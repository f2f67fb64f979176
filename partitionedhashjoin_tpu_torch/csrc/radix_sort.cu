// Full tuple sort for Hopper (sm_90a): a one-sweep LSD radix sort.
//
// Replaces partitionedhashjoin_tpu/ops/pallas/bitonic_sort.py::sort_i32_tuple
// (K6: phase A _sort_blocks, then ceil(log2(blocks)) _merge_pass_rows
// passes in one program), and with it the port's own K6a + K6b path
// (bitonic_sort.cu), which stays only as the counterpart of sort_blocks_i32
// and merge_pass_i32.  It computes the same function: k = 1..4 int32
// operands sorted ascending in full lexicographic tuple order (operand 0
// first, ties by operand 1, ...).  Ties are bit-identical tuples, so the
// sort has exactly one correct output, which a stable LSD radix sort over
// the whole tuple produces.
//
// The tuple is one (32 k)-bit unsigned key: each operand biased by
// ^ 0x80000000 (signed order becomes unsigned order; the bias is applied
// when a digit is extracted, never stored), operand 0 most significant.
// Digits are 8 bits, sorted least significant first: operand k-1's byte 0
// first, operand 0's byte 3 last, up to 4 k passes.
//
// What bounds it on this card: bytes.  The compulsory traffic is each
// operand read once and written once, 2 x 4 k bytes per row; the ranking is
// a few integer operations per row and pass.  The merge-sort design before
// it touched memory once per phase (phase A, then 15 merge passes at 200M
// rows): 16x the compulsory bytes.  This design moves (1 + passes) x 2 x 4k
// bytes per row at most (the upsweep only reads, so it is 1 read + passes x
// (read + write)), and skips every pass whose digit is the same in all rows.
//
// Kernels:
// - upsweep_kernel: ONE read of all k operands builds all 4 k digit
//   histograms: per-CTA histograms in shared memory (a warp whose 32 lanes
//   share a digit adds 32 once, so a constant digit does not serialise on
//   one counter), then global 64-bit atomics.  offsets_kernel turns each
//   histogram into the exclusive digit offsets of its pass.  The host reads
//   the histograms back once per sort (the one synchronisation), and a digit
//   whose histogram has a single non-empty bucket is the same in every row:
//   its pass is skipped, exactly and at no extra cost (keys in [1, 10M] skip
//   their top byte; an all-zero flag or the hi plane of small int64 keys
//   skips all four).  The plan (digit order, skipped digits, buffer parity)
//   is the host function radix_plan in ops/kernels/bitonic_sort.py.
// - sweep_kernel, one launch per digit that varies: each CTA of 512 threads
//   claims the next tile of kTile = 8,192 rows through an atomic counter
//   (so a tile only waits on tiles claimed before it: the look-back always
//   progresses) and loads the key operand warp-striped: each warp load is
//   one coalesced 128-byte line, and each ranking round holds 32
//   consecutive rows in lane order (16-byte loads turned through shared
//   memory measured no faster).  It ranks every row stably in input order
//   within its warp: nine ballots find the lanes of a round that share its
//   digit (measured faster than the match.any instruction), per-warp digit
//   counters in shared memory count the rows of earlier rounds.  Per-digit
//   warp offsets and tile offsets follow; thread d publishes the tile's
//   count of digit d and finds the digit's global prefix by decoupled
//   look-back over the tiles before (lookback.cuh: one thread per digit,
//   eight polls in flight).  Every operand is then staged in shared memory
//   in digit order and written out by consecutive threads at consecutive
//   addresses of each digit's run; the key operand is staged from the
//   ranking's registers (read once per pass).  Buffers ping-pong between
//   the caller's two sets (the last pass writes the output); the status
//   words and the tile counter are zeroed by a cudaMemsetAsync before every
//   pass.
// All row offsets are 64-bit.  Any n is accepted, with no padding.
//
// C interface for ctypes: each entry returns cudaGetLastError() after its
// last launch (and after any call that fails), so a refused launch reaches
// the caller.

#include <cstdint>

#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kMaxOperands = 4;
constexpr int kRadix = 256;
constexpr int kDigits = 4;  // 8-bit digits of an int32 operand
constexpr uint32_t kBias = 0x80000000u;
constexpr unsigned int kFull = 0xffffffffu;

constexpr int kUpThreads = 256;
constexpr int kUpBlocksPerSm = 4;
constexpr int kUpRowsPerWarp = 128;  // one int4 per lane

constexpr int kSweepThreads = 512;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kItems = 16;             // rows per thread
constexpr int kWarpRows = 32 * kItems;  // 512
constexpr int kTile = kSweepThreads * kItems;  // 8192 rows per tile

struct Operands {
  const int32_t* in[kMaxOperands];
  int32_t* out[kMaxOperands];
};

__device__ __forceinline__ unsigned int digit_of(int32_t v, int shift) {
  return ((static_cast<uint32_t>(v) ^ kBias) >> shift) & (kRadix - 1);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ---------------------------------------------------------------- upsweep

template <int K>
__global__ void __launch_bounds__(kUpThreads)
    upsweep_kernel(Operands ops, int64_t n,
                   unsigned long long* __restrict__ hist) {
  __shared__ unsigned int s_hist[K * kDigits][kRadix];
  for (int i = threadIdx.x; i < K * kDigits * kRadix; i += kUpThreads) {
    (&s_hist[0][0])[i] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kUpThreads + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * kUpThreads) >> 5;
  // the bound is the same for every lane, so the warp votes below are safe
  for (int64_t base = warp * kUpRowsPerWarp; base < n;
       base += warps * kUpRowsPerWarp) {
    const int64_t row0 = base + lane * 4;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const int32_t* src = ops.in[c];
      int32_t v[4];
      bool ok[4];
      if (row0 + 4 <= n && aligned16(src)) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(src + row0));
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ok[e] = true;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ok[e] = row0 + e < n;
          v[e] = ok[e] ? src[row0 + e] : 0;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int b = 0; b < kDigits; ++b) {
          const unsigned int d = ok[e] ? digit_of(v[e], 8 * b) : kRadix;
          const unsigned int d0 = __shfl_sync(kFull, d, 0);
          unsigned int* h = s_hist[c * kDigits + b];
          if (__all_sync(kFull, d == d0)) {
            if (lane == 0 && d0 < kRadix) {
              atomicAdd(h + d0, 32u);
            }
          } else if (d < kRadix) {
            atomicAdd(h + d, 1u);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K * kDigits * kRadix; i += kUpThreads) {
    const unsigned int c = (&s_hist[0][0])[i];
    if (c) {
      atomicAdd(hist + i, static_cast<unsigned long long>(c));
    }
  }
}

// One block per histogram: offsets[row][d] = sum of hist[row][0 .. d-1].
__global__ void __launch_bounds__(kRadix)
    offsets_kernel(const unsigned long long* __restrict__ hist,
                   unsigned long long* __restrict__ offsets) {
  __shared__ unsigned long long s_warp[kRadix / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t at = static_cast<int64_t>(blockIdx.x) * kRadix + threadIdx.x;
  const unsigned long long c = hist[at];
  unsigned long long inc = c;
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const unsigned long long up = __shfl_up_sync(kFull, inc, offset);
    if (lane >= offset) {
      inc += up;
    }
  }
  if (lane == 31) {
    s_warp[warp] = inc;
  }
  __syncthreads();
  unsigned long long before = 0;
  for (int w = 0; w < warp; ++w) {
    before += s_warp[w];
  }
  offsets[at] = before + inc - c;
}

// ---------------------------------------------------------------- sweep

struct SweepShared {
  int32_t val[kTile];                       // staging, 32 KB
  uint32_t warp_hist[kSweepWarps][kRadix];  // per-warp digit counts, 16 KB
  uint16_t place[kTile];  // each input row's place in digit order, 16 KB
  uint8_t digit[kTile];   // the digit of each place, 8 KB
  long long adj[kRadix];  // global position of a digit's run - its place
  uint32_t tile_prefix[kRadix];  // places before each digit in the tile
  uint32_t scan[kRadix / 32];
  long long tile;
};

// The thread's kItems rows of a tile, warp-striped: item i is tile row
// warp_first + 32 i + lane (0 past the tile's rows).  Every load is issued
// before the first value is used.
__device__ __forceinline__ void load_striped(const int32_t* src,
                                             int64_t tile_begin,
                                             int warp_first, int lane,
                                             int tile_rows,
                                             int32_t (&v)[kItems]) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int r = warp_first + 32 * i + lane;
    v[i] = r < tile_rows ? __ldg(src + tile_begin + r) : 0;
  }
}

// The lanes of the warp whose digit equals this lane's d (d < 512): one
// ballot per digit bit, which issues faster than the match.any instruction.
__device__ __forceinline__ unsigned int peers_of(unsigned int d) {
  unsigned int peers = kFull;
#pragma unroll
  for (int bit = 0; bit < 9; ++bit) {
    const bool set = (d >> bit) & 1u;
    const unsigned int b = __ballot_sync(kFull, set);
    peers &= set ? b : ~b;
  }
  return peers;
}

// The staged tile written out: place j goes to its digit's run.
__device__ __forceinline__ void write_tile(const SweepShared& s, int32_t* dst,
                                           int tile_rows) {
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int j = m * kSweepThreads + threadIdx.x;
    if (j < tile_rows) {
      dst[s.adj[s.digit[j]] + j] = s.val[j];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kSweepThreads, 2)
    sweep_kernel(Operands ops, const int32_t* __restrict__ keys,
                 int32_t* __restrict__ keys_out, int key_op, int shift,
                 int64_t n,
                 const unsigned long long* __restrict__ digit_base,
                 unsigned long long* status, unsigned int* counter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SweepShared& s = *reinterpret_cast<SweepShared*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s.tile = phj::claim_tile(counter);
  }
  for (int i = threadIdx.x; i < kSweepWarps * kRadix; i += kSweepThreads) {
    (&s.warp_hist[0][0])[i] = 0;
  }
  __syncthreads();
  const long long tile = s.tile;
  const int64_t tile_begin = tile * kTile;
  const int tile_rows =
      static_cast<int>(min(static_cast<int64_t>(kTile), n - tile_begin));
  const int warp_first = warp * kWarpRows;

  // 1. The warp's key rows, warp-striped: item i of a lane is row
  //    warp_first + 32 i + lane, so each ranking round holds 32 consecutive
  //    rows in lane order, and each warp load is one coalesced 128-byte
  //    line.
  int32_t key[kItems];
  load_striped(keys, tile_begin, warp_first, lane, tile_rows, key);

  // 2. Stable rank of each row among the warp's earlier rows of its digit.
  uint32_t* hist = s.warp_hist[warp];
  const unsigned int lanes_before = (1u << lane) - 1u;
  uint32_t rank[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool ok = warp_first + 32 * i + lane < tile_rows;
    const unsigned int d = ok ? digit_of(key[i], shift) : kRadix;
    const unsigned int peers = peers_of(d);  // invalid rows: d == kRadix
    const unsigned int before = __popc(peers & lanes_before);
    const unsigned int count = ok ? hist[d] : 0u;
    __syncwarp();
    if (ok && before == 0) {
      hist[d] = count + __popc(peers);
    }
    __syncwarp();
    rank[i] = count + before;
  }
  __syncthreads();

  // 3. Thread d: the warps' counts of digit d become exclusive offsets, the
  //    tile's count is published (AGGREGATE) at once, and the digits are
  //    scanned in the tile.
  unsigned int tile_count = 0;
  unsigned int inc = 0;
  if (threadIdx.x < kRadix) {
    const int d = threadIdx.x;
#pragma unroll
    for (int w = 0; w < kSweepWarps; ++w) {
      const unsigned int c = s.warp_hist[w][d];
      s.warp_hist[w][d] = tile_count;
      tile_count += c;
    }
    phj::status_publish(
        status + tile * kRadix + d,
        tile == 0 ? phj::kStatusInclusive : phj::kStatusAggregate, tile_count);
    inc = tile_count;
#pragma unroll
    for (int offset = 1; offset < 32; offset <<= 1) {
      const unsigned int up = __shfl_up_sync(kFull, inc, offset);
      if (lane >= offset) {
        inc += up;
      }
    }
    if (lane == 31) {
      s.scan[warp] = inc;
    }
  }
  __syncthreads();
  if (threadIdx.x < kRadix) {
    unsigned int before = 0;
    for (int w = 0; w < warp; ++w) {
      before += s.scan[w];
    }
    s.tile_prefix[threadIdx.x] = before + inc - tile_count;
  }
  __syncthreads();

  // 4. Each row's place in the digit-ordered tile; the key operand is
  //    staged there at once.
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int r = warp_first + 32 * i + lane;
    if (r < tile_rows) {
      const unsigned int d = digit_of(key[i], shift);
      const unsigned int place = s.tile_prefix[d] + hist[d] + rank[i];
      if (K > 1) {
        s.place[r] = static_cast<uint16_t>(place);
      }
      s.digit[place] = static_cast<uint8_t>(d);
      s.val[place] = key[i];
    }
  }
  // 5. Thread d: the digit's global prefix over the tiles before.
  if (threadIdx.x < kRadix) {
    const int d = threadIdx.x;
    const unsigned long long before =
        tile == 0 ? 0ull : phj::lookback_thread(status + d, tile, kRadix);
    if (tile != 0) {
      phj::status_publish(status + tile * kRadix + d, phj::kStatusInclusive,
                          before + tile_count);
    }
    s.adj[d] = static_cast<long long>(digit_base[d] + before) -
               static_cast<long long>(s.tile_prefix[d]);
  }
  __syncthreads();

  // 6. Every operand, staged in digit order, is written by consecutive
  //    threads at consecutive addresses of each digit's run: the key
  //    operand first, then each other one after its own loads.
  write_tile(s, keys_out, tile_rows);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (c == key_op) {
      continue;
    }
    __syncthreads();
    int32_t v[kItems];
    load_striped(ops.in[c], tile_begin, warp_first, lane, tile_rows, v);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int r = warp_first + 32 * i + lane;
      if (r < tile_rows) {
        s.val[s.place[r]] = v[i];
      }
    }
    __syncthreads();
    write_tile(s, ops.out[c], tile_rows);
  }
}

int g_sm_count = 0;

int sm_count() {
  if (g_sm_count == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess) {
      g_sm_count = 132;
    }
  }
  return g_sm_count;
}

Operands make_operands(const int32_t* const* in, int32_t* const* out, int k) {
  Operands ops{};
  for (int c = 0; c < k; ++c) {
    ops.in[c] = in[c];
    ops.out[c] = out[c];
  }
  return ops;
}

template <int K>
cudaError_t launch_histograms(const Operands& ops, int64_t n,
                              unsigned long long* hist,
                              unsigned long long* offsets,
                              cudaStream_t stream) {
  const int rows = K * kDigits;
  cudaError_t err = cudaMemsetAsync(
      hist, 0, static_cast<size_t>(rows) * kRadix * sizeof(*hist), stream);
  if (err != cudaSuccess) {
    return err;
  }
  const int64_t per_block = static_cast<int64_t>(kUpThreads / 32) * kUpRowsPerWarp;
  const int64_t needed = (n + per_block - 1) / per_block;
  const int64_t most = static_cast<int64_t>(sm_count()) * kUpBlocksPerSm;
  const unsigned int grid =
      static_cast<unsigned int>(needed < most ? needed : most);
  upsweep_kernel<K><<<grid, kUpThreads, 0, stream>>>(ops, n, hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return err;
  }
  offsets_kernel<<<rows, kRadix, 0, stream>>>(hist, offsets);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_pass(const Operands& ops, int64_t n, int key_op, int shift,
                        const unsigned long long* digit_base,
                        unsigned long long* status, cudaStream_t stream) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  cudaError_t err = cudaMemsetAsync(
      status, 0, static_cast<size_t>(tiles * kRadix + 1) * sizeof(*status),
      stream);
  if (err != cudaSuccess) {
    return err;
  }
  const int smem = static_cast<int>(sizeof(SweepShared));
  err = cudaFuncSetAttribute(sweep_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    return err;
  }
  auto* counter = reinterpret_cast<unsigned int*>(status + tiles * kRadix);
  sweep_kernel<K><<<static_cast<unsigned int>(tiles), kSweepThreads, smem,
                    stream>>>(ops, ops.in[key_op], ops.out[key_op], key_op,
                              shift, n, digit_base, status, counter);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Most operands a call takes; the wrapper checks it.
int phj_radix_max_operands() { return kMaxOperands; }

// Rows per sweep tile; the wrapper sizes the status buffer from it.
int phj_radix_tile_rows() { return kTile; }

// The upsweep: hist and offsets are device buffers of 4 k x 256 uint64;
// row 4 c + b of hist receives the histogram of byte b (0 = least
// significant) of biased operand c over its n rows, the same row of offsets
// its exclusive prefix over the digits.  One memset and two launches on
// `stream`, no synchronisation.  Returns cudaGetLastError().
int phj_radix_histograms(int k, int64_t n, const int32_t* in0,
                         const int32_t* in1, const int32_t* in2,
                         const int32_t* in3, unsigned long long* hist,
                         unsigned long long* offsets, cudaStream_t stream) {
  if (k < 1 || k > kMaxOperands || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int32_t* in[kMaxOperands] = {in0, in1, in2, in3};
  int32_t* out[kMaxOperands] = {nullptr, nullptr, nullptr, nullptr};
  const Operands ops = make_operands(in, out, k);
  switch (k) {
    case 1:
      return static_cast<int>(launch_histograms<1>(ops, n, hist, offsets, stream));
    case 2:
      return static_cast<int>(launch_histograms<2>(ops, n, hist, offsets, stream));
    case 3:
      return static_cast<int>(launch_histograms<3>(ops, n, hist, offsets, stream));
    default:
      return static_cast<int>(launch_histograms<4>(ops, n, hist, offsets, stream));
  }
}

// One sweep pass: the n rows of in0..in(k-1) stably reordered by byte
// shift / 8 of biased operand key_op into out0..out(k-1) (which must not
// alias the inputs).  digit_base is that digit's row of the upsweep's
// offsets (256 uint64); status is a device buffer of ceil(n / kTile) x 256
// + 1 uint64, zeroed here.  One memset and one launch on `stream`, no
// synchronisation.  Returns cudaGetLastError().
int phj_radix_pass(int k, int64_t n, int key_op, int shift,
                   const int32_t* in0, const int32_t* in1, const int32_t* in2,
                   const int32_t* in3, int32_t* out0, int32_t* out1,
                   int32_t* out2, int32_t* out3,
                   const unsigned long long* digit_base,
                   unsigned long long* status, cudaStream_t stream) {
  if (k < 1 || k > kMaxOperands || n < 0 || key_op < 0 || key_op >= k ||
      shift < 0 || shift > 24 || shift % 8 != 0 ||
      (n + kTile - 1) / kTile > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int32_t* in[kMaxOperands] = {in0, in1, in2, in3};
  int32_t* out[kMaxOperands] = {out0, out1, out2, out3};
  const Operands ops = make_operands(in, out, k);
  switch (k) {
    case 1:
      return static_cast<int>(
          launch_pass<1>(ops, n, key_op, shift, digit_base, status, stream));
    case 2:
      return static_cast<int>(
          launch_pass<2>(ops, n, key_op, shift, digit_base, status, stream));
    case 3:
      return static_cast<int>(
          launch_pass<3>(ops, n, key_op, shift, digit_base, status, stream));
    default:
      return static_cast<int>(
          launch_pass<4>(ops, n, key_op, shift, digit_base, status, stream));
  }
}

}  // extern "C"
