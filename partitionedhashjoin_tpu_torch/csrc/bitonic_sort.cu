// Tuple sort kernels for Hopper (sm_90a): block sort and pairwise merge.
//
// Replaces partitionedhashjoin_tpu/ops/pallas/bitonic_sort.py (K6):
// - phase A, _sort_blocks / sort_blocks_i32 (K6a): each block of kBlk rows
//   of k int32 operands sorted ascending in full lexicographic tuple order
//   (operand 0 first, ties by operand 1, ...);
// - phase B, _merge_pass_rows / merge_pass_i32 (K6b): one pairwise merge
//   pass, sorted runs of run_len rows become sorted runs of 2 * run_len, "A
//   wins ties", a lone tail run copied through, a truncated last B.
// Ties are bit-identical tuples, so the sort has exactly one correct output
// and the kernels agree with any correct sort (the plain PyTorch version is
// a cascade of stable torch.sort calls).
//
// What bounds them on this card.  The work's own bound is bytes: each
// operand read once and written once, 8 k bytes a row (0.48 ms for 200M rows
// at k = 1); a block's comparisons or digit counts are far below the card's
// arithmetic rate.  The full sort no longer uses these kernels: it is the
// radix sort of radix_sort.cu, since a merge sort touches device memory once
// per phase (16x the compulsory bytes at 200M rows).
//
// What the designs do about it.  The TPU kernel keeps a whole block in
// vector registers, builds partner exchanges from lane rotations and static
// sublane swaps, and overlays a reversed B window on A in (ROWS + 1)-row DMA
// windows, because of Mosaic's limits.  Here:
// - sort_blocks_kernel (K6a): a block-local LSD radix sort in shared memory.
//   A bitonic network over a block is 91 compare-exchange stages, each a
//   round trip of every row through shared memory and a barrier, moving all
//   k operands at every swap; that held K6a at 20x its bytes.  Here one CTA
//   of 512 threads per kBlk-row block reads the k operands once (16 bytes a
//   thread) into shared memory, biased so that unsigned order is the
//   signed order, and takes on the way each operand's AND and OR over the
//   block: a 4-bit digit whose AND equals its OR is the same in every row,
//   so its pass is skipped (keys in [1, 10M] skip two of eight; a block
//   whose rows are all one tuple is copied through).  Each varying digit,
//   least significant first (operand k-1's digit 0 first, operand 0's digit
//   7 last), is one stable counting pass with three barriers: thread t
//   ranks rows 16 t .. 16 t + 15 of the current order with its own column
//   of 16 counters (no atomics, no bank conflicts beyond two threads a
//   word), one scan of all 8,192 counters in (digit, thread) order gives
//   every (digit, thread) its first place, and each row goes to its place.
//   Why not the sweep's ranking of 32 rows a round by ballots: it issued
//   some 80 instructions a row for each 8-bit digit, where a thread's own
//   counters issue about 26 for each 4-bit digit.  At k = 1 a pass moves
//   the values themselves; at k > 1 it moves only a 16-bit permutation
//   (place -> row) and reads each row's digit through it, so no operand
//   moves between passes.  Each operand is then written once, 16 bytes a
//   thread: output row i is row perm[i].  Rows sit in shared memory with
//   one pad word per 32 (pad(), pad16() for the permutation), so a
//   thread's run of 16 rows and the coalesced reads and writes are free of
//   bank conflicts.  Shared memory is k x 33 KB of operands, 16 KB of
//   counters and (k > 1) 17 KB of permutation: two CTAs per SM at k <= 2,
//   so one block's loads overlap another's passes, and one at k = 3, 4.
//   Ties are bit-identical tuples, so the stable sort's order is the one
//   correct order.
// - diag_kernel: one thread per output tile of a merge pass finds the tile's
//   merge-path split (how many rows of run A precede it) by binary search
//   over the pair in device memory: the largest i with A[i - 1] <= B[g - i].
// - merge_kernel: one CTA per output tile of kBlk rows loads its A and B
//   windows (between its split and the next tile's) into shared memory,
//   every thread finds its own split of 16 outputs in the windows with the
//   same predicate, merges them sequentially into registers, and the CTA
//   writes the tile back coalesced.  Splits at both ends of a tile come from
//   the same predicate, so runs of equal tuples longer than a tile or a run
//   are neither duplicated nor dropped.
// Shared memory is indexed with one pad word per 32 (pad()), so the strided
// register write-back of merge_kernel is free of bank conflicts.  All row
// offsets are 64-bit.
//
// C interface for ctypes: each entry returns cudaGetLastError() after its
// last launch (and after any launch that fails), so a refused launch reaches
// the caller.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOperands = 4;
constexpr int kLogBlk = 13;
constexpr int kBlk = 1 << kLogBlk;  // rows per phase-A block and merge tile
constexpr uint32_t kBias = 0x80000000u;  // signed order becomes unsigned order
constexpr unsigned int kFull = 0xffffffffu;
constexpr int kSortThreads = 512;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = kBlk / kSortThreads;  // rows per thread
constexpr int kSortVecs = kBlk / 4 / kSortThreads;  // int4 per thread and operand
constexpr int kDigitBits = 4;
constexpr int kDigitValues = 1 << kDigitBits;
constexpr int kDigits = 32 / kDigitBits;  // digits of an int32 operand
constexpr int kMergeThreads = 512;
constexpr int kItems = kBlk / kMergeThreads;  // outputs per merge thread
constexpr int kPadBlk = kBlk + kBlk / 32;  // a block's rows with their pads
constexpr int kDiagThreads = 256;

struct Operands {
  const int32_t* in[kMaxOperands];
  int32_t* out[kMaxOperands];
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Strict lexicographic a < b over K operands.
template <int K>
__device__ __forceinline__ bool tuple_less(const int32_t (&a)[K],
                                           const int32_t (&b)[K]) {
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (a[c] != b[c]) {
      return a[c] < b[c];
    }
  }
  return false;
}

template <int K>
__device__ __forceinline__ void load_shared(int32_t (&v)[K],
                                            const int32_t* smem, int stride,
                                            int at) {
#pragma unroll
  for (int c = 0; c < K; ++c) {
    v[c] = smem[c * stride + at];
  }
}

template <int K>
__device__ __forceinline__ void load_global(int32_t (&v)[K],
                                            const Operands& ops, int64_t at) {
#pragma unroll
  for (int c = 0; c < K; ++c) {
    v[c] = ops.in[c][at];
  }
}

// ------------------------------------------------------------ block sort

// The padded index of a uint16 row: two pad halves per 64 rows, so that
// 32 threads reading rows 16 t + i (a thread's run) hit 32 banks.
__device__ __forceinline__ int pad16(int i) { return i + 2 * (i >> 6); }

template <int K>
struct __align__(16) BlockShared {
  // the block's operands, biased (^ kBias), at pad(row); K = 1 moves the
  // values, K > 1 never moves them
  uint32_t val[K][kPadBlk];
  uint16_t perm[K > 1 ? kPadBlk : 8];  // K > 1: place -> row, at pad16
  // count[d][t]: thread t's rows of digit d in this pass, then the
  // exclusive prefix of (d, t) in digit-major, thread-minor order
  uint16_t count[kDigitValues][kSortThreads];
  uint32_t warp_total[kSortWarps];
  uint32_t warp_and[K][kSortWarps];
  uint32_t warp_or[K][kSortWarps];
};

// The block's digits that vary, as a mask over the passes in order: bit
// kDigits (K - 1 - c) + b is digit b (0 = least significant) of operand c.
// A digit whose bits agree in the AND and the OR of the block's rows is
// the same in every row (the bias flips bit 31 of every row, so it changes
// neither), and a stable pass by it moves nothing.
template <int K>
__device__ __forceinline__ uint32_t varying_digits(const BlockShared<K>& s) {
  uint32_t plan = 0;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    uint32_t all = kFull, any = 0;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      all &= s.warp_and[c][w];
      any |= s.warp_or[c][w];
    }
    const uint32_t vary = all ^ any;
#pragma unroll
    for (int b = 0; b < kDigits; ++b) {
      if ((vary >> (kDigitBits * b)) & (kDigitValues - 1)) {
        plan |= 1u << (kDigits * (K - 1 - c) + b);
      }
    }
  }
  return plan;
}

// Every thread: the counters, read in (digit, thread) order as 8 words of
// two counts per thread, become exclusive prefixes.  Two __syncthreads.
__device__ __forceinline__ void scan_counts(
    uint16_t (&count)[kDigitValues][kSortThreads], uint32_t* warp_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint4* words = reinterpret_cast<uint4*>(&count[0][0]) + 2 * threadIdx.x;
  uint32_t total = 0;
  {
    const uint4 w0 = words[0];
    const uint4 w1 = words[1];
    const uint32_t x[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      total += (x[k] & 0xffffu) + (x[k] >> 16);
    }
  }
  uint32_t inc = total;
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, inc, offset);
    if (lane >= offset) {
      inc += up;
    }
  }
  if (lane == 31) {
    warp_total[warp] = inc;
  }
  __syncthreads();
  // the totals of the warps before this one: lane v < kSortWarps holds warp
  // v's, and a sum over the lanes below this warp's index
  uint32_t before = lane < warp ? warp_total[lane] : 0u;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    before += __shfl_xor_sync(kFull, before, offset);
  }
  // the thread's counters again (only this thread writes them, below)
  const uint4 w0 = words[0];
  const uint4 w1 = words[1];
  uint32_t x[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  uint32_t run = before + inc - total;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t lo = x[k] & 0xffffu;
    const uint32_t hi = x[k] >> 16;
    x[k] = run | ((run + lo) << 16);
    run += lo + hi;
  }
  words[0] = make_uint4(x[0], x[1], x[2], x[3]);
  words[1] = make_uint4(x[4], x[5], x[6], x[7]);
  __syncthreads();
}

template <int K>
__global__ void __launch_bounds__(kSortThreads, K <= 2 ? 2 : 1)
    sort_blocks_kernel(Operands ops) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BlockShared<K>& s = *reinterpret_cast<BlockShared<K>*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlk;

  // 1. The block's operands into shared memory, biased, 16 bytes a thread
  //    where the operand allows it, with the AND and OR of every operand's
  //    rows; the counters zeroed.
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int32_t* src = ops.in[c] + base;
    uint32_t all = kFull, any = 0;
    if (aligned16(src)) {
#pragma unroll
      for (int m = 0; m < kSortVecs; ++m) {
        const int q = m * kSortThreads + threadIdx.x;
        const int4 v = __ldg(reinterpret_cast<const int4*>(src) + q);
        const uint32_t x[4] = {static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
                               static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s.val[c][pad(4 * q + e)] = x[e] ^ kBias;
          all &= x[e];
          any |= x[e];
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < kSortItems; ++m) {
        const int r = m * kSortThreads + threadIdx.x;
        const uint32_t x = static_cast<uint32_t>(__ldg(src + r));
        s.val[c][pad(r)] = x ^ kBias;
        all &= x;
        any |= x;
      }
    }
    all = __reduce_and_sync(kFull, all);
    any = __reduce_or_sync(kFull, any);
    if (lane == 0) {
      s.warp_and[c][warp] = all;
      s.warp_or[c][warp] = any;
    }
  }
  uint4* counters = reinterpret_cast<uint4*>(&s.count[0][0]) + 2 * threadIdx.x;
  counters[0] = make_uint4(0, 0, 0, 0);
  counters[1] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // 2. One stable counting pass per varying digit, least significant first.
  //    Thread t ranks rows 16 t .. 16 t + 15 of the current order: its own
  //    column of counters counts its rows of each digit (and gives each row
  //    the count of its earlier rows of its digit), and the scan of all
  //    counters in (digit, thread) order gives each (digit, thread) its
  //    first place.  K = 1 moves the values (held in registers across the
  //    scan); K > 1 moves the permutation (place -> row, 16 bits) and reads
  //    each row's digit through it.
  const uint32_t plan = varying_digits(s);
  const int first = kSortItems * threadIdx.x;
  uint16_t* column = &s.count[0][threadIdx.x];
  bool moved = false;  // K > 1: perm holds the order so far
#pragma unroll 1
  for (int t = 0; t < kDigits * K; ++t) {
    if (((plan >> t) & 1u) == 0) {
      continue;
    }
    const int c = K - 1 - t / kDigits;
    const int shift = kDigitBits * (t % kDigits);
    uint32_t item[kSortItems];  // K = 1: the value; K > 1: row | digit << 16
    if constexpr (K == 1) {
#pragma unroll
      for (int i = 0; i < kSortItems; ++i) {
        item[i] = s.val[0][pad(first + i)];
      }
    }
    uint32_t before[2] = {0, 0};  // 4 bits per row: its thread's earlier rows of its digit
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      unsigned int d;
      if constexpr (K == 1) {
        d = (item[i] >> shift) & (kDigitValues - 1);
      } else {
        const uint32_t row = moved ? s.perm[pad16(first + i)] : first + i;
        d = (s.val[c][pad(row)] >> shift) & (kDigitValues - 1);
        item[i] = row | (d << 16);
      }
      const uint32_t at = d * kSortThreads;
      const uint32_t n = column[at];
      column[at] = static_cast<uint16_t>(n + 1);
      before[i / 8] |= n << (4 * (i % 8));
    }
    __syncthreads();
    scan_counts(s.count, s.warp_total);
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      const uint32_t at = (K == 1 ? (item[i] >> shift) & (kDigitValues - 1)
                                  : item[i] >> 16) * kSortThreads;
      const int place = column[at] +
                        ((before[i / 8] >> (4 * (i % 8))) & 15u);
      if constexpr (K == 1) {
        s.val[0][pad(place)] = item[i];
      } else {
        s.perm[pad16(place)] = static_cast<uint16_t>(item[i]);
      }
    }
#pragma unroll
    for (int d = 0; d < kDigitValues; ++d) {
      column[d * kSortThreads] = 0;
    }
    __syncthreads();
    moved = true;
  }

  // 3. Each operand written once, unbiased, 16 bytes a thread: output row i
  //    is row perm[i] of the block (K = 1, or no pass ran: row i).
#pragma unroll
  for (int c = 0; c < K; ++c) {
    int4* dst = reinterpret_cast<int4*>(ops.out[c] + base);
#pragma unroll
    for (int m = 0; m < kSortVecs; ++m) {
      const int q = m * kSortThreads + threadIdx.x;
      uint32_t x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * q + e;
        const int row = K == 1 || !moved ? i : s.perm[pad16(i)];
        x[e] = s.val[c][pad(row)] ^ kBias;
      }
      dst[q] = make_int4(static_cast<int>(x[0]), static_cast<int>(x[1]),
                         static_cast<int>(x[2]), static_cast<int>(x[3]));
    }
  }
}

// The pair of runs that output row g_global of a merge pass belongs to.
struct Pair {
  int64_t base_a, base_b, len_a, len_b, g;
};

__device__ __forceinline__ Pair pair_of(int64_t g_global, int64_t n,
                                        int64_t run_len) {
  Pair p;
  p.base_a = g_global / (2 * run_len) * (2 * run_len);
  p.base_b = p.base_a + run_len;
  p.len_a = min(run_len, n - p.base_a);
  p.len_b = max(int64_t{0}, min(run_len, n - p.base_b));
  p.g = g_global - p.base_a;
  return p;
}

template <int K>
__global__ void __launch_bounds__(kDiagThreads)
    diag_kernel(Operands ops, int64_t n, int64_t run_len, int64_t tiles,
                int64_t* __restrict__ split) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kDiagThreads +
                    threadIdx.x;
  if (w >= tiles) {
    return;
  }
  const Pair p = pair_of(w * kBlk, n, run_len);
  int64_t lo = max(int64_t{0}, p.g - p.len_b);
  int64_t hi = min(p.g, p.len_a);
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    int32_t a[K], b[K];
    load_global(a, ops, p.base_a + mid - 1);
    load_global(b, ops, p.base_b + p.g - mid);
    if (tuple_less(b, a)) {
      hi = mid - 1;
    } else {
      lo = mid;
    }
  }
  split[w] = lo;
}

template <int K>
__global__ void __launch_bounds__(kMergeThreads)
    merge_kernel(Operands ops, int64_t n, int64_t run_len,
                 const int64_t* __restrict__ split, int64_t n_out) {
  extern __shared__ int32_t smem[];  // K operands x kPadBlk words
  const int64_t w = blockIdx.x;
  const int64_t g_global = w * kBlk;
  const Pair p = pair_of(g_global, n, run_len);
  const int64_t a_lo = split[w];
  const int64_t a_hi =
      p.g + kBlk >= p.len_a + p.len_b ? p.len_a : split[w + 1];
  const int la = static_cast<int>(a_hi - a_lo);
  const int lb = kBlk - la;
  const int64_t a_from = p.base_a + a_lo;
  const int64_t b_from = p.base_b + (p.g - a_lo);
  // windows: A at local [0, la), B at local [la, kBlk)
#pragma unroll
  for (int c = 0; c < K; ++c) {
    for (int i = threadIdx.x; i < kBlk; i += kMergeThreads) {
      smem[c * kPadBlk + pad(i)] =
          i < la ? ops.in[c][a_from + i] : ops.in[c][b_from + (i - la)];
    }
  }
  __syncthreads();

  const int y = threadIdx.x * kItems;
  int lo = max(0, y - lb);
  int hi = min(y, la);
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    int32_t a[K], b[K];
    load_shared(a, smem, kPadBlk, pad(mid - 1));
    load_shared(b, smem, kPadBlk, pad(la + y - mid));
    if (tuple_less(b, a)) {
      hi = mid - 1;
    } else {
      lo = mid;
    }
  }
  int ai = lo;
  int bi = y - lo;
  int32_t a[K], b[K];
  if (ai < la) {
    load_shared(a, smem, kPadBlk, pad(ai));
  }
  if (bi < lb) {
    load_shared(b, smem, kPadBlk, pad(la + bi));
  }
  int32_t out[K][kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool take_a = bi >= lb || (ai < la && !tuple_less(b, a));
#pragma unroll
    for (int c = 0; c < K; ++c) {
      out[c][k] = take_a ? a[c] : b[c];
    }
    if (take_a) {
      if (++ai < la) {
        load_shared(a, smem, kPadBlk, pad(ai));
      }
    } else if (++bi < lb) {
      load_shared(b, smem, kPadBlk, pad(la + bi));
    }
  }
  __syncthreads();  // every thread has read its windows
#pragma unroll
  for (int c = 0; c < K; ++c) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      smem[c * kPadBlk + pad(y + k)] = out[c][k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < K; ++c) {
    for (int i = threadIdx.x; i < kBlk; i += kMergeThreads) {
      const int64_t row = g_global + i;
      if (row < n_out) {
        ops.out[c][row] = smem[c * kPadBlk + pad(i)];
      }
    }
  }
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
cudaError_t launch_sort_blocks(const Operands& ops, int64_t n,
                               cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(BlockShared<K>));
  cudaError_t err = cudaFuncSetAttribute(
      sort_blocks_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    return err;
  }
  const unsigned int grid = static_cast<unsigned int>(n / kBlk);
  sort_blocks_kernel<K><<<grid, kSortThreads, smem, stream>>>(ops);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_merge_pass(const Operands& ops, int64_t n,
                              int64_t run_len, int64_t* split, int64_t n_out,
                              cudaStream_t stream) {
  const int64_t tiles = n / kBlk;
  const unsigned int diag_grid =
      static_cast<unsigned int>((tiles + kDiagThreads - 1) / kDiagThreads);
  diag_kernel<K><<<diag_grid, kDiagThreads, 0, stream>>>(ops, n, run_len,
                                                          tiles, split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return err;
  }
  const int smem = K * kPadBlk * static_cast<int>(sizeof(int32_t));
  err = cudaFuncSetAttribute(
      merge_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    return err;
  }
  merge_kernel<K><<<static_cast<unsigned int>(tiles), kMergeThreads, smem,
                    stream>>>(ops, n, run_len, split, n_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per phase-A block and per merge tile; the wrapper checks it.
int phj_bitonic_block_rows() { return kBlk; }

// Most operands a call takes; the wrapper checks it.
int phj_bitonic_max_operands() { return kMaxOperands; }

// Phase A over n rows (a multiple of kBlk) of k operands: each kBlk-row
// block of in0..in3 sorted into out0..out3, which must not alias the inputs
// and must start on a 16-byte boundary (the inputs need not).  Operands past
// k are ignored.  Launches on `stream` and does not synchronise.  Returns
// cudaGetLastError().
int phj_sort_blocks(int k, int64_t n, const int32_t* in0, const int32_t* in1,
                    const int32_t* in2, const int32_t* in3, int32_t* out0,
                    int32_t* out1, int32_t* out2, int32_t* out3,
                    cudaStream_t stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (n % kBlk != 0 || n / kBlk > 0x7fffffffLL || k < 1 || k > kMaxOperands) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* in[kMaxOperands] = {in0, in1, in2, in3};
  int32_t* out[kMaxOperands] = {out0, out1, out2, out3};
  for (int c = 0; c < k; ++c) {
    if (reinterpret_cast<uintptr_t>(out[c]) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Operands ops = make_operands(in, out, k);
  switch (k) {
    case 1:
      return static_cast<int>(launch_sort_blocks<1>(ops, n, stream));
    case 2:
      return static_cast<int>(launch_sort_blocks<2>(ops, n, stream));
    case 3:
      return static_cast<int>(launch_sort_blocks<3>(ops, n, stream));
    default:
      return static_cast<int>(launch_sort_blocks<4>(ops, n, stream));
  }
}

// One merge pass over n rows (a multiple of kBlk) of k operands: sorted runs
// of run_len rows (a positive multiple of kBlk) in in0..in3 become sorted
// runs of 2 * run_len; out0..out3 receive the first n_out rows.  split is a
// device buffer of n / kBlk int64.  Launches two kernels on `stream` and
// does not synchronise.  Returns cudaGetLastError().
int phj_merge_pass(int k, int64_t n, int64_t run_len, const int32_t* in0,
                   const int32_t* in1, const int32_t* in2, const int32_t* in3,
                   int64_t n_out, int32_t* out0, int32_t* out1, int32_t* out2,
                   int32_t* out3, int64_t* split, cudaStream_t stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (n % kBlk != 0 || n / kBlk > 0x7fffffffLL || run_len <= 0 ||
      run_len % kBlk != 0 || k < 1 || k > kMaxOperands) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* in[kMaxOperands] = {in0, in1, in2, in3};
  int32_t* out[kMaxOperands] = {out0, out1, out2, out3};
  const Operands ops = make_operands(in, out, k);
  switch (k) {
    case 1:
      return static_cast<int>(
          launch_merge_pass<1>(ops, n, run_len, split, n_out, stream));
    case 2:
      return static_cast<int>(
          launch_merge_pass<2>(ops, n, run_len, split, n_out, stream));
    case 3:
      return static_cast<int>(
          launch_merge_pass<3>(ops, n, run_len, split, n_out, stream));
    default:
      return static_cast<int>(
          launch_merge_pass<4>(ops, n, run_len, split, n_out, stream));
  }
}

}  // extern "C"
