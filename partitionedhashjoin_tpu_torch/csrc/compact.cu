// Stable stream-compaction kernels for Hopper (sm_90a).
//
// Replaces partitionedhashjoin_tpu/ops/pallas/compact.py::block_compact and
// its kernel body _compact_kernel_factory (K5): the rows i with keep[i] != 0
// move to the front in their original order, out_pos[j] = i for the j-th
// kept row, and each carried int32 column (at most kMaxCols) moves with
// them.  The output is gap-free: kept row j lands at position j, so the
// TPU kernel's aligned total equals the kept count and no sentinel gaps
// appear.  Rows whose position would be >= out_len are not written (the
// capacity of compact_columns); the count stays exact.
//
// What bounds it on this card: bytes.  keep is read (1 byte per row), and
// each column is read only at kept rows; the kept rows are written once per
// column plus pos.  The arithmetic is a prefix count.
//
// What the design does about it.  The TPU kernel sorts a (drop-flag << 13 |
// position) key through a 91-stage bitonic network per 8192-row block and
// writes 128-aligned rows with DMAs, because Mosaic has no scatter.  On
// CUDA a stable compaction is a scan, in three launches on one stream:
// 1. count_kernel: each block of kTile rows counts its kept rows;
// 2. scan_kernel: one block turns the counts into exclusive block offsets
//    and writes the total;
// 3. scatter_kernel: each block walks its tile in kRowsPerThread rounds of
//    kThreads consecutive rows (thread t takes row t of the round, so keep
//    loads are coalesced); a warp ballot and popc give each kept row its
//    rank in the warp, shared memory the warps before it (double-buffered
//    per round, so one barrier a round), and a running offset the rounds
//    before; kept rows then read their columns and store them at
//    consecutive positions.
// Pass 1 and pass 3 both read keep, so keep is read twice; a single-pass
// decoupled look-back scan is a later optimisation.
//
// C interface for ctypes: phj_compact returns cudaGetLastError() after the
// last launch (and after any launch that fails), so a refused launch reaches
// the caller.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;
constexpr int kTile = kThreads * kRowsPerThread;  // rows per block
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kMaxCols = 6;

struct Columns {
  const int32_t* in[kMaxCols];
  int32_t* out[kMaxCols];
};

__global__ void __launch_bounds__(kThreads)
    count_kernel(const uint8_t* __restrict__ keep, int64_t n,
                 int64_t* __restrict__ block_counts) {
  __shared__ unsigned int warp_counts[kWarps];
  const int64_t tile_begin = static_cast<int64_t>(blockIdx.x) * kTile;
  unsigned int kept = 0;
#pragma unroll 4
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t row =
        tile_begin + static_cast<int64_t>(k) * kThreads + threadIdx.x;
    kept += (row < n && __ldg(keep + row) != 0) ? 1u : 0u;
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    kept += __shfl_down_sync(0xffffffffu, kept, offset);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_counts[warp] = kept;
  }
  __syncthreads();
  if (warp == 0) {
    kept = lane < kWarps ? warp_counts[lane] : 0u;
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      kept += __shfl_down_sync(0xffffffffu, kept, offset);
    }
    if (lane == 0) {
      block_counts[blockIdx.x] = kept;
    }
  }
}

// Exclusive sum-scan of v across the warp: lane l gets the sum over lanes
// < l (0 for lane 0).
__device__ __forceinline__ int64_t warp_exclusive_sum(int64_t v, int lane) {
  int64_t inc = v;
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const int64_t up = __shfl_up_sync(0xffffffffu, inc, offset);
    if (lane >= offset) {
      inc += up;
    }
  }
  return inc - v;
}

// One block of kScanThreads: offsets[t] = sum(counts[0 .. t-1]) and
// *total = sum(counts).
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const int64_t* __restrict__ counts, int64_t n_blocks,
                int64_t* __restrict__ offsets, int64_t* __restrict__ total) {
  __shared__ int64_t warp_sums[kScanThreads / 32];
  const int64_t per_thread = (n_blocks + kScanThreads - 1) / kScanThreads;
  const int64_t begin = static_cast<int64_t>(threadIdx.x) * per_thread;
  const int64_t end =
      begin + per_thread < n_blocks ? begin + per_thread : n_blocks;
  int64_t mine = 0;
  for (int64_t t = begin; t < end; ++t) {
    mine += counts[t];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t prefix = warp_exclusive_sum(mine, lane);
  if (lane == 31) {
    warp_sums[warp] = prefix + mine;
  }
  __syncthreads();
  if (warp == 0) {
    const int64_t w = warp_sums[lane];  // kScanThreads / 32 == 32 warps
    const int64_t exc = warp_exclusive_sum(w, lane);
    warp_sums[lane] = exc;
    if (lane == 31) {
      *total = exc + w;
    }
  }
  __syncthreads();
  prefix += warp_sums[warp];
  for (int64_t t = begin; t < end; ++t) {
    offsets[t] = prefix;
    prefix += counts[t];
  }
}

__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const uint8_t* __restrict__ keep, int64_t n,
                   const int64_t* __restrict__ offsets, Columns cols,
                   int n_cols, int32_t* __restrict__ out_pos,
                   int64_t out_len) {
  __shared__ unsigned int warp_kept[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned int lanes_before = (1u << lane) - 1u;
  const int64_t tile_begin = static_cast<int64_t>(blockIdx.x) * kTile;
  int64_t base = offsets[blockIdx.x];

  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t row =
        tile_begin + static_cast<int64_t>(k) * kThreads + threadIdx.x;
    const bool kept = row < n && __ldg(keep + row) != 0;
    const unsigned int ballot = __ballot_sync(0xffffffffu, kept);
    unsigned int* round_kept = warp_kept[k & 1];
    if (lane == 0) {
      round_kept[warp] = __popc(ballot);
    }
    // One barrier a round: round k + 2 rewrites this buffer only after
    // every thread has passed round k + 1's barrier, i.e. finished reading.
    __syncthreads();
    unsigned int before = 0;
    unsigned int round_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned int c = round_kept[w];
      before += w < warp ? c : 0u;
      round_total += c;
    }
    if (kept) {
      const int64_t dest = base + before + __popc(ballot & lanes_before);
      if (dest < out_len) {
        out_pos[dest] = static_cast<int32_t>(row);
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          if (c < n_cols) {
            cols.out[c][dest] = __ldg(cols.in[c] + row);
          }
        }
      }
    }
    base += round_total;
  }
}

}  // namespace

extern "C" {

// Rows per block; the Python wrapper checks it against its own copy and
// sizes the scratch buffer from it.
int phj_compact_tile_rows() { return kTile; }

// Columns a call can carry besides pos.
int phj_compact_max_cols() { return kMaxCols; }

// Stable compaction (see the note at the top).  keep is a device pointer to
// n bytes (nonzero = keep; n < 2^31 so that pos fits int32); in0..in5 are
// int32 device columns of n rows and out0..out5 their outputs of out_len
// rows, the first n_cols of each used (the rest may be null); out_pos
// receives the original row index of each kept row; scratch is a device
// buffer of 2 * ceil(n / kTile) int64; *total (int64, device) receives the
// kept count, exact even when it exceeds out_len.  Positions >= the kept
// count are not written.  Launches on `stream` and does not synchronise.
// Returns cudaGetLastError() (0 = ok).
int phj_compact(const uint8_t* keep, int64_t n, int n_cols,
                const int32_t* in0, const int32_t* in1, const int32_t* in2,
                const int32_t* in3, const int32_t* in4, const int32_t* in5,
                int32_t* out0, int32_t* out1, int32_t* out2, int32_t* out3,
                int32_t* out4, int32_t* out5, int32_t* out_pos,
                int64_t out_len, int64_t* scratch, int64_t* total,
                cudaStream_t stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (n_cols < 0 || n_cols > kMaxCols || n > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n + kTile - 1) / kTile;
  const Columns cols = {{in0, in1, in2, in3, in4, in5},
                        {out0, out1, out2, out3, out4, out5}};
  int64_t* counts = scratch;
  int64_t* offsets = scratch + blocks;
  const unsigned int grid = static_cast<unsigned int>(blocks);
  count_kernel<<<grid, kThreads, 0, stream>>>(keep, n, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  scan_kernel<<<1, kScanThreads, 0, stream>>>(counts, blocks, offsets, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  scatter_kernel<<<grid, kThreads, 0, stream>>>(keep, n, offsets, cols, n_cols,
                                                out_pos, out_len);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
