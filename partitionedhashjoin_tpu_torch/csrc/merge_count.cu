// Fused merge-count kernel for Hopper (sm_90a).
//
// Replaces partitionedhashjoin_tpu/ops/pallas/merge_count.py::
// merge_count_sorted and its kernel body _merge_count_kernel (K2): one pass
// over the merged, sorted (int32 key, is_build) stream of the sort-merge
// join.  It counts the rows i where
//   !is_build[i]  &&  key[i] != INT32_MIN  &&
//   key[i] == max over j <= i of (is_build[j] ? key[j] : INT32_MIN),
// i.e. probe rows whose key equals the most recent build key (keys ascend,
// and build rows precede equal-keyed probe rows).  INT32_MIN doubles as "no
// build key yet"; the caller adds the INT32_MIN matches back
// (ops/sort_merge.py).
//
// What bounds it on this card: bytes.  Each row is read once (4 bytes of key,
// 1 byte of tag); the work is a max and a compare per row.
//
// What the design does about it.  The TPU kernel carries the running maximum
// in SMEM from one grid step to the next, because its grid runs in order.
// CUDA blocks run concurrently and in no order, so the carry is made in three
// launches on one stream:
// 1. block_max_kernel: each block of kTile rows writes the maximum build key
//    of its tile (INT32_MIN if it has none).
// 2. carry_scan_kernel: one block turns those maxima into exclusive carries,
//    carry[t] = max(block_max[0..t-1]).
// 3. count_kernel: each block re-reads its tile, runs an inclusive max-scan
//    seeded with its carry (per-thread serial scan over kRowsPerThread
//    consecutive rows, then __shfl_up_sync across the warp and shared memory
//    across the warps), counts its hits and makes one atomicAdd to a 64-bit
//    total.
// Pass 1 and pass 3 each read the stream once, so the kernel moves twice the
// bytes of the one-pass bound; a single-pass decoupled look-back scan is a
// later optimisation.
//
// C interface for ctypes: phj_merge_count returns cudaGetLastError() after
// the last launch (and after any launch that fails), so a refused launch
// reaches the caller.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;
constexpr int kTile = kThreads * kRowsPerThread;  // rows per block
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int32_t kInt32Min = -2147483647 - 1;

__device__ __forceinline__ int32_t warp_max(int32_t v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = max(v, __shfl_down_sync(0xffffffffu, v, offset));
  }
  return v;  // lane 0 holds the warp's maximum
}

// Exclusive max-scan of v across the warp: lane l gets max(v of lanes < l),
// INT32_MIN for lane 0.
__device__ __forceinline__ int32_t warp_exclusive_max(int32_t v, int lane) {
  int32_t inc = v;
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const int32_t up = __shfl_up_sync(0xffffffffu, inc, offset);
    if (lane >= offset) {
      inc = max(inc, up);
    }
  }
  const int32_t exc = __shfl_up_sync(0xffffffffu, inc, 1);
  return lane == 0 ? kInt32Min : exc;
}

__global__ void __launch_bounds__(kThreads)
    block_max_kernel(const int32_t* __restrict__ keys,
                     const uint8_t* __restrict__ is_build, int64_t n,
                     int32_t* __restrict__ block_max) {
  __shared__ int32_t warp_best[kWarps];
  const int64_t tile_begin = static_cast<int64_t>(blockIdx.x) * kTile;
  int32_t best = kInt32Min;
#pragma unroll 4
  for (int k = 0; k < kRowsPerThread; ++k) {
    // strided rows: a warp's loads are coalesced
    const int64_t row =
        tile_begin + static_cast<int64_t>(k) * kThreads + threadIdx.x;
    if (row < n && __ldg(is_build + row) != 0) {
      best = max(best, __ldg(keys + row));
    }
  }
  best = warp_max(best);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_best[warp] = best;
  }
  __syncthreads();
  if (warp == 0) {
    best = warp_max(lane < kWarps ? warp_best[lane] : kInt32Min);
    if (lane == 0) {
      block_max[blockIdx.x] = best;
    }
  }
}

// One block of kScanThreads: carry[t] = max(block_max[0 .. t-1]).
__global__ void __launch_bounds__(kScanThreads)
    carry_scan_kernel(const int32_t* __restrict__ block_max, int64_t n_blocks,
                      int32_t* __restrict__ carry) {
  __shared__ int32_t warp_inc[kScanThreads / 32];
  const int64_t per_thread = (n_blocks + kScanThreads - 1) / kScanThreads;
  const int64_t begin = static_cast<int64_t>(threadIdx.x) * per_thread;
  const int64_t end =
      begin + per_thread < n_blocks ? begin + per_thread : n_blocks;
  int32_t mine = kInt32Min;
  for (int64_t t = begin; t < end; ++t) {
    mine = max(mine, block_max[t]);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t prefix = warp_exclusive_max(mine, lane);
  if (lane == 31) {
    warp_inc[warp] = max(prefix, mine);
  }
  __syncthreads();
  if (warp == 0) {
    const int32_t w = warp_inc[lane];  // kScanThreads / 32 == 32 warps
    warp_inc[lane] = warp_exclusive_max(w, lane);
  }
  __syncthreads();
  prefix = max(prefix, warp_inc[warp]);
  for (int64_t t = begin; t < end; ++t) {
    carry[t] = prefix;
    prefix = max(prefix, block_max[t]);
  }
}

__global__ void __launch_bounds__(kThreads)
    count_kernel(const int32_t* __restrict__ keys,
                 const uint8_t* __restrict__ is_build, int64_t n,
                 const int32_t* __restrict__ carry,
                 unsigned long long* __restrict__ total) {
  __shared__ int32_t warp_inc[kWarps];
  __shared__ unsigned int warp_counts[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // thread t owns kRowsPerThread consecutive rows, so its serial scan runs
  // in stream order
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTile +
                        static_cast<int64_t>(threadIdx.x) * kRowsPerThread;

  int32_t key[kRowsPerThread];
  bool build[kRowsPerThread];
  int32_t mine = kInt32Min;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t row = first + k;
    const bool live = row < n;
    key[k] = live ? __ldg(keys + row) : kInt32Min;
    build[k] = live && __ldg(is_build + row) != 0;
    if (build[k]) {
      mine = max(mine, key[k]);
    }
  }

  // running max before this thread's first row: the block's carry, the
  // warps before this one, the lanes before this one
  int32_t prefix = warp_exclusive_max(mine, lane);
  if (lane == 31) {
    warp_inc[warp] = max(prefix, mine);
  }
  __syncthreads();
  if (warp == 0) {
    const int32_t w = lane < kWarps ? warp_inc[lane] : kInt32Min;
    const int32_t exc = warp_exclusive_max(w, lane);
    if (lane < kWarps) {
      warp_inc[lane] = exc;
    }
  }
  __syncthreads();
  prefix = max(prefix, max(warp_inc[warp], carry[blockIdx.x]));

  unsigned int found = 0;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (build[k]) {
      prefix = max(prefix, key[k]);
    } else if (first + k < n && key[k] != kInt32Min && key[k] == prefix) {
      ++found;
    }
  }

#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    found += __shfl_down_sync(0xffffffffu, found, offset);
  }
  if (lane == 0) {
    warp_counts[warp] = found;
  }
  __syncthreads();
  if (warp == 0) {
    found = lane < kWarps ? warp_counts[lane] : 0u;
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      found += __shfl_down_sync(0xffffffffu, found, offset);
    }
    if (lane == 0 && found != 0) {
      atomicAdd(total, static_cast<unsigned long long>(found));
    }
  }
}

}  // namespace

extern "C" {

// Rows per block; the Python wrapper checks it against its own copy and
// sizes the scratch buffer from it.
int phj_merge_count_tile_rows() { return kTile; }

// Adds to *total the count described at the top.  keys (int32) and is_build
// (one byte per row, nonzero = build row) are device pointers to n rows in
// merged sorted order; scratch is a device buffer of 2 * ceil(n / kTile)
// int32; *total is a zeroed 64-bit counter.  Launches on `stream` and does
// not synchronise.  Returns cudaGetLastError() (0 = ok).
int phj_merge_count(const int32_t* keys, const uint8_t* is_build, int64_t n,
                    int32_t* scratch, unsigned long long* total,
                    cudaStream_t stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int64_t blocks = (n + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int32_t* block_max = scratch;
  int32_t* carry = scratch + blocks;
  const unsigned int grid = static_cast<unsigned int>(blocks);
  block_max_kernel<<<grid, kThreads, 0, stream>>>(keys, is_build, n,
                                                  block_max);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  carry_scan_kernel<<<1, kScanThreads, 0, stream>>>(block_max, blocks, carry);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  count_kernel<<<grid, kThreads, 0, stream>>>(keys, is_build, n, carry, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
