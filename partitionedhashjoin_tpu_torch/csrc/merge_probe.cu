// Ranged merge-probe count kernels for Hopper (sm_90a), int32 and int64 keys.
//
// Replaces partitionedhashjoin_tpu/ops/pallas/merge_probe.py::
// ranged_merge_count_prepared and its kernel body _ranged_count_kernel (K1,
// int32), and _count_i64_planes_full / _count_i64_planes with their body
// _ranged_count_kernel_i64 (K3, int64): the number of rows of an ascending
// probe run b whose key occurs in an ascending build run a.  With
// exclude_int32_max (int32 only), only a[0, limit) is searched,
// limit = lower_bound(a, INT32_MAX), so no INT32_MAX probe counts (the
// validity protocol of ops/merge_join.py).  The int64 count has no such flag:
// it counts over the full int64 domain.
//
// What bounds it on this card: reads from device memory.  Every probe row is
// read once (4 or 8 bytes) and the build run is read in the ranges the probe
// tiles cover; the arithmetic is a few compares per row.  A row's binary
// search is a chain of dependent loads, so latency, not bandwidth, is what a
// thread waits on.
//
// What the design does about it:
// - One block per tile of kTile consecutive sorted probe rows.  Thread 0 finds
//   the tile's build range [lo, hi) from the tile's first and last key, so
//   every row then searches only that range, which for sorted probes is
//   narrow and stays hot in L1/L2.
// - Thread t takes rows t, t + kThreads, ... of the tile, so a warp's probe
//   loads are coalesced and its 32 searches walk nearly the same path.
// - Many resident blocks (256 threads each) hide the load latency.
// - A tile whose range is empty returns before any row is read.
// - Per-thread counts are summed by warp shuffles and shared memory, and one
//   atomicAdd per block adds the block's count to a 64-bit total.
//
// What the TPU kernels needed and these do not: lane-transposed build tiles,
// a static flattened work list, scalar-prefetched ranges, a run-start dedup
// and probe padding with its INT32_MAX / INT64_MAX correction.  They existed
// because Mosaic has no data-dependent loops and pads to (8, 128) tiles; here
// every row is searched once in its own range, so no row can be counted twice
// or padded.  Nor the int64 kernel's (hi, lo) int32 plane split: Mosaic is
// 32-bit, CUDA compares 64-bit keys natively.
//
// The same file holds the merge-probe payload kernel, replacing
// merge_probe.py::ranged_merge_payload_prepared and its body
// _ranged_payload_kernel (K4): for each row i of an ascending int32 probe
// run b, with lb = lower_bound(a[0, limit), b[i]) over the ascending build
// run a, a hit is lb < limit && a[lb] == b[i]; then pos[i] = lb + 1 and
// pay[i] = a_payloads[lb], else both are 0.  The LOWEST matching position
// wins by construction of the lower bound, also for runs that cross tiles.
// It shares K1's tiling and search: one block per kTile sorted probe rows,
// the tile's build range from two searches by thread 0, then one search per
// row inside the range.  It reads a, a_payloads and b and writes pay and pos
// (all int32), each thread writing its strided rows, so a warp's stores are
// coalesced.  What bounds it: bytes (b, pay and pos are 12 of the 12.4
// bytes per probe row at 10M x 200M), but as for K1 the dependent loads of
// the search set its time.  Unlike the count, a tile with an empty range
// still writes its zeros.  Not carried over from the TPU kernel: its work
// list, lane-transposed tiles, double-buffered DMAs, the "first visit"
// overlay and the run-start test q > prev_last, all of which exist because
// Mosaic has no data-dependent loops.
//
// C interface for ctypes: each entry returns cudaGetLastError() after the
// launch, so a refused launch reaches the caller.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;
constexpr int kTile = kThreads * kRowsPerThread;  // probe rows per block
constexpr int kWarps = kThreads / 32;
constexpr int32_t kInt32Max = 2147483647;

// First position in [lo, hi) whose key is >= q, or hi.
template <typename Key>
__device__ __forceinline__ int64_t lower_bound(const Key* __restrict__ a,
                                               int64_t lo, int64_t hi, Key q) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// First position in [lo, hi) whose key is > q, or hi.
template <typename Key>
__device__ __forceinline__ int64_t upper_bound(const Key* __restrict__ a,
                                               int64_t lo, int64_t hi, Key q) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Key is int (int32) or long long (int64), the types __ldg takes.
// exclude_int32_max is only ever set for int32 keys.
template <typename Key>
__global__ void __launch_bounds__(kThreads)
    ranged_count_kernel(const Key* __restrict__ a, int64_t n_a,
                        const Key* __restrict__ b, int64_t n_b,
                        int exclude_int32_max,
                        unsigned long long* __restrict__ total) {
  __shared__ int64_t range[2];
  __shared__ unsigned int warp_counts[kWarps];

  const int64_t tile_begin = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t tile_end =
      tile_begin + kTile < n_b ? tile_begin + kTile : n_b;

  if (threadIdx.x == 0) {
    const int64_t limit =
        exclude_int32_max ? lower_bound(a, 0, n_a, static_cast<Key>(kInt32Max))
                          : n_a;
    const int64_t lo = lower_bound(a, 0, limit, __ldg(b + tile_begin));
    range[0] = lo;
    range[1] = upper_bound(a, lo, limit, __ldg(b + tile_end - 1));
  }
  __syncthreads();
  const int64_t lo = range[0];
  const int64_t hi = range[1];
  if (lo >= hi) {
    return;  // the same for every thread of the block: no key of it is in a
  }

  unsigned int found = 0;
#pragma unroll 4
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t row =
        tile_begin + static_cast<int64_t>(k) * kThreads + threadIdx.x;
    if (row < tile_end) {
      const Key q = __ldg(b + row);
      const int64_t pos = lower_bound(a, lo, hi, q);
      found += (pos < hi && __ldg(a + pos) == q) ? 1u : 0u;
    }
  }

#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    found += __shfl_down_sync(0xffffffffu, found, offset);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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

// K4: see the note at the top.  Every probe row of the tile is written.
__global__ void __launch_bounds__(kThreads)
    ranged_payload_kernel(const int32_t* __restrict__ a,
                          const int32_t* __restrict__ a_payloads, int64_t n_a,
                          const int32_t* __restrict__ b, int64_t n_b,
                          int exclude_int32_max, int32_t* __restrict__ pay,
                          int32_t* __restrict__ pos) {
  __shared__ int64_t range[2];

  const int64_t tile_begin = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t tile_end =
      tile_begin + kTile < n_b ? tile_begin + kTile : n_b;

  if (threadIdx.x == 0) {
    const int64_t limit =
        exclude_int32_max ? lower_bound(a, 0, n_a, kInt32Max) : n_a;
    const int64_t lo = lower_bound(a, 0, limit, __ldg(b + tile_begin));
    range[0] = lo;
    range[1] = upper_bound(a, lo, limit, __ldg(b + tile_end - 1));
  }
  __syncthreads();
  const int64_t lo = range[0];
  const int64_t hi = range[1];

#pragma unroll 4
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t row =
        tile_begin + static_cast<int64_t>(k) * kThreads + threadIdx.x;
    if (row < tile_end) {
      const int32_t q = __ldg(b + row);
      // the global lower bound of q lies in [lo, hi]: lo and hi bound the
      // tile's first and last keys
      const int64_t p = lower_bound(a, lo, hi, q);
      const bool hit = p < hi && __ldg(a + p) == q;
      pos[row] = hit ? static_cast<int32_t>(p + 1) : 0;
      pay[row] = hit ? __ldg(a_payloads + p) : 0;
    }
  }
}

template <typename Key>
int launch_count(const Key* a, int64_t n_a, const Key* b, int64_t n_b,
                 int exclude_int32_max, unsigned long long* total,
                 cudaStream_t stream) {
  if (n_a <= 0 || n_b <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int64_t blocks = (n_b + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ranged_count_kernel<Key><<<static_cast<unsigned int>(blocks), kThreads, 0,
                             stream>>>(a, n_a, b, n_b, exclude_int32_max,
                                       total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Probe rows per block; the Python wrapper checks it against its own copy.
int phj_merge_probe_tile_rows() { return kTile; }

// Adds to *total the count of b's rows whose key is in a (see the note at the
// top).  a and b are device pointers to ascending int32 runs; *total is a
// zeroed 64-bit counter on the same device.  Launches on `stream` and does
// not synchronise.  Returns cudaGetLastError() after the launch (0 = ok).
int phj_merge_probe_count(const int32_t* a, int64_t n_a, const int32_t* b,
                          int64_t n_b, int exclude_int32_max,
                          unsigned long long* total, cudaStream_t stream) {
  return launch_count<int>(a, n_a, b, n_b, exclude_int32_max, total, stream);
}

// The same count for ascending int64 runs, over the full int64 domain.
int phj_merge_probe_count_i64(const int64_t* a, int64_t n_a, const int64_t* b,
                              int64_t n_b, unsigned long long* total,
                              cudaStream_t stream) {
  return launch_count<long long>(reinterpret_cast<const long long*>(a), n_a,
                                 reinterpret_cast<const long long*>(b), n_b, 0,
                                 total, stream);
}

// For each of b's n_b rows, writes pos = 1 + the lowest position of its key
// in a (0 = miss) and pay = a_payloads at that position (0 = miss); see the
// note at the top.  a, a_payloads, b, pay and pos are device pointers to
// int32; a and b ascend; n_a < 2^31 - 1 so that pos fits.  Launches on
// `stream` and does not synchronise.  Returns cudaGetLastError() (0 = ok).
int phj_merge_probe_payload(const int32_t* a, const int32_t* a_payloads,
                            int64_t n_a, const int32_t* b, int64_t n_b,
                            int exclude_int32_max, int32_t* pay, int32_t* pos,
                            cudaStream_t stream) {
  if (n_a <= 0 || n_b <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int64_t blocks = (n_b + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL || n_a >= 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ranged_payload_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          stream>>>(a, a_payloads, n_a, b, n_b,
                                    exclude_int32_max, pay, pos);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
