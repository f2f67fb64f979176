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
// What bounds it on this card: bytes.  Every probe row is read once (4
// bytes for K1, 8 for K3) and the build run once (each tile reads the build
// range its keys span; ranges of neighbouring tiles share at most one key),
// so at 10M x 200M the compulsory traffic is 0.84 GB (K1) or 1.68 GB (K3).
// The count itself is a compare per row.  A binary search per probe row in
// device memory, after thread 0 of every block has searched the whole
// build run for the tile's range and the INT32_MAX limit, is bound instead
// by its chains of dependent loads: on an H100 at 10M x 200M it took as
// long for int64 keys as for int32, with twice the bytes.
//
// What the design does about it:
// - tile_ranges_kernel, a first launch: one thread per probe-tile boundary
//   finds every tile's build range [lo, hi) at once: from the first
//   occurrence of the tile's first key, or of the next larger build key, to
//   the first occurrence of its last key (duplicate build keys after it are
//   left out, so a tile of one repeated key reads one build row however long
//   that key's build run is; the range is empty when no build key lies
//   between the tile's first and last keys).  One more thread finds the
//   limit.  They go into a scratch
//   buffer of 2 n_tiles + 1 int64 that the wrapper allocates.  The count
//   kernel clamps both ends to the limit (lower_bound over a[0, limit) is
//   min(limit, lower_bound over a)), so the limit is found once per call.
// - ranged_count_kernel, one block of 256 threads per tile of kTile = 4,096
//   sorted probe rows: the tile is copied into shared memory with 16-byte
//   cp.async (element copies where b is not 16-byte aligned or the tile is
//   ragged), issued before the block reads its range so that the two
//   overlap; then the first chunk of its build range, up to kChunk rows
//   (16 KB: 4,096 int32 or 2,048 int64 keys).
// - The count is a merge of the two sorted runs in shared memory: the merge
//   of m build and n probe rows (build rows first on equal keys) is cut
//   along its diagonals into one span per thread, each found by one short
//   merge-path search in shared memory; a span has an odd length, so the
//   threads of a warp start on distinct banks.  Each thread walks its span
//   keeping the last build key it passed: a probe row counts when that key
//   equals it, so it counts once however many build rows share its key,
//   also when its run is cut between threads.
// - A range longer than one chunk is walked chunk by chunk (a sparse probe
//   tail over a dense build).  Chunk c takes the probe rows with keys in
//   (last key of chunk c - 1, last key of chunk c]; every build occurrence
//   of such a key starts in chunk c, so each row meets its key in exactly
//   one chunk, exactly, also for a duplicate build run across a chunk edge.
//   The walk stops at the first chunk past the tile's last probe row.
//   There is no per-row search and no fallback path.
// - A tile whose range is empty waits for its copy and returns.  Per-thread
//   counts are summed by warp shuffles and shared memory, and one atomicAdd
//   per block adds the block's count to a 64-bit total.
//
// What the TPU kernels needed and these do not: lane-transposed build tiles,
// a static flattened work list, scalar-prefetched ranges, a run-start dedup
// and probe padding with its INT32_MAX / INT64_MAX correction.  They existed
// because Mosaic has no data-dependent loops and pads to (8, 128) tiles;
// here every probe row meets the merge once, so no row can be counted twice
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
// Build rows per shared-memory chunk of the count kernel: 16 KB, so 4,096
// int32 (K1) or 2,048 int64 (K3) keys.
template <typename Key>
constexpr int kChunk = 16384 / static_cast<int>(sizeof(Key));

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

// 16-byte and one-key asynchronous copies from device to shared memory.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

template <typename Key>
__device__ __forceinline__ void cp_async_key(Key* dst, const Key* src) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(Key) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies n keys from src to dst (shared) with the block's threads:
// 16-byte copies when both ends allow it, else one key per copy.
template <typename Key>
__device__ __forceinline__ void stage(Key* dst, const Key* src, int n) {
  constexpr int kPerVec = 16 / static_cast<int>(sizeof(Key));
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && n % kPerVec == 0) {
    for (int v = threadIdx.x; v < n / kPerVec; v += kThreads) {
      cp_async_16(dst + v * kPerVec, src + v * kPerVec);
    }
  } else {
    for (int r = threadIdx.x; r < n; r += kThreads) {
      cp_async_key(dst + r, src + r);
    }
  }
}

// First position in [lo, hi) of the shared run s whose key is > q, or hi.
template <typename Key>
__device__ __forceinline__ int upper_bound_shared(const Key* s, int lo, int hi,
                                                  Key q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// This thread's share of the count of q[0, n) rows whose key is in
// s_a[0, m), both ascending in shared memory, m, n >= 1: the merge of the
// two (build rows first on equal keys) is cut into spans of an odd length
// span >= (m + n) / kThreads, one per thread.
template <typename Key>
__device__ __forceinline__ unsigned int merge_count_span(const Key* s_a, int m,
                                                         const Key* q, int n) {
  const int total = m + n;
  const int span = ((total + kThreads - 1) / kThreads) | 1;
  const int d0 = static_cast<int>(threadIdx.x) * span;
  if (d0 >= total) {
    return 0u;
  }
  const int d1 = d0 + span < total ? d0 + span : total;
  // merge path: i build rows precede diagonal d0 when s_a[i - 1] <=
  // q[d0 - i] and q[d0 - i - 1] < s_a[i]
  int i = d0 - n > 0 ? d0 - n : 0;
  int end = d0 < m ? d0 : m;
  while (i < end) {
    const int mid = (i + end) >> 1;
    if (s_a[mid] <= q[d0 - 1 - mid]) {
      i = mid + 1;
    } else {
      end = mid;
    }
  }
  int j = d0 - i;
  // last: the last build key the merge has passed, the largest <= q[j]
  Key last = s_a[i > 0 ? i - 1 : 0];
  Key ai = s_a[i < m ? i : m - 1];
  Key qj = q[j < n ? j : n - 1];
  unsigned int found = 0;
  for (int d = d0; d < d1 && j < n; ++d) {
    if (i < m && ai <= qj) {
      last = ai;
      ++i;
      ai = s_a[i < m ? i : m - 1];
    } else {
      found += (i > 0 && last == qj) ? 1u : 0u;
      ++j;
      qj = q[j < n ? j : n - 1];
    }
  }
  return found;
}

// K1 / K3: see the note at the top.  ranges holds (lo, hi) of every tile
// and, last, the limit (tile_ranges_kernel).  Key is int (int32) or long
// long (int64).  Dynamic shared memory: kTile + kChunk<Key> keys.
template <typename Key>
__global__ void __launch_bounds__(kThreads)
    ranged_count_kernel(const Key* __restrict__ a, const Key* __restrict__ b,
                        int64_t n_b, const int64_t* __restrict__ ranges,
                        int64_t n_tiles,
                        unsigned long long* __restrict__ total) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  Key* s_probe = reinterpret_cast<Key*>(shared_raw);
  Key* s_build = s_probe + kTile;
  __shared__ unsigned int warp_counts[kWarps];

  const int64_t tile = blockIdx.x;
  const int64_t tile_begin = tile * kTile;
  const int n_p =
      static_cast<int>(n_b - tile_begin < kTile ? n_b - tile_begin : kTile);
  stage(s_probe, b + tile_begin, n_p);  // in flight while the range is read

  const int64_t limit = __ldg(ranges + 2 * n_tiles);
  const int64_t lo_raw = __ldg(ranges + 2 * tile);
  const int64_t hi_raw = __ldg(ranges + 2 * tile + 1);
  const int64_t lo = lo_raw < limit ? lo_raw : limit;
  const int64_t hi = hi_raw < limit ? hi_raw : limit;
  if (lo >= hi) {
    cp_async_wait_all();  // the copy must land before the block's memory
    return;               // is handed on; the same for every thread
  }

  unsigned int found = 0;
  int p0 = 0;  // first probe row of the chunk: keys > the last chunk's last
  for (int64_t c0 = lo; c0 < hi; c0 += kChunk<Key>) {
    const int m =
        static_cast<int>(hi - c0 < kChunk<Key> ? hi - c0 : kChunk<Key>);
    if (c0 != lo) {
      __syncthreads();  // every thread is done with the previous chunk
    }
    stage(s_build, a + c0, m);
    cp_async_wait_all();
    __syncthreads();
    // the chunk's probe rows: keys in (last key of chunk - 1, last key]
    const int p1 = c0 + m >= hi ? n_p
                                : upper_bound_shared(s_probe, p0, n_p,
                                                     s_build[m - 1]);
    if (p1 > p0) {
      found += merge_count_span(s_build, m, s_probe + p0, p1 - p0);
    }
    p0 = p1;
    if (p0 >= n_p) {
      break;  // the same for every thread: no probe row left
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

// One thread per probe-tile boundary: ranges[2 t] = lower_bound(a, first
// key of tile t), ranges[2 t + 1] = lower_bound(a, its last key), plus one
// if that key is in a; thread 2 n_tiles writes the limit
// (lower_bound(a, INT32_MAX) with exclude_int32_max, else n_a).
template <typename Key>
__global__ void __launch_bounds__(kThreads)
    tile_ranges_kernel(const Key* __restrict__ a, int64_t n_a,
                       const Key* __restrict__ b, int64_t n_b, int64_t n_tiles,
                       int exclude_int32_max, int64_t* __restrict__ ranges) {
  const int64_t slot =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (slot < 2 * n_tiles) {
    const int64_t tile_begin = (slot >> 1) * kTile;
    if ((slot & 1) == 0) {
      ranges[slot] = lower_bound(a, 0, n_a, __ldg(b + tile_begin));
    } else {
      const int64_t last =
          (tile_begin + kTile < n_b ? tile_begin + kTile : n_b) - 1;
      const Key q = __ldg(b + last);
      const int64_t p = lower_bound(a, 0, n_a, q);
      ranges[slot] = p < n_a && __ldg(a + p) == q ? p + 1 : p;
    }
  } else if (slot == 2 * n_tiles) {
    ranges[slot] = exclude_int32_max
                       ? lower_bound(a, 0, n_a, static_cast<Key>(kInt32Max))
                       : n_a;
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
                 int exclude_int32_max, int64_t* ranges,
                 unsigned long long* total, cudaStream_t stream) {
  if (n_a <= 0 || n_b <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int64_t tiles = (n_b + kTile - 1) / kTile;
  if (tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t range_blocks = (2 * tiles + 1 + kThreads - 1) / kThreads;
  tile_ranges_kernel<Key><<<static_cast<unsigned int>(range_blocks), kThreads,
                            0, stream>>>(a, n_a, b, n_b, tiles,
                                         exclude_int32_max, ranges);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int smem = static_cast<int>((kTile + kChunk<Key>) * sizeof(Key));
  err = cudaFuncSetAttribute(ranged_count_kernel<Key>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  ranged_count_kernel<Key><<<static_cast<unsigned int>(tiles), kThreads, smem,
                             stream>>>(a, b, n_b, ranges, tiles, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Probe rows per block; the Python wrapper checks it against its own copy.
int phj_merge_probe_tile_rows() { return kTile; }

// Adds to *total the count of b's rows whose key is in a (see the note at the
// top).  a and b are device pointers to ascending int32 runs; ranges is a
// device scratch buffer of 2 ceil(n_b / kTile) + 1 int64; *total is a
// zeroed 64-bit counter on the same device.  Two launches on `stream`, no
// synchronisation.  Returns cudaGetLastError() after the launches (0 = ok).
int phj_merge_probe_count(const int32_t* a, int64_t n_a, const int32_t* b,
                          int64_t n_b, int exclude_int32_max, int64_t* ranges,
                          unsigned long long* total, cudaStream_t stream) {
  return launch_count<int>(a, n_a, b, n_b, exclude_int32_max, ranges, total,
                           stream);
}

// The same count for ascending int64 runs, over the full int64 domain.
int phj_merge_probe_count_i64(const int64_t* a, int64_t n_a, const int64_t* b,
                              int64_t n_b, int64_t* ranges,
                              unsigned long long* total, cudaStream_t stream) {
  return launch_count<long long>(reinterpret_cast<const long long*>(a), n_a,
                                 reinterpret_cast<const long long*>(b), n_b, 0,
                                 ranges, total, stream);
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
