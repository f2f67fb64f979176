// The chained table's kernels for Hopper (sm_90a): its build pass and its
// count probe.
//
// chained_count_kernel replaces no TPU kernel.  The JAX package's chained
// probe (partitionedhashjoin_tpu/ops/hash_table.py, _probe_chained_count_chunk
// and _window) is jnp window gathers, and the port ran the same windows as
// torch ops: PROBE_WINDOW = 4 gathers of every probe row's chain entries,
// each written to device memory, compared, masked and read back, then a tail
// compacted on the host.  This kernel counts the same thing in one launch.
//
// What it computes (the Get semantics of ops/hash_table.probe_chained_count):
// for each probe row i in [skip, n), bucket b = hashes[i] & mask; the row
// counts once if some entry of entry_keys[offsets[b], offsets[b + 1]) equals
// keys[i], compared at int64 when the two key widths differ.  A bucket id
// >= num_buckets (possible only through a caller's bucket override) is an
// empty chain.  The count is added to *total.
//
// What bounds it on this card: bytes streamed (the probe keys and their
// 32-bit hashes, 8 or 12 bytes a row) plus two dependent random sectors a
// row: one of offsets (both bounds share it, bar a line edge) and one of
// entry_keys (a chain's entries are contiguous, and a chain is about one
// entry long at the tables' load factor <= 1).  The random loads are latency
// bound: each waits on the one before it, so the card is only busy if many
// rows are in flight at once.
//
// What the design does about it:
// - each thread owns kRows = 4 consecutive rows and loads their keys and
//   hashes as 16-byte vectors (one uint4 of hashes; one int4 or two
//   longlong2 of keys) when both columns are 16-byte aligned, with the
//   streaming hint (__ldcs, evict first), so that 2.4 GB of streamed columns
//   do not push a hot table out of L2.  A view that is not aligned (a
//   chunk of a chunked probe) loads the same rows one by one;
// - it then issues the offsets loads of all four rows, then the first entry
//   loads of all four, before any compare, and walks longer chains four
//   rows abreast in the same way, so each thread has up to eight
//   independent loads in flight where a row-at-a-time walk has one or two;
// - it reads a chain in 16-byte chunks aligned to 16 bytes of memory (four
//   int32 or two int64 entries), so the next entries of a chain are most
//   often in the chunk already loaded: a chain of a few entries costs one
//   load, not one a step (on 128M uniform int32 keys, 1.46 entries walked a
//   row, this measured 10% faster than one entry a load).  Entries of a
//   chunk outside the chain are masked off.  A chunk holds at least one
//   entry of the table and never crosses a page, so reading the rest of it
//   stays in memory the table's pages map, even where it lies before
//   entry_keys[0] or after its last entry;
// - the grid is one wave, sized from the SM count and the kernel's
//   occupancy, over a grid-stride loop of 4-row groups;
// - each thread counts in a register; a warp shuffle and shared memory sum a
//   block's counts, and the block adds its 64-bit sum to *total with one
//   atomicAdd.  Integer sums are exact in any order, so the count is the
//   same on every run.
//
// chained_build_kernel replaces no TPU kernel either.  The JAX package builds
// the table (hash_table.py, build_chained_from_buckets) with one stable sort
// of (bucket, key, row), then a scatter-add of ones into a bucket histogram,
// a cumsum of it and a max; the port ran the same as torch ops after its
// sort (bincount, which reads the ids' min and max back to the host before
// it launches, a scan, a cat, two casts and a max: six launches, two waits
// and three int64 columns of num_buckets words).  The sort already puts the
// ids in order, so the kernel takes the sorted ids and the sort's
// permutation and writes the table in one pass:
// - offsets[b] is the first row i whose sorted id is >= b, for b in
//   [0, num_buckets]: row i writes offsets[b] = i for every b in
//   (c(sorted[i - 1]), c(sorted[i])], with c clamping an id to
//   [-1, num_buckets] and sorted[-1] read as -1; the row n - 1 also writes
//   offsets[b] = n for b up to num_buckets.  So each of the num_buckets + 1
//   words is written exactly once, with no memset and no atomics, and an id
//   at or past num_buckets falls in no chain (offsets[num_buckets] counts
//   the ids below it, as the histogram's drop did);
// - entry_rows[i] = order[i] as int32;
// - max_chain: a row that starts a run of an id in [0, num_buckets) measures
//   it, inside its group where the run ends there, else by an exponential
//   then binary search for the run's end (O(log L) loads for a chain of L),
//   so one long chain costs no thread a walk; a block's longest goes to
//   *max_chain by one atomicMax.
// The key gather entry_keys = keys[order] stays outside: on an H100, fused
// into this pass it read 0.44-0.48 ms at 10M int64 keys into 2^24 buckets
// against 0.43 for this pass plus the library's gather (5.57-5.60 against
// 5.75-5.82 ms at 128M int32 keys into 2^27), so the fusion is not taken.
// What bounds it: the bytes streamed, 4 or 8 of sorted ids, 8 of order and
// 4 of entry_rows a row, and 4 a bucket of offsets.  What the design does:
// - each thread owns kRows = 4 rows, read and written as 16-byte vectors
//   when the columns are 16-byte aligned (evict-first hints: nothing reads
//   them again in this pass), in one grid-stride wave of warp-uniform steps;
// - a warp's 32 groups write one contiguous run of offsets, so the warp
//   stages it in shared memory (kStage words) and stores it with
//   neighbouring lanes on neighbouring words; each lane storing its own
//   offsets, 4 to 16 bytes apart, measured 1.73-1.78 ms at 128M rows on
//   an H100 against 1.18 staged.  A run longer than the stage (empty
//   buckets far past the rows' density) is stored lane by lane;
// - a lane takes the id before its group from the lane before it by a
//   shuffle, so only lane 0 loads it.

// C interface for ctypes: each entry point returns cudaGetLastError() after
// its launch, so a refused launch reaches the caller.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // rows a thread owns per step: one uint4 of hashes
constexpr unsigned int kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T stream_load(const T* p) {
  if constexpr (sizeof(T) == 8) {
    return static_cast<T>(__ldcs(reinterpret_cast<const long long*>(p)));
  } else {
    return static_cast<T>(__ldcs(reinterpret_cast<const int*>(p)));
  }
}

// The keys and hashes of rows [i0, i0 + kRows): 16-byte vector loads when
// kVec and the group is whole, else one row at a time up to n.
template <typename ProbeT, bool kVec>
__device__ __forceinline__ void load_rows(const ProbeT* __restrict__ keys,
                                          const uint32_t* __restrict__ hashes,
                                          int64_t i0, int64_t n,
                                          ProbeT (&key)[kRows],
                                          uint32_t (&hash)[kRows]) {
  if (kVec && i0 + kRows <= n) {
    const uint4 h = __ldcs(reinterpret_cast<const uint4*>(hashes + i0));
    hash[0] = h.x;
    hash[1] = h.y;
    hash[2] = h.z;
    hash[3] = h.w;
    if constexpr (sizeof(ProbeT) == 8) {
      const longlong2* k = reinterpret_cast<const longlong2*>(keys + i0);
      const longlong2 k0 = __ldcs(k);
      const longlong2 k1 = __ldcs(k + 1);
      key[0] = k0.x;
      key[1] = k0.y;
      key[2] = k1.x;
      key[3] = k1.y;
    } else {
      const int4 k = __ldcs(reinterpret_cast<const int4*>(keys + i0));
      key[0] = k.x;
      key[1] = k.y;
      key[2] = k.z;
      key[3] = k.w;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    key[r] = 0;
    hash[r] = 0;
    if (i0 + r < n) {
      key[r] = stream_load(keys + i0 + r);
      hash[r] = stream_load(hashes + i0 + r);
    }
  }
}

// The 16-byte chunk of entries at p (16-byte aligned): four int32 or two
// int64 entries.
__device__ __forceinline__ void load_chunk(const int32_t* p, int32_t (&e)[4]) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  e[0] = v.x;
  e[1] = v.y;
  e[2] = v.z;
  e[3] = v.w;
}

__device__ __forceinline__ void load_chunk(const int64_t* p, int64_t (&e)[2]) {
  const longlong2 v = *reinterpret_cast<const longlong2*>(p);
  e[0] = v.x;
  e[1] = v.y;
}

template <typename ProbeT, typename EntryT>
__device__ __forceinline__ bool same_key(EntryT entry, ProbeT key) {
  if constexpr (std::is_same_v<ProbeT, EntryT>) {
    return entry == key;
  } else {
    return static_cast<int64_t>(entry) == static_cast<int64_t>(key);
  }
}

template <typename ProbeT, typename EntryT, bool kVec>
__global__ void __launch_bounds__(kThreads)
    chained_count_kernel(const ProbeT* __restrict__ keys,
                         const uint32_t* __restrict__ hashes, uint32_t mask,
                         const int32_t* __restrict__ offsets,
                         int64_t num_buckets,
                         const EntryT* __restrict__ entry_keys, int lead,
                         int64_t n, int64_t skip,
                         unsigned long long* __restrict__ total) {
  constexpr int kChunk = 16 / sizeof(EntryT);
  __shared__ unsigned long long warp_sums[kWarps];
  const int64_t groups = (n + kRows - 1) / kRows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  unsigned long long found = 0;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const int64_t i0 = g * kRows;
    ProbeT key[kRows];
    uint32_t hash[kRows];
    load_rows<ProbeT, kVec>(keys, hashes, i0, n, key, hash);
    // every row's chain bounds before any entry load
    int32_t pos[kRows];
    int32_t end[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t i = i0 + r;
      const uint32_t b = hash[r] & mask;
      pos[r] = 0;
      end[r] = 0;
      if (i >= skip && i < n && b < num_buckets) {
        pos[r] = offsets[b];
        end[r] = offsets[b + 1];
      }
    }
    unsigned int live = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      live |= (pos[r] < end[r] ? 1u : 0u) << r;
    }
    // walk the chains four rows abreast, one aligned chunk a step: each
    // step loads the chunk at every live row's position, then compares
    // them all; entries of a chunk outside [pos, end) are masked
    while (live) {
      EntryT entry[kRows][kChunk];
      int64_t first[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        first[r] = ((pos[r] + lead) & ~(kChunk - 1)) - lead;
        if (live & (1u << r)) {
          load_chunk(entry_keys + first[r], entry[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (live & (1u << r)) {
          bool hit = false;
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            const int64_t at = first[r] + j;
            hit |= at >= pos[r] && at < end[r] && same_key(entry[r][j], key[r]);
          }
          pos[r] = static_cast<int32_t>(first[r] + kChunk);
          if (hit) {
            ++found;
          }
          if (hit || pos[r] >= end[r]) {
            live &= ~(1u << r);
          }
        }
      }
    }
  }
  // one 64-bit sum a block, added to the total by one atomic
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    found += __shfl_down_sync(kFull, found, offset);
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    warp_sums[warp] = found;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sum += warp_sums[w];
    }
    if (sum) {
      atomicAdd(total, sum);
    }
  }
}

// The current device's SM count into *sms.
cudaError_t sm_count(int* sms) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) {
    return err;
  }
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

template <typename ProbeT, typename EntryT, bool kVec>
cudaError_t launch(const void* keys, const uint32_t* hashes, uint32_t mask,
                   const int32_t* offsets, int64_t num_buckets,
                   const void* entry_keys, int64_t n, int64_t skip,
                   unsigned long long* total, cudaStream_t stream) {
  const auto kernel = &chained_count_kernel<ProbeT, EntryT, kVec>;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) {
    return err;
  }
  // one wave, and no more blocks than the rows need
  const int64_t groups = (n + kRows - 1) / kRows;
  const int64_t wanted = (groups + kThreads - 1) / kThreads;
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = wanted < wave ? wanted : wave;
  // entries between the 16-byte boundary at or before entry_keys and it
  const int lead = static_cast<int>(
      (reinterpret_cast<uintptr_t>(entry_keys) & 15u) / sizeof(EntryT));
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const ProbeT*>(keys), hashes, mask, offsets, num_buckets,
      static_cast<const EntryT*>(entry_keys), lead, n, skip, total);
  return cudaGetLastError();
}

template <typename ProbeT, typename EntryT>
cudaError_t launch_aligned(const void* keys, const uint32_t* hashes,
                           uint32_t mask, const int32_t* offsets,
                           int64_t num_buckets, const void* entry_keys,
                           int64_t n, int64_t skip, unsigned long long* total,
                           cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(keys) |
                         reinterpret_cast<uintptr_t>(hashes)) & 15u) == 0;
  if (aligned) {
    return launch<ProbeT, EntryT, true>(keys, hashes, mask, offsets,
                                        num_buckets, entry_keys, n, skip,
                                        total, stream);
  }
  return launch<ProbeT, EntryT, false>(keys, hashes, mask, offsets,
                                       num_buckets, entry_keys, n, skip,
                                       total, stream);
}

// ---------------------------------------------------------------- build

// Offsets a warp stages in shared memory per step (16 KB a block).
constexpr int kStage = 512;

// An id clamped to [-1, num_buckets]: ids below 0 precede bucket 0, ids at or
// past num_buckets follow the last bucket.
template <typename IdT>
__device__ __forceinline__ int64_t clamp_id(IdT id, int64_t num_buckets) {
  const int64_t x = static_cast<int64_t>(id);
  return x < 0 ? -1 : (x > num_buckets ? num_buckets : x);
}

// The first row j >= from whose sorted id is not v, or n: the end of a run
// of v that reaches row from - 1.  Exponential steps, then a binary search,
// so a run of L rows costs O(log L) loads.
template <typename IdT>
__device__ int64_t run_end(const IdT* __restrict__ sorted, int64_t from,
                           int64_t n, IdT v) {
  if (from >= n || sorted[from] != v) {
    return from;
  }
  int64_t lo = from;  // sorted[lo] == v
  int64_t step = 1;
  int64_t hi = lo + 1;
  while (hi < n && sorted[hi] == v) {
    lo = hi;
    step <<= 1;
    hi = lo + step;
  }
  if (hi > n) {
    hi = n;
  }
  // sorted[lo] == v, and hi == n or sorted[hi] != v
  while (hi - lo > 1) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (sorted[mid] == v) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return hi;
}

// The sorted ids and the order of rows [i0, i0 + kRows): 16-byte vector
// loads when kVec and the group is whole, else one row at a time up to n.
template <typename IdT, bool kVec>
__device__ __forceinline__ void load_sorted(const IdT* __restrict__ sorted,
                                            const int64_t* __restrict__ order,
                                            int64_t i0, int64_t n,
                                            IdT (&id)[kRows],
                                            int64_t (&row)[kRows]) {
  if (kVec && i0 + kRows <= n) {
    if constexpr (sizeof(IdT) == 8) {
      const longlong2* p = reinterpret_cast<const longlong2*>(sorted + i0);
      const longlong2 a = __ldcs(p);
      const longlong2 b = __ldcs(p + 1);
      id[0] = a.x;
      id[1] = a.y;
      id[2] = b.x;
      id[3] = b.y;
    } else {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(sorted + i0));
      id[0] = a.x;
      id[1] = a.y;
      id[2] = a.z;
      id[3] = a.w;
    }
    const longlong2* q = reinterpret_cast<const longlong2*>(order + i0);
    const longlong2 a = __ldcs(q);
    const longlong2 b = __ldcs(q + 1);
    row[0] = a.x;
    row[1] = a.y;
    row[2] = b.x;
    row[3] = b.y;
    return;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    id[r] = 0;
    row[r] = 0;
    if (i0 + r < n) {
      id[r] = sorted[i0 + r];
      row[r] = order[i0 + r];
    }
  }
}

// entry_rows[i] = order[i] as int32 for the group's rows below n.
template <bool kVec>
__device__ __forceinline__ void write_rows(const int64_t (&row)[kRows],
                                           int64_t i0, int64_t n,
                                           int32_t* __restrict__ entry_rows) {
  if (kVec && i0 + kRows <= n) {
    __stcs(reinterpret_cast<int4*>(entry_rows + i0),
           make_int4(static_cast<int>(row[0]), static_cast<int>(row[1]),
                     static_cast<int>(row[2]), static_cast<int>(row[3])));
    return;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (i0 + r < n) {
      entry_rows[i0 + r] = static_cast<int32_t>(row[r]);
    }
  }
}

// Writes offsets[b] = row for b in (lo, hi] through `write`, lo and hi
// clamped ids.
template <typename Write>
__device__ __forceinline__ void fill(int64_t lo, int64_t hi, int32_t row,
                                     Write write) {
  for (int64_t b = lo + 1; b <= hi; ++b) {
    write(b, row);
  }
}

template <typename IdT, bool kVec>
__global__ void __launch_bounds__(kThreads)
    chained_build_kernel(const IdT* __restrict__ sorted,
                         const int64_t* __restrict__ order, int64_t n,
                         int64_t num_buckets, int32_t* __restrict__ offsets,
                         int32_t* __restrict__ entry_rows,
                         int* __restrict__ max_chain) {
  __shared__ int32_t stage[kWarps][kStage];
  __shared__ int warp_max[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  int32_t* const my_stage = stage[warp];
  const int64_t groups = (n + kRows - 1) / kRows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int longest = 0;
  // warp-uniform steps: lane l takes group base + l, and a warp's 32 groups
  // write one run of offsets, (first, last]
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads + warp * 32;
       base < groups; base += stride) {
    const int64_t i0 = (base + lane) * kRows;
    const int rows =
        i0 < n ? static_cast<int>(n - i0 < kRows ? n - i0 : kRows) : 0;
    IdT id[kRows];
    int64_t row[kRows];
    IdT last_id = 0;
    if (rows > 0) {
      load_sorted<IdT, kVec>(sorted, order, i0, n, id, row);
      write_rows<kVec>(row, i0, n, entry_rows);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          last_id = id[r];
        }
      }
    }
    // the id before the group: the lane before's last, or a load in lane 0
    const IdT up = __shfl_up_sync(kFull, last_id, 1);
    const IdT before = lane > 0 ? up : (i0 > 0 ? sorted[i0 - 1] : id[0]);
    const int64_t prev = i0 > 0 ? clamp_id(before, num_buckets) : -1;
    const bool holds_last = rows > 0 && i0 + rows == n;
    const int64_t end =
        holds_last ? num_buckets : clamp_id(last_id, num_buckets);
    const unsigned int active = __ballot_sync(kFull, rows > 0);
    const int64_t first = __shfl_sync(kFull, prev, 0);
    const int64_t last = __shfl_sync(kFull, end, 31 - __clz(active));
    // the warp's run of offsets goes through the stage, to be stored
    // coalesced, unless it is longer than the stage (a run of empty buckets
    // far past the rows' density): then each lane stores its own
    const bool staged = last - first <= kStage;
    const auto write = [&](int64_t b, int32_t v) {
      if (staged) {
        my_stage[b - first - 1] = v;
      } else {
        offsets[b] = v;
      }
    };
    int64_t lo = prev;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const int64_t cur = clamp_id(id[r], num_buckets);
        fill(lo, cur, static_cast<int32_t>(i0 + r), write);
        lo = cur;
      }
    }
    if (holds_last) {
      fill(lo, num_buckets, static_cast<int32_t>(n), write);
    }
    if (staged) {
      __syncwarp();
      for (int64_t j = lane; j < last - first; j += 32) {
        offsets[first + 1 + j] = my_stage[j];
      }
      __syncwarp();
    }
    if (rows == 0) {
      continue;
    }
    // the runs that start in this group: their lengths, where a run ends
    // inside the group, else up to the run's end found by search
    int start = (i0 > 0 && before == id[0]) ? -1 : 0;
#pragma unroll
    for (int r = 1; r < kRows; ++r) {
      if (r < rows && id[r] != id[r - 1]) {
        const int64_t v = static_cast<int64_t>(id[r - 1]);
        if (start >= 0 && v >= 0 && v < num_buckets) {
          longest = max(longest, r - start);
        }
        start = r;
      }
    }
    const int64_t v = static_cast<int64_t>(last_id);
    if (start >= 0 && v >= 0 && v < num_buckets) {
      const int64_t stop = run_end(sorted, i0 + rows, n, last_id);
      longest = max(longest, static_cast<int>(stop - (i0 + start)));
    }
  }
  // the block's longest chain, then one atomicMax
  longest = __reduce_max_sync(kFull, longest);
  if (lane == 0) {
    warp_max[warp] = longest;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int block = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      block = max(block, warp_max[w]);
    }
    if (block > 0) {
      atomicMax(max_chain, block);
    }
  }
}

template <typename IdT, bool kVec>
cudaError_t launch_build(const void* sorted, const int64_t* order, int64_t n,
                         int64_t num_buckets, int32_t* offsets,
                         int32_t* entry_rows, int* max_chain,
                         cudaStream_t stream) {
  const auto kernel = &chained_build_kernel<IdT, kVec>;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) {
    return err;
  }
  const int64_t groups = (n + kRows - 1) / kRows;
  const int64_t wanted = (groups + kThreads - 1) / kThreads;
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = wanted < wave ? wanted : wave;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const IdT*>(sorted), order, n, num_buckets, offsets,
      entry_rows, max_chain);
  return cudaGetLastError();
}

template <typename IdT>
cudaError_t launch_build_aligned(const void* sorted, const int64_t* order,
                                 int64_t n, int64_t num_buckets,
                                 int32_t* offsets, int32_t* entry_rows,
                                 int* max_chain, cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(sorted) |
                         reinterpret_cast<uintptr_t>(order) |
                         reinterpret_cast<uintptr_t>(entry_rows)) & 15u) == 0;
  if (aligned) {
    return launch_build<IdT, true>(sorted, order, n, num_buckets, offsets,
                                   entry_rows, max_chain, stream);
  }
  return launch_build<IdT, false>(sorted, order, n, num_buckets, offsets,
                                  entry_rows, max_chain, stream);
}

}  // namespace

extern "C" {

// Rows per thread and step of both kernels; the wrapper checks it when the
// library loads.
int phj_chained_count_rows() { return kRows; }

// Adds to *total (device int64, zeroed by the caller) the probe rows i in
// [skip, n) whose key keys[i] is in the chain of bucket hashes[i] & mask,
// entry_keys[offsets[b], offsets[b + 1]) (device pointers; offsets holds
// num_buckets + 1 int32 words).  key_bytes and entry_bytes are 4 (int32) or
// 8 (int64).  Launches on `stream` and does not synchronise.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another width.
int phj_chained_count(const void* keys, int key_bytes, const uint32_t* hashes,
                      uint32_t mask, const int32_t* offsets,
                      int64_t num_buckets, const void* entry_keys,
                      int entry_bytes, int64_t n, int64_t skip,
                      unsigned long long* total, cudaStream_t stream) {
  if (n <= skip) {
    return static_cast<int>(cudaSuccess);
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (key_bytes == 4 && entry_bytes == 4) {
    err = launch_aligned<int32_t, int32_t>(keys, hashes, mask, offsets,
                                           num_buckets, entry_keys, n, skip,
                                           total, stream);
  } else if (key_bytes == 4 && entry_bytes == 8) {
    err = launch_aligned<int32_t, int64_t>(keys, hashes, mask, offsets,
                                           num_buckets, entry_keys, n, skip,
                                           total, stream);
  } else if (key_bytes == 8 && entry_bytes == 4) {
    err = launch_aligned<int64_t, int32_t>(keys, hashes, mask, offsets,
                                           num_buckets, entry_keys, n, skip,
                                           total, stream);
  } else if (key_bytes == 8 && entry_bytes == 8) {
    err = launch_aligned<int64_t, int64_t>(keys, hashes, mask, offsets,
                                           num_buckets, entry_keys, n, skip,
                                           total, stream);
  }
  return static_cast<int>(err);
}

// The chained table from the stable sort of its bucket ids: sorted (n ids
// of id_bytes 4 or 8, ascending), order (int64[n], the sort's permutation)
// and num_buckets give offsets (int32[num_buckets + 1]), entry_rows
// (int32[n]) and *max_chain (device int32, zeroed by the caller: the
// longest run of an id in [0, num_buckets)).  n >= 1.  Launches on `stream`
// and does not synchronise.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another width or n < 1.
int phj_chained_build(const void* sorted, int id_bytes, const int64_t* order,
                      int64_t n, int64_t num_buckets, int32_t* offsets,
                      int32_t* entry_rows, int* max_chain,
                      cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  if (n >= 1 && id_bytes == 4) {
    err = launch_build_aligned<int32_t>(sorted, order, n, num_buckets, offsets,
                                        entry_rows, max_chain, stream);
  } else if (n >= 1 && id_bytes == 8) {
    err = launch_build_aligned<int64_t>(sorted, order, n, num_buckets, offsets,
                                        entry_rows, max_chain, stream);
  }
  return static_cast<int>(err);
}

}  // extern "C"
