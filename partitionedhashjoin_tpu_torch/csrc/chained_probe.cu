// Chained-table count probe for Hopper (sm_90a).
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
// C interface for ctypes: phj_chained_count returns cudaGetLastError() after
// the launch, so a refused launch reaches the caller.

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

}  // namespace

extern "C" {

// Rows per thread and step; the wrapper checks it when the library loads.
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

}  // extern "C"
