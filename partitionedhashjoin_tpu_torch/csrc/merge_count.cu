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
// (ops/sort_merge.py).  The count is defined for rows in any order, and the
// kernel computes it for any order: it scans the running maximum and never
// assumes that a tile's last build row holds its largest build key.
//
// What bounds it on this card: bytes.  Each row is read once (4 bytes of key,
// 1 byte of tag); the work is a max and a compare per row.
//
// What the design does about it.  The TPU kernel carries the running maximum
// in SMEM from one grid step to the next, because its grid runs in order.
// CUDA blocks run concurrently and in no order, so the carry crosses blocks
// by a decoupled look-back (lookback.cuh), in ONE launch that reads the
// stream once:
// - each CTA claims the next tile of kTile rows through an atomic counter
//   (phj::claim_tile), so a tile waits only on tiles claimed before it;
// - each of 512 threads owns kRowsPerThread = 16 consecutive rows and loads
//   their keys as four int4 and their tags as one uint4, so a warp's loads
//   are coalesced 16-byte accesses (on the main path's stream, tiles of
//   8,192 rows measured faster than 4,096 and as fast as 16,384 of 32 rows
//   a thread; 2,048 rows, or 1,024 threads, were slower).  Tiles are laid
//   out from the 16-byte boundary at or before keys[0] (`lead` rows before
//   it, 0..3), so every thread's keys are 16-byte aligned; the rows before
//   row 0 and past row n - 1 (the head and tail of a view) are dead rows,
//   and the threads that hold them load their live rows one by one.  Tags
//   that do not share the keys' alignment (a view such as tags[3:] beside
//   keys[1:]) are loaded one byte at a time;
// - the thread's build-key maximum, a warp shuffle max-scan and shared
//   memory across the warps give the tile's maximum, which warp 0 publishes
//   as AGGREGATE; it then walks back to the nearest INCLUSIVE taking the
//   maximum (phj::lookback_warp with phj::LookbackMax) and publishes the
//   tile's INCLUSIVE.
//   A status value is the biased key uint32(key) ^ 0x80000000, whose
//   unsigned order is the signed order of the keys (INT32_MIN -> 0, the
//   identity of the maximum);
// - each thread then runs its inclusive max-scan seeded with the carry
//   before its first row, counts its hits, and the tile adds its count to
//   the 64-bit total with one atomicAdd.
// The status words, the tile counter and the total share one scratch
// buffer, zeroed by one cudaMemsetAsync per call.
//
// C interface for ctypes: phj_merge_count returns cudaGetLastError() after
// the launch (or the memset's error), so a refused launch reaches the
// caller.

#include <cstdint>

#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRowsPerThread = 16;
constexpr int kTile = kThreads * kRowsPerThread;  // rows per tile
static_assert(kRowsPerThread == 16, "a thread's tags are one uint4 load");
constexpr int kWarps = kThreads / 32;
constexpr int32_t kInt32Min = -2147483647 - 1;
constexpr unsigned int kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long biased(int32_t key) {
  return static_cast<unsigned long long>(static_cast<uint32_t>(key) ^
                                         0x80000000u);
}

__device__ __forceinline__ int32_t unbiased(unsigned long long value) {
  return static_cast<int32_t>(static_cast<uint32_t>(value) ^ 0x80000000u);
}

// Bits e set where byte e of the 16 bytes (w0..w3) is nonzero.
__device__ __forceinline__ unsigned int nonzero_bytes(uint4 w) {
  const unsigned int words[4] = {w.x, w.y, w.z, w.w};
  unsigned int mask = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      mask |= ((words[q] >> (8 * b)) & 0xffu) ? 1u << (4 * q + b) : 0u;
    }
  }
  return mask;
}

// Exclusive max-scan of v across the warp: lane l gets max(v of lanes < l),
// INT32_MIN for lane 0; *inclusive gets the scan including lane l.
__device__ __forceinline__ int32_t warp_scan_max(int32_t v, int lane,
                                                 int32_t* inclusive) {
  int32_t inc = v;
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const int32_t up = __shfl_up_sync(kFull, inc, offset);
    if (lane >= offset) {
      inc = max(inc, up);
    }
  }
  *inclusive = inc;
  const int32_t exc = __shfl_up_sync(kFull, inc, 1);
  return lane == 0 ? kInt32Min : exc;
}

__global__ void __launch_bounds__(kThreads)
    merge_count_kernel(const int32_t* __restrict__ keys,
                       const uint8_t* __restrict__ is_build, int64_t n,
                       int lead, bool tags_vector,
                       unsigned long long* status, unsigned int* counter,
                       unsigned long long* __restrict__ total) {
  __shared__ int32_t s_warp[kWarps];
  __shared__ unsigned int s_found[kWarps];
  __shared__ long long s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = phj::claim_tile(counter);
  }
  __syncthreads();
  const long long tile = s_tile;
  // the thread's first row; rows < 0 or >= n are dead
  const int64_t row0 = tile * kTile +
                       static_cast<int64_t>(threadIdx.x) * kRowsPerThread -
                       lead;

  int32_t key[kRowsPerThread];
  unsigned int build = 0;  // bit e: row0 + e is a build row
  if (row0 >= 0 && row0 + kRowsPerThread <= n) {
    const int4* k4 = reinterpret_cast<const int4*>(keys + row0);
#pragma unroll
    for (int q = 0; q < kRowsPerThread / 4; ++q) {
      const int4 v = __ldg(k4 + q);
      key[4 * q] = v.x;
      key[4 * q + 1] = v.y;
      key[4 * q + 2] = v.z;
      key[4 * q + 3] = v.w;
    }
    if (tags_vector) {
      build = nonzero_bytes(
          __ldg(reinterpret_cast<const uint4*>(is_build + row0)));
    } else {
#pragma unroll
      for (int e = 0; e < kRowsPerThread; ++e) {
        build |= __ldg(is_build + row0 + e) != 0 ? 1u << e : 0u;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kRowsPerThread; ++e) {
      const int64_t row = row0 + e;
      const bool live = row >= 0 && row < n;
      key[e] = live ? __ldg(keys + row) : kInt32Min;
      build |= live && __ldg(is_build + row) != 0 ? 1u << e : 0u;
    }
  }

  int32_t mine = kInt32Min;
#pragma unroll
  for (int e = 0; e < kRowsPerThread; ++e) {
    if ((build >> e) & 1u) {
      mine = max(mine, key[e]);
    }
  }
  int32_t lane_inclusive;
  const int32_t lane_exclusive = warp_scan_max(mine, lane, &lane_inclusive);
  if (lane == 31) {
    s_warp[warp] = lane_inclusive;
  }
  __syncthreads();
  if (warp == 0) {
    int32_t warp_inclusive;
    const int32_t warp_exclusive = warp_scan_max(
        lane < kWarps ? s_warp[lane] : kInt32Min, lane, &warp_inclusive);
    const int32_t aggregate = __shfl_sync(kFull, warp_inclusive, kWarps - 1);
    unsigned long long carry = 0;  // biased maximum over the tiles before
    if (tile == 0) {
      if (lane == 0) {
        phj::status_publish(status, phj::kStatusInclusive, biased(aggregate));
      }
    } else {
      if (lane == 0) {
        phj::status_publish(status + tile, phj::kStatusAggregate,
                            biased(aggregate));
      }
      carry = phj::lookback_warp(status, tile, phj::LookbackMax());
      if (lane == 0) {
        const unsigned long long mine_b = biased(aggregate);
        phj::status_publish(status + tile, phj::kStatusInclusive,
                            carry > mine_b ? carry : mine_b);
      }
    }
    if (lane < kWarps) {
      s_warp[lane] = max(warp_exclusive, unbiased(carry));
    }
  }
  __syncthreads();

  // running max before this thread's first row: the carry and the warps
  // before this one (s_warp), the lanes before this one
  int32_t prefix = max(s_warp[warp], lane_exclusive);
  unsigned int found = 0;
#pragma unroll
  for (int e = 0; e < kRowsPerThread; ++e) {
    if ((build >> e) & 1u) {
      prefix = max(prefix, key[e]);
    } else if (key[e] != kInt32Min && key[e] == prefix) {
      ++found;  // dead rows hold INT32_MIN and are never counted
    }
  }
  found = __reduce_add_sync(kFull, found);
  if (lane == 0) {
    s_found[warp] = found;
  }
  __syncthreads();
  if (warp == 0) {
    found = __reduce_add_sync(kFull, lane < kWarps ? s_found[lane] : 0u);
    if (lane == 0 && found != 0) {
      atomicAdd(total, static_cast<unsigned long long>(found));
    }
  }
}

// Rows before keys[0] back to its 16-byte boundary (keys is 4-byte aligned).
int lead_rows(const int32_t* keys) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(keys) & 15u) / 4u);
}

}  // namespace

extern "C" {

// Rows per tile; the Python wrapper checks it against its own copy and
// sizes the scratch buffer from it.
int phj_merge_count_tile_rows() { return kTile; }

// Adds to scratch[0] (as a 64-bit count) the count described at the top.
// keys (int32, 4-byte aligned) and is_build (one byte per row, nonzero =
// build row) are device pointers to n rows; scratch is a device buffer of
// scratch_words int64, at least 2 + ceil((n + lead) / kTile) where lead =
// (address of keys mod 16) / 4 <= 3, so 3 + ceil(n / kTile) always do: the
// total, the tile counter, then one status word per tile.  It is zeroed here.  One memset and one launch on
// `stream`, no synchronisation.  Returns cudaGetLastError() (0 = ok).
int phj_merge_count(const int32_t* keys, const uint8_t* is_build, int64_t n,
                    int64_t* scratch, int64_t scratch_words,
                    cudaStream_t stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if ((reinterpret_cast<uintptr_t>(keys) & 3u) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int lead = lead_rows(keys);
  const int64_t tiles = (n + lead + kTile - 1) / kTile;
  if (tiles > 0x7fffffffLL || scratch_words < 2 + tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the tags of every fully live thread are 16-byte aligned iff tags - lead is
  const bool tags_vector =
      ((reinterpret_cast<uintptr_t>(is_build) - lead) & 15u) == 0;
  auto* total = reinterpret_cast<unsigned long long*>(scratch);
  auto* counter = reinterpret_cast<unsigned int*>(scratch + 1);
  auto* status = reinterpret_cast<unsigned long long*>(scratch + 2);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(2 + tiles) * sizeof(int64_t), stream);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  merge_count_kernel<<<static_cast<unsigned int>(tiles), kThreads, 0,
                       stream>>>(keys, is_build, n, lead, tags_vector, status,
                                 counter, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
