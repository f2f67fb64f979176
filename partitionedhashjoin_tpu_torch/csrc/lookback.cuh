// Decoupled look-back for single-pass scans on Hopper (sm_90a).
//
// Shared by the one-pass stream compaction (compact.cu, K5), the sweep of
// the LSD radix sort (radix_sort.cu, K6), both of which scan sums, and the
// one-pass merge count (merge_count.cu, K2), which scans a running maximum
// (lookback_warp with LookbackMax).  A kernel of this kind claims its
// tiles in order through an atomic counter (claim_tile), so a tile only ever
// waits on tiles that were claimed before it and are therefore resident:
// the spin below always ends.  Each tile publishes, per scanned value, one
// 64-bit status word:
//   bits 63..62  flag: 0 = nothing yet, 1 = AGGREGATE (this tile's count
//                alone), 2 = INCLUSIVE (the sum over this tile and every
//                tile before it; for a maximum scan, the maximum);
//   bits 61..0   the count (or the maximum, as an unsigned value).
// A tile publishes its AGGREGATE as soon as it has counted, then walks back
// over its predecessors, adding AGGREGATEs until it meets an INCLUSIVE, and
// publishes its own INCLUSIVE.  Flag and count share one 64-bit word, and
// no other data passes through the status words, so relaxed atomic loads
// and stores at GPU scope are enough: a reader never sees a flag without
// its count, and each poll reads the word afresh from L2.  (Release and
// acquire, which also order the thread's other memory operations, measured
// slower.)  The words must be zeroed before the launch (cudaMemsetAsync on
// the same stream).

#pragma once

#include <cstdint>

namespace phj {

constexpr unsigned long long kStatusAggregate = 1ull << 62;
constexpr unsigned long long kStatusInclusive = 2ull << 62;
constexpr unsigned long long kStatusValue = (1ull << 62) - 1;

__device__ __forceinline__ void status_publish(unsigned long long* word,
                                               unsigned long long flag,
                                               unsigned long long value) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word),
               "l"(flag | value)
               : "memory");
}

__device__ __forceinline__ unsigned long long status_poll(
    const unsigned long long* word) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(word)
               : "memory");
  return v;
}

// The next tile in claim order; `counter` is zeroed with the status words.
__device__ __forceinline__ long long claim_tile(unsigned int* counter) {
  return static_cast<long long>(atomicAdd(counter, 1u));
}

// One thread's look-back for one scanned value: the sum over tiles
// 0 .. tile-1 of the value whose status words lie `stride` words apart
// (word of tile p = status[p * stride]).  Used with one thread per radix
// digit, so a CTA resolves its 256 digits in parallel; each thread keeps
// kLookbackWindow polls in flight, so a walk back over many tiles that have
// only published their AGGREGATE costs one round trip per window.
constexpr int kLookbackWindow = 8;

__device__ __forceinline__ unsigned long long lookback_thread(
    const unsigned long long* status, long long tile, long long stride) {
  unsigned long long exclusive = 0;
  long long end = tile;  // tiles end-1, end-2, ... are still to be added
  while (end > 0) {
    unsigned long long s[kLookbackWindow];
#pragma unroll
    for (int w = 0; w < kLookbackWindow; ++w) {
      const long long p = end - 1 - w;
      s[w] = p >= 0 ? status_poll(status + p * stride) : kStatusInclusive;
    }
#pragma unroll
    for (int w = 0; w < kLookbackWindow; ++w) {
      if (s[w] < kStatusAggregate) {
        break;  // not published yet: its tile is resident, poll again
      }
      exclusive += s[w] & kStatusValue;
      if (s[w] >= kStatusInclusive) {
        return exclusive;
      }
      --end;
    }
  }
  return exclusive;
}

// How lookback_warp combines status values: a sum (K5) or a maximum (K2).
// Each combines two values and has an identity, 0 for both (the maximum
// is taken over unsigned values).
struct LookbackSum {
  __device__ __forceinline__ unsigned long long operator()(
      unsigned long long a, unsigned long long b) const {
    return a + b;
  }
};

struct LookbackMax {
  __device__ __forceinline__ unsigned long long operator()(
      unsigned long long a, unsigned long long b) const {
    return a > b ? a : b;
  }
};

// Warp-cooperative look-back for one scanned value (status word of tile p
// = status[p]): lane i inspects tile (window end - 1 - i), the warp waits
// until all 32 have published, combines up to the nearest INCLUSIVE and
// stops there, or combines all 32 AGGREGATEs and moves the window 32 tiles
// back.  Call with the whole warp; every lane gets the combination over
// tiles 0 .. tile-1 (the sum by default; with LookbackMax the maximum),
// the identity 0 for tile 0.
template <typename Combine = LookbackSum>
__device__ __forceinline__ unsigned long long lookback_warp(
    const unsigned long long* status, long long tile,
    Combine combine = Combine()) {
  const int lane = threadIdx.x & 31;
  unsigned long long exclusive = 0;
  for (long long end = tile; end > 0; end -= 32) {
    const long long p = end - 1 - lane;
    unsigned long long s = p >= 0 ? status_poll(status + p) : kStatusInclusive;
    while (__any_sync(0xffffffffu, s < kStatusAggregate)) {
      if (s < kStatusAggregate) {
        s = status_poll(status + p);
      }
    }
    const unsigned int inclusive =
        __ballot_sync(0xffffffffu, s >= kStatusInclusive);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    unsigned long long v = lane <= stop ? (s & kStatusValue) : 0ull;
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      v = combine(v, __shfl_xor_sync(0xffffffffu, v, offset));
    }
    exclusive = combine(exclusive, v);
    if (inclusive) {
      break;
    }
  }
  return exclusive;
}

}  // namespace phj
