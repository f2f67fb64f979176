// Generation kernels for Hopper (sm_90a): seeded hashing and Zipf sampling.
//
// Replaces partitionedhashjoin_tpu/ops/pallas/generate.py:
// - hash_kernel (K7, hash_keys / _hash_kernel): ops/hashing.hash32 on int32
//   keys, out = fmix32(fmix32(key ^ seed) + 0x9E3779B9), as uint32.
//   What bounds it: bytes (4 read and 4 written per key against ~14 integer
//   operations).  The design: a grid-stride loop over 16-byte vectors (int4
//   in, uint4 out) when both pointers allow it, and a scalar loop for the
//   rest.
// - hash64_vec_kernel (K7 on int64 keys; no TPU counterpart: the JAX
//   package hashes 32-bit keys only): ops/hashing.hash64_pair of the key's
//   (lo, hi) words, out = fmix32(fmix32(lo ^ seed) ^ hi ^ 0x9E3779B9), as
//   uint32.  What bounds it: bytes (8 read and 4 written per key).  The
//   design is hash_vec_kernel's: a grid-stride loop over 16-byte vectors
//   (longlong2 in, two keys, uint2 out), so that a warp reads 512 and
//   writes 256 contiguous bytes, and a scalar loop, hash64_kernel, for
//   the rest.
// - zipf_kernel (K8, zipf_keys_pallas / _zipf_kernel): n Zipf(alpha) keys
//   over [1, cardinality] by the reference's rejection sampler
//   (src/DataGenerator/Zipf.cpp:14-56, as ops/generators.zipf_candidates):
//   up to `rounds` rounds of three uniforms; the first accepted round wins;
//   a slot never accepted gets key 1.  The TPU kernel draws its uniforms
//   from the hardware PRNG, seeded per grid block, which no other machine
//   reproduces, so this kernel matches it in distribution only.  Here the
//   uniforms come from a counter-based generator: Philox4x32-10 keyed by the
//   64-bit seed, counter (slot, round, 0); one call gives the three uniforms
//   of a round, each built from 23 bits as in the TPU kernel
//   ((bits >> 9) | 0x3F800000 as a float, minus 1).  With per-(slot, round)
//   counters a slot's key does not depend on which thread evaluates which
//   of its rounds, or when.  The float32 arithmetic of zipf_candidates is
//   spelled with _rn intrinsics, so nvcc contracts no multiply-add into an
//   FMA that torch's separate operations do not make; only powf can differ
//   from torch.pow, by rounding.
//   What bounds it: operations (one Philox call, three powf and a handful
//   of float operations per round; 4 bytes written per key), on the issue
//   slots and the integer and MUFU pipes (chip_smoke.py counts a round's
//   SASS instructions by pipe, in zipf_round_kernel below).
//   The design: a round is accepted with probability ~0.965 at
//   Zipf(1.05) over 10M keys, so a slot needs ~1.04 rounds, but a warp whose
//   32 lanes each own one slot runs until its slowest lane accepts (~1.7
//   rounds).  So each warp owns one contiguous range of slots (the grid is
//   one wave, sized from the SM count and the kernel's occupancy), and each
//   lane holds one (slot, round) pair.  Every step, each lane evaluates one
//   round; lanes that accepted, or ran out of rounds, write their key to
//   out[slot] (scattered within a window of a few lines; staging a run of
//   1,024 keys per warp in shared memory and storing it coalesced measured
//   slower) and take the next unclaimed slots of the range, handed out
//   in lane order by a ballot and popc.  Lanes idle only in the drain at
//   the end of the range, a few steps out of ~n / (32 x warps).  The round
//   keys of the Philox key schedule come precomputed in the kernel's
//   parameters, and the step evaluates a round on every lane with no branch
//   around it (faster than a branch that skips lanes past the range).
// - uniforms_kernel: the three uniforms of one round for every slot, so the
//   generator can be held bit for bit against its plain PyTorch version.
// - zipf_round_kernel: one round of zipf_kernel<false> as straight-line
//   code, never launched; chip_smoke.py counts its SASS instructions as the
//   work of a round, apart from the step's loop and refill, for K8's bound.
//
// C interface for ctypes: each entry returns cudaGetLastError() after its
// last launch, so a refused launch reaches the caller.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned int kFull = 0xffffffffu;
constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash32(int32_t key, uint32_t seed) {
  return fmix32(fmix32(static_cast<uint32_t>(key) ^ seed) + kGolden);
}

__device__ __forceinline__ uint32_t hash64(int64_t key, uint32_t seed) {
  const uint64_t k = static_cast<uint64_t>(key);
  return fmix32(fmix32(static_cast<uint32_t>(k) ^ seed) ^
                static_cast<uint32_t>(k >> 32) ^ kGolden);
}

__global__ void __launch_bounds__(kThreads)
    hash_vec_kernel(const int4* __restrict__ keys, int64_t n4, uint32_t seed,
                    uint4* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n4; i += stride) {
    const int4 k = keys[i];
    out[i] = make_uint4(hash32(k.x, seed), hash32(k.y, seed),
                        hash32(k.z, seed), hash32(k.w, seed));
  }
}

__global__ void __launch_bounds__(kThreads)
    hash_kernel(const int32_t* __restrict__ keys, int64_t n, uint32_t seed,
                uint32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    out[i] = hash32(keys[i], seed);
  }
}

__global__ void __launch_bounds__(kThreads)
    hash64_vec_kernel(const longlong2* __restrict__ keys, int64_t n2,
                      uint32_t seed, uint2* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n2; i += stride) {
    const longlong2 k = keys[i];
    out[i] = make_uint2(hash64(k.x, seed), hash64(k.y, seed));
  }
}

__global__ void __launch_bounds__(kThreads)
    hash64_kernel(const int64_t* __restrict__ keys, int64_t n, uint32_t seed,
                  uint32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    out[i] = hash64(keys[i], seed);
  }
}

// The ten round keys of Philox4x32-10 under the 64-bit key (k0, k1):
// round r uses (k0 + r W0, k1 + r W1) mod 2^32.  Computed once on the host
// and passed by value, so the rounds read them from the constant bank
// instead of recomputing the schedule for every counter.
struct PhiloxKeys {
  uint32_t k0[10];
  uint32_t k1[10];
};

// Philox4x32-10 (Salmon et al., SC'11) of counter c under the round keys k.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, const PhiloxKeys& k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.k0[r], lo1, hi0 ^ c.w ^ k.k1[r], lo0);
  }
  return c;
}

// A uniform float in [0, 1) from the top 23 bits, as the TPU kernel builds it.
__device__ __forceinline__ float uniform23(uint32_t bits) {
  return __int_as_float(static_cast<int32_t>((bits >> 9) | 0x3F800000u)) -
         1.0f;
}

__device__ __forceinline__ uint4 round_bits(const PhiloxKeys& key,
                                            int64_t slot, uint32_t round) {
  const uint64_t s = static_cast<uint64_t>(slot);
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32),
                 round, 0u),
      key);
}

// float32 constants of zipf_candidates, computed by the wrapper exactly as
// the plain version computes them.
struct ZipfParams {
  float alpha;
  float neg_alpha;
  float sd;
  float inv_sd;
  float norm;
  float inv_norm;
  float card_f;
  int32_t card;
};

// One accept/reject round of ops/generators.zipf_candidates; kDither when
// the cardinality exceeds 2^24: spread samples within a float32 step.
template <bool kDither>
__device__ __forceinline__ bool zipf_candidate(const ZipfParams& z, float u1,
                                               float u2, float u3,
                                               int32_t* key) {
  const float un = __fmul_rn(u1, z.norm);
  const float tail = powf(__fadd_rn(__fmul_rn(un, z.sd), z.alpha), z.inv_sd);
  const float icdf = un <= 1.0f ? un : tail;
  const float sample = fminf(fmaxf(floorf(__fadd_rn(icdf, 1.0f)), 1.0f),
                             z.card_f);
  const float density_original = powf(sample, z.neg_alpha);
  const float density_sampling =
      sample <= 1.0f ? z.inv_norm : __fdiv_rn(powf(icdf, z.neg_alpha), z.norm);
  const float ratio =
      __fdiv_rn(density_original, __fmul_rn(density_sampling, z.norm));
  int32_t k = static_cast<int32_t>(sample);
  if (kDither) {
    const int exponent = ((__float_as_int(sample) >> 23) & 0xFF) - 127;
    const int spacing = exponent > 23 ? 1 << (exponent - 23) : 1;
    const int32_t dither =
        static_cast<int32_t>(__fmul_rn(u3, static_cast<float>(spacing)));
    k = min(k + dither, z.card);
  }
  *key = k;
  return u2 < ratio;
}

template <bool kDither>
__global__ void __launch_bounds__(kThreads)
    zipf_kernel(PhiloxKeys key, int64_t n, int rounds, ZipfParams z,
                int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  // this warp's range of slots, [begin, begin + len)
  const int64_t begin = warp * n / warps;
  const uint32_t len = static_cast<uint32_t>((warp + 1) * n / warps - begin);
  int32_t* const out_w = out + begin;
  if (rounds <= 0) {  // no round: every key 1
    for (uint32_t i = lane; i < len; i += 32) {
      out_w[i] = 1;
    }
    return;
  }
  uint32_t off = lane;  // the lane's slot - begin
  uint32_t next = 32;   // the range's first unclaimed slot - begin
  uint32_t round = 0;
  const unsigned int lanes_below = (1u << lane) - 1u;
  while (__any_sync(kFull, off < len)) {
    // every lane evaluates a round, so the step has no branch around it; a
    // lane past the range (only in the drain) keeps nothing of it
    const uint4 bits = round_bits(key, begin + off, round);
    int32_t cand;
    const bool accepted = zipf_candidate<kDither>(
        z, uniform23(bits.x), uniform23(bits.y), uniform23(bits.z), &cand);
    ++round;
    const bool done =
        off < len && (accepted || round >= static_cast<uint32_t>(rounds));
    if (done) {
      out_w[off] = accepted ? cand : 1;  // out of rounds: key 1
    }
    // finished lanes take the next slots of the range, in lane order
    const unsigned int finished = __ballot_sync(kFull, done);
    if (done) {
      off = next + __popc(finished & lanes_below);
      round = 0;
    }
    next += __popc(finished);
  }
}

__global__ void __launch_bounds__(kThreads)
    uniforms_kernel(PhiloxKeys key, int64_t n, uint32_t round,
                    float* __restrict__ u1, float* __restrict__ u2,
                    float* __restrict__ u3) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t slot = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
       slot < n; slot += stride) {
    const uint4 bits = round_bits(key, slot, round);
    u1[slot] = uniform23(bits.x);
    u2[slot] = uniform23(bits.y);
    u3[slot] = uniform23(bits.z);
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

// Blocks of a grid-stride loop over `items`: enough to fill each of the
// card's `sms` SMs several times over; the loops stride.
unsigned int grid_for(int64_t items, int sms) {
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 32;
  return static_cast<unsigned int>(blocks < cap ? blocks : cap);
}

PhiloxKeys philox_keys(uint64_t seed) {
  PhiloxKeys k;
  for (int r = 0; r < 10; ++r) {
    const uint32_t step = static_cast<uint32_t>(r);
    k.k0[r] = static_cast<uint32_t>(seed) + step * kPhiloxW0;
    k.k1[r] = static_cast<uint32_t>(seed >> 32) + step * kPhiloxW1;
  }
  return k;
}

}  // namespace

// One round of zipf_kernel<false> for slot (blockIdx.x << 32 | threadIdx.x):
// the Philox call, the uniforms and zipf_candidate, with no step loop, no
// refill and no index arithmetic.  Never launched: chip_smoke.py counts its
// SASS instructions as the work of one round, for K8's bound.  An accepted
// round stores its key to *out so that the compiler keeps the round.
// Outside the anonymous namespace, so that the compiler emits it.
__global__ void __launch_bounds__(kThreads)
    zipf_round_kernel(PhiloxKeys key, uint32_t round, ZipfParams z,
                      int32_t* out) {
  const int64_t slot =
      static_cast<int64_t>((static_cast<uint64_t>(blockIdx.x) << 32) |
                           threadIdx.x);
  const uint4 bits = round_bits(key, slot, round);
  int32_t cand;
  if (zipf_candidate<false>(z, uniform23(bits.x), uniform23(bits.y),
                            uniform23(bits.z), &cand)) {
    *out = cand;
  }
}

extern "C" {

// out[i] = hash32(keys[i], seed) for i < n (device pointers).  Launches on
// `stream` and does not synchronise.  Returns cudaGetLastError().
int phj_hash_keys(const int32_t* keys, int64_t n, uint32_t seed,
                  uint32_t* out, cudaStream_t stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  int sms = 0;
  const cudaError_t sm_err = sm_count(&sms);
  if (sm_err != cudaSuccess) {
    return static_cast<int>(sm_err);
  }
  int64_t done = 0;
  if (((reinterpret_cast<uintptr_t>(keys) |
        reinterpret_cast<uintptr_t>(out)) & 15u) == 0) {
    const int64_t n4 = n / 4;
    if (n4 > 0) {
      hash_vec_kernel<<<grid_for(n4, sms), kThreads, 0, stream>>>(
          reinterpret_cast<const int4*>(keys), n4, seed,
          reinterpret_cast<uint4*>(out));
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) {
        return static_cast<int>(err);
      }
    }
    done = n4 * 4;
  }
  if (done < n) {
    hash_kernel<<<grid_for(n - done, sms), kThreads, 0, stream>>>(
        keys + done, n - done, seed, out + done);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[i] = hash64_pair(lo, hi, seed) of keys[i] for i < n (device
// pointers): the vector kernel over pairs of keys when the keys are 16-byte
// and out 8-byte aligned, the scalar kernel for the rest.  Launches on
// `stream` and does not synchronise.  Returns cudaGetLastError().
int phj_hash64_keys(const int64_t* keys, int64_t n, uint32_t seed,
                    uint32_t* out, cudaStream_t stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  int sms = 0;
  const cudaError_t sm_err = sm_count(&sms);
  if (sm_err != cudaSuccess) {
    return static_cast<int>(sm_err);
  }
  int64_t done = 0;
  if ((reinterpret_cast<uintptr_t>(keys) & 15u) == 0 &&
      (reinterpret_cast<uintptr_t>(out) & 7u) == 0) {
    const int64_t n2 = n / 2;
    if (n2 > 0) {
      hash64_vec_kernel<<<grid_for(n2, sms), kThreads, 0, stream>>>(
          reinterpret_cast<const longlong2*>(keys), n2, seed,
          reinterpret_cast<uint2*>(out));
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) {
        return static_cast<int>(err);
      }
    }
    done = n2 * 2;
  }
  if (done < n) {
    hash64_kernel<<<grid_for(n - done, sms), kThreads, 0, stream>>>(
        keys + done, n - done, seed, out + done);
  }
  return static_cast<int>(cudaGetLastError());
}

// n Zipf keys into out (device int32) by the rejection sampler above; the
// float constants are zipf_candidates' float32 values.  The grid is one
// wave: every SM of the current device, as many blocks as fit on it.
// Launches on `stream` and does not synchronise.  Returns cudaGetLastError().
int phj_zipf_keys(uint64_t seed, int64_t n, int rounds, float alpha,
                  float sd, float inv_sd, float norm, float inv_norm,
                  float card_f, int32_t card, int dither, int32_t* out,
                  cudaStream_t stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const ZipfParams z{alpha, -alpha, sd, inv_sd, norm, inv_norm, card_f, card};
  const auto kernel = dither ? &zipf_kernel<true> : &zipf_kernel<false>;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  // no more warps than 32-slot groups, so that small n uses few warps
  const int64_t wanted = (n + kThreads - 1) / kThreads;
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = wanted < wave ? wanted : wave;
  if (n / (blocks * kWarps) >= 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);  // a warp's range > 2^31
  }
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      philox_keys(seed), n, rounds, z, out);
  return static_cast<int>(cudaGetLastError());
}

// The three uniforms of round `round` for slots [0, n) into u1, u2, u3
// (device float32).  Launches on `stream` and does not synchronise.  Returns
// cudaGetLastError().
int phj_philox_uniforms(uint64_t seed, int64_t n, uint32_t round, float* u1,
                        float* u2, float* u3, cudaStream_t stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  int sms = 0;
  const cudaError_t sm_err = sm_count(&sms);
  if (sm_err != cudaSuccess) {
    return static_cast<int>(sm_err);
  }
  uniforms_kernel<<<grid_for(n, sms), kThreads, 0, stream>>>(
      philox_keys(seed), n, round, u1, u2, u3);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
