// Generation kernels for Hopper (sm_90a): seeded hashing and Zipf sampling.
//
// Replaces partitionedhashjoin_tpu/ops/pallas/generate.py:
// - hash_kernel (K7, hash_keys / _hash_kernel): ops/hashing.hash32 on int32
//   keys, out = fmix32(fmix32(key ^ seed) + 0x9E3779B9), as uint32.
//   What bounds it: bytes (4 read and 4 written per key against ~14 integer
//   operations).  The design: a grid-stride loop over 16-byte vectors (int4
//   in, uint4 out) when both pointers allow it, and a scalar loop for the
//   rest.
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
//   ((bits >> 9) | 0x3F800000 as a float, minus 1).  With per-slot counters
//   the output does not depend on launch geometry, and a thread stops at its
//   first accepted round with the same result.  The float32 arithmetic of
//   zipf_candidates is spelled with _rn intrinsics, so nvcc contracts no
//   multiply-add into an FMA that torch's separate operations do not make;
//   only powf can differ from torch.pow, by rounding.
//   What bounds it: operations (one Philox call, three powf and a handful
//   of float operations per round; 4 bytes written per key).
// - uniforms_kernel: the three uniforms of one round for every slot, so the
//   generator can be held bit for bit against its plain PyTorch version.
//
// C interface for ctypes: each entry returns cudaGetLastError() after its
// last launch, so a refused launch reaches the caller.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
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

// Philox4x32-10 (Salmon et al., SC'11) of counter c under key k.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// A uniform float in [0, 1) from the top 23 bits, as the TPU kernel builds it.
__device__ __forceinline__ float uniform23(uint32_t bits) {
  return __int_as_float(static_cast<int32_t>((bits >> 9) | 0x3F800000u)) -
         1.0f;
}

__device__ __forceinline__ uint4 round_bits(uint2 key, int64_t slot,
                                            uint32_t round) {
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
  int dither;  // cardinality > 2^24: spread samples within a float32 step
};

// One accept/reject round of ops/generators.zipf_candidates.
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
  if (z.dither) {
    const int exponent = ((__float_as_int(sample) >> 23) & 0xFF) - 127;
    const int spacing = exponent > 23 ? 1 << (exponent - 23) : 1;
    const int32_t dither =
        static_cast<int32_t>(__fmul_rn(u3, static_cast<float>(spacing)));
    k = min(k + dither, z.card);
  }
  *key = k;
  return u2 < ratio;
}

__global__ void __launch_bounds__(kThreads)
    zipf_kernel(uint2 key, int64_t n, int rounds, ZipfParams z,
                int32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t slot = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
       slot < n; slot += stride) {
    int32_t value = 1;
    for (int r = 0; r < rounds; ++r) {
      const uint4 bits = round_bits(key, slot, static_cast<uint32_t>(r));
      int32_t cand;
      if (zipf_candidate(z, uniform23(bits.x), uniform23(bits.y),
                         uniform23(bits.z), &cand)) {
        value = cand;
        break;
      }
    }
    out[slot] = value;
  }
}

__global__ void __launch_bounds__(kThreads)
    uniforms_kernel(uint2 key, int64_t n, uint32_t round,
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

unsigned int grid_for(int64_t items) {
  // enough blocks to fill the card several times over; the loops stride
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks < 132 * 32 ? blocks : 132 * 32);
}

uint2 philox_key(uint64_t seed) {
  return make_uint2(static_cast<uint32_t>(seed),
                    static_cast<uint32_t>(seed >> 32));
}

}  // namespace

extern "C" {

// out[i] = hash32(keys[i], seed) for i < n (device pointers).  Launches on
// `stream` and does not synchronise.  Returns cudaGetLastError().
int phj_hash_keys(const int32_t* keys, int64_t n, uint32_t seed,
                  uint32_t* out, cudaStream_t stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  int64_t done = 0;
  if (((reinterpret_cast<uintptr_t>(keys) |
        reinterpret_cast<uintptr_t>(out)) & 15u) == 0) {
    const int64_t n4 = n / 4;
    if (n4 > 0) {
      hash_vec_kernel<<<grid_for(n4), kThreads, 0, stream>>>(
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
    hash_kernel<<<grid_for(n - done), kThreads, 0, stream>>>(
        keys + done, n - done, seed, out + done);
  }
  return static_cast<int>(cudaGetLastError());
}

// n Zipf keys into out (device int32) by the rejection sampler above; the
// float constants are zipf_candidates' float32 values.  Launches on `stream`
// and does not synchronise.  Returns cudaGetLastError().
int phj_zipf_keys(uint64_t seed, int64_t n, int rounds, float alpha,
                  float sd, float inv_sd, float norm, float inv_norm,
                  float card_f, int32_t card, int dither, int32_t* out,
                  cudaStream_t stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const ZipfParams z{alpha, -alpha, sd, inv_sd, norm, inv_norm,
                     card_f, card, dither};
  zipf_kernel<<<grid_for(n), kThreads, 0, stream>>>(philox_key(seed), n,
                                                     rounds, z, out);
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
  uniforms_kernel<<<grid_for(n), kThreads, 0, stream>>>(philox_key(seed), n,
                                                         round, u1, u2, u3);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
