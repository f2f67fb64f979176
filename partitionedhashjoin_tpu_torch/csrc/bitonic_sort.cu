// Tuple sort kernels for Hopper (sm_90a): block sort and pairwise merge.
//
// Replaces partitionedhashjoin_tpu/ops/pallas/bitonic_sort.py (K6):
// - phase A, _sort_blocks / sort_blocks_i32 (K6a): each block of kBlk rows
//   of k int32 operands sorted ascending in full lexicographic tuple order
//   (operand 0 first, ties by operand 1, ...);
// - phase B, _merge_pass_rows / merge_pass_i32 (K6b): one pairwise merge
//   pass, sorted runs of run_len rows become sorted runs of 2 * run_len, "A
//   wins ties", a lone tail run copied through, a truncated last B.
// Ties are bit-identical tuples, so the sort has exactly one correct output
// and the kernels agree with any correct sort (the plain PyTorch version is
// a cascade of stable torch.sort calls).
//
// What bounds it on this card: bytes.  The compulsory traffic of a sort is
// each operand read once and written once; this design touches device memory
// once per phase (phase A, then one read and one write per merge pass:
// ceil(log2(n / kBlk)) passes, 15 at 200M rows), so it moves 16x the
// compulsory bytes at 200M rows.  The comparisons, n log2 n of them, are far
// below the card's arithmetic rate.
//
// What the design does about it.  The TPU kernel keeps a whole block in
// vector registers, builds partner exchanges from lane rotations and static
// sublane swaps, and overlays a reversed B window on A in (ROWS + 1)-row DMA
// windows, because of Mosaic's limits.  Here:
// - sort_blocks_kernel: one CTA of 1024 threads per kBlk-row block of k
//   operands in dynamic shared memory (32 KB per operand), the 91-stage
//   bitonic network with a tuple compare-exchange per pair and a barrier
//   between stages.  Rows past the input read as all-INT32_MAX tuples, the
//   maximal tuple, so padding sorts last or next to bit-identical genuine
//   rows.
// - diag_kernel: one thread per output tile of a merge pass finds the tile's
//   merge-path split (how many rows of run A precede it) by binary search
//   over the pair in device memory: the largest i with A[i - 1] <= B[g - i].
// - merge_kernel: one CTA per output tile of kBlk rows loads its A and B
//   windows (between its split and the next tile's) into shared memory,
//   every thread finds its own split of 16 outputs in the windows with the
//   same predicate, merges them sequentially into registers, and the CTA
//   writes the tile back coalesced.  Splits at both ends of a tile come from
//   the same predicate, so runs of equal tuples longer than a tile or a run
//   are neither duplicated nor dropped.
// Shared memory is indexed with one pad word per 32 (pad()), so the strided
// register write-back of merge_kernel is free of bank conflicts.  All row
// offsets are 64-bit.
//
// C interface for ctypes: each entry returns cudaGetLastError() after its
// last launch (and after any launch that fails), so a refused launch reaches
// the caller.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOperands = 4;
constexpr int kLogBlk = 13;
constexpr int kBlk = 1 << kLogBlk;  // rows per phase-A block and merge tile
constexpr int kSortThreads = 1024;
constexpr int kPairsPerThread = kBlk / 2 / kSortThreads;
constexpr int kMergeThreads = 512;
constexpr int kItems = kBlk / kMergeThreads;  // outputs per merge thread
constexpr int kPadBlk = kBlk + kBlk / 32;
constexpr int kDiagThreads = 256;
constexpr int32_t kInt32Max = 2147483647;

struct Operands {
  const int32_t* in[kMaxOperands];
  int32_t* out[kMaxOperands];
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Strict lexicographic a < b over K operands.
template <int K>
__device__ __forceinline__ bool tuple_less(const int32_t (&a)[K],
                                           const int32_t (&b)[K]) {
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (a[c] != b[c]) {
      return a[c] < b[c];
    }
  }
  return false;
}

template <int K>
__device__ __forceinline__ void load_shared(int32_t (&v)[K],
                                            const int32_t* smem, int stride,
                                            int at) {
#pragma unroll
  for (int c = 0; c < K; ++c) {
    v[c] = smem[c * stride + at];
  }
}

template <int K>
__device__ __forceinline__ void load_global(int32_t (&v)[K],
                                            const Operands& ops, int64_t at) {
#pragma unroll
  for (int c = 0; c < K; ++c) {
    v[c] = ops.in[c][at];
  }
}

template <int K>
__global__ void __launch_bounds__(kSortThreads)
    sort_blocks_kernel(Operands ops, int64_t n_in, int64_t n_out) {
  extern __shared__ int32_t smem[];  // K operands x kBlk rows
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlk;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    for (int i = threadIdx.x; i < kBlk; i += kSortThreads) {
      const int64_t row = base + i;
      smem[c * kBlk + i] = row < n_in ? ops.in[c][row] : kInt32Max;
    }
  }
  __syncthreads();
  for (int k = 1; k <= kLogBlk; ++k) {
    for (int j = k - 1; j >= 0; --j) {
#pragma unroll
      for (int r = 0; r < kPairsPerThread; ++r) {
        const int p = threadIdx.x + r * kSortThreads;
        // the pair's lower row: p with a zero bit inserted at position j
        const int lo = ((p >> j) << (j + 1)) | (p & ((1 << j) - 1));
        const int hi = lo | (1 << j);
        const bool ascending = ((lo >> k) & 1) == 0;
        int32_t x[K], y[K];
        load_shared(x, smem, kBlk, lo);
        load_shared(y, smem, kBlk, hi);
        if (ascending ? tuple_less(y, x) : tuple_less(x, y)) {
#pragma unroll
          for (int c = 0; c < K; ++c) {
            smem[c * kBlk + lo] = y[c];
            smem[c * kBlk + hi] = x[c];
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int c = 0; c < K; ++c) {
    for (int i = threadIdx.x; i < kBlk; i += kSortThreads) {
      const int64_t row = base + i;
      if (row < n_out) {
        ops.out[c][row] = smem[c * kBlk + i];
      }
    }
  }
}

// The pair of runs that output row g_global of a merge pass belongs to.
struct Pair {
  int64_t base_a, base_b, len_a, len_b, g;
};

__device__ __forceinline__ Pair pair_of(int64_t g_global, int64_t n,
                                        int64_t run_len) {
  Pair p;
  p.base_a = g_global / (2 * run_len) * (2 * run_len);
  p.base_b = p.base_a + run_len;
  p.len_a = min(run_len, n - p.base_a);
  p.len_b = max(int64_t{0}, min(run_len, n - p.base_b));
  p.g = g_global - p.base_a;
  return p;
}

template <int K>
__global__ void __launch_bounds__(kDiagThreads)
    diag_kernel(Operands ops, int64_t n, int64_t run_len, int64_t tiles,
                int64_t* __restrict__ split) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kDiagThreads +
                    threadIdx.x;
  if (w >= tiles) {
    return;
  }
  const Pair p = pair_of(w * kBlk, n, run_len);
  int64_t lo = max(int64_t{0}, p.g - p.len_b);
  int64_t hi = min(p.g, p.len_a);
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    int32_t a[K], b[K];
    load_global(a, ops, p.base_a + mid - 1);
    load_global(b, ops, p.base_b + p.g - mid);
    if (tuple_less(b, a)) {
      hi = mid - 1;
    } else {
      lo = mid;
    }
  }
  split[w] = lo;
}

template <int K>
__global__ void __launch_bounds__(kMergeThreads)
    merge_kernel(Operands ops, int64_t n, int64_t run_len,
                 const int64_t* __restrict__ split, int64_t n_out) {
  extern __shared__ int32_t smem[];  // K operands x kPadBlk words
  const int64_t w = blockIdx.x;
  const int64_t g_global = w * kBlk;
  const Pair p = pair_of(g_global, n, run_len);
  const int64_t a_lo = split[w];
  const int64_t a_hi =
      p.g + kBlk >= p.len_a + p.len_b ? p.len_a : split[w + 1];
  const int la = static_cast<int>(a_hi - a_lo);
  const int lb = kBlk - la;
  const int64_t a_from = p.base_a + a_lo;
  const int64_t b_from = p.base_b + (p.g - a_lo);
  // windows: A at local [0, la), B at local [la, kBlk)
#pragma unroll
  for (int c = 0; c < K; ++c) {
    for (int i = threadIdx.x; i < kBlk; i += kMergeThreads) {
      smem[c * kPadBlk + pad(i)] =
          i < la ? ops.in[c][a_from + i] : ops.in[c][b_from + (i - la)];
    }
  }
  __syncthreads();

  const int y = threadIdx.x * kItems;
  int lo = max(0, y - lb);
  int hi = min(y, la);
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    int32_t a[K], b[K];
    load_shared(a, smem, kPadBlk, pad(mid - 1));
    load_shared(b, smem, kPadBlk, pad(la + y - mid));
    if (tuple_less(b, a)) {
      hi = mid - 1;
    } else {
      lo = mid;
    }
  }
  int ai = lo;
  int bi = y - lo;
  int32_t a[K], b[K];
  if (ai < la) {
    load_shared(a, smem, kPadBlk, pad(ai));
  }
  if (bi < lb) {
    load_shared(b, smem, kPadBlk, pad(la + bi));
  }
  int32_t out[K][kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool take_a = bi >= lb || (ai < la && !tuple_less(b, a));
#pragma unroll
    for (int c = 0; c < K; ++c) {
      out[c][k] = take_a ? a[c] : b[c];
    }
    if (take_a) {
      if (++ai < la) {
        load_shared(a, smem, kPadBlk, pad(ai));
      }
    } else if (++bi < lb) {
      load_shared(b, smem, kPadBlk, pad(la + bi));
    }
  }
  __syncthreads();  // every thread has read its windows
#pragma unroll
  for (int c = 0; c < K; ++c) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      smem[c * kPadBlk + pad(y + k)] = out[c][k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < K; ++c) {
    for (int i = threadIdx.x; i < kBlk; i += kMergeThreads) {
      const int64_t row = g_global + i;
      if (row < n_out) {
        ops.out[c][row] = smem[c * kPadBlk + pad(i)];
      }
    }
  }
}

Operands make_operands(const int32_t* const* in, int32_t* const* out, int k) {
  Operands ops{};
  for (int c = 0; c < k; ++c) {
    ops.in[c] = in[c];
    ops.out[c] = out[c];
  }
  return ops;
}

template <int K>
cudaError_t launch_sort_blocks(const Operands& ops, int64_t n_pad,
                               int64_t n_in, int64_t n_out,
                               cudaStream_t stream) {
  const int smem = K * kBlk * static_cast<int>(sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      sort_blocks_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    return err;
  }
  const unsigned int grid = static_cast<unsigned int>(n_pad / kBlk);
  sort_blocks_kernel<K><<<grid, kSortThreads, smem, stream>>>(ops, n_in,
                                                               n_out);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_merge_pass(const Operands& ops, int64_t n,
                              int64_t run_len, int64_t* split, int64_t n_out,
                              cudaStream_t stream) {
  const int64_t tiles = n / kBlk;
  const unsigned int diag_grid =
      static_cast<unsigned int>((tiles + kDiagThreads - 1) / kDiagThreads);
  diag_kernel<K><<<diag_grid, kDiagThreads, 0, stream>>>(ops, n, run_len,
                                                          tiles, split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return err;
  }
  const int smem = K * kPadBlk * static_cast<int>(sizeof(int32_t));
  err = cudaFuncSetAttribute(
      merge_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    return err;
  }
  merge_kernel<K><<<static_cast<unsigned int>(tiles), kMergeThreads, smem,
                    stream>>>(ops, n, run_len, split, n_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per phase-A block and per merge tile; the wrapper checks it.
int phj_bitonic_block_rows() { return kBlk; }

// Most operands a call takes; the wrapper checks it.
int phj_bitonic_max_operands() { return kMaxOperands; }

// Phase A over n_pad rows (a multiple of kBlk) of k operands: in0..in3 hold
// n_in rows each (rows past n_in read as INT32_MAX), out0..out3 receive the
// first n_out rows of the block-sorted result.  Operands past k are ignored.
// Launches on `stream` and does not synchronise.  Returns cudaGetLastError().
int phj_sort_blocks(int k, int64_t n_pad, int64_t n_in, const int32_t* in0,
                    const int32_t* in1, const int32_t* in2,
                    const int32_t* in3, int64_t n_out, int32_t* out0,
                    int32_t* out1, int32_t* out2, int32_t* out3,
                    cudaStream_t stream) {
  if (n_pad <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (n_pad % kBlk != 0 || n_pad / kBlk > 0x7fffffffLL || k < 1 ||
      k > kMaxOperands) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* in[kMaxOperands] = {in0, in1, in2, in3};
  int32_t* out[kMaxOperands] = {out0, out1, out2, out3};
  const Operands ops = make_operands(in, out, k);
  switch (k) {
    case 1:
      return static_cast<int>(
          launch_sort_blocks<1>(ops, n_pad, n_in, n_out, stream));
    case 2:
      return static_cast<int>(
          launch_sort_blocks<2>(ops, n_pad, n_in, n_out, stream));
    case 3:
      return static_cast<int>(
          launch_sort_blocks<3>(ops, n_pad, n_in, n_out, stream));
    default:
      return static_cast<int>(
          launch_sort_blocks<4>(ops, n_pad, n_in, n_out, stream));
  }
}

// One merge pass over n rows (a multiple of kBlk) of k operands: sorted runs
// of run_len rows (a positive multiple of kBlk) in in0..in3 become sorted
// runs of 2 * run_len; out0..out3 receive the first n_out rows.  split is a
// device buffer of n / kBlk int64.  Launches two kernels on `stream` and
// does not synchronise.  Returns cudaGetLastError().
int phj_merge_pass(int k, int64_t n, int64_t run_len, const int32_t* in0,
                   const int32_t* in1, const int32_t* in2, const int32_t* in3,
                   int64_t n_out, int32_t* out0, int32_t* out1, int32_t* out2,
                   int32_t* out3, int64_t* split, cudaStream_t stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (n % kBlk != 0 || n / kBlk > 0x7fffffffLL || run_len <= 0 ||
      run_len % kBlk != 0 || k < 1 || k > kMaxOperands) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* in[kMaxOperands] = {in0, in1, in2, in3};
  int32_t* out[kMaxOperands] = {out0, out1, out2, out3};
  const Operands ops = make_operands(in, out, k);
  switch (k) {
    case 1:
      return static_cast<int>(
          launch_merge_pass<1>(ops, n, run_len, split, n_out, stream));
    case 2:
      return static_cast<int>(
          launch_merge_pass<2>(ops, n, run_len, split, n_out, stream));
    case 3:
      return static_cast<int>(
          launch_merge_pass<3>(ops, n, run_len, split, n_out, stream));
    default:
      return static_cast<int>(
          launch_merge_pass<4>(ops, n, run_len, split, n_out, stream));
  }
}

}  // extern "C"
