// One-pass stable stream compaction for Hopper (sm_90a).
//
// Replaces partitionedhashjoin_tpu/ops/pallas/compact.py::block_compact and
// its kernel body _compact_kernel_factory (K5): the rows i with keep[i] != 0
// move to the front in their original order, out_pos[j] = i for the j-th
// kept row, and each carried int32 column (at most kMaxCols) moves with
// them.  The output is gap-free: kept row j lands at position j, so the
// TPU kernel's aligned total equals the kept count and no sentinel gaps
// appear.  Rows whose position would be >= out_len are not written (the
// capacity of compact_columns); the count stays exact.
//
// What bounds it on this card: bytes.  keep is read (1 byte per row), and
// each column is read only at kept rows; the kept rows are written once per
// column plus pos.  The arithmetic is a prefix count.
//
// What the design does about it.  The TPU kernel sorts a (drop-flag << 13 |
// position) key through a 91-stage bitonic network per 8192-row block and
// writes 128-aligned rows with DMAs, because Mosaic has no scatter.  On
// CUDA a stable compaction is a scan, here in ONE pass over keep with a
// decoupled look-back (lookback.cuh), so keep is read once:
// - each CTA claims the next tile of kTile rows through an atomic counter;
// - each of 128 threads reads its 32 consecutive keep bytes with two
//   16-byte loads (byte loads where the tile is ragged or keep unaligned)
//   and turns them into a bit mask; popc and a warp shuffle scan give each
//   thread its kept rows' rank in the warp, shared memory the warps before;
// - warp 0 publishes the tile's count, looks back over the tiles before it
//   for the tile's global offset, and the last tile writes the total;
// - the kept rows' tile-local indices are staged in shared memory in order,
//   so consecutive threads then write pos and every column at consecutive
//   positions.
// The only other operation of a call is a cudaMemsetAsync of the status
// words and the tile counter.
//
// C interface for ctypes: phj_compact returns cudaGetLastError() after the
// launch (or the memset's error), so a refused launch reaches the caller.

#include <cstdint>

#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 32;  // two 16-byte loads of keep
constexpr int kTile = kThreads * kRowsPerThread;  // rows per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 6;

struct Columns {
  const int32_t* in[kMaxCols];
  int32_t* out[kMaxCols];
};

// Bit e set where keep[row0 + e] != 0, for the thread's 32 rows.
__device__ __forceinline__ unsigned int keep_mask(const uint8_t* keep,
                                                  int64_t row0, int64_t n,
                                                  bool vector) {
  unsigned int mask = 0;
  if (vector && row0 + kRowsPerThread <= n) {
    const uint4* at = reinterpret_cast<const uint4*>(keep + row0);
    const uint4 q0 = __ldg(at);
    const uint4 q1 = __ldg(at + 1);
    const unsigned int words[8] = {q0.x, q0.y, q0.z, q0.w,
                                   q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int w = 0; w < 8; ++w) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        mask |= ((words[w] >> (8 * b)) & 0xffu) ? 1u << (4 * w + b) : 0u;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kRowsPerThread; ++e) {
      const int64_t row = row0 + e;
      mask |= (row < n && keep[row] != 0) ? 1u << e : 0u;
    }
  }
  return mask;
}

__global__ void __launch_bounds__(kThreads)
    compact_kernel(const uint8_t* __restrict__ keep, int64_t n, Columns cols,
                   int n_cols, int32_t* __restrict__ out_pos, int64_t out_len,
                   unsigned long long* status, unsigned int* counter,
                   int64_t tiles, int64_t* __restrict__ total) {
  __shared__ uint16_t s_rows[kTile];  // tile-local row of the j-th kept row
  __shared__ unsigned int s_warp[kWarps];
  __shared__ unsigned int s_count;
  __shared__ long long s_tile;
  __shared__ unsigned long long s_base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = phj::claim_tile(counter);
  }
  __syncthreads();
  const long long tile = s_tile;
  const int64_t tile_begin = tile * kTile;
  const bool vector = (reinterpret_cast<uintptr_t>(keep) & 15u) == 0;
  const int first = threadIdx.x * kRowsPerThread;  // tile-local
  unsigned int mask = keep_mask(keep, tile_begin + first, n, vector);

  // rank: kept rows of the lanes before, then of the warps before
  const unsigned int mine = __popc(mask);
  unsigned int inclusive = mine;
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const unsigned int up = __shfl_up_sync(0xffffffffu, inclusive, offset);
    if (lane >= offset) {
      inclusive += up;
    }
  }
  if (lane == 31) {
    s_warp[warp] = inclusive;
  }
  __syncthreads();
  if (warp == 0) {
    const unsigned int w = lane < kWarps ? s_warp[lane] : 0u;
    unsigned int w_inc = w;
#pragma unroll
    for (int offset = 1; offset < kWarps; offset <<= 1) {
      const unsigned int up = __shfl_up_sync(0xffffffffu, w_inc, offset);
      if (lane >= offset) {
        w_inc += up;
      }
    }
    if (lane < kWarps) {
      s_warp[lane] = w_inc - w;
    }
    const unsigned int count = __shfl_sync(0xffffffffu, w_inc, kWarps - 1);
    if (lane == 0) {
      s_count = count;
      phj::status_publish(status + tile,
                          tile == 0 ? phj::kStatusInclusive
                                    : phj::kStatusAggregate,
                          count);
    }
  }
  __syncthreads();
  // stage the kept rows in order
  unsigned int at = s_warp[warp] + inclusive - mine;
  while (mask) {
    const int e = __ffs(mask) - 1;
    mask &= mask - 1;
    s_rows[at++] = static_cast<uint16_t>(first + e);
  }
  const unsigned int count = s_count;
  if (warp == 0) {
    const unsigned long long base =
        tile == 0 ? 0ull : phj::lookback_warp(status, tile);
    if (lane == 0) {
      if (tile != 0) {
        phj::status_publish(status + tile, phj::kStatusInclusive,
                            base + count);
      }
      if (tile == tiles - 1) {
        *total = static_cast<int64_t>(base + count);
      }
      s_base = base;
    }
  }
  __syncthreads();
  const int64_t base = static_cast<int64_t>(s_base);
  for (unsigned int j = threadIdx.x; j < count; j += kThreads) {
    const int64_t dest = base + j;
    if (dest >= out_len) {
      break;
    }
    const int64_t row = tile_begin + s_rows[j];
    out_pos[dest] = static_cast<int32_t>(row);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < n_cols) {
        cols.out[c][dest] = __ldg(cols.in[c] + row);
      }
    }
  }
}

}  // namespace

extern "C" {

// Rows per tile; the Python wrapper checks it against its own copy and
// sizes the scratch buffer from it.
int phj_compact_tile_rows() { return kTile; }

// Columns a call can carry besides pos.
int phj_compact_max_cols() { return kMaxCols; }

// Stable compaction (see the note at the top).  keep is a device pointer to
// n bytes (nonzero = keep; n < 2^31 so that pos fits int32); in0..in5 are
// int32 device columns of n rows and out0..out5 their outputs of out_len
// rows, the first n_cols of each used (the rest may be null); out_pos
// receives the original row index of each kept row; scratch is a device
// buffer of ceil(n / kTile) + 1 int64 (the tiles' status words, then the
// tile counter), zeroed here; *total (int64, device) receives the kept
// count, exact even when it exceeds out_len.  Positions >= the kept count
// are not written.  One memset and one launch on `stream`, no
// synchronisation.  Returns cudaGetLastError() (0 = ok).
int phj_compact(const uint8_t* keep, int64_t n, int n_cols,
                const int32_t* in0, const int32_t* in1, const int32_t* in2,
                const int32_t* in3, const int32_t* in4, const int32_t* in5,
                int32_t* out0, int32_t* out1, int32_t* out2, int32_t* out3,
                int32_t* out4, int32_t* out5, int32_t* out_pos,
                int64_t out_len, int64_t* scratch, int64_t* total,
                cudaStream_t stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (n_cols < 0 || n_cols > kMaxCols || n > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (n + kTile - 1) / kTile;
  const Columns cols = {{in0, in1, in2, in3, in4, in5},
                        {out0, out1, out2, out3, out4, out5}};
  auto* status = reinterpret_cast<unsigned long long*>(scratch);
  auto* counter = reinterpret_cast<unsigned int*>(scratch + tiles);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(tiles + 1) * sizeof(int64_t), stream);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  compact_kernel<<<static_cast<unsigned int>(tiles), kThreads, 0, stream>>>(
      keep, n, cols, n_cols, out_pos, out_len, status, counter, tiles, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
