// Device helpers of the MM-aggregation kernels.
//
// Replaces the Pallas device helpers of src/repro/kernels/mm_aggregate.py
// (:134-240): _bitonic_stage/_bitonic_sort_rows (a paired sort network
// whose swap mask permutes every carried weight plane), _median_rows,
// _wquantile_planes/_weighted_median_planes and _rank_median_planes.
// The sort networks of the `regs`/`warp` single-pass variants and of the
// two-pass kernel live in their own sources (mm_single_pass.cu,
// mm_two_pass.cu); what is here serves every kernel (the float <-> key
// maps, the IRLS row in reciprocal form) or the single-pass `smem`
// variant (the rank sort over a shared-memory tile and its consumers).
//
// What changes on Hopper, and why:
//   * The TPU sorts a (P, N, bm) stack of weight planes through a
//     bitonic network in vector registers.  The `smem` variant sorts a
//     column once by ranks: the thread that owns (column, row r) counts
//     the rows that order before r and writes r into that slot of a
//     row-index tile in shared memory.  Every consumer then gathers the
//     value from the resident (rows, bm) tile and the weight a[row, n]
//     from the (K, N) weight tile, so N weight planes are never
//     materialised.  Ranks use a total order on the float's bits (ties
//     broken by row index), so the index tile is always a permutation,
//     even on NaN input.
//   * Sorted order equals a stable argsort: the same order the plain
//     PyTorch version uses, so cumulative weights are summed in the same
//     sequence, in f32, and a crossing at exactly 1/2 picks the same row.
//   * The MAD needs the two middle order statistics of |x - med|.  Over
//     the sorted column these deviations fall and then rise around med,
//     so a two-pointer merge from the split point yields them in O(K)
//     without a second sort.  fabsf(v - med) is monotone in v on each
//     side, so the merge sees exactly the values a sort would.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <stdio.h>

namespace mm {

constexpr float kMadConsistency = 1.4826022185056018f;
constexpr float kScaleFloor = 1e-12f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Monotone map of a float's bits to an unsigned key: -inf < ... < -0 <
// +0 < ... < +inf < NaN.  Only used to order rows, never as a value.
__device__ __forceinline__ uint32_t sort_key(float v) {
  uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Inverse of sort_key: the float whose key this is.
__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__host__ __device__ constexpr int ilog2(int p) {
  return p <= 1 ? 0 : 1 + ilog2(p / 2);
}

// Load rows [0, cnt) x columns [0, cols) of a row-major (.., ld) array
// starting at (row0, m0) into tile[r * bm + col] as f32; columns past
// `cols` are zero, the launcher's zero M padding done in place.
template <typename T>
__device__ void load_tile(float* tile, const T* __restrict__ x, int64_t ld,
                          int64_t row0, int cnt, int64_t m0, int cols,
                          int bm) {
  for (int p = threadIdx.x; p < cnt * bm; p += blockDim.x) {
    int r = p / bm, col = p - r * bm;
    tile[p] = col < cols ? to_f32(x[(row0 + r) * ld + m0 + col]) : 0.0f;
  }
}

// Stable rank sort of every column of a (cnt, bm) tile: idx[j * bm + col]
// is the tile row holding the j-th smallest value of the column.
__device__ void rank_sort_columns(const float* tile, uint16_t* idx, int cnt,
                                  int bm) {
  for (int p = threadIdx.x; p < cnt * bm; p += blockDim.x) {
    int r = p / bm, col = p - r * bm;
    uint32_t kr = sort_key(tile[p]);
    int rank = 0;
    for (int j = 0; j < cnt; ++j) {
      uint32_t kj = sort_key(tile[j * bm + col]);
      rank += (kj < kr) || (kj == kr && j < r);
    }
    idx[rank * bm + col] = (uint16_t)r;
  }
}

__device__ __forceinline__ float sorted_value(const float* tile,
                                              const uint16_t* idx, int j,
                                              int col, int bm) {
  return tile[idx[j * bm + col] * bm + col];
}

// Midpoint of the rank-(cnt-1)/2 and rank-cnt/2 values (_median_rows /
// _rank_median_planes).
__device__ __forceinline__ float rank_median(const float* tile,
                                             const uint16_t* idx, int cnt,
                                             int col, int bm) {
  float lo = sorted_value(tile, idx, (cnt - 1) / 2, col, bm);
  float hi = sorted_value(tile, idx, cnt / 2, col, bm);
  return 0.5f * (lo + hi);
}

// First sorted row whose cumulative weight reaches `half` while the
// previous one is below it (_wquantile_planes: no epsilon).  Weights are
// a[(row0 + row) * n + nn]; the sum runs in sorted order, in f32.
// Returns 0 when no row crosses (a block with no mass).
__device__ __forceinline__ float weighted_crossing(
    const float* tile, const uint16_t* idx, const float* a, int64_t row0,
    int n, int nn, float half, int cnt, int col, int bm) {
  float cw = 0.0f;
  for (int j = 0; j < cnt; ++j) {
    int r = idx[j * bm + col];
    float prev = cw;
    cw += a[(row0 + r) * n + nn];
    if (cw >= half && prev < half) return tile[r * bm + col];
  }
  return 0.0f;
}

// Rank median of |v_j - med| over the cnt sorted values of one column.
__device__ float mad_median(const float* tile, const uint16_t* idx, int cnt,
                            int col, int bm, float med) {
  int split = 0;  // values <= med come first in sorted order
  while (split < cnt && sorted_value(tile, idx, split, col, bm) <= med) ++split;
  int lo_rank = (cnt - 1) / 2, hi_rank = cnt / 2;
  int i = split - 1, j = split;  // left walks down, right walks up
  float lo = 0.0f, hi = 0.0f;
  for (int t = 0; t <= hi_rank; ++t) {
    float d;
    bool take_left;
    if (i < 0) {
      take_left = false;
    } else if (j >= cnt) {
      take_left = true;
    } else {
      float dl = fabsf(sorted_value(tile, idx, i, col, bm) - med);
      float dr = fabsf(sorted_value(tile, idx, j, col, bm) - med);
      take_left = dl <= dr;
    }
    if (take_left) {
      d = fabsf(sorted_value(tile, idx, i, col, bm) - med);
      --i;
    } else {
      d = fabsf(sorted_value(tile, idx, j, col, bm) - med);
      ++j;
    }
    if (t == lo_rank) lo = d;
    if (t == hi_rank) hi = d;
  }
  return 0.5f * (lo + hi);
}

// One row's share of a Tukey IRLS step, in reciprocal form (inv =
// 1 / (c scale), once per (column, n) and step).  x - mu is taken first:
// it is exact for rows near mu, so a row at mu keeps weight a even where
// the MAD is floored and inv is huge.
__device__ __forceinline__ void tukey_accumulate(float xv, float a, float mu,
                                                 float inv, float& num,
                                                 float& den) {
  const float y = (xv - mu) * inv;
  // 1 - y^2 <= 1, so saturating to [0, 1] is the clamp at 0, and it
  // rides on the FMA
  const float u = __saturatef(fmaf(-y, y, 1.0f));
  const float w = a * (u * u);
  num = fmaf(w, xv, num);
  den += w;
}

__device__ __forceinline__ float irls_update(float num, float den, float mu) {
  return den > kScaleFloor ? num / den : mu;
}

// ---- launch queries (host) -------------------------------------------------

// What one launch would run, written by the mm_*_config queries in place
// of launching it: blocks, threads a block, dynamic shared memory, the
// blocks of that size one SM holds (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor, as the card reports it: 0 where none fits), the SM
// count, and the kernel's instantiation (`name`, `name_len` bytes).
struct LaunchQuery {
  int64_t blocks, threads, smem, per_sm, sms;
  char* name;
  int name_len;
};

template <typename T> inline const char* type_name();
template <> inline const char* type_name<float>() { return "float"; }
template <> inline const char* type_name<__nv_bfloat16>() { return "bf16"; }

// Blocks of `threads` threads and `smem` bytes one SM of the current
// device holds (0 where none fits), and the device's SM count.
template <typename Kern>
cudaError_t occupancy(Kern kern, int threads, size_t smem, int* per_sm,
                      int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads,
                                                        smem);
  return err;
}

inline int report(LaunchQuery* q, int64_t blocks, int threads, size_t smem,
                  int per_sm, int sms) {
  q->blocks = blocks;
  q->threads = threads;
  q->smem = (int64_t)smem;
  q->per_sm = per_sm;
  q->sms = sms;
  return 0;
}

}  // namespace mm
