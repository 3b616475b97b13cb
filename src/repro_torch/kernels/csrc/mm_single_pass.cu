// Single-pass fused (weighted, batched) MM aggregation for Hopper.
//
// Replaces: _mm_kernel, src/repro/kernels/mm_aggregate.py:243-303.
// Per column m of a (K, M) update matrix and each of N normalised weight
// columns a[:, n]: a weighted median (or, unweighted, the rank midpoint)
// starts the estimate, MAD = 1.4826 x the rank median of |x - med_n|
// floored at 1e-12 gives the scale, and num_iters Tukey IRLS steps refine
// it (mu kept where sum w <= 1e-12).  Output (N, M) in x's dtype.
//
// What bounds it on this card: f32 operations, if only just.  Each row of
// each IRLS step needs 9 of them (an FMA counted as two: residual, square,
// 1 - r^2 / (c scale)^2 as one FMA, clamp, square, num and den), 10 with
// weights, so one column needs ~N (9 T K + 4 K) for 4 K bytes read and 4 N
// written.  At the whole-pytree shape (K = 8, N = 1, T = 10) that is ~780
// operations per 36 bytes, ~22 per byte against the card's 20 (67 TFLOP/s
// over 3.35 TB/s).  The batched diffusion case (N = K = 32, weighted)
// needs ~20 times more per byte and is plainly bound by operations.
//
// What the design does about it:
//   * One block owns bm columns and reads its (K, bm) tile from HBM once,
//     coalesced along M, into shared memory.  Nothing else of x is read
//     and nothing but the (N, bm) estimates is written, whatever N is.
//   * Each column is sorted once, carrying a row index, not N weight
//     planes (mm_common.cuh); weights come from the (K, N) tile in shared
//     memory.
//   * Threads own (column, n) pairs for the median, MAD and IRLS, so all
//     N neighbourhoods run from the one resident tile.
//   * The ragged last tile is masked here (zero columns, nothing stored),
//     so the launcher never makes a padded copy of a multi-GB input.
//   * Offsets into x and the output are 64-bit: K x M passes 2^31 at the
//     full width of a model's parameter tree.
#include "mm_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(mm::kThreads)
mm_single_pass(const T* __restrict__ x, int64_t ld, int k, int64_t m,
               const float* __restrict__ a, int n, T* __restrict__ out,
               int bm, int num_iters, float c2, int weighted) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);        // (k, bm)
  float* aw = tile + (size_t)k * bm;                    // (k, n)
  uint16_t* idx = reinterpret_cast<uint16_t*>(aw + (size_t)k * n);  // (k, bm)

  const int64_t m0 = (int64_t)blockIdx.x * bm;
  const int cols = m - m0 < bm ? (int)(m - m0) : bm;

  mm::load_tile(tile, x, ld, 0, k, m0, cols, bm);
  for (int p = threadIdx.x; p < k * n; p += blockDim.x) aw[p] = a[p];
  __syncthreads();
  mm::rank_sort_columns(tile, idx, k, bm);
  __syncthreads();

  for (int p = threadIdx.x; p < n * bm; p += blockDim.x) {
    const int nn = p / bm, col = p - nn * bm;
    if (col >= cols) continue;
    float med = weighted
        ? mm::weighted_crossing(tile, idx, aw, 0, n, nn, 0.5f, k, col, bm)
        : mm::rank_median(tile, idx, k, col, bm);
    float scale = fmaxf(mm::kMadConsistency *
                            mm::mad_median(tile, idx, k, col, bm, med),
                        mm::kScaleFloor);
    float mu = med;
    for (int t = 0; t < num_iters; ++t) {
      float num = 0.0f, den = 0.0f;
      for (int r = 0; r < k; ++r) {
        float xv = tile[r * bm + col];
        float w = mm::tukey_weight(xv, mu, scale, c2, aw[r * n + nn]);
        num += w * xv;
        den += w;
      }
      mu = mm::irls_update(num, den, mu);
    }
    out[(int64_t)nn * m + m0 + col] = mm::from_f32<T>(mu);
  }
}

template <typename T>
int launch(const void* x, int64_t ld, int k, int64_t m, const void* a, int n,
           void* out, int bm, int num_iters, float c2, int weighted,
           size_t smem, cudaStream_t stream) {
  auto kern = mm_single_pass<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (m + bm - 1) / bm;
  kern<<<(unsigned)blocks, mm::kThreads, smem, stream>>>(
      static_cast<const T*>(x), ld, k, m, static_cast<const float*>(a), n,
      static_cast<T*>(out), bm, num_iters, c2, weighted);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel carves per block; the Python launch plan
// models the same number (mm_aggregate.single_pass_smem_bytes).
size_t mm_single_pass_smem_bytes(int k, int n, int bm) {
  return (size_t)k * bm * sizeof(float) + (size_t)k * n * sizeof(float) +
         (size_t)k * bm * sizeof(uint16_t);
}

// x: (k, m) row-major with row stride ld, f32 (dtype 0) or bf16 (dtype 1);
// a: (k, n) f32 normalised weight columns; out: (n, m) in x's dtype.
// Returns the cudaError_t of the launch (0 on success).
int mm_single_pass_launch(const void* x, int dtype, int64_t ld, int k,
                          int64_t m, const void* a, int n, void* out, int bm,
                          int num_iters, float c2, int weighted,
                          void* stream) {
  if (k < 1 || k > 65535 || n < 1 || bm < 1 || m < 1 ||
      (m + bm - 1) / bm > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  size_t smem = mm_single_pass_smem_bytes(k, n, bm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, ld, k, m, a, n, out, bm, num_iters, c2, weighted,
                         smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ld, k, m, a, n, out, bm, num_iters, c2,
                                 weighted, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
