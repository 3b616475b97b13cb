// Two-pass K-major MM aggregation for large cohorts (K >> 64), Hopper.
//
// Replaces: _mm_two_pass_kernel, src/repro/kernels/mm_aggregate.py:306-405.
//   pass 1, each K block of bk rows: the block's weighted median at half
//     the block's weight mass (unweighted: the rank midpoint of its cnt
//     valid rows) and the block MAD, the rank median of |x - med| over
//     those rows;
//   pass 2: mu0 = the mass-weighted median of the block medians, scale =
//     1.4826 x the mass-weighted median of the block MADs (floored), then
//     num_iters Tukey IRLS steps whose num and den are summed exactly over
//     every row.  Exact when there is one K block; with several, the init
//     and scale are the reference's median-of-medians approximation.
//
// What bounds it on this card: f32 operations.  At N = 1 a column needs
// ~9 T K operations of IRLS and K log2 bk compares of sorting per 4 K
// bytes read, ~25 per byte at T = 10 against the card's 20.  This kernel
// sorts by ranks, K bk compares per column, so at the cohort sizes that
// reach this path (K = 512 from a 1024-client federation at participation
// 0.5) its sort, not the IRLS, takes most of its operations.
//
// What the design does about it:
//   * The TPU's sequential K grid axis is a loop inside the block: Hopper
//     blocks run in no order, so nothing can carry from one block to the
//     next.  Pass-1 stats (KB, N, bm) x 2 live in shared memory and never
//     reach HBM.
//   * Sorting bk-row blocks instead of all K rows cuts the rank sort from
//     K^2 to K bk compares per column.
//   * The (K_pad, bm) tile stays resident in shared memory when it fits
//     (the launch plan decides, tile_resident): x is then read from HBM
//     once.  Otherwise only the current bk-row block is staged and each
//     IRLS step re-reads the column from HBM (the plan counts that
//     traffic).  K = 1024 at bm = 32 is 128 KB and stays resident.
//   * Threads own (column, row) pairs for the sort and (column, n) pairs
//     for the statistics and IRLS; the ragged last tile is masked here.
#include "mm_common.cuh"

namespace {

// Mass-weighted median over the kb block statistics of one (column, n):
// values v[b * n * bm + nn * bm + col], masses mass[b * n + nn], taken in
// ascending value order (ties by block), crossing at `half` with no
// epsilon; 0 when nothing crosses.
__device__ float block_crossing(const float* v, const float* mass, int kb,
                                int n, int nn, int col, int bm, float half) {
  float cw = 0.0f;
  for (int pos = 0; pos < kb; ++pos) {
    // the block at sorted position `pos`: rank by (value key, block)
    for (int b = 0; b < kb; ++b) {
      uint32_t kv = mm::sort_key(v[((size_t)b * n + nn) * bm + col]);
      int rank = 0;
      for (int b2 = 0; b2 < kb; ++b2) {
        uint32_t k2 = mm::sort_key(v[((size_t)b2 * n + nn) * bm + col]);
        rank += (k2 < kv) || (k2 == kv && b2 < b);
      }
      if (rank != pos) continue;
      float prev = cw;
      cw += mass[b * n + nn];
      if (cw >= half && prev < half) return v[((size_t)b * n + nn) * bm + col];
      break;
    }
  }
  return 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(mm::kThreads)
mm_two_pass(const T* __restrict__ x, int64_t ld, int k, int64_t m,
            const float* __restrict__ a, int n, T* __restrict__ out, int bm,
            int bk, int kb, int resident, int num_iters, float c2,
            int weighted) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k_pad = kb * bk;
  const int tile_rows = resident ? k_pad : bk;
  float* tile = reinterpret_cast<float*>(smem);           // (tile_rows, bm)
  float* aw = tile + (size_t)tile_rows * bm;               // (k_pad, n)
  float* mass = aw + (size_t)k_pad * n;                    // (kb, n)
  float* meds = mass + (size_t)kb * n;                     // (kb, n, bm)
  float* mads = meds + (size_t)kb * n * bm;                // (kb, n, bm)
  uint16_t* idx = reinterpret_cast<uint16_t*>(mads + (size_t)kb * n * bm);

  const int64_t m0 = (int64_t)blockIdx.x * bm;
  const int cols = m - m0 < bm ? (int)(m - m0) : bm;

  for (int p = threadIdx.x; p < k_pad * n; p += blockDim.x)
    aw[p] = p < k * n ? a[p] : 0.0f;  // sentinel rows carry weight 0
  __syncthreads();
  // block masses, summed in row order
  for (int p = threadIdx.x; p < kb * n; p += blockDim.x) {
    const int b = p / n, nn = p - b * n;
    float s = 0.0f;
    for (int r = b * bk; r < (b + 1) * bk; ++r) s += aw[r * n + nn];
    mass[p] = s;
  }

  // ---- pass 1: per-block statistics ----
  for (int b = 0; b < kb; ++b) {
    const int row0 = b * bk;
    const int cnt = min(k - row0, bk);
    float* blk = resident ? tile + (size_t)row0 * bm : tile;
    __syncthreads();  // the previous block's readers are done
    mm::load_tile(blk, x, ld, row0, cnt, m0, cols, bm);
    __syncthreads();
    mm::rank_sort_columns(blk, idx, cnt, bm);
    __syncthreads();
    for (int p = threadIdx.x; p < n * bm; p += blockDim.x) {
      const int nn = p / bm, col = p - nn * bm;
      float med;
      if (weighted) {
        float half = 0.5f * mm::sorted_mass(idx, aw, row0, n, nn, cnt, col, bm);
        med = mm::weighted_crossing(blk, idx, aw, row0, n, nn, half, cnt, col,
                                    bm);
      } else {
        med = mm::rank_median(blk, idx, cnt, col, bm);
      }
      meds[((size_t)b * n + nn) * bm + col] = med;
      mads[((size_t)b * n + nn) * bm + col] =
          mm::mad_median(blk, idx, cnt, col, bm, med);
    }
  }
  __syncthreads();

  // ---- pass 2: combine, then IRLS summed over every row ----
  for (int p = threadIdx.x; p < n * bm; p += blockDim.x) {
    const int nn = p / bm, col = p - nn * bm;
    if (col >= cols) continue;
    float total = 0.0f;
    for (int b = 0; b < kb; ++b) total += mass[b * n + nn];
    const float half = 0.5f * total;
    float mu = block_crossing(meds, mass, kb, n, nn, col, bm, half);
    float scale = fmaxf(
        mm::kMadConsistency * block_crossing(mads, mass, kb, n, nn, col, bm, half),
        mm::kScaleFloor);
    for (int t = 0; t < num_iters; ++t) {
      float num = 0.0f, den = 0.0f;
      for (int r = 0; r < k; ++r) {
        float xv = resident ? tile[r * bm + col]
                            : mm::to_f32(x[(int64_t)r * ld + m0 + col]);
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
           void* out, int bm, int bk, int kb, int resident, int num_iters,
           float c2, int weighted, size_t smem, cudaStream_t stream) {
  auto kern = mm_two_pass<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (m + bm - 1) / bm;
  kern<<<(unsigned)blocks, mm::kThreads, smem, stream>>>(
      static_cast<const T*>(x), ld, k, m, static_cast<const float*>(a), n,
      static_cast<T*>(out), bm, bk, kb, resident, num_iters, c2, weighted);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel carves per block; the Python launch plan
// models the same number (mm_aggregate.two_pass_smem_bytes).
size_t mm_two_pass_smem_bytes(int k, int n, int bm, int bk, int resident) {
  const size_t kb = (size_t)((k + bk - 1) / bk), k_pad = kb * bk;
  const size_t tile_rows = resident ? k_pad : (size_t)bk;
  return sizeof(float) * (tile_rows * bm + k_pad * n + kb * n + 2 * kb * n * bm) +
         sizeof(uint16_t) * (size_t)bk * bm;
}

// As mm_single_pass_launch, plus the K block bk (rows per pass-1 sort)
// and whether the whole (K_pad, bm) tile stays in shared memory.
int mm_two_pass_launch(const void* x, int dtype, int64_t ld, int k, int64_t m,
                       const void* a, int n, void* out, int bm, int bk,
                       int resident, int num_iters, float c2, int weighted,
                       void* stream) {
  if (k < 1 || n < 1 || bm < 1 || m < 1 || bk < 1 || bk > 65535 ||
      (m + bm - 1) / bm > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int kb = (k + bk - 1) / bk;
  size_t smem = mm_two_pass_smem_bytes(k, n, bm, bk, resident);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, ld, k, m, a, n, out, bm, bk, kb, resident,
                         num_iters, c2, weighted, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ld, k, m, a, n, out, bm, bk, kb, resident,
                                 num_iters, c2, weighted, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
