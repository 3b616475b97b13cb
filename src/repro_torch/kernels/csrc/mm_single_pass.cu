// Single-pass fused (weighted, batched) MM aggregation for Hopper.
//
// Replaces: _mm_kernel, src/repro/kernels/mm_aggregate.py:243-303.
// Per column m of a (K, M) update matrix and each of N normalised weight
// columns a[:, n]: a weighted median (or, unweighted, the rank midpoint)
// starts the estimate, MAD = 1.4826 x the rank median of |x - med_n|
// floored at 1e-12 gives the scale, and num_iters Tukey IRLS steps refine
// it (mu kept where sum w <= 1e-12).  Output (N, M) in x's dtype.
//
// What bounds it on this card: instruction issue.  By the count of the
// operations the estimate needs (9 per row and IRLS step, FMA as two) the
// whole-pytree shape (K = 8, N = 1, T = 10) sits just past the byte
// bound, and the batched diffusion shape (N = K = 32) well past it.  What
// the card issues per column is more than that count: the sort, the
// crossing, the MAD and, above all, how each IRLS row is written.  A
// shared-memory tile read twice per row and step and two IEEE divisions
// per row (each a multi-instruction sequence with a slow-path branch) cost
// ~40 instructions per row and step; the reciprocal form below costs ~8.
//
// One source, three variants; the launch plan picks one from (K, M, N)
// (mm_aggregate.single_pass_variant) and the launcher never substitutes
// another:
//
//   regs  K <= 32, wide M.  One thread owns one column and every n of it,
//         in a grid-stride loop over columns on a grid the card holds at
//         once; the next column's K values are loaded into registers
//         (coalesced along M: neighbouring threads, neighbouring columns)
//         before the current one is computed, so HBM latency hides
//         behind that work.  K is a template bound (8, 16, 32); rows
//         past the runtime k are sentinels that sort last and carry
//         weight 0.  A column is sorted once by a compare-exchange
//         network, and each value comes back from its key exactly.
//         Weighted, the network sorts the 64-bit pair (sort_key(v), row):
//         the order is the plain version's stable argsort, so each n's
//         weights, gathered in that order from the (K, N) weight tile in
//         shared memory (an odd row stride: distinct rows, distinct
//         banks), are summed in the same f32 sequence and a crossing at
//         exactly 1/2 picks the same row.  Unweighted, the rank midpoint
//         needs values only, so 32-bit keys are sorted.  The MAD's middle
//         order statistics come from a bitonic merge of |x - med| (a
//         V-shaped sequence over the sorted column, so one merge sorts
//         it), and IRLS runs on registers only.  Every register array is
//         indexed by unrolled, static indices.  Each kernel holds a second
//         copy of its column loop for k equal to its bound (the tree's 8,
//         the batch's 32), where the sentinel predicates fold away.
//   warp  K <= 64, few (column, n) pairs.  One warp owns one pair; lane
//         l holds rows l and l + 32.  Ranks come from 32 shuffles; the
//         crossing walks ranks 0, 1, ... in order, each lane adding the
//         same shuffled weight, so the cumulative sum runs in the plain
//         version's sequence; num and den of each IRLS step are reduced
//         with __shfl_xor (a butterfly, so every lane holds the same sum).
//   smem  every other single-pass shape (K = 33 ... ~300, or many pairs
//         at K > 32): one block stages its (K, bm) tile in shared memory,
//         sorts each column by ranks (mm_common.cuh) and threads own
//         (column, n) pairs.
//
// IRLS in reciprocal form, all variants: inv = 1 / (c scale) once per
// pair, then per row y = (x - mu) inv, u = max(1 - y^2, 0) as one
// saturating FMA, w = a u^2, num = fma(w, x, num), den += w; mu = num / den (IEEE)
// where den > 1e-12.  Against the plain version's (x - mu) / scale and
// y^2 / c^2 this moves each weight by a few ulps; Tukey's weight is
// continuous in y and the sort, median and MAD see the same f32 values in
// the same order, so the estimate moves by about an ulp per step, inside
// the parity tolerance of 1e-5 x max(1, |x|_inf).
//
// Offsets into x and the output are 64-bit: K x M passes 2^31 at the full
// width of a model's parameter tree.  No variant pads or copies x; each
// masks the ragged edge itself.
#include "mm_common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = mm::kThreads / 32;
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without opt-in
enum Variant { kRegs = 0, kWarp = 1, kSmem = 2 };

using mm::ilog2;
using mm::key_value;
using mm::tukey_accumulate;

// Compare-exchange: lo <- the smaller, hi <- the larger.
__device__ __forceinline__ void order_pair(uint32_t& lo, uint32_t& hi) {
  const uint32_t a = lo;
  lo = min(a, hi);
  hi = max(a, hi);
}
__device__ __forceinline__ void order_pair(float& lo, float& hi) {
  const float a = lo;
  lo = fminf(a, hi);
  hi = fmaxf(a, hi);
}
__device__ __forceinline__ void order_pair(uint64_t& lo, uint64_t& hi) {
  const uint64_t a = lo, b = hi;
  const bool swap = b < a;
  lo = swap ? b : a;
  hi = swap ? a : b;
}

// Ascending bitonic sort of P = 2^LOG values; every index is static once
// the loops unroll.
template <int LOG, typename K>
__device__ __forceinline__ void bitonic_sort(K (&v)[1 << LOG]) {
  constexpr int P = 1 << LOG;
#pragma unroll
  for (int s = 1; s <= LOG; ++s) {
#pragma unroll
    for (int t = s - 1; t >= 0; --t) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int j = i ^ (1 << t);
        if (j > i) {
          if ((i & (1 << s)) == 0) order_pair(v[i], v[j]);
          else order_pair(v[j], v[i]);
        }
      }
    }
  }
}

// Ascending sort of a bitonic sequence (one falling then rising run, or a
// rotation of one) of P = 2^LOG values.
template <int LOG, typename K>
__device__ __forceinline__ void bitonic_merge(K (&v)[1 << LOG]) {
  constexpr int P = 1 << LOG;
#pragma unroll
  for (int t = LOG - 1; t >= 0; --t) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int j = i ^ (1 << t);
      if (j > i) order_pair(v[i], v[j]);
    }
  }
}

// Midpoint of the values at positions (cnt - 1) / 2 and cnt / 2 of a
// sorted register array, by static selects.
template <int P>
__device__ __forceinline__ float middle(const float (&v)[P], int cnt) {
  const int jl = (cnt - 1) / 2, jh = cnt / 2;
  float lo = 0.0f, hi = 0.0f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    lo = j == jl ? v[j] : lo;
    hi = j == jh ? v[j] : hi;
  }
  return 0.5f * (lo + hi);
}

// ---- regs ------------------------------------------------------------------

// 1.4826 x the rank median of |x - med| over a sorted column, floored.
// Over sorted values the deviations fall and then rise, and the sentinels
// (+inf) only extend the rise: one bitonic merge sorts them.
template <int LOG>
__device__ __forceinline__ float mad_scale(const float (&xs)[1 << LOG], int k,
                                           float med) {
  float d[1 << LOG];
#pragma unroll
  for (int j = 0; j < (1 << LOG); ++j)
    d[j] = j < k ? fabsf(xs[j] - med) : __int_as_float(0x7f800000);
  bitonic_merge<LOG>(d);
  return fmaxf(mm::kMadConsistency * middle(d, k), mm::kScaleFloor);
}

// num_iters Tukey IRLS steps from mu over register rows (any order).
template <int P>
__device__ __forceinline__ float irls(const float (&xv)[P], const float (&av)[P],
                                     float mu, float scale, float c,
                                     int num_iters) {
  const float inv = 1.0f / (c * scale);
  for (int t = 0; t < num_iters; ++t) {
    float num = 0.0f, den = 0.0f;
#pragma unroll
    for (int j = 0; j < P; ++j) tukey_accumulate(xv[j], av[j], mu, inv, num, den);
    mu = mm::irls_update(num, den, mu);
  }
  return mu;
}

// Column col's k values in row order; 0 on sentinel rows.
template <int KMAX, typename T>
__device__ __forceinline__ void load_column(float (&v)[KMAX],
                                            const T* __restrict__ x,
                                            int64_t ld, int k, int64_t col) {
#pragma unroll
  for (int r = 0; r < KMAX; ++r)
    v[r] = r < k ? mm::to_f32(x[(int64_t)r * ld + col]) : 0.0f;
}

// One thread's columns, grid-stride: its next column is loaded into
// registers before the current one is computed, so HBM latency hides
// behind that work.  The kernel calls this with k == KMAX as a constant
// where it can, so the sentinel predicates fold away.
template <int KMAX, bool WEIGHTED, typename T>
__device__ __forceinline__ void regs_columns(
    const T* __restrict__ x, int64_t ld, int k, int64_t m,
    const float* aw, int lda, int n, T* __restrict__ out, int num_iters,
    float c) {
  constexpr int LOG = ilog2(KMAX);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float a0[KMAX];  // unweighted: the weights of n = 0, in row order
  if (!WEIGHTED) {
#pragma unroll
    for (int r = 0; r < KMAX; ++r) a0[r] = r < k ? aw[r * lda] : 0.0f;
  }
  float next[KMAX];
  if (col < m) load_column(next, x, ld, k, col);
  for (; col < m; col += stride) {
    float v[KMAX];
#pragma unroll
    for (int r = 0; r < KMAX; ++r) v[r] = next[r];
    if (col + stride < m) load_column(next, x, ld, k, col + stride);

    if (!WEIGHTED) {
      // the rank midpoint needs values only: sort the 32-bit keys and run
      // IRLS over the rows in their own order
      uint32_t sk[KMAX];
#pragma unroll
      for (int r = 0; r < KMAX; ++r)
        sk[r] = r < k ? mm::sort_key(v[r]) : 0xffffffffu;  // sentinels last
      bitonic_sort<LOG>(sk);
      float xs[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) xs[j] = j < k ? key_value(sk[j]) : 0.0f;
      const float med = middle(xs, k);
      const float scale = mad_scale<LOG>(xs, k, med);
      out[col] = mm::from_f32<T>(irls(v, a0, med, scale, c, num_iters));
      for (int nn = 1; nn < n; ++nn) {
        float ar[KMAX];
#pragma unroll
        for (int r = 0; r < KMAX; ++r) ar[r] = r < k ? aw[r * lda + nn] : 0.0f;
        out[(int64_t)nn * m + col] =
            mm::from_f32<T>(irls(v, ar, med, scale, c, num_iters));
      }
      continue;
    }

    // weighted: sort (key, row) pairs, so the crossing sums each n's
    // weights in the plain version's order
    uint64_t s[KMAX];
#pragma unroll
    for (int r = 0; r < KMAX; ++r)
      s[r] = r < k ? ((uint64_t)mm::sort_key(v[r]) << 32) | (uint32_t)r
                   : ~0ull;  // sentinel: after every row, NaN included
    bitonic_sort<LOG>(s);
    float xs[KMAX];
    int row[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      xs[j] = j < k ? key_value((uint32_t)(s[j] >> 32)) : 0.0f;
      row[j] = (int)(uint32_t)s[j];
    }
    for (int nn = 0; nn < n; ++nn) {
      float as[KMAX];  // weights in sorted order; 0 on sentinel rows
#pragma unroll
      for (int j = 0; j < KMAX; ++j) as[j] = j < k ? aw[row[j] * lda + nn] : 0.0f;
      float cw = 0.0f, med = 0.0f;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        const float prev = cw;
        cw += as[j];
        if (j < k && cw >= 0.5f && prev < 0.5f) med = xs[j];
      }
      const float scale = mad_scale<LOG>(xs, k, med);
      out[(int64_t)nn * m + col] =
          mm::from_f32<T>(irls(xs, as, med, scale, c, num_iters));
    }
  }
}

template <int KMAX, typename T>
__global__ void __launch_bounds__(mm::kThreads)
mm_regs(const T* __restrict__ x, int64_t ld, int k, int64_t m,
        const float* __restrict__ a, int n, T* __restrict__ out,
        int num_iters, float c, int weighted) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* aw = reinterpret_cast<float*>(smem);  // (k, lda)
  const int lda = n | 1;
  for (int p = threadIdx.x; p < k * n; p += blockDim.x) {
    const int r = p / n;
    aw[r * lda + (p - r * n)] = a[p];
  }
  __syncthreads();
  if (weighted) {
    if (k == KMAX)
      regs_columns<KMAX, true>(x, ld, KMAX, m, aw, lda, n, out, num_iters, c);
    else
      regs_columns<KMAX, true>(x, ld, k, m, aw, lda, n, out, num_iters, c);
  } else {
    if (k == KMAX)
      regs_columns<KMAX, false>(x, ld, KMAX, m, aw, lda, n, out, num_iters, c);
    else
      regs_columns<KMAX, false>(x, ld, k, m, aw, lda, n, out, num_iters, c);
  }
}

// ---- warp ------------------------------------------------------------------

// The value a lane holds for the row of rank p, in every lane.
template <int RPL>
__device__ __forceinline__ float at_rank(const float (&v)[RPL],
                                         const int (&rank)[RPL], int p) {
  unsigned b = __ballot_sync(kFullMask, rank[0] == p);
  if (RPL == 1 || b) return __shfl_sync(kFullMask, v[0], __ffs(b) - 1);
  b = __ballot_sync(kFullMask, rank[RPL - 1] == p);
  return __shfl_sync(kFullMask, v[RPL - 1], __ffs(b) - 1);
}

// Rank of each of a lane's rows among all 32 x RPL rows, ordered by
// (key, row).
template <int RPL>
__device__ __forceinline__ void ranks(const uint32_t (&key)[RPL], int lane,
                                      int (&rank)[RPL]) {
#pragma unroll
  for (int q = 0; q < RPL; ++q) rank[q] = 0;
  for (int src = 0; src < 32; ++src) {
#pragma unroll
    for (int q2 = 0; q2 < RPL; ++q2) {
      const uint32_t ks = __shfl_sync(kFullMask, key[q2], src);
      const int rs = src + 32 * q2;
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const int r = lane + 32 * q;
        rank[q] += (ks < key[q]) || (ks == key[q] && rs < r);
      }
    }
  }
}

template <int RPL, typename T>
__global__ void __launch_bounds__(mm::kThreads)
mm_warp(const T* __restrict__ x, int64_t ld, int k, int64_t m,
        const float* __restrict__ a, int n, T* __restrict__ out,
        int num_iters, float c, int weighted) {
  const int lane = threadIdx.x & 31;
  const int64_t pair = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= m * n) return;  // the whole warp leaves together
  const int nn = (int)(pair / m);
  const int64_t col = pair - (int64_t)nn * m;

  float v[RPL], w[RPL];
  uint32_t key[RPL];
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    const int r = lane + 32 * q;
    const bool valid = r < k;
    v[q] = valid ? mm::to_f32(x[(int64_t)r * ld + col]) : 0.0f;
    w[q] = valid ? a[r * n + nn] : 0.0f;
    key[q] = valid ? mm::sort_key(v[q]) : 0xffffffffu;  // sentinels last
  }
  int rank[RPL];
  ranks(key, lane, rank);

  float med = 0.0f;
  if (weighted) {
    float cw = 0.0f;
    for (int p = 0; p < k; ++p) {
      const float vp = at_rank(v, rank, p);
      const float prev = cw;
      cw += at_rank(w, rank, p);
      if (cw >= 0.5f && prev < 0.5f) med = vp;
    }
  } else {
    med = 0.5f * (at_rank(v, rank, (k - 1) / 2) + at_rank(v, rank, k / 2));
  }

  float d[RPL];
  uint32_t dkey[RPL];
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    d[q] = lane + 32 * q < k ? fabsf(v[q] - med)
                             : __int_as_float(0x7f800000);  // +inf: last
    dkey[q] = mm::sort_key(d[q]);
  }
  int drank[RPL];
  ranks(dkey, lane, drank);
  const float mad =
      0.5f * (at_rank(d, drank, (k - 1) / 2) + at_rank(d, drank, k / 2));
  const float scale = fmaxf(mm::kMadConsistency * mad, mm::kScaleFloor);
  const float inv = 1.0f / (c * scale);

  float mu = med;
  for (int t = 0; t < num_iters; ++t) {
    float num = 0.0f, den = 0.0f;
#pragma unroll
    for (int q = 0; q < RPL; ++q) tukey_accumulate(v[q], w[q], mu, inv, num, den);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      num += __shfl_xor_sync(kFullMask, num, off);
      den += __shfl_xor_sync(kFullMask, den, off);
    }
    mu = mm::irls_update(num, den, mu);
  }
  if (lane == 0) out[(int64_t)nn * m + col] = mm::from_f32<T>(mu);
}

// ---- smem ------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(mm::kThreads)
mm_smem(const T* __restrict__ x, int64_t ld, int k, int64_t m,
        const float* __restrict__ a, int n, T* __restrict__ out, int bm,
        int num_iters, float c, int weighted) {
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
    const float inv = 1.0f / (c * scale);
    float mu = med;
    for (int t = 0; t < num_iters; ++t) {
      float num = 0.0f, den = 0.0f;
      for (int r = 0; r < k; ++r)
        tukey_accumulate(tile[r * bm + col], aw[r * n + nn], mu, inv, num, den);
      mu = mm::irls_update(num, den, mu);
    }
    out[(int64_t)nn * m + m0 + col] = mm::from_f32<T>(mu);
  }
}

// ---- launch ----------------------------------------------------------------

// Opt a kernel in to `smem` bytes of dynamic shared memory, calling
// cudaFuncSetAttribute only when a launch needs more than the kernel has
// been granted so far (once per instantiation and size, not per launch).
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem, size_t* granted) {
  if (smem <= *granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *granted = smem;
  return err;
}

struct Args {
  const void* x;
  int64_t ld;
  int k;
  int64_t m;
  const void* a;
  int n;
  void* out;
  int bm;
  int num_iters;
  float c;
  int weighted;
  size_t smem;
  cudaStream_t stream;
  mm::LaunchQuery* query;  // set: report the launch below, launch nothing
};

// Blocks of `threads` threads and `smem` bytes one SM holds, and the SM
// count: the grid of a grid-stride kernel is their product.  Cached per
// instantiation for the last (threads, smem) asked.  per_sm is the
// card's own answer, 0 where no such block fits an SM: a launch then
// fails (cudaErrorLaunchOutOfResources) instead of launching a grid of
// blocks that cannot be resident.
struct Resident {
  int threads = 0;
  size_t smem = 0;
  int per_sm = 0;
  int sms = 0;
};

template <typename Kern>
cudaError_t resident_blocks(Kern kern, int threads, size_t smem,
                            Resident* cache) {
  if (cache->sms && cache->threads == threads && cache->smem == smem)
    return cudaSuccess;
  int per_sm = 0, sms = 0;
  cudaError_t err = mm::occupancy(kern, threads, smem, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  *cache = Resident{threads, smem, per_sm, sms};
  return cudaSuccess;
}

template <int KMAX, typename T>
int launch_regs(const Args& g) {
  static size_t granted = kDefaultSmem;
  static Resident resident;
  auto kern = mm_regs<KMAX, T>;
  cudaError_t err = allow_smem(kern, g.smem, &granted);
  if (err == cudaSuccess) err = resident_blocks(kern, g.bm, g.smem, &resident);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (g.m + g.bm - 1) / g.bm;
  const int64_t held = (int64_t)resident.sms * resident.per_sm;
  if (blocks > held) blocks = held;
  if (g.query) {
    snprintf(g.query->name, g.query->name_len, "mm_regs<%d, %s>", KMAX,
             mm::type_name<T>());
    return mm::report(g.query, blocks, g.bm, g.smem, resident.per_sm,
                      resident.sms);
  }
  if (blocks < 1) return (int)cudaErrorLaunchOutOfResources;
  kern<<<(unsigned)blocks, g.bm, g.smem, g.stream>>>(
      static_cast<const T*>(g.x), g.ld, g.k, g.m,
      static_cast<const float*>(g.a), g.n, static_cast<T*>(g.out),
      g.num_iters, g.c, g.weighted);
  return (int)cudaGetLastError();
}

template <int RPL, typename T>
int launch_warp(const Args& g) {
  const int64_t blocks = (g.m * g.n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (g.query) {
    int per_sm = 0, sms = 0;
    cudaError_t err =
        mm::occupancy(mm_warp<RPL, T>, mm::kThreads, 0, &per_sm, &sms);
    if (err != cudaSuccess) return (int)err;
    snprintf(g.query->name, g.query->name_len, "mm_warp<%d, %s>", RPL,
             mm::type_name<T>());
    return mm::report(g.query, blocks, mm::kThreads, 0, per_sm, sms);
  }
  mm_warp<RPL, T><<<(unsigned)blocks, mm::kThreads, 0, g.stream>>>(
      static_cast<const T*>(g.x), g.ld, g.k, g.m,
      static_cast<const float*>(g.a), g.n, static_cast<T*>(g.out),
      g.num_iters, g.c, g.weighted);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_smem(const Args& g) {
  static size_t granted = kDefaultSmem;
  auto kern = mm_smem<T>;
  cudaError_t err = allow_smem(kern, g.smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (g.m + g.bm - 1) / g.bm;
  if (g.query) {
    int per_sm = 0, sms = 0;
    err = mm::occupancy(kern, mm::kThreads, g.smem, &per_sm, &sms);
    if (err != cudaSuccess) return (int)err;
    snprintf(g.query->name, g.query->name_len, "mm_smem<%s>",
             mm::type_name<T>());
    return mm::report(g.query, blocks, mm::kThreads, g.smem, per_sm, sms);
  }
  kern<<<(unsigned)blocks, mm::kThreads, g.smem, g.stream>>>(
      static_cast<const T*>(g.x), g.ld, g.k, g.m,
      static_cast<const float*>(g.a), g.n, static_cast<T*>(g.out), g.bm,
      g.num_iters, g.c, g.weighted);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int variant, const Args& g) {
  if (variant == kRegs) {
    if (g.bm > mm::kThreads || g.bm % 32) return (int)cudaErrorInvalidValue;
    if (g.k <= 8) return launch_regs<8, T>(g);
    if (g.k <= 16) return launch_regs<16, T>(g);
    if (g.k <= 32) return launch_regs<32, T>(g);
    return (int)cudaErrorInvalidValue;
  }
  if (variant == kWarp) {
    if (g.k <= 32) return launch_warp<1, T>(g);
    if (g.k <= 64) return launch_warp<2, T>(g);
    return (int)cudaErrorInvalidValue;
  }
  if (variant == kSmem) return launch_smem<T>(g);
  return (int)cudaErrorInvalidValue;
}

size_t smem_bytes(int variant, int k, int n, int bm) {
  if (variant == kRegs) return (size_t)k * (n | 1) * sizeof(float);
  if (variant == kWarp) return 0;
  return (size_t)k * bm * sizeof(float) + (size_t)k * n * sizeof(float) +
         (size_t)k * bm * sizeof(uint16_t);
}

// Checks the arguments and runs (query == nullptr) or reports (query set)
// one launch.
int dispatch(const void* x, int dtype, int64_t ld, int k, int64_t m,
             const void* a, int n, void* out, int bm, int variant,
             int num_iters, float c, int weighted, void* stream,
             mm::LaunchQuery* query) {
  if (k < 1 || k > 65535 || n < 1 || bm < 1 || m < 1 ||
      (m + bm - 1) / bm > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const Args g{x, ld, k, m, a, n, out, bm, num_iters, c, weighted,
               smem_bytes(variant, k, n, bm),
               static_cast<cudaStream_t>(stream), query};
  if (dtype == 0) return launch<float>(variant, g);
  if (dtype == 1) return launch<__nv_bfloat16>(variant, g);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory one block of `variant` carves; the Python launch plan
// models the same number (mm_aggregate.variant_smem_bytes).
size_t mm_single_pass_smem_bytes(int variant, int k, int n, int bm) {
  return smem_bytes(variant, k, n, bm);
}

// x: (k, m) row-major with row stride ld, f32 (dtype 0) or bf16 (dtype 1);
// a: (k, n) f32 normalised weight columns; out: (n, m) in x's dtype;
// variant: 0 regs, 1 warp, 2 smem; c: Tukey's constant.  Returns the
// cudaError_t of the launch (0 on success).
int mm_single_pass_launch(const void* x, int dtype, int64_t ld, int k,
                          int64_t m, const void* a, int n, void* out, int bm,
                          int variant, int num_iters, float c, int weighted,
                          void* stream) {
  return dispatch(x, dtype, ld, k, m, a, n, out, bm, variant, num_iters, c,
                  weighted, stream, nullptr);
}

// What mm_single_pass_launch would launch for these arguments on the
// current device, through the same dispatch, launching nothing: in
// out[0..4] the blocks, threads a block, dynamic shared memory, the blocks
// of that size one SM holds (0 where none fits) and the SM count; in
// `name` the kernel's instantiation.  Returns a cudaError_t.
int mm_single_pass_config(int dtype, int k, int64_t m, int n, int bm,
                          int variant, int64_t* out, char* name,
                          int name_len) {
  if (out == nullptr || name == nullptr || name_len < 1)
    return (int)cudaErrorInvalidValue;
  mm::LaunchQuery q{0, 0, 0, 0, 0, name, name_len};
  const int err = dispatch(nullptr, dtype, m, k, m, nullptr, n, nullptr, bm,
                           variant, 0, 1.0f, 1, nullptr, &q);
  out[0] = q.blocks;
  out[1] = q.threads;
  out[2] = q.smem;
  out[3] = q.per_sm;
  out[4] = q.sms;
  return err;
}

}  // extern "C"
