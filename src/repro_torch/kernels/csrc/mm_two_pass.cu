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
// bytes read, ~25 per byte at T = 10 against the card's 20.  The
// large-cohort layer launch, 512 clients over one Qwen3-0.6B decoder
// layer (K = 512, M = 15,730,944, N = 1), is bound at 12.15 ms by its
// operations (bytes alone: 9.64 ms; chip_smoke.mm_ops).
//
// What held the first port back, and what this design does about it:
//   * It sorted by counting ranks, K bk shared-memory compares per column
//     (262,144 at K = 512).  Here one warp owns one column: lane l holds
//     bk / 32 of its rows in registers (RPL, "rows per lane"), and a warp
//     bitonic network orders them, in-lane stages on registers and
//     cross-lane stages by __shfl_xor_sync (45 stages of 16 compare-
//     exchanges a lane at bk = 512).  The warp's element e = lane * RPL +
//     q, so the first log2(RPL) distances of every merge stay inside a
//     lane.  Each merge level opens with a mirror stage (e against e ^
//     (2^s - 1)), so every comparator ascends and none picks its direction
//     at run time.  Weighted columns sort 64-bit (key, row) pairs: the
//     order is the plain version's stable argsort, so weights gathered in
//     that order are summed in its f32 sequence and a crossing at exactly
//     1/2 picks the row it picks.  Unweighted columns sort 32-bit keys.
//   * It launched one block of 64 columns per tile, four blocks in all at
//     the cohort's (512, 256, 1), and ran IRLS over 512 rows serially per
//     thread with two IEEE divisions per row.  Here a block is `cols`
//     warps over `cols` columns (8, or fewer where the tile would not fit
//     or M gives fewer tiles than the card has SMs; the launch plan picks
//     it), and the grid walks the column tiles grid-stride on as many
//     blocks as the card holds at once (asked of the card, per device).
//     IRLS is split across the warp's lanes in reciprocal form (one
//     division per (column, n, step)), and num and den are reduced by a
//     butterfly of shuffles, which leaves the same sum in every lane.
//   * Its combine ranked the KB block statistics in O(KB^3).  Here the
//     (value, block) pairs of one (column, n) are sorted once: in
//     registers, one pair a lane, for KB <= 32; in a per-warp strip of
//     shared memory above that, so any KB launches.  The masses are then
//     added in that order in f32.
//   * It kept the whole (K_pad, N) weight matrix and (KB, N, bm) x 2
//     stats in shared memory, so (K, N) = (256, 256) could not launch.
//     Here N is walked in chunks of nc weight columns staged as an
//     (nc, K_pad) slice (once per block where nc = N), and the stats are
//     (2 KB, cols) floats whatever N is: a column is sorted once per K
//     block and each of the N weight planes reuses that order.  The K
//     block masses that the combine halves are summed inside this kernel,
//     in row order in f32 (the plain version's order), from the staged
//     slice: the launch is the call's only kernel.
//   * Loads are coalesced and streamed.  A chunk of bk rows x cols columns
//     is read by the whole block, neighbouring threads on one row's
//     contiguous columns, into registers, and written to the tile after
//     the current chunk has been computed: the next chunk's HBM latency
//     hides behind this one's sort.  Staging through registers lets every
//     element land at a swizzled address (column c of row r at r cols +
//     (c + r / (32 / cols)) mod cols), so a warp reading 32 consecutive
//     rows of its column hits 32 distinct banks; it also takes bf16, and
//     ragged columns, on one path.
//   * The MAD needs no second sort.  Over a sorted block |x - med| falls
//     and then rises (sentinels, +inf, extend the rise): one bitonic merge
//     of log2(32 RPL) stages sorts it.
//   * With several K blocks and weights, the sorted block is written back
//     over its rows of the tile, with its row indices beside it, so every
//     later weight plane reads it without sorting again.
//   * __launch_bounds__ per instantiation: the unweighted 512-row blocks
//     (the large-cohort path) are held to 128 registers, two 256-thread
//     blocks an SM; the others take what they need, so none spills.
#include "mm_common.cuh"

namespace {

using mm::ilog2;
using mm::key_value;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCols = 8;               // columns a block, one warp each
constexpr int kMaxThreads = 32 * kMaxCols;
constexpr int kMaxRowsPerLane = 16;       // bk <= 512
constexpr int kRegCombine = 32;           // K blocks a warp combines in registers
constexpr int kDefaultSmem = 48 * 1024;   // dynamic shared memory without opt-in
constexpr int kMaxDevices = 16;
static_assert(kMaxThreads == mm::kThreads, "one warp per column of a tile");

// Smallest power of two >= n (>= 2): the combine strip's length.
__host__ __device__ inline int next_pow2(int n) {
  int p = 2;
  while (p < n) p *= 2;
  return p;
}

template <typename K>
__device__ __forceinline__ K kmin(K a, K b) { return b < a ? b : a; }
template <typename K>
__device__ __forceinline__ K kmax(K a, K b) { return b < a ? a : b; }

struct Params {
  int64_t ld, m;
  int k, n, bk, kb, nc, cols, log_cols, num_iters;
  float c;
};

// Tile address of (row r, column c): rows of `cols` floats, each row's
// columns rotated by r / (32 / cols), so 32 consecutive rows of one
// column fall in 32 banks.
__device__ __forceinline__ int tile_at(const Params& p, int r, int c) {
  return r * p.cols + ((c + (r >> (5 - p.log_cols))) & (p.cols - 1));
}

// One ascending compare-exchange stage at distance 2^t of a sequence of
// 32 RPL elements held by a warp as e = lane * RPL + q: the element with
// bit t clear keeps the smaller key.
template <int RPL, typename K>
__device__ __forceinline__ void warp_stage(K (&v)[RPL], int lane, int t) {
  constexpr int LOGR = ilog2(RPL);
  if (t >= LOGR) {  // partner: lane ^ 2^(t - LOGR), same q
    const int lm = 1 << (t - LOGR);
    const bool lower = (lane & lm) == 0;
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      const K o = __shfl_xor_sync(kFull, v[q], lm);
      v[q] = lower ? kmin(v[q], o) : kmax(v[q], o);
    }
  } else {  // partner: q ^ 2^t in this lane
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int j = i ^ (1 << t);
      if (j > i) {
        const K lo = kmin(v[i], v[j]), hi = kmax(v[i], v[j]);
        v[i] = lo;
        v[j] = hi;
      }
    }
  }
}

// The first stage of merge level s: element e against its mirror in its
// 2^s-run, e ^ (2^s - 1), the lower one keeping the smaller key.  With
// this stage every later comparator ascends.
template <int RPL, typename K>
__device__ __forceinline__ void warp_flip(K (&v)[RPL], int lane, int s) {
  constexpr int LOGR = ilog2(RPL);
  if (s <= LOGR) {  // inside the lane: q ^ (2^s - 1)
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int j = i ^ ((1 << s) - 1);
      if (j > i) {
        const K lo = kmin(v[i], v[j]), hi = kmax(v[i], v[j]);
        v[i] = lo;
        v[j] = hi;
      }
    }
  } else {  // lane ^ (2^(s - LOGR) - 1), q ^ (RPL - 1)
    const int lm = (1 << (s - LOGR)) - 1;
    const bool lower = (lane & (1 << (s - LOGR - 1))) == 0;
#pragma unroll
    for (int q = 0; q < RPL / 2 + (RPL == 1); ++q) {
      const int r = RPL - 1 - q;
      const K oq = __shfl_xor_sync(kFull, v[r], lm);   // the partner's v[r]
      const K orr = __shfl_xor_sync(kFull, v[q], lm);  // the partner's v[q]
      v[q] = lower ? kmin(v[q], oq) : kmax(v[q], oq);
      if (r != q) v[r] = lower ? kmin(v[r], orr) : kmax(v[r], orr);
    }
  }
}

// Ascending bitonic sort of the warp's 32 RPL elements: each merge level
// is a mirror stage, then ascending half-cleaners.
template <int RPL, typename K>
__device__ __forceinline__ void warp_sort(K (&v)[RPL], int lane) {
  constexpr int LOG = ilog2(RPL) + 5;
#pragma unroll
  for (int s = 1; s <= LOG; ++s) {
    warp_flip<RPL>(v, lane, s);
#pragma unroll
    for (int t = s - 2; t >= 0; --t) warp_stage<RPL>(v, lane, t);
  }
}

// Ascending sort of a bitonic sequence (falling, then rising).
template <int RPL, typename K>
__device__ __forceinline__ void warp_merge(K (&v)[RPL], int lane) {
  constexpr int LOG = ilog2(RPL) + 5;
#pragma unroll
  for (int t = LOG - 1; t >= 0; --t) warp_stage<RPL>(v, lane, t);
}

// v[q] for a runtime q by a tree of selects on q's bits, so the array
// stays in registers (an indexed read would go to local memory).
template <int RPL>
__device__ __forceinline__ float pick(const float (&v)[RPL], int q) {
  if constexpr (RPL == 1) {
    return v[0];
  } else {
    float h[RPL / 2];
#pragma unroll
    for (int i = 0; i < RPL / 2; ++i) h[i] = (q & 1) ? v[2 * i + 1] : v[2 * i];
    return pick<RPL / 2>(h, q >> 1);
  }
}

// The element at warp position e (the same e in every lane), everywhere.
template <int RPL>
__device__ __forceinline__ float at_position(const float (&v)[RPL], int e) {
  return __shfl_sync(kFull, pick(v, e & (RPL - 1)), e / RPL);
}

// Midpoint of the sorted positions (cnt - 1) / 2 and cnt / 2.
template <int RPL>
__device__ __forceinline__ float middle(const float (&v)[RPL], int cnt) {
  return 0.5f * (at_position(v, (cnt - 1) / 2) + at_position(v, cnt / 2));
}

// Rank median of |x - med| over the cnt sorted values of a block.
template <int RPL>
__device__ __forceinline__ float block_mad(const float (&xs)[RPL], int lane,
                                           int cnt, float med) {
  float d[RPL];
#pragma unroll
  for (int q = 0; q < RPL; ++q)
    d[q] = lane * RPL + q < cnt ? fabsf(xs[q] - med)
                                : __int_as_float(0x7f800000);
  warp_merge<RPL>(d, lane);
  return middle(d, cnt);
}

// Value at the first sorted position whose cumulative weight reaches half
// the block's mass while the previous one is below it (no epsilon); 0
// where none does.  The cumulative sum, and the mass, run position by
// position in f32, the plain version's order: lane s extends lane s - 1's
// sum, one lane at a time, over the lanes that hold valid positions.
template <int RPL>
__device__ __forceinline__ float block_crossing(const float (&xs)[RPL],
                                                const float (&ws)[RPL],
                                                int lane, int cnt) {
  float pre[RPL];
  float carry = 0.0f, cin = 0.0f;
  const int lanes = (cnt + RPL - 1) / RPL;
  for (int s = 0; s < lanes; ++s) {
    float cw = carry;
    if (lane == s) {
      cin = cw;
#pragma unroll
      for (int q = 0; q < RPL; ++q) pre[q] = (cw += ws[q]);
    }
    carry = __shfl_sync(kFull, cw, s);
  }
  if (lane >= lanes) {
    cin = carry;
#pragma unroll
    for (int q = 0; q < RPL; ++q) pre[q] = carry;
  }
  const float half = 0.5f * carry;
  float val = 0.0f;
  bool hit = false;
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    const float prev = q == 0 ? cin : pre[q - 1];
    if (pre[q] >= half && prev < half) {
      val = xs[q];
      hit = true;
    }
  }
  const unsigned b = __ballot_sync(kFull, hit);
  return b ? __shfl_sync(kFull, val, __ffs(b) - 1) : 0.0f;
}

__device__ __forceinline__ uint64_t stat_pair(float v, int b) {
  return ((uint64_t)mm::sort_key(v) << 32) | (uint32_t)b;
}

// Mass-weighted median of the kb block statistics st[b * cols] of one
// (column, n): the (value, block) pairs in ascending order (the plain
// version's stable argsort), masses mass[b * stride] added in that order
// in f32, the crossing at `half` with no epsilon; 0 where none crosses.
// Every lane returns the same value.  kb <= 32: one pair a lane, sorted
// by the warp network; above, the pairs are sorted in `strip`, this
// warp's P = next_pow2(kb) slots of shared memory.
__device__ float combine(const float* st, int cols,
                         const float* __restrict__ mass, int stride, int kb,
                         float half, uint64_t* strip, int lane) {
  if (kb == 1) return mass[0] >= half && 0.0f < half ? st[0] : 0.0f;
  if (kb <= kRegCombine) {
    uint64_t s[1] = {lane < kb ? stat_pair(st[lane * cols], lane) : ~0ull};
    warp_sort<1>(s, lane);
    const float mine = lane < kb ? mass[(int)(uint32_t)s[0] * stride] : 0.0f;
    float cw = 0.0f;
    int hit = -1;
    for (int j = 0; j < kb; ++j) {
      const float prev = cw;
      cw += __shfl_sync(kFull, mine, j);
      if (hit < 0 && cw >= half && prev < half) hit = j;
    }
    const float v = __shfl_sync(kFull, key_value((uint32_t)(s[0] >> 32)),
                                hit < 0 ? 0 : hit);
    return hit < 0 ? 0.0f : v;
  }
  int pw = 2;
  while (pw < kb) pw *= 2;
  for (int i = lane; i < pw; i += 32)
    strip[i] = i < kb ? stat_pair(st[i * cols], i) : ~0ull;
  __syncwarp();
  for (int size = 2; size <= pw; size *= 2) {
    for (int j = size / 2; j > 0; j /= 2) {
      for (int i = lane; i < pw; i += 32) {
        const int o = i ^ j;
        if (o > i) {
          const uint64_t a = strip[i], b = strip[o];
          const bool up = (i & size) == 0;
          if ((b < a) == up) {
            strip[i] = b;
            strip[o] = a;
          }
        }
      }
      __syncwarp();
    }
  }
  float cw = 0.0f, out = 0.0f;
  bool found = false;
  for (int j = 0; j < kb; ++j) {
    const uint64_t pr = strip[j];
    const float prev = cw;
    cw += mass[(int)(uint32_t)pr * stride];
    if (!found && cw >= half && prev < half) {
      out = key_value((uint32_t)(pr >> 32));
      found = true;
    }
  }
  __syncwarp();  // the strip's readers are done before it is refilled
  return out;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The block's (bk, cols) chunk of rows [r0, r0 + cnt) at column m0, into
// registers: element e = threadIdx.x + blockDim.x i is row e / cols,
// column e % cols, so neighbouring threads read one row's contiguous
// columns.
template <int RPL, typename T>
__device__ __forceinline__ void load_chunk(T (&pre)[RPL],
                                           const T* __restrict__ x,
                                           const Params& p, int64_t m0,
                                           int r0) {
  const int cnt = min(p.k - r0, p.bk);
  const int valid_cols = (int)min((int64_t)p.cols, p.m - m0);
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int e = threadIdx.x + blockDim.x * i;
    const int rl = e >> p.log_cols, cc = e & (p.cols - 1);
    pre[i] = rl < cnt && cc < valid_cols
                 ? x[(int64_t)(r0 + rl) * p.ld + m0 + cc]
                 : mm::from_f32<T>(0.0f);
  }
}

template <int RPL, typename T>
__device__ __forceinline__ void store_chunk(const T (&pre)[RPL], float* tile,
                                            const Params& p, int r0) {
  const int cnt = min(p.k - r0, p.bk);
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int e = threadIdx.x + blockDim.x * i;
    const int rl = e >> p.log_cols;
    if (rl < cnt)
      tile[tile_at(p, r0 + rl, e & (p.cols - 1))] = mm::to_f32(pre[i]);
  }
}

// Weight columns [n0, n0 + nc) as an (nc, K_pad) slice, 0 past row k,
// then their K block masses ms[b * p.nc + nl], each summed by one thread
// in row order in f32 (the plain version's order) from the slice.
__device__ __forceinline__ void stage_weights(float* ws, float* ms,
                                              const float* __restrict__ a,
                                              const Params& p, int n0) {
  const int nc = min(p.nc, p.n - n0), k_pad = p.kb * p.bk;
  for (int i = threadIdx.x; i < nc * k_pad; i += blockDim.x) {
    const int r = i / nc, nl = i - r * nc;
    ws[nl * k_pad + r] = r < p.k ? a[(int64_t)r * p.n + n0 + nl] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.kb * nc; i += blockDim.x) {
    const int b = i / nc, nl = i - b * nc;
    const float* w = ws + nl * k_pad + b * p.bk;
    float s = 0.0f;
    for (int r = 0; r < p.bk; ++r) s += w[r];
    ms[b * p.nc + nl] = s;
  }
}

// Blocks an SM must hold: two for the unweighted 512-row blocks (the
// large-cohort path; 128 registers fit its sort without spilling), else
// one, so that no instantiation spills to local memory.
template <int RPL, bool WEIGHTED>
constexpr int min_blocks() { return !WEIGHTED && RPL == 16 ? 2 : 1; }

template <int RPL, bool WEIGHTED, typename T>
__global__ void __launch_bounds__(kMaxThreads, (min_blocks<RPL, WEIGHTED>()))
mm_two_pass(const T* __restrict__ x, const float* __restrict__ a,
            T* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k_pad = p.kb * p.bk;
  const int strip_len = p.kb > kRegCombine ? next_pow2(p.kb) : 0;
  uint64_t* strips = reinterpret_cast<uint64_t*>(smem);        // (cols, P)
  float* tile = reinterpret_cast<float*>(strips + p.cols * strip_len);
  float* ws = tile + (size_t)k_pad * p.cols;                    // (nc, k_pad)
  float* st = ws + (size_t)p.nc * k_pad;                        // (2 kb, cols)
  float* ms = st + 2 * p.kb * p.cols;                           // (kb, nc)
  uint16_t* idx = reinterpret_cast<uint16_t*>(ms + p.kb * p.nc);  // (k_pad, cols)

  const int lane = threadIdx.x & 31, col = threadIdx.x >> 5;
  uint64_t* strip = strips + col * strip_len;
  const int64_t tiles = (p.m + p.cols - 1) / p.cols;
  int64_t t = blockIdx.x;
  if (t >= tiles) return;  // the whole block leaves together
  const bool staged_once = p.nc >= p.n;
  if (staged_once) stage_weights(ws, ms, a, p, 0);  // read after the first sync

  T pre[RPL];
  load_chunk(pre, x, p, t * p.cols, 0);
  float v[RPL], xs[RPL];  // a block's rows in row order; sorted (KB = 1)
  int rw[RPL];            // sorted positions' rows (weighted, KB = 1)
  for (; t < tiles; t += gridDim.x) {
    const int64_t m0 = t * p.cols;
    // ---- pass 1: sort each K block of this warp's column once ----
    for (int b = 0; b < p.kb; ++b) {
      const int r0 = b * p.bk, cnt = min(p.k - r0, p.bk);
      __syncthreads();  // the rows' previous readers are done
      store_chunk(pre, tile, p, r0);
      __syncthreads();
      if (b + 1 < p.kb) load_chunk(pre, x, p, m0, r0 + p.bk);
      else if (t + gridDim.x < tiles)
        load_chunk(pre, x, p, (t + gridDim.x) * p.cols, 0);
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const int j = q * 32 + lane;
        v[q] = j < cnt ? tile[tile_at(p, r0 + j, col)] : 0.0f;
      }
      if (WEIGHTED) {
        uint64_t s[RPL];
#pragma unroll
        for (int q = 0; q < RPL; ++q) {
          const int j = q * 32 + lane;
          s[q] = j < cnt ? ((uint64_t)mm::sort_key(v[q]) << 32) | (uint32_t)j
                         : ~0ull;  // sentinel: after every row, NaN included
        }
        warp_sort<RPL>(s, lane);
#pragma unroll
        for (int q = 0; q < RPL; ++q) {
          const bool valid = lane * RPL + q < cnt;
          xs[q] = valid ? key_value((uint32_t)(s[q] >> 32)) : 0.0f;
          rw[q] = valid ? (int)(uint32_t)s[q] : 0;
        }
        if (p.kb > 1) {  // position lane * RPL + q back at row q * 32 + lane
          __syncwarp();
#pragma unroll
          for (int q = 0; q < RPL; ++q) {
            if (lane * RPL + q < cnt) {
              const int at = tile_at(p, r0 + q * 32 + lane, col);
              tile[at] = xs[q];
              idx[at] = (uint16_t)rw[q];
            }
          }
        }
      } else {
        uint32_t s[RPL];
#pragma unroll
        for (int q = 0; q < RPL; ++q)
          s[q] = q * 32 + lane < cnt ? mm::sort_key(v[q]) : 0xffffffffu;
        warp_sort<RPL>(s, lane);
#pragma unroll
        for (int q = 0; q < RPL; ++q)
          xs[q] = lane * RPL + q < cnt ? key_value(s[q]) : 0.0f;
        const float med = middle(xs, cnt);
        const float mad = block_mad(xs, lane, cnt, med);
        if (lane == 0) {
          st[b * p.cols + col] = med;
          st[(p.kb + b) * p.cols + col] = mad;
        }
      }
    }

    // ---- pass 2, per weight column: combine, then IRLS over every row ----
    for (int n0 = 0; n0 < p.n; n0 += p.nc) {
      if (!staged_once) {
        __syncthreads();  // the previous chunk's readers are done
        stage_weights(ws, ms, a, p, n0);
      }
      __syncthreads();
      const int nc = min(p.nc, p.n - n0);
      for (int nl = 0; nl < nc; ++nl) {
        const int nn = n0 + nl;
        const float* wn = ws + (size_t)nl * k_pad;
        float wv[RPL];  // KB = 1: the IRLS weights of the rows in registers
        if (WEIGHTED) {
          for (int b = 0; b < p.kb; ++b) {
            const int r0 = b * p.bk, cnt = min(p.k - r0, p.bk);
            if (p.kb > 1) {
#pragma unroll
              for (int q = 0; q < RPL; ++q) {
                const bool valid = lane * RPL + q < cnt;
                const int at = tile_at(p, r0 + q * 32 + lane, col);
                xs[q] = valid ? tile[at] : 0.0f;
                rw[q] = valid ? idx[at] : 0;
              }
            }
#pragma unroll
            for (int q = 0; q < RPL; ++q)
              wv[q] = lane * RPL + q < cnt ? wn[r0 + rw[q]] : 0.0f;
            const float med = block_crossing(xs, wv, lane, cnt);
            const float mad = block_mad(xs, lane, cnt, med);
            if (lane == 0) {
              st[b * p.cols + col] = med;
              st[(p.kb + b) * p.cols + col] = mad;
            }
          }
        } else if (p.kb == 1) {
#pragma unroll
          for (int q = 0; q < RPL; ++q)
            wv[q] = q * 32 + lane < p.k ? wn[q * 32 + lane] : 0.0f;
        }
        __syncwarp();
        const float* mb = ms + nl;  // this plane's block masses
        float half = 0.0f;
        for (int b = 0; b < p.kb; ++b) half += mb[b * p.nc];
        half *= 0.5f;
        const float mu0 = combine(st + col, p.cols, mb, p.nc, p.kb, half,
                                  strip, lane);
        const float mad = combine(st + p.kb * p.cols + col, p.cols, mb, p.nc,
                                  p.kb, half, strip, lane);
        const float scale = fmaxf(mm::kMadConsistency * mad, mm::kScaleFloor);
        const float inv = 1.0f / (p.c * scale);
        float mu = mu0;
        for (int it = 0; it < p.num_iters; ++it) {
          float num = 0.0f, den = 0.0f;
          if (p.kb == 1) {  // rows in registers: sorted (weighted) or not
#pragma unroll
            for (int q = 0; q < RPL; ++q)
              mm::tukey_accumulate(WEIGHTED ? xs[q] : v[q], wv[q], mu, inv,
                                   num, den);
          } else {
            for (int b = 0; b < p.kb; ++b) {
              const int r0 = b * p.bk, cnt = min(p.k - r0, p.bk);
#pragma unroll
              for (int q = 0; q < RPL; ++q) {
                const int slot = q * 32 + lane;
                const bool valid = (WEIGHTED ? lane * RPL + q : slot) < cnt;
                const int at = tile_at(p, r0 + slot, col);
                const float xv = valid ? tile[at] : 0.0f;
                const float av =
                    valid ? wn[r0 + (WEIGHTED ? (int)idx[at] : slot)] : 0.0f;
                mm::tukey_accumulate(xv, av, mu, inv, num, den);
              }
            }
          }
          num = warp_sum(num);
          den = warp_sum(den);
          mu = mm::irls_update(num, den, mu);
        }
        if (lane == 0 && m0 + col < p.m)
          out[(int64_t)nn * p.m + m0 + col] = mm::from_f32<T>(mu);
        __syncwarp();  // st is rewritten by the next plane
      }
    }
  }
}

// What one instantiation was last granted and found on one device: the
// dynamic shared memory it may use, and for blocks of `threads` threads
// and `smem` bytes how many one SM holds (the card's own answer, 0 where
// none fits) and the SM count.
struct Occupancy {
  size_t granted = kDefaultSmem;
  int threads = 0;
  size_t smem = 0;
  int per_sm = 0;
  int sms = 0;
};

// The occupancy of this launch: asked of the current device once per
// instantiation, device and (threads, smem); both the shared-memory
// opt-in and the SM count belong to a device.
template <int RPL, bool WEIGHTED, typename T>
cudaError_t resident_blocks(int threads, size_t smem, Occupancy* found) {
  static Occupancy cached[kMaxDevices];
  auto kern = mm_two_pass<RPL, WEIGHTED, T>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Occupancy uncached;  // a device past the cache asks every launch
  Occupancy* o = dev < kMaxDevices ? &cached[dev] : &uncached;
  if (o->sms && o->threads == threads && o->smem == smem) {
    *found = *o;
    return cudaSuccess;
  }
  if (smem > o->granted) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    o->granted = smem;
  }
  int per_sm = 0, sms = 0;
  err = mm::occupancy(kern, threads, smem, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  o->threads = threads;
  o->smem = smem;
  o->per_sm = per_sm;
  o->sms = sms;
  *found = *o;
  return cudaSuccess;
}

// Where a launch goes instead of the card: a query of its configuration
// (mm_two_pass_config) or of its grid alone (mm_two_pass_blocks).
struct Report {
  mm::LaunchQuery* query;
  int64_t* blocks;
};

// One launch: min(column tiles, blocks the card holds at once) blocks of
// one warp a column walk the tiles grid-stride.  With no resident block
// (per_sm 0) it fails rather than launch a grid that cannot run.
template <int RPL, bool WEIGHTED, typename T>
int launch(const void* x, const float* a, void* out, const Params& p,
           size_t smem, cudaStream_t stream, const Report& report) {
  const int threads = 32 * p.cols;
  Occupancy occ;
  cudaError_t err = resident_blocks<RPL, WEIGHTED, T>(threads, smem, &occ);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (p.m + p.cols - 1) / p.cols;
  const int64_t held = (int64_t)occ.sms * occ.per_sm;
  if (blocks > held) blocks = held;
  if (report.blocks) {  // the grid alone
    *report.blocks = blocks;
    return 0;
  }
  if (report.query) {
    snprintf(report.query->name, report.query->name_len,
             "mm_two_pass<%d, %s, %s>", RPL, WEIGHTED ? "true" : "false",
             mm::type_name<T>());
    return mm::report(report.query, blocks, threads, smem, occ.per_sm,
                      occ.sms);
  }
  if (blocks < 1) return (int)cudaErrorLaunchOutOfResources;
  mm_two_pass<RPL, WEIGHTED, T><<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), a, static_cast<T*>(out), p);
  return (int)cudaGetLastError();
}

template <bool WEIGHTED, typename T>
int launch_rows(const void* x, const float* a, void* out, const Params& p,
                size_t smem, cudaStream_t s, const Report& r) {
  if (p.bk <= 32) return launch<1, WEIGHTED, T>(x, a, out, p, smem, s, r);
  if (p.bk == 64) return launch<2, WEIGHTED, T>(x, a, out, p, smem, s, r);
  if (p.bk == 128) return launch<4, WEIGHTED, T>(x, a, out, p, smem, s, r);
  if (p.bk == 256) return launch<8, WEIGHTED, T>(x, a, out, p, smem, s, r);
  if (p.bk == 512) return launch<16, WEIGHTED, T>(x, a, out, p, smem, s, r);
  return (int)cudaErrorInvalidValue;
}

size_t smem_bytes(int k, int nc, int bk, int cols) {
  const size_t kb = (size_t)((k + bk - 1) / bk), k_pad = kb * bk;
  const size_t strip = kb > kRegCombine ? (size_t)next_pow2((int)kb) : 0;
  return sizeof(uint64_t) * cols * strip +
         sizeof(float) * (k_pad * cols + (size_t)nc * k_pad +
                          2 * kb * cols + kb * (size_t)nc) +
         (kb > 1 ? sizeof(uint16_t) * k_pad * cols : 0);
}

// Checks the launch arguments and runs (report empty) or reports one
// launch.
int dispatch(const void* x, int dtype, int64_t ld, int k, int64_t m,
             const void* a, int n, void* out, int bk, int nc, int cols,
             int num_iters, float c, int weighted, void* stream,
             const Report& report) {
  if (k < 1 || n < 1 || m < 1 || bk < 2 || bk > 32 * kMaxRowsPerLane ||
      (bk & (bk - 1)) || nc < 1 || nc > n || cols < 1 || cols > kMaxCols ||
      (cols & (cols - 1)))
    return (int)cudaErrorInvalidValue;
  const Params p{ld, m, k, n, bk, (k + bk - 1) / bk, nc, cols, ilog2(cols),
                 num_iters, c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const size_t smem = smem_bytes(k, nc, bk, cols);
  if (dtype == 0)
    return weighted ? launch_rows<true, float>(x, af, out, p, smem, s, report)
                    : launch_rows<false, float>(x, af, out, p, smem, s, report);
  if (dtype == 1)
    return weighted
               ? launch_rows<true, __nv_bfloat16>(x, af, out, p, smem, s,
                                                  report)
               : launch_rows<false, __nv_bfloat16>(x, af, out, p, smem, s,
                                                   report);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory one block carves; the Python launch plan models the same
// number (mm_aggregate.two_pass_smem_bytes): above 32 K blocks each warp's
// strip of next_pow2(KB) (value, block) pairs for the combine, the
// (K_pad, cols) f32 tile, the (nc, K_pad) weight slice, (2 KB, cols)
// block stats, the (KB, nc) block masses and, with several K blocks, the
// (K_pad, cols) uint16 row index of the sorted blocks.
size_t mm_two_pass_smem_bytes(int k, int nc, int bk, int cols) {
  return smem_bytes(k, nc, bk, cols);
}

// x: (k, m) row-major with row stride ld, f32 (dtype 0) or bf16 (dtype 1);
// a: (k, n) f32 normalised weight columns; out: (n, m) in x's dtype;
// bk: the K block, a power of two <= 512 (any number of blocks); nc:
// weight columns per chunk; cols: columns (warps) per block, 1, 2, 4 or
// 8; c: Tukey's constant.  One launch; returns its cudaError_t.
int mm_two_pass_launch(const void* x, int dtype, int64_t ld, int k, int64_t m,
                       const void* a, int n, void* out, int bk, int nc,
                       int cols, int num_iters, float c, int weighted,
                       void* stream) {
  return dispatch(x, dtype, ld, k, m, a, n, out, bk, nc, cols, num_iters, c,
                  weighted, stream, Report{nullptr, nullptr});
}

// The blocks mm_two_pass_launch would launch for these arguments on the
// current device (min(column tiles, blocks the card holds at once)), in
// *blocks; launches nothing.  Returns a cudaError_t.
int mm_two_pass_blocks(int dtype, int k, int64_t m, int n, int bk, int nc,
                       int cols, int weighted, int64_t* blocks) {
  if (blocks == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(nullptr, dtype, m, k, m, nullptr, n, nullptr, bk, nc, cols,
                  0, 1.0f, weighted, nullptr, Report{nullptr, blocks});
}

// What mm_two_pass_launch would launch for these arguments on the current
// device, through the same dispatch, launching nothing: in out[0..4] the
// blocks, threads a block, dynamic shared memory, the blocks of that size
// one SM holds (0 where none fits) and the SM count; in `name` the
// kernel's instantiation.  Returns a cudaError_t.
int mm_two_pass_config(int dtype, int k, int64_t m, int n, int bk, int nc,
                       int cols, int weighted, int64_t* out, char* name,
                       int name_len) {
  if (out == nullptr || name == nullptr || name_len < 1)
    return (int)cudaErrorInvalidValue;
  mm::LaunchQuery q{0, 0, 0, 0, 0, name, name_len};
  const int err = dispatch(nullptr, dtype, m, k, m, nullptr, n, nullptr, bk,
                           nc, cols, 0, 1.0f, weighted, nullptr,
                           Report{&q, nullptr});
  out[0] = q.blocks;
  out[1] = q.threads;
  out[2] = q.smem;
  out[3] = q.per_sm;
  out[4] = q.sms;
  return err;
}

}  // extern "C"
