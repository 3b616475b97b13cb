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
// operations (bytes alone: 9.64 ms; chip_smoke.mm_ops).  In practice the
// kernel is bound by instruction issue: sorting, cumulative sums and
// reductions cost far more instructions than the modelled operations.
//
// Two layouts, one kernel: mm_two_pass<RPL, WEIGHTED, T, LANES>, RPL rows
// a lane and LANES lanes a column.
//
// One K block (kb == 1, every launch with K <= 512 by default): the group
// layout, mm_two_pass<R, W, T, bk / R>, R = 16 rows a lane up to bk = 128
// and 32 above (LANES = 1 where bk <= R).  The serve cohort's launch is
// mm_two_pass<16, true, float, 8>.
//   * A column's B = R LANES rows are held by a group of LANES lanes, R a
//     lane, read straight from HBM into registers (lane li holds rows
//     q LANES + li, so one load instruction of a warp reads LANES rows of
//     32 / LANES neighbouring columns).  The group sorts them with the
//     bitonic network below: of the log2(B)(log2(B)+1)/2 stages only those
//     at distances >= R cross lanes (6 of 28 at bk = 128, against 15 when
//     a warp sorts a column at 4 rows a lane).  Unweighted columns sort
//     32-bit keys by min and max.  Weighted columns need the plain
//     version's stable argsort, the (key, row) order:
//       - R = 16 (bk <= 128): 32-bit coarse keys, by min and max
//         (sort_coarse): the key relative to the column's least, scaled
//         to fill 32 bits, with the row in its low log2(B) bits.  The
//         exact values are gathered back by row from a copy of the rows
//         in the strip (re-reading them from HBM instead made the serve
//         cohort's launch 20% slower on an H100), and the order is
//         checked: where a full key falls from one position to the next
//         (two values share their coarse bits), the warp sorts its tile
//         again on pairs.  On an H100 2.1% of the serve cohort's
//         warp-tiles take that path (112 N(0, 1) values and 16 copies of
//         one a column), and none of narrow data (1000 + N(0, 1e-3)),
//         which every tile took before the relative scale.
//       - R = 32 (bk 256 / 512): 64-bit (key, row) pairs at one comparison
//         a compare-exchange.  Coarse keys would drop 8-9 bits: a numpy
//         model of the cohort's mix fails 4.8% of columns at K = 256 and
//         33% at 512, against 0.55% at 128.
//   * The sorted values (and, weighted, their rows) go to the group's
//     slots of the block's strips in shared memory.  The work that is
//     serial or a reduction per column stays in the group, so no barrier
//     of the block is needed between tiles: the weights summed in sorted
//     order in f32 from position 0, lane after lane (the half mass), then
//     by each lane again from its carry-in to the position that crosses
//     half; the MAD by selection, which each lane of the group runs on
//     the strip: the |x - med| of a sorted column fall to the split at
//     med and rise after it, so the rank-r one is the r-th of two sorted
//     runs, found by a binary search over how many the left run gives.
//   * IRLS: each lane sums its R rows in registers in reciprocal form, and
//     log2(LANES) butterfly steps of shuffles (3 at bk = 128) leave the
//     group's sum in each of its lanes.  Weighted rows are the sorted
//     values with their gathered weights (by a row strip in shared memory:
//     R = 16, each thread's positions' rows packed four to a word; R = 32,
//     a uint16 row a position); unweighted rows are the rows as loaded,
//     with their own weights.
//   * A block holds `cols` columns (a power of two, at most 256 / LANES,
//     from M as the launch plan picks it), cols LANES threads (at least
//     one warp: the groups past `cols` hold no column).  Shared memory:
//     the (nc, bk) weight slice, nc masses and the strips, laid out for
//     the widest block so their offsets are constants: 6 R 256 bytes,
//     24.5 KB at bk = 128, 48.5 KB above (the row strip is carved for
//     every instantiation; only weighted ones write it).  Blocks of 16
//     rows a lane are held to 85 registers, three 256-thread blocks (24
//     warps) an SM; those of 32 to 128, two (the weighted 512-row ones
//     take one).
//   * Budget a column at (K, N) = (128, 1), weighted, in warp
//     instructions over 4 columns a warp: the coarse-key sort ~160 (22
//     in-lane stages of 8 compare-exchanges of 2 instructions and 6
//     cross-lane stages of 16 elements of 3), the range, row copy, gather
//     and check ~70, IRLS ~310 (10 steps of 128 rows of 7 instructions,
//     plus 6 shuffles a step), the cumulative sums ~35 and the MAD ~50,
//     loads and strips ~40: ~670, against ~880 with 64-bit pairs (~430
//     for the sort: compare-exchanges of 6 instructions, cross-lane
//     elements of 7) and ~400 unweighted.  On an H100 the serve cohort's
//     launch (128, 15,730,944, 1) takes 21.5 ms, against 29.1 with pairs
//     and 16.0 unweighted.  IRLS's f32 work now outweighs the sort's
//     integer work; the rest of the weighted path's extra cost is the
//     copy, gather and check and the crossing's serial sum over the
//     group's lanes (group_crossing).
//
// Several K blocks (kb > 1): the warp layout, mm_two_pass<bk / 32, W, T,
// 32> (RPL = 1 for bk <= 32), one warp a column, as the first redesign
// built it:
//   * Lane l holds bk / 32 of a block's rows in registers, and a warp
//     bitonic network orders them, in-lane stages on registers and
//     cross-lane stages by __shfl_xor_sync (45 stages of 16 compare-
//     exchanges a lane at bk = 512).  The warp's element e = lane * RPL +
//     q, so the first log2(RPL) distances of every merge stay inside a
//     lane.  Each merge level opens with a mirror stage (e against e ^
//     (2^s - 1)), so every comparator ascends and none picks its direction
//     at run time.
//   * A block is `cols` warps over `cols` columns (8, or fewer where the
//     tile would not fit or M gives fewer tiles than the card has SMs),
//     and IRLS is split across the warp's lanes in reciprocal form, num
//     and den reduced by a butterfly of shuffles.
//   * The (value, block) pairs of one (column, n) are sorted once for the
//     combine: in registers, one pair a lane, for KB <= 32; in a per-warp
//     strip of shared memory above that, so any KB launches.  The masses
//     are then added in that order in f32.
//   * N is walked in chunks of nc weight columns staged as an (nc, K_pad)
//     slice (once per block where nc = N), and the stats are (2 KB, cols)
//     floats whatever N is: a column is sorted once per K block and each
//     of the N weight planes reuses that order.  The K block masses that
//     the combine halves are summed inside this kernel, in row order in
//     f32 (the plain version's order), from the staged slice: the launch
//     is the call's only kernel (both layouts).
//   * A chunk of bk rows x cols columns is read by the whole block,
//     neighbouring threads on one row's contiguous columns, into
//     registers, and written to the tile after the current chunk has been
//     computed.  Each element lands at a swizzled address (column c of row
//     r at r cols + (c + r / (32 / cols)) mod cols), so a warp reading 32
//     consecutive rows of its column hits 32 distinct banks.
//   * The block MAD merges |x - med| (falling, then rising) with one
//     bitonic merge.  With weights, the sorted block is written back over
//     its rows of the tile, with its row indices beside it, so every
//     later weight plane reads it without sorting again.
//   * __launch_bounds__ per instantiation: the unweighted 512-row warp
//     blocks are held to 128 registers, two 256-thread blocks an SM, as
//     are all group-layout blocks; the others take what they need, so none
//     spills.
//
// Rows where they lie: a weighted launch may pass a device table of k row
// addresses instead of x (Params::rows), and row r is then read at
// rows[r]: the streaming service's launch program reads its cohort's
// payloads so, without staging them into one (k, M) buffer.  One K block
// (the group layout): each block copies the table once, before its column
// loop, to k slots of shared memory past the layout's own, so only a
// table launch carves them (8 k bytes, k <= 512; smem_bytes counts them)
// and a launch without one keeps its shared memory and its occupancy.
// Several K blocks (one warp a column): the table is read where it lies,
// each chunk's bases through the read-only cache before its elements, so
// no launch carves more for it at any k.  The loads take the row base by one
// branch a tile (or chunk) on whether the launch has a table, never one
// an element; the table's address is read from the parameters there, so
// no register holds it across the loop (held, it spilled the warp and
// 16-row group blocks).  The elements read, and their order, are those
// of the (k, M) launch: the same bits.
//   Unweighted launches take no table (the service launches weighted
// only), and the unweighted instantiations are compiled without the table
// path.  With it in its loop, the unweighted group layout of 32 rows a
// lane took 112-116 ms at (512, 15,730,944, 1) without a table, against
// 75-83 on an H100, whatever form the path took: its loads touch 16 rows an
// instruction and share sectors across warps through L1, and its time
// swings with their timing (the same kernel with plain loads in place of
// read-only ones took 116 ms); the unweighted warp layout of 512-row
// blocks spilled.
#include "mm_common.cuh"

namespace {

using mm::ilog2;
using mm::key_value;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCols = 8;               // warp layout: columns a block, one warp each
constexpr int kMaxThreads = 32 * kMaxCols;
constexpr int kMaxRowsPerLane = 16;       // bk <= 512
constexpr int kRegCombine = 32;           // K blocks a warp combines in registers
constexpr int kGroupThreads = 256;        // group layout: threads of the widest block
constexpr int kGroupSplit = 128;          // group layout: 16 rows a lane up to this bk, then 32

// Rows a lane and lanes a column of the group layout for a K block of bk
// rows (one K block).
__host__ __device__ constexpr int group_rows(int bk) {
  return bk > kGroupSplit ? 32 : 16;
}
__host__ __device__ constexpr int group_lanes(int bk) {
  return bk > group_rows(bk) ? bk / group_rows(bk) : 1;
}
constexpr int kDefaultSmem = 48 * 1024;   // dynamic shared memory without opt-in
constexpr int kMaxDevices = 16;
static_assert(kMaxThreads == mm::kThreads, "one warp per column of a tile");

// Smallest power of two >= n (>= 2): the combine strip's length.
__host__ __device__ inline int next_pow2(int n) {
  int p = 2;
  while (p < n) p *= 2;
  return p;
}

// Orders (a, b) ascending on one comparison (two 32-bit compares for a
// 64-bit key, and four selects); 32-bit keys take a min and a max.
template <typename K>
__device__ __forceinline__ void exchange(K& a, K& b) {
  const bool swap = b < a;
  const K lo = swap ? b : a, hi = swap ? a : b;
  a = lo;
  b = hi;
}
template <>
__device__ __forceinline__ void exchange(uint32_t& a, uint32_t& b) {
  const uint32_t lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// The value a lane keeps of (mine, its partner's): the smaller where it
// is the lower of the two.
template <typename K>
__device__ __forceinline__ K keep(K mine, K other, bool lower) {
  return (other < mine) == lower ? other : mine;
}
template <>
__device__ __forceinline__ uint32_t keep(uint32_t mine, uint32_t other,
                                         bool lower) {
  return lower ? min(mine, other) : max(mine, other);
}

struct Params {
  int64_t ld, m;
  int k, n, bk, kb, nc, cols, log_cols, num_iters;
  float c;
  const void* rows;  // a device table of k row addresses, or null
  int64_t rows_at;   // where the group layout's copy of it lies in smem
};

// Row r's base in a table launch's device table, through the read-only
// cache.
template <typename T>
__device__ __forceinline__ const T* table_row(const Params& p, int r) {
  return reinterpret_cast<const T*>(
      __ldg(static_cast<const long long*>(p.rows) + r));
}

// The group layout's copy of a table launch's table, in the block's shared
// memory.
template <typename T>
__device__ __forceinline__ mm::RowBases<T> row_bases(const Params& p,
                                                     unsigned char* smem) {
  return reinterpret_cast<const T* const*>(smem + p.rows_at);
}

// Copies a table launch's row addresses to the block's shared memory (the
// group layout), then a barrier.
template <typename T>
__device__ __forceinline__ void stage_rows(const Params& p,
                                           unsigned char* smem) {
  const T** bases = reinterpret_cast<const T**>(smem + p.rows_at);
  for (int r = threadIdx.x; r < p.k; r += blockDim.x)
    bases[r] = table_row<T>(p, r);
  __syncthreads();
}

// Tile address of (row r, column c): rows of `cols` floats, each row's
// columns rotated by r / (32 / cols), so 32 consecutive rows of one
// column fall in 32 banks.
__device__ __forceinline__ int tile_at(const Params& p, int r, int c) {
  return r * p.cols + ((c + (r >> (5 - p.log_cols))) & (p.cols - 1));
}

// One ascending compare-exchange stage at distance 2^t of a sequence of
// LANES RPL elements held by a group of LANES lanes (the warp's aligned
// runs of LANES lanes) as e = lane * RPL + q: the element with bit t clear
// keeps the smaller key.  Partners never leave the group.
template <int RPL, typename K>
__device__ __forceinline__ void warp_stage(K (&v)[RPL], int lane, int t) {
  constexpr int LOGR = ilog2(RPL);
  if (t >= LOGR) {  // partner: lane ^ 2^(t - LOGR), same q
    const int lm = 1 << (t - LOGR);
    const bool lower = (lane & lm) == 0;
#pragma unroll
    for (int q = 0; q < RPL; ++q)
      v[q] = keep(v[q], __shfl_xor_sync(kFull, v[q], lm), lower);
  } else {  // partner: q ^ 2^t in this lane
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int j = i ^ (1 << t);
      if (j > i) exchange(v[i], v[j]);
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
      if (j > i) exchange(v[i], v[j]);
    }
  } else {  // lane ^ (2^(s - LOGR) - 1), q ^ (RPL - 1)
    const int lm = (1 << (s - LOGR)) - 1;
    const bool lower = (lane & (1 << (s - LOGR - 1))) == 0;
#pragma unroll
    for (int q = 0; q < RPL / 2 + (RPL == 1); ++q) {
      const int r = RPL - 1 - q;
      const K oq = __shfl_xor_sync(kFull, v[r], lm);   // the partner's v[r]
      const K orr = __shfl_xor_sync(kFull, v[q], lm);  // the partner's v[q]
      v[q] = keep(v[q], oq, lower);
      if (r != q) v[r] = keep(v[r], orr, lower);
    }
  }
}

// Ascending bitonic sort of each group's LANES RPL elements: each merge
// level is a mirror stage, then ascending half-cleaners.
template <int RPL, int LANES, typename K>
__device__ __forceinline__ void warp_sort(K (&v)[RPL], int lane) {
  constexpr int LOG = ilog2(RPL) + ilog2(LANES);
#pragma unroll
  for (int s = 1; s <= LOG; ++s) {
    warp_flip<RPL>(v, lane, s);
#pragma unroll
    for (int t = s - 2; t >= 0; --t) warp_stage<RPL>(v, lane, t);
  }
}

// Ascending sort of a bitonic sequence (falling, then rising) of a warp.
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

// Mass-weighted median of the kb > 1 block statistics st[b * cols] of one
// (column, n): the (value, block) pairs in ascending order (the plain
// version's stable argsort), masses mass[b * stride] added in that order
// in f32, the crossing at `half` with no epsilon; 0 where none crosses.
// Every lane returns the same value.  kb <= 32: one pair a lane, sorted
// by the warp network; above, the pairs are sorted in `strip`, this
// warp's P = next_pow2(kb) slots of shared memory.
__device__ float combine(const float* st, int cols,
                         const float* __restrict__ mass, int stride, int kb,
                         float half, uint64_t* strip, int lane) {
  if (kb <= kRegCombine) {
    uint64_t s[1] = {lane < kb ? stat_pair(st[lane * cols], lane) : ~0ull};
    warp_sort<1, 32>(s, lane);
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
// columns.  Row r lies at the device table's entry r (a table launch;
// weighted instantiations, TABLE, only) or at x + r * ld.
template <bool TABLE, int RPL, typename T>
__device__ __forceinline__ void load_chunk(T (&pre)[RPL],
                                           const T* __restrict__ x,
                                           const Params& p, int64_t m0,
                                           int r0) {
  const int cnt = min(p.k - r0, p.bk);
  const int valid_cols = (int)min((int64_t)p.cols, p.m - m0);
  if constexpr (TABLE) {
    if (p.rows) {
      // every base first (a valid entry each), so their loads overlap:
      // read one by one beside their elements, each a round trip to L2
      // once the table outgrows what the tile leaves of L1, they cost
      // 10% at K 4096 and 14% at K 8192 on an H100
      const T* row[RPL];
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const int e = threadIdx.x + blockDim.x * i;
        row[i] = table_row<T>(p, min(r0 + (e >> p.log_cols), p.k - 1));
      }
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const int e = threadIdx.x + blockDim.x * i;
        const int rl = e >> p.log_cols, cc = e & (p.cols - 1);
        pre[i] = rl < cnt && cc < valid_cols ? row[i][m0 + cc]
                                             : mm::from_f32<T>(0.0f);
      }
      return;
    }
  }
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

// ---- several K blocks: one warp a column ----------------------------------

template <int RPL, bool WEIGHTED, typename T>
__device__ __forceinline__ void warp_columns(const T* __restrict__ x,
                                             const float* __restrict__ a,
                                             T* __restrict__ out,
                                             const Params& p,
                                             unsigned char* smem) {
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
  load_chunk<WEIGHTED>(pre, x, p, t * p.cols, 0);
  float v[RPL], xs[RPL];  // a block's rows in row order; sorted
  int rw[RPL];            // sorted positions' rows (weighted)
  for (; t < tiles; t += gridDim.x) {
    const int64_t m0 = t * p.cols;
    // ---- pass 1: sort each K block of this warp's column once ----
    for (int b = 0; b < p.kb; ++b) {
      const int r0 = b * p.bk, cnt = min(p.k - r0, p.bk);
      __syncthreads();  // the rows' previous readers are done
      store_chunk(pre, tile, p, r0);
      __syncthreads();
      if (b + 1 < p.kb)
        load_chunk<WEIGHTED>(pre, x, p, m0, r0 + p.bk);
      else if (t + gridDim.x < tiles)
        load_chunk<WEIGHTED>(pre, x, p, (t + gridDim.x) * p.cols, 0);
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
        warp_sort<RPL, 32>(s, lane);
#pragma unroll
        for (int q = 0; q < RPL; ++q) {
          const bool valid = lane * RPL + q < cnt;
          xs[q] = valid ? key_value((uint32_t)(s[q] >> 32)) : 0.0f;
          rw[q] = valid ? (int)(uint32_t)s[q] : 0;
        }
        // position lane * RPL + q back at row q * 32 + lane
        __syncwarp();
#pragma unroll
        for (int q = 0; q < RPL; ++q) {
          if (lane * RPL + q < cnt) {
            const int at = tile_at(p, r0 + q * 32 + lane, col);
            tile[at] = xs[q];
            idx[at] = (uint16_t)rw[q];
          }
        }
      } else {
        uint32_t s[RPL];
#pragma unroll
        for (int q = 0; q < RPL; ++q)
          s[q] = q * 32 + lane < cnt ? mm::sort_key(v[q]) : 0xffffffffu;
        warp_sort<RPL, 32>(s, lane);
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
        if (WEIGHTED) {
          for (int b = 0; b < p.kb; ++b) {
            const int r0 = b * p.bk, cnt = min(p.k - r0, p.bk);
            float wv[RPL];
#pragma unroll
            for (int q = 0; q < RPL; ++q) {
              const bool valid = lane * RPL + q < cnt;
              const int at = tile_at(p, r0 + q * 32 + lane, col);
              xs[q] = valid ? tile[at] : 0.0f;
              rw[q] = valid ? idx[at] : 0;
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

// ---- one K block: a group of LANES lanes a column ---------------------------

// Slot of sorted position e of the block's column c in a strip of R
// LANES rows of W = 256 / LANES entries (the widest block's columns,
// whatever the block holds, so every offset is a constant): the columns
// of row e rotated by (e / R) G.  A group's lanes hold runs of R
// positions and a warp's G = 32 / LANES groups neighbouring columns, so a
// warp storing the q-th position of every run hits 32 banks (W >= 32).
template <int R, int LANES>
__device__ __forceinline__ int strip_at(int e, int c) {
  constexpr int W = kGroupThreads / LANES, G = 32 / LANES;
  return e * W + ((c + (e / R) * G) & (W - 1));
}

// Slot of row r of column c while the strip holds a weighted column's
// rows before its sort: the slot of position (r mod LANES) R + r / LANES,
// where the lane that loaded the row keeps it.  A column keeps its own
// slots of every strip row, as in the sorted layout, so a group's copy
// never meets the strips of groups in other warps.
template <int R, int LANES>
__device__ __forceinline__ int row_at(int r, int c) {
  constexpr int W = kGroupThreads / LANES, G = 32 / LANES;
  const int li = r & (LANES - 1);
  return (li * R + r / LANES) * W + ((c + li * G) & (W - 1));
}

// Warp-tiles of the coarse-key sort (sort_coarse) that took the exact
// (key, row) sort, on this device, since mm_two_pass_exact_tiles last
// read it.
__device__ unsigned long long exact_tiles = 0;

// A weighted column of the group layout with 16 rows a lane (B = 16
// LANES <= 128 rows), sorted into the plain version's stable (key, row)
// order on 32-bit coarse keys, which the group's network sorts by min and
// max.  A row's coarse key is its sort_key less the column's least
// (aligned down to a multiple of B, so a wide column keeps the buckets of
// the keys themselves, +0 apart from -0), shifted left until the column's
// range fills 32 bits, with its low log2 B bits replaced by the row: an
// order-preserving map, exact where the range spans fewer than 2^(32 -
// log2 B) keys (narrow columns).  Sentinels (rows >= k) are 0xffffffff,
// above every valid key: where any exists, k - 1 < B - 1.  The exact
// values are gathered back by row from a copy of the rows in the strip;
// the coarse order is the exact one exactly where their keys never fall
// from one valid position to the next (equal keys are ordered by row
// already).  A warp whose group fails that check sorts its tile again on
// (key, row) pairs from the copy, one branch for the warp.  Leaves the
// sorted values in v (0 past k) and position li R + q's row in byte q mod
// 4 of rb_s[(q / 4) 256 + threadIdx.x], this thread's words of the row
// strip (in registers, the rows spilled the n loop's IRLS).
template <int R, int LANES>
__device__ __forceinline__ void sort_coarse(float (&v)[R], float* xs_s,
                                            uint32_t* rb_s, const Params& p,
                                            bool mine, int base, int slot,
                                            int lane, int li) {
  constexpr int W = kGroupThreads / LANES;
  constexpr uint32_t B = R * LANES;
  uint32_t ck[R];
  uint32_t lo = 0xffffffffu, hi = 0u;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (mine) xs_s[base + q * W] = v[q];  // row_at(q LANES + li, slot)
    ck[q] = mm::sort_key(v[q]);
    if (q * LANES + li < p.k) {
      lo = min(lo, ck[q]);
      hi = max(hi, ck[q]);
    }
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, off));
    hi = max(hi, __shfl_xor_sync(kFull, hi, off));
  }
  lo &= ~(B - 1);
  const int sh = min(31, __clz(hi - lo));
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = q * LANES + li;
    ck[q] = r < p.k ? (((ck[q] - lo) << sh) & ~(B - 1)) | (uint32_t)r
                    : 0xffffffffu;
  }
  __syncwarp();  // the copy is whole before any lane gathers from it
  warp_sort<R, LANES>(ck, lane);
  bool bad = false;
  uint32_t first = 0, last = 0, packed = 0;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const bool valid = li * R + q < p.k;
    const uint32_t r = ck[q] & (B - 1);
    v[q] = valid ? xs_s[row_at<R, LANES>(r, slot)] : 0.0f;
    packed |= r << (8 * (q % 4));
    if (q % 4 == 3) {
      rb_s[(q / 4) * kGroupThreads + threadIdx.x] = packed;
      packed = 0;
    }
    const uint32_t key = mm::sort_key(v[q]);
    if (q == 0) first = key;
    else if (valid) bad |= last > key;
    last = key;
  }
  if constexpr (LANES > 1) {  // against the last key of the lane before
    const uint32_t before = __shfl_up_sync(kFull, last, 1);
    if (li > 0 && li * R < p.k) bad |= before > first;
  }
  if (__any_sync(kFull, mine && bad)) {
    if (lane == 0) atomicAdd(&exact_tiles, 1ull);
    uint64_t s[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = q * LANES + li;
      s[q] = r < p.k ? ((uint64_t)mm::sort_key(xs_s[base + q * W]) << 32) |
                           (uint32_t)r
                     : ~0ull;  // sentinel: after every row, NaN included
    }
    warp_sort<R, LANES>(s, lane);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      v[q] = li * R + q < p.k ? key_value((uint32_t)(s[q] >> 32)) : 0.0f;
      packed |= ((uint32_t)s[q] & (B - 1)) << (8 * (q % 4));
      if (q % 4 == 3) {
        rb_s[(q / 4) * kGroupThreads + threadIdx.x] = packed;
        packed = 0;
      }
    }
  }
  __syncwarp();  // every gather from the copy is done before it is rewritten
}

// Rank median of |x - med| over the k sorted values of the column in
// slot c.  They fall over the positions [0, s) whose values are <= med
// and rise over [s, k), so with A_i = |x[s - 1 - i] - med| and B_j =
// |x[s + j] - med| (both ascending) the r + 1 smallest are A_[0, i) and
// B_[0, r + 1 - i) for the least i with A_i >= B_(r - i): a binary
// search.  The rank-(k - 1) / 2 and rank-k / 2 values are then the larger
// of the last ones taken and (k even) the smaller of the next ones.
template <int R, int LANES>
__device__ __forceinline__ float mad_select(const float* xs_s, int k,
                                            float med, int c) {
  auto xv = [&](int e) { return xs_s[strip_at<R, LANES>(e, c)]; };
  int lo = 0, hi = k;
  while (lo < hi) {  // s: the values <= med
    const int mid = (lo + hi) >> 1;
    if (xv(mid) <= med) lo = mid + 1;
    else hi = mid;
  }
  const int s = lo, r = (k - 1) / 2;
  lo = max(0, r + 1 - (k - s));
  hi = min(r + 1, s);
  while (lo < hi) {
    const int i = (lo + hi) >> 1;
    if (fabsf(xv(s - 1 - i) - med) >= fabsf(xv(s + r - i) - med)) hi = i;
    else lo = i + 1;
  }
  const int i = lo, j = r + 1 - i;
  const float inf = __int_as_float(0x7f800000);
  const float d_lo = fmaxf(i > 0 ? fabsf(xv(s - i) - med) : -inf,
                           j > 0 ? fabsf(xv(s + j - 1) - med) : -inf);
  if (k & 1) return 0.5f * (d_lo + d_lo);
  const float d_hi = fminf(i < s ? fabsf(xv(s - 1 - i) - med) : inf,
                           j < k - s ? fabsf(xv(s + j) - med) : inf);
  return 0.5f * (d_lo + d_hi);
}

// The sorted position (li R + q) of a group of LANES lanes whose
// cumulative weight reaches half the group's mass while the one before is
// below it (the last such; -1: none), the mass and cumulative sums taken
// position by position in f32 from position 0: lane li adds its R weights
// to lane li - 1's sum, one lane at a time.  Every lane of the group
// returns the same position.
template <int R, int LANES>
__device__ __forceinline__ int group_crossing(const float (&wv)[R],
                                              int lane) {
  const int li = lane & (LANES - 1), base = lane - li;
  float carry = 0.0f, cin = 0.0f;
#pragma unroll
  for (int s = 0; s < LANES; ++s) {
    float cw = carry;
    if (li == s) {
      cin = cw;
#pragma unroll
      for (int q = 0; q < R; ++q) cw += wv[q];
    }
    carry = LANES == 1 ? cw : __shfl_sync(kFull, cw, base + s);
  }
  const float half = 0.5f * carry;
  float cw = cin;
  int hit = -1;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const float prev = cw;
    cw += wv[q];
    if (cw >= half && prev < half) hit = li * R + q;
  }
  if (LANES == 1) return hit;
  const unsigned mask = (unsigned)(((1ull << LANES) - 1) << base);
  const unsigned found = __ballot_sync(kFull, hit >= 0) & mask;
  // every lane shuffles (a full-mask shuffle in a divergent branch would
  // make the compiler serialise the warp's collectives)
  const int last = __shfl_sync(kFull, hit, found ? 31 - __clz(found) : lane);
  return found ? last : -1;
}

// The column's rows q LANES + li of one tile into v (0 past row k or the
// last column), read through the table copy where the launch has one (a
// weighted instantiation, TABLE, only), else at x + r * ld.
template <int R, int LANES, bool TABLE, typename T>
__device__ __forceinline__ void load_group(float (&v)[R],
                                           const T* __restrict__ x,
                                           const Params& p,
                                           unsigned char* smem, bool real,
                                           int64_t mc, int li) {
  if constexpr (TABLE) {
    if (p.rows) {
      const mm::RowBases<T> bases = row_bases<T>(p, smem);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = q * LANES + li;
        v[q] = real && r < p.k ? mm::to_f32(bases[r][mc]) : 0.0f;
      }
      return;
    }
  }
  const T* xc = x + (real ? mc : 0);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = q * LANES + li;
    v[q] = real && r < p.k ? mm::to_f32(xc[(int64_t)r * p.ld]) : 0.0f;
  }
}

template <int R, int LANES, bool WEIGHTED, typename T>
__device__ __forceinline__ void group_columns(const T* __restrict__ x,
                                              const float* __restrict__ a,
                                              T* __restrict__ out,
                                              const Params& p,
                                              unsigned char* smem) {
  constexpr int W = kGroupThreads / LANES;  // a strip row's entries
  const int cols = p.cols, k_pad = p.bk;
  float* ws = reinterpret_cast<float*>(smem);                   // (nc, k_pad)
  float* ms = ws + (size_t)p.nc * k_pad;                        // (nc)
  float* xs_s = ms + p.nc;                                      // (R LANES, W)
  uint16_t* rw_s = reinterpret_cast<uint16_t*>(xs_s + R * LANES * W);
  uint32_t* rb_s = reinterpret_cast<uint32_t*>(rw_s);  // R = 16: 4 a thread

  const int lane = threadIdx.x & 31, li = lane & (LANES - 1);
  const int col = threadIdx.x / LANES;  // this group's column of the tile
  const bool mine = col < cols;         // groups past the tile hold none
  const int slot = col & (cols - 1);
  // this lane's run of the strips: positions li R + q at base + q W
  const int base = strip_at<R, LANES>(li * R, slot);
  const int64_t tiles = (p.m + cols - 1) / cols;
  int64_t t = blockIdx.x;
  if (t >= tiles) return;  // the whole block leaves together
  if (WEIGHTED && p.rows) stage_rows<T>(p, smem);
  const bool staged_once = p.nc >= p.n;
  if (staged_once) {
    stage_weights(ws, ms, a, p, 0);
    __syncthreads();
  }

  for (; t < tiles; t += gridDim.x) {
    const int64_t mc = t * cols + col;
    const bool real = mine && mc < p.m;
    // ---- the column's rows q LANES + li, sorted by the group ----
    float v[R];  // unweighted: the rows as loaded; weighted: then sorted
    load_group<R, LANES, WEIGHTED>(v, x, p, smem, real, mc, li);
    __syncwarp();  // the last tile's readers of the strips are done
    if constexpr (WEIGHTED && R == 16) {
      sort_coarse<R, LANES>(v, xs_s, rb_s, p, mine, base, slot, lane, li);
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (mine && li * R + q < p.k) xs_s[base + q * W] = v[q];
    } else if constexpr (WEIGHTED) {
      uint64_t s[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = q * LANES + li;
        s[q] = r < p.k ? ((uint64_t)mm::sort_key(v[q]) << 32) | (uint32_t)r
                       : ~0ull;  // sentinel: after every row, NaN included
      }
      warp_sort<R, LANES>(s, lane);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const bool valid = li * R + q < p.k;
        v[q] = valid ? key_value((uint32_t)(s[q] >> 32)) : 0.0f;
        if (mine && valid) {
          xs_s[base + q * W] = v[q];
          rw_s[base + q * W] = (uint16_t)s[q];
        }
      }
    } else {
      uint32_t s[R];
#pragma unroll
      for (int q = 0; q < R; ++q)
        s[q] = q * LANES + li < p.k ? mm::sort_key(v[q]) : 0xffffffffu;
      warp_sort<R, LANES>(s, lane);
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (mine && li * R + q < p.k) xs_s[base + q * W] = key_value(s[q]);
    }
    __syncwarp();  // the group's strip is whole before its lanes read it

    // ---- per weight column: median, MAD and IRLS in the group ----
    for (int n0 = 0; n0 < p.n; n0 += p.nc) {
      if (!staged_once) {
        __syncthreads();  // the previous chunk's readers are done
        stage_weights(ws, ms, a, p, n0);
        __syncthreads();
      }
      const int nc = min(p.nc, p.n - n0);
      for (int nl = 0; nl < nc; ++nl) {
        const float* wn = ws + (size_t)nl * k_pad;
        float wv[R];  // weighted: the sorted positions'; else the rows'
#pragma unroll
        for (int q = 0; q < R; ++q) {
          if constexpr (WEIGHTED && R == 16)
            wv[q] = li * R + q < p.k
                        ? wn[(rb_s[(q / 4) * kGroupThreads + threadIdx.x] >>
                              (8 * (q % 4))) & 0xffu]
                        : 0.0f;
          else if constexpr (WEIGHTED)
            wv[q] = li * R + q < p.k ? wn[rw_s[base + q * W]] : 0.0f;
          else
            wv[q] = q * LANES + li < p.k ? wn[q * LANES + li] : 0.0f;
        }
        float med;
        if (WEIGHTED) {
          const int hit = group_crossing<R, LANES>(wv, lane);
          med = hit < 0 ? 0.0f : xs_s[strip_at<R, LANES>(hit, slot)];
        } else {
          med = 0.5f * (xs_s[strip_at<R, LANES>((p.k - 1) / 2, slot)] +
                        xs_s[strip_at<R, LANES>(p.k / 2, slot)]);
        }
        // the combine of one K block: its statistics where its mass
        // reaches half the total
        const float mass = ms[nl], half = 0.5f * mass;
        const bool crosses = mass >= half && 0.0f < half;
        const float mu0 = crosses ? med : 0.0f;
        const float mad =
            crosses ? mad_select<R, LANES>(xs_s, p.k, med, slot) : 0.0f;
        const float scale = fmaxf(mm::kMadConsistency * mad, mm::kScaleFloor);
        const float inv = 1.0f / (p.c * scale);
        float mu = mu0;
        for (int it = 0; it < p.num_iters; ++it) {
          float num = 0.0f, den = 0.0f;
#pragma unroll
          for (int q = 0; q < R; ++q)
            mm::tukey_accumulate(v[q], wv[q], mu, inv, num, den);
#pragma unroll
          for (int off = LANES / 2; off > 0; off >>= 1) {
            num += __shfl_xor_sync(kFull, num, off);
            den += __shfl_xor_sync(kFull, den, off);
          }
          mu = mm::irls_update(num, den, mu);
        }
        if (li == 0 && real)
          out[(int64_t)(n0 + nl) * p.m + mc] = mm::from_f32<T>(mu);
      }
    }
  }
}

// Blocks an SM must hold: three for group-layout blocks of 16 rows a lane
// (85 registers), two for those of 32 (128 registers fit their sorts)
// but the weighted 512-row ones and for the unweighted 512-row warp
// blocks, else one, so that no instantiation spills to local memory.
template <int RPL, bool WEIGHTED, int LANES>
constexpr int min_blocks() {
  if (LANES < 32) return RPL == 16 ? 3 : WEIGHTED && LANES == 16 ? 1 : 2;
  return !WEIGHTED && RPL == 16 ? 2 : 1;
}

template <int LANES>
constexpr int max_threads() { return LANES < 32 ? kGroupThreads : kMaxThreads; }

template <int RPL, bool WEIGHTED, typename T, int LANES>
__global__ void __launch_bounds__((max_threads<LANES>()),
                                  (min_blocks<RPL, WEIGHTED, LANES>()))
mm_two_pass(const T* __restrict__ x, const float* __restrict__ a,
            T* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (LANES == 32)
    warp_columns<RPL, WEIGHTED>(x, a, out, p, smem);
  else
    group_columns<RPL, LANES, WEIGHTED>(x, a, out, p, smem);
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
template <int RPL, bool WEIGHTED, typename T, int LANES>
cudaError_t resident_blocks(int threads, size_t smem, Occupancy* found) {
  static Occupancy cached[kMaxDevices];
  auto kern = mm_two_pass<RPL, WEIGHTED, T, LANES>;
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

// One launch: min(column tiles, blocks the card holds at once) blocks
// walk the tiles grid-stride, each `cols` columns over 32 cols threads
// (warp layout) or max(32, cols LANES) (group layout).  With no resident
// block (per_sm 0) it fails rather than launch a grid that cannot run.
template <int RPL, bool WEIGHTED, typename T, int LANES>
int launch(const void* x, const float* a, void* out, const Params& p,
           size_t smem, cudaStream_t stream, const Report& report) {
  if (p.rows && !WEIGHTED) return (int)cudaErrorNotSupported;  // header
  const int threads = LANES == 32 ? 32 * p.cols : max(32, p.cols * LANES);
  Occupancy occ;
  cudaError_t err =
      resident_blocks<RPL, WEIGHTED, T, LANES>(threads, smem, &occ);
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
             "mm_two_pass<%d, %s, %s, %d>", RPL, WEIGHTED ? "true" : "false",
             mm::type_name<T>(), LANES);
    return mm::report(report.query, blocks, threads, smem, occ.per_sm,
                      occ.sms);
  }
  if (blocks < 1) return (int)cudaErrorLaunchOutOfResources;
  mm_two_pass<RPL, WEIGHTED, T, LANES>
      <<<(unsigned)blocks, threads, smem, stream>>>(
          static_cast<const T*>(x), a, static_cast<T*>(out), p);
  return (int)cudaGetLastError();
}

// One launch of the group layout for a K block of BK rows.
template <int BK, bool WEIGHTED, typename T>
int launch_group(const void* x, const float* a, void* out, const Params& p,
                 size_t smem, cudaStream_t s, const Report& r) {
  return launch<group_rows(BK), WEIGHTED, T, group_lanes(BK)>(x, a, out, p,
                                                              smem, s, r);
}

template <bool WEIGHTED, typename T>
int launch_rows(const void* x, const float* a, void* out, const Params& p,
                size_t smem, cudaStream_t s, const Report& r) {
  if (p.kb == 1) {  // the group layout
    if (p.bk <= 16) return launch_group<16, WEIGHTED, T>(x, a, out, p, smem, s, r);
    if (p.bk == 32) return launch_group<32, WEIGHTED, T>(x, a, out, p, smem, s, r);
    if (p.bk == 64) return launch_group<64, WEIGHTED, T>(x, a, out, p, smem, s, r);
    if (p.bk == 128) return launch_group<128, WEIGHTED, T>(x, a, out, p, smem, s, r);
    if (p.bk == 256) return launch_group<256, WEIGHTED, T>(x, a, out, p, smem, s, r);
    if (p.bk == 512) return launch_group<512, WEIGHTED, T>(x, a, out, p, smem, s, r);
    return (int)cudaErrorInvalidValue;
  }
  if (p.bk <= 32) return launch<1, WEIGHTED, T, 32>(x, a, out, p, smem, s, r);
  if (p.bk == 64) return launch<2, WEIGHTED, T, 32>(x, a, out, p, smem, s, r);
  if (p.bk == 128) return launch<4, WEIGHTED, T, 32>(x, a, out, p, smem, s, r);
  if (p.bk == 256) return launch<8, WEIGHTED, T, 32>(x, a, out, p, smem, s, r);
  if (p.bk == 512) return launch<16, WEIGHTED, T, 32>(x, a, out, p, smem, s, r);
  return (int)cudaErrorInvalidValue;
}

// The group layout's copy of a table launch's table lies past its own
// slots, on a 16-byte boundary.
size_t table_at(size_t own) { return (own + 15) & ~(size_t)15; }

size_t smem_bytes(int k, int nc, int bk, int cols, bool table) {
  const size_t kb = (size_t)((k + bk - 1) / bk), k_pad = kb * bk;
  if (kb == 1) {  // group layout: (nc, bk) slice, nc masses, the (R
                  // LANES, 256 / LANES) value and row strips
    const size_t strip = (size_t)group_rows(bk) * kGroupThreads;
    const size_t own = sizeof(float) * ((size_t)nc * k_pad + nc + strip) +
                       sizeof(uint16_t) * strip;
    return table ? table_at(own) + sizeof(void*) * k : own;
  }
  const size_t strip = kb > kRegCombine ? (size_t)next_pow2((int)kb) : 0;
  return sizeof(uint64_t) * cols * strip +
         sizeof(float) * (k_pad * cols + (size_t)nc * k_pad +
                          2 * kb * cols + kb * (size_t)nc) +
         sizeof(uint16_t) * k_pad * cols;
}

// Checks the launch arguments and runs (report empty) or reports one
// launch.
int dispatch(const void* x, const void* rows, int dtype, int64_t ld, int k,
             int64_t m, const void* a, int n, void* out, int bk, int nc,
             int cols, int num_iters, float c, int weighted, void* stream,
             const Report& report) {
  if (k < 1 || n < 1 || m < 1 || bk < 2 || bk > 32 * kMaxRowsPerLane ||
      (bk & (bk - 1)) || nc < 1 || nc > n || cols < 1 || (cols & (cols - 1)))
    return (int)cudaErrorInvalidValue;
  const int kb = (k + bk - 1) / bk;
  if (cols > (kb == 1 ? kGroupThreads / group_lanes(bk) : kMaxCols))
    return (int)cudaErrorInvalidValue;
  const size_t own = smem_bytes(k, nc, bk, cols, false);
  const Params p{ld, m, k, n, bk, kb, nc, cols, ilog2(cols), num_iters, c,
                 rows, (int64_t)table_at(own)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const size_t smem = smem_bytes(k, nc, bk, cols, rows != nullptr);
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
// number (mm_aggregate.two_pass_smem_bytes).  One K block (group layout):
// the (nc, bk) weight slice, nc masses and the (R, cols) f32 values and
// uint16 rows of the sorted columns, R = max(32, bk).
// Several: above 32 K blocks each warp's strip of next_pow2(KB) (value,
// block) pairs for the combine, the (K_pad, cols) f32 tile, the (nc,
// K_pad) weight slice, (2 KB, cols) block stats, the (KB, nc) block
// masses and the (K_pad, cols) uint16 row index of the sorted blocks.
// table: a launch with a device table of row addresses, for which the
// group layout carves 8 k bytes more, past its own on a 16-byte boundary.
size_t mm_two_pass_smem_bytes(int k, int nc, int bk, int cols, int table) {
  return smem_bytes(k, nc, bk, cols, table != 0);
}

// x: (k, m) row-major with row stride ld, f32 (dtype 0) or bf16 (dtype 1);
// rows: null, or a device table of k addresses of contiguous rows of m
// elements of that dtype, read in place of x (x and ld are then unused;
// with one K block the block carves 8 k bytes of shared memory more for
// its copy, as mm_two_pass_smem_bytes counts; weighted launches only,
// else cudaErrorNotSupported);
// a: (k, n) f32 normalised weight columns; out: (n, m) in x's dtype;
// bk: the K block, a power of two <= 512 (any number of blocks); nc:
// weight columns per chunk; cols: columns per block, a power of two, at
// most 8 with several K blocks and 256 / max(1, bk / 32) with one; c:
// Tukey's constant.  One launch; returns its cudaError_t.
int mm_two_pass_launch(const void* x, const void* rows, int dtype,
                       int64_t ld, int k, int64_t m, const void* a, int n,
                       void* out, int bk, int nc, int cols, int num_iters,
                       float c, int weighted, void* stream) {
  return dispatch(x, rows, dtype, ld, k, m, a, n, out, bk, nc, cols,
                  num_iters, c, weighted, stream, Report{nullptr, nullptr});
}

// The blocks mm_two_pass_launch would launch for these arguments on the
// current device (min(column tiles, blocks the card holds at once)), in
// *blocks; launches nothing.  Returns a cudaError_t.
int mm_two_pass_blocks(int dtype, int k, int64_t m, int n, int bk, int nc,
                       int cols, int weighted, int64_t* blocks) {
  if (blocks == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(nullptr, nullptr, dtype, m, k, m, nullptr, n, nullptr, bk,
                  nc, cols, 0, 1.0f, weighted, nullptr,
                  Report{nullptr, blocks});
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
  const int err = dispatch(nullptr, nullptr, dtype, m, k, m, nullptr, n,
                           nullptr, bk, nc, cols, 0, 1.0f, weighted, nullptr,
                           Report{&q, nullptr});
  out[0] = q.blocks;
  out[1] = q.threads;
  out[2] = q.smem;
  out[3] = q.per_sm;
  out[4] = q.sms;
  return err;
}

// The warp-tiles of weighted one-K-block launches of 16 rows a lane (K
// blocks of at most 128 rows) that took the exact (key, row) sort on the
// current device since the last call, in *tiles; the count is then reset.
// Copies through the legacy default stream, so it waits for the launches
// before it.  Returns a cudaError_t.
int mm_two_pass_exact_tiles(int64_t* tiles) {
  if (tiles == nullptr) return (int)cudaErrorInvalidValue;
  unsigned long long n = 0;
  const unsigned long long zero = 0;
  cudaError_t err = cudaMemcpyFromSymbol(&n, exact_tiles, sizeof(n));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(exact_tiles, &zero, sizeof(zero));
  *tiles = (int64_t)n;
  return (int)err;
}

}  // extern "C"
