"""The two-pass kernel's arithmetic, transcribed to numpy f32 and held to
the plain version (CPU).

``csrc/mm_two_pass.cu`` has two layouts.  With several K blocks one warp
owns one column: lane l holds the rows q * 32 + l of each K block (q <
RPL = bk / 32), a warp bitonic network sorts them into positions e = l *
RPL + q, the weighted crossing sums weights position by position, the
MAD merges |x - med| with one bitonic merge, the combine sorts (value,
block) pairs (one a lane for KB <= 32, else in a shared-memory strip),
and IRLS runs in reciprocal form with each lane's partial sums reduced
by a butterfly.  With one K block a group of L lanes owns a column, R =
16 rows a lane up to bk = 128 and 32 above (L = max(1, bk / R)): lane li
holds rows q * L + li (q < R), the group's network sorts them into
positions e = li * R + q (weighted, R = 16: on 32-bit coarse keys that
carry the row, checked, and on (key, row) pairs where the check fails;
R = 32: on the pairs), the group sums the
weights in sorted order lane after lane (the half mass), then each lane
again from its carry-in to find the crossing, selects the MAD from the
two sorted runs of |x - med| by a binary search, and IRLS sums each
lane's R rows (weighted: the sorted positions; unweighted: the rows as
loaded) before log2(L) butterfly steps.  No CUDA compiler runs here, so the networks below follow the
kernel's ``warp_flip``, ``warp_stage`` and ``combine`` stage for stage
(partners, in-lane and cross-lane, directions): these tests check its
schedule as well as the rounding of its arithmetic, within the tolerance
the card's parity uses, 1e-5 x max(1, |x|_inf).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import mestimators
from repro_torch.kernels import mm_aggregate as TK

F32 = np.float32
REG_COMBINE = 32


def ilog2(p):
    return p.bit_length() - 1


def warp_stage(v, t):
    """Ascending stage at distance 2^t; v: (M, lanes, RPL), element
    e = lane * RPL + q (the kernel's layout; a warp, or a group of lanes
    of the group layout)."""
    rpl = v.shape[2]
    logr = ilog2(rpl)
    lane = np.arange(v.shape[1])
    v = v.copy()
    if t >= logr:
        lm = 1 << (t - logr)
        other = v[:, lane ^ lm, :]
        lower = ((lane & lm) == 0)[None, :, None]
        return np.where(lower, np.minimum(v, other), np.maximum(v, other))
    for i in range(rpl):
        j = i ^ (1 << t)
        if j > i:
            lo = np.minimum(v[:, :, i], v[:, :, j])
            hi = np.maximum(v[:, :, i], v[:, :, j])
            v[:, :, i], v[:, :, j] = lo, hi
    return v


def warp_flip(v, s):
    """Merge level s's first stage: e against e ^ (2^s - 1)."""
    rpl = v.shape[2]
    logr = ilog2(rpl)
    lane = np.arange(v.shape[1])
    v = v.copy()
    if s <= logr:
        for i in range(rpl):
            j = i ^ ((1 << s) - 1)
            if j > i:
                lo = np.minimum(v[:, :, i], v[:, :, j])
                hi = np.maximum(v[:, :, i], v[:, :, j])
                v[:, :, i], v[:, :, j] = lo, hi
        return v
    lm = (1 << (s - logr)) - 1
    lower = ((lane & (1 << (s - logr - 1))) == 0)[None, :, None]
    other = v[:, lane ^ lm, ::-1]          # the partner's v[RPL - 1 - q]
    return np.where(lower, np.minimum(v, other), np.maximum(v, other))


def warp_sort(v):
    log = ilog2(v.shape[2]) + ilog2(v.shape[1])
    for s in range(1, log + 1):
        v = warp_flip(v, s)
        for t in range(s - 2, -1, -1):
            v = warp_stage(v, t)
    return v


def warp_merge(v):
    log = ilog2(v.shape[2]) + 5
    for t in range(log - 1, -1, -1):
        v = warp_stage(v, t)
    return v


def strip_sort(s):
    """The combine's shared-memory network over a strip of P pairs,
    (M, P): the standard bitonic schedule, direction by bit ``size`` of
    the lower index."""
    s = s.copy()
    p = s.shape[1]
    size = 2
    while size <= p:
        j = size // 2
        while j > 0:
            for i in range(p):
                o = i ^ j
                if o > i:
                    a, b = s[:, i].copy(), s[:, o].copy()
                    up = (i & size) == 0
                    swap = (b < a) == up
                    s[:, i] = np.where(swap, b, a)
                    s[:, o] = np.where(swap, a, b)
            j //= 2
        size *= 2
    return s


def sort_key(x):
    b = x.astype(F32).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def key_value(key):
    key = key.astype(np.uint32)
    return np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key).astype(
        np.uint32).view(F32)


def positions(v):
    """(M, 32, RPL) lane-major -> (M, 32 RPL) in position order."""
    return v.reshape(v.shape[0], -1)


def middle(p, cnt):
    return F32(0.5) * (p[:, (cnt - 1) // 2] + p[:, cnt // 2])


def fma(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def next_pow2(n):
    p = 2
    while p < n:
        p *= 2
    return p


def combine(stats, mass, half):
    """stats (KB, M), mass (KB,): the kernel's mass-weighted median of
    block statistics (its ``combine``), with the kernel's network."""
    kb, m = stats.shape
    if kb == 1:
        return np.where((mass[0] >= half) & (F32(0) < half), stats[0],
                        F32(0)).astype(F32)
    pairs = (sort_key(stats).astype(np.uint64) << np.uint64(32)) | \
        np.arange(kb, dtype=np.uint64)[:, None]                   # (KB, M)
    if kb <= REG_COMBINE:
        lanes = np.full((m, 32, 1), ~np.uint64(0))
        lanes[:, :kb, 0] = pairs.T
        ordered = positions(warp_sort(lanes))[:, :kb]
    else:
        strip = np.full((m, next_pow2(kb)), ~np.uint64(0))
        strip[:, :kb] = pairs.T
        ordered = strip_sort(strip)[:, :kb]
    cw = np.zeros(m, F32)
    out = np.zeros(m, F32)
    found = np.zeros(m, bool)
    for j in range(kb):
        b = (ordered[:, j] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        prev = cw
        cw = (cw + mass[b]).astype(F32)
        sel = ~found & (cw >= half) & (prev < half)
        out = np.where(sel, key_value(ordered[:, j] >> np.uint64(32)), out)
        found |= sel
    return out


def warp_two_pass(x, a, *, block_k, weighted, num_iters=10,
                  c=mestimators.TUKEY_C95):
    """The kernel's estimate for x (K, M) and normalized a (K, N)."""
    k, m = x.shape
    n = a.shape[1]
    bk = block_k
    rpl = max(1, bk // 32)
    kb = -(-k // bk)
    k_pad = kb * bk
    lane = np.arange(32)
    ap = np.zeros((k_pad, n), F32)
    ap[:k] = a
    mass = np.zeros((kb, n), F32)      # row order, f32, from the slice
    for b in range(kb):
        for r in range(b * bk, (b + 1) * bk):
            mass[b] = (mass[b] + ap[r]).astype(F32)
    blocks = []
    for b in range(kb):
        r0, cnt = b * bk, min(k - b * bk, bk)
        slot = np.arange(rpl)[None, :] * 32 + lane[:, None]      # (32, RPL)
        valid = slot < cnt
        rows = np.where(valid, r0 + slot, 0)
        v = np.where(valid[None], x[rows.T].transpose(2, 1, 0), F32(0))
        pos_valid = (lane[:, None] * rpl + np.arange(rpl)[None]) < cnt
        if weighted:
            keys = np.where(valid[None], (sort_key(v).astype(np.uint64)
                                          << np.uint64(32))
                            | slot.astype(np.uint64)[None], ~np.uint64(0))
            keys = warp_sort(keys)
            xs = np.where(pos_valid[None],
                          key_value(keys >> np.uint64(32)), F32(0))
            rw = np.where(pos_valid[None],
                          (keys & np.uint64(0xFFFFFFFF)).astype(np.int64), 0)
        else:
            keys = np.where(valid[None], sort_key(v), np.uint32(0xFFFFFFFF))
            keys = warp_sort(keys)
            xs = np.where(pos_valid[None], key_value(keys), F32(0))
            rw = None
        blocks.append((r0, cnt, v, valid, xs, rw, pos_valid))

    def block_stats(blk, wcol):
        r0, cnt, v, valid, xs, rw, pos_valid = blk
        if weighted:
            ws = np.where(pos_valid[None], wcol[r0 + rw], F32(0))
            cw = np.zeros(xs.shape[0], F32)
            pre = np.zeros(xs.shape[:1] + (32 * rpl,), F32)
            for e, w in enumerate(positions(ws).T):
                cw = (cw + w).astype(F32)
                pre[:, e] = cw
            half = F32(0.5) * cw
            prev = np.concatenate([np.zeros((xs.shape[0], 1), F32),
                                   pre[:, :-1]], 1)
            sel = (pre >= half[:, None]) & (prev < half[:, None])
            med = np.where(sel.any(1), positions(xs)[np.arange(xs.shape[0]),
                                                     sel.argmax(1)], F32(0))
        else:
            med = middle(positions(xs), cnt)
        d = np.where(pos_valid[None], np.abs(xs - med[:, None, None]),
                     F32(np.inf))
        return med.astype(F32), middle(positions(warp_merge(d)), cnt)

    out = np.zeros((n, m), F32)
    for nn in range(n):
        wcol = ap[:, nn]
        stats = [block_stats(blk, wcol) for blk in blocks]
        tot = F32(0)
        for b in range(kb):
            tot = F32(tot + mass[b, nn])
        half = F32(0.5) * tot
        mu = combine(np.stack([s[0] for s in stats]), mass[:, nn], half)
        mad = combine(np.stack([s[1] for s in stats]), mass[:, nn], half)
        scale = np.maximum(F32(TK._MAD_CONSISTENCY) * mad, F32(1e-12))
        inv = (F32(1) / (F32(c) * scale)).astype(F32)
        for _ in range(num_iters):
            num = np.zeros((m, 32), F32)
            den = np.zeros((m, 32), F32)
            for blk in blocks:
                r0, cnt, v, valid, xs, rw, pos_valid = blk
                for q in range(rpl):
                    if weighted:
                        xv = xs[:, :, q]
                        av = np.where(pos_valid[:, q], wcol[r0 + rw[:, :, q]],
                                      F32(0))
                    else:
                        xv = v[:, :, q]
                        av = np.where(valid[:, q],
                                      wcol[np.where(valid[:, q],
                                                    r0 + q * 32 + lane, 0)],
                                      F32(0))
                    y = ((xv - mu[:, None]) * inv[:, None]).astype(F32)
                    u = np.clip(fma(-y, y, F32(1)), 0, 1)
                    w = (av * (u * u)).astype(F32)
                    num = fma(w, xv, num)
                    den = (den + w).astype(F32)
            for off in (16, 8, 4, 2, 1):
                num = (num + num[:, lane ^ off]).astype(F32)
                den = (den + den[:, lane ^ off]).astype(F32)
            num, den = num[:, 0], den[:, 0]
            safe = den > F32(1e-12)
            mu = np.where(safe, num / np.where(safe, den, F32(1)),
                          mu).astype(F32)
        out[nn] = mu
    return out


def mad_select(xs, med):
    """The kernel's MAD by selection: xs (M, k) sorted, med (M,).  The
    split s (values <= med) by binary search, then the binary search for
    how many of the r + 1 smallest |x - med| the falling run A gives."""
    m, k = xs.shape
    cols = np.arange(m)

    def xv(e):
        return xs[cols, np.clip(e, 0, k - 1)]

    lo, hi = np.zeros(m, np.int64), np.full(m, k, np.int64)
    while (lo < hi).any():
        act, mid = lo < hi, (lo + hi) >> 1
        le = xv(mid) <= med
        lo, hi = np.where(act & le, mid + 1, lo), np.where(act & ~le, mid, hi)
    s, r = lo, (k - 1) // 2
    lo, hi = np.maximum(0, r + 1 - (k - s)), np.minimum(r + 1, s)
    while (lo < hi).any():
        act, i = lo < hi, (lo + hi) >> 1
        ge = np.abs(xv(s - 1 - i) - med) >= np.abs(xv(s + r - i) - med)
        lo, hi = np.where(act & ~ge, i + 1, lo), np.where(act & ge, i, hi)
    i, j = lo, r + 1 - lo
    inf = F32(np.inf)
    d_lo = np.maximum(np.where(i > 0, np.abs(xv(s - i) - med), -inf),
                      np.where(j > 0, np.abs(xv(s + j - 1) - med), -inf))
    if k % 2:
        return F32(0.5) * (d_lo + d_lo)
    d_hi = np.minimum(np.where(i < s, np.abs(xv(s - 1 - i) - med), inf),
                      np.where(j < k - s, np.abs(xv(s + j) - med), inf))
    return (F32(0.5) * (d_lo + d_hi)).astype(F32)


def group_slots(lanes, rows):
    """(L, R): the row lane li holds at q, q L + li."""
    return np.arange(rows)[None, :] * lanes + np.arange(lanes)[:, None]


def group_positions(lanes, rows):
    """(L, R): the sorted position lane li holds at q, li R + q."""
    return np.arange(lanes)[:, None] * rows + np.arange(rows)[None, :]


def load_group(x, block_k):
    """x (K, M) as the group layout loads it: (M, L, R), row q L + li of
    each column at [:, li, q], 0 past row K."""
    k = x.shape[0]
    rows, lanes = TK.two_pass_rows(block_k), TK.two_pass_lanes(block_k)
    slot = group_slots(lanes, rows)
    return np.where((slot < k)[None],
                    np.moveaxis(x[np.where(slot < k, slot, 0)], 2, 0),
                    F32(0))


def pair_sort(v, k):
    """A weighted group's (key, row) network on 64-bit pairs: (M, L, R)
    rows as loaded -> the sorted values and their rows (0 past k)."""
    lanes, rows = v.shape[1:]
    slot = group_slots(lanes, rows)
    keys = np.where((slot < k)[None], (sort_key(v).astype(np.uint64)
                                       << np.uint64(32))
                    | slot.astype(np.uint64)[None], ~np.uint64(0))
    keys = warp_sort(keys)
    pos_valid = (group_positions(lanes, rows) < k)[None]
    return (np.where(pos_valid, key_value(keys >> np.uint64(32)), F32(0)),
            np.where(pos_valid,
                     (keys & np.uint64(0xFFFFFFFF)).astype(np.int64), 0))


def clz32(x):
    """Leading zero bits of uint32 values (32 for 0)."""
    x = x.astype(np.uint64)
    return 32 - sum(((x >> np.uint64(j)) > 0).astype(np.int64)
                    for j in range(32))


def coarse_parts(v, k):
    """The kernel's ``sort_coarse`` up to its branch, for (M, L, R) rows as
    loaded: each row's 32-bit coarse key (its sort_key less the column's
    least, that aligned down to a multiple of B, shifted left by the
    leading zeros of the range, its low log2(B) bits replaced by the row;
    0xffffffff past k), sorted by the group's network; each position's
    row read from the low bits and its value gathered by row; and, per
    column, whether the check fails: a valid position's full key below
    the one before it, in a lane or (by the shuffle) across the boundary
    from lane li - 1 to li.  Returns (values, rows, fails), values and
    rows 0 past k."""
    m, lanes, rows = v.shape
    b = lanes * rows
    slot = group_slots(lanes, rows)
    valid = (slot < k)[None]
    key = sort_key(v)
    lo = np.where(valid, key, np.uint32(0xFFFFFFFF)).min((1, 2)) \
        & np.uint32(2 ** 32 - b)
    hi = np.where(valid, key, np.uint32(0)).max((1, 2))
    sh = np.minimum(31, clz32(hi - lo)).astype(np.uint64)
    rel = (((key - lo[:, None, None]).astype(np.uint64) << sh[:, None, None])
           & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    ck = np.where(valid, (rel & np.uint32(2 ** 32 - b))
                  | slot.astype(np.uint32)[None], np.uint32(0xFFFFFFFF))
    ck = warp_sort(ck)
    pos_valid = (group_positions(lanes, rows) < k)[None]
    rw = np.where(pos_valid, (ck & np.uint32(b - 1)).astype(np.int64), 0)
    xs = np.where(pos_valid, v[np.arange(m)[:, None, None], rw % lanes,
                               rw // lanes], F32(0))
    key = sort_key(xs)
    fails = ((key[:, :, :-1] > key[:, :, 1:])
             & pos_valid[:, :, 1:]).any((1, 2))
    if lanes > 1:
        li = np.arange(1, lanes)
        fails |= ((key[:, :-1, -1] > key[:, 1:, 0])
                  & (li * rows < k)[None]).any(1)
    return xs, rw, fails


def coarse_sort(v, k):
    """The kernel's ``sort_coarse``: the coarse order where every column
    of a warp (32 / L neighbouring columns) passes the check, else the
    (key, row) pairs for the warp's columns.  Returns (values, rows,
    the warps that took the pairs)."""
    m, lanes, _ = v.shape
    xs, rw, fails = coarse_parts(v, k)
    g = 32 // lanes
    warp_fails = np.zeros(-(-m // g) * g, bool)
    warp_fails[:m] = fails
    warp_fails = warp_fails.reshape(-1, g).any(1)
    exact = np.repeat(warp_fails, g)[:m]
    if exact.any():
        xp, rp = pair_sort(v[exact], k)
        xs[exact], rw[exact] = xp, rp
    return xs, rw, warp_fails


def group_two_pass(x, a, *, block_k, weighted, num_iters=10,
                   c=mestimators.TUKEY_C95):
    """The kernel's group layout (one K block, k <= block_k) for x (K, M)
    and normalized a (K, N): weighted columns of 16 rows a lane sort on
    coarse keys (``coarse_sort``), those of 32 on (key, row) pairs."""
    k, m = x.shape
    n = a.shape[1]
    rows, lanes = TK.two_pass_rows(block_k), TK.two_pass_lanes(block_k)
    li = np.arange(lanes)
    slot = group_slots(lanes, rows)                            # (L, R) rows
    valid = slot < k
    v = load_group(x, block_k)                                 # (M, L, R)
    pos_valid = group_positions(lanes, rows) < k
    cols = np.arange(m)
    if weighted:
        xs, rw = coarse_sort(v, k)[:2] if rows == 16 else pair_sort(v, k)
        rw_sorted = positions(rw)[:, :k]
    else:
        keys = warp_sort(np.where(valid[None], sort_key(v),
                                  np.uint32(0xFFFFFFFF)))
        xs = np.where(pos_valid[None], key_value(keys), F32(0))
    xs_sorted = positions(xs)[:, :k]
    ap = np.zeros((max(block_k, k), n), F32)
    ap[:k] = a
    out = np.zeros((n, m), F32)
    for nn in range(n):
        wcol = ap[:, nn]
        mass = F32(0)                     # stage_weights: bk rows in order
        for r in range(block_k):
            mass = F32(mass + wcol[r])
        if weighted:                      # position by position, twice
            ws = wcol[rw_sorted]
            tot = np.zeros(m, F32)
            for e in range(k):
                tot = (tot + ws[:, e]).astype(F32)
            half = F32(0.5) * tot
            cw, hit = np.zeros(m, F32), np.full(m, -1)
            for e in range(k):
                prev = cw
                cw = (cw + ws[:, e]).astype(F32)
                hit = np.where((cw >= half) & (prev < half), e, hit)
            med = np.where(hit >= 0, xs_sorted[cols, np.maximum(hit, 0)],
                           F32(0))
            xv = xs
            wv = np.where(pos_valid[None], wcol[rw], F32(0))
        else:
            med = middle(xs_sorted, k)
            xv = v
            wv = np.where(valid[None], wcol[np.where(valid, slot, 0)][None],
                          F32(0))
        mad = mad_select(xs_sorted, med.astype(F32))
        crosses = mass >= F32(0.5) * mass and F32(0) < F32(0.5) * mass
        mu = (med if crosses else np.zeros(m)).astype(F32)
        mad = (mad if crosses else np.zeros(m)).astype(F32)
        scale = np.maximum(F32(TK._MAD_CONSISTENCY) * mad, F32(1e-12))
        inv = (F32(1) / (F32(c) * scale)).astype(F32)
        for _ in range(num_iters):
            num = np.zeros((m, lanes), F32)
            den = np.zeros((m, lanes), F32)
            for q in range(rows):         # each lane's rows, in order
                y = ((xv[:, :, q] - mu[:, None]) * inv[:, None]).astype(F32)
                u = np.clip(fma(-y, y, F32(1)), 0, 1)
                w = (wv[:, :, q] * (u * u)).astype(F32)
                num = fma(w, xv[:, :, q], num)
                den = (den + w).astype(F32)
            off = lanes // 2
            while off:                    # the group's butterfly
                num = (num + num[:, li ^ off]).astype(F32)
                den = (den + den[:, li ^ off]).astype(F32)
                off //= 2
            num, den = num[:, 0], den[:, 0]
            safe = den > F32(1e-12)
            mu = np.where(safe, num / np.where(safe, den, F32(1)),
                          mu).astype(F32)
        out[nn] = mu
    return out


def kernel_two_pass(x, a, *, block_k, weighted):
    """The layout the kernel takes: the group layout for one K block, one
    warp a column for several."""
    run = group_two_pass if x.shape[0] <= block_k else warp_two_pass
    return run(x, a, block_k=block_k, weighted=weighted)


def make(k, m, n, kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, m)).astype(F32)
    if kind == "ties":
        x = (np.round(x * 2.0) / 2.0 + 0.0).astype(F32)
    else:
        x[-max(1, k // 5):] += F32(1000.0)
    if kind == "mad_floor":
        x[:, ::3] = F32(3.0)
    a = rng.uniform(0.1, 1.0, size=(k, n)).astype(F32)
    if kind == "ties":
        a[:] = 1.0
    return x, (a / a.sum(0)).astype(F32)


def plain(x, a, block_k, weighted):
    k, m = x.shape
    plan = TK.launch_plan(k, m, a.shape[1], path="two_pass", block_k=block_k)
    xp, ap = TK._pad_inputs(torch.from_numpy(x), torch.from_numpy(a),
                            plan=plan)
    return TK.mm_two_pass_plain(xp, ap, k=k, block_k=block_k,
                                weighted=weighted)[:, :m].numpy()


@pytest.mark.parametrize("rpl", [1, 2, 4, 8, 16])
def test_warp_network_sorts_and_merges_like_the_kernel(rpl):
    rng = np.random.default_rng(rpl)
    v = rng.integers(0, 50, size=(9, 32, rpl)).astype(np.uint32)
    got = positions(warp_sort(v))
    np.testing.assert_array_equal(got, np.sort(positions(v), axis=1))
    # a falling-then-rising run, then +inf sentinels: one merge sorts it
    vals = rng.normal(size=(9, 32 * rpl)).astype(F32)
    vals.sort(axis=1)
    med = vals[:, 32 * rpl // 3]
    d = np.abs(vals - med[:, None])
    d[:, 32 * rpl - 5:] = np.inf
    merged = positions(warp_merge(d.reshape(9, 32, rpl)))
    np.testing.assert_array_equal(merged, np.sort(d, axis=1))


@pytest.mark.parametrize("p", [64, 128, 256])
def test_strip_network_sorts_pairs(p):
    rng = np.random.default_rng(p)
    s = rng.integers(0, 2 ** 40, size=(7, p)).astype(np.uint64)
    np.testing.assert_array_equal(strip_sort(s), np.sort(s, axis=1))


@pytest.mark.parametrize("kb", [2, 3, 18, 32, 35, 64])
def test_combine_crosses_where_the_plain_version_does(kb):
    """Both of the kernel's combine networks (registers to 32 blocks, the
    strip above) give the plain version's stable (value, block) order:
    stats with ties across blocks, equal masses, so half the mass falls
    exactly on a block boundary."""
    rng = np.random.default_rng(kb)
    m = 50
    stats = (np.round(rng.normal(size=(kb, m)) * 2) / 2).astype(F32)
    for mass in (np.full(kb, F32(1.0) / kb, F32),
                 rng.uniform(0, 1, kb).astype(F32)):
        mass = mass.copy()
        if kb > 2:
            mass[1] = 0.0                       # a massless block
        half = F32(0.5) * np.add.accumulate(mass, dtype=F32)[-1]
        got = combine(stats, mass, half)
        st = torch.from_numpy(stats)[:, None, :]             # (KB, 1, M)
        order = torch.argsort(st, dim=0, stable=True)
        mw = torch.take_along_dim(
            torch.from_numpy(mass)[:, None, None].expand_as(st), order, 0)
        want = TK._crossing(torch.take_along_dim(st, order, 0), mw,
                            torch.tensor(half))[0].numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["contaminated", "ties", "mad_floor"])
@pytest.mark.parametrize("k,block_k,n", [(100, 128, 2), (40, 64, 1),
                                         (200, 128, 2), (70, 32, 1),
                                         (1100, 32, 1)])
def test_kernel_arithmetic_stays_within_parity_of_the_plain_version(
        k, block_k, n, kind):
    """KB = 1 (K = 100 at bk = 128, K = 40 at bk = 64), KB = 2, 3 (K = 200
    at 128; K = 70 at 32, a partial last block) and KB = 35 (K = 1100 at
    32: the combine in the strip), weighted and unweighted."""
    x, a = make(k, 37, n, kind, seed=k + block_k + len(kind))
    tol = 1e-5 * max(1.0, float(np.abs(x).max()))
    for weighted, aw in ((True, a), (False, np.full((k, 1), 1.0 / k, F32))):
        got = kernel_two_pass(x, aw, block_k=block_k, weighted=weighted)
        want = plain(x, aw, block_k, weighted)
        assert np.isfinite(got).all()
        assert float(np.abs(got - want).max()) <= tol, (weighted, kind)


def test_massless_middle_block_leaves_the_combine():
    x, a = make(70, 29, 1, "contaminated", seed=5)
    a[32:64] = 0.0
    a = (a / a.sum(0)).astype(F32)
    got = warp_two_pass(x, a, block_k=32, weighted=True)
    want = plain(x, a, 32, True)
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(x).max())


@pytest.mark.parametrize("bk", [16, 32, 64, 128, 256, 512])
def test_group_network_sorts_like_the_kernel(bk):
    """The group layout's network at each K block's rows a lane and lanes
    a column, pairs with ties in the key broken by the row, as the
    weighted columns sort."""
    rows, lanes = TK.two_pass_rows(bk), TK.two_pass_lanes(bk)
    rng = np.random.default_rng(bk)
    keys = rng.integers(0, 20, size=(5, lanes * rows)).astype(np.uint64)
    pairs = (keys << np.uint64(32)) | np.arange(lanes * rows,
                                                dtype=np.uint64)
    got = positions(warp_sort(pairs.reshape(5, lanes, rows)))
    np.testing.assert_array_equal(got, np.sort(pairs, axis=1))


@pytest.mark.parametrize("k", [1, 2, 3, 64, 65, 128, 301, 512])
def test_mad_selection_matches_the_sorted_deviations(k):
    """The selection gives the rank midpoint of the sorted |x - med|, bit
    for bit: ties, a median inside, at either end and outside the
    column, and every value equal."""
    rng = np.random.default_rng(k)
    xs = np.sort((np.round(rng.normal(size=(40, k)) * 3) / 3).astype(F32), 1)
    xs[-3:] = F32(2.5)
    med = np.concatenate([
        xs[:10, (k - 1) // 2], xs[10:20, 0], xs[20:30, -1],
        (xs[30:37, 0] - F32(5)), xs[37:, 0]]).astype(F32)
    ds = np.sort(np.abs(xs - med[:, None]), 1)
    want = F32(0.5) * (ds[:, (k - 1) // 2] + ds[:, k // 2])
    np.testing.assert_array_equal(mad_select(xs, med), want)


def group_inputs(k, m, n, kind, seed):
    """Values and normalized weights for the group layout's cases: ties
    (multiples of 0.5, random weights), zero_weights (a third of the rows
    weigh 0) and exact_half (64 rows of weight 1/64, the rest 0, so the
    sorted-order mass reaches exactly one half at a row)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, m)).astype(F32)
    if kind == "ties":
        x = (np.round(x * 2.0) / 2.0 + 0.0).astype(F32)
    else:
        x[-max(1, k // 5):] += F32(1000.0)
    a = rng.uniform(0.1, 1.0, size=(k, n)).astype(F32)
    if kind == "zero_weights":
        a[rng.uniform(size=(k, n)) < 1 / 3] = 0.0
    elif kind == "exact_half":
        a[:] = 0.0
        for j in range(n):
            a[rng.permutation(k)[:64], j] = 1.0
    return x, (a / a.sum(0)).astype(F32)


@pytest.mark.parametrize("kind", ["ties", "zero_weights", "exact_half"])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("k", [65, 100, 128, 301, 512])
def test_group_layout_stays_within_parity_of_the_plain_version(k, n, kind):
    """One K block of next_pow2(K) rows (8 or 16 lanes a column):
    the sequential crossing over the sorted order (at exactly half the
    mass in exact_half), the MAD by selection and IRLS in the group's
    partial-sum order, weighted and unweighted (one uniform column, as
    the wrappers launch it)."""
    bk = TK.next_pow2(k)
    x, a = group_inputs(k, 23, n, kind, seed=k * 10 + n)
    tol = 1e-5 * max(1.0, float(np.abs(x).max()))
    for weighted, aw in ((True, a), (False, np.full((k, 1), 1.0 / k, F32))):
        got = group_two_pass(x, aw, block_k=bk, weighted=weighted)
        want = plain(x, aw, bk, weighted)
        assert np.isfinite(got).all()
        assert float(np.abs(got - want).max()) <= tol, (weighted, kind)


def tile_at(r, c, cols):
    """The kernel's swizzled tile address of (row r, column c)."""
    return r * cols + ((c + (r >> (5 - ilog2(cols)))) & (cols - 1))


def strip_at(e, c, rows, lanes):
    """The group layout's strip slot of sorted position e, column c."""
    w = 256 // lanes
    return e * w + ((c + (e // rows) * (32 // lanes)) & (w - 1))


@pytest.mark.parametrize("bk", [16, 32, 64, 128, 256, 512])
def test_group_strips_are_a_bijection_without_bank_conflicts(bk):
    """Every (position, column) of the widest block has its own slot; a
    warp storing the q-th position of each lane's run (its 32 / lanes
    columns), and 32 neighbouring columns read at one position, hit 32
    distinct banks (at most 2 ways where a row has 16 entries, bk 512)."""
    rows, lanes = TK.two_pass_rows(bk), TK.two_pass_lanes(bk)
    w, g = 256 // lanes, 32 // lanes
    e, c = np.meshgrid(np.arange(rows * lanes), np.arange(w), indexing="ij")
    slots = strip_at(e, c, rows, lanes)
    assert sorted(slots.ravel().tolist()) == list(range(rows * lanes * w))
    ways = 1 if w >= 32 else 32 // w
    lane = np.arange(32)
    for warp in range(256 // 32):
        col, li = warp * g + lane // lanes, lane % lanes
        for q in range(rows):
            banks = strip_at(li * rows + q, col, rows, lanes) % 32
            assert np.bincount(banks).max() <= ways
    for pos in range(rows * lanes):
        banks = strip_at(pos, np.arange(min(32, w)), rows, lanes) % 32
        assert np.bincount(banks).max() == 1


@pytest.mark.parametrize("cols", TK.TWO_PASS_BLOCK_MS)
def test_tile_swizzle_is_a_bijection_without_bank_conflicts(cols):
    """Every (row, column) of a (K_pad, cols) tile has its own slot; a
    warp reading 32 consecutive rows of its column, and a warp storing
    32 consecutive elements of a loaded chunk (row e / cols, column
    e % cols), each hit 32 distinct banks."""
    rows = 512
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    slots = tile_at(r, c, cols)
    assert sorted(slots.ravel().tolist()) == list(range(rows * cols))
    for col in range(cols):
        for r0 in range(0, rows, 32):
            banks = tile_at(np.arange(r0, r0 + 32), col, cols) % 32
            assert len(set(banks.tolist())) == 32
    for e0 in range(0, rows * cols, 32):
        e = np.arange(e0, e0 + 32)
        banks = tile_at(e // cols, e % cols, cols) % 32
        assert len(set(banks.tolist())) == 32


def row_at(r, c, rows, lanes):
    """The group layout's strip slot of row r, column c, while it holds a
    weighted column's rows before the coarse-key sort: the slot of
    position (r mod L) R + r / L, where the lane that loaded it keeps it."""
    return strip_at((r % lanes) * rows + r // lanes, c, rows, lanes)


@pytest.mark.parametrize("bk", [16, 32, 64, 128])
def test_row_copy_keeps_each_column_in_its_own_slots(bk):
    """The copy of a coarse-key sort's rows (16 rows a lane): every (row,
    column) of the widest block has its own slot, each column the very
    slots the sorted layout gives it (so a group's copy never lands in a
    slot that a group of another warp reads unsynchronised), and a warp
    storing row q L + li of each of its 32 / L columns hits 32 distinct
    banks."""
    rows, lanes = TK.two_pass_rows(bk), TK.two_pass_lanes(bk)
    w, g = 256 // lanes, 32 // lanes
    r, c = np.meshgrid(np.arange(rows * lanes), np.arange(w), indexing="ij")
    slots = row_at(r, c, rows, lanes)
    assert sorted(slots.ravel().tolist()) == list(range(rows * lanes * w))
    np.testing.assert_array_equal(np.sort(slots, 0),
                                  np.sort(strip_at(r, c, rows, lanes), 0))
    lane = np.arange(32)
    for warp in range(256 // 32):
        col, li = warp * g + lane // lanes, lane % lanes
        for q in range(rows):
            banks = row_at(q * lanes + li, col, rows, lanes) % 32
            assert len(set(banks.tolist())) == 32


def coarse_values(k, m, kind, seed):
    """(K, M) f32 columns for the coarse-key sort: cohort (the serve
    cohort's mix, K // 8 copies of one value beside N(0, 1) rows), bucket
    (near ties: keys in one or two neighbouring 128-key buckets, exact
    ties among them), narrow (1000 + N(0, 1e-3)), clustered (rows 0 and
    1 at -1000 and 1000, so the range is wide, the rest 1 + j ulp, j <
    100: one bucket, out of row order), specials (+-0, +-inf and NaNs of
    either sign beside N(0, 1)) and top (NaNs whose keys lie at and just
    below 0xffffffff, the sentinel, and the lowest key, beside N(0, 1))."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, m)).astype(F32)
    if kind == "cohort":
        x[k - k // 8:] = x[0] + F32(1000.0)
    elif kind == "bucket":
        base = sort_key(x[0]) & np.uint32(2 ** 32 - 128)
        keys = base + np.uint32(128) * rng.integers(0, 2, size=(k, m)) \
            + rng.integers(0, 40, size=(k, m))
        x = key_value(keys.astype(np.uint32))
    elif kind == "narrow":
        x = (F32(1000.0) + F32(1e-3) * x).astype(F32)
    elif kind == "clustered":
        x = key_value(np.uint32(0xBF800000)
                      + rng.integers(0, 100, size=(k, m)).astype(np.uint32))
        x[:2] = np.array([-1000.0, 1000.0], F32)[:k, None]
    elif kind == "specials":
        bits = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                         0x7FC00000, 0xFFC00000, 0x7F800001, 0x3F800000],
                        np.uint32)
        pick = rng.integers(0, 2 * len(bits), size=(k, m))
        x = np.where(pick < len(bits), bits[pick % len(bits)].view(F32), x)
    elif kind == "top":
        bits = (np.uint32(0x7FFFFF80)
                + rng.integers(0, 128, size=(k, m))).astype(np.uint32)
        bits[rng.uniform(size=(k, m)) < 0.1] = 0x7FFFFFFF
        bits[rng.uniform(size=(k, m)) < 0.05] = 0xFFFFFFFF
        x = np.where(rng.uniform(size=(k, m)) < 0.5, bits.view(F32), x)
    return x


COARSE_KINDS = ["cohort", "bucket", "narrow", "clustered", "specials", "top"]
COARSE_SHAPES = [(bk, k) for bk in (16, 32, 64, 128)
                 for k in (1, 2, 17, 65, 100, 127, 128) if k <= bk]


@pytest.mark.parametrize("kind", COARSE_KINDS)
@pytest.mark.parametrize("bk,k", COARSE_SHAPES)
def test_coarse_keys_sort_exactly_where_the_check_passes(bk, k, kind):
    """The coarse-key schedule (keys, the group's network on 32 bits, rows
    from the low bits, the check) against the (key, row) pairs' network:
    a column's check fails exactly where its coarse order differs from
    the pairs' order, so wherever it passes the order and the gathered
    values are the pairs', bit for bit; and after the warps that fail
    sort again on pairs, every column is the pairs'."""
    m = 256
    v = load_group(coarse_values(k, m, kind, seed=bk * 1000 + k), bk)
    xs_p, rw_p = pair_sort(v, k)
    xs_c, rw_c, fails = coarse_parts(v, k)
    same = (rw_c == rw_p).all((1, 2))
    np.testing.assert_array_equal(fails, ~same)
    np.testing.assert_array_equal(xs_c[same].view(np.uint32),
                                  xs_p[same].view(np.uint32))
    xs, rw, _ = coarse_sort(v, k)
    np.testing.assert_array_equal(rw, rw_p)
    np.testing.assert_array_equal(xs.view(np.uint32), xs_p.view(np.uint32))


def test_coarse_keys_send_few_cohort_warps_and_no_narrow_ones_to_pairs():
    """At the serve cohort's shape (K = 128, one 128-row block, 4 columns
    a warp): its mix sends a few percent of warps to the pairs' sort, as
    the kernel's exact-tile count should read; narrow data, whose range
    the relative scale spreads over 32 bits, and bf16 values (16 bits of
    key) none; clustered columns (a wide range, the rest in one bucket)
    all."""
    m = 4096
    share = {}
    for kind in ("cohort", "narrow", "clustered"):
        v = load_group(coarse_values(128, m, kind, seed=7), 128)
        share[kind] = float(coarse_sort(v, 128)[2].mean())
    assert 0.005 < share["cohort"] < 0.06, share
    assert share["narrow"] == 0.0 and share["clustered"] == 1.0, share
    x = coarse_values(128, m, "cohort", seed=8)
    bf16 = torch.from_numpy(x).bfloat16().float().numpy()
    assert not coarse_sort(load_group(bf16, 128), 128)[2].any()
