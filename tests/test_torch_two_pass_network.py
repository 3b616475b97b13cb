"""The two-pass kernel's arithmetic, transcribed to numpy f32 and held to
the plain version (CPU).

``csrc/mm_two_pass.cu`` gives one warp one column: lane l holds the rows
q * 32 + l of each K block (q < RPL = bk / 32), a warp bitonic network
sorts them into positions e = l * RPL + q, the weighted crossing sums
weights position by position, the MAD merges |x - med| with one bitonic
merge, the combine sorts (value, block) pairs (one a lane for KB <= 32,
else in a shared-memory strip), and IRLS runs in reciprocal form with
each lane's partial sums reduced by a butterfly.  No CUDA compiler runs
here, so the networks below follow the kernel's ``warp_flip``,
``warp_stage`` and ``combine`` stage for stage (partners, in-lane and
cross-lane, directions): these tests check its schedule as well as the
rounding of its arithmetic, within the tolerance the card's parity uses,
1e-5 x max(1, |x|_inf).
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
    """Ascending stage at distance 2^t; v: (M, 32, RPL), element
    e = lane * RPL + q (the kernel's layout)."""
    rpl = v.shape[2]
    logr = ilog2(rpl)
    lane = np.arange(32)
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
    lane = np.arange(32)
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
    log = ilog2(v.shape[2]) + 5
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
        got = warp_two_pass(x, aw, block_k=block_k, weighted=weighted)
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


def tile_at(r, c, cols):
    """The kernel's swizzled tile address of (row r, column c)."""
    return r * cols + ((c + (r >> (5 - ilog2(cols)))) & (cols - 1))


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
