"""The service's norms after a commit (``ops.residual_norms``).

On the CPU: the plain version against ``vector_norm(row - center)`` row
by row, the wrapper's refusals (dtype, strided tensors, a length or
device that is not the centre's, no rows), and services whose
estimator-outlier verdicts, step-norm EMA and clipped models are those of
the formula the service applied before the norms shared one read: each
member's ``vector_norm(row - estimate)`` against the MADN threshold, and
``vector_norm(estimate - w)`` for the trust clip.

Marked ``cuda`` (they skip without a card; run them on one with
``pytest -m cuda tests/test_torch_residual.py``): the CUDA kernel against
the plain version and a float64 sum for 1 to 513 rows, at odd lengths,
on views that are not 16-byte aligned, with Byzantine-sized offsets, and
the same bits on a repeat."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.serve import buffer as sbuf
from repro_torch.serve import service as ssvc
from repro_torch.serve.clock import SimClock


def _rows(n, m, seed=0, shift=0.0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    rows = [torch.randn(m, generator=g, device=device) for _ in range(n)]
    if shift:
        rows[-1] += shift
    center = torch.randn(m, generator=g, device=device) * 0.1
    return rows, center


def _per_row(rows, center):
    return torch.stack([torch.linalg.vector_norm(r - center) for r in rows])


def _float64_norms(rows, center):
    """The difference in f32, as the kernel takes it, its squares summed
    in f64."""
    return torch.stack([torch.linalg.vector_norm((r - center).double())
                        for r in rows])


# ===========================================================================
# the plain version and the wrapper on the CPU
# ===========================================================================

@pytest.mark.parametrize("n,m,shift", [(1, 1, 0.0), (2, 7, 0.0),
                                        (9, 1001, 1000.0), (17, 33, 0.0)])
def test_plain_version_is_vector_norm_row_by_row(n, m, shift):
    rows, center = _rows(n, m, seed=n, shift=shift)
    want = _per_row(rows, center)
    for got in (ops.residual_norms_plain(rows, center),
                ops.residual_norms(rows, center)):
        assert got.dtype == torch.float32 and got.shape == (n,)
        assert torch.equal(got, want)


def _refusal(case):
    rows, center = _rows(3, 8)
    if case == "no rows":
        return [], center
    if case == "dtype":
        return [rows[0], rows[1].double(), rows[2]], center
    if case == "centre dtype":
        return rows, center.to(torch.bfloat16)
    if case == "strided":
        return [rows[0], torch.randn(16)[::2], rows[2]], center
    if case == "strided centre":
        return rows, torch.randn(16)[::2]
    if case == "length":
        return [rows[0], torch.randn(9), rows[2]], center
    if case == "device":
        return [rows[0], rows[1].to("meta"), rows[2]], center
    raise AssertionError(case)


@pytest.mark.parametrize("case,match", [
    ("no rows", "at least one row"), ("dtype", "float32"),
    ("centre dtype", "float32"), ("strided", "strided"),
    ("strided centre", "strided"), ("length", "9 elements"),
    ("device", "is on meta")])
def test_wrapper_refuses_what_the_kernel_cannot_read(case, match):
    rows, center = _refusal(case)
    before = ops.RESIDUAL_LAUNCHES
    with pytest.raises(ValueError, match=match):
        ops.residual_norms(rows, center)
    assert ops.RESIDUAL_LAUNCHES == before


def test_cpu_norms_launch_nothing():
    before = ops.RESIDUAL_LAUNCHES
    ops.residual_norms(*_rows(4, 10))
    assert ops.RESIDUAL_LAUNCHES == before


# ===========================================================================
# the service's verdicts, EMA and clip against the formula as it stood
# ===========================================================================

DIM = 6
K = 4


def _formula_outliers(rows, est, entries_ids, z):
    r = torch.stack([torch.linalg.vector_norm(rows[i] - est)
                     for i in range(len(entries_ids))]).numpy()
    med = float(np.median(r))
    madn = 1.4826 * float(np.median(np.abs(r - med)))
    floor = max(1e-7, 1e-3 * max(med, 1.0))
    thresh = med + z * max(madn, floor)
    return tuple(a for a, ri in zip(entries_ids, r) if float(ri) > thresh)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("health_gate", [True, False])
def test_service_verdicts_ema_and_clip_follow_the_formula(
        backend, health_gate, monkeypatch):
    config = ssvc.ServeConfig(k_min=K, quorum=2, deadline_s=1.0,
                              backend=backend, health_gate=health_gate,
                              trust_factor=2.0)
    svc = ssvc.AggregationService(np.zeros(DIM, np.float32), config=config,
                                  clock=SimClock(), device="cpu")
    seen = []
    launch = svc._launch

    def spy(rows, a, degraded):
        out = launch(rows, a, degraded)
        seen.append(([r.clone() for r in rows], out[0].clone(), svc.model))
        return out

    monkeypatch.setattr(svc, "_launch", spy)
    g = torch.Generator().manual_seed(7)
    ema, clipped_any = None, False
    # two rounds near 0.5, then a jump the trust clip has to hold back
    for rnd, level in enumerate((0.5, 0.6, 5.0, 5.1)):
        for agent in range(K):
            payload = level + 0.01 * torch.randn(DIM, generator=g)
            if agent == K - 1:
                payload = payload + 1000.0          # the Byzantine member
            svc.submit(sbuf.AgentUpdate(agent_id=agent, round=svc.round,
                                        payload=payload, seq=rnd + 1))
        (c,) = svc.drain_commits()
        assert c.kind == "aggregated", c
        rows, est, w_prev = seen[-1]
        want = _formula_outliers(rows, est, c.agent_ids, config.residual_z) \
            if health_gate else ()
        assert c.outliers == want
        if health_gate:
            assert c.outliers == (K - 1,)
        delta = est - w_prev
        norm = float(torch.linalg.vector_norm(delta))
        clipped = False
        if ema is not None:
            clip = config.trust_factor * float(ema)
            if norm > clip > 0.0:
                est = delta.mul_(clip / norm).add_(w_prev)
                norm, clipped = clip, True
        assert c.clipped == clipped
        clipped_any |= clipped
        assert torch.equal(svc.model, est)
        ema = norm if ema is None else 0.9 * ema + 0.1 * norm
        assert svc._step_norm_ema == ema
    assert clipped_any


# ===========================================================================
# the CUDA kernel, on a card
# ===========================================================================

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the residual kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _kernel_check(rows, center, label):
    before = ops.RESIDUAL_LAUNCHES
    got = ops.residual_norms(rows, center)
    assert ops.RESIDUAL_LAUNCHES == before + 1, label
    assert got.dtype == torch.float32 and got.shape == (len(rows),), label
    assert got.device == center.device, label
    # the same f32 differences summed in f64 on both sides: within 2 ulp
    want = _float64_norms(rows, center).float()
    torch.testing.assert_close(got, want, rtol=2.5e-7, atol=0.0, msg=label)
    # the plain version sums its squares in f32
    plain = ops.residual_norms_plain(rows, center)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=0.0, msg=label)
    again = ops.residual_norms(rows, center)
    assert torch.equal(got, again), label
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 2, 9, 16, 17, 129, 513))
@pytest.mark.parametrize("m", (0, 1, 5, 4099, 1 << 20))
def test_kernel_matches_the_plain_version(card, n, m):
    rows, center = _rows(n, m, seed=n + m, device=card)
    _kernel_check(rows, center, (n, m))


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 9, 129))
def test_kernel_on_views_not_aligned_to_16_bytes(card, n):
    m = 10_007
    g = torch.Generator(device=card).manual_seed(n)
    base = torch.randn((n + 1) * (m + 3) + 8, generator=g, device=card)
    for c_off in (0, 1, 2, 3):
        center = base[c_off:c_off + m]
        rows = [base[(i + 1) * (m + 3) + (i % 4):][:m] for i in range(n)]
        assert len({r.data_ptr() % 16 for r in rows}) == min(n, 4)
        _kernel_check(rows, center, (n, c_off))


@pytest.mark.cuda
@pytest.mark.parametrize("n", (9, 129))
def test_kernel_with_byzantine_offsets(card, n):
    rows, center = _rows(n, 300_001, seed=3, shift=1000.0, device=card)
    got = _kernel_check(rows, center, n)
    assert float(got[-1]) > 100.0 * float(got[:-1].max())


@pytest.mark.cuda
def test_kernel_reads_a_row_given_twice_and_the_centre_as_a_row(card):
    rows, center = _rows(3, 5_000, seed=5, device=card)
    got = _kernel_check([rows[0], rows[1], rows[0], center], center, "dup")
    assert float(got[0]) == float(got[2]) and float(got[3]) == 0.0


@pytest.mark.cuda
def test_kernel_refuses_cuda_tensors_it_cannot_read(card):
    rows, center = _rows(2, 64, device=card)
    for bad in (torch.zeros(128, device=card)[::2],
                torch.zeros(64, dtype=torch.float16, device=card),
                torch.zeros(64)):
        with pytest.raises(ValueError):
            ops.residual_norms([rows[0], bad], center)
