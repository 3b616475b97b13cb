"""The finiteness check of the streaming service (``ops.any_nonfinite``).

On the CPU: the kernel's bit test in plain PyTorch
(``any_nonfinite_plain``) against ``torch.isfinite(x).all()`` at the
kernel's edges (lengths around one 16-byte vector, storage offsets 1-3,
NaN/+inf/-inf first, in the middle and last, bit patterns at the edge of
finite), the split of a tensor into the kernel's head, 16-byte vectors and
tail, the CPU path of ``any_nonfinite`` (which is ``torch.isfinite``), and
the service's three checks (an update refused at submit with its seq
consumed, an estimate carried forward, an initial model refused).

Marked ``cuda`` (they skip without a card; run them on one with
``pytest -m cuda tests/test_torch_finite.py``): the CUDA kernel itself
against ``torch.isfinite(x).all()`` at the same edges, on real addresses,
and its refusal of the CUDA tensors it cannot read."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.serve import buffer as sbuf
from repro_torch.serve import service as ssvc
from repro_torch.serve.clock import SimClock

SPECIALS = {"nan": float("nan"), "+inf": float("inf"), "-inf": float("-inf")}
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# lengths around one 16-byte vector of f32 (4) and bf16 (8) elements
LENGTHS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 15, 16, 17, 33)
OFFSETS = (1, 2, 3)
# bit patterns at the edge of finite: the largest and smallest finite
# values, denormals and -0 are finite; every NaN payload and both
# infinities are not
BIT_PATTERNS = {
    torch.float32: (torch.int32, {
        "max": 0x7F7FFFFF, "-max": -0x00800001, "tiny": 0x00000001,
        "-0": -0x80000000, "snan": 0x7F800001, "-qnan": -0x00400000,
        "+inf": 0x7F800000, "-inf": -0x00800000}),
    torch.bfloat16: (torch.int16, {
        "max": 0x7F7F, "-max": -0x0081, "tiny": 0x0001, "-0": -0x8000,
        "snan": 0x7F81, "-qnan": -0x0040, "+inf": 0x7F80, "-inf": -0x0080}),
}
NONFINITE_PATTERNS = ("snan", "-qnan", "+inf", "-inf")


def _expected(x: torch.Tensor) -> bool:
    return not bool(torch.isfinite(x).all())


def _positions(n: int) -> dict:
    return {"first": 0, "middle": n // 2, "last": n - 1}


def _edge_cases(dtype, special, where, device="cpu"):
    """(label, tensor) pairs: for every LENGTHS n, a finite tensor and one
    with ``special`` at ``where``, contiguous and as views at each of
    OFFSETS elements into a larger storage."""
    for n in LENGTHS:
        for offset in (0, *OFFSETS):
            base = torch.linspace(-3.0, 3.0, n + offset).to(dtype).to(device)
            view = base[offset:]
            assert view.storage_offset() == offset and view.numel() == n
            yield (n, offset, None), view.clone() if offset == 0 else view
            bad = base.clone()[offset:]
            bad[_positions(n)[where]] = SPECIALS[special]
            yield (n, offset, special), bad


def _bit_cases(dtype, device="cpu"):
    bits, patterns = BIT_PATTERNS[dtype]
    for name, pattern in patterns.items():
        x = torch.zeros(11, dtype=bits)
        x[7] = pattern
        yield name, x.view(dtype).to(device)


# ===========================================================================
# the kernel's test in plain PyTorch, and the split, on the CPU
# ===========================================================================

@pytest.mark.parametrize("dtype", KERNEL_DTYPES, ids=str)
@pytest.mark.parametrize("special", SPECIALS)
@pytest.mark.parametrize("where", ("first", "middle", "last"))
def test_plain_version_matches_isfinite(dtype, special, where):
    for label, x in _edge_cases(dtype, special, where):
        got = bool(ops.any_nonfinite_plain(x))
        assert got == _expected(x) == (label[2] is not None), label


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("dtype", KERNEL_DTYPES, ids=str)
def test_split_of_views_at_a_storage_offset(offset, dtype):
    """The split of a view that starts ``offset`` elements into an
    aligned storage: the head reaches the first 16-byte boundary, and the
    plain version reads the view, not its storage."""
    base = torch.linspace(-2.0, 2.0, 64).to(dtype)
    per_vec = 16 // base.element_size()
    assert base.data_ptr() % 16 == 0
    for n in (0, *LENGTHS):
        view = base[offset:offset + n]
        head, n_vec, tail = ops.finite_split(view.data_ptr(), n,
                                             view.element_size())
        assert head == min(per_vec - offset, n)
        assert head + n_vec * per_vec + tail == n
        # a special just outside the view is not the view's
        outside = base.clone()
        outside[offset - 1] = float("nan")
        outside[offset + n] = float("inf")
        assert not bool(ops.any_nonfinite_plain(outside[offset:offset + n]))


@pytest.mark.parametrize("itemsize", (2, 4))
def test_split_covers_every_element_once(itemsize):
    per_vec = 16 // itemsize
    for ptr in range(4096, 4096 + 32, itemsize):
        for n in range(0, 41):
            head, n_vec, tail = ops.finite_split(ptr, n, itemsize)
            assert head + n_vec * per_vec + tail == n
            assert 0 <= head < per_vec and 0 <= tail < per_vec
            if n_vec:
                assert (ptr + head * itemsize) % 16 == 0
            if head < n:
                # the head stops at the first boundary, and no later
                assert (ptr + head * itemsize) % 16 == 0
    with pytest.raises(ValueError, match="not aligned"):
        ops.finite_split(4097, 8, itemsize)


@pytest.mark.parametrize("dtype", KERNEL_DTYPES, ids=("f32", "bf16"))
def test_bit_patterns_at_the_edges_of_finite(dtype):
    for name, x in _bit_cases(dtype):
        want = name in NONFINITE_PATTERNS
        assert _expected(x) == want, name
        assert bool(ops.any_nonfinite_plain(x)) == want, name


@pytest.mark.parametrize("dtype", KERNEL_DTYPES, ids=str)
def test_plain_version_of_empty_tensors(dtype):
    for shape in ((0,), (3, 0), (0, 0, 2)):
        assert not bool(ops.any_nonfinite_plain(torch.empty(shape,
                                                            dtype=dtype)))


# ===========================================================================
# any_nonfinite on a CPU tensor: torch.isfinite, as a 0-d int32 flag
# ===========================================================================

@pytest.mark.parametrize("dtype", (*KERNEL_DTYPES, torch.float16, torch.int32,
                                   torch.int64, torch.uint8), ids=str)
def test_cpu_tensors_take_isfinite(dtype):
    cases = [torch.empty(0, dtype=dtype), torch.empty((3, 0), dtype=dtype),
             torch.arange(7).to(dtype)]
    if dtype.is_floating_point:
        for value in SPECIALS.values():
            x = torch.arange(7).to(dtype)
            x[3] = value
            cases.append(x)
    for x in cases:
        got = ops.any_nonfinite(x)
        assert got.shape == () and got.dtype == torch.int32
        assert bool(got) == _expected(x)


def test_cpu_checks_launch_nothing():
    before = ops.FINITE_LAUNCHES
    ops.any_nonfinite(torch.full((100,), float("nan")))
    assert ops.FINITE_LAUNCHES == before


# ===========================================================================
# the CUDA kernel, on a card
# ===========================================================================

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the finiteness kernel has no CPU "
                    "mode")
    return torch.device("cuda", torch.cuda.current_device())


def _kernel_check(x, label):
    before = ops.FINITE_LAUNCHES
    got = ops.any_nonfinite(x)
    assert got.shape == () and got.dtype == torch.int32, label
    assert ops.FINITE_LAUNCHES == before + (x.numel() > 0), label
    assert bool(got) == _expected(x), label
    return bool(got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", KERNEL_DTYPES, ids=str)
@pytest.mark.parametrize("special", SPECIALS)
@pytest.mark.parametrize("where", ("first", "middle", "last"))
def test_kernel_matches_isfinite(card, dtype, special, where):
    for label, x in _edge_cases(dtype, special, where, card):
        assert _kernel_check(x, label) == (label[2] is not None), label
    for shape in ((0,), (3, 0)):
        assert not _kernel_check(torch.empty(shape, dtype=dtype,
                                             device=card), shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", KERNEL_DTYPES, ids=("f32", "bf16"))
def test_kernel_bit_patterns(card, dtype):
    for name, x in _bit_cases(dtype, card):
        assert _kernel_check(x, name) == (name in NONFINITE_PATTERNS), name


@pytest.mark.cuda
def test_kernel_refuses_tensors_it_cannot_read(card):
    strided = torch.zeros(64, device=card)[::2]
    for x in (strided, torch.zeros(8, dtype=torch.float16, device=card),
              torch.zeros(8, dtype=torch.int32, device=card)):
        with pytest.raises(ValueError, match="finiteness kernel"):
            ops.any_nonfinite(x)


@pytest.mark.cuda
def test_kernel_on_a_device_that_is_not_current(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", (card.index + 1) % torch.cuda.device_count())
    x = torch.zeros(1000, device=other)
    assert not _kernel_check(x, "finite")
    x[999] = float("nan")
    assert _kernel_check(x, "nan last")
    assert torch.cuda.current_device() == card.index


# ===========================================================================
# the service's three checks
# ===========================================================================

DIM = 6


def _service(**cfg_kw):
    config = ssvc.ServeConfig(**dict(dict(k_min=4, quorum=2, deadline_s=1.0,
                                          backend="jnp"), **cfg_kw))
    return ssvc.AggregationService(np.zeros(DIM, np.float32), config=config,
                                   clock=SimClock(), device="cpu")


def _update(agent, seq, payload):
    return sbuf.AgentUpdate(agent_id=agent, round=0, payload=payload,
                            seq=seq)


@pytest.mark.parametrize("special", SPECIALS)
@pytest.mark.parametrize("where", ("first", "middle", "last"))
def test_nonfinite_update_is_refused_and_its_seq_consumed(special, where):
    svc = _service()
    bad = torch.full((DIM,), 0.5)
    bad[_positions(DIM)[where]] = SPECIALS[special]
    assert svc.submit(_update(0, 3, bad)) == "rejected_invalid"
    # a replay of the refused delivery is a duplicate, a newer one is taken
    assert svc.submit(_update(0, 3, torch.full((DIM,), 0.5))) == "duplicate"
    assert svc.submit(_update(0, 4, torch.full((DIM,), 0.5))) == "buffered"
    assert len(svc.buffer) == 1


@pytest.mark.parametrize("special", SPECIALS)
@pytest.mark.parametrize("where", ("first", "middle", "last"))
def test_nonfinite_estimate_is_carried_forward(special, where, monkeypatch):
    svc = _service()
    launch = svc._launch

    def poisoned(rows, a, degraded):
        result, *rest = launch(rows, a, degraded)
        result = result.clone()
        result[_positions(DIM)[where]] = SPECIALS[special]
        return (result, *rest)

    monkeypatch.setattr(svc, "_launch", poisoned)
    for agent in range(svc.config.k_min):
        svc.submit(_update(agent, 1, torch.full((DIM,), 0.5)))
    (c,) = svc.drain_commits()
    assert c.kind == "carried_forward" and svc.round == 0
    assert svc.telemetry.counters["nonfinite_rejected"] == 1
    assert torch.equal(svc.model, torch.zeros(DIM))
    assert len(svc.buffer) == 0          # the cohort was consumed


@pytest.mark.parametrize("special", SPECIALS)
@pytest.mark.parametrize("where", ("first", "middle", "last"))
def test_nonfinite_initial_model_is_refused(special, where):
    w0 = np.zeros(DIM, np.float32)
    w0[_positions(DIM)[where]] = SPECIALS[special]
    with pytest.raises(ValueError, match="initial model must be finite"):
        ssvc.AggregationService(w0, clock=SimClock(), device="cpu")
