"""repro_torch estimator core against the JAX reference on CPU.

``core.mestimators`` and ``core.location`` of both packages get the same
numpy inputs: even K, ties, zero and negative weights, an invalid weight
column, a weight batch, and bf16.  f32 agrees at atol 1e-6; bf16 within
one bf16 ulp (the two frameworks may round a midpoint at another step).
Also here: carrying trees across (``interop``), the import guard, and
the Qwen3-0.6B shape table ``chip_smoke.py`` drives.
"""

import ast
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import location as jloc
from repro.core import mestimators as jmest
from repro_torch import interop, pytree
from repro_torch.core import location as tloc
from repro_torch.core import mestimators as tmest

REPO = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


def _within_bf16_ulp(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    g = got.to(torch.float32).numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(g - want) <= ulp + 1e-30), np.max(np.abs(g - want))


def _data(k, m, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, m)).astype(np.float32)
    if ties:
        x = np.round(x * 2) / 2           # many exact ties
    x[-max(1, k // 5):] += 1000.0
    return x


@pytest.mark.parametrize("name", ["quadratic", "absolute", "huber", "tukey"])
def test_loss_families_match(name):
    y = np.linspace(-8, 8, 161).astype(np.float32)
    jl, tl = jmest.get_loss(name), tmest.get_loss(name)
    for fn in ("rho", "psi", "weight"):
        _close(getattr(tl, fn)(_t(y)), getattr(jl, fn)(jnp.asarray(y)),
               atol=1e-5)
    assert jl.redescending == tl.redescending
    assert (tmest.TUKEY_C95, tmest.HUBER_C95, tmest.TUKEY_C50) == \
        (jmest.TUKEY_C95, jmest.HUBER_C95, jmest.TUKEY_C50)


@pytest.mark.parametrize("k", [4, 5, 16, 33])
@pytest.mark.parametrize("ties", [False, True])
def test_median_and_mad_match(k, ties):
    x = _data(k, 37, seed=k, ties=ties)
    _close(tloc.median(_t(x)), jloc.median(jnp.asarray(x)))
    _close(tloc.mad(_t(x)), jloc.mad(jnp.asarray(x)), atol=1e-4)


def test_median_is_the_midpoint_not_the_lower_order_statistic():
    x = np.array([[1.0], [2.0], [3.0], [10.0]], np.float32)
    assert float(tloc.median(_t(x))[0]) == 2.5 == float(jloc.median(x)[0])


@pytest.mark.parametrize("case", ["random", "zero", "negative", "nan",
                                  "uniform_even"])
def test_weighted_median_matches(case):
    k = 16
    x = _data(k, 41, seed=3)
    rng = np.random.default_rng(7)
    a = rng.uniform(0.1, 1.0, size=k).astype(np.float32)
    if case == "zero":
        a[:5] = 0.0
    elif case == "negative":
        a[2] = -0.5                      # invalid -> uniform fallback
    elif case == "nan":
        a[0] = np.nan
    elif case == "uniform_even":
        a[:] = 1.0                       # crossing exactly at 0.5
    _close(tloc.weighted_median(_t(x), _t(a)),
           jloc.weighted_median(jnp.asarray(x), jnp.asarray(a)))


def test_normalize_weights_columns_and_fallback():
    a = np.array([[1.0, 0.0, 1.0, 2.0],
                  [3.0, 0.0, -1.0, 2.0],
                  [0.0, 0.0, 1.0, np.inf]], np.float32)
    _close(tloc.normalize_weights(_t(a)),
           jloc.normalize_weights(jnp.asarray(a)))
    _close(tloc.normalize_weights(_t(a[:, 0])),
           jloc.normalize_weights(jnp.asarray(a[:, 0])))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("loss", ["tukey", "huber"])
@pytest.mark.parametrize("k", [8, 31])
def test_mm_estimate_matches(weighted, loss, k):
    x = _data(k, 53, seed=k + 1)
    a = np.random.default_rng(k).uniform(0.1, 1, size=k).astype(np.float32) \
        if weighted else None
    jres = jloc.mm_estimate(jnp.asarray(x), a=None if a is None else
                            jnp.asarray(a), loss=jmest.get_loss(loss))
    tres = tloc.mm_estimate(_t(x), a=None if a is None else _t(a),
                            loss=tmest.get_loss(loss))
    _close(tres.estimate, jres.estimate, atol=1e-5)
    _close(tres.scale, jres.scale, atol=1e-4)
    _close(tres.weights, jres.weights, atol=1e-5)


def test_mm_estimate_weight_batch_equals_per_column():
    """(K, N) weights against x (K, N, M): the reference's vmap over
    weight columns, written out as a batch axis."""
    k, n, m = 12, 4, 19
    x = _data(k, m, seed=11)
    a = np.random.default_rng(2).uniform(0.0, 1, size=(k, n)).astype(np.float32)
    a[:, 1] = 0.0                         # an invalid column
    want = jax.vmap(lambda col: jloc.mm_estimate(
        jnp.asarray(x), a=col).estimate, in_axes=1)(jnp.asarray(a))
    got = tloc.mm_estimate(_t(x).unsqueeze(1).expand(k, n, m),
                           a=_t(a)).estimate
    _close(got, want, atol=1e-5)


def test_irls_keeps_mu_when_every_weight_vanishes():
    x = np.array([[0.0], [0.0], [1e6]], np.float32)
    init = np.array([5e5], np.float32)
    scale = np.array([1.0], np.float32)
    j = jloc.m_estimate(jnp.asarray(x), init=jnp.asarray(init),
                        scale=jnp.asarray(scale), num_iters=3).estimate
    t = tloc.m_estimate(_t(x), init=_t(init), scale=_t(scale),
                        num_iters=3).estimate
    _close(t, j)
    assert float(t[0]) == 5e5


def test_bf16_median_and_mad_within_one_ulp():
    x = _data(16, 64, seed=5).astype(ml_dtypes.bfloat16)
    tx = interop.from_numpy_tree(x, "cpu")
    assert tx.dtype == torch.bfloat16
    _within_bf16_ulp(tloc.median(tx), jloc.median(jnp.asarray(x)))
    _within_bf16_ulp(tloc.mad(tx), jloc.mad(jnp.asarray(x)))


def test_from_numpy_tree_keeps_structure_and_dtypes():
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "a": [np.ones(3, np.float64), np.zeros(2, np.int32)],
            "b": np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16))}
    out = interop.from_numpy_tree(tree, "cpu")
    assert out["w"].dtype == torch.float32 and out["w"].shape == (2, 3)
    assert out["a"][0].dtype == torch.float64
    assert out["a"][1].dtype == torch.int32
    assert out["b"].dtype == torch.bfloat16
    assert out["b"].float().tolist() == [1.5, -2.25]
    leaves, _ = pytree.flatten(out)
    assert len(leaves) == len(jax.tree.leaves(tree))


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch import devices
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devices.resolve()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.from_numpy_tree({"w": np.zeros(2, np.float32)})
    assert devices.resolve("cpu").type == "cpu"


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_chip_smoke_shape_table_is_qwen3_0p6b():
    from repro.configs import qwen3_0p6b
    from repro.models import model
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shapes = jax.eval_shape(lambda: model.init_model(jax.random.key(0),
                                                     qwen3_0p6b.MODEL))
    want = [tuple(leaf.shape) for leaf in jax.tree.leaves(shapes)]
    got, _ = smoke.qwen3_shapes()
    assert got == want
    assert sum(int(np.prod(s)) for s in got) == 751_894_528
