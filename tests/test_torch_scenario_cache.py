"""The scenario runner's executable cache, ``ScenarioResult.to_row``,
``registry.as_lowering``, ``metrics.assert_finite`` and the thin public
helpers (``aggregate_pytree``, ``run_diffusion``, ``run_federated``) of
the port, against the JAX package where it has a counterpart (CPU).

A cache hit reuses the lowering of an identical spec: its histories must
be bit-equal to the miss's, since every run starts from a fresh copy of
the initial state and the warm-up step of a miss draws from a generator
of its own.  The loops are held to the reference on a deterministic
gradient (full-batch least squares, no noise) under the additive
attack, with rtol 1e-4 and atol 1e-6 over 50 steps: the two frameworks
sum in another order, and the differences compound step by step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro.core import aggregators as jagg
from repro.core import attacks as jatt
from repro.core import diffusion as jdiff
from repro.core import federated as jfed
from repro.core import graph as jgraph
from repro.scenarios import metrics as jmetrics
from repro_torch import interop, scenarios
from repro_torch.core import aggregators as tagg
from repro_torch.core import attacks as tatt
from repro_torch.core import diffusion as tdiff
from repro_torch.core import federated as tfed
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import tuning
from repro_torch.scenarios import metrics, registry, runner

K, DIM = 8, 6
TINY = dict(num_agents=K, dim=DIM, num_steps=15, step_size=0.05)


@pytest.fixture(autouse=True)
def empty_caches(monkeypatch):
    monkeypatch.setattr(tuning, "_CACHE", {})
    runner.clear_executable_cache()
    yield
    runner.clear_executable_cache()


def _run(spec, **kw):
    return scenarios.run(spec, device="cpu", **kw)


def _equal_histories(r1, r2):
    assert r1.history.keys() == r2.history.keys()
    for name in r1.history:
        np.testing.assert_array_equal(r1.history[name], r2.history[name])


# ---------------------------------------------------------------------------
# the executable cache (tests/test_scenarios.py's, on the port)
# ---------------------------------------------------------------------------

def test_second_run_of_identical_spec_hits_the_cache():
    sp = scenarios.ScenarioSpec(paradigm="diffusion", aggregator="mm_tukey",
                                backend="pallas", num_malicious=2,
                                num_agents=K, dim=DIM, num_steps=9)
    r1 = _run(sp)
    r2 = _run(sp)
    assert not r1.compile_cache_hit and r1.compile_s > 0.0
    assert r2.compile_cache_hit and r2.compile_s == 0.0
    assert r2.wall_clock_s > 0.0 and runner.executable_cache_size() == 1
    _equal_histories(r1, r2)
    assert r1.launch_audit == r2.launch_audit and r1.launch_audit
    assert r2.to_row()["compile_cache_hit"] is True
    # a different spec is a miss, and so is another device name
    r3 = _run(scenarios.ScenarioSpec(
        paradigm="diffusion", aggregator="mm_tukey", backend="pallas",
        num_malicious=2, num_agents=K, dim=DIM, num_steps=8))
    assert not r3.compile_cache_hit and runner.executable_cache_size() == 2
    assert runner._exec_cache_key(sp, "cpu") != \
        runner._exec_cache_key(sp, "cuda:0")
    runner.clear_executable_cache()
    assert runner.executable_cache_size() == 0
    assert not _run(sp).compile_cache_hit


def test_the_cache_keys_on_the_tuning_state():
    """A new tuning winner changes the launch geometry a lowering's steps
    resolve: the cache must miss and the audit show the new tile."""
    sp = scenarios.ScenarioSpec(paradigm="diffusion", aggregator="mm_tukey",
                                backend="pallas", num_agents=K, dim=DIM,
                                num_steps=7)
    r1 = _run(sp)
    tuning.set_blocks(K, DIM, K, torch.float32, (64, None))
    r2 = _run(sp)
    assert not r2.compile_cache_hit
    assert r2.launch_audit["block_m"] == 64
    assert r1.launch_audit["block_m"] != 64


def test_w0_override_hits_the_cache():
    sp = scenarios.ScenarioSpec(paradigm="federated", aggregator="mm_tukey",
                                num_agents=K, dim=DIM, num_steps=6)
    r1 = _run(sp)
    r2 = _run(sp, w0=np.ones(DIM, np.float32))
    assert r2.compile_cache_hit
    assert not np.array_equal(r1.history["msd"], r2.history["msd"])
    assert r2.finite()
    _equal_histories(r1, _run(sp))      # the override left state0 alone


def test_the_cache_is_least_recently_used(monkeypatch):
    monkeypatch.setattr(runner, "_EXEC_CACHE_MAX", 2)
    specs = [scenarios.ScenarioSpec(paradigm="federated", num_agents=K,
                                    dim=DIM, num_steps=2, seed=s)
             for s in range(3)]
    _run(specs[0])
    _run(specs[1])
    assert _run(specs[0]).compile_cache_hit       # 0 is now the newest
    _run(specs[2])                                # evicts 1
    assert runner.executable_cache_size() == 2
    assert _run(specs[0]).compile_cache_hit
    assert not _run(specs[1]).compile_cache_hit


@pytest.mark.parametrize("model_config,kw", [
    ("paper_lsq", dict(num_agents=K, dim=DIM, num_steps=6,
                       num_malicious=2)),
    ("qwen3-0.6b", dict(num_agents=2, num_steps=2, num_malicious=1,
                        paradigm_kwargs=(("batch_per_agent", 1),
                                         ("seq_len", 8)))),
])
def test_substrate_runs_twice_from_a_pristine_state(model_config, kw):
    """The substrate's optimizers update parameters (and Adam's moments)
    in place: a cached lowering must still start every run from the
    initial state, so the two histories are bit-equal."""
    sp = scenarios.ScenarioSpec(paradigm="substrate", backend="pallas",
                                model_config=model_config, **kw)
    r1 = _run(sp)
    r2 = _run(sp)
    assert not r1.compile_cache_hit and r2.compile_cache_hit
    _equal_histories(r1, r2)
    assert r1.launch_audit == r2.launch_audit and r1.launch_audit


# ---------------------------------------------------------------------------
# to_row, as_lowering, assert_finite
# ---------------------------------------------------------------------------

def test_to_row_has_the_reference_keys_and_the_device():
    kw = dict(paradigm="diffusion", aggregator="mm_tukey", num_malicious=1,
              num_agents=K, dim=DIM, num_steps=4)
    row = _run(scenarios.ScenarioSpec(**kw)).to_row()
    jrow = jscenarios.run(jscenarios.ScenarioSpec(**kw)).to_row()
    assert set(row) == set(jrow) | {"device"} and row["device"] == "cpu"
    same = ("name", "paradigm", "topology", "aggregator", "backend", "attack",
            "num_malicious", "schedule", "data", "num_agents", "dim",
            "num_steps", "seed", "compile_cache_hit", "model_config",
            "broke_down", "finite", "launch_audit")
    assert {k: row[k] for k in same} == {k: jrow[k] for k in same}
    json.dumps(row, allow_nan=False)


def test_to_row_is_strict_json_even_when_broken_down():
    sp = scenarios.ScenarioSpec(
        paradigm="diffusion", aggregator="mean", attack="scale",
        num_malicious=2, attack_kwargs=(("gamma", 1e18),),
        **{**TINY, "num_steps": 40})
    res = _run(sp)
    row = res.to_row()
    json.dumps(row, allow_nan=False)       # no Infinity/NaN tokens
    assert not res.finite() and row["finite"] is False
    assert row["final_msd"] is None and row["broke_down"] is True


def test_as_lowering_takes_both_adapter_forms(monkeypatch):
    low = registry.Lowering(state0=1, step_fn=print)
    assert registry.as_lowering(low) is low
    legacy = registry.as_lowering((2, print))
    assert (legacy.state0, legacy.step_fn, legacy.finalize,
            legacy.breakdown_level) == (2, print, None, None)
    # an adapter returning the legacy tuple runs through the runner
    sp = scenarios.ScenarioSpec(paradigm="diffusion", **TINY)
    want = _run(sp)
    runner.clear_executable_cache()
    adapter = registry.get_paradigm("diffusion")

    def tuple_adapter(spec, device):
        full = adapter(spec, device)
        return full.state0, full.step_fn

    monkeypatch.setitem(registry._PARADIGMS, "diffusion", tuple_adapter)
    _equal_histories(_run(sp), want)


def test_assert_finite_matches_the_reference():
    ok = {"msd": np.ones(3, np.float32)}
    metrics.assert_finite(ok, "x")
    jmetrics.assert_finite(ok, "x")
    bad = {"msd": np.ones(3), "loss": np.array([1.0, np.inf])}
    for fn in (metrics.assert_finite, jmetrics.assert_finite):
        for label, where in (("spec-a", "spec-a"), ("", "<run>")):
            with pytest.raises(AssertionError,
                               match=f"non-finite metric 'loss' in "
                                     f"scenario {where}"):
                fn(bad, label)


def test_package_exports_the_reference_names():
    for name in ("attack_summary", "breakdown_threshold", "Lowering",
                 "get_paradigm", "paradigm_names", "register_paradigm",
                 "LSQ_SUBSTRATE", "SUBSTRATE_AGGREGATORS", "run",
                 "ScenarioSpec", "ScenarioResult", "BACKENDS", "PARADIGMS",
                 "steady"):
        assert hasattr(jscenarios, name) and hasattr(scenarios, name), name
    assert scenarios.LSQ_SUBSTRATE == jscenarios.LSQ_SUBSTRATE
    assert scenarios.SUBSTRATE_AGGREGATORS == jscenarios.SUBSTRATE_AGGREGATORS
    # the reference's own paradigms: a test module of the reference
    # registers more in the same process (test_scenarios.py's
    # constant_drift), which the port is not asked to export
    own = {name for name in jscenarios.paradigm_names()
           if jscenarios.get_paradigm(name).__module__.startswith("repro.")}
    assert set(jscenarios.PARADIGMS) <= own
    assert own <= set(scenarios.paradigm_names())


# ---------------------------------------------------------------------------
# the thin public helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,weighted", [("mm_tukey", False),
                                           ("mm_tukey", True),
                                           ("median", True),
                                           ("mm_pallas", True)])
def test_aggregate_pytree_matches_the_reference(name, weighted):
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(K, 3, 2)).astype(np.float32),
            "b": {"c": rng.normal(size=(K, 5)).astype(np.float32)}}
    tree["a"][-2:] += 1000.0
    a = rng.uniform(0.1, 1, size=K).astype(np.float32) if weighted else None
    want = jagg.aggregate_pytree(jax.tree.map(jnp.asarray, tree), name,
                                 None if a is None else jnp.asarray(a))
    got = tagg.aggregate_pytree(interop.from_numpy_tree(tree, "cpu"), name,
                                None if a is None else torch.from_numpy(a))
    for g, w in ((got["a"], want["a"]), (got["b"]["c"], want["b"]["c"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-6)
    fn = tagg.get_aggregator("mean")
    out = tagg.aggregate_pytree(interop.from_numpy_tree(tree, "cpu"), fn)
    np.testing.assert_allclose(out["b"]["c"].numpy(),
                               tree["b"]["c"].mean(0), atol=1e-6)


def _lsq(seed=5):
    """A deterministic full-batch least-squares gradient per agent:
    R_k (w_k - w*) with R_k = B_k B_k^T / M + I / 2."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(K, DIM, DIM)).astype(np.float32)
    r = (np.einsum("kij,klj->kil", b, b) / DIM
         + 0.5 * np.eye(DIM, dtype=np.float32)).astype(np.float32)
    w_star = rng.normal(size=DIM).astype(np.float32)
    return r, w_star


BYZ = dict(num_malicious=2, attack="additive",
           attack_kwargs=(("delta", 100.0),))


def test_run_diffusion_matches_the_reference():
    r, w_star = _lsq()
    comb = jgraph.combination_matrix(jgraph.ring(K, hops=2), "metropolis")
    jr, tr = jnp.asarray(r), torch.from_numpy(r)
    jw, tw = jnp.asarray(w_star), torch.from_numpy(w_star)
    jcfg = jdiff.DiffusionConfig(step_size=0.05, aggregator="mm_tukey",
                                 byzantine=jatt.ByzantineConfig(**BYZ))
    tcfg = tdiff.DiffusionConfig(step_size=0.05, aggregator="mm_tukey",
                                 byzantine=tatt.ByzantineConfig(**BYZ))
    w_j, h_j = jdiff.run_diffusion(
        grad_fn=lambda w, key: jnp.einsum("kij,kj->ki", jr, w - jw),
        combination=comb, config=jcfg, w_star=jw, num_iters=50,
        key=jax.random.key(0), log_every=5)
    w_t, h_t = tdiff.run_diffusion(
        grad_fn=lambda w, gen: torch.einsum("kij,kj->ki", tr, w - tw),
        combination=comb, config=tcfg, w_star=tw, num_iters=50,
        generator=torch.Generator().manual_seed(0), log_every=5)
    assert h_t.shape == np.asarray(h_j).shape == (10,)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-4,
                               atol=1e-6)
    assert float(h_t[-1]) < 1e-2 < float(h_t[0])    # the attack is survived


def test_run_federated_matches_the_reference():
    r, w_star = _lsq(6)
    jr, tr = jnp.asarray(r), torch.from_numpy(r)
    jw, tw = jnp.asarray(w_star), torch.from_numpy(w_star)
    kw = dict(num_clients=K, clients_per_round=K, local_steps=3,
              step_size=0.05, aggregator="mm_tukey")
    jcfg = jfed.FederatedConfig(byzantine=jatt.ByzantineConfig(**BYZ), **kw)
    tcfg = tfed.FederatedConfig(byzantine=tatt.ByzantineConfig(**BYZ), **kw)
    w_j, h_j = jfed.run_federated(
        # vmapped over the cohort: one client's (M,) model and index
        grad_fn=lambda w, idx, key: jr[idx] @ (w - jw),
        config=jcfg, w_star=jw, num_rounds=50, key=jax.random.key(0))
    w_t, h_t = tfed.run_federated(
        grad_fn=lambda w, idx, gen: torch.einsum("kij,kj->ki", tr[idx],
                                                 w - tw),
        config=tcfg, w_star=tw, num_rounds=50,
        generator=torch.Generator().manual_seed(0))
    assert h_t.shape == (50,)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-4,
                               atol=1e-6)


def test_diffusion_spec_matches_the_wrapper_bitwise():
    """One spec reproduces ``run_diffusion`` on the same generator, bit
    for bit (the runner's warm-up step draws from its own generator)."""
    sp = scenarios.ScenarioSpec(
        paradigm="diffusion", aggregator="mm_tukey", attack="additive",
        num_malicious=2, attack_kwargs=(("delta", 100.0),), seed=3, **TINY)
    res = _run(sp)
    prob = tsyn.LinearModelProblem(dim=DIM, noise_var=0.01, seed=0)
    cfg = tdiff.DiffusionConfig(
        step_size=0.05, aggregator="mm_tukey",
        byzantine=tatt.ByzantineConfig(**BYZ))
    _, hist = tdiff.run_diffusion(
        grad_fn=tsyn.make_stacked_grad_fn(prob, K, device="cpu"),
        combination=sp.combination(), config=cfg,
        w_star=prob.w_star("cpu"), num_iters=15,
        generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(hist.numpy(), res.history["msd"])
