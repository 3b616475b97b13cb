"""Aggregators, attacks, graphs, data and the paradigm steps of the port
against the JAX reference on identical numpy inputs (CPU).

Step parity: ``diffusion_step`` and ``federated_round`` of both packages
get the same W (through ``interop.from_numpy_tree``), a gradient that is
a fixed numpy table (plus a term in w, so the local steps matter) and
the additive attack, and agree at 1e-5.  Federated rounds sample every
client (participation 1), so the two frameworks' different permutations
only reorder a permutation-invariant aggregation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core import attacks as jatt
from repro.core import diffusion as jdiff
from repro.core import federated as jfed
from repro.core import graph as jgraph
from repro.data import synthetic as jsyn
from repro_torch import interop, scenarios
from repro_torch.core import aggregators as tagg
from repro_torch.core import attacks as tatt
from repro_torch.core import diffusion as tdiff
from repro_torch.core import federated as tfed
from repro_torch.core import graph as tgraph
from repro_torch.data import synthetic as tsyn

K, M = 8, 6


def _x(seed=0, k=K, m=M, n_bad=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, m)).astype(np.float32)
    x[-n_bad:] += 1000.0
    return x


def _close(got, want, atol=1e-5):
    # rtol: sums run in another order, and a non-robust aggregate of
    # attacked updates sits near 1000, where an f32 ulp is 6e-5
    np.testing.assert_allclose(interop.to_numpy(got),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["mean", "median", "trimmed_mean",
                                  "geometric_median", "krum", "m_huber",
                                  "mm_tukey", "ref", "mm_pallas"])
@pytest.mark.parametrize("weighted", [False, True])
def test_aggregators_match(name, weighted):
    x = _x(1)
    a = np.random.default_rng(2).uniform(0.1, 1, size=K).astype(np.float32) \
        if weighted else None
    want = jagg.get_aggregator(name)(jnp.asarray(x),
                                     None if a is None else jnp.asarray(a))
    got = tagg.get_aggregator(name)(torch.from_numpy(x),
                                    None if a is None else torch.from_numpy(a))
    atol = 1e-3 if name == "geometric_median" else 1e-5
    _close(got, want, atol=atol)


@pytest.mark.parametrize("name", ["additive", "sign_flip", "zero", "scale",
                                  "alie", "scm"])
def test_deterministic_attacks_match(name):
    x = _x(3, n_bad=0)
    mask = np.arange(K) >= K - 3
    want = jatt.get_attack(name)(jnp.asarray(x), jnp.asarray(mask),
                                 jax.random.key(0), 0)
    got = tatt.get_attack(name)(torch.from_numpy(x), torch.from_numpy(mask),
                                torch.Generator().manual_seed(0), 0)
    _close(got, want, atol=1e-4)


def test_gaussian_attack_draws_from_the_generator():
    x = torch.zeros(K, 2000)
    mask = torch.arange(K) >= K - 2
    out = tatt.gaussian(x, mask, torch.Generator().manual_seed(1), sigma=10.0)
    assert bool((out[:-2] == 0).all())
    assert abs(float(out[-2:].std()) - 10.0) < 0.5
    again = tatt.gaussian(x, mask, torch.Generator().manual_seed(1))
    assert torch.equal(out, again)


@pytest.mark.parametrize("schedule", ["static", "intermittent", "rotating"])
def test_schedules_match(schedule):
    kw = dict(num_malicious=3, schedule=schedule,
              schedule_kwargs=(("period", 2),))
    jb, tb = jatt.ByzantineConfig(**kw), tatt.ByzantineConfig(**kw)
    for step in range(9):
        assert np.array_equal(np.asarray(jb.malicious_mask(K, step)),
                              tb.malicious_mask(K, step, "cpu").numpy()), step


def test_graphs_and_problem_instance_are_bit_identical():
    for name, kw in (("ring", {"hops": 2}), ("erdos_renyi", {"seed": 3}),
                     ("small_world", {"seed": 4}), ("grid", {})):
        adj = tgraph.get_topology(name, 12, **kw)
        assert np.array_equal(adj, jgraph.get_topology(name, 12, **kw))
        for rule in ("uniform", "metropolis"):
            assert np.array_equal(tgraph.combination_matrix(adj, rule),
                                  jgraph.combination_matrix(adj, rule))
    prob = tsyn.LinearModelProblem(dim=10, seed=7)
    assert np.array_equal(prob.w_star("cpu").numpy(),
                          np.asarray(jsyn.LinearModelProblem(dim=10,
                                                             seed=7).w_star))
    for got, want in zip(tsyn.dirichlet_mixture(9, 0.3, seed=2),
                         jsyn.dirichlet_mixture(9, 0.3, seed=2)):
        assert np.array_equal(got, want)


def test_synthetic_gradients_are_lms():
    prob = tsyn.LinearModelProblem(dim=4, noise_var=0.0)
    w_star = prob.w_star("cpu")
    for data in ("iid", "dirichlet"):
        grad = tsyn.make_stacked_grad_fn(prob, 5, data=data, device="cpu")
        g = grad(w_star.expand(5, 4).clone(), torch.Generator().manual_seed(0))
        assert g.shape == (5, 4) and float(g.abs().max()) < 1e-6
        cgrad = tsyn.make_client_grad_fn(prob, 5, data=data, device="cpu")
        idx = torch.tensor([4, 0, 2])
        g = cgrad(torch.zeros(3, 4), idx, torch.Generator().manual_seed(0))
        assert g.shape == (3, 4) and bool(torch.isfinite(g).all())


@pytest.mark.parametrize("entry", [
    lambda: tsyn.LinearModelProblem(dim=4).w_star(),
    lambda: tsyn.make_stacked_grad_fn(tsyn.LinearModelProblem(dim=4), 5),
    lambda: tsyn.make_stacked_loss_grad_fn(tsyn.LinearModelProblem(dim=4), 5),
    lambda: tsyn.make_client_grad_fn(tsyn.LinearModelProblem(dim=4), 5),
    lambda: tatt.ByzantineConfig(num_malicious=1).malicious_mask(K),
    lambda: scenarios.run(scenarios.ScenarioSpec(num_agents=4, num_steps=1)),
], ids=["w_star", "stacked_grad", "stacked_loss_grad", "client_grad",
        "malicious_mask", "run"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


@pytest.mark.parametrize("aggregator", ["mm_pallas", "mm_tukey", "mean",
                                        "median"])
def test_diffusion_step_parity(aggregator):
    rng = np.random.default_rng(5)
    w = rng.normal(size=(K, M)).astype(np.float32)
    table = rng.normal(size=(K, M)).astype(np.float32)
    comb = jgraph.metropolis_weights(jgraph.ring(K, hops=2)).astype(np.float32)
    byz = dict(num_malicious=2, attack="additive",
               attack_kwargs=(("delta", 1000.0),))
    jcfg = jdiff.DiffusionConfig(step_size=0.05, aggregator=aggregator,
                                 byzantine=jatt.ByzantineConfig(**byz))
    tcfg = tdiff.DiffusionConfig(step_size=0.05, aggregator=aggregator,
                                 byzantine=tatt.ByzantineConfig(**byz))
    want = jdiff.diffusion_step(
        jnp.asarray(w), jax.random.key(0),
        grad_fn=lambda ws, key: jnp.asarray(table) + 0.1 * ws,
        combination=jnp.asarray(comb), config=jcfg)
    tw = interop.from_numpy_tree({"w": w, "comb": comb, "g": table}, "cpu")
    got = tdiff.diffusion_step(
        tw["w"], torch.Generator().manual_seed(0),
        grad_fn=lambda ws, gen: tw["g"] + 0.1 * ws,
        combination=tw["comb"], config=tcfg)
    assert got.shape == (K, M)
    _close(got, want)


@pytest.mark.parametrize("aggregator,weights", [
    ("mm_pallas", False), ("mm_pallas", True), ("mm_tukey", True),
    ("mean", False)])
def test_federated_round_parity(aggregator, weights):
    rng = np.random.default_rng(6)
    n_clients = 10
    w = rng.normal(size=M).astype(np.float32)
    table = rng.normal(size=(n_clients, M)).astype(np.float32)
    client_w = tuple(float(v) for v in rng.uniform(0.2, 1, size=n_clients)) \
        if weights else None
    kw = dict(num_clients=n_clients, clients_per_round=n_clients,
              local_steps=3, step_size=0.05, aggregator=aggregator,
              client_weights=client_w)
    byz = dict(num_malicious=2, attack="additive")
    want = jfed.federated_round(
        jnp.asarray(w), jax.random.key(1),
        grad_fn=lambda v, idx, key: jnp.asarray(table)[idx] + 0.1 * v,
        config=jfed.FederatedConfig(byzantine=jatt.ByzantineConfig(**byz),
                                    **kw))
    tt = interop.from_numpy_tree([w, table], "cpu")
    got = tfed.federated_round(
        tt[0], torch.Generator().manual_seed(1),
        grad_fn=lambda v, idx, gen: tt[1][idx] + 0.1 * v,
        config=tfed.FederatedConfig(byzantine=tatt.ByzantineConfig(**byz),
                                    **kw))
    assert got.shape == (M,)
    _close(got, want)


def test_spec_keeps_the_reference_fields_and_labels():
    from repro import scenarios as jsc
    kw = dict(paradigm="federated", aggregator="mm_tukey", backend="pallas",
              num_agents=64, participation=0.25, num_malicious=4)
    assert scenarios.ScenarioSpec(**kw).label() == jsc.ScenarioSpec(**kw).label()
    assert scenarios.ScenarioSpec(**kw).resolved_aggregator()[0] == "mm_pallas"
    with pytest.raises(ValueError, match="backend='pallas'"):
        scenarios.ScenarioSpec(aggregator="mean", backend="pallas")
    with pytest.raises(ValueError, match="participation"):
        scenarios.ScenarioSpec(paradigm="diffusion", participation=0.5)


@pytest.mark.parametrize("paradigm,queue", [("sharded", "queue 1, item 2")])
def test_unported_paradigms_name_their_roadmap_queue(paradigm, queue):
    """The last paradigm that named its ROADMAP queue (``queue``) is
    ported: its stacked lowering runs on one process, and its collective
    lowering asks for a process group instead of refusing."""
    sp = scenarios.ScenarioSpec(paradigm=paradigm, num_steps=2)
    res = scenarios.run(sp, device="cpu")
    assert res.finite() and res.history["msd"].shape == (2,)
    with pytest.raises(RuntimeError, match="process group of 16 ranks"):
        scenarios.run(scenarios.ScenarioSpec(
            paradigm=paradigm, num_steps=2,
            paradigm_kwargs=(("collective", "rs_mm"),)), device="cpu")


def test_run_audits_the_kernel_launches_and_splits_timing():
    sp = scenarios.ScenarioSpec(paradigm="diffusion", num_agents=8, dim=5,
                                aggregator="mm_tukey", backend="pallas",
                                num_malicious=2, num_steps=6,
                                attack_schedule="rotating")
    res = scenarios.run(sp, device="cpu")
    assert res.history["msd"].shape == (6,) and res.finite()
    assert res.launch_audit["path"] == "single"
    assert res.launch_audit["n_out"] == 8 and res.launch_audit["m_total"] >= 5
    assert res.compile_s > 0 and res.wall_clock_s > 0 and res.device == "cpu"
    again = scenarios.run(sp, device="cpu")
    assert np.array_equal(again.history["msd"], res.history["msd"])
    with pytest.raises(ValueError, match="w0 override"):
        scenarios.run(sp, device="cpu", w0=np.zeros(5, np.float32))


def test_legacy_loops_share_the_runner_step_functions():
    from repro_torch.scenarios import runner
    prob = tsyn.LinearModelProblem(dim=4)
    w_star = prob.w_star("cpu")
    comb = torch.as_tensor(tgraph.combination_matrix(tgraph.ring(6), "uniform"),
                           dtype=torch.float32)
    cfg = tdiff.DiffusionConfig(step_size=0.05, aggregator="mm_pallas")
    w, hist = runner.diffusion_loop(
        grad_fn=tsyn.make_stacked_grad_fn(prob, 6, device="cpu"),
        combination=comb,
        config=cfg, w_star=w_star, num_iters=40,
        generator=torch.Generator().manual_seed(0))
    assert w.shape == (6, 4) and hist["msd"].shape == (40,)
    assert float(hist["msd"][-1]) < float(hist["msd"][0])
    fcfg = tfed.FederatedConfig(num_clients=6, clients_per_round=3,
                                step_size=0.05, aggregator="mm_pallas")
    w, hist = runner.federated_loop(
        grad_fn=tsyn.make_client_grad_fn(prob, 6, device="cpu"), config=fcfg,
        w_star=w_star, num_rounds=20, generator=torch.Generator().manual_seed(0))
    assert w.shape == (4,) and float(hist["msd"][-1]) < float(hist["msd"][0])


def test_paired_sort_oracle_matches():
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(9)
    x = rng.normal(size=(9, 7)).astype(np.float32)
    w = rng.uniform(size=(9, 3, 7)).astype(np.float32)
    for carry in (w[:, 0], w):
        jx, jw = jref.paired_sort_ref(jnp.asarray(x), jnp.asarray(carry))
        tx, tw = tref.paired_sort_ref(torch.from_numpy(x),
                                      torch.from_numpy(carry))
        assert np.array_equal(tx.numpy(), np.asarray(jx))
        assert np.array_equal(tw.numpy(), np.asarray(jw))
