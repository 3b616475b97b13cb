"""The port's compiled programs on the CPU: the tree-layout cache,
``AggregationEngine.lower_tree`` (``LoweredTree``, ``TreeProgram``), leaf
donation, and ``runner.trace_spec`` / ``ScenarioProgram``, against the
JAX package where it has a counterpart.

On the CPU a compiled object runs the engine's eager code, so a tree
program's estimate equals ``aggregate_tree``'s bit for bit, and both
are held to the JAX engine's ``aggregate_tree`` in interpret mode at the
reference's own tolerance (atol 1e-6, ``tests/test_kernels.py:320``),
with and without donation.  The CUDA graphs themselves are checked on
the card by ``chip_smoke.py`` (phases width, paper and cohort); here a
stub graph checks the launch bookkeeping of a replay.
"""

import collections
import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro.kernels import ops as jops
from repro.scenarios import runner as jrunner
from repro_torch import scenarios
from repro_torch.core import federated as tfed
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import launches
from repro_torch.kernels import mm_aggregate as mk
from repro_torch.kernels import ops
from repro_torch.scenarios import runner

K = 8


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(K, 16, 4)).astype(np.float32),
            "b": rng.normal(size=(K, 5)).astype(np.float32),
            "s": rng.normal(size=(K,)).astype(np.float32)}
    for leaf in tree.values():
        leaf[-1] += 1000.0                       # one outlying agent
    return tree


def _tree(seed=0):
    return {k: torch.tensor(v) for k, v in _np_tree(seed).items()}


def _weights():
    return np.linspace(0.5, 1.5, K).astype(np.float32)


def _assert_trees_equal(got, want):
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name


# ---------------------------------------------------------------------------
# the tree program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_tree_program_equals_aggregate_tree_bitwise(weighted):
    a = torch.tensor(_weights()) if weighted else None
    eng = ops.AggregationEngine()
    want = eng.aggregate_tree(_tree(), a)
    program = eng.lower_tree(_tree(), a).compile()
    _assert_trees_equal(program(_tree(), a), want)
    # a second tree of the layout replays the same program
    _assert_trees_equal(program(_tree(1), a), eng.aggregate_tree(_tree(1), a))
    assert program.replays == 2 and program.graph is None


@pytest.mark.parametrize("donate", [False, True])
def test_tree_paths_match_the_jax_engine(donate):
    a = _weights()
    jtree = {k: jnp.asarray(v) for k, v in _np_tree().items()}
    want = jops.AggregationEngine(interpret=True).aggregate_tree(
        jtree, jnp.asarray(a))
    eng = ops.AggregationEngine(donate_leaves=donate)
    eager = eng.aggregate_tree(_tree(), torch.tensor(a))
    compiled = eng.lower_tree(_tree(), torch.tensor(a)).compile()(
        _tree(), torch.tensor(a))
    for name in want:
        for got in (eager, compiled):
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]), atol=1e-6,
                                       err_msg=name)


def test_donated_leaves_raise_on_read_plain_ones_do_not():
    plain = _tree()
    ops.AggregationEngine().aggregate_tree(plain)
    assert all(float(v.abs().sum()) > 0 for v in plain.values())
    eng = ops.AggregationEngine(donate_leaves=True)
    for run in (eng.aggregate_tree,
                lambda t: eng.lower_tree(_tree()).compile()(t)):
        tree = _tree()
        run(tree)
        for leaf in tree.values():
            assert isinstance(leaf, ops.DonatedTensor)
            assert leaf.untyped_storage().nbytes() == 0
            assert leaf.shape[0] == K and leaf.dtype == torch.float32
            with pytest.raises(RuntimeError, match="donated"):
                leaf.sum()
            with pytest.raises(RuntimeError, match="donated"):
                leaf.clone()
            assert "released" in repr(leaf)
        # a donated tree is consumed: handing it over again raises
        with pytest.raises(RuntimeError, match="donated"):
            run(tree)


@pytest.mark.parametrize("donate", [False, True])
def test_lowered_tree_donated_mirrors_the_setting(donate):
    low = ops.AggregationEngine(donate_leaves=donate).lower_tree(_tree())
    assert low.donated == (donate,) * 3
    jtree = {k: jnp.asarray(v) for k, v in _np_tree().items()}
    lowered = jops.AggregationEngine(
        interpret=True, donate_leaves=donate).lower_tree(jtree)
    infos = jax.tree.leaves(lowered.args_info,
                            is_leaf=lambda x: hasattr(x, "donated"))
    jflags = [bool(i.donated) for i in infos if hasattr(i, "donated")]
    assert tuple(jflags) == low.donated


def test_leaves_on_one_storage_are_released_after_the_last():
    base = torch.tensor(np.random.default_rng(3).normal(
        size=(K, 30)).astype(np.float32))
    want = ops.AggregationEngine().aggregate_tree(
        {"a": base[:, :10].clone(), "b": base[:, 10:].clone()})
    tree = {"a": base[:, :10], "b": base[:, 10:]}
    got = ops.AggregationEngine(donate_leaves=True).aggregate_tree(tree)
    _assert_trees_equal(got, want)
    assert base.untyped_storage().nbytes() == 0
    assert all(isinstance(v, ops.DonatedTensor) for v in tree.values())


@pytest.mark.parametrize("path", ["eager", "program"])
def test_leaves_torch_does_not_own_are_refused_before_staging(path):
    """A numpy-backed leaf cannot be released: donating it raises and no
    leaf of the tree is taken over."""
    eng = ops.AggregationEngine(donate_leaves=True)
    run = eng.aggregate_tree if path == "eager" else \
        eng.lower_tree(_tree()).compile()
    tree = dict(_tree(), w=torch.from_numpy(_np_tree()["w"]))
    with pytest.raises(ValueError, match="leaf 2 .* cannot be donated"):
        run(tree)
    assert not any(isinstance(v, ops.DonatedTensor) for v in tree.values())
    assert all(v.untyped_storage().nbytes() > 0 for v in tree.values())


def test_engine_caches_tree_layout():
    """The reference's test_engine_caches_tree_layout, on the port."""
    tree = {"w": torch.ones((4, 8)), "b": torch.zeros((4, 3))}
    eng = ops.AggregationEngine()
    eng.aggregate_tree(tree)
    assert len(eng._layouts) == 1
    eng.aggregate_tree({k: v + 1.0 for k, v in tree.items()})
    assert len(eng._layouts) == 1      # same structure -> cached plan
    eng.lower_tree(tree)
    assert len(eng._layouts) == 1
    eng.aggregate_tree({"w": torch.ones((4, 9)), "b": torch.zeros((4, 3))})
    assert len(eng._layouts) == 2      # new shapes -> new plan


def test_a_cached_layout_is_not_rebuilt(monkeypatch):
    built = []

    class Counted(ops._TreeLayout):
        def __init__(self, *args):
            built.append(args)
            super().__init__(*args)

    monkeypatch.setattr(ops, "_TreeLayout", Counted)
    eng = ops.AggregationEngine()
    first = eng.lower_tree(_tree()).layout
    eng.aggregate_tree(_tree(1))
    program = eng.lower_tree(_tree(2)).compile()
    program(_tree(3))
    assert len(built) == 1 and eng.lower_tree(_tree()).layout is first


def test_tree_program_refuses_another_layout():
    program = ops.AggregationEngine().lower_tree(_tree()).compile()
    others = [
        {k: v for k, v in _tree().items() if k != "s"},
        dict(_tree(), b=torch.zeros((K, 6))),
        dict(_tree(), b=torch.zeros((K, 5), dtype=torch.bfloat16)),
    ]
    for tree in others:
        with pytest.raises(ValueError, match="layout"):
            program(tree)
    with pytest.raises(ValueError, match="weights"):
        program(_tree(), torch.ones(K))


def _stub_tree_program():
    program = ops.AggregationEngine().lower_tree(_tree()).compile()
    program.outputs = [torch.zeros(5), torch.zeros(()), torch.zeros(16, 4)]
    return program, lambda: program(_tree()), (K, 85, 1), 1


def _stub_launch_program():
    program = ops.AggregationEngine().lower_launch(K, 10,
                                                   device="cpu").compile()
    program.out = torch.zeros(10)
    return program, program.replay, (K, 10, 1), 1


def _stub_scenario_program():
    spec = scenarios.ScenarioSpec(**SPECS["diffusion"],
                                  aggregator="mm_tukey", backend="pallas")
    program, records = runner.trace_spec(spec, device="cpu")
    program.state = copy.deepcopy(program.state0)
    (shape,) = {(r["k"], r["m"], r["n"]) for r in records}
    return program, lambda: program.replay(seed=spec.seed), shape, \
        spec.num_steps


@pytest.mark.parametrize("make", [_stub_tree_program, _stub_launch_program,
                                  _stub_scenario_program],
                         ids=["tree", "launch", "scenario"])
def test_program_replays_count_their_captured_launches(make):
    """A captured program counts its graph's launch keys in the tally on
    every replay (a stub graph stands in for the card's)."""
    program, replay, (k, m, n), per_replay = make()
    key = (mk.launch_plan(k, m, n).variant or "two_pass", k, m, n)
    program.graph = types.SimpleNamespace(replay=lambda: None)
    program.launches = collections.Counter({key: per_replay})
    with launches.uncounted():
        before = launches.COUNTS.copy()
        replay()
        replay()
        assert launches.COUNTS - before == \
            collections.Counter({key: 2 * per_replay})


# ---------------------------------------------------------------------------
# trace_spec and the scenario program
# ---------------------------------------------------------------------------

SPECS = {
    "diffusion": dict(paradigm="diffusion", num_agents=5, dim=4,
                      num_steps=3, attack="additive", num_malicious=1),
    "federated": dict(paradigm="federated", num_agents=6, dim=4,
                      num_steps=3, attack="sign_flip", num_malicious=1),
    "sharded": dict(paradigm="sharded", num_agents=5, dim=4, num_steps=3,
                    attack="additive", num_malicious=1),
}
_FIELDS = ("k", "m", "n", "dtype", "backend")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_trace_spec_records_match_the_reference(name):
    kw = dict(SPECS[name], aggregator="mm_tukey", backend="pallas")
    _, jrecords = jrunner.trace_spec(jscenarios.ScenarioSpec(**kw))
    program, records = runner.trace_spec(scenarios.ScenarioSpec(**kw),
                                         device="cpu")
    assert len(records) == len(jrecords) > 0
    assert sorted(tuple(r[f] for f in _FIELDS) for r in records) == \
        sorted(tuple(r[f] for f in _FIELDS) for r in jrecords)
    assert program.records == records and not program.captured
    assert set(program.timings) == {"warm_up_s"}


def test_trace_spec_leaves_state_and_generators_alone():
    sp = scenarios.ScenarioSpec(**SPECS["federated"])
    w0 = torch.full((4,), 0.5)
    rng = torch.get_rng_state()
    program, _ = runner.trace_spec(sp, w0=w0, device="cpu")
    assert torch.equal(w0, torch.full((4,), 0.5))
    assert torch.equal(torch.get_rng_state(), rng)
    fresh = torch.Generator().manual_seed(sp.seed)
    assert torch.equal(program.generator.get_state(), fresh.get_state())
    assert torch.equal(program.state0, w0) and program.state0 is not w0


def test_replay_equals_the_eager_loop_on_the_same_lowering():
    sp = scenarios.ScenarioSpec(**dict(SPECS["diffusion"], num_steps=6,
                                       aggregator="mm_tukey",
                                       backend="pallas"))
    low, state, gen = runner._lowered_state(sp, torch.device("cpu"))
    _, hist = runner.loop(low.step_fn, state, gen, sp.num_steps)
    runner.clear_executable_cache()
    try:
        for _ in range(2):                 # a miss, then a hit
            res = scenarios.run(sp, device="cpu")
            np.testing.assert_array_equal(
                res.history["msd"], torch.stack(hist["msd"]).numpy())
    finally:
        runner.clear_executable_cache()


def test_federated_client_weights_are_built_once_and_unchanged():
    """run_federated stages the client weights once in its lowering; the
    history is bit-equal to rounds that copy them from the host."""
    problem = tsyn.LinearModelProblem(dim=4, seed=0)
    grad = tsyn.make_client_grad_fn(problem, 6, device="cpu")
    cfg = tfed.FederatedConfig(
        num_clients=6, clients_per_round=4, local_steps=2, step_size=0.05,
        aggregator="mm_tukey",
        client_weights=tuple(float(v) for v in np.linspace(1, 2, 6)))
    w_star = problem.w_star("cpu")
    _, got = tfed.run_federated(grad_fn=grad, config=cfg, w_star=w_star,
                                num_rounds=5,
                                generator=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(4)
    w, want = torch.zeros(4), []
    for i in range(5):
        w = tfed.federated_round(w, gen, grad_fn=grad, config=cfg, step=i)
        want.append(torch.sum((w - w_star) ** 2))
    assert torch.equal(got, torch.stack(want))
