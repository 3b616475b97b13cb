"""One Mode A train step of the port (``launch.steps.make_train_step_gspmd``)
against the reference's, and the serve steps (CPU).

K = 4 agents on the smoke Qwen3 config, agent 3 additive at +1000, on
both engine backends (``jnp``; ``pallas``, which is the kernel's plain
version on the CPU), microbatches 1 and 2, and ``mean``, ``rs_mm`` and
``gather_mm``.  Compared: the aggregate (SGD at lr 1 without clip makes
it p0 - p1 on the reference's side), loss, grad_norm and consensus; for
Adam the moments m and v (its first step is about lr * sign(g), which
amplifies float noise where |g| is near 0, so the parameters are not
compared there).  Most embedding rows see no token of any benign agent:
their gradients are exactly 0, the MAD is 0, the estimate rests on the
scale floor, and the attacker's 1000 must get Tukey weight 0 there.

Tolerances: the aggregate atol 1e-6 and rtol 1e-5 (the two estimators
sum in another order; its reference value carries the cancellation of
p0 - p1 at lr 1), loss rtol 1e-6, grad_norm and consensus rtol 1e-5,
Adam m and v rtol 1e-5 with atol 1e-5 of the leaf's largest moment
(coordinates near 0 carry the estimate's noise at the leaf's scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import attacks as jatt
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro.optim import optimizers as JO
from repro_torch import configs as tconfigs
from repro_torch import interop, pytree
from repro_torch.core import attacks as tatt
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.optim import optimizers as TO


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: in a parallel run each worker's default
    pool spins against the other workers', and these small-tensor tests
    ran 30-50x slower there than alone (alone, one thread is as fast)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K = 4


def _setup(seed=0):
    jcfg = jconfigs.load_smoke("qwen3_0p6b")
    tcfg = tconfigs.load_smoke("qwen3_0p6b")
    jp = JM.init_model(jax.random.key(seed), jcfg)
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (2 * K, 9)).astype(np.int32)
    return jcfg, tcfg, jp, toks


def _port_params(jp):
    return interop.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("backend,microbatches,aggregation,optimizer", [
    ("jnp", 1, "rs_mm", "sgd"),
    ("pallas", 1, "rs_mm", "adam"),
    ("pallas", 2, "gather_mm", "sgd"),
    ("jnp", 2, "mean", "sgd"),
])
def test_train_step_matches_the_reference(backend, microbatches, aggregation,
                                          optimizer):
    jcfg, tcfg, jp, toks = _setup()
    kw = dict(microbatches=microbatches, aggregation=aggregation,
              use_kernel=backend == "pallas")
    okw = dict(name=optimizer, learning_rate=1.0 if optimizer == "sgd" else 1e-2,
               grad_clip=0.0 if optimizer == "sgd" else 1.0, warmup_steps=0,
               schedule_kind="constant")
    byz = dict(num_malicious=1, attack="additive",
               attack_kwargs=(("delta", 1000.0),))
    jstep, _ = JS.make_train_step_gspmd(
        jcfg, jconfigs.ParallelConfig(**kw), JO.OptimizerConfig(**okw),
        make_host_mesh(), jatt.ByzantineConfig(**byz), k_agents=K,
        consensus_metric=True)
    jopt = JO.init(JO.OptimizerConfig(**okw), jp)
    jp1, jopt1, jm = jax.jit(jstep)(jp, jopt, {"tokens": jnp.asarray(toks)})

    tp = _port_params(jp)
    ocfg = TO.OptimizerConfig(**okw)
    tstep = TS.make_train_step_gspmd(
        tcfg, tconfigs.ParallelConfig(**kw), ocfg, "cpu",
        tatt.ByzantineConfig(**byz), k_agents=K, consensus_metric=True)
    tp1, topt1, tm = tstep(tp, TO.init(ocfg, tp), {"tokens": torch.from_numpy(toks)})

    assert tp1 is tp and topt1.step == 1 == int(jopt1.step)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["consensus"]), float(jm["consensus"]),
                               rtol=1e-5)
    names = pytree.leaf_paths(tp)
    agg = dict(zip(names, tstep.last_aggregate))
    stacks = dict(zip(names, tstep.last_stacks))
    if optimizer == "sgd":
        p0 = dict(zip(names, jax.tree.leaves(jp)))
        p1 = dict(zip(names, jax.tree.leaves(jp1)))
        for name in names:
            want = np.asarray(p0[name]) - np.asarray(p1[name])
            np.testing.assert_allclose(interop.to_numpy(agg[name]), want,
                                       atol=1e-6, rtol=1e-5, err_msg=name)
    else:
        for tree, jtree in ((topt1.m, jopt1.m), (topt1.v, jopt1.v)):
            for a, b in zip(pytree.flatten(tree)[0], jax.tree.leaves(jtree)):
                b = np.asarray(b)
                np.testing.assert_allclose(interop.to_numpy(a), b, rtol=1e-5,
                                           atol=1e-5 * np.abs(b).max())
    # the attacker's row carries the shift on every leaf
    assert float(stacks["ln_f"][K - 1].min()) > 900.0
    if aggregation != "mean":
        # embedding rows no benign agent touched: zero MAD, estimate 0
        emb = stacks["embed"].reshape(K, -1)
        untouched = (emb[:K - 1] == 0).all(dim=0)
        assert int(untouched.sum()) > emb.shape[1] // 2
        assert bool((agg["embed"].reshape(-1)[untouched] == 0).all())


def test_step_phases_errors_and_agents():
    _, tcfg, jp, toks = _setup(1)
    par = tconfigs.ParallelConfig()
    ocfg = TO.OptimizerConfig()
    step = TS.make_train_step_gspmd(tcfg, par, ocfg, "cpu", k_agents=3)
    tp = _port_params(jp)
    with pytest.raises(ValueError, match="3 agents"):
        step(tp, TO.init(ocfg, tp), {"tokens": torch.from_numpy(toks)})
    assert step.phase_ms() == {}         # no CUDA events off the card
    # Mode A ignores the fsdp flag, as the reference's does (Mode B is
    # make_train_step_fsdp): the same step either way
    aggs = []
    for fsdp in (False, True):
        tp_f = _port_params(jp)
        st = TS.make_train_step_gspmd(
            tcfg, tconfigs.ParallelConfig(fsdp=fsdp), ocfg, "cpu", k_agents=2)
        st(tp_f, TO.init(ocfg, tp_f), {"tokens": torch.from_numpy(toks)})
        aggs.append(st.last_aggregate)
    assert all(torch.equal(a, b) for a, b in zip(*aggs))
    krum = TS.make_train_step_gspmd(
        tcfg, tconfigs.ParallelConfig(aggregation="krum"), ocfg, "cpu",
        k_agents=2)
    with pytest.raises(ValueError, match="unknown aggregation"):
        krum(tp, TO.init(ocfg, tp), {"tokens": torch.from_numpy(toks)})
    # the model module and its tree are the same parameters
    model = TM.Model(tcfg, tp)
    step1 = TS.make_train_step_gspmd(tcfg, par, ocfg, "cpu", k_agents=2)
    before = model.tree()["ln_f"].detach().clone()
    out, _, m = step1(model, TO.init(ocfg, model.tree()),
                      {"tokens": torch.from_numpy(toks)})
    assert out is model and "consensus" not in m
    assert not torch.equal(model.tree()["ln_f"], before)


def test_serve_steps_match_the_reference():
    jcfg, tcfg, jp, toks = _setup(2)
    tp = _port_params(jp)
    mesh = make_host_mesh()
    want = jax.jit(JS.make_prefill_step(jcfg, mesh))(
        jp, {"tokens": jnp.asarray(toks[:, :8])})
    got = TS.make_prefill_step(tcfg, "cpu")(tp, {"tokens": torch.from_numpy(
        toks[:, :8])})
    assert got.shape == (2 * K, 1, jcfg.padded_vocab)
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                               atol=2e-5, rtol=1e-5)
    jdec = jax.jit(JS.make_decode_step(jcfg, mesh))
    tdec = TS.make_decode_step(tcfg, "cpu")
    jc = JM.init_cache(jcfg, 2 * K, 12)
    tc = TM.init_cache(tcfg, 2 * K, 12, device="cpu")
    jt = jnp.asarray(toks[:, :1])
    tt = torch.from_numpy(toks[:, :1])
    for _ in range(5):
        jt, jc = jdec(jp, jt, jc)
        tt, tc = tdec(tp, tt, tc)
        assert tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(interop.to_numpy(tc["blocks"]["v"]),
                               np.asarray(jc["blocks"]["v"]), atol=2e-5)


def test_a_step_frees_its_stacks_without_the_cycle_collector():
    """The stacks are the step's largest buffers (24 GB at full width):
    dropping them must free them at once, with no reference cycle (a
    self-calling closure in the pytree walks was one) keeping them for
    the cyclic garbage collector."""
    import gc
    import weakref
    _, tcfg, jp, toks = _setup(3)
    tp = _port_params(jp)
    ocfg = TO.OptimizerConfig()
    step = TS.make_train_step_gspmd(
        tcfg, tconfigs.ParallelConfig(use_kernel=True), ocfg, "cpu",
        tatt.ByzantineConfig(num_malicious=1), k_agents=K,
        consensus_metric=True)
    batch = {"tokens": torch.from_numpy(toks)}
    opt = step(tp, TO.init(ocfg, tp), batch)[1]   # first call: lazy imports
    gc.collect()
    gc.disable()
    try:
        step(tp, opt, batch)
        refs = [weakref.ref(t) for t in step.last_stacks + step.last_aggregate]
        step.last_stacks = step.last_aggregate = None
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
