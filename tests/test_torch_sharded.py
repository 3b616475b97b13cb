"""The robust collectives of the port (``repro_torch.core.sharded`` over
``torch.distributed``) against the reference's shard_map collectives,
and the ``sharded`` scenario paradigm (CPU, gloo).

One spawn of K = 4 gloo ranks (``launch.mesh.run_ranks``, a 2 x 2
``(pod, data)`` mesh) runs every collective on the same numpy inputs as
the reference, which runs in a subprocess on 4 forced host devices (the
device count locks at first jax init), as ``tests/test_sharded.py``
does.  This module imports no jax at the top: the ranks import it.

Tolerance 1e-5, as ``tests/test_sharded.py`` holds the reference to its
oracle (``hier_mm``, whose pod estimates sit near 250, adds rtol 1e-6);
``rs_mm`` must equal ``gather_mm`` bit for bit in the port, on both the
flat (padded) and the dim-0 path.
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch import scenarios
from repro_torch.core import sharded
from repro_torch.launch import mesh as mesh_lib

K = 4
M_FLAT = 1037          # not a multiple of K: the flat path pads 3 zeros
TOL = 1e-5
# the sharded paradigm: the reference test's linear problem at K = 4
PARADIGM = dict(paradigm="sharded", aggregator="mm_tukey", num_agents=K,
                dim=6, num_steps=25, step_size=0.05, attack="additive",
                num_malicious=1)

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.core import sharded

    inp = dict(np.load(sys.argv[1]))
    mesh = compat.make_mesh((4,), ("data",))
    mesh2 = compat.make_mesh((2, 2), ("pod", "data"))

    def smap(fn, spec):
        return jax.jit(compat.shard_map(fn, mesh=mesh, in_specs=spec,
                                        out_specs=P(None), check_vma=False))

    out = {}
    x = jnp.asarray(inp["x"])
    for method in ("gather_mm", "rs_mm", "mean"):
        out[method] = smap(lambda v, m=method: sharded.robust_all_reduce(
            v[0], "data", method=m), P("data", None))(x)
    out["rs_mm_dim0"] = smap(lambda v: sharded.rs_mm(v[0], "data"),
                             P("data", None, None))(jnp.asarray(inp["stacks"]))
    tree = {"w": jnp.asarray(inp["tree_w"]), "b": jnp.asarray(inp["tree_b"])}
    got = jax.jit(compat.shard_map(
        lambda t: sharded.robust_all_reduce_tree(
            {k: v[0] for k, v in t.items()}, "data", method="rs_mm"),
        mesh=mesh, in_specs=({"w": P("data", None, None),
                              "b": P("data", None)},),
        out_specs={"w": P(None), "b": P(None)}, check_vma=False))(tree)
    out["tree_w"], out["tree_b"] = got["w"], got["b"]
    out["hier_mm"] = jax.jit(compat.shard_map(
        lambda v: sharded.robust_all_reduce(v[0], ("pod", "data"),
                                            method="hier_mm"),
        mesh=mesh2, in_specs=P(("pod", "data"), None), out_specs=P(None),
        check_vma=False))(x)
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""")


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    x = rng.normal(size=(K, M_FLAT)).astype(np.float32)
    x[-1] += 500.0                      # one of the four agents an outlier
    return {"x": x,
            "stacks": rng.normal(size=(K, 16, 24)).astype(np.float32),
            "tree_w": rng.normal(size=(K, 32, 6)).astype(np.float32),
            "tree_b": rng.normal(size=(K, 11)).astype(np.float32)}


def _rank(mesh, inp):
    """Every collective on this rank's row of the inputs (run by each of
    the K ranks)."""
    r = mesh.agent_index
    x = torch.from_numpy(inp["x"][r])
    stacks = torch.from_numpy(inp["stacks"][r])
    pod, data = mesh.axis("pod"), mesh.axis("data")
    out = {"axes": (pod.size, pod.index, data.size, data.index),
           "transport": sharded.transport(mesh)}
    for method in ("gather_mm", "rs_mm", "mean"):
        out[method] = sharded.robust_all_reduce(x, mesh, method=method)
    for method in ("gather_mm", "rs_mm"):
        out[f"{method}_kernel"] = sharded.robust_all_reduce(
            x, mesh, method=method, aggregator="mm_pallas")
    out["gather_mm_dim0"] = sharded.gather_mm(stacks, mesh)
    out["rs_mm_dim0"] = sharded.rs_mm(stacks, mesh)
    tree = sharded.robust_all_reduce_tree(
        {"w": torch.from_numpy(inp["tree_w"][r]),
         "b": torch.from_numpy(inp["tree_b"][r])}, mesh.agents,
        method="rs_mm")
    out["tree_w"], out["tree_b"] = tree["w"], tree["b"]
    out["hier_mm"] = sharded.robust_all_reduce(x, (pod, data),
                                               method="hier_mm")
    out["pod_estimate"] = sharded.gather_mm(x, data)
    # the bytes one flat rs_mm sends: (K-1)/K of the padded (K, 260)
    # block in the all-to-all, K-1 copies of the (260,) estimate
    before = dict(sharded.TRAFFIC)
    sharded.rs_mm(x, mesh)
    out["traffic"] = {k: sharded.TRAFFIC[k] - before[k] for k in before}
    # the sharded paradigm's collective lowering, and a spec whose agents
    # do not match the process group
    coll = scenarios.ScenarioSpec(paradigm_kwargs=(("collective", "rs_mm"),),
                                  **PARADIGM)
    out["paradigm_msd"] = scenarios.run(coll, device="cpu").history["msd"]
    try:
        scenarios.run(scenarios.ScenarioSpec(
            paradigm_kwargs=(("collective", "rs_mm"),),
            **dict(PARADIGM, num_agents=2 * K)), device="cpu")
    except RuntimeError as exc:
        out["paradigm_mismatch"] = str(exc)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = mesh_lib.run_ranks(_rank, K, inp, pods=2, timeout_s=120)
    finally:
        _, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err[-3000:]
    return inp, ranks, dict(np.load(tmp / "out.npz"))


def _close(got: torch.Tensor, want: np.ndarray, rtol: float = 0.0):
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=rtol)


@pytest.mark.parametrize("method", ["gather_mm", "rs_mm", "mean"])
def test_collectives_match_the_reference(runs, method):
    _, ranks, ref = runs
    for out in ranks:
        assert out[method].shape == (M_FLAT,)
        _close(out[method], ref[method])


@pytest.mark.parametrize("method", ["gather_mm", "rs_mm"])
def test_kernel_backend_matches_the_reference(runs, method):
    """``mm_pallas`` (the kernel's plain version on a CPU tensor) on the
    local block gives the reference's estimate."""
    _, ranks, ref = runs
    for out in ranks:
        _close(out[f"{method}_kernel"], ref[method])


def test_rs_mm_dim0_path_matches_the_reference(runs):
    _, ranks, ref = runs
    for out in ranks:
        assert out["rs_mm_dim0"].shape == (16, 24)
        _close(out["rs_mm_dim0"], ref["rs_mm_dim0"])


@pytest.mark.parametrize("path", ["", "_kernel", "_dim0"])
def test_rs_mm_equals_gather_mm_bitwise(runs, path):
    _, ranks, _ = runs
    for out in ranks:
        assert torch.equal(out["rs_mm" + path], out["gather_mm" + path])


def test_every_rank_ends_with_the_same_estimate(runs):
    _, ranks, _ = runs
    for key in ("gather_mm", "rs_mm", "mean", "rs_mm_dim0", "tree_w",
                "hier_mm"):
        for out in ranks[1:]:
            assert torch.equal(out[key], ranks[0][key]), key


def test_tree_matches_the_reference(runs):
    _, ranks, ref = runs
    for out in ranks:
        _close(out["tree_w"], ref["tree_w"])
        _close(out["tree_b"], ref["tree_b"])


def test_hier_mm_is_the_mean_of_the_pod_estimates(runs):
    """2 pods x 2: MM within each pod's data axis, the mean across pods,
    as the reference's hier_mm on a (pod, data) mesh."""
    _, ranks, ref = runs
    assert [out["axes"] for out in ranks] == [
        (2, 0, 2, 0), (2, 0, 2, 1), (2, 1, 2, 0), (2, 1, 2, 1)]
    pods = (ranks[0]["pod_estimate"] + ranks[2]["pod_estimate"]) / 2
    for out in ranks:
        # a pod holding the outlier estimates near 250 from two values,
        # where an f32 ulp is 1.5e-5: rtol 1e-6, as ROADMAP section 3
        # sets for values that sit near an attacker's shift
        _close(out["hier_mm"], ref["hier_mm"], rtol=1e-6)
        assert torch.equal(out["hier_mm"], pods)


def test_traffic_counts_and_transport(runs):
    _, ranks, _ = runs
    pad = M_FLAT + (-M_FLAT) % K
    want_a2a = pad * 4 * (K - 1) // K
    want_ag = (K - 1) * (pad // K) * 4
    for out in ranks:
        assert out["traffic"] == {"all_gather": want_ag,
                                  "all_to_all": want_a2a,
                                  "reduce_scatter": 0, "all_reduce": 0}
        assert out["transport"] == "gloo:direct"


def test_dispatch_errors():
    x = torch.zeros(8)
    with pytest.raises(ValueError,
                       match=r"hier_mm needs axis=\(outer, inner\)"):
        sharded.robust_all_reduce(x, None, method="hier_mm")
    with pytest.raises(ValueError, match=r"unknown method 'median'; known: "
                       r"\['gather_mm', 'mean', 'rs_mm', 'hier_mm'\]"):
        sharded.robust_all_reduce(x, None, method="median")
    with pytest.raises(RuntimeError, match="initialised process group"):
        mesh_lib.AgentMesh()


# ---------------------------------------------------------------------------
# the sharded paradigm
# ---------------------------------------------------------------------------

def test_sharded_collective_matches_stacked_exactly(runs):
    """Every rank's collective run is the stacked single-process run,
    bit for bit (the same generator draws the same stack everywhere)."""
    _, ranks, _ = runs
    stacked = scenarios.run(scenarios.ScenarioSpec(**PARADIGM), device="cpu")
    assert np.isfinite(stacked.history["msd"]).all()
    for out in ranks:
        np.testing.assert_array_equal(out["paradigm_msd"],
                                      stacked.history["msd"])
        assert "needs a process group of 8 ranks, have 4" in \
            out["paradigm_mismatch"]


def test_sharded_stacked_path_holds_the_reference_bands():
    """The reference's bands (tests/test_scenarios.py) over 200 steps:
    the jax and torch random streams differ, so the runs are held to the
    same bands, not to each other."""
    tiny = dict(paradigm="sharded", aggregator="mm_tukey", num_agents=8,
                dim=6, num_steps=200, step_size=0.05)
    clean = scenarios.run(scenarios.ScenarioSpec(**tiny), device="cpu")
    assert clean.history["msd"][-1] < 1e-2
    attacked = scenarios.run(scenarios.ScenarioSpec(
        attack="additive", num_malicious=2,
        attack_kwargs=(("delta", 1000.0),), **tiny), device="cpu")
    assert attacked.history["msd"][-1] < 5e-2


def test_sharded_collective_guards():
    coll = dict(PARADIGM, paradigm_kwargs=(("collective", "rs_mm"),))
    with pytest.raises(ValueError, match="backend='jnp'"):
        scenarios.run(scenarios.ScenarioSpec(**dict(coll, backend="pallas")),
                      device="cpu")
    with pytest.raises(RuntimeError, match="process group of 4 ranks, have 1"):
        scenarios.run(scenarios.ScenarioSpec(**coll), device="cpu")


# ---------------------------------------------------------------------------
# the rank launcher
# ---------------------------------------------------------------------------

def _fail_on_rank_1(mesh):
    if mesh.agent_index == 1:
        raise ArithmeticError("rank 1 gives up")
    sharded.all_reduce_sum(torch.ones(3), mesh)   # waits for rank 1
    return mesh.agent_index


def _hang_on_rank_1(mesh):
    if mesh.agent_index == 1:
        time.sleep(60)
    return mesh.agent_index


def test_run_ranks_fails_with_the_failing_rank():
    with pytest.raises(RuntimeError, match="(?s)failed.*rank 1 gives up"):
        mesh_lib.run_ranks(_fail_on_rank_1, 2, timeout_s=60)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out after 4 s"):
        mesh_lib.run_ranks(_hang_on_rank_1, 2, timeout_s=4)
    assert time.monotonic() - t0 < 30


# ---------------------------------------------------------------------------
# apply_local against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,kwargs", [
    ("additive", {}), ("additive", {"delta": 7.5}), ("sign_flip", {}),
    ("sign_flip", {"gamma": 2.0}), ("zero", {}), ("scale", {}),
])
def test_apply_local_matches_the_reference(kind, kwargs):
    import jax.numpy as jnp
    from repro.core import attacks as jatt
    from repro_torch.core import attacks as tatt
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    for mal in (True, False):
        want = jatt.apply_local({k: jnp.asarray(v) for k, v in tree.items()},
                                jnp.asarray(mal), kind, kwargs)
        tt = {k: torch.from_numpy(v) for k, v in tree.items()}
        for flag in (mal, torch.tensor(mal)):
            got = tatt.apply_local(tt, flag, kind, kwargs)
            for k in tree:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
    bf = torch.from_numpy(tree["w"]).to(torch.bfloat16)
    assert tatt.apply_local(bf, True, kind, kwargs).dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["alie", "gaussian", "scm"])
def test_apply_local_refuses_what_has_no_local_form(kind):
    from repro.core import attacks as jatt
    from repro_torch.core import attacks as tatt
    for fn in (jatt.apply_local, tatt.apply_local):
        with pytest.raises(ValueError, match=f"attack '{kind}' has no local "
                           "form"):
            fn(np.zeros(3, np.float32), True, kind)
