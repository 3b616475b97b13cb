"""The port's substrate paradigm (``scenarios.substrate``), its spec
checks and the training entry point ``launch.train`` (CPU).

The reference's bands hold the runs (jax.random and torch draw
different streams, so whole runs are compared by band, not value):
paper_lsq under the additive attack settles at the noise floor with MM
(last-30 mean loss < 0.05, no breakdown) and breaks down with the mean.
An LM smoke run on the kernel backend is finite and audits one launch
plan per aggregated leaf layout; the two engine backends agree on the
same run (rtol 1e-4, the reference's own band).  ``grad_consensus``
matches the reference on identical stacks at rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as JS
from repro_torch import pytree, scenarios
from repro_torch.launch import steps as TS
from repro_torch.launch import train
from repro_torch.models import model as TM
from repro_torch.scenarios import substrate


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: in a parallel run each worker's default
    pool spins against the other workers', and these small-tensor tests
    ran 30-50x slower there than alone (alone, one thread is as fast)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LM_TINY = dict(
    paradigm="substrate", model_config="qwen3-0.6b", aggregator="mm_tukey",
    num_agents=4, num_steps=2,
    paradigm_kwargs=(("batch_per_agent", 1), ("seq_len", 8)))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_lsq_substrate_mm_holds_and_mean_breaks_down(backend):
    base = dict(paradigm="substrate", model_config="paper_lsq",
                num_agents=8, dim=6, num_steps=150, step_size=0.05,
                attack="additive", num_malicious=2,
                attack_kwargs=(("delta", 100.0),))
    robust = scenarios.run(scenarios.ScenarioSpec(
        aggregator="mm_tukey", backend=backend, **base), device="cpu")
    assert robust.finite()
    assert float(np.mean(robust.history["loss"][-30:])) < 0.05
    assert not robust.summary["broke_down"]
    np.testing.assert_array_equal(robust.history["msd"],
                                  robust.history["loss"])
    assert (robust.launch_audit is None) == (backend == "jnp")
    broken = scenarios.run(scenarios.ScenarioSpec(aggregator="mean", **base),
                           device="cpu")
    assert broken.summary["broke_down"]


def test_lm_substrate_kernel_backend_audits_each_leaf_layout():
    sp = scenarios.ScenarioSpec(backend="pallas", attack="additive",
                                num_malicious=1, **LM_TINY)
    res = scenarios.run(sp, device="cpu")
    assert res.finite()
    assert set(res.history) == {"msd", "loss", "consensus"}
    for h in res.history.values():
        assert h.shape == (sp.num_steps,)
    model, opt = res.final_state
    assert isinstance(model, TM.Model) and opt.step == sp.num_steps
    widths = {leaf.numel() for leaf in pytree.flatten(model.tree())[0]}
    audit = res.launch_audit
    assert audit["n_layouts"] == len(widths) > 1
    for plan in audit["layouts"]:
        assert plan["n_out"] == 1 and plan["k_pad"] == sp.num_agents
        assert plan["m_total"] % plan["block_m"] == 0 and plan["grid"][0] >= 1


def test_lm_substrate_backends_agree_under_a_schedule():
    base = dict(attack="sign_flip", num_malicious=1,
                attack_schedule="intermittent",
                schedule_kwargs=(("period", 1),), **LM_TINY)
    r_jnp = scenarios.run(scenarios.ScenarioSpec(backend="jnp", **base),
                          device="cpu")
    r_pal = scenarios.run(scenarios.ScenarioSpec(backend="pallas", **base),
                          device="cpu")
    assert r_jnp.finite() and r_pal.finite()
    np.testing.assert_allclose(r_jnp.history["loss"], r_pal.history["loss"],
                               rtol=1e-4, atol=1e-5)
    assert r_jnp.launch_audit is None and r_pal.launch_audit is not None


def test_build_lm_components_is_the_step_launch_train_builds():
    sp = scenarios.ScenarioSpec(seed=3, **LM_TINY)
    dev = torch.device("cpu")
    model_cfg, par, opt_cfg, byz, (model, opt), batch_fn = \
        substrate.build_lm_components(sp, dev)
    assert par.aggregation == "rs_mm" and not par.use_kernel
    assert opt_cfg.name == "adam" and opt_cfg.grad_clip == 1.0
    batch = batch_fn(torch.Generator().manual_seed(0))
    assert batch["tokens"].shape == (4, 9)
    step = TS.make_train_step_gspmd(model_cfg, par, opt_cfg, dev, byz,
                                    k_agents=sp.num_agents,
                                    consensus_metric=True)
    _, opt1, m = step(model, opt, batch)
    assert opt1.step == 1 and np.isfinite(float(m["consensus"]))


def test_substrate_spec_checks_like_the_reference():
    with pytest.raises(ValueError, match="unknown arch"):
        scenarios.ScenarioSpec(paradigm="substrate", model_config="gpt-9")
    with pytest.raises(ValueError, match="iid"):
        scenarios.ScenarioSpec(paradigm="substrate",
                               model_config="qwen3-0.6b", data="dirichlet")
    scenarios.ScenarioSpec(paradigm="substrate", model_config="paper_lsq",
                           data="dirichlet")
    with pytest.raises(ValueError, match="model_config"):
        scenarios.ScenarioSpec(paradigm="substrate")
    with pytest.raises(ValueError, match="substrate aggregation"):
        scenarios.ScenarioSpec(paradigm="substrate", model_config="paper_lsq",
                               aggregator="krum")
    with pytest.raises(ValueError, match="substrate-only"):
        scenarios.ScenarioSpec(model_config="qwen3-0.6b")
    sp = scenarios.ScenarioSpec(paradigm="substrate", model_config="paper_lsq",
                                num_steps=1)
    with pytest.raises(ValueError, match="w0"):
        scenarios.run(sp, w0=np.zeros(10, np.float32), device="cpu")


def test_grad_consensus_matches_the_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(5, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(5, 7)).astype(np.float32) * 10}
    benign = np.array([True, True, False, True, True])
    want = JS.grad_consensus({k: jnp.asarray(v) for k, v in tree.items()},
                             jnp.asarray(benign))
    got = TS.grad_consensus({k: torch.from_numpy(v) for k, v in tree.items()},
                            torch.from_numpy(benign))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    losses = train.main(["--device", "cpu", "--steps", "2", "--agents", "2",
                         "--malicious", "1", "--use-kernel", "--seq", "8",
                         "--batch", "3", "--log-every", "1",
                         "--checkpoint", ck])
    assert len(losses) == 2 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "rounding batch to 2" in out and "saved" in out
    losses = train.main(["--device", "cpu", "--steps", "2", "--agents", "2",
                         "--seq", "8", "--scenario", "--arch",
                         "llava-next-34b"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    with pytest.raises(SystemExit, match="drop --full-config"):
        train.main(["--device", "cpu", "--scenario", "--full-config"])
