"""The dry run on meta tensors (``repro_torch.launch.dryrun``) and the
inputs it traces (``configs.input_specs``).

``input_specs`` is held to the reference's for every arch x shape, leaf
for leaf (the decode cache through ``jax.eval_shape``).  The dry run of
the smoke configs at a small shape, on a 4-rank group that moves
nothing, is held to what the same steps really do on the CPU: the
parameter count and the argument bytes to the reference's
``jax.eval_shape`` leaves, the MM kernel calls and the flops to a CPU
run's, and the bytes a rank sends to a real 4-rank gloo run's
``core.sharded.TRAFFIC`` (``launch.mesh.run_ranks``; the rank function
lives here, and this module imports no jax at the top, since the
spawned ranks import it).
"""

import dataclasses
import json
import math

import pytest
import torch

from repro_torch import configs, pytree
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import optimizers

RANKS = 4
SHAPES = {"train": InputShape("tiny_train", "train", 32, 8),
          "prefill": InputShape("tiny_prefill", "prefill", 32, 8),
          "decode": InputShape("tiny_decode", "decode", 48, 8)}
# (arch, kind): every family in Mode A, Mode B's three families, the
# serve steps with and without fsdp
CASES = (
    ("qwen3_0p6b", "train"), ("rwkv6_1p6b", "train"),
    ("zamba2_2p7b", "train"), ("seamless_m4t_large_v2", "train"),
    ("qwen3_32b", "train"), ("dbrx_132b", "train"),
    ("llava_next_34b", "train"),
    ("qwen3_0p6b", "prefill"), ("qwen3_32b", "prefill"),
    ("qwen3_0p6b", "decode"), ("qwen3_32b", "decode"),
    ("rwkv6_1p6b", "decode"),
)


def _setup(arch: str, kind: str):
    cfg = configs.load_smoke(arch)
    shape = SHAPES[kind]
    par = dataclasses.replace(
        configs.load_arch(arch).parallel_for(shape.name), use_kernel=True)
    return cfg, par, shape


def _counted(rec: dict) -> dict:
    """What a run on another device must reproduce exactly."""
    return {"flops": rec["flops_per_rank"],
            "mm": sorted((tuple(d["key"]), d["dtype"], d["weighted"],
                          d["count"], d["bytes"], d["ops"])
                         for d in rec["mm_launches"]),
            "collectives": rec["collectives"],
            "argument_bytes": rec["memory"]["argument_bytes"]}


def _cpu_trace(arch, kind, world, mesh, agents=1):
    cfg, par, shape = _setup(arch, kind)
    opt_cfg = optimizers.OptimizerConfig(state_dtype=par.opt_state_dtype)
    _, fn, args = dryrun.step_and_arguments(cfg, par, opt_cfg, shape, world,
                                            mesh, device="cpu",
                                            agents=agents)
    return _counted(dryrun.trace(fn, args))


def _rank(mesh, cases):
    """One gloo rank: every sharded case's step on the CPU, traced."""
    torch.manual_seed(0)
    return {f"{a}/{k}": _cpu_trace(a, k, RANKS, mesh) for a, k in cases}


def _sharded(arch, kind):
    return configs.load_arch(arch).parallel_for(SHAPES[kind].name).fsdp


@pytest.fixture(scope="module")
def gloo_runs():
    cases = [c for c in CASES if _sharded(*c)]
    ranks = mesh_lib.run_ranks(_rank, RANKS, cases, timeout_s=240)
    return ranks[0]


@pytest.fixture(scope="module")
def meta_runs():
    out = {}
    for arch, kind in CASES:
        cfg, par, shape = _setup(arch, kind)
        out[f"{arch}/{kind}"] = dryrun.trace_step(cfg, par, shape,
                                                  ranks=RANKS)
    return out


# ===========================================================================
# input_specs against the reference
# ===========================================================================

def _leaves_ref(tree):
    import jax
    return [(tuple(x.shape), str(x.dtype))
            for x in jax.tree_util.tree_leaves(tree)]


def _leaves(tree):
    return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in pytree.flatten(tree)[0]]


@pytest.mark.parametrize("shape_name", sorted(configs.INPUT_SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_match_the_reference(arch, shape_name):
    from repro import configs as rconfigs
    shape = configs.INPUT_SHAPES[shape_name]
    got = configs.input_specs(configs.load_arch(arch).model, shape)
    want = rconfigs.input_specs(rconfigs.load_arch(arch).model,
                                rconfigs.INPUT_SHAPES[shape_name])
    assert sorted(got) == sorted(want)
    assert pytree.leaf_paths(got) == [
        ".".join(str(getattr(k, "key", k)) for k in path)
        for path, _ in __import__("jax").tree_util.tree_leaves_with_path(
            want)]
    assert _leaves(got) == _leaves_ref(want)
    assert all(t.device.type == "meta" for t in pytree.flatten(got)[0])


def test_input_specs_on_another_device():
    cfg = configs.load_smoke("qwen3_0p6b")
    got = configs.input_specs(cfg, SHAPES["decode"], device="cpu")
    assert got["tokens"].device.type == "cpu"
    assert tuple(got["tokens"].shape) == (8, 1)


# ===========================================================================
# the dry run against the reference's shapes and the CPU's counts
# ===========================================================================

def _ref_bytes(arch: str, kind: str, agents_rows: int) -> tuple:
    """(parameter elements, argument bytes) from the reference's
    jax.eval_shape leaves: the parameters (f32 to train, the activation
    dtype to serve), Adam's moments (the reference's int32 step counter
    is a host int in the port, so it is left out), and the rank's batch
    or tokens and cache; a Mode B rank holds 1/K of each sharded leaf."""
    import jax
    import jax.numpy as jnp
    from repro import configs as rconfigs
    from repro.models import model as RM
    from repro.optim import optimizers as ropt
    cfg = rconfigs.load_smoke(arch)
    par = rconfigs.load_arch(arch).parallel
    tmpl = jax.eval_shape(lambda: RM.init_model(jax.random.key(0), cfg))
    numel = sum(math.prod(x.shape) for x in jax.tree_util.tree_leaves(tmpl))
    dims = pytree.flatten(steps.fsdp_dims(
        steps.param_template(configs.load_smoke(arch)), RANKS))[0] \
        if par.fsdp else None

    def tree_bytes(tree, itemsize=None):
        leaves = jax.tree_util.tree_leaves(tree)
        total = 0
        for i, x in enumerate(leaves):
            n = math.prod(x.shape) * (itemsize or x.dtype.itemsize)
            total += n // RANKS if dims and dims[i] >= 0 else n
        return total

    shape = SHAPES[kind]
    local = rconfigs.InputShape(shape.name, kind, shape.seq_len,
                                agents_rows)
    ins = rconfigs.input_specs(cfg, local)
    if kind == "train":
        opt = jax.eval_shape(lambda: ropt.init(ropt.OptimizerConfig(), tmpl))
        return numel, (tree_bytes(tmpl) + tree_bytes(opt.m)
                       + tree_bytes(opt.v) + _plain_bytes(ins["batch"]))
    act = jnp.dtype(cfg.act_dtype).itemsize
    return numel, tree_bytes(tmpl, act) + _plain_bytes(ins)


def _plain_bytes(tree):
    import jax
    return sum(math.prod(x.shape) * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(c))
def test_dry_run_counts_match_the_reference_shapes(meta_runs, case):
    arch, kind = case
    rec = meta_runs[f"{arch}/{kind}"]
    cfg, par, shape = _setup(arch, kind)
    numel, arg_bytes = _ref_bytes(arch, kind,
                                  dryrun._rows(shape.global_batch, RANKS))
    assert rec["param_numel"] == numel
    assert rec["memory"]["argument_bytes"] == arg_bytes
    assert rec["mode"] == ("B" if kind == "train" and par.fsdp else
                           "A" if kind == "train" else kind)
    assert rec["flops_per_rank"] > 0 and rec["bytes_accessed_per_rank"] > 0
    if kind == "train":
        # one MM launch per leaf a step in Mode A; Mode B's hooked layer
        # leaves launch per layer, microbatch and chunk
        assert rec["mm_launch_count"] >= (len(pytree.flatten(
            steps.param_template(cfg))[0]) if not par.fsdp else 1)
        assert rec["memory"]["saved_for_backward_bytes"] > 0
    else:
        assert rec["mm_launch_count"] == 0
    mem = rec["memory"]
    assert mem["argument_bytes"] <= mem["argument_alloc_bytes"] \
        <= mem["live_peak_bytes"]


@pytest.mark.parametrize("case", [c for c in CASES if not _sharded(*c)],
                         ids=lambda c: "-".join(c))
def test_meta_step_counts_equal_a_cpu_run(meta_runs, case):
    arch, kind = case
    want = _cpu_trace(arch, kind, RANKS, None)
    got = _counted(meta_runs[f"{arch}/{kind}"])
    assert got == want


@pytest.mark.parametrize("case", [c for c in CASES if _sharded(*c)],
                         ids=lambda c: "-".join(c))
def test_meta_step_counts_equal_a_gloo_run(meta_runs, gloo_runs, case):
    arch, kind = case
    got = _counted(meta_runs[f"{arch}/{kind}"])
    want = gloo_runs[f"{arch}/{kind}"]
    assert got == want
    if kind == "train":     # Mode B gathers and scatters every step
        assert got["collectives"]["all_gather"]["bytes"] > 0
        assert got["collectives"]["all_to_all"]["bytes"] > 0


def test_k_agents_on_one_card_match_a_cpu_run():
    """The card-side check's step: K agents of one card's rows each (as
    chip_smoke.py's lm_train), meta against the CPU."""
    cfg, par, shape = _setup("qwen3_0p6b", "train")
    one = dataclasses.replace(shape, global_batch=1)
    got = dryrun.trace_step(cfg, par, one, ranks=1, agents=4)
    opt_cfg = optimizers.OptimizerConfig()
    _, fn, args = dryrun.step_and_arguments(cfg, par, opt_cfg, one, 1, None,
                                            device="cpu", agents=4)
    want = dryrun.trace(fn, args)
    assert _counted(got) == _counted(want)
    leaves = len(pytree.flatten(steps.param_template(cfg))[0])
    assert got["mm_launch_count"] == leaves
    assert all(d["key"][1] == 4 for d in got["mm_launches"])
    assert tuple(args[2]["tokens"].shape) == (4, shape.seq_len + 1)


def test_trace_pair_record_and_cli(tmp_path, capsys):
    rc = dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                      "--out", str(tmp_path)])
    assert rc == 0
    assert "OK" in capsys.readouterr().out
    rec = json.loads((tmp_path / "qwen3_0p6b_long_500k_16.json").read_text())
    for key in ("params", "active_params", "param_numel", "flops_per_rank",
                "bytes_accessed_per_rank", "aten_ops", "mm_launches",
                "collectives", "memory", "trace_s", "fits_80gb"):
        assert key in rec, key
    assert rec["model_axis"] == 1 and rec["ranks"] == 16
    assert rec["mode"] == "decode" and rec["fits_80gb"]
    assert rec["params"] == configs.load_arch("qwen3-0.6b").model \
        .param_count()
    assert not torch.distributed.is_initialized()


def test_fake_group_moves_nothing_and_leaves_no_group():
    with dryrun.fake_group(8):
        assert torch.distributed.get_world_size() == 8
        x = torch.empty((8, 4), device="meta")
        from repro_torch.core import sharded
        before = dict(sharded.TRAFFIC)
        out = sharded.all_to_all(x, None)
        assert out.device.type == "meta" and tuple(out.shape) == (8, 4)
        assert sharded.TRAFFIC["all_to_all"] - before["all_to_all"] == \
            8 * 4 * 4 * 7 // 8
    assert not torch.distributed.is_initialized()
