"""Mode B of the port (``launch.steps.make_train_step_fsdp``: FSDP over
K = 4 agent ranks with the robust-scatter backward) and its FSDP serve
steps, against the reference's ``make_train_step_fsdp`` on a (4,)
``data`` mesh (CPU, gloo).

The same numpy parameters (the port's seeded init) and tokens go to the
reference, which runs in a subprocess on 4 forced host devices and
shards them with its PartitionSpecs, and to one spawn of 4 gloo ranks
(``launch.mesh.run_ranks``), which cut them with
``launch.steps.shard_params``.  Cases: the smoke Qwen3 config with
``rs_mm``, ``gather_mm`` and ``mean``, with and without an additive
attacker at +1000 on the last rank, at microbatches 1 and 2, and the
smoke MoE config; the reference's side aggregates with its jnp
estimator, the port's with the kernel's plain version or the plain
estimator (``use_kernel``), which agree to float rounding.

Compared: SGD at lr 1 without clip, so p0 - p1 is the aggregate the
optimizer applied (glued from the ranks' shards), and the loss.  The
gathered layer is bf16 in both packages, so the cotangent of each
gathered leaf is rounded to bf16 before the robust scatter; where the
two packages' f32 sums differ in their last bits, a coordinate's
rounding may fall on the other side of a bf16 step (2^-8 of its value)
for one agent (on the CPU: 0.05-0.3% of a large leaf's coordinates,
one or two of a norm's 64-256).  So the aggregate is held to atol 1e-6
+ rtol 1e-5 (PR 16's Mode A tolerance) on all but max(2, 1%) of a
leaf's coordinates, and every coordinate to 2^-8 of the leaf's largest
value.  The loss: rtol 1e-6.

One Adam case with clip 1.0 is compared rank by rank with the
reference's per-device shards (``addressable_shards``): the moments m
and v, held as the aggregate but with atol 1e-5 of the leaf's largest
moment (PR 16's Adam case), and v, a square, to two bf16 steps.  The
reference clips each rank's local tree (its block shards and the
replicated rest) by that tree's norm, so the factor differs from rank
to rank and the replicated leaves' moments differ across its devices;
the port reproduces each device's copy.

This module imports no jax at the top: the ranks import it.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs, interop, pytree
from repro_torch.core import attacks
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.optim import optimizers

K = 4
ROWS, SEQ = 2 * K, 9           # two rows an agent: microbatches 1 and 2
SERVE_PROMPT, SERVE_TOKENS, SERVE_LEN = 6, 4, 12
ARCHS = ("qwen3_0p6b", "qwen3_moe_235b_a22b")
SGD = dict(name="sgd", learning_rate=1.0, grad_clip=0.0, warmup_steps=0,
           schedule_kind="constant")
ADAM = dict(name="adam", learning_rate=1e-2, grad_clip=1.0, warmup_steps=0,
            schedule_kind="constant")
# (arch, aggregation, additive attacker, microbatches, optimizer, the
# port's use_kernel)
CASES = (
    ("qwen3_0p6b", "rs_mm", True, 1, "sgd", True),
    ("qwen3_0p6b", "rs_mm", False, 2, "sgd", False),
    ("qwen3_0p6b", "gather_mm", True, 2, "sgd", True),
    ("qwen3_0p6b", "mean", True, 1, "sgd", True),
    ("qwen3_0p6b", "mean", False, 2, "sgd", False),
    ("qwen3_moe_235b_a22b", "rs_mm", True, 2, "sgd", True),
    ("qwen3_moe_235b_a22b", "mean", False, 1, "sgd", False),
    ("qwen3_0p6b", "rs_mm", True, 1, "adam", True),
)
BYZ = dict(num_malicious=1, attack="additive",
           attack_kwargs=(("delta", 1000.0),))

JAX_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro import compat, configs
    from repro.core import attacks
    from repro.launch import steps
    from repro.models import model as M
    from repro.optim import optimizers

    inp = dict(np.load(sys.argv[1]))
    cases = json.loads(sys.argv[3])
    opts = json.loads(sys.argv[4])
    byz = json.loads(sys.argv[5])
    byz["attack_kwargs"] = tuple(tuple(kv) for kv in byz["attack_kwargs"])
    mesh = compat.make_mesh((4, 1), ("data", "model"))
    rank_of = {d.id: i for i, d in enumerate(mesh.devices.flat)}
    out = {}

    def load(arch):
        cfg = configs.load_smoke(arch)
        leaves, treedef = jax.tree.flatten(jax.eval_shape(
            lambda: M.init_model(jax.random.key(0), cfg)))
        return cfg, jax.tree.unflatten(treedef, [
            jnp.asarray(inp[f"{arch}/p{i}"]) for i in range(len(leaves))])

    def per_device(prefix, leaves):
        for i, leaf in enumerate(leaves):
            for s in leaf.addressable_shards:
                r = rank_of[s.device.id]
                out[f"{prefix}{i}/r{r}"] = np.asarray(s.data)

    for c, (arch, method, attack, mb, opt, _) in enumerate(cases):
        cfg, params = load(arch)
        par = configs.ParallelConfig(fsdp=True, aggregation=method,
                                     microbatches=mb)
        ocfg = optimizers.OptimizerConfig(**opts[opt])
        build, _ = steps.make_train_step_fsdp(
            cfg, par, ocfg, mesh,
            byzantine=attacks.ByzantineConfig(**byz) if attack else None)
        batch = {"tokens": jnp.asarray(inp[f"{arch}/tokens"])}
        opt0 = optimizers.init(ocfg, params)
        p1, o1, m = jax.jit(build(batch))(params, opt0, batch)
        out[f"{c}/loss"] = np.asarray(m["loss"])
        out[f"{c}/grad_norm"] = np.asarray(m["grad_norm"])
        if opt == "sgd":
            for i, (a, b) in enumerate(zip(jax.tree.leaves(params),
                                           jax.tree.leaves(p1))):
                out[f"{c}/d{i}"] = np.asarray(a) - np.asarray(b)
        else:
            per_device(f"{c}/m", jax.tree.leaves(o1.m))
            per_device(f"{c}/v", jax.tree.leaves(o1.v))
            per_device(f"{c}/p", jax.tree.leaves(p1))

    # FSDP serve: prefill, then greedy decode from the prompt's first token
    cfg, params = load("qwen3_0p6b")
    toks = jnp.asarray(inp["serve/tokens"])
    batch = {"tokens": toks}
    pf = jax.jit(steps.make_prefill_step(cfg, mesh, fsdp=True,
                                         batch_template=batch))
    out["serve/prefill"] = np.asarray(pf(params, batch))
    cache = M.init_cache(cfg, toks.shape[0], int(sys.argv[6]))
    dec = jax.jit(steps.make_decode_step(cfg, mesh, fsdp=True,
                                         cache_template=cache,
                                         global_batch=toks.shape[0]))
    tok, gen = toks[:, :1], []
    for _ in range(int(sys.argv[7])):
        tok, cache = dec(params, tok, cache)
        gen.append(np.asarray(tok))
    out["serve/tokens_out"] = np.concatenate(gen, axis=1)
    out["serve/cache_v"] = np.asarray(cache["blocks"]["v"])
    np.savez(sys.argv[2], **out)
""")


def _inputs() -> dict:
    """The port's seeded smoke parameters and the tokens, as numpy."""
    inp = {}
    for j, arch in enumerate(ARCHS):
        cfg = configs.load_smoke(arch)
        model = M.init_model(cfg, seed=j, device="cpu")
        for i, leaf in enumerate(pytree.flatten(model.tree())[0]):
            inp[f"{arch}/p{i}"] = leaf.detach().numpy().copy()
        inp[f"{arch}/tokens"] = np.random.default_rng(j).integers(
            0, cfg.vocab_size, (ROWS, SEQ)).astype(np.int32)
    inp["serve/tokens"] = np.random.default_rng(7).integers(
        0, configs.load_smoke("qwen3_0p6b").vocab_size,
        (ROWS, SERVE_PROMPT)).astype(np.int32)
    return inp


def _full_params(inp: dict, arch: str) -> dict:
    cfg = configs.load_smoke(arch)
    treedef = pytree.flatten(steps.param_template(cfg))[1]
    n = len(pytree.flatten(steps.param_template(cfg))[0])
    return interop.from_numpy_tree(
        pytree.unflatten(treedef, [inp[f"{arch}/p{i}"] for i in range(n)]),
        "cpu")


def _rank(mesh, inp):
    """Every case's Mode B step on this rank's shards, then the FSDP
    serve steps on its rows (run by each of the K ranks)."""
    r = mesh.agent_index
    out = {"cases": []}
    for arch, method, attack, mb, opt, use_kernel in CASES:
        cfg = configs.load_smoke(arch)
        local = steps.shard_params(_full_params(inp, arch), K, r)
        p0 = [t.clone() for t in pytree.flatten(local)[0]]
        ocfg = optimizers.OptimizerConfig(**(SGD if opt == "sgd" else ADAM))
        step = steps.make_train_step_fsdp(
            cfg, configs.ParallelConfig(fsdp=True, aggregation=method,
                                        microbatches=mb,
                                        use_kernel=use_kernel),
            ocfg, mesh, attacks.ByzantineConfig(**BYZ) if attack else None,
            device="cpu")
        batch = steps.local_rows(
            {"tokens": torch.from_numpy(inp[f"{arch}/tokens"])}, mesh)
        _, o1, m = step(local, optimizers.init(ocfg, local), batch)
        p1 = [t.detach() for t in pytree.flatten(local)[0]]
        res = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "traffic": step.traffic,
               "d": [a - b for a, b in zip(p0, p1)]}
        if opt == "adam":
            res.update(m=pytree.flatten(o1.m)[0], v=pytree.flatten(o1.v)[0],
                       p=p1)
        out["cases"].append(res)
    # a leaf sharded on its second dim: the gather, and both scatters
    # of a cotangent that differs by rank
    for method in ("mean", "rs_mm"):
        w = (torch.arange(6.0).reshape(3, 2) + 10 * r).requires_grad_(True)
        full = steps.FsdpHook(mesh, {"w": 1}, method=method)({"w": w})["w"]
        coef = torch.arange(24.0).reshape(3, 8) * (r + 1)
        (full.float() * coef).sum().backward()
        out[f"dim1_{method}"] = (full.detach(), w.grad)
    cfg = configs.load_smoke("qwen3_0p6b")
    local = steps.shard_params(_full_params(inp, "qwen3_0p6b"), K, r)
    toks = steps.local_rows({"tokens": torch.from_numpy(inp["serve/tokens"])},
                            mesh)["tokens"]
    prefill = steps.make_prefill_step(cfg, "cpu", fsdp=True, mesh=mesh)
    out["prefill"] = prefill(local, {"tokens": toks})
    dec = steps.make_decode_step(cfg, "cpu", fsdp=True, mesh=mesh)
    cache = M.init_cache(cfg, toks.shape[0], SERVE_LEN, device="cpu")
    tok, gen = toks[:, :1], []
    for _ in range(SERVE_TOKENS):
        tok, cache = dec(local, tok, cache)
        gen.append(tok)
    out["tokens_out"] = torch.cat(gen, dim=1)
    out["cache_v"] = cache["blocks"]["v"]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz"), json.dumps(CASES),
         json.dumps({"sgd": SGD, "adam": ADAM}), json.dumps(BYZ),
         str(SERVE_LEN), str(SERVE_TOKENS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = mesh_lib.run_ranks(_rank, K, inp, timeout_s=120)
    finally:
        _, err = jax_proc.communicate(timeout=900)
    assert jax_proc.returncode == 0, err[-3000:]
    return inp, ranks, dict(np.load(tmp / "out.npz"))


def _dims(arch: str) -> list:
    return pytree.flatten(steps.fsdp_dims(
        steps.param_template(configs.load_smoke(arch)), K))[0]


def _names(arch: str) -> list:
    return pytree.leaf_paths(steps.param_template(configs.load_smoke(arch)))


def _held(got: torch.Tensor, want: np.ndarray, atol: float, what,
          bf16_steps: int = 1) -> None:
    """All but max(2, 1%) of the coordinates within ``atol`` + rtol 1e-5,
    every one within ``bf16_steps`` bf16 steps (2^-8 relative) of the
    largest |want| (see the module docstring)."""
    diff = np.abs(got.numpy() - want)
    off = int((diff > atol + 1e-5 * np.abs(want)).sum())
    assert off <= max(2, want.size // 100), (what, off, want.size)
    assert diff.max() <= bf16_steps * 2.0 ** -8 * np.abs(want).max(), \
        (what, diff.max())


@pytest.mark.parametrize("case", range(len(CASES) - 1),
                         ids=["-".join(map(str, c[:4])) for c in CASES[:-1]])
def test_mode_b_step_matches_the_reference(runs, case):
    _, ranks, ref = runs
    arch, method, attack = CASES[case][:3]
    for out in ranks:
        np.testing.assert_allclose(out["cases"][case]["loss"],
                                   float(ref[f"{case}/loss"]), rtol=1e-6)
    for i, (name, d) in enumerate(zip(_names(arch), _dims(arch))):
        parts = [out["cases"][case]["d"][i] for out in ranks]
        got = parts[0] if d < 0 else torch.cat(parts, dim=d)
        if d < 0:   # replicated: every rank applied the same update
            assert all(torch.equal(p, parts[0]) for p in parts), name
        _held(got, ref[f"{case}/d{i}"], 1e-6, name)
    if attack and method != "mean":
        # the attacker's +1000 is rejected: the update stays at the
        # benign scale while the mean case moves by about 1000 / K
        assert max(float(np.abs(ref[f"{case}/d{i}"]).max())
                   for i in range(len(_dims(arch)))) < 10.0


def test_mean_under_attack_moves_every_leaf(runs):
    _, ranks, _ = runs
    case = CASES.index(("qwen3_0p6b", "mean", True, 1, "sgd", True))
    for i, d in enumerate(ranks[0]["cases"][case]["d"]):
        assert float(d.mean()) > 0.2 * 1000.0 / K


def test_adam_with_clip_matches_the_reference_rank_by_rank(runs):
    """The reference's per-device moments, each rank's own; its clip
    factor is this rank's, so the replicated leaves' moments differ
    across ranks in both packages (ROADMAP section 3)."""
    _, ranks, ref = runs
    case = len(CASES) - 1
    names = _names(CASES[case][0])
    for r, out in enumerate(ranks):
        res = out["cases"][case]
        for key, steps_ in (("m", 1), ("v", 2)):     # v is g^2: 2 steps
            for i, got in enumerate(res[key]):
                want = ref[f"{case}/{key}{i}/r{r}"]
                _held(got, want, 1e-5 * np.abs(want).max(),
                      (names[i], key, r), steps_)
    np.testing.assert_allclose(ranks[0]["cases"][case]["grad_norm"],
                               float(ref[f"{case}/grad_norm"]), rtol=1e-5)
    # the drift: a replicated leaf's first moment differs across ranks,
    # in the reference's devices and in the port's ranks alike
    embed = names.index("embed")
    for src in ([ref[f"{case}/m{embed}/r{r}"] for r in range(K)],
                [out["cases"][case]["m"][embed].numpy() for out in ranks]):
        assert max(np.abs(m - src[0]).max() for m in src[1:]) > 0
    norms = [out["cases"][case]["grad_norm"] for out in ranks]
    assert len(set(norms)) == K       # each rank clips by its own norm


def test_step_traffic_and_refusals(runs):
    _, ranks, _ = runs
    i_rs = CASES.index(("qwen3_0p6b", "rs_mm", True, 1, "sgd", True))
    i_mean = CASES.index(("qwen3_0p6b", "mean", True, 1, "sgd", True))
    for out in ranks:
        rs = out["cases"][i_rs]["traffic"]
        mean = out["cases"][i_mean]["traffic"]
        assert rs["gather"] > 0 and rs["scatter"] > 0 and rs["rest"] > 0
        # the mean's scatter is a reduce-scatter of f32: twice the bytes
        # of the robust scatter's bf16 all-to-all
        assert mean["scatter"] == 2 * rs["scatter"]
    cfg = configs.load_smoke("rwkv6_1p6b")
    with pytest.raises(ValueError, match="Mode B takes the"):
        steps.make_train_step_fsdp(cfg, configs.ParallelConfig(fsdp=True),
                                   optimizers.OptimizerConfig(), None,
                                   device="cpu")
    with pytest.raises(ValueError, match="needs the agent mesh"):
        steps.make_prefill_step(configs.load_smoke("qwen3_0p6b"), "cpu",
                                fsdp=True)


def test_a_leaf_sharded_on_its_second_dim(runs):
    """The gather glues the ranks' shards along dim 1; the mean scatter
    gives each rank the mean of the ranks' cotangents over its columns,
    the robust one their MM estimate (here the median-like centre of
    (r + 1) x c over r = 0..3, between the 2nd and 3rd)."""
    _, ranks, _ = runs
    shards = [torch.arange(6.0).reshape(3, 2) + 10 * r for r in range(K)]
    full = torch.cat(shards, dim=1).to(torch.bfloat16)
    coef = torch.arange(24.0).reshape(3, 8)
    for r, out in enumerate(ranks):
        cols = coef[:, 2 * r:2 * r + 2]
        for method in ("mean", "rs_mm"):
            got_full, grad = out[f"dim1_{method}"]
            assert torch.equal(got_full, full)
            assert grad.dtype == torch.float32 and grad.shape == (3, 2)
        assert torch.allclose(out["dim1_mean"][1], cols * 2.5)
        robust = out["dim1_rs_mm"][1]
        assert bool(((robust >= cols * 2 - 1e-4) &
                     (robust <= cols * 3 + 1e-4)).all()), robust


def test_shard_params_round_trips():
    inp = _inputs()
    for arch in ARCHS:
        full = _full_params(inp, arch)
        dims = steps.fsdp_dims(full, K)
        shards = [steps.shard_params(full, K, r) for r in range(K)]
        back = steps.unshard_params(shards, dims)
        for j, (a, d) in enumerate(zip(pytree.flatten(full)[0],
                                       pytree.flatten(dims)[0])):
            assert torch.equal(pytree.flatten(back)[0][j], a)
            part = pytree.flatten(shards[1])[0][j]
            want = list(a.shape)
            if d >= 0:
                want[d] //= K
            assert list(part.shape) == want


@pytest.mark.parametrize("arch", ["qwen3_32b", "dbrx_132b",
                                  "qwen3_moe_235b_a22b", "llava_next_34b",
                                  "zamba2_2p7b", "seamless_m4t_large_v2"])
def test_fsdp_layout_matches_the_reference(arch):
    """Which dim of which leaf Mode B shards over the agents, on the full
    configs (the port's tree on the meta device, the reference's from
    ``jax.eval_shape``): the reference's ``param_specs(..., fsdp=True)``
    on a mesh of K agents and model size 1, and ``shard_dims`` with model
    sizes above 1 too."""
    import jax
    from types import SimpleNamespace
    from repro import configs as jconfigs
    from repro.launch import steps as JS
    from repro.models import model as JM
    jcfg = jconfigs.load_arch(arch).model
    jtmpl = jax.eval_shape(lambda: JM.init_model(jax.random.key(0), jcfg))
    tmpl = steps.param_template(configs.load_arch(arch).model)
    for k in (4, 32):
        specs = JS.param_specs(jtmpl, SimpleNamespace(shape={"data": k}),
                               fsdp=True)
        want = [next((i for i, e in enumerate(sp) if e == "data"), -1)
                for sp in jax.tree.leaves(
                    specs, is_leaf=lambda x: isinstance(x, tuple))]
        assert pytree.flatten(steps.fsdp_dims(tmpl, k))[0] == want
        for leaf in jax.tree.leaves(jtmpl):
            for model in (1, 2, 16):
                sliced = tuple(leaf.shape[1:])
                assert steps.shard_dims(sliced, k, model) == \
                    JS.shard_dims(sliced, k, model)


def test_fsdp_prefill_matches_the_reference(runs):
    _, ranks, ref = runs
    got = torch.cat([out["prefill"] for out in ranks])
    assert got.shape == ref["serve/prefill"].shape
    np.testing.assert_allclose(got.numpy(), ref["serve/prefill"],
                               atol=2e-5, rtol=1e-5)


def test_fsdp_decode_matches_the_reference(runs):
    _, ranks, ref = runs
    got = torch.cat([out["tokens_out"] for out in ranks])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref["serve/tokens_out"])
    cache = torch.cat([out["cache_v"] for out in ranks], dim=1)
    np.testing.assert_allclose(cache.numpy(), ref["serve/cache_v"],
                               atol=2e-5)
