"""The RWKV6 (``ssm``), Zamba2 (``hybrid``) and encoder-decoder (``audio``)
families of the port (``repro_torch.models.model``) against the JAX
reference (CPU), beside the smoke-config cases of
``test_torch_lm_model.py``.

- Decode equals the forward token by token and equals the reference's
  decode, on ``tests/test_models_parity.py``'s models (the audio cross
  cache filled by hand from the encoder output, as there).
- Chunk-size invariance of the whole model.
- One Mode A train step and the serve steps on the RWKV6 smoke config
  against the reference's; the substrate paradigm and ``launch.train``
  on the new families.
- Each full config's leaf paths and shapes equal the reference's
  (``jax.eval_shape``; the port's tree on the meta device, so nothing
  is allocated).
- bf16: the smoke configs' forward against the reference, and decode
  against the forward at each full config's depth and a narrow width:
  the rehearsal of ``chip_smoke.py``'s serve gates.

Tolerances: decode vs forward 3e-4 (the reference's own); port vs
reference f32 logits and caches atol 2e-5 with rtol 1e-5, loss rtol
1e-6; chunk invariance 2e-4 (the reference's); bf16 as stated at each
test.
"""

import dataclasses
import math

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
from repro_torch import interop, pytree, scenarios
from repro_torch.core import attacks as tatt
from repro_torch.launch import steps as TS
from repro_torch.launch import train
from repro_torch.models import layers as TL
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


FAMILY_ARCHS = ("rwkv6_1p6b", "zamba2_2p7b", "seamless_m4t_large_v2")
# tests/test_models_parity.py's models
PARITY_CFGS = {
    "ssm": dict(name="r", arch_type="ssm", num_layers=2, d_model=64,
                num_heads=0, num_kv_heads=0, d_ff=128, vocab_size=128,
                ssm_head_dim=16, chunk_size=4),
    "hybrid": dict(name="h", arch_type="hybrid", num_layers=4, d_model=64,
                   num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128,
                   ssm_state=16, ssm_head_dim=16, attn_every=2,
                   chunk_size=4),
    "audio": dict(name="a", arch_type="audio", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                  encoder_layers=2, num_prefix_tokens=8, mlp_gated=False),
}
# chip_smoke.py's serve gate: decode within 2^-4 x max(1, |logits|_inf)
# of the forward
SERVE_TOL = 2.0 ** -4


def _np(t):
    return interop.to_numpy(t)


def _port(jp):
    return interop.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")


def _tcfg(jcfg):
    return tconfigs.ModelConfig(**dataclasses.asdict(jcfg))


def _fill_cross(params, cfg, frames, cache, mod, layers):
    """The reference test's hand-filled cross cache: the encoder output
    projected to each decoder layer's k and v."""
    enc = mod._encdec_encode(params, cfg, frames, lambda p: p, False)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        xattn = jax.tree.map(lambda x: x[i], params["blocks"]["xattn"]) \
            if mod is JM else {n: t[i] for n, t in
                               params["blocks"]["xattn"].items()}
        k, v = layers.project_enc_kv(xattn, enc, mod.attn_dims(
            cfg, causal=False))
        ks.append(k)
        vs.append(v)
    stack = jnp.stack if mod is JM else torch.stack
    cache["cross"] = {"k": stack(ks), "v": stack(vs)}
    return cache


def _port_decode(tp, tcfg, toks, frames, cache_len):
    cache = TM.init_cache(tcfg, toks.shape[0], cache_len, device="cpu")
    if frames is not None:
        cache = _fill_cross(tp, tcfg, frames, cache, TM, TL)
    outs = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            lg, cache = TM.decode_step(tp, tcfg, toks[:, t:t + 1], cache)
            outs.append(lg[:, 0])
    return torch.stack(outs, dim=1), cache


@pytest.mark.parametrize("family", ["ssm", "hybrid", "audio"])
def test_decode_equals_forward_and_the_reference_decode(family):
    from repro.models import layers as JL
    jcfg = jconfigs.ModelConfig(**PARITY_CFGS[family])
    tcfg = _tcfg(jcfg)
    jp = JM.init_model(jax.random.key(0), jcfg)
    tp = _port(jp)
    steps = 12
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 128, (2, steps)).astype(np.int32)
    frames = rng.normal(size=(2, 8, 64)).astype(np.float32) \
        if family == "audio" else None
    batch = {"tokens": torch.from_numpy(toks)}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames)
    with torch.no_grad():
        full, _ = TM.forward(tp, tcfg, batch, remat=False)
        dec, cache = _port_decode(
            tp, tcfg, torch.from_numpy(toks),
            None if frames is None else torch.from_numpy(frames), steps + 4)
    np.testing.assert_allclose(_np(dec), _np(full), atol=3e-4)

    jcache = JM.init_cache(jcfg, 2, steps + 4)
    if frames is not None:
        jcache = _fill_cross(jp, jcfg, jnp.asarray(frames), jcache, JM, JL)
    step = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))
    for t in range(steps):
        jlg, jcache = step(jp, jnp.asarray(toks[:, t:t + 1]), jcache)
    np.testing.assert_allclose(_np(dec[:, -1]), np.asarray(jlg[:, 0]),
                               atol=2e-5, rtol=1e-5)
    jleaves, tleaves = jax.tree.leaves(jcache), pytree.flatten(cache)[0]
    assert len(jleaves) == len(tleaves)
    for name, a, b in zip(pytree.leaf_paths(cache), tleaves, jleaves):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-5,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_smoke_config_prefill_cache_and_decode_match_the_reference(arch):
    """The smoke config's prefill, zero cache and decode steps against
    the reference's, and decode against the port's own forward."""
    from repro.models import layers as JL
    jcfg, tcfg = jconfigs.load_smoke(arch), tconfigs.load_smoke(arch)
    jp = JM.init_model(jax.random.key(3), jcfg)
    tp = _port(jp)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    batch = {"tokens": toks}
    if jcfg.arch_type == "audio":
        batch["frames"] = rng.normal(size=(2, jcfg.num_prefix_tokens,
                                           jcfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = jax.jit(lambda p, b: JM.prefill(p, jcfg, b, remat=False))(jp, jb)
    with torch.no_grad():
        got = TM.prefill(tp, tcfg, tb)
        full, _ = TM.forward(tp, tcfg, tb, remat=False)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5,
                               rtol=1e-5)

    jcache, tcache = JM.init_cache(jcfg, 2, 8), TM.init_cache(
        tcfg, 2, 8, device="cpu")
    assert pytree.leaf_paths(tcache) == [
        ".".join(str(k.key) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jcache)[0]]
    for a, b in zip(pytree.flatten(tcache)[0], jax.tree.leaves(jcache)):
        assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[-1] \
            == str(b.dtype)
    dec, _ = _port_decode(tp, tcfg, tb["tokens"], tb.get("frames"), 8)
    np.testing.assert_allclose(_np(dec), _np(full), atol=3e-4)
    if "frames" in jb:
        jcache = _fill_cross(jp, jcfg, jb["frames"], jcache, JM, JL)
    step = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))
    for t in range(8):
        jlg, jcache = step(jp, jb["tokens"][:, t:t + 1], jcache)
    np.testing.assert_allclose(_np(dec[:, -1]), np.asarray(jlg[:, 0]),
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_model_chunk_size_invariance(family):
    jcfg = jconfigs.ModelConfig(**dict(PARITY_CFGS[family], num_layers=2))
    jp = JM.init_model(jax.random.key(0), jcfg)
    tp = _port(jp)
    toks = np.random.default_rng(2).integers(0, 128, (2, 16)).astype(np.int32)
    want, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    with torch.no_grad():
        for chunk in (4, 16):
            got, _ = TM.forward(
                tp, _tcfg(dataclasses.replace(jcfg, chunk_size=chunk)),
                {"tokens": torch.from_numpy(toks)}, remat=False)
            np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-4)


K = 4


def test_rwkv6_train_step_matches_the_reference():
    """K = 4 agents on the RWKV6 smoke config, agent 3 additive at +1000,
    rs_mm on the kernel backend (its plain version on the CPU), SGD at
    lr 1 without clip: the aggregate is p0 - p1 on the reference's side.
    Tolerance: the aggregate atol 5e-5 (RWKV6's gradient tolerance in
    test_torch_lm_model.py) with rtol 1e-5; loss rtol 1e-6; grad_norm
    and consensus rtol 1e-5."""
    jcfg, tcfg = jconfigs.load_smoke("rwkv6_1p6b"), \
        tconfigs.load_smoke("rwkv6_1p6b")
    jp = JM.init_model(jax.random.key(0), jcfg)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2 * K, 9)).astype(np.int32)
    kw = dict(aggregation="rs_mm", use_kernel=True)
    okw = dict(name="sgd", learning_rate=1.0, grad_clip=0.0, warmup_steps=0,
               schedule_kind="constant")
    byz = dict(num_malicious=1, attack="additive",
               attack_kwargs=(("delta", 1000.0),))
    jstep, _ = JS.make_train_step_gspmd(
        jcfg, jconfigs.ParallelConfig(**kw), JO.OptimizerConfig(**okw),
        make_host_mesh(), jatt.ByzantineConfig(**byz), k_agents=K,
        consensus_metric=True)
    jp1, _, jm = jax.jit(jstep)(jp, JO.init(JO.OptimizerConfig(**okw), jp),
                                {"tokens": jnp.asarray(toks)})
    tp = _port(jp)
    ocfg = TO.OptimizerConfig(**okw)
    tstep = TS.make_train_step_gspmd(
        tcfg, tconfigs.ParallelConfig(**kw), ocfg, "cpu",
        tatt.ByzantineConfig(**byz), k_agents=K, consensus_metric=True)
    _, topt1, tm = tstep(tp, TO.init(ocfg, tp),
                         {"tokens": torch.from_numpy(toks)})
    assert topt1.step == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["consensus"]), float(jm["consensus"]),
                               rtol=1e-5)
    names = pytree.leaf_paths(tp)
    assert len(names) == 26
    p0 = dict(zip(names, jax.tree.leaves(jp)))
    p1 = dict(zip(names, jax.tree.leaves(jp1)))
    for name, est, stack in zip(names, tstep.last_aggregate,
                                tstep.last_stacks):
        want = np.asarray(p0[name]) - np.asarray(p1[name])
        np.testing.assert_allclose(_np(est), want, atol=5e-5, rtol=1e-5,
                                   err_msg=name)
        assert bool(torch.isfinite(stack).all())
        assert float(stack[K - 1].min()) > 900.0     # the attacker's row


def test_rwkv6_serve_steps_match_the_reference():
    jcfg, tcfg = jconfigs.load_smoke("rwkv6_1p6b"), \
        tconfigs.load_smoke("rwkv6_1p6b")
    jp = JM.init_model(jax.random.key(2), jcfg)
    tp = _port(jp)
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (3, 8)).astype(np.int32)
    mesh = make_host_mesh()
    want = jax.jit(JS.make_prefill_step(jcfg, mesh))(
        jp, {"tokens": jnp.asarray(toks)})
    got = TS.make_prefill_step(tcfg, "cpu")(tp, {"tokens": torch.from_numpy(
        toks)})
    assert got.shape == (3, 1, jcfg.padded_vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    jdec = jax.jit(JS.make_decode_step(jcfg, mesh))
    tdec = TS.make_decode_step(tcfg, "cpu")
    jc = JM.init_cache(jcfg, 3, 12)
    tc = TM.init_cache(tcfg, 3, 12, device="cpu")
    jt, tt = jnp.asarray(toks[:, :1]), torch.from_numpy(toks[:, :1])
    for _ in range(5):
        jt, jc = jdec(jp, jt, jc)
        tt, tc = tdec(tp, tt, tc)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(_np(tc["blocks"]["state"]),
                               np.asarray(jc["blocks"]["state"]), atol=2e-5,
                               rtol=1e-5)


def test_substrate_paradigm_trains_rwkv6():
    """The substrate paradigm on ``rwkv6-1.6b``'s smoke config, kernel
    backend, one attacker: finite, and one launch plan per aggregated
    leaf layout."""
    sp = scenarios.ScenarioSpec(
        paradigm="substrate", model_config="rwkv6-1.6b",
        aggregator="mm_tukey", backend="pallas", attack="additive",
        num_malicious=1, num_agents=4, num_steps=2,
        paradigm_kwargs=(("batch_per_agent", 1), ("seq_len", 8)))
    res = scenarios.run(sp, device="cpu")
    assert res.finite()
    model, opt = res.final_state
    assert isinstance(model, TM.Model) and opt.step == sp.num_steps
    widths = {leaf.numel() for leaf in pytree.flatten(model.tree())[0]}
    assert res.launch_audit["n_layouts"] == len(widths) > 1


def test_launch_train_makes_the_audio_batch(capsys):
    losses = train.main(["--device", "cpu", "--arch", "seamless-m4t-large-v2",
                         "--steps", "2", "--agents", "2", "--malicious", "1",
                         "--use-kernel", "--seq", "8", "--batch", "2"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "arch=seamless-m4t-large-v2" in capsys.readouterr().out
    sp = scenarios.ScenarioSpec(
        paradigm="substrate", model_config="seamless-m4t-large-v2",
        num_agents=2, num_steps=1,
        paradigm_kwargs=(("batch_per_agent", 1), ("seq_len", 8)))
    assert scenarios.run(sp, device="cpu").finite()


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_full_config_leaves_match_the_reference(arch):
    jcfg, tcfg = jconfigs.load_arch(arch).model, \
        tconfigs.load_arch(arch).model
    shapes = jax.eval_shape(lambda k: JM.init_model(k, jcfg),
                            jax.random.key(0))
    jpaths = [".".join(str(k.key) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    model = TM.init_model(tcfg, generator=torch.Generator(), device="meta")
    tree = model.tree()
    assert pytree.leaf_paths(tree) == jpaths
    got = [tuple(t.shape) for t in pytree.flatten(tree)[0]]
    assert got == [s.shape for s in jax.tree.leaves(shapes)]
    n = sum(math.prod(s) for s in got)
    if arch == "rwkv6_1p6b":
        assert (n, len(got)) == (1_583_943_680, 26)
    if arch == "zamba2_2p7b":
        assert tree["mamba_groups"]["mamba"]["in_proj"].shape == \
            (9, 6, 2560, 10448)
        assert tree["shared"]["attn"]["wq"].shape == (2560, 2560)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_bf16_forward_matches_the_reference(arch):
    """bf16 activations on the smoke config: logits within 2^-5 of the
    largest (the packages' bf16 products round at different points), as
    the dense family's bf16 test holds them."""
    jcfg = dataclasses.replace(jconfigs.load_smoke(arch), act_dtype="bfloat16")
    jp = JM.init_model(jax.random.key(0), jcfg)
    tp = _port(jp)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 16))
             .astype(np.int32)}
    if jcfg.arch_type == "audio":
        batch["frames"] = rng.normal(size=(2, jcfg.num_prefix_tokens,
                                           jcfg.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p, b: JM.forward(p, jcfg, b, remat=False))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, _ = TM.forward(tp, _tcfg(jcfg), {k: torch.from_numpy(v)
                                              for k, v in batch.items()},
                            remat=False)
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), w, atol=2 ** -5 * np.abs(w).max())


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_bf16_decode_at_full_depth_holds_the_serve_tolerance(arch):
    """The rehearsal of chip_smoke.py's serve gates: each full config at
    its full depth (24; 54; 24 + 24) and a narrow width, bf16, random
    weights; a 32-token prompt through the forward (one chunk) and
    through the decode step (chunks of 1), the first 8 positions held to
    2^-4 x max(1, |logits|_inf); then the same in f32 activations within
    1e-3 x max(1, |logits|_inf).  (At full width the card's gate also allows
    twice the bf16 forward's own distance from the f32 forward, which
    this width does not need.)"""
    full = tconfigs.load_arch(arch).model
    narrow = dict(d_model=128, d_ff=256, vocab_size=512)
    if full.arch_type == "hybrid":
        narrow.update(num_heads=2, num_kv_heads=2, head_dim=64)
    if full.arch_type == "audio":
        narrow.update(num_heads=2, num_kv_heads=2, head_dim=64,
                      num_prefix_tokens=32)
    cfg = dataclasses.replace(full, **narrow)
    assert cfg.act_dtype == "bfloat16"
    model = TM.init_model(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, 512, (2, 32), generator=g, dtype=torch.int32)
    batch = {"tokens": prompt}
    frames = None
    if cfg.arch_type == "audio":
        frames = 0.02 * torch.randn((2, 32, 128), generator=g,
                                    dtype=torch.bfloat16)
        batch["frames"] = frames
    with torch.no_grad():
        want, _ = TM.forward(model, cfg, batch, remat=False)
        got, _ = _port_decode(model.tree(), cfg, prompt[:, :8], frames, 8)
    want = want[:, :8, :512].float()
    err = float((got[..., :512].float() - want).abs().max())
    assert err <= SERVE_TOL * max(1.0, float(want.abs().max())), err
    # the f32 gate beside it: f32 activations, decode within 1e-3 of the
    # largest logit
    cfg32 = dataclasses.replace(cfg, act_dtype="float32")
    with torch.no_grad():
        want, _ = TM.forward(model, cfg32, batch, remat=False)
        got, _ = _port_decode(model.tree(), cfg32, prompt[:, :8], frames, 8)
    want = want[:, :8, :512]
    err = float((got[..., :512] - want).abs().max())
    assert err <= 1e-3 * max(1.0, float(want.abs().max())), err
