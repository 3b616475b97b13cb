"""The port's attention-free mixers (``repro_torch.models.ssm``) against
the JAX reference (CPU): Mamba2's causal conv and chunked SSD, RWKV6's
time mix and channel mix, on the same numpy inputs and the same
parameters (crossed with ``interop.from_numpy_tree``), with and without
carried state.  Outputs, carried-out states and every parameter's
gradient under one random cotangent are compared; then chunk-size
invariance, and the overflow of the reference's pairwise decays.

The parameters are the reference's initialisation with the decay and
skip terms drawn at random (``a_log``, ``dt_bias``; RWKV's ``w0`` and
``bonus``), so that every term of the chunked form carries weight.

Tolerances (f32, sums in another order): outputs and states atol 1e-5
with rtol 1e-5; gradients atol 1e-5 x max(1, the leaf's largest
|gradient|) -- their cotangent sums over every position.  Chunk-size
invariance: the reference's own 2e-4 on the outputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch import configs as tconfigs
from repro_torch import interop, pytree
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: in a parallel run each worker's default
    pool spins against the other workers', and these small-tensor tests
    ran 30-50x slower there than alone (alone, one thread is as fast)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, T = 2, 16


def _np(t):
    return interop.to_numpy(t)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol,
                               rtol=1e-5)


def _grad_close(tgrads, jgrads, names):
    assert len(tgrads) == len(jgrads)
    for name, a, b in zip(names, tgrads, jgrads):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(b).max()),
                                   err_msg=name)


def _mamba_cfg(**kw):
    base = dict(name="m", arch_type="hybrid", num_layers=2, d_model=32,
                num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                ssm_state=8, ssm_head_dim=8, attn_every=2, chunk_size=4)
    base.update(kw)
    return jconfigs.ModelConfig(**base)


def _mamba_params(cfg, rng):
    jp = JS.init_mamba2(jax.random.key(0), cfg.d_model, expand=cfg.ssm_expand,
                        head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state,
                        d_conv=cfg.ssm_conv)
    h = jp["a_log"].shape[0]
    jp = dict(jp, a_log=jnp.asarray(rng.normal(size=h).astype(np.float32)),
              dt_bias=jnp.asarray(rng.normal(size=h).astype(np.float32)),
              d_skip=jnp.asarray(rng.normal(size=h).astype(np.float32)))
    return jp, interop.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")


def _rwkv_params(d, hd, rng):
    jp = JS.init_rwkv6_timemix(jax.random.key(0), d, hd)
    jp = dict(jp,
              w0=jnp.asarray(rng.normal(size=d).astype(np.float32) - 1.0),
              bonus=jnp.asarray(rng.normal(size=jp["bonus"].shape)
                                .astype(np.float32)))
    return jp, interop.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")


def _leaves(tp):
    leaves = pytree.flatten(tp)[0]
    for leaf in leaves:
        leaf.requires_grad_(True)
    return leaves


@pytest.mark.parametrize("width,carried", [(4, False), (4, True), (1, True)])
def test_causal_conv_matches(width, carried):
    rng = np.random.default_rng(width)
    x = rng.normal(size=(B, T, 6)).astype(np.float32)
    w = rng.normal(size=(width, 6)).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    st = rng.normal(size=(B, width - 1, 6)).astype(np.float32) if carried \
        else None
    want, wstate = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(bias),
                                   None if st is None else jnp.asarray(st))
    got, gstate = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(bias),
                                  None if st is None else torch.from_numpy(st))
    _close(got, want)
    assert gstate.shape == wstate.shape == (B, width - 1, 6)
    _close(gstate, wstate)


@pytest.mark.parametrize("carried", [False, True])
def test_mamba2_fwd_matches_the_reference(carried):
    cfg = _mamba_cfg()
    tcfg = tconfigs.ModelConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(1)
    jp, tp = _mamba_params(cfg, rng)
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    ct = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    conv0, ssm0 = JS.init_mamba2_state(B, cfg, jnp.float32)
    if carried:
        conv0 = jnp.asarray(rng.normal(size=conv0.shape).astype(np.float32))
        ssm0 = jnp.asarray(rng.normal(size=ssm0.shape).astype(np.float32))
    states = (conv0, ssm0) if carried else (None, None)

    def jf(p, x):
        y, (conv, ssm) = JS.mamba2_fwd(p, x, cfg, *states)
        return jnp.sum(y * ct) + jnp.sum(ssm), (y, conv, ssm)

    (_, (jy, jconv, jssm)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jp, jnp.asarray(x))
    leaves = _leaves(tp)
    tstates = [None if s is None else torch.from_numpy(np.array(s))
               for s in states]
    ty, (tconv, tssm) = TS.mamba2_fwd(tp, torch.from_numpy(x), tcfg, *tstates)
    _close(ty, jy)
    _close(tconv, jconv)
    _close(tssm, jssm)
    v = torch.sum(ty * torch.from_numpy(ct)) + torch.sum(tssm)
    _grad_close(torch.autograd.grad(v, leaves), jax.tree.leaves(jg),
                pytree.leaf_paths(tp))
    # the one-token step: the forward at chunk length 1, from the states
    jd, (jdc, jds) = JS.mamba2_decode(jp, jnp.asarray(x[:, :1]), cfg,
                                      conv0, ssm0)
    with torch.no_grad():
        td, (tdc, tds) = TS.mamba2_decode(
            tp, torch.from_numpy(x[:, :1]), tcfg,
            torch.from_numpy(np.array(conv0)), torch.from_numpy(np.array(ssm0)))
    for got, want in ((td, jd), (tdc, jdc), (tds, jds)):
        _close(got, want)


@pytest.mark.parametrize("carried", [False, True])
def test_rwkv6_timemix_matches_the_reference(carried):
    d, hd = 64, 16
    rng = np.random.default_rng(2)
    jp, tp = _rwkv_params(d, hd, rng)
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    ct = rng.normal(size=(B, T, d)).astype(np.float32)
    last = rng.normal(size=(B, 1, d)).astype(np.float32) if carried else None
    st = rng.normal(size=(B, d // hd, hd, hd)).astype(np.float32) if carried \
        else None

    def jf(p, x):
        out, (lx, s) = JS.rwkv6_timemix(
            p, x, hd, 4, None if last is None else jnp.asarray(last),
            None if st is None else jnp.asarray(st))
        return jnp.sum(out * ct) + jnp.sum(s), (out, lx, s)

    (_, (jo, jlx, jst)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jp, jnp.asarray(x))
    leaves = _leaves(tp)
    to, (tlx, tst) = TS.rwkv6_timemix(
        tp, torch.from_numpy(x), hd, 4,
        None if last is None else torch.from_numpy(last),
        None if st is None else torch.from_numpy(st))
    _close(to, jo)
    _close(tlx, jlx)
    _close(tst, jst)
    v = torch.sum(to * torch.from_numpy(ct)) + torch.sum(tst)
    _grad_close(torch.autograd.grad(v, leaves), jax.tree.leaves(jg),
                pytree.leaf_paths(tp))


@pytest.mark.parametrize("carried", [False, True])
def test_rwkv6_channelmix_matches_the_reference(carried):
    d, f = 64, 96
    rng = np.random.default_rng(3)
    jp = JS.init_rwkv6_channelmix(jax.random.key(1), d, f)
    tp = interop.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    ct = rng.normal(size=(B, T, d)).astype(np.float32)
    last = rng.normal(size=(B, 1, d)).astype(np.float32) if carried else None

    def jf(p, x):
        out, lx = JS.rwkv6_channelmix(
            p, x, None if last is None else jnp.asarray(last))
        return jnp.sum(out * ct), (out, lx)

    (_, (jo, jlx)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jp, jnp.asarray(x))
    leaves = _leaves(tp)
    to, tlx = TS.rwkv6_channelmix(
        tp, torch.from_numpy(x),
        None if last is None else torch.from_numpy(last))
    _close(to, jo)
    _close(tlx, jlx)
    v = torch.sum(to * torch.from_numpy(ct))
    _grad_close(torch.autograd.grad(v, leaves), jax.tree.leaves(jg),
                pytree.leaf_paths(tp))


@pytest.mark.parametrize("mixer", ["mamba2", "rwkv6"])
def test_chunk_size_does_not_change_the_result(mixer):
    """Chunks of 1, 4 (whole), 6 (falls to the divisor 4 at T = 16) and
    16 give one result, and the reference's at chunk 4."""
    rng = np.random.default_rng(4)
    outs = []
    if mixer == "mamba2":
        cfg = _mamba_cfg()
        jp, tp = _mamba_params(cfg, rng)
        x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
        want, _ = JS.mamba2_fwd(jp, jnp.asarray(x), cfg)
        for c in (1, 4, 6, 16):
            tcfg = tconfigs.ModelConfig(**dataclasses.asdict(
                dataclasses.replace(cfg, chunk_size=c)))
            outs.append(TS.mamba2_fwd(tp, torch.from_numpy(x), tcfg))
    else:
        jp, tp = _rwkv_params(64, 16, rng)
        x = rng.normal(size=(B, T, 64)).astype(np.float32)
        want, _ = JS.rwkv6_timemix(jp, jnp.asarray(x), 16, 4)
        outs = [TS.rwkv6_timemix(tp, torch.from_numpy(x), 16, c)
                for c in (1, 4, 6, 16)]
    for out, (conv_or_last, state) in outs:
        np.testing.assert_allclose(_np(out), np.asarray(want), atol=2e-4)
        np.testing.assert_allclose(_np(state), _np(outs[0][1][1]), atol=2e-4)
    assert TS._chunk_len(6, 16) == 4 and TS._chunk_len(8, 17) == 1


def _overflow_case(mixer):
    """A model whose chunk of 64 overflows the reference's pairwise
    decays: Mamba2 with 16 heads (a reaches -16) at chunk 64, T = 64;
    RWKV6 with w0 = 1 (log-decay -e a step) at chunk 64."""
    if mixer == "mamba2":
        cfg = jconfigs.ModelConfig(
            name="ov", arch_type="hybrid", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128,
            ssm_state=16, ssm_head_dim=8, attn_every=2, chunk_size=64)
        jp = JM.init_model(jax.random.key(0), cfg)
    else:
        cfg = jconfigs.ModelConfig(
            name="ov", arch_type="ssm", num_layers=2, d_model=64,
            num_heads=0, num_kv_heads=0, d_ff=128, vocab_size=128,
            ssm_head_dim=16, chunk_size=64)
        jp = JM.init_model(jax.random.key(0), cfg)
        tm = jp["blocks"]["tm"]
        tm["w0"] = jnp.ones_like(tm["w0"])
        tm["bonus"] = jnp.asarray(np.random.default_rng(6).normal(
            size=tm["bonus"].shape).astype(np.float32))
    toks = np.random.default_rng(5).integers(0, 128, (2, 65)).astype(np.int32)
    return cfg, jp, toks


@pytest.mark.parametrize("mixer,finite_chunk", [("mamba2", 2), ("rwkv6", 8)])
def test_masked_decay_exponent_keeps_gradients_finite(mixer, finite_chunk):
    """The deliberate divergence: where the reference's gradient is NaN
    (its masked pairs' exp overflows before the mask), the port's is
    finite and equals the reference's at a chunk short enough for the
    reference to stay finite (Mamba2: 2 -- with 16 heads ``a`` reaches
    -16, and at chunk 4 the reference still overflows here; RWKV6: 8).

    Gradient tolerance atol 1e-4 x max(1, |g|_inf), rtol 1e-5: a
    different chunk length sums in another order, and RWKV6's embedding
    gradient carries that at 4.7e-5 of its scale (the port against
    itself at chunks 64, 8 and 1) -- the other leaves agree to 1e-5."""
    cfg, jp, toks = _overflow_case(mixer)
    batch = {"tokens": jnp.asarray(toks)}
    grad = jax.jit(jax.value_and_grad(
        lambda p, c: JM.loss_fn(p, c, batch, remat=False)),
        static_argnums=1)
    jl, jg = grad(jp, cfg)
    assert np.isfinite(float(jl))
    paths = [".".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    nonfinite = {p for p, g in zip(paths, jax.tree.leaves(jg))
                 if not bool(jnp.isfinite(g).all())}
    assert nonfinite                               # the reference's NaN
    if mixer == "mamba2":   # every leaf upstream of the Mamba2 layers
        assert nonfinite == {p for p in paths if p == "embed"
                             or p.startswith("mamba_groups.")}, nonfinite
    jlc, jgc = grad(jp, dataclasses.replace(cfg, chunk_size=finite_chunk))
    assert all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(jgc))

    tp = interop.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    leaves = _leaves(tp)
    tl = TM.loss_fn(tp, tconfigs.ModelConfig(**dataclasses.asdict(cfg)),
                    {"tokens": torch.from_numpy(toks)}, remat=False)
    tg = torch.autograd.grad(tl, leaves)
    assert all(bool(torch.isfinite(g).all()) for g in tg)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tl.detach()), float(jlc), rtol=1e-5)
    for name, a, b in zip(pytree.leaf_paths(tp), tg, jax.tree.leaves(jgc)):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=1e-5,
                                   atol=1e-4 * max(1.0, np.abs(b).max()),
                                   err_msg=name)
