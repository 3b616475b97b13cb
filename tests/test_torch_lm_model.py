"""The port's decoder transformer (``repro_torch.models.model``) against
the JAX reference (CPU): the same parameters (a JAX tree crossed with
``interop.from_numpy_tree``), the same numpy tokens.

Every family's ``smoke_config()`` (dense, MoE, VLM, RWKV6, Zamba2, the
encoder-decoder): logits, loss and every leaf's gradient.  Then decode
equal to forward (GQA with qk-norm and biases; the sliding-window ring
cache), remat leaving values unchanged, the pad-class mask of a vocab
that is not a multiple of 256, the VLM prefix outside the logits, one
bf16-activation forward, the module's names and leaf order, and the
configs.  The RWKV6, Zamba2 and encoder-decoder families' own cases are
in ``test_torch_lm_families.py``.

Tolerances: f32 logits atol 2e-5, loss rtol 1e-6, gradients atol 2e-5
(sums in another order) -- RWKV6's 5e-5: at initialisation its bonus
and state are 0, so the first token's head output is exactly 0 and the
per-head norm scales its gradient by rsqrt(1e-5) = 316, which shows
f32 rounding in ``embed`` at 3.2e-5 (with a random bonus the same
comparison gives 9.5e-7); bf16 logits within 2^-5 of the largest
logit (the packages' bf16 products round at different points).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch import interop, pytree
from repro_torch.models import model as TM


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: in a parallel run each worker's default
    pool spins against the other workers', and these small-tensor tests
    ran 30-50x slower there than alone (alone, one thread is as fast)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LM_ARCHS = ("qwen3_0p6b", "qwen3_32b", "qwen1p5_110b", "stablelm_3b",
            "dbrx_132b", "qwen3_moe_235b_a22b", "llava_next_34b",
            "rwkv6_1p6b", "zamba2_2p7b", "seamless_m4t_large_v2")
GRAD_ATOL = {"rwkv6_1p6b": 5e-5}


def _params(jcfg, seed=0):
    jp = JM.init_model(jax.random.key(seed), jcfg)
    return jp, interop.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")


def _port_cfg(jcfg):
    return tconfigs.ModelConfig(**dataclasses.asdict(jcfg))


def _batch(cfg, b=2, t=17, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.arch_type in ("vlm", "audio"):
        batch["prefix" if cfg.arch_type == "vlm" else "frames"] = rng.normal(
            size=(b, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(t):
    return interop.to_numpy(t)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_config_logits_loss_and_grads_match(arch):
    jcfg, tcfg = jconfigs.load_smoke(arch), tconfigs.load_smoke(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg)
    inp = dict(batch, tokens=batch["tokens"][:, :-1])
    want, waux = jax.jit(lambda p, b: JM.forward(p, jcfg, b, remat=False))(
        jp, _j(inp))
    got, gaux = TM.forward(tp, tcfg, _t(inp), remat=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(float(gaux), float(waux), atol=1e-6, rtol=1e-6)

    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b)))(jp, _j(batch))
    leaves = pytree.flatten(tp)[0]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tl = TM.loss_fn(tp, tcfg, _t(batch))
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(tg, jleaves):
        np.testing.assert_allclose(_np(a), np.asarray(b),
                                   atol=GRAD_ATOL.get(arch, 2e-5), rtol=1e-5)


def _decode_all(params, cfg, toks, cache_len):
    cache = TM.init_cache(cfg, toks.shape[0], cache_len, device="cpu")
    outs = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            lg, cache = TM.decode_step(params, cfg, toks[:, t:t + 1], cache)
            outs.append(lg[:, 0])
    return torch.stack(outs, dim=1), cache


@pytest.mark.parametrize("kw,steps", [
    (dict(qk_norm=True, qkv_bias=True), 12),      # GQA, qk-norm, biases
    (dict(sliding_window=4), 14),                 # the ring cache
    (dict(num_experts=4, experts_per_tok=2), 10),  # decode's MoE routing
])
def test_decode_equals_forward_and_the_reference_decode(kw, steps):
    jcfg = jconfigs.ModelConfig(
        name="d", arch_type="moe" if "num_experts" in kw else "dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=128, **kw)
    tcfg = _port_cfg(jcfg)
    jp, tp = _params(jcfg)
    toks = np.random.default_rng(1).integers(0, 128, (2, steps)).astype(np.int32)
    full, _ = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                         remat=False)
    dec, cache = _decode_all(tp, tcfg, torch.from_numpy(toks), steps + 4)
    if "num_experts" not in kw:     # decode routes a token a group
        np.testing.assert_allclose(_np(dec), _np(full), atol=3e-4)
    jcache = JM.init_cache(jcfg, 2, steps + 4)
    step = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))
    for t in range(steps):
        jlg, jcache = step(jp, jnp.asarray(toks[:, t:t + 1]), jcache)
    np.testing.assert_allclose(_np(dec[:, -1]), np.asarray(jlg[:, 0]),
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(cache["blocks"]["k"]),
                               np.asarray(jcache["blocks"]["k"]), atol=2e-5)


def test_remat_does_not_change_values():
    cfg = tconfigs.ModelConfig(name="rm", arch_type="dense", num_layers=2,
                               d_model=64, num_heads=4, num_kv_heads=2,
                               d_ff=128, vocab_size=128, q_chunk=4)
    model = TM.init_model(cfg, seed=0, device="cpu")
    toks = torch.randint(0, 128, (2, 17), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    out = []
    for remat in (True, False):
        loss = TM.loss_fn(model, cfg, {"tokens": toks}, remat=remat)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


def test_pad_classes_are_masked_like_the_reference():
    jcfg = jconfigs.ModelConfig(name="pv", arch_type="dense", num_layers=1,
                                d_model=64, num_heads=4, num_kv_heads=2,
                                d_ff=128, vocab_size=300)
    assert jcfg.padded_vocab == 512
    tcfg = _port_cfg(jcfg)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, t=9)
    inp = dict(batch, tokens=batch["tokens"][:, :-1])
    want, _ = jax.jit(lambda p, b: JM.forward(p, jcfg, b, remat=False))(
        jp, _j(inp))
    got, _ = TM.forward(tp, tcfg, _t(inp), remat=False)
    assert got.shape == (2, 8, 512)
    np.testing.assert_array_equal(_np(got)[..., 300:], np.asarray(want)[..., 300:])
    assert bool((got[..., 300:] == torch.finfo(torch.float32).min).all())
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5, rtol=1e-5)
    with torch.no_grad():
        tl = TM.loss_fn(tp, tcfg, _t(batch))
    jl = jax.jit(lambda p, b: JM.loss_fn(p, jcfg, b))(jp, _j(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


def test_vlm_prefix_region_excluded_from_logits():
    jcfg = jconfigs.ModelConfig(name="v", arch_type="vlm", num_layers=2,
                                d_model=64, num_heads=4, num_kv_heads=2,
                                d_ff=128, vocab_size=128, num_prefix_tokens=8)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, t=10)
    want, _ = jax.jit(lambda p, b: JM.forward(p, jcfg, b, remat=False))(
        jp, _j(batch))
    got, _ = TM.forward(tp, _port_cfg(jcfg), _t(batch), remat=False)
    assert got.shape == (2, 10, jcfg.padded_vocab)
    assert bool((got[..., jcfg.vocab_size:] < -1e30).all())
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5, rtol=1e-5)


def test_bf16_activation_forward_matches():
    jcfg = dataclasses.replace(jconfigs.load_smoke("qwen3_0p6b"),
                               act_dtype="bfloat16", q_chunk=8, vocab_size=500)
    jp, tp = _params(jcfg)
    tcfg = _port_cfg(jcfg)
    batch = _batch(jcfg)
    want, _ = jax.jit(lambda p, b: JM.forward(p, jcfg, b, remat=False))(
        jp, _j(batch))
    got, _ = TM.forward(tp, tcfg, _t(batch), remat=False)
    # the masked pad classes promote the logits to f32 in both packages
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    w = np.asarray(want)[..., :500]
    np.testing.assert_allclose(_np(got)[..., :500], w,
                               atol=2 ** -5 * np.abs(w).max())
    with torch.no_grad():
        tl = TM.loss_fn(tp, tcfg, _t(batch))
    jl = jax.jit(lambda p, b: JM.loss_fn(p, jcfg, b))(jp, _j(batch))
    np.testing.assert_allclose(float(tl), float(jl), atol=5e-3)


def test_model_module_holds_the_reference_leaves():
    jcfg = jconfigs.load_smoke("qwen3_0p6b")
    jp, tp = _params(jcfg)
    model = TM.Model(_port_cfg(jcfg), tp)
    names = {n for n, _ in model.named_parameters()}
    assert names == set(pytree.leaf_paths(tp))
    assert "blocks.attn.wq" in names and len(names) == 14
    jpaths = [".".join(str(k.key) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert pytree.leaf_paths(model.tree()) == jpaths
    assert model.tree()["blocks"]["attn"]["wq"].shape == (2, 128, 128)
    full = tconfigs.load_arch("qwen3-0.6b").model
    assert (full.padded_vocab, full.head_dim) == (152_064, 128)


def test_configs_match_the_reference():
    for arch in jconfigs.ARCH_IDS:
        ja, ta = jconfigs.load_arch(arch), tconfigs.load_arch(arch)
        assert dataclasses.asdict(ja) == dataclasses.asdict(ta), arch
        assert ja.model.param_count() == ta.model.param_count()
        assert dataclasses.asdict(jconfigs.load_smoke(arch)) == \
            dataclasses.asdict(tconfigs.load_smoke(arch))
    assert tconfigs.resolve_arch("qwen3-0.6b") == "qwen3_0p6b"
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.resolve_arch("gpt-5")
    shape = tconfigs.INPUT_SHAPES["long_500k"]
    m = tconfigs.model_for_shape(tconfigs.load_arch("qwen3-0.6b").model, shape)
    assert m.sliding_window == tconfigs.LONG_CONTEXT_WINDOW
