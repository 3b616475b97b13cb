"""The port's transformer layers against the JAX reference on identical
numpy inputs (CPU): norms, RoPE, attention (causal, sliding window,
query-chunked equal to full), the ring-cache decode, the MLP and the
MoE FFN.  Tolerance: f32 at atol 2e-5 / rtol 1e-5 (sums run in another
order); the MoE inputs have no tied router probabilities, so
``torch.topk`` and ``jax.lax.top_k`` route alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import moe as JMOE
from repro_torch import interop
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE

ATOL, RTOL = 2e-5, 1e-5


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _tree(tree_np):
    return interop.from_numpy_tree(tree_np, "cpu")


def _np_tree(jtree):
    return jax.tree.map(np.asarray, jtree)


def _dims(**kw):
    base = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                qk_norm=True, qkv_bias=True, rope_theta=10_000.0,
                norm_eps=1e-5)
    base.update(kw)
    return JL.AttnDims(**base), TL.AttnDims(**base)


def _attn_params(jd, seed=0):
    p = _np_tree(JL.init_attention(jax.random.key(seed), jd))
    rng = np.random.default_rng(seed)
    # non-trivial biases and norm weights, so both paths are exercised
    for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if name in p:
            p[name] = (p[name] + 0.1 * rng.normal(size=p[name].shape)
                       ).astype(np.float32)
    return p


def test_norms_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32) * 3.0
    w = rng.normal(size=(16,)).astype(np.float32)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    _close(TL.head_rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           JL.head_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    pos = np.broadcast_to(np.arange(5, dtype=np.int32) * 37, (2, 5)).copy()
    _close(TL.rope_freqs(16, 1e6), JL.rope_freqs(16, 1e6), atol=0, rtol=1e-6)
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), atol=5e-5)


def test_bf16_rms_norm_computes_in_f32_and_casts_back():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = TL.rms_norm(tx, torch.from_numpy(w).to(torch.bfloat16), 1e-5)
    want = JL.rms_norm(jx, jnp.asarray(w, jnp.bfloat16), 1e-5)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # both round the same f32 value to bf16: equal up to one bf16 step
    np.testing.assert_allclose(interop.to_numpy(got),
                               np.asarray(want, np.float32), rtol=2 ** -7)


@pytest.mark.parametrize("window,q_chunk,causal", [
    (0, 1024, True),     # full causal, one chunk
    (0, 4, True),        # four query chunks, each recomputed in backward
    (5, 4, True),        # sliding window across chunks
    (0, 16, False),      # encoder self-attention
])
def test_attention_fwd_matches(window, q_chunk, causal):
    jd, td = _dims(sliding_window=window, q_chunk=q_chunk, causal=causal)
    p = _attn_params(jd)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    want, (wk, wv) = jax.jit(JL.attention_fwd, static_argnums=2)(
        p, jnp.asarray(x), jd, jnp.asarray(pos))
    got, (gk, gv) = TL.attention_fwd(_tree(p), torch.from_numpy(x), td,
                                     torch.from_numpy(pos))
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


def test_query_chunks_equal_one_chunk_with_gradients():
    jd, td4 = _dims(q_chunk=4)
    _, td_full = _dims(q_chunk=1024)
    p = _tree(_attn_params(jd, seed=3))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 16, 64)).astype(np.float32))
    pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
    outs, grads = [], []
    for dims in (td4, td_full):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        out, _ = TL.attention_fwd(leaves, x, dims, pos)
        outs.append(out)
        grads.append(torch.autograd.grad(out.square().sum(),
                                         list(leaves.values())))
    _close(outs[0], interop.to_numpy(outs[1]))
    for a, b in zip(*grads):
        _close(a, interop.to_numpy(b), atol=1e-4)


@pytest.mark.parametrize("window,cache_len,steps", [(0, 12, 10), (4, 4, 11)])
def test_attention_decode_and_ring_cache_match(window, cache_len, steps):
    jd, td = _dims(sliding_window=window)
    p = _attn_params(jd, seed=4)
    tp = _tree(p)
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(steps, 2, 1, 64)).astype(np.float32)
    jc = JL.init_kv_cache(2, jd, cache_len, jnp.float32)
    tc = TL.init_kv_cache(2, td, cache_len, torch.float32)
    decode = jax.jit(JL.attention_decode, static_argnums=2)
    for t in range(steps):
        want, jc = decode(p, jnp.asarray(xs[t]), jd, jc)
        got, tc = TL.attention_decode(tp, torch.from_numpy(xs[t]), td, tc)
        _close(got, want)
    _close(tc["k"], jc["k"])
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    pos = np.array([3, 9], np.int32)
    np.testing.assert_array_equal(
        TL.cache_abs_positions(torch.from_numpy(pos), 4, 4).numpy(),
        np.asarray(JL.cache_abs_positions(jnp.asarray(pos), 4, 4)))


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches(gated):
    p = _np_tree(JL.init_mlp(jax.random.key(5), 32, 64, gated))
    x = np.random.default_rng(5).normal(size=(2, 3, 32)).astype(np.float32)
    _close(TL.mlp_fwd(_tree(p), torch.from_numpy(x), gated),
           JL.mlp_fwd(p, jnp.asarray(x), gated))


@pytest.mark.parametrize("gated,group_size,capacity_factor", [
    (True, 512, 1.25),     # one group: the whole sequence
    (False, 4, 1.25),      # GELU experts, several groups
    (True, 1, 2.0),        # the decode routing: one token a group
])
def test_moe_fwd_matches(gated, group_size, capacity_factor):
    e, k = 4, 2
    p = _np_tree(JMOE.init_moe(jax.random.key(6), 32, 48, e, gated))
    x = np.random.default_rng(6).normal(size=(2, 8, 32)).astype(np.float32)
    kw = dict(num_experts=e, top_k=k, gated=gated, group_size=group_size,
              capacity_factor=capacity_factor)
    want, waux = jax.jit(lambda p, x: JMOE.moe_fwd(p, x, **kw))(
        p, jnp.asarray(x))
    got, gaux = TMOE.moe_fwd(_tree(p), torch.from_numpy(x), **kw)
    _close(got, want)
    _close(gaux, waux, atol=1e-6)
