"""Shared neural building blocks (``repro.models.layers``): pure
functions over explicit parameter dicts.

Conventions, the reference's:
  * params are plain dicts of tensors; init_* draws from a
    ``torch.Generator``
  * stacked layers: leaves get a leading (L, ...) axis and each layer
    indexes its slice
  * activations run in ``cfg.act_dtype`` (bf16 in production configs),
    params are float32 masters cast at use
  * every cast mirrors the reference's: norms and RoPE compute in f32
    and cast back, attention scores and softmax are f32, masks are an
    additive ``finfo(f32).min`` bias

Attention is the reference's query-chunked softmax written as plain
PyTorch einsums; each chunk is recomputed in backward
(``torch.utils.checkpoint``) so backward never holds every chunk's
(B, KV, G, q_chunk, S) f32 probabilities at once.  Cross-attention
(the encoder-decoder family) is query-chunked the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32_MIN = torch.finfo(torch.float32).min

# ---------------------------------------------------------------------------
# initializers / norms
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = fan_in ** -0.5
    return scale * torch.randn(tuple(shape), generator=generator, dtype=dtype,
                               device=device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight).to(dt)


def head_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """qk-norm: RMSNorm over the head_dim of (..., heads, head_dim)."""
    return rms_norm(x, weight, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D), positions: (B, S) int."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (half,)
    ang = positions[..., None].float() * freqs                   # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + qk-norm + bias + sliding window + KV cache decode)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool
    qkv_bias: bool
    rope_theta: float
    norm_eps: float
    sliding_window: int = 0       # 0 = full causal
    causal: bool = True           # False for encoder self-attention
    q_chunk: int = 1024           # query-chunked attention for long seqs


def init_attention(generator: torch.Generator, dims: AttnDims,
                   device="cpu") -> dict:
    d, h, kv, hd = dims.d_model, dims.num_heads, dims.num_kv_heads, dims.head_dim
    p = {
        "wq": dense_init(generator, (d, h * hd), device=device),
        "wk": dense_init(generator, (d, kv * hd), device=device),
        "wv": dense_init(generator, (d, kv * hd), device=device),
        "wo": dense_init(generator, (h * hd, d), device=device),
    }
    if dims.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), device=device)
        p["bk"] = torch.zeros((kv * hd,), device=device)
        p["bv"] = torch.zeros((kv * hd,), device=device)
    if dims.qk_norm:
        p["q_norm"] = torch.ones((hd,), device=device)
        p["k_norm"] = torch.ones((hd,), device=device)
    return p


def _project_qkv(p: dict, x: torch.Tensor, dims: AttnDims,
                 positions: torch.Tensor):
    b, s, _ = x.shape
    h, kv, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if dims.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if dims.qk_norm:
        q = head_rms_norm(q, p["q_norm"].to(dt), dims.norm_eps)
        k = head_rms_norm(k, p["k_norm"].to(dt), dims.norm_eps)
    q = apply_rope(q, positions, dims.rope_theta)
    k = apply_rope(k, positions, dims.rope_theta)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, dims: AttnDims) -> torch.Tensor:
    """q: (B, Sq, H, D), k: (B, Sk, KV, D) -> (B, KV, G, Sq, Sk)."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    return torch.einsum("bqkgd,bskd->bkgqs", qg, k) / (hd ** 0.5)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B, KV, G, Sq, Sk), v: (B, Sk, KV, D) -> (B, Sq, H*D)."""
    b, kv, g, sq, _ = probs.shape
    hd = v.shape[-1]
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, kv * g * hd)


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, F32_MIN)


def attention_fwd(p: dict, x: torch.Tensor, dims: AttnDims,
                  positions: torch.Tensor, kv_positions=None):
    """Full-sequence attention (train / prefill).

    Query-chunked: the (Sq, Sk) score matrix never materializes for
    more than ``q_chunk`` query rows, and with several chunks each is
    recomputed in backward.  Returns (out, (k, v)) so prefill can build
    the cache.
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, dims, positions)
    kpos = positions if kv_positions is None else kv_positions
    dt = x.dtype

    qc = min(dims.q_chunk, s)
    while s % qc:
        qc -= 1

    def chunk_attn(q_blk, qpos_blk, k, v):
        scores = _gqa_scores(q_blk, k, dims).float()
        mask = torch.ones((b, 1, 1, q_blk.shape[1], s), dtype=torch.bool,
                          device=x.device)
        if dims.causal:
            mask = mask & (kpos[:, None, None, None, :]
                           <= qpos_blk[:, None, None, :, None])
        if dims.sliding_window:
            mask = mask & (kpos[:, None, None, None, :]
                           > qpos_blk[:, None, None, :, None]
                           - dims.sliding_window)
        probs = torch.softmax(scores + _mask_bias(mask), dim=-1)
        return _gqa_out(probs.to(dt), v)

    if qc == s:
        out = chunk_attn(q, positions, k, v)
    else:
        outs = [checkpoint(chunk_attn, q[:, lo:lo + qc],
                           positions[:, lo:lo + qc], k, v, use_reentrant=False)
                for lo in range(0, s, qc)]
        out = torch.cat(outs, dim=1)

    out = out @ p["wo"].to(dt)
    return out, (k, v)


def attention_decode(p: dict, x: torch.Tensor, dims: AttnDims, cache: dict):
    """One-token decode against a (possibly ring-buffer) KV cache.

    cache = {"k": (B, S_c, KV, D), "v": ..., "pos": (B,) int next position}
    Ring semantics when dims.sliding_window > 0 and S_c == window.  The
    input cache is left as it was; the new one is returned.
    """
    b = x.shape[0]
    pos = cache["pos"]                                   # (B,)
    q, k_new, v_new = _project_qkv(p, x, dims, pos[:, None])
    s_c = cache["k"].shape[1]
    ring = bool(dims.sliding_window) and s_c == dims.sliding_window

    slot = (pos % dims.sliding_window if ring else pos).long()
    bidx = torch.arange(b, device=x.device)
    k = cache["k"].index_put((bidx, slot), k_new[:, 0])
    v = cache["v"].index_put((bidx, slot), v_new[:, 0])

    # validity + causality mask over cache slots
    if ring:
        kpos = cache_abs_positions(pos, s_c, dims.sliding_window)
        age = pos[:, None] - kpos
        valid = (age >= 0) & (age < dims.sliding_window) & (kpos >= 0)
    else:
        slots = torch.arange(s_c, device=x.device)[None, :]   # (1, S_c)
        valid = slots <= pos[:, None]

    scores = _gqa_scores(q, k, dims).float()             # (B, KV, G, 1, S_c)
    probs = torch.softmax(scores + _mask_bias(valid[:, None, None, None, :]),
                          dim=-1)
    out = _gqa_out(probs.to(x.dtype), v) @ p["wo"].to(x.dtype)
    return out, {"k": k, "v": v, "pos": pos + 1}


def cache_abs_positions(pos: torch.Tensor, s_c: int, window: int) -> torch.Tensor:
    """Absolute positions stored in each ring slot given next-pos ``pos``.

    Slot j holds the most recent absolute position p with p % window == j
    and p <= pos (after the current write at slot pos%window).
    """
    slots = torch.arange(s_c, device=pos.device)[None, :]
    cur = pos[:, None]
    delta = torch.remainder(cur - slots, window)
    return cur - delta


def init_kv_cache(batch: int, dims: AttnDims, max_len: int, dtype,
                  device="cpu") -> dict:
    s_c = min(max_len, dims.sliding_window) if dims.sliding_window else max_len
    kv, hd = dims.num_kv_heads, dims.head_dim
    return {
        "k": torch.zeros((batch, s_c, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, s_c, kv, hd), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------

def cross_attention_fwd(p: dict, x: torch.Tensor, enc_k: torch.Tensor,
                        enc_v: torch.Tensor, dims: AttnDims,
                        positions: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention: q from x, fixed (precomputed) encoder k/v;
    no RoPE and no mask.  ``positions`` is unused, as in the reference.

    Query-chunked like self-attention, each chunk recomputed in backward
    when there are several."""
    del positions
    b, s, _ = x.shape
    dt = x.dtype
    h, hd = dims.num_heads, dims.head_dim
    q = (x @ p["wq"].to(dt)).reshape(b, s, h, hd)
    if dims.qk_norm:
        q = head_rms_norm(q, p["q_norm"].to(dt), dims.norm_eps)

    qc = min(dims.q_chunk, s)
    while s % qc:
        qc -= 1

    def chunk_attn(q_blk, enc_k, enc_v):
        probs = torch.softmax(_gqa_scores(q_blk, enc_k, dims).float(), dim=-1)
        return _gqa_out(probs.to(dt), enc_v)

    if qc == s:
        out = chunk_attn(q, enc_k, enc_v)
    else:
        out = torch.cat([checkpoint(chunk_attn, q[:, lo:lo + qc], enc_k,
                                    enc_v, use_reentrant=False)
                         for lo in range(0, s, qc)], dim=1)
    return out @ p["wo"].to(dt)


def project_enc_kv(p: dict, enc_out: torch.Tensor, dims: AttnDims):
    """The encoder output's keys and values, (B, F, KV, D) each."""
    b, s, _ = enc_out.shape
    dt = enc_out.dtype
    kv, hd = dims.num_kv_heads, dims.head_dim
    k = (enc_out @ p["wk"].to(dt)).reshape(b, s, kv, hd)
    v = (enc_out @ p["wv"].to(dt)).reshape(b, s, kv, hd)
    if dims.qk_norm:
        k = head_rms_norm(k, p["k_norm"].to(dt), dims.norm_eps)
    return k, v


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU or plain GELU)
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, gated: bool,
             device="cpu") -> dict:
    p = {
        "w_up": dense_init(generator, (d_model, d_ff), device=device),
        "w_down": dense_init(generator, (d_ff, d_model), device=device),
    }
    if gated:
        p["w_gate"] = dense_init(generator, (d_model, d_ff), device=device)
    return p


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_fwd(p: dict, x: torch.Tensor, gated: bool) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["w_up"].to(dt)
    if gated:
        h = F.silu(x @ p["w_gate"].to(dt)) * h
    else:
        h = gelu(h)
    return h @ p["w_down"].to(dt)
