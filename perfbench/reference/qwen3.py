"""The Qwen3 decoder (dense, GQA, qk-norm, RoPE, SwiGLU) forward and
next-token loss, in plain PyTorch, written from the architecture:

  x = embed[tokens]
  per layer:  h = RMSNorm(x) ; q, k, v = h Wq, h Wk, h Wv (heads of
              ``head_dim``; ``num_key_value_heads`` shared by groups of
              query heads) ; RMSNorm over each q and k head (qk-norm) ;
              RoPE on q and k (rotation of the two halves of a head,
              frequencies theta^(-i / (head_dim / 2))) ; causal softmax
              attention with scores scaled by head_dim^-1/2 ; x += o Wo
              h = RMSNorm(x) ; x += (silu(h Wgate) * (h Wup)) Wdown
  logits = RMSNorm(x) Whead, classes at or above ``vocab_size`` masked
  loss = mean token cross-entropy of tokens[1:] given tokens[:-1]

Parameters come as a flat dict of the benchmark's weights under dotted
names (``blocks.attn.wq`` of shape (L, d, H hd), ...); every norm has a
weight and ``rms_norm_eps``.  ``q`` rounds each matmul operand (the
identity for the reference, ``lowp.fp8`` for its control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import lowp


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D): rotate (x1, x2) = the two halves by pos * freq."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(p: dict, i: int, h: torch.Tensor, cfg: dict, q) -> torch.Tensor:
    b, s, _ = h.shape
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps = cfg["head_dim"], cfg["rms_norm_eps"]
    qh = (q(h) @ q(p["blocks.attn.wq"][i])).reshape(b, s, nh, hd)
    kh = (q(h) @ q(p["blocks.attn.wk"][i])).reshape(b, s, nkv, hd)
    vh = (q(h) @ q(p["blocks.attn.wv"][i])).reshape(b, s, nkv, hd)
    qh = rope(rms_norm(qh, p["blocks.attn.q_norm"][i], eps), cfg["rope_theta"])
    kh = rope(rms_norm(kh, p["blocks.attn.k_norm"][i], eps), cfg["rope_theta"])
    rep = nh // nkv
    kh = kh.repeat_interleave(rep, dim=2)
    vh = vh.repeat_interleave(rep, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (qh, kh, vh))   # (B, H, S, D)
    scores = (q(qt) @ q(kt).transpose(-1, -2)) / hd ** 0.5
    causal = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = q(torch.softmax(scores, dim=-1)) @ q(vt)
    o = o.transpose(1, 2).reshape(b, s, nh * hd)
    return q(o) @ q(p["blocks.attn.wo"][i])


def _mlp(p: dict, i: int, h: torch.Tensor, q) -> torch.Tensor:
    gate = q(h) @ q(p["blocks.mlp.w_gate"][i])
    up = q(h) @ q(p["blocks.mlp.w_up"][i])
    return q(F.silu(gate) * up) @ q(p["blocks.mlp.w_down"][i])


def logits(p: dict, tokens: torch.Tensor, cfg: dict, q=lowp.identity):
    eps = cfg["rms_norm_eps"]
    x = p["embed"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        x = x + _attention(p, i, rms_norm(x, p["blocks.ln1"][i], eps), cfg, q)
        x = x + _mlp(p, i, rms_norm(x, p["blocks.ln2"][i], eps), q)
    out = q(rms_norm(x, p["ln_f"], eps)) @ q(p["head"])
    pad = torch.arange(out.shape[-1], device=out.device) >= cfg["vocab_size"]
    return out.masked_fill(pad, float("-inf"))


def loss(p: dict, tokens: torch.Tensor, cfg: dict, q=lowp.identity):
    """Mean cross-entropy of tokens[:, 1:] given tokens[:, :-1]."""
    lg = logits(p, tokens[:, :-1], cfg, q)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]).float(),
                           tokens[:, 1:].reshape(-1))
