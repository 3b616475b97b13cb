"""Mixture-of-Experts FFN (``repro.models.moe``): top-k router and
GShard-style capacity dispatch.

Einsum/one-hot dispatch, no ragged ops, as the reference lowers it.
Tokens are routed in groups (``group_size``) with per-group expert
capacity ``int(group * k / E * capacity_factor) + 1`` -- overflow
tokens drop (Switch/GShard semantics).  The router aux loss is the
load-balance term E * sum_e f_e * p_e.

``torch.topk`` may break exact ties between router probabilities in
another order than ``jax.lax.top_k``; untied inputs route identically.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, gelu


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, gated: bool = True, device="cpu") -> dict:
    p = {
        "router": dense_init(generator, (d_model, num_experts), device=device),
        "w_up": dense_init(generator, (num_experts, d_model, d_ff),
                           device=device),
        "w_down": dense_init(generator, (num_experts, d_ff, d_model),
                             device=device),
    }
    if gated:
        p["w_gate"] = dense_init(generator, (num_experts, d_model, d_ff),
                                 device=device)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_fwd(p: dict, x: torch.Tensor, *, num_experts: int, top_k: int,
            gated: bool = True, group_size: int = 512,
            capacity_factor: float = 1.25):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    b, s, d = x.shape
    dt = x.dtype
    e, k = num_experts, top_k

    g_sz = min(group_size, s)
    while s % g_sz:
        g_sz -= 1
    n_groups = (b * s) // g_sz
    xg = x.reshape(n_groups, g_sz, d)

    logits = (xg @ p["router"].to(dt)).float()                   # (G, Sg, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)                  # (G, Sg, K)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)       # renormalize

    # load-balance aux loss (computed on the full softmax)
    density = torch.mean(_one_hot(top_i[..., 0], e, torch.float32), dim=(0, 1))
    mean_prob = torch.mean(probs, dim=(0, 1))
    aux = e * torch.sum(density * mean_prob)

    cap = int(g_sz * k / e * capacity_factor) + 1

    # position of each (token, choice) within its expert's capacity buffer
    onehot = _one_hot(top_i, e, torch.int32)                     # (G, Sg, K, E)
    flat = onehot.reshape(n_groups, g_sz * k, e)
    pos = torch.cumsum(flat, dim=1) - 1                          # (G, Sg*K, E)
    pos = pos.reshape(n_groups, g_sz, k, e)
    within_cap = (pos < cap) & (onehot > 0)

    pos_oh = _one_hot(pos, cap, dt) * within_cap[..., None].to(dt)
    # (G, Sg, K, E, C)
    dispatch = torch.sum(pos_oh, dim=2)                          # (G, Sg, E, C)
    combine = torch.sum(pos_oh * top_p[..., None, None].to(dt), dim=2)

    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)            # (G, E, C, D)
    h = torch.einsum("gecd,edf->gecf", xe, p["w_up"].to(dt))
    if gated:
        gate = torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(dt))
        h = F.silu(gate) * h
    else:
        h = gelu(h)
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dt))
    out = torch.einsum("gecd,gsec->gsd", ye, combine)
    return out.reshape(b, s, d), aux
