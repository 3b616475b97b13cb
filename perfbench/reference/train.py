"""The Mode A robust training step, in plain PyTorch:

  1. every agent k takes the gradient of the mean next-token loss of its
     own rows, into row k of a (K, *leaf) stack per leaf;
  2. the Byzantine agents (the last ``num_malicious``) add ``delta`` to
     every coordinate of their rows (the paper's additive attack);
  3. every leaf is aggregated by the unweighted MM estimate along K;
  4. the aggregate is clipped to global norm ``grad_clip``;
  5. Adam (bias-corrected, no weight decay) with a linear warm-up over
     ``warmup_steps`` and a cosine decay to 10% at ``total_steps``.

``follow`` runs the first steps from the benchmark's weights and
returns what the comparison reads: each step's loss (the mean over the
agents), the first step's clipped aggregate, leaf by leaf, and the
parameters after the last step.  ``q`` rounds the model's matmul
operands (the control) and ``half_rows`` makes each agent's loss the
mean over the first half of its tokens only (a planted fault).
"""

from __future__ import annotations

import math

import torch

from reference import lowp, mm

MM_BLOCK = 1 << 24   # columns a leaf's estimate takes at a time


def schedule(opt: dict, step: int) -> float:
    warm = min(1.0, (step + 1.0) / max(opt["warmup_steps"], 1))
    frac = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["learning_rate"] * warm * (0.1 + 0.45 * (1.0 + math.cos(
        math.pi * frac)))


def agent_grads(params: dict, tokens: torch.Tensor, loss_fn, k: int, q,
                half_rows: bool):
    """(per-leaf (K, *leaf) f32 stacks, (K,) losses)."""
    names = list(params)
    stacks = {n: torch.empty((k,) + tuple(params[n].shape),
                             dtype=torch.float32, device=params[n].device)
              for n in names}
    per = tokens.shape[0] // k
    losses = []
    for a in range(k):
        rows = tokens[a * per:(a + 1) * per]
        if half_rows:
            rows = rows[:, :rows.shape[1] // 2 + 1]
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        loss = loss_fn(leaves, rows, q)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        for n, g in zip(names, grads):
            stacks[n][a] = g
        losses.append(float(loss.detach()))
        del loss, grads, leaves
    return stacks, losses


def step(params: dict, m: dict, v: dict, t: int, tokens: torch.Tensor,
         loss_fn, opt: dict, attack: dict, k: int, q=lowp.identity,
         half_rows: bool = False):
    """One step in place on params, m and v; returns (mean loss, the
    clipped aggregate by leaf)."""
    stacks, losses = agent_grads(params, tokens, loss_fn, k, q, half_rows)
    for n in stacks:
        stacks[n][k - attack["num_malicious"]:] += attack["delta"]
    agg = {}
    for n in list(stacks):
        x = stacks.pop(n).reshape(k, -1)
        agg[n] = mm.estimate_blocks(lambda lo, hi, x=x: x[:, lo:hi],
                                    x.shape[1], block=MM_BLOCK
                                    ).reshape(params[n].shape)
        del x
    norm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                         for g in agg.values()))
    factor = min(1.0, opt["grad_clip"] / max(norm, 1e-9))
    lr = schedule(opt, t)
    b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
    c1, c2 = 1.0 - b1 ** (t + 1), 1.0 - b2 ** (t + 1)
    with torch.no_grad():
        for n, g in agg.items():
            g.mul_(factor)
            m[n].mul_(b1).add_((1 - b1) * g)
            v[n].mul_(b2).add_((1 - b2) * g * g)
            params[n].sub_(lr * (m[n] / c1) / (torch.sqrt(v[n] / c2) + eps))
    return sum(losses) / len(losses), agg


def follow(params: dict, batches, loss_fn, opt: dict, attack: dict, k: int,
           steps: int, q=lowp.identity, half_rows: bool = False) -> dict:
    """The first ``steps`` steps from ``params`` (updated in place)."""
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], None
    for t in range(steps):
        loss, agg = step(params, m, v, t, batches[t], loss_fn, opt, attack,
                         k, q, half_rows)
        losses.append(loss)
        if first is None:
            first = {n: float(torch.linalg.vector_norm(g.double()))
                     for n, g in agg.items()}
        del agg
    return {"losses": losses, "first_grad_norms": first}
