"""Hand-rolled optimizers (``repro.optim.optimizers``).

Pytree-native SGD / momentum / Adam(W) with the usual (init, update)
pair.  States are pytrees with the same structure as the params.

Two differences from the reference, both for one card at full width:

  * the step counter lives on the host (a Python int in the state), so
    the schedule, the Adam bias corrections and a step-keyed attack
    schedule cost no device sync.  They are computed in float32 numpy,
    as the reference computes them in float32 on the device;
  * ``update`` writes the new parameters and moments into the tensors it
    is given (under ``torch.no_grad``) and returns them, so a step holds
    no second copy of the parameters or of the Adam moments.  The clip
    factor is applied leaf by leaf inside the update, so no clipped copy
    of the whole gradient tree is made either.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import pytree


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adam"
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip: float = 1.0      # global-norm clip; 0 disables
    warmup_steps: int = 100
    total_steps: int = 10_000   # cosine decay horizon
    state_dtype: str = "float32"  # adam m/v storage ("bfloat16" halves the
                                  # optimizer footprint; update math stays f32)
    schedule_kind: str = "cosine"  # cosine | constant (constant keeps the
                                   # warmup ramp, then holds learning_rate --
                                   # the paper's fixed-mu linear experiments)


class AdamState(NamedTuple):
    step: int
    m: dict
    v: dict


class MomentumState(NamedTuple):
    step: int
    m: dict


class SGDState(NamedTuple):
    step: int


_f32 = np.float32


def schedule(cfg: OptimizerConfig, step: int) -> float:
    """Linear warmup + cosine decay to 10% (or flat, per schedule_kind),
    in float32 as the reference computes it."""
    step = _f32(step)
    warm = min(_f32(1.0), (step + _f32(1.0)) / _f32(max(cfg.warmup_steps, 1)))
    lr = _f32(cfg.learning_rate)
    if cfg.schedule_kind == "constant":
        return float(lr * warm)
    if cfg.schedule_kind != "cosine":
        raise ValueError(f"unknown schedule_kind {cfg.schedule_kind!r}")
    frac = np.clip((step - _f32(cfg.warmup_steps))
                   / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   _f32(0.0), _f32(1.0))
    cos = _f32(0.1) + _f32(0.45) * (_f32(1.0) + np.cos(_f32(np.pi) * frac))
    return float(lr * warm * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in pytree.flatten(tree)[0]))


def _clip_factor(grads, max_norm: float):
    """min(1, max_norm / norm) as a device scalar (None: no clip)."""
    if max_norm <= 0:
        return None
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    factor = _clip_factor(grads, max_norm)
    if factor is None:
        return grads
    return pytree.tree_map(lambda g: (g.float() * factor).to(g.dtype), grads)


def init(cfg: OptimizerConfig, params):
    sdt = getattr(torch, cfg.state_dtype)

    def z():
        return pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=sdt, device=p.device), params)

    if cfg.name == "adam":
        return AdamState(0, z(), z())
    if cfg.name == "momentum":
        return MomentumState(0, z())
    if cfg.name == "sgd":
        return SGDState(0)
    raise ValueError(f"unknown optimizer {cfg.name!r}")


@torch.no_grad()
def update(cfg: OptimizerConfig, params, grads, state):
    """Returns (params, new_state); the parameter and moment tensors are
    updated in place."""
    factor = _clip_factor(grads, cfg.grad_clip)
    lr = schedule(cfg, state.step)
    p_leaves, treedef = pytree.flatten(params)
    g_leaves = pytree.flatten(grads)[0]

    def clipped(g):
        g = g.float()
        return g if factor is None else g * factor

    if cfg.name == "adam":
        t = state.step + 1
        b1, b2 = cfg.beta1, cfg.beta2
        mhat_s = float(_f32(1.0) / (_f32(1.0) - _f32(b1) ** _f32(t)))
        vhat_s = float(_f32(1.0) / (_f32(1.0) - _f32(b2) ** _f32(t)))
        for p, m, v, g in zip(p_leaves, pytree.flatten(state.m)[0],
                              pytree.flatten(state.v)[0], g_leaves):
            g = clipped(g)
            mf = b1 * m.float() + (1 - b1) * g
            vf = b2 * v.float() + (1 - b2) * torch.square(g)
            m.copy_(mf)
            v.copy_(vf)
            mf, vf = m.float(), v.float()
            step_ = lr * (mf * mhat_s) / (torch.sqrt(vf * vhat_s) + cfg.eps)
            if cfg.weight_decay:
                step_ = step_ + lr * cfg.weight_decay * p.float()
            p.copy_(p.float() - step_)
        return params, AdamState(t, state.m, state.v)

    if cfg.name == "momentum":
        for p, m, g in zip(p_leaves, pytree.flatten(state.m)[0], g_leaves):
            m.copy_(cfg.momentum * m.float() + clipped(g))
            p.copy_(p.float() - lr * m.float())
        return params, MomentumState(state.step + 1, state.m)

    if cfg.name == "sgd":
        for p, g in zip(p_leaves, g_leaves):
            p.copy_(p.float() - lr * clipped(g))
        return params, SGDState(state.step + 1)

    raise ValueError(cfg.name)
