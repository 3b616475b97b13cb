"""Shared per-step metrics and post-run summaries
(``repro.scenarios.metrics``).

  msd        -- mean-square deviation to w_star over benign agents
                (single-model paradigms: the one model's squared error)
  loss       -- expected excess streaming MSE = msd + sigma_v^2
  consensus  -- mean squared distance of benign agents to their centroid
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def msd_single(w: torch.Tensor, w_star: torch.Tensor) -> torch.Tensor:
    """Squared deviation of one shared model (federated)."""
    return torch.sum((w - w_star) ** 2)


def consensus_distance(w: torch.Tensor,
                       benign_mask: torch.Tensor) -> torch.Tensor:
    """Mean squared distance of benign agents to the benign centroid."""
    b = benign_mask.to(w.dtype)
    nb = torch.clamp(torch.sum(b), min=1.0)
    wbar = torch.sum(w * b[:, None], dim=0) / nb
    sq = torch.sum((w - wbar[None]) ** 2, dim=1)
    return torch.sum(sq * b) / nb


def steady(h: np.ndarray, frac: float = 0.2) -> float:
    """Mean of the trailing ``frac`` of a history (steady-state level)."""
    n = max(1, int(len(h) * frac))
    return float(np.mean(h[-n:]))


def breakdown_threshold(spec, safety: float = 25.0) -> float:
    """Spec-derived breakdown level: ``safety`` x the clean level the
    trailing window can reach on the linear problem (residual transient
    (1 - mu)^(2 t_tail) plus the steady scale mu * sigma_v^2 * M)."""
    mu = float(spec.step_size)
    per_round = spec.local_steps if spec.paradigm == "federated" else 1
    t_tail = max(int(spec.num_steps * (1.0 - 0.2)), 0) * per_round
    contraction = min(max(1.0 - mu, 0.0), 1.0) ** (2 * t_tail)
    steady_scale = mu * float(spec.noise_var) * spec.dim
    return safety * (contraction + steady_scale) + 1e-9


def attack_summary(msd_hist: np.ndarray,
                   breakdown_level: float = 1.0) -> Dict:
    """The attack succeeded if the run diverged or settled above
    ``breakdown_level``."""
    finite = bool(np.isfinite(msd_hist).all())
    s = steady(msd_hist) if finite else float("inf")
    return {
        "steady_msd": s,
        "peak_msd": float(np.max(msd_hist)) if finite else float("inf"),
        "breakdown_level": float(breakdown_level),
        "broke_down": (not finite) or s > breakdown_level,
    }


def assert_finite(history: Dict[str, np.ndarray], label: str = "") -> None:
    for name, h in history.items():
        if not np.isfinite(h).all():
            raise AssertionError(
                f"non-finite metric {name!r} in scenario {label or '<run>'}")
