"""One commit of the robust aggregation service, in plain PyTorch and
Python, written from the service's stated policy:

  weights     client weight 1 x (1 + staleness)^-alpha x the health
              factor floor + (1 - floor) x score
  estimate    the weighted MM estimate of the cohort's rows
  verdicts    r_i = |row_i - estimate|; with med and MADN = 1.4826 x
              median |r - med| over the cohort, agent i is an outlier
              where r_i > med + z max(MADN, max(1e-7, 1e-3 max(med, 1)))
  trust clip  with the EMA of step norms known, a step longer than
              trust_factor x EMA is scaled to that length
  EMA         the (clipped) step norm, then 0.9 EMA + 0.1 norm
  health      an outlier's score x (1 - alpha_h), its run of rejections
              + 1 (at ``quarantine_threshold``: quarantined for
              ``quarantine_rounds`` rounds from this one, the run reset);
              every other member's score (1 - alpha_h) score + alpha_h,
              its run reset

``commit`` takes the state before the commit (model, EMA, each member's
health) and returns the state after it; norms are summed in float64.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from reference import mm

POLICY = dict(staleness_alpha=0.5, health_floor=0.1, health_alpha=0.25,
              residual_z=4.0, trust_factor=2.0, quarantine_threshold=5,
              quarantine_rounds=8)


def weights(scores, stalenesses, policy=POLICY) -> np.ndarray:
    return np.asarray([
        (1.0 + s) ** -policy["staleness_alpha"]
        * (policy["health_floor"] + (1.0 - policy["health_floor"]) * h)
        for h, s in zip(scores, stalenesses)], dtype=np.float32)


def _norm(fn: Callable[[int, int], torch.Tensor], m: int, block: int) -> float:
    total = 0.0
    for lo in range(0, m, block):
        total += float(torch.sum(fn(lo, min(m, lo + block)).double() ** 2))
    return total ** 0.5


def commit(rows: Callable[[int, int], torch.Tensor], m: int, ids, scores,
           runs, round_: int, w_prev: torch.Tensor, ema: Optional[float], *,
           block: int, dtype=torch.float32, policy=POLICY) -> dict:
    """``rows(lo, hi)`` is the cohort's (K, hi - lo) slice; ``scores`` and
    ``runs`` each member's health score and run of rejections before the
    commit.  Returns the committed model, the outliers, whether the step
    was clipped, the EMA and each member's (score, run, quarantined
    until) after the commit."""
    a = torch.from_numpy(weights(scores, [0] * len(ids), policy))
    est = mm.estimate_blocks(rows, m, a, block=block, dtype=dtype)
    k = len(ids)
    r = np.asarray([_norm(lambda lo, hi, i=i: rows(lo, hi)[i].float()
                          - est[lo:hi], m, block) for i in range(k)])
    med = float(np.median(r))
    madn = 1.4826 * float(np.median(np.abs(r - med)))
    floor = max(1e-7, 1e-3 * max(med, 1.0))
    thresh = med + policy["residual_z"] * max(madn, floor)
    outliers = tuple(i for i, ri in zip(ids, r) if ri > thresh)
    norm = _norm(lambda lo, hi: est[lo:hi] - w_prev[lo:hi].float(), m, block)
    clipped = False
    if ema is not None:
        clip = policy["trust_factor"] * ema
        if norm > clip > 0.0:
            est.sub_(w_prev).mul_(clip / norm).add_(w_prev)
            norm, clipped = clip, True
    ema = norm if ema is None else 0.9 * ema + 0.1 * norm
    health = {}
    alpha = policy["health_alpha"]
    for i, s, run in zip(ids, scores, runs):
        until = -1
        if i in outliers:
            s, run = (1.0 - alpha) * s, run + 1
            if run >= policy["quarantine_threshold"]:
                until, run = round_ + policy["quarantine_rounds"], 0
        else:
            s, run = (1.0 - alpha) * s + alpha, 0
        health[i] = (s, run, until)
    return {"model": est, "outliers": outliers, "clipped": clipped,
            "ema": ema, "health": health, "residuals": r}
