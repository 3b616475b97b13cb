"""REF-Diffusion (Algorithm 1) and the classical ATC diffusion baseline.

Counterpart of ``repro.core.diffusion``.  State is the stacked agent
models ``W`` of shape (K, M).  One iteration:

  Step 1 (adapt):     phi_k = w_k - mu * grad_hat_k(w_k)          (Eq. 16)
  (attack):           malicious agents corrupt their outgoing phi  (Eq. 34)
  Step 2+3 (combine): w_k = Agg({phi_l}_{l in N_k}; a_{.k})        (Eq. 15)

Neighborhoods are a dense left-stochastic combination matrix A (K, K)
with a_{lk} = 0 outside N_k.  With ``mm_pallas`` all K columns go to the
Hopper kernel in ONE batched launch that reads the (K, M) update matrix
once; the other aggregators take the K columns as a batch axis (the
reference's ``vmap``).  Rank-based aggregators (trimmed_mean, krum)
ignore weights and need a fully-connected graph.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import aggregators, attacks

GradFn = Callable[[torch.Tensor, torch.Generator], torch.Tensor]

_WEIGHT_AWARE = {"mean", "median", "mm_tukey", "ref", "m_huber",
                 "geometric_median", "mm_pallas"}


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    step_size: float = 0.01
    aggregator: str = "mm_tukey"
    agg_kwargs: tuple = ()  # (key, value) pairs
    byzantine: attacks.ByzantineConfig = attacks.ByzantineConfig()

    def aggregator_fn(self):
        return aggregators.get_aggregator(self.aggregator, **dict(self.agg_kwargs))


def check_compatible(config: DiffusionConfig, combination: np.ndarray) -> None:
    if config.aggregator in _WEIGHT_AWARE:
        return
    if not (np.asarray(combination) > 0).all():
        raise ValueError(
            f"aggregator {config.aggregator!r} is rank-based and ignores "
            "combination weights; it requires a fully-connected graph")


def diffusion_step(
    w: torch.Tensor,               # (K, M) agent models
    generator: torch.Generator,
    *,
    grad_fn: GradFn,
    combination: torch.Tensor,     # (K, K) left-stochastic, columns sum to 1
    config: DiffusionConfig,
    step: int = 0,                 # step index (attack schedules)
) -> torch.Tensor:
    phi = w - config.step_size * grad_fn(w, generator)
    phi_sent = config.byzantine.apply(phi, generator, step)
    if config.aggregator == "mm_pallas":
        from repro_torch.kernels import ops  # deferred: keep core import-light
        return ops.mm_aggregate_batched(phi_sent, combination,
                                        **dict(config.agg_kwargs))
    k = phi_sent.shape[0]
    x_b = phi_sent.unsqueeze(1).expand((k,) + tuple(phi_sent.shape))
    return config.aggregator_fn()(x_b, combination)


def msd(w: torch.Tensor, w_star: torch.Tensor,
        benign_mask: torch.Tensor) -> torch.Tensor:
    """Mean-square deviation over benign agents (paper Fig. 1 metric)."""
    sq = torch.sum((w - w_star[None]) ** 2, dim=1)
    b = benign_mask.to(w.dtype)
    return torch.sum(sq * b) / torch.sum(b)


def run_diffusion(
    *,
    grad_fn: GradFn,
    combination,                   # (K, K) numpy array or tensor
    config: DiffusionConfig,
    w_star: torch.Tensor,
    num_iters: int,
    generator: torch.Generator,
    w0: Optional[torch.Tensor] = None,
    log_every: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the strategy; returns (final W, MSD history (num_iters//log_every,)).

    Thin wrapper over the scenario runner's diffusion loop, with the
    reference's signature and return shape (a ``generator`` in place of
    its ``key``); runs on ``w_star``'s device."""
    from repro_torch.scenarios import runner  # deferred: runner imports this
    comb = torch.as_tensor(combination, dtype=w_star.dtype,
                           device=w_star.device)
    w_final, history = runner.diffusion_loop(
        grad_fn=grad_fn, combination=comb, config=config, w_star=w_star,
        num_iters=num_iters, generator=generator, w0=w0)
    return w_final, history["msd"][::log_every]
