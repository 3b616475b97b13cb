"""Federated learning with pluggable (robust) server aggregation.

Counterpart of ``repro.core.federated``: FedAvg (Example 1 of the
paper) whose server-side average (Eq. 4) is any aggregator.  Each round
the server samples N of K clients (a random permutation), every sampled
client runs L local SGD steps from the server model, malicious clients
corrupt their returned model, and the server aggregates the N models.
The cohort is a batch axis written out (the reference vmaps over it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import aggregators, attacks

# (W (N, M), client_idx (N,), generator) -> stochastic gradients (N, M)
ClientGradFn = Callable[[torch.Tensor, torch.Tensor, torch.Generator],
                        torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    num_clients: int = 32
    clients_per_round: int = 16
    local_steps: int = 5
    step_size: float = 0.01
    aggregator: str = "mm_tukey"
    agg_kwargs: tuple = ()
    byzantine: attacks.ByzantineConfig = attacks.ByzantineConfig()
    # optional per-client combination weights (K,), e.g. proportional to
    # local dataset sizes (Eq. 4's p_k); None -> uniform server averaging
    client_weights: Optional[tuple] = None


def local_update(w0: torch.Tensor, client_idx: torch.Tensor,
                 generator: torch.Generator, *, grad_fn: ClientGradFn,
                 steps: int, mu: float) -> torch.Tensor:
    """L steps of local SGD (Eq. 3) for every cohort member: (N, M)."""
    w = w0
    for _ in range(steps):
        w = w - mu * grad_fn(w, client_idx, generator)
    return w


def client_weight_tensor(config: FederatedConfig, dtype=torch.float32,
                         device="cpu") -> Optional[torch.Tensor]:
    """``config.client_weights`` as a (K,) tensor (None without them)."""
    if config.client_weights is None:
        return None
    return torch.as_tensor(config.client_weights, dtype=dtype, device=device)


def federated_round(w: torch.Tensor, generator: torch.Generator, *,
                    grad_fn: ClientGradFn, config: FederatedConfig,
                    step: int = 0,
                    client_weights: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """One round from server model ``w``.  ``client_weights`` is
    ``config.client_weights`` already on w's device
    (``client_weight_tensor``), which a loop builds once; without it a
    round copies them from the host."""
    perm = torch.randperm(config.num_clients, generator=generator,
                          device=w.device)
    chosen = perm[:config.clients_per_round]                        # (N,)
    start = w.unsqueeze(0).expand(config.clients_per_round, *w.shape)
    phis = local_update(start, chosen, generator, grad_fn=grad_fn,
                        steps=config.local_steps, mu=config.step_size)
    # a client is malicious iff its *global* index is in the set
    mask = config.byzantine.malicious_mask(
        config.num_clients, step, w.device)[chosen]
    if config.byzantine.num_malicious > 0:
        fn = attacks.get_attack(config.byzantine.attack,
                                **dict(config.byzantine.attack_kwargs))
        phis = fn(phis, mask, generator, step)
    agg = aggregators.get_aggregator(config.aggregator,
                                     **dict(config.agg_kwargs))
    if client_weights is None:
        client_weights = client_weight_tensor(config, phis.dtype, w.device)
    a = None if client_weights is None else client_weights[chosen]
    return agg(phis, a)


def run_federated(
    *,
    grad_fn: ClientGradFn,
    config: FederatedConfig,
    w_star: torch.Tensor,
    num_rounds: int,
    generator: torch.Generator,
    w0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final server model, MSD history (num_rounds,)).

    Thin wrapper over the scenario runner's federated loop, with the
    reference's signature and return shape (a ``generator`` in place of
    its ``key``)."""
    from repro_torch.scenarios import runner  # deferred: runner imports this
    w_final, history = runner.federated_loop(
        grad_fn=grad_fn, config=config, w_star=w_star,
        num_rounds=num_rounds, generator=generator, w0=w0)
    return w_final, history["msd"]
