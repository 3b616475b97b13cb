"""Synthetic data: the paper's linear-model experiment (Sec. 4) and LM
token streams.

Counterpart of ``repro.data.synthetic``.  Per-agent streaming regression
pairs d_k = u_k^T w_o + v_k with u_k ~ N(0, I_M), v_k ~ N(0, sigma_v^2)
and the LMS gradient approximation (Eq. 33).

The problem instance (``w_star``, the Dirichlet mixtures) is made with
the same numpy calls as the reference, so it is bit-identical.  The
per-step samples come from an explicit ``torch.Generator``; they differ
from the reference's ``jax.random`` stream.

Heterogeneity: regressors come from a mixture of ``num_components``
diagonal families (per-component std ``scales``) and each agent draws
components with its own weights pi_k ~ Dirichlet(alpha * 1).

Token streams: ``token_batches`` is pure numpy, the reference's own
code, so both packages yield the same stream from one
``TokenStreamConfig``; ``make_lm_batch`` draws uniform tokens from a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch import devices


@dataclasses.dataclass(frozen=True)
class LinearModelProblem:
    """Streaming least-mean-squares problem shared by K agents."""

    dim: int = 10
    noise_var: float = 0.01
    seed: int = 0

    @property
    def w_star_np(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        w = rng.normal(size=(self.dim,))
        return (w / np.linalg.norm(w)).astype(np.float32)

    def w_star(self, device="cuda") -> torch.Tensor:
        """The normalized target model, float32 on ``device``."""
        return torch.from_numpy(self.w_star_np).to(devices.resolve(device))


def dirichlet_mixture(k_agents: int, alpha: float, num_components: int = 4,
                      seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-agent mixture weights (K, F) and per-component input stds (F,)."""
    if alpha <= 0:
        raise ValueError(f"dirichlet alpha must be > 0, got {alpha}")
    rng = np.random.default_rng(seed)
    pi = rng.dirichlet(alpha * np.ones(num_components), size=k_agents)
    scales = np.logspace(-0.5, 0.5, num_components)
    return pi, scales


def _mixture(k_agents, data, alpha, num_components, seed, device):
    if data not in ("iid", "dirichlet"):
        raise ValueError(f"unknown data split {data!r}")
    if data == "iid":
        return None
    pi, scales = dirichlet_mixture(k_agents, alpha, num_components, seed)
    return (torch.as_tensor(pi, dtype=torch.float32, device=device),
            torch.as_tensor(scales, dtype=torch.float32, device=device))


def _regressors(mix, idx, rows, dim, gen, dtype, device):
    """(rows, dim) regressors; under a Dirichlet split each row's scale
    comes from its agent's mixture component."""
    u = torch.randn((rows, dim), generator=gen, dtype=dtype, device=device)
    if mix is None:
        return u
    pi, scales = mix
    comp = torch.multinomial(pi[idx], 1, generator=gen)[:, 0]
    return u * scales[comp].to(dtype)[:, None]


def make_stacked_grad_fn(problem: LinearModelProblem, k_agents: int, *,
                         data: str = "iid", alpha: float = 1.0,
                         num_components: int = 4, seed: int = 0,
                         device="cuda"):
    """Stacked grad fn (W (K, M), gen) -> (K, M) for diffusion."""
    loss_grad = make_stacked_loss_grad_fn(
        problem, k_agents, data=data, alpha=alpha,
        num_components=num_components, seed=seed, device=device)

    def grad(w_stack: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        return loss_grad(w_stack, gen)[1]

    return grad


def make_stacked_loss_grad_fn(problem: LinearModelProblem, k_agents: int, *,
                              data: str = "iid", alpha: float = 1.0,
                              num_components: int = 4, seed: int = 0,
                              device="cuda"):
    """Like ``make_stacked_grad_fn`` but also returns the per-agent
    streaming losses 0.5 * (d_k - u_k^T w_k)^2, whose gradient is the LMS
    gradient: (W (K, M), gen) -> ((K,), (K, M))."""
    device = devices.resolve(device)
    mix = _mixture(k_agents, data, alpha, num_components, seed, device)
    w_star = problem.w_star(device)
    sigma_v = float(np.sqrt(problem.noise_var))

    def loss_grad(w_stack: torch.Tensor, gen: torch.Generator):
        k = w_stack.shape[0]
        idx = torch.arange(k, device=w_stack.device)
        u = _regressors(mix, idx, k, problem.dim, gen, w_stack.dtype,
                        w_stack.device)
        v = sigma_v * torch.randn((k,), generator=gen, dtype=w_stack.dtype,
                                  device=w_stack.device)
        err = u @ w_star + v - torch.sum(u * w_stack, dim=1)
        return 0.5 * err ** 2, -u * err[:, None]

    return loss_grad


def make_client_grad_fn(problem: LinearModelProblem, k_agents: int, *,
                        data: str = "iid", alpha: float = 1.0,
                        num_components: int = 4, seed: int = 0,
                        device="cuda"):
    """Cohort grad fn (W (N, M), client_idx (N,), gen) -> (N, M) for
    federated rounds: one fresh sample per sampled client, drawn with
    the client's own mixture component under a Dirichlet split.  The
    reference's per-client function, with the cohort written out as a
    batch axis."""
    device = devices.resolve(device)
    mix = _mixture(k_agents, data, alpha, num_components, seed, device)
    w_star = problem.w_star(device)
    sigma_v = float(np.sqrt(problem.noise_var))

    def grad(w: torch.Tensor, idx: torch.Tensor,
             gen: torch.Generator) -> torch.Tensor:
        n = w.shape[0]
        u = _regressors(mix, idx, n, problem.dim, gen, w.dtype, w.device)
        v = sigma_v * torch.randn((n,), generator=gen, dtype=w.dtype,
                                  device=w.device)
        d = u @ w_star + v
        return -u * (d - torch.sum(u * w, dim=1))[:, None]

    return grad


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    batch_size: int          # per-host batch
    seed: int = 0
    structure: float = 0.7   # prob. next token is a deterministic fn of prev


def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return p / p.sum()


def token_batches(cfg: TokenStreamConfig) -> Iterator[dict]:
    """Infinite iterator of {'tokens': (B, T+1) int32} host arrays.

    tokens[:, :-1] are inputs, tokens[:, 1:] are labels.  A fraction
    ``structure`` of transitions follow t_{i+1} = (a*t_i + c) % V so the
    stream has learnable structure; the rest are Zipf draws.
    """
    rng = np.random.default_rng(cfg.seed)
    probs = _zipf_probs(cfg.vocab_size)
    a, c = 6364136223846793005 % cfg.vocab_size or 1, 1442695040888963407 % cfg.vocab_size
    while True:
        noise = rng.choice(cfg.vocab_size, size=(cfg.batch_size, cfg.seq_len + 1), p=probs)
        structured = rng.random((cfg.batch_size, cfg.seq_len + 1)) < cfg.structure
        toks = noise.copy()
        for t in range(1, cfg.seq_len + 1):
            det = (a * toks[:, t - 1] + c) % cfg.vocab_size
            toks[:, t] = np.where(structured[:, t], det, noise[:, t])
        yield {"tokens": toks.astype(np.int32)}


def make_lm_batch(generator: torch.Generator, batch: int, seq: int,
                  vocab: int, device="cuda") -> dict:
    """Quick batch (for tests and the substrate): uniform int32 tokens
    (batch, seq + 1) on ``device``, drawn from ``generator``."""
    toks = torch.randint(0, vocab, (batch, seq + 1), generator=generator,
                         device=devices.resolve(device), dtype=torch.int32)
    return {"tokens": toks}


def make_frames(generator: torch.Generator, batch: int, frames: int,
                d_model: int, dtype, device="cuda") -> torch.Tensor:
    """Stub audio frame embeddings (batch, frames, d_model) for the
    encoder-decoder: 0.02 x standard normal draws in ``dtype``, as the
    reference's batches make them."""
    return 0.02 * torch.randn((batch, frames, d_model), generator=generator,
                              dtype=dtype, device=devices.resolve(device))
