"""Network topologies and combination matrices for decentralized learning.

A topology is a symmetric boolean adjacency matrix with self-loops
(every agent is in its own neighborhood).  A combination matrix A is
left-stochastic: columns sum to one, A[l, k] = a_{lk} is the weight
agent k gives to the update received from agent l (paper Eq. 6).

A copy of ``repro.core.graph``: numpy only, so the same seeds give the
same graphs in both packages.
"""

from __future__ import annotations

import numpy as np


def fully_connected(k: int) -> np.ndarray:
    return np.ones((k, k), dtype=bool)


def ring(k: int, hops: int = 1) -> np.ndarray:
    adj = np.eye(k, dtype=bool)
    for h in range(1, hops + 1):
        adj |= np.eye(k, k=h, dtype=bool) | np.eye(k, k=-h, dtype=bool)
        adj |= np.eye(k, k=k - h, dtype=bool) | np.eye(k, k=-(k - h), dtype=bool)
    return adj


def grid(rows: int, cols: int) -> np.ndarray:
    k = rows * cols
    adj = np.eye(k, dtype=bool)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if c + 1 < cols:
                adj[i, i + 1] = adj[i + 1, i] = True
            if r + 1 < rows:
                adj[i, i + cols] = adj[i + cols, i] = True
    return adj


def erdos_renyi(k: int, p: float, seed: int = 0) -> np.ndarray:
    """ER graph, re-sampled until connected (with self-loops added)."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        upper = rng.random((k, k)) < p
        adj = np.triu(upper, 1)
        adj = adj | adj.T | np.eye(k, dtype=bool)
        if is_connected(adj):
            return adj
    raise RuntimeError(f"could not sample a connected ER({k}, {p}) graph")


def star(k: int) -> np.ndarray:
    """Hub-and-spoke: agent 0 is connected to everyone (the federated
    fusion-center topology viewed as a graph)."""
    adj = np.eye(k, dtype=bool)
    adj[0, :] = adj[:, 0] = True
    return adj


def small_world(k: int, nbrs: int = 2, rewire_p: float = 0.1,
                seed: int = 0) -> np.ndarray:
    """Watts-Strogatz small world: a ring lattice (each agent linked to
    ``nbrs`` hops on each side) with every lattice edge rewired to a
    uniform random endpoint with probability ``rewire_p``; re-sampled
    until connected.  ``rewire_p=0`` is exactly ``ring(k, nbrs)``."""
    if not 0.0 <= rewire_p <= 1.0:
        raise ValueError(f"rewire_p must be in [0, 1], got {rewire_p}")
    lattice_hops = min(nbrs, (k - 1) // 2)
    if lattice_hops < 1:
        raise ValueError(
            f"small_world needs k >= 3 for a nonempty ring lattice, got k={k}")
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        adj = np.eye(k, dtype=bool)
        for h in range(1, lattice_hops + 1):
            for i in range(k):
                j = (i + h) % k
                if rng.random() < rewire_p:
                    cand = [c for c in range(k) if c != i and not adj[i, c]]
                    if cand:
                        j = int(rng.choice(cand))
                adj[i, j] = adj[j, i] = True
        if is_connected(adj):
            return adj
    raise RuntimeError(f"could not sample a connected small world graph")


def _grid_from_k(k: int, rows: int = 0) -> np.ndarray:
    """Near-square grid on k agents; ``rows`` pins the factorization."""
    if rows:
        if k % rows:
            raise ValueError(f"grid rows={rows} does not divide k={k}")
    else:
        rows = int(np.sqrt(k))
        while rows > 1 and k % rows:
            rows -= 1
    return grid(rows, k // rows)


# name -> builder(k, **kwargs); the scenario spec's topology field
# resolves through this registry, so a new topology is one entry here.
_TOPOLOGIES = {
    "fully_connected": fully_connected,
    "ring": ring,
    "grid": _grid_from_k,
    "erdos_renyi": lambda k, p=0.3, seed=0: erdos_renyi(k, p, seed),
    "small_world": small_world,
    "star": star,
}


def topology_names() -> list:
    return sorted(_TOPOLOGIES)


def get_topology(name: str, k: int, **kwargs) -> np.ndarray:
    """Build an adjacency matrix by registry name."""
    try:
        fn = _TOPOLOGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown topology {name!r}; known: {topology_names()}") from None
    return fn(k, **kwargs)


def is_connected(adj: np.ndarray) -> bool:
    k = adj.shape[0]
    seen = np.zeros(k, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        i = stack.pop()
        for j in np.nonzero(adj[i])[0]:
            if not seen[j]:
                seen[j] = True
                stack.append(int(j))
    return bool(seen.all())


def uniform_weights(adj: np.ndarray) -> np.ndarray:
    """a_{lk} = 1/|N_k| for l in N_k: columns sum to one."""
    adj = adj.astype(np.float64)
    return adj / adj.sum(axis=0, keepdims=True)


def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings rule: doubly-stochastic for symmetric adj."""
    k = adj.shape[0]
    deg = adj.sum(axis=0)  # includes self-loop
    a = np.zeros((k, k))
    for l in range(k):
        for kk in range(k):
            if l != kk and adj[l, kk]:
                a[l, kk] = 1.0 / max(deg[l], deg[kk])
    a[np.diag_indices(k)] = 1.0 - a.sum(axis=0)
    return a


_WEIGHT_RULES = {
    "uniform": uniform_weights,
    "metropolis": metropolis_weights,
}


def combination_matrix(adj: np.ndarray, rule: str = "uniform") -> np.ndarray:
    """Left-stochastic combination matrix from an adjacency by rule name."""
    try:
        fn = _WEIGHT_RULES[rule]
    except KeyError:
        raise ValueError(f"unknown weight rule {rule!r}; "
                         f"known: {sorted(_WEIGHT_RULES)}") from None
    a = fn(adj)
    validate_combination_matrix(a)
    return a


def validate_combination_matrix(a: np.ndarray, atol: float = 1e-10) -> None:
    if (a < -atol).any():
        raise ValueError("combination matrix has negative entries")
    col = a.sum(axis=0)
    if not np.allclose(col, 1.0, atol=1e-8):
        raise ValueError(f"columns must sum to 1, got {col}")
