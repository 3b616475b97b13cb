"""Declarative scenario specification (``repro.scenarios.spec``).

``ScenarioSpec`` has the reference's fields and values, so one spec
means the same run in both packages; only the random streams differ.
``backend="pallas"`` means the Hopper kernel and ``backend="jnp"`` the
plain PyTorch estimator.

``ScenarioResult`` is the uniform output: per-step metric histories,
an attack-success summary, timing and, for kernel-backend runs, the
``mm_aggregate.launch_plan`` audit of the launches the run made.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core import aggregators, attacks, graph
from repro_torch.scenarios import registry

PARADIGMS = ("federated", "diffusion", "sharded", "substrate")
BACKENDS = ("pallas", "jnp")
DATA_SPLITS = ("iid", "dirichlet")
MM_AGGREGATORS = ("mm_tukey", "ref", "mm_pallas")
LSQ_SUBSTRATE = "paper_lsq"
SUBSTRATE_AGGREGATORS = ("mean",) + MM_AGGREGATORS


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One declarative scenario.

    ``num_steps`` is rounds (federated) or iterations (diffusion).
    ``seed`` seeds the run's ``torch.Generator``; ``data_seed`` fixes the
    problem instance (w_star, Dirichlet mixture, random graphs).
    """

    name: str = ""
    paradigm: str = "diffusion"

    # problem
    num_agents: int = 16
    dim: int = 10
    noise_var: float = 0.01
    data: str = "iid"                  # iid | dirichlet
    dirichlet_alpha: float = 1.0
    data_seed: int = 0

    # topology (diffusion; federated is implicitly a star)
    topology: str = "fully_connected"
    topology_kwargs: tuple = ()
    weights: str = "uniform"           # uniform | metropolis

    # aggregation
    aggregator: str = "mm_tukey"
    agg_kwargs: tuple = ()
    backend: str = "jnp"               # pallas | jnp

    # adversary
    attack: str = "additive"
    num_malicious: int = 0
    attack_kwargs: tuple = ()
    attack_schedule: str = "static"    # static | intermittent | rotating
    schedule_kwargs: tuple = ()

    # dynamics
    participation: float = 1.0         # federated: fraction sampled per round
    local_steps: int = 5               # federated local SGD steps
    step_size: float = 0.05
    num_steps: int = 400
    seed: int = 0

    paradigm_kwargs: tuple = ()
    model_config: str = ""             # substrate paradigm only

    def __post_init__(self):
        known = set(PARADIGMS) | set(registry.paradigm_names())
        if self.paradigm not in known:
            raise ValueError(
                f"unknown paradigm {self.paradigm!r}; known: {sorted(known)}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; known: {BACKENDS}")
        if self.data not in DATA_SPLITS:
            raise ValueError(
                f"unknown data split {self.data!r}; known: {DATA_SPLITS}")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(
                f"participation must be in (0, 1], got {self.participation}")
        if self.participation < 1.0 and self.paradigm != "federated":
            raise ValueError("partial participation is a federated-only field")
        if self.attack_schedule not in attacks.SCHEDULES:
            raise ValueError(
                f"unknown schedule {self.attack_schedule!r}; "
                f"known: {attacks.SCHEDULES}")
        if self.backend == "pallas" and \
                self.resolved_aggregator()[0] != "mm_pallas":
            raise ValueError(
                "backend='pallas' applies to the MM aggregator family "
                f"({MM_AGGREGATORS}); got {self.aggregator!r}")
        attacks.get_attack(self.attack)
        aggregators.get_aggregator(self.aggregator)
        if self.topology not in graph.topology_names():
            raise ValueError(
                f"unknown topology {self.topology!r}; "
                f"known: {graph.topology_names()}")
        if not 0 <= self.num_malicious < self.num_agents:
            raise ValueError(
                f"num_malicious must be in [0, {self.num_agents}), "
                f"got {self.num_malicious}")
        if self.paradigm == "substrate":
            if not self.model_config:
                raise ValueError(
                    "substrate scenarios need model_config=... "
                    f"({LSQ_SUBSTRATE!r} or a configs arch name)")
            if self.model_config != LSQ_SUBSTRATE:
                from repro_torch.configs.base import resolve_arch
                resolve_arch(self.model_config)   # raises on unknown names
            if self.aggregator not in SUBSTRATE_AGGREGATORS:
                raise ValueError(
                    f"substrate aggregation supports {SUBSTRATE_AGGREGATORS}; "
                    f"got {self.aggregator!r}")
            if self.data != "iid" and self.model_config != LSQ_SUBSTRATE:
                raise ValueError(
                    "LM-substrate token batches are iid; "
                    f"data={self.data!r} is only modeled for "
                    f"model_config={LSQ_SUBSTRATE!r}")
        elif self.model_config:
            raise ValueError(
                "model_config is a substrate-only field "
                f"(paradigm is {self.paradigm!r})")

    def effective_topology(self) -> str:
        """The topology the run exercises: federated is a star, sharded
        and substrate all-to-all, whatever the field says."""
        if self.paradigm == "federated":
            return "star"
        if self.paradigm in ("sharded", "substrate"):
            return "fully_connected"
        return self.topology

    def label(self) -> str:
        if self.name:
            return self.name
        paradigm = self.paradigm
        if self.paradigm == "substrate":
            paradigm = f"substrate[{self.model_config}]"
        return (f"{paradigm}/{self.effective_topology()}/{self.aggregator}"
                f"-{self.backend}/{self.attack}x{self.num_malicious}"
                f"/{self.data}/K{self.num_agents}_M{self.dim}"
                f"_T{self.num_steps}_s{self.seed}")

    def byzantine(self) -> attacks.ByzantineConfig:
        return attacks.ByzantineConfig(
            num_malicious=self.num_malicious, attack=self.attack,
            attack_kwargs=self.attack_kwargs, schedule=self.attack_schedule,
            schedule_kwargs=self.schedule_kwargs)

    def resolved_aggregator(self) -> tuple:
        """(registry name, kwargs dict): the MM family becomes the kernel
        (``mm_pallas``) under backend 'pallas', ``mm_tukey`` otherwise."""
        name, kw = self.aggregator, dict(self.agg_kwargs)
        if name in MM_AGGREGATORS:
            name = "mm_pallas" if self.backend == "pallas" else "mm_tukey"
        return name, kw

    def adjacency(self) -> np.ndarray:
        return graph.get_topology(self.topology, self.num_agents,
                                  **dict(self.topology_kwargs))

    def combination(self) -> np.ndarray:
        return graph.combination_matrix(self.adjacency(), self.weights)

    def clients_per_round(self) -> int:
        return max(1, round(self.participation * self.num_agents))


@dataclasses.dataclass
class ScenarioResult:
    """Uniform result of ``runner.run``.

    ``compile_s`` is what a miss of the runner's executable cache costs,
    ``runner.trace_spec``: the adapter's lowering, one warm-up step on a
    copy of the initial state (the kernels' build at first use and their
    first launch) and, on a card, the capture of the whole trajectory
    into one CUDA graph (the eager ``substrate`` paradigm and ``rs_mm``
    collective lowering capture nothing); 0.0 on a hit
    (``compile_cache_hit``).  ``wall_clock_s`` is the replay of every
    step of the run (one graph replay on a card), ended by a device
    synchronize, on a hit or a miss."""

    spec: ScenarioSpec
    history: Dict[str, np.ndarray]     # msd / loss / consensus, (num_steps,)
    summary: Dict[str, Any]            # steady_msd / peak_msd / broke_down
    wall_clock_s: float
    launch_audit: Optional[dict]       # mm_aggregate.launch_plan (pallas)
    final_state: Any                   # (M,) server model or (K, M) stack
    compile_s: float = 0.0
    compile_cache_hit: bool = False    # reused the in-process lowering
    device: str = "cpu"

    @property
    def final_msd(self) -> float:
        return float(self.history["msd"][-1])

    def finite(self) -> bool:
        return all(bool(np.isfinite(h).all()) for h in self.history.values())

    def to_row(self) -> dict:
        """Strict-JSON-able row, the reference's keys plus the device
        (non-finite metrics become null, not the non-standard Infinity
        token)."""
        def num(x):
            return float(x) if np.isfinite(x) else None

        s = self.spec
        return {
            "name": s.label(),
            "paradigm": s.paradigm,
            "topology": s.effective_topology(),
            "aggregator": s.aggregator,
            "backend": s.backend,
            "attack": s.attack,
            "num_malicious": s.num_malicious,
            "schedule": s.attack_schedule,
            "data": s.data,
            "num_agents": s.num_agents,
            "dim": s.dim,
            "num_steps": s.num_steps,
            "seed": s.seed,
            "wall_clock_s": round(self.wall_clock_s, 4),
            "compile_s": round(self.compile_s, 4),
            "compile_cache_hit": self.compile_cache_hit,
            "model_config": s.model_config or None,
            "final_msd": num(self.final_msd),
            "steady_msd": num(self.summary["steady_msd"]),
            "broke_down": self.summary["broke_down"],
            "finite": self.finite(),
            "launch_audit": self.launch_audit,
            "device": self.device,
        }
