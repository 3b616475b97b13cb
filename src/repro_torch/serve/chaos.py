"""Deterministic fault injection for the streaming service.

Counterpart of ``repro.serve.chaos``.  Every draw stays on a numpy
``Generator`` seeded as in the reference, so the same seed gives the
same roles, delays, drops, reorders and corruptions in both packages;
only the payloads are tensors (``corrupt_payload`` writes its NaN/Inf
into a copy of the tensor at the indices the numpy calls drew).

One ``ChaosConfig`` describes everything that can go wrong between the
agents and the committed model; the replay harness
(``serve.scenario``) draws every fault from a single seeded generator
under the simulated clock, so a chaos run is bit-for-bit reproducible.

Fault matrix (see docs/serving.md for the defense each one lands on):

  straggler     an affected agent's deliveries get an extra exponential
                delay (mean ``straggler_delay_s``) -> arrives late with
                a nonzero round age; admitted stale-downweighted or
                rejected beyond the window
  dropout       an affected agent stops sending for good at
                ``dropout_after_frac`` of the run horizon -> the
                service keeps committing from the survivors (deadline
                admissions / degradation ladder)
  duplicate     a delivery is replayed with the same sequence number ->
                dropped by the buffer's duplicate gate
  stale         an agent re-sends its *previous* update (fresh sequence
                number, old round tag) -> staleness-weighted or
                rejected
  byzantine     an affected agent corrupts every payload through the
                attack registry (per-agent attacks only: the collusion
                attacks need sight of the benign cohort, which a
                streaming client does not have) -> rejected by the MM
                estimator's redescending loss, then health-scored out
                of admission entirely (circuit breaker)
  launch fault  the engine launch itself raises ``FaultInjected`` with
                probability ``launch_fault_rate`` per attempt ->
                absorbed by the retry/backoff policy

Network-level faults (the transport front's half of the matrix):

  partition     ``partition_frac`` of the agents are unreachable while
                the server round is inside
                ``[partition_start_frac, partition_end_frac] x horizon``;
                their deliveries are held by the "network" and released
                in a burst when the partition heals -> the service rides
                the window on deadline admissions, and the healed burst
                lands as stale-downweighted / seq-gated deliveries
  reorder       with ``reorder_prob`` a delivery is held an extra
                ``reorder_hold_s``, so a *newer* delivery from the same
                agent overtakes it -> the overtaken one arrives as a
                ``duplicate`` (seq gate) or stale -- never re-admitted
  corrupt       with ``corrupt_prob`` the payload is bit-mangled in
                flight (NaN/Inf poison) -> the buffer's existing
                non-finite rejection path (``rejected_invalid``)
  slow loris    an affected agent's deliveries trickle: they occupy
                their bounded per-agent inbound channel for
                ``loris_delay_s`` before completing -> head-of-line
                blocking is confined to the agent's own lane, whose
                backpressure verdicts throttle it at the door
  crash         the service process dies at each fraction in
                ``crash_restart_frac`` of the round horizon and is
                restored from its journal -> exactly-once admission
                across the restart (seq gates are durable), counted as
                a ``crash`` recovery
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import attacks as _attacks
from repro_torch.serve.retry import FaultInjected

PER_AGENT_ATTACKS = ("additive", "sign_flip", "gaussian", "zero", "scale")


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Fault intensities; all zero = clean run."""

    straggler_frac: float = 0.0
    straggler_delay_s: float = 2.0   # mean of the exponential extra delay
    dropout_frac: float = 0.0
    dropout_after_frac: float = 0.5  # crash time as fraction of horizon
    duplicate_prob: float = 0.0      # per delivery
    stale_resend_prob: float = 0.0   # per delivery: re-send previous update
    byzantine_frac: float = 0.0
    attack: str = "additive"
    attack_kwargs: Tuple[Tuple[str, float], ...] = ()
    launch_fault_rate: float = 0.0   # per launch attempt
    # -- network-level faults (see module docstring) ----------------------
    partition_frac: float = 0.0      # agents behind the partition
    partition_start_frac: float = 0.3   # window, as fractions of the
    partition_end_frac: float = 0.6     # round horizon
    reorder_prob: float = 0.0        # per delivery
    reorder_hold_s: float = 1.5      # extra hold for a reordered delivery
    corrupt_prob: float = 0.0        # per delivery: payload -> NaN/Inf
    slow_loris_frac: float = 0.0     # trickling agents
    loris_delay_s: float = 8.0       # trickle completion time
    crash_restart_frac: Tuple[float, ...] = ()  # crash points (of horizon)

    def __post_init__(self):
        for name in ("straggler_frac", "dropout_frac", "dropout_after_frac",
                     "duplicate_prob", "stale_resend_prob", "byzantine_frac",
                     "launch_fault_rate", "partition_frac",
                     "partition_start_frac", "partition_end_frac",
                     "reorder_prob", "corrupt_prob", "slow_loris_frac"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.straggler_delay_s < 0 or self.reorder_hold_s < 0 \
                or self.loris_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if self.partition_frac > 0 \
                and self.partition_start_frac >= self.partition_end_frac:
            raise ValueError(
                f"partition window must be non-empty, got "
                f"[{self.partition_start_frac}, {self.partition_end_frac}]")
        for f in self.crash_restart_frac:
            if not 0.0 < f < 1.0:
                raise ValueError(
                    f"crash_restart_frac entries must be in (0, 1), got {f}")
        if tuple(sorted(self.crash_restart_frac)) \
                != tuple(self.crash_restart_frac):
            raise ValueError("crash_restart_frac must be sorted ascending")
        if self.byzantine_frac > 0 and self.attack not in PER_AGENT_ATTACKS:
            raise ValueError(
                f"attack {self.attack!r} is not applicable per-agent "
                f"(collusion attacks need the benign cohort); "
                f"known: {PER_AGENT_ATTACKS}")

    def fault_modes(self) -> Tuple[str, ...]:
        """Names of the fault modes this config actually injects."""
        modes = []
        if self.straggler_frac > 0:
            modes.append("straggler")
        if self.dropout_frac > 0:
            modes.append("dropout")
        if self.duplicate_prob > 0:
            modes.append("duplicate")
        if self.stale_resend_prob > 0:
            modes.append("stale")
        if self.byzantine_frac > 0:
            modes.append("byzantine")
        if self.launch_fault_rate > 0:
            modes.append("launch_fault")
        if self.partition_frac > 0:
            modes.append("partition")
        if self.reorder_prob > 0:
            modes.append("reorder")
        if self.corrupt_prob > 0:
            modes.append("corrupt")
        if self.slow_loris_frac > 0:
            modes.append("slow_loris")
        if self.crash_restart_frac:
            modes.append("crash")
        return tuple(modes)

    def attack_fn(self):
        if self.byzantine_frac <= 0:
            return None
        return _attacks.get_attack(self.attack, **dict(self.attack_kwargs))


@dataclasses.dataclass(frozen=True)
class AgentRoles:
    """Deterministic role assignment for one replay (tuples of ids)."""

    byzantine: Tuple[int, ...] = ()
    stragglers: Tuple[int, ...] = ()
    dropouts: Tuple[int, ...] = ()
    partitioned: Tuple[int, ...] = ()
    loris: Tuple[int, ...] = ()


def assign_roles(config: ChaosConfig, num_agents: int,
                 rng: np.random.Generator) -> AgentRoles:
    """Sample the affected agent sets.  Roles are drawn independently
    (an agent can be both byzantine and a straggler -- real fleets do
    not partition their failure modes either)."""

    def pick(frac: float) -> Tuple[int, ...]:
        n = int(round(frac * num_agents))
        if n == 0:
            return ()
        return tuple(sorted(rng.choice(num_agents, size=n, replace=False)
                            .tolist()))

    return AgentRoles(byzantine=pick(config.byzantine_frac),
                      stragglers=pick(config.straggler_frac),
                      dropouts=pick(config.dropout_frac),
                      partitioned=pick(config.partition_frac),
                      loris=pick(config.slow_loris_frac))


def corrupt_payload(payload: torch.Tensor,
                    rng: np.random.Generator) -> torch.Tensor:
    """Bit-mangle a payload in flight: poison some entries with NaN /
    +-Inf (at least one).  Lands on the buffer's existing non-finite
    rejection path -- corruption must never be something the estimator
    has to average around."""
    out = payload.detach().to(torch.float32).reshape(-1).clone()
    n = out.shape[0]
    n_bad = max(1, int(rng.integers(1, max(n // 4, 2))))
    idx = rng.choice(n, size=min(n_bad, n), replace=False)
    poison = rng.choice(np.asarray(
        [np.nan, np.inf, -np.inf], dtype=np.float32), size=idx.shape[0])
    out[torch.from_numpy(idx).to(out.device)] = \
        torch.from_numpy(poison).to(out.device)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class DeliveryPlan:
    """What the "wire" decided for one scheduled delivery."""

    delay_s: float                # total transport delay (send -> front)
    hold_s: float = 0.0           # channel trickle (slow loris): the
                                  # entry occupies its inbound channel
                                  # this long before it is pump-able
    payload: Optional[torch.Tensor] = None  # corrupted payload, if any
    held_by_partition: bool = False
    reordered: bool = False
    corrupted: bool = False
    duplicated: bool = False


class NetworkModel:
    """The deterministic network between the agents and the transport
    front.  All draws come from the harness generator (one seeded
    stream), all times from the harness clock -- a chaos run is
    bit-for-bit reproducible.

    ``plan_delivery`` decides, per scheduled delivery, what the wire
    does to it; the partition window is expressed in *server rounds*
    (fractions of the round horizon), so partitions interact with
    service progress, not wall time.
    """

    def __init__(self, config: ChaosConfig, roles: AgentRoles,
                 rng: np.random.Generator, *, horizon_rounds: int,
                 base_delay_s: float):
        self.config = config
        self.roles = roles
        self._rng = rng
        self._base_delay_s = float(base_delay_s)
        self.partition_start_round = int(
            round(config.partition_start_frac * horizon_rounds))
        self.partition_end_round = int(
            round(config.partition_end_frac * horizon_rounds))

    def partition_active(self, progress_round: int) -> bool:
        if self.config.partition_frac <= 0:
            return False
        return (self.partition_start_round
                <= progress_round < self.partition_end_round)

    def plan_delivery(self, agent: int, payload: torch.Tensor,
                      *, progress_round: int) -> DeliveryPlan:
        cfg, rng = self.config, self._rng
        delay = self._base_delay_s * (0.5 + float(rng.random()))
        if agent in self.roles.stragglers:
            delay += float(rng.exponential(cfg.straggler_delay_s))
        reordered = False
        if cfg.reorder_prob > 0 and float(rng.random()) < cfg.reorder_prob:
            # hold THIS delivery long enough that the agent's next one
            # overtakes it on the wire
            delay += cfg.reorder_hold_s * (1.0 + float(rng.random()))
            reordered = True
        corrupted = False
        new_payload = None
        if cfg.corrupt_prob > 0 and float(rng.random()) < cfg.corrupt_prob:
            new_payload = corrupt_payload(payload, rng)
            corrupted = True
        hold = 0.0
        if agent in self.roles.loris:
            hold = cfg.loris_delay_s * (0.5 + float(rng.random()))
        duplicated = (cfg.duplicate_prob > 0
                      and float(rng.random()) < cfg.duplicate_prob)
        held = (agent in self.roles.partitioned
                and self.partition_active(progress_round))
        return DeliveryPlan(delay_s=delay, hold_s=hold, payload=new_payload,
                            held_by_partition=held, reordered=reordered,
                            corrupted=corrupted, duplicated=duplicated)

    def heal_jitter(self) -> float:
        """Per-delivery release jitter when the partition heals (the
        burst is spread over a short interval, deterministically)."""
        return float(self._rng.random()) * self._base_delay_s * 2.0


def make_launch_fault_hook(config: ChaosConfig, seed: int = 0
                           ) -> Optional[Callable]:
    """A ``fault_hook`` for ``AggregationService``: raises
    ``FaultInjected`` with probability ``launch_fault_rate`` per launch
    attempt, from its own seeded stream (independent of the service's
    backoff jitter)."""
    if config.launch_fault_rate <= 0:
        return None
    rng = np.random.default_rng(seed)

    def hook():
        if rng.random() < config.launch_fault_rate:
            raise FaultInjected(
                f"injected launch fault (rate={config.launch_fault_rate})")

    return hook


CHAOS_PROFILES = {
    "clean": ChaosConfig(),
    "stragglers": ChaosConfig(straggler_frac=0.3, straggler_delay_s=2.0),
    # pure network chaos: the transport front's half of the matrix
    "network": ChaosConfig(
        partition_frac=0.25, partition_start_frac=0.3,
        partition_end_frac=0.6,
        reorder_prob=0.15, reorder_hold_s=1.5,
        corrupt_prob=0.1, slow_loris_frac=0.15, loris_delay_s=8.0),
    # everything at once, including a mid-run crash/restart
    "mixed": ChaosConfig(
        straggler_frac=0.25, straggler_delay_s=2.0,
        dropout_frac=0.15, dropout_after_frac=0.5,
        duplicate_prob=0.1, stale_resend_prob=0.1,
        byzantine_frac=0.3, attack="additive",
        launch_fault_rate=0.1,
        partition_frac=0.2, partition_start_frac=0.25,
        partition_end_frac=0.45,
        reorder_prob=0.1, reorder_hold_s=1.5,
        corrupt_prob=0.08, slow_loris_frac=0.1, loris_delay_s=6.0,
        crash_restart_frac=(0.6,)),
}
