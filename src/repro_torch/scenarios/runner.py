"""Lower a ``ScenarioSpec`` to one loop and run it (``repro.scenarios.runner``).

Every paradigm contributes an adapter (``registry.register_paradigm``)
that maps a spec to its initial state and step function; ``run(spec)``
drives the step function ``spec.num_steps`` times from one
``torch.Generator`` seeded by ``spec.seed`` (the reference's
``lax.scan`` over split keys becomes a Python loop), collects the
uniform per-step metrics on the device and copies them to the host once
at the end, summarizes attack success, and attaches a launch audit built
from the kernel workloads the engine resolved
(``kernels.ops.record_workloads``).

Lowerings are cached in-process (``clear_executable_cache``,
``executable_cache_size``), keyed by (spec, device, tuning state): the
frozen spec fixes the adapter's lowering, and the tuning fingerprint
keeps a new autotune winner from reusing a lowering whose launches were
resolved for another geometry.  The port has no compiled scan, so a
miss's ``compile_s`` times the adapter's lowering and one warm-up step
on a copy of the initial state, drawn from a generator of its own (the
kernels' build at first use and their first launch); a hit's is 0.0.
``wall_clock_s`` times all ``num_steps`` from the initial state with the
spec's generator, on a hit or a miss, so the histories do not depend on
the cache.  Every run starts from a fresh copy of the lowering's initial
state: the optimizers update parameters in place.

The ``substrate`` adapter lives in ``scenarios.substrate``, imported at
first use.

The ``sharded`` paradigm defaults to the stacked single-program lowering
(one process: K per-agent gradients, one robust aggregate a step).
``paradigm_kwargs`` ``(("collective", "rs_mm"),)`` opts into the real
per-rank lowering: ``run`` is then called on each of K ranks of an
initialised process group (one agent a rank), each draws the full
replicated stack from the same seeded generator, keeps its own row and
aggregates with ``core.sharded.robust_all_reduce``.
"""

from __future__ import annotations

import collections
import copy
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import devices
from repro_torch.core import diffusion, federated, sharded
from repro_torch.data import synthetic
from repro_torch.kernels import mm_aggregate, ops, tuning
from repro_torch.scenarios import metrics, registry
from repro_torch.scenarios.spec import ScenarioResult, ScenarioSpec


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def loop(step_fn, state0, generator: torch.Generator, num_steps: int):
    """Run ``step_fn(state, generator, i) -> (state, metrics)`` for steps
    ``0 .. num_steps - 1``; returns (final state, {metric: [tensor]})."""
    state, hist = state0, {}
    for i in range(num_steps):
        state, m = step_fn(state, generator, i)
        for name, v in m.items():
            hist.setdefault(name, []).append(v)
    return state, hist


def _stack(hist) -> dict:
    return {name: torch.stack(v) for name, v in hist.items()}


# ---------------------------------------------------------------------------
# paradigm step functions
# ---------------------------------------------------------------------------

def _diffusion_step_fn(grad_fn, comb, config, w_star):
    def step(w, generator, i):
        w_next = diffusion.diffusion_step(
            w, generator, grad_fn=grad_fn, combination=comb, config=config,
            step=i)
        # benign set at THIS step (time-varying schedules move it)
        benign = ~config.byzantine.malicious_mask(w.shape[0], i, w.device)
        return w_next, {
            "msd": diffusion.msd(w_next, w_star, benign),
            "consensus": metrics.consensus_distance(w_next, benign),
        }
    return step


def _federated_step_fn(grad_fn, config, w_star):
    def step(w, generator, i):
        w_next = federated.federated_round(
            w, generator, grad_fn=grad_fn, config=config, step=i)
        return w_next, {
            "msd": metrics.msd_single(w_next, w_star),
            "consensus": torch.zeros((), dtype=w_next.dtype,
                                     device=w_next.device),
        }
    return step


def _sharded_step_fn(grad_fn, agg_fn, byz, k_agents, step_size, w_star):
    """Distributed SGD with a robust all-reduce, stacked lowering: one
    shared model, K per-agent gradients, one robust aggregate a step
    (the Mode A train step's semantics on the linear problem)."""
    def step(w, generator, i):
        grads = grad_fn(w.expand((k_agents,) + tuple(w.shape)), generator)
        grads = byz.apply(grads, generator, i)
        w_next = w - step_size * agg_fn(grads, None)
        return w_next, {
            "msd": metrics.msd_single(w_next, w_star),
            "consensus": torch.zeros((), dtype=w_next.dtype,
                                     device=w_next.device),
        }
    return step


def _sharded_collective_step_fn(grad_fn, byz, k_agents, step_size, w_star,
                                method, agg_name, agg_kwargs, mesh):
    """The per-rank lowering: this rank owns one agent's gradient and the
    aggregate is a ``core.sharded.robust_all_reduce`` over the mesh, the
    building block the robust-FSDP step applies per layer.  Every rank
    draws the same replicated stack (collusion attacks need all of it)
    and keeps its own row."""
    def step(w, generator, i):
        grads = grad_fn(w.expand((k_agents,) + tuple(w.shape)), generator)
        grads = byz.apply(grads, generator, i)
        est = sharded.robust_all_reduce(
            grads[mesh.agent_index], mesh, method=method,
            aggregator=agg_name, **agg_kwargs)
        w_next = w - step_size * est
        return w_next, {
            "msd": metrics.msd_single(w_next, w_star),
            "consensus": torch.zeros((), dtype=w_next.dtype,
                                     device=w_next.device),
        }
    return step


def diffusion_loop(*, grad_fn, combination, config, w_star, num_iters: int,
                   generator: torch.Generator, w0=None):
    """The REF-Diffusion loop; returns (final W, {metric: (T,) tensor})."""
    diffusion.check_compatible(config, combination.cpu().numpy())
    if w0 is None:
        w0 = torch.zeros((combination.shape[0], w_star.shape[0]),
                         dtype=w_star.dtype, device=w_star.device)
    step = _diffusion_step_fn(grad_fn, combination.to(w0), config, w_star)
    w, hist = loop(step, w0, generator, num_iters)
    return w, _stack(hist)


def federated_loop(*, grad_fn, config, w_star, num_rounds: int,
                   generator: torch.Generator, w0=None):
    """The FedAvg-with-robust-server loop; returns (final w, metrics)."""
    if w0 is None:
        w0 = torch.zeros_like(w_star)
    w, hist = loop(_federated_step_fn(grad_fn, config, w_star), w0,
                   generator, num_rounds)
    return w, _stack(hist)


# ---------------------------------------------------------------------------
# spec adapters
# ---------------------------------------------------------------------------

def _problem(spec: ScenarioSpec) -> synthetic.LinearModelProblem:
    return synthetic.LinearModelProblem(
        dim=spec.dim, noise_var=spec.noise_var, seed=spec.data_seed)


@registry.register_paradigm("diffusion")
def _diffusion_adapter(spec: ScenarioSpec, device: torch.device):
    problem = _problem(spec)
    grad_fn = synthetic.make_stacked_grad_fn(
        problem, spec.num_agents, data=spec.data, alpha=spec.dirichlet_alpha,
        seed=spec.data_seed, device=device)
    agg_name, _ = spec.resolved_aggregator()
    config = diffusion.DiffusionConfig(
        step_size=spec.step_size, aggregator=agg_name,
        agg_kwargs=spec.agg_kwargs, byzantine=spec.byzantine())
    comb_np = spec.combination()
    diffusion.check_compatible(config, comb_np)
    w_star = problem.w_star(device)
    w0 = torch.zeros((spec.num_agents, spec.dim), dtype=w_star.dtype,
                     device=device)
    comb = torch.as_tensor(comb_np, dtype=w0.dtype, device=device)
    return registry.Lowering(w0, _diffusion_step_fn(grad_fn, comb, config,
                                                     w_star))


@registry.register_paradigm("federated")
def _federated_adapter(spec: ScenarioSpec, device: torch.device):
    problem = _problem(spec)
    grad_fn = synthetic.make_client_grad_fn(
        problem, spec.num_agents, data=spec.data, alpha=spec.dirichlet_alpha,
        seed=spec.data_seed, device=device)
    agg_name, _ = spec.resolved_aggregator()
    config = federated.FederatedConfig(
        num_clients=spec.num_agents,
        clients_per_round=spec.clients_per_round(),
        local_steps=spec.local_steps, step_size=spec.step_size,
        aggregator=agg_name, agg_kwargs=spec.agg_kwargs,
        byzantine=spec.byzantine())
    w_star = problem.w_star(device)
    return registry.Lowering(torch.zeros_like(w_star),
                             _federated_step_fn(grad_fn, config, w_star))


@registry.register_paradigm("sharded")
def _sharded_adapter(spec: ScenarioSpec, device: torch.device):
    problem = _problem(spec)
    grad_fn = synthetic.make_stacked_grad_fn(
        problem, spec.num_agents, data=spec.data, alpha=spec.dirichlet_alpha,
        seed=spec.data_seed, device=device)
    agg_name, agg_kw = spec.resolved_aggregator()
    byz = spec.byzantine()
    w_star = problem.w_star(device)
    w0 = torch.zeros_like(w_star)
    collective = dict(spec.paradigm_kwargs).get("collective")
    if collective:
        # the reference's guards: its shard_map region cannot host a
        # pallas_call, and it needs one device per agent
        if spec.backend == "pallas":
            raise ValueError(
                "collective sharded scenarios keep the reference's rule: "
                "backend='jnp' (its per-rank region hosts no kernel)")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != spec.num_agents:
            raise RuntimeError(
                f"collective sharded scenario runs one agent a rank: needs a "
                f"process group of {spec.num_agents} ranks, have {world}")
        from repro_torch.launch.mesh import AgentMesh
        method = "mean" if agg_name == "mean" else collective
        step = _sharded_collective_step_fn(
            grad_fn, byz, spec.num_agents, spec.step_size, w_star, method,
            agg_name, agg_kw, AgentMesh())
    else:
        step = _sharded_step_fn(grad_fn,
                                sharded.engine_aggregator(agg_name, **agg_kw),
                                byz, spec.num_agents, spec.step_size, w_star)
    return registry.Lowering(w0, step)


@registry.register_paradigm("substrate")
def _substrate_adapter(spec: ScenarioSpec, device: torch.device):
    # lazy: the substrate pulls the training stack (launch, models, optim)
    from repro_torch.scenarios import substrate
    return substrate.lower(spec, device)


# ---------------------------------------------------------------------------
# run
# ---------------------------------------------------------------------------

def _audit_from_records(records) -> Optional[dict]:
    """One ``launch_plan`` dict per distinct kernel workload the engine
    resolved during the run (the plan dict itself for a single one)."""
    plans = []
    for r in records:
        if r["backend"] != "pallas":
            continue
        plan = mm_aggregate.launch_plan(
            r["k"], r["m"], r["n"], dtype=r["dtype"], block_m=r["block_m"],
            block_k=r["block_k"], path=r["path"])
        d = plan._asdict()
        d["grid"] = list(d["grid"])
        plans.append(d)
    if not plans:
        return None
    if len(plans) == 1:
        return plans[0]
    return {"layouts": plans, "n_layouts": len(plans)}


def _validated_override(state0, w0, spec: ScenarioSpec):
    if not isinstance(state0, torch.Tensor):
        raise ValueError(
            f"paradigm {spec.paradigm!r} has no (K, M) or (M,) model state "
            "to override with w0")
    w0 = torch.as_tensor(w0)
    if tuple(w0.shape) != tuple(state0.shape):
        raise ValueError(
            f"w0 override has shape {tuple(w0.shape)}, but paradigm "
            f"{spec.paradigm!r} expects state of shape {tuple(state0.shape)} "
            "((K, M) stacked agent models for diffusion, (M,) for "
            "federated/sharded)")
    return w0.to(dtype=state0.dtype, device=state0.device, copy=True)


# in-process cache of lowerings, least recently used evicted first
_EXEC_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_EXEC_CACHE_MAX = 32


def clear_executable_cache() -> None:
    _EXEC_CACHE.clear()


def executable_cache_size() -> int:
    return len(_EXEC_CACHE)


def _exec_cache_key(spec: ScenarioSpec, device):
    return (spec, str(device), tuning.cache_state())


def _lowered_state(spec: ScenarioSpec, device: torch.device, w0=None,
                   lowering: Optional[registry.Lowering] = None):
    """(lowering, state0, generator): ``lowering`` (None: the paradigm
    adapter's, built now), a fresh copy of its initial state (or the
    validated ``w0``), and the generator seeded by ``spec.seed``."""
    low = lowering or registry.as_lowering(
        registry.get_paradigm(spec.paradigm)(spec, device))
    state0 = copy.deepcopy(low.state0) if w0 is None \
        else _validated_override(low.state0, w0, spec)
    return low, state0, torch.Generator(device=device).manual_seed(spec.seed)


def run(spec: ScenarioSpec, *, w0=None, device="cuda") -> ScenarioResult:
    """Lower the spec through its paradigm adapter (or reuse the cached
    lowering of an identical spec) and run it on ``device`` (CUDA unless
    the caller asks for the CPU).  A ``w0`` override hits the cache too."""
    dev = devices.resolve(device)
    key = _exec_cache_key(spec, dev)
    cached = _EXEC_CACHE.get(key)
    cache_hit = cached is not None
    t0 = time.perf_counter()
    low, state, generator = _lowered_state(spec, dev, w0, cached)
    if cache_hit:
        _EXEC_CACHE.move_to_end(key)
        compile_s = 0.0
    else:
        warm = torch.Generator(device=dev).manual_seed(spec.seed + 1)
        loop(low.step_fn, copy.deepcopy(low.state0), warm,
             min(1, spec.num_steps))
        _sync(dev)
        compile_s = time.perf_counter() - t0
        _EXEC_CACHE[key] = low
        while len(_EXEC_CACHE) > _EXEC_CACHE_MAX:
            _EXEC_CACHE.popitem(last=False)

    with ops.record_workloads() as records:
        t0 = time.perf_counter()
        state, hist = loop(low.step_fn, state, generator, spec.num_steps)
        _sync(dev)
        wall = time.perf_counter() - t0

    history = {name: h.cpu().numpy() for name, h in _stack(hist).items()}
    if low.finalize is not None:
        history = low.finalize(history)
    else:
        history["loss"] = history["msd"] + spec.noise_var
    level = low.breakdown_level if low.breakdown_level is not None \
        else metrics.breakdown_threshold(spec)
    return ScenarioResult(
        spec=spec, history=history,
        summary=metrics.attack_summary(history["msd"], breakdown_level=level),
        wall_clock_s=wall, compile_s=compile_s, compile_cache_hit=cache_hit,
        launch_audit=_audit_from_records(records), final_state=state,
        device=str(dev))
