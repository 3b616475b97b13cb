"""Lower a ``ScenarioSpec`` to one program and run it (``repro.scenarios.runner``).

Every paradigm contributes an adapter (``registry.register_paradigm``)
that maps a spec to its initial state and step function.
``trace_spec(spec)`` lowers a spec and compiles its whole trajectory
into a ``ScenarioProgram`` without running it; ``run(spec)`` replays
that program once, copies the per-step metrics to the host, summarizes
attack success, and attaches a launch audit built from the kernel
workloads the engine resolved (``kernels.ops.record_workloads``).

The compiled trajectory.  The reference compiles one ``lax.scan`` over
``spec.num_steps`` split keys.  On a CUDA device the port's counterpart
is one CUDA graph of all ``num_steps`` steps, captured from the eager
``loop`` with each step's index baked in.  The steps draw from the
spec's ``torch.Generator``, which is registered with the graph, so a
replay re-seeded with ``spec.seed`` draws the same Philox stream as the
eager loop, and its histories are ``loop``'s bit for bit.  Before the
capture the lowering runs one warm-up step on a copy of the initial
state, on a side stream, from a generator of its own (seeded
``spec.seed + 1``): it builds the kernels, opts them in to their shared
memory and fills the tuning cache, none of which may happen inside a
capture.  A failed capture raises; nothing falls back to the eager loop
on a card.  On the CPU the program runs the eager ``loop``.

What stays eager.  The ``substrate`` paradigm (a full LM train step,
its many small launches a step, and optimizers that update their state
in place) and the ``rs_mm``
collective lowering of the ``sharded`` paradigm (gloo's collectives
cannot be captured) run the eager loop on the card too.

Programs are cached in-process (``clear_executable_cache``,
``executable_cache_size``), keyed by (spec, device, tuning state): the
frozen spec fixes the adapter's lowering, and the tuning fingerprint
keeps a new autotune winner from reusing a program whose launches were
resolved for another geometry.  A miss's ``compile_s`` times
``trace_spec`` (the lowering, the warm-up step and the capture, or for
the eager paradigms the lowering and the warm-up step); a hit's is 0.0
and replays the cached program.  ``wall_clock_s`` times the replay of
all ``num_steps`` from the initial state, ended by a synchronize.  A
``w0`` override is copied into the program's static state and hits the
cache too.  The least recently used program is evicted past
``_EXEC_CACHE_MAX`` and releases its graph and memory pool.

``diffusion_loop`` / ``federated_loop`` compile the same step functions
without the spec layer or the cache (captured on a card) and replay
them once from the caller's generator as it stands;
``core.diffusion.run_diffusion`` and ``core.federated.run_federated``
delegate here.  A program replayed once costs more than the eager loop:
its capture drives the same Python step by step, and the graph is then
instantiated (``ScenarioProgram.timings`` splits a compile).

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

from repro_torch import devices, pytree
from repro_torch.core import diffusion, federated, sharded
from repro_torch.data import synthetic
from repro_torch.kernels import launches, mm_aggregate, ops, tuning
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


def _federated_step_fn(grad_fn, config, w_star, dtype=None):
    # the client weights go to the device once, not every round
    weights = federated.client_weight_tensor(
        config, dtype or w_star.dtype, w_star.device)

    def step(w, generator, i):
        w_next = federated.federated_round(
            w, generator, grad_fn=grad_fn, config=config, step=i,
            client_weights=weights)
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
    return _run_once(step, w0, generator, num_iters)


def federated_loop(*, grad_fn, config, w_star, num_rounds: int,
                   generator: torch.Generator, w0=None):
    """The FedAvg-with-robust-server loop; returns (final w, metrics)."""
    if w0 is None:
        w0 = torch.zeros_like(w_star)
    step = _federated_step_fn(grad_fn, config, w_star, w0.dtype)
    return _run_once(step, w0, generator, num_rounds)


def _run_once(step_fn, w0, generator: torch.Generator, num_steps: int):
    """A legacy loop: on a card, compile it (no cache) and replay it once
    from the generator as it stands; elsewhere the eager ``loop``.
    (final state, stacked metrics), both the caller's own tensors."""
    if w0.device.type != "cuda":
        final, hist = loop(step_fn, w0, generator, num_steps)
        return final, _stack(hist)
    program = compile_trajectory(
        registry.Lowering(w0, step_fn), w0, generator, num_steps,
        device=w0.device, warm_seed=generator.initial_seed() + 1)
    final, hist = program.replay(w0)
    if program.captured:
        final = final.clone()
        hist = {name: h.clone() for name, h in hist.items()}
        program.release()
    return final, hist


# ---------------------------------------------------------------------------
# the compiled trajectory
# ---------------------------------------------------------------------------

class ScenarioProgram:
    """A compiled trajectory (``trace_spec``, the legacy loops).

    ``state0`` is the state a replay starts from unless it is given
    another, ``generator`` the generator the steps draw from and
    ``records`` the engine workloads the compile resolved.  With
    ``graph`` set (a CUDA device, a capturable paradigm) ``state`` is
    the graph's static input and ``final_state`` / ``history`` its
    static outputs, overwritten by the next replay; ``launches`` holds the
    keys of the kernel launches the capture made, counted on every
    replay (``launches.replay``).  Without a graph a replay
    runs the eager ``loop`` on a fresh copy of the state.  ``timings``
    splits the compile's seconds: ``warm_up_s`` (the warm-up step and a
    synchronize), and for a captured program ``capture_s`` (the Python
    that drives the steps under capture) and ``instantiate_s`` (ending
    the capture and instantiating the graph).
    """

    def __init__(self, lowering: registry.Lowering, state0,
                 generator: torch.Generator, num_steps: int):
        self.lowering = lowering
        self.state0 = state0
        self.generator = generator
        self.num_steps = num_steps
        self.records: list = []
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.state = None
        self.final_state = None
        self.history: Optional[dict] = None
        self.launches = collections.Counter()  # launch keys a replay
        self.timings: dict = {}

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def replay(self, state=None, seed: Optional[int] = None):
        """All ``num_steps`` from ``state`` (``state0`` when None), the
        generator re-seeded with ``seed`` first (as it stands when
        None): (final state, {metric: (T,) tensor}).  Asynchronous on
        the card, where both are the graph's own outputs."""
        if seed is not None:
            self.generator.manual_seed(seed)
        if self.graph is None:
            start = copy.deepcopy(self.state0) if state is None else state
            final, hist = loop(self.lowering.step_fn, start, self.generator,
                               self.num_steps)
            return final, _stack(hist)
        src = pytree.flatten(self.state0 if state is None else state)[0]
        for dst, value in zip(pytree.flatten(self.state)[0], src):
            dst.copy_(value)
        self.graph.replay()
        launches.replay(self.launches)
        return self.final_state, self.history

    def release(self) -> None:
        """Free the graph and its memory pool (an evicted program)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.state = self.final_state = self.history = None


def compile_trajectory(lowering: registry.Lowering, state0,
                       generator: torch.Generator, num_steps: int, *,
                       device: torch.device, warm_seed: int,
                       capture: bool = True) -> ScenarioProgram:
    """The ``ScenarioProgram`` of ``num_steps`` steps of the lowering from
    ``state0`` with ``generator``: one warm-up step on a copy of the
    state from a generator seeded ``warm_seed`` (on a side stream on the
    card), then, on a CUDA device where ``capture`` holds, the capture of
    the whole trajectory.  The generator's state is left as it was."""
    dev = device
    program = ScenarioProgram(lowering, state0, generator, num_steps)
    warm = torch.Generator(device=dev).manual_seed(warm_seed)

    def warm_step():
        loop(lowering.step_fn, copy.deepcopy(state0), warm,
             min(1, num_steps))

    with ops.record_workloads() as records:
        t0 = time.perf_counter()
        if dev.type != "cuda" or not capture or num_steps == 0:
            warm_step()
            _sync(dev)
            program.timings["warm_up_s"] = time.perf_counter() - t0
        else:
            ops.warm_up(warm_step, dev)
            t1 = time.perf_counter()
            static = pytree.tree_map(torch.clone, state0)
            driven = []

            def trajectory():
                final, hist = loop(lowering.step_fn, static, generator,
                                   num_steps)
                out = final, _stack(hist)
                driven.append(time.perf_counter())
                return out

            program.graph, (program.final_state, program.history), \
                program.launches = ops.capture_graph(trajectory, (generator,))
            program.state = static
            program.timings.update(
                warm_up_s=t1 - t0, capture_s=driven[0] - t1,
                instantiate_s=time.perf_counter() - driven[0])
    program.records = list(records)
    return program


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


def _capturable(spec: ScenarioSpec) -> bool:
    """Whether the spec's trajectory is captured on a card (module
    docstring: the substrate and the rs_mm collective stay eager)."""
    return spec.paradigm != "substrate" and not (
        spec.paradigm == "sharded"
        and dict(spec.paradigm_kwargs).get("collective"))


# in-process cache of programs, least recently used evicted first
_EXEC_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_EXEC_CACHE_MAX = 32


def clear_executable_cache() -> None:
    while _EXEC_CACHE:
        _EXEC_CACHE.popitem()[1].release()


def executable_cache_size() -> int:
    return len(_EXEC_CACHE)


def _exec_cache_key(spec: ScenarioSpec, device):
    return (spec, str(device), tuning.cache_state())


def _lowered_state(spec: ScenarioSpec, device: torch.device):
    """(lowering, a fresh copy of its initial state, the generator seeded
    by ``spec.seed``): what the eager ``loop`` of a spec starts from."""
    low = registry.as_lowering(
        registry.get_paradigm(spec.paradigm)(spec, device))
    return (low, copy.deepcopy(low.state0),
            torch.Generator(device=device).manual_seed(spec.seed))


def trace_spec(spec: ScenarioSpec, *, w0=None, device="cuda"):
    """Compile (do not run) the exact program ``run(spec)`` replays.

    Returns ``(program, records)``: the ``ScenarioProgram`` (on a CUDA
    device one CUDA graph of all ``spec.num_steps`` steps, except for
    the eager paradigms) and the engine workloads its warm-up step and
    capture resolved (``ops.record_workloads``).  The program's
    generator is seeded by ``spec.seed`` and not drawn from; ``w0`` is
    validated and copied, never written."""
    dev = devices.resolve(device)
    low = registry.as_lowering(
        registry.get_paradigm(spec.paradigm)(spec, dev))
    # every replay starts from a copy of state0, so it is not copied here
    state0 = low.state0 if w0 is None \
        else _validated_override(low.state0, w0, spec)
    generator = torch.Generator(device=dev).manual_seed(spec.seed)
    program = compile_trajectory(low, state0, generator, spec.num_steps,
                                 device=dev, warm_seed=spec.seed + 1,
                                 capture=_capturable(spec))
    return program, list(program.records)


def run(spec: ScenarioSpec, *, w0=None, device="cuda") -> ScenarioResult:
    """Compile the spec's trajectory (``trace_spec``; a cache miss) or
    take the cached program of an identical spec (a hit), then replay
    it once on ``device`` (CUDA unless the caller asks for the CPU) with
    the generator re-seeded by ``spec.seed``.  On a card that replay is
    one CUDA graph, except for the ``substrate`` paradigm and the
    ``rs_mm`` collective lowering, which run the eager loop (module
    docstring).  ``final_state`` is the run's own copy; a ``w0``
    override hits the cache too."""
    dev = devices.resolve(device)
    key = _exec_cache_key(spec, dev)
    program = _EXEC_CACHE.get(key)
    cache_hit = program is not None
    if cache_hit:
        _EXEC_CACHE.move_to_end(key)
        compile_s = 0.0
    else:
        t0 = time.perf_counter()
        program, _ = trace_spec(spec, device=dev)
        compile_s = time.perf_counter() - t0
        _EXEC_CACHE[key] = program
        while len(_EXEC_CACHE) > _EXEC_CACHE_MAX:
            _EXEC_CACHE.popitem(last=False)[1].release()
    state = None if w0 is None \
        else _validated_override(program.state0, w0, spec)

    t0 = time.perf_counter()
    final, hist = program.replay(state, seed=spec.seed)
    _sync(dev)
    wall = time.perf_counter() - t0
    # out of the graph's memory before anything can replay it again
    history = {name: h.cpu().numpy() for name, h in hist.items()}
    if program.captured:
        final = pytree.tree_map(torch.clone, final)

    low = program.lowering
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
        launch_audit=_audit_from_records(program.records), final_state=final,
        device=str(dev))
