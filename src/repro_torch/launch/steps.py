"""Train and serve steps (``repro.launch.steps``): the paper's
aggregation as a first-class part of the training step.

Mode A, replicated parameters on one card: K simulated agents, each with
its own shard of the batch.  Each agent's gradient comes from its own
forward and backward (``torch.autograd.grad``), one agent after
another, and is written into row k of a per-leaf (K, *leaf.shape) f32
stack -- the reference's vmapped layout, made without ever holding more
than one agent's activations and gradients.  The Byzantine agents then
corrupt their rows, leaf by leaf; every leaf is aggregated by one MM
estimate along K (``aggregate_stack``: one kernel launch per leaf on the
kernel backend), and the optimizer applies the aggregate.

On one card the reference's ``rs_mm``, ``gather_mm`` and ``hier_mm``
(with no ``pod`` axis) differ only in sharding constraints, which are
no-ops here, so all three are the same per-leaf MM estimate; ``mean``
is the f32 mean.  Mode B (FSDP with the robust gather) and the
collectives are ROADMAP queue 1, item 2.

Serve steps (prefill / decode) run the model without aggregation and
without autograd.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch import devices, pytree
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import attacks as attacks_lib
from repro_torch.core import sharded as sharded_lib
from repro_torch.models import model as M
from repro_torch.optim import optimizers

AGGREGATIONS = ("mean", "gather_mm", "rs_mm", "hier_mm")
# the seed of the attack's generator, folded with the step as the
# reference folds jax.random.key(17) with it
_ATTACK_SEED = 17


# ===========================================================================
# Mode A: robust aggregation over stacked per-agent gradients
# ===========================================================================

def _mm_axis0(flat: torch.Tensor, num_iters: int,
              use_kernel: bool = False) -> torch.Tensor:
    """Every MM aggregation in the train steps resolves through the one
    shared path (``core.sharded.engine_aggregator`` -> ``kernels.ops``);
    ``use_kernel`` (``ParallelConfig.use_kernel``) selects the Hopper
    kernel, else the plain PyTorch estimator."""
    agg = sharded_lib.engine_aggregator(
        "mm_pallas" if use_kernel else "mm_tukey", num_iters=num_iters)
    return agg(flat, None)


def aggregate_stack(grads, par: ParallelConfig):
    """Aggregate per-agent gradient pytrees (leaves (K, ...)) into one,
    leaf by leaf: the f32 mean for ``mean``, else one MM estimate along
    K per leaf."""
    method = par.aggregation
    if method not in AGGREGATIONS:
        raise ValueError(f"unknown aggregation {method!r}; known: "
                         f"{AGGREGATIONS}")

    def one(leaf):
        if method == "mean":
            est = torch.mean(leaf.float(), dim=0)
        else:
            est = _mm_axis0(leaf.float(), par.agg_num_iters, par.use_kernel)
        return est.to(leaf.dtype)

    return pytree.tree_map(one, grads)


def grad_consensus(grads, benign: torch.Tensor) -> torch.Tensor:
    """Mean squared distance of the benign agents' stacked per-agent
    gradients (leaves (K, ...)) from their benign centroid, summed over
    leaves -- the pre-aggregation disagreement the robust estimator has
    to resolve (the substrate paradigm's ``consensus`` metric).  The
    distances are taken row by row, so a leaf needs one row of
    temporaries, not K."""
    bf = benign.float()
    nb = torch.clamp(torch.sum(bf), min=1.0)
    total = torch.zeros((), dtype=torch.float32, device=bf.device)
    for g in pytree.flatten(grads)[0]:
        gf = g.float()
        centroid = torch.tensordot(bf, gf, dims=1) / nb
        for k in range(gf.shape[0]):
            total = total + torch.square(
                torch.linalg.vector_norm(gf[k] - centroid)) * bf[k]
    return total / nb


class PhaseTimer:
    """CUDA-event device times of a step's phases, summed per name; a
    no-op off the card."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._events: list = []

    def reset(self) -> None:
        self._events = []

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._events.append((name, start, end))

    def phase_ms(self) -> dict:
        """{phase: device ms} of the last step (synchronizes)."""
        if not self._events:
            return {}
        torch.cuda.synchronize()
        out: dict = {}
        for name, start, end in self._events:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


class TrainStep:
    """Mode A train step: ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.  ``params`` is a ``models.model.Model`` or its
    parameter tree; it and the optimizer state are updated in place and
    returned.  ``batch["tokens"]`` is (B, S+1) with B divisible by K:
    agent k takes rows [k B/K, (k+1) B/K), split further into
    ``par.microbatches`` microbatches whose gradients are averaged.

    After a step, ``last_stacks`` holds the (K, ...) f32 gradient stack
    of every leaf as the Byzantine agents left it (``pytree.flatten``
    order), ``last_aggregate`` the per-leaf estimates the optimizer
    applied, and ``phase_ms()`` the device time of each phase (on the
    card; a few CUDA events a step); the next step drops them first."""

    def __init__(self, model_cfg: ModelConfig, par: ParallelConfig,
                 opt_cfg: optimizers.OptimizerConfig, device,
                 byzantine: Optional[attacks_lib.ByzantineConfig],
                 k_agents: int, consensus_metric: bool):
        if par.fsdp:
            raise NotImplementedError(
                "Mode B (FSDP with the robust gather) is ROADMAP queue 1, "
                "item 2; this is the Mode A step")
        self.model_cfg = model_cfg
        self.par = par
        self.opt_cfg = opt_cfg
        self.device = devices.resolve(device)
        self.byzantine = byzantine
        self.k_agents = int(k_agents)
        self.consensus_metric = consensus_metric
        self.timer = PhaseTimer(self.device.type == "cuda")
        self.last_stacks: Optional[list] = None
        self.last_aggregate: Optional[list] = None

    def phase_ms(self) -> dict:
        return self.timer.phase_ms()

    def _attacking(self) -> bool:
        return self.byzantine is not None and self.byzantine.num_malicious > 0

    def _grad_into(self, stacks, row: int, tree, leaves, batch,
                   first: bool) -> torch.Tensor:
        """One forward and backward on ``batch``; its gradient written
        (``first``) or added into row ``row`` of every stack."""
        with torch.enable_grad():
            loss = M.loss_fn(tree, self.model_cfg, batch,
                             remat=self.par.remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        with torch.no_grad():
            for s, g in zip(stacks, grads):
                if first:
                    s[row].copy_(g)
                else:
                    s[row].add_(g)
        return loss.detach()

    def _agent_grads(self, stacks, tree, leaves, batch) -> torch.Tensor:
        """Every agent's gradient into its row; (K,) losses."""
        k = self.k_agents
        rows = batch["tokens"].shape[0]
        if rows % k:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{k} agents")
        per = rows // k
        nm = min(self.par.microbatches, per)
        if per % nm:
            raise ValueError(f"{per} rows per agent do not split into "
                             f"{nm} microbatches")
        mper = per // nm
        losses = []
        for a in range(k):
            micro = []
            for j in range(nm):
                lo = a * per + j * mper
                mb = {name: t[lo:lo + mper] for name, t in batch.items()}
                micro.append(self._grad_into(stacks, a, tree, leaves, mb,
                                             first=j == 0))
            if nm > 1:
                with torch.no_grad():
                    for s in stacks:
                        s[a].div_(nm)
            losses.append(torch.mean(torch.stack(micro)))
        return torch.stack(losses)

    def __call__(self, params, opt_state, batch):
        self.last_stacks = self.last_aggregate = None
        self.timer.reset()
        step = int(opt_state.step)
        tree = M.param_tree(params)
        leaves, treedef = pytree.flatten(tree)
        for leaf in leaves:
            if not leaf.requires_grad:
                leaf.requires_grad_(True)
        stacks = [torch.empty((self.k_agents,) + tuple(leaf.shape),
                              dtype=torch.float32, device=leaf.device)
                  for leaf in leaves]
        with self.timer.phase("forward_backward"):
            losses = self._agent_grads(stacks, tree, leaves, batch)

        with torch.no_grad():
            if self._attacking():
                # in place on the list: each honest stack is freed as its
                # corrupted copy replaces it
                gen = torch.Generator(device=stacks[0].device).manual_seed(
                    (_ATTACK_SEED << 32) + step)
                with self.timer.phase("attack"):
                    self.byzantine.apply_tree(stacks, gen, step)

            with self.timer.phase("aggregate"):
                agg = aggregate_stack(stacks, self.par)
            agg_tree = pytree.unflatten(treedef, agg)
            with self.timer.phase("update"):
                params_tree, new_opt = optimizers.update(
                    self.opt_cfg, tree, agg_tree, opt_state)
            metrics = {"loss": torch.mean(losses),
                       "grad_norm": optimizers.global_norm(agg_tree)}
            if self.consensus_metric:
                with self.timer.phase("consensus"):
                    if self._attacking():
                        benign = ~self.byzantine.malicious_mask(
                            self.k_agents, step, stacks[0].device)
                    else:
                        benign = torch.ones((self.k_agents,), dtype=torch.bool,
                                            device=stacks[0].device)
                    metrics["consensus"] = grad_consensus(stacks, benign)
        self.last_stacks, self.last_aggregate = stacks, agg
        return params, new_opt, metrics


def make_train_step_gspmd(model_cfg: ModelConfig, par: ParallelConfig,
                          opt_cfg: optimizers.OptimizerConfig,
                          device="cuda",
                          byzantine: Optional[attacks_lib.ByzantineConfig] = None,
                          k_agents: Optional[int] = None,
                          consensus_metric: bool = False) -> TrainStep:
    """The Mode A train step (the reference's name, with ``device`` in
    place of its mesh).  ``k_agents`` simulated agents share the card
    (default 1: one card is one agent of the reference's mesh).
    ``consensus_metric`` adds ``grad_consensus`` over the benign agents'
    stacks to the metrics: a full extra f32 pass over the (K, param)
    stacks, so a train loop that never reads it should not ask for it."""
    return TrainStep(model_cfg, par, opt_cfg, device, byzantine,
                     1 if k_agents is None else k_agents, consensus_metric)


# ===========================================================================
# serve steps
# ===========================================================================

def make_prefill_step(model_cfg: ModelConfig, device="cuda"):
    """``step(params, batch) -> (B, 1, V)`` last-position logits."""
    devices.resolve(device)

    @torch.no_grad()
    def step(params, batch):
        return M.prefill(params, model_cfg, batch, remat=False)
    return step


def make_decode_step(model_cfg: ModelConfig, device="cuda"):
    """``step(params, tokens (B, 1), cache) -> (next tokens (B, 1) int32,
    cache)``: one greedy decode step on the KV cache."""
    devices.resolve(device)

    @torch.no_grad()
    def step(params, tokens, cache):
        logits, cache = M.decode_step(params, model_cfg, tokens, cache)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return step
