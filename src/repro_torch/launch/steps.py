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
is the f32 mean.  As in the reference, Mode A ignores
``ParallelConfig.fsdp``: the FSDP step is ``make_train_step_fsdp``.

Mode B, FSDP over the agent ranks of a ``launch.mesh.AgentMesh`` (one
agent a process, ``torch.distributed`` underneath): the block leaves are
stored sharded on an fsdp dim (``fsdp_dims``; ``shard_params`` cuts a
full tree into rank r's shards), and every layer gathers its block
through ``fsdp_gather_robust``, whose backward replaces the usual
reduce-scatter(sum) with the robust all-to-all + MM + keep-own-shard
scatter.  Aggregation therefore happens per (layer x microbatch).  The
roots that are not hooked (embed, head, norms) take the robust
all-reduce of ``core.sharded`` after the backward.  The reference's
``model`` mesh axis has no counterpart (model size 1).

Serve steps (prefill / decode) run the model without aggregation and
without autograd; with ``fsdp=True`` each rank serves its rows of the
batch with the same per-layer gather (forward only).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch import devices, pytree
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import attacks as attacks_lib
from repro_torch.core import sharded as sharded_lib
from repro_torch.launch.mesh import AgentMesh, agent_axes, num_agents
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
    ``par.fsdp`` is ignored, as the reference's Mode A ignores it.
    ``consensus_metric`` adds ``grad_consensus`` over the benign agents'
    stacks to the metrics: a full extra f32 pass over the (K, param)
    stacks, so a train loop that never reads it should not ask for it."""
    return TrainStep(model_cfg, par, opt_cfg, device, byzantine,
                     1 if k_agents is None else k_agents, consensus_metric)


# ===========================================================================
# Mode B: FSDP with the robust-scatter backward
# ===========================================================================

# roots whose stacked leaves are scanned (and hence fsdp-hookable), and
# how many leading stacking dims each has
SCAN_DIMS = {"blocks": 1, "enc_blocks": 1, "mamba_groups": 2}
GATHER_DTYPE = torch.bfloat16   # compute copy of a gathered layer
_MM_CHUNK_BYTES = 64 * 2 ** 20
# the Mode B step and serve steps take these families (the reference's
# make_train_step_fsdp asserts the same)
FSDP_ARCH_TYPES = ("dense", "moe", "vlm")


def _shardable(dim: int, size: int) -> bool:
    """Evenly divisible, or big enough that padding waste is <13% (the
    reference's rule for its model axis)."""
    return dim % size == 0 or dim >= 8 * size


def shard_dims(sliced_shape, fsdp_size: int, model_size: int):
    """(fsdp_dim, model_dim) for a *sliced* (per-layer) leaf: the
    reference's choice, which picks the model dim first (the largest
    shardable one; the expert dim of a 3D expert tensor), then the first
    remaining dim that divides the fsdp size.  1D leaves prefer fsdp, so
    that their gradients go through the robust scatter."""
    nd = len(sliced_shape)
    if nd == 1:
        if fsdp_size > 1 and sliced_shape[0] % fsdp_size == 0:
            return 0, -1
        if model_size > 1 and sliced_shape[0] % model_size == 0:
            return -1, 0
        return -1, -1
    md = -1
    if model_size > 1:
        if nd == 3 and sliced_shape[0] % model_size == 0:
            md = 0  # expert parallelism
        else:
            best_sz = 0
            for i in range(nd):
                if _shardable(sliced_shape[i], model_size) \
                        and sliced_shape[i] >= best_sz:
                    md, best_sz = i, sliced_shape[i]
    fd = -1
    if fsdp_size > 1:
        for i in range(nd):
            if i != md and sliced_shape[i] % fsdp_size == 0:
                fd = i
                break
    return fd, md


def fsdp_dim_for(sliced_shape, fsdp_size: int, model_size: int = 1) -> int:
    return shard_dims(sliced_shape, fsdp_size, model_size)[0]


def param_template(model_cfg: ModelConfig) -> dict:
    """The parameter tree's shapes, allocated nowhere (meta tensors)."""
    return M.init_model(model_cfg, generator=torch.Generator(),
                        device="meta").tree()


def fsdp_dims(template: dict, k_agents: int) -> dict:
    """The tree of each leaf's dim sharded over the K agents in Mode B,
    -1 where the leaf is replicated: the reference's ``param_specs(...,
    fsdp=True)`` with model size 1.  Only the roots of ``SCAN_DIMS`` are
    sharded (on the first dim of the per-layer slice that K divides);
    embed, head and the norms stay whole on every rank.  ``template``
    is a full tree (tensors of any device, the meta one included)."""
    out = {}
    for root, sub in template.items():
        sd = SCAN_DIMS.get(root)

        def one(leaf, sd=sd):
            if sd is None:
                return -1
            fd = fsdp_dim_for(tuple(leaf.shape[sd:]), k_agents)
            return sd + fd if fd >= 0 else -1

        out[root] = pytree.tree_map(one, sub) if isinstance(sub, dict) \
            else one(sub)
    return out


def shard_params(tree: dict, k_agents: int, index: int) -> dict:
    """Agent ``index``'s Mode B shards of a full parameter (or optimizer
    moment) tree: each sharded leaf's ``index``-th of K equal blocks
    along its fsdp dim (a copy), the replicated leaves as they are."""
    dims = pytree.flatten(fsdp_dims(tree, k_agents))[0]
    leaves, treedef = pytree.flatten(tree)
    out = []
    for leaf, d in zip(leaves, dims):
        if d < 0:
            out.append(leaf)
        else:
            n = leaf.shape[d] // k_agents
            out.append(leaf.narrow(d, index * n, n).clone())
    return pytree.unflatten(treedef, out)


def unshard_params(shards: list, dims: dict) -> dict:
    """The full tree from every agent's shards, ``shard_params``'s
    inverse: ``dims`` is ``fsdp_dims`` of the full template (local
    shapes would misjudge what divides K); sharded leaves are glued
    along their dim, replicated ones taken from agent 0."""
    per = [pytree.flatten(s)[0] for s in shards]
    treedef = pytree.flatten(shards[0])[1]
    out = [per[0][j] if d < 0 else torch.cat([p[j] for p in per], dim=d)
           for j, d in enumerate(pytree.flatten(dims)[0])]
    return pytree.unflatten(treedef, out)


def _chunked_mm_axis0(sw: torch.Tensor, num_iters: int,
                      use_kernel: bool = False) -> torch.Tensor:
    """MM over axis 0 of (K, n0, ...) in chunks along n0, so each f32
    temporary stays within ``_MM_CHUNK_BYTES``: one engine launch per
    chunk, the estimates written into one (n0, ...) f32 tensor."""
    k, n0 = sw.shape[0], sw.shape[1]
    rest = 1
    for d in sw.shape[2:]:
        rest *= d
    per_row = k * rest * 4
    target = max(1, _MM_CHUNK_BYTES // max(per_row, 1))
    c = 1
    for cand in range(min(target, n0), 0, -1):
        if n0 % cand == 0:
            c = cand
            break
    if c == n0:
        return _mm_axis0(sw.float(), num_iters, use_kernel)
    out = torch.empty(tuple(sw.shape[1:]), dtype=torch.float32,
                      device=sw.device)
    for lo in range(0, n0, c):
        out[lo:lo + c] = _mm_axis0(sw[:, lo:lo + c].float(), num_iters,
                                   use_kernel)
    return out


class FsdpHook:
    """The per-layer gather of Mode B (``layer_hook``): each block leaf
    with an fsdp dim (``dims_tree``, from the GLOBAL template shapes:
    a (128,) q-norm is locally (32,) on 4 ranks, and a divisibility test
    on it would misfire) goes through ``fsdp_gather_robust``; the rest
    pass as they are.  ``robust=False`` is the serve hook: the gather
    alone, outside autograd.

    ``traffic`` sums the bytes this rank sent in the gathers and the
    scatters, ``timer`` (a ``PhaseTimer``) their device times."""

    def __init__(self, mesh: AgentMesh, dims_tree, *, method: str = "rs_mm",
                 num_iters: int = 10,
                 byzantine: Optional[attacks_lib.ByzantineConfig] = None,
                 use_kernel: bool = False, robust: bool = True,
                 timer: Optional["PhaseTimer"] = None):
        self.axis = mesh.agents
        self.dims = pytree.flatten(dims_tree)[0]
        self.method = method
        self.num_iters = num_iters
        self.byzantine = byzantine \
            if byzantine is not None and byzantine.num_malicious > 0 else None
        # the reference's static mask: the last num_malicious agents
        self.is_malicious = self.byzantine is not None and \
            self.axis.index >= self.axis.size - self.byzantine.num_malicious
        self.use_kernel = use_kernel
        self.robust = robust
        self.timer = timer or PhaseTimer(False)
        self.traffic = {"gather": 0, "scatter": 0}

    def __call__(self, blk):
        leaves, treedef = pytree.flatten(blk)
        out = []
        for w, d in zip(leaves, self.dims):
            if d < 0:
                out.append(w)
            elif self.robust:
                out.append(fsdp_gather_robust(w, d, self))
            else:
                out.append(self.gather(w, d))
        return pytree.unflatten(treedef, out)

    def gather(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """The tiled all-gather of this rank's f32 shard as bf16 along
        ``dim``."""
        sent = _sent()
        with self.timer.phase("gather"):
            parts = sharded_lib.all_gather(
                w.to(GATHER_DTYPE).movedim(dim, 0), self.axis)
            full = parts.reshape((-1,) + tuple(parts.shape[2:]))
            out = full.movedim(0, dim) if dim else full
        self.traffic["gather"] += _sent() - sent
        return out

    def scatter(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        """The robust scatter of a gathered leaf's gradient ``g``: this
        rank's f32 shard gradient, the MM estimate over the K agents
        (the sum over them / K for ``mean``)."""
        sent = _sent()
        k = self.axis.size
        with self.timer.phase("scatter"):
            if self.byzantine is not None:
                g = attacks_lib.apply_local(
                    g, self.is_malicious, self.byzantine.attack,
                    dict(self.byzantine.attack_kwargs))
            if self.method == "mean":
                est = sharded_lib.reduce_scatter_sum(
                    g.float().movedim(dim, 0), self.axis) / k
            else:
                g2 = g.movedim(dim, 0)
                sh = tuple(g2.shape)
                sw = sharded_lib.all_to_all(
                    g2.reshape((k, sh[0] // k) + sh[1:]), self.axis)
                est = _chunked_mm_axis0(sw, self.num_iters, self.use_kernel)
            out = est.movedim(0, dim).contiguous() if dim else est
        self.traffic["scatter"] += _sent() - sent
        return out


def _sent() -> int:
    return sum(sharded_lib.TRAFFIC.values())


class FsdpGatherRobust(torch.autograd.Function):
    """FSDP layer gather with a robust-aggregating backward.

    forward: the f32 master shard all-gathered as bf16 along its fsdp
    dim (half the traffic and residency of f32; the model casts to its
    activation dtype anyway).
    backward: in place of the usual reduce-scatter(sum), the robust
    scatter: the attackers corrupt their gradient (``apply_local``), an
    all-to-all gives each rank the full K column of its shard, and a
    chunked MM estimate (f32 temporaries within 64 MiB, one engine
    launch a chunk) becomes the f32 shard gradient."""

    @staticmethod
    def forward(ctx, w, dim: int, hook: FsdpHook):
        ctx.dim, ctx.hook = dim, hook
        return hook.gather(w, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.hook.scatter(g, ctx.dim), None, None


def fsdp_gather_robust(w: torch.Tensor, dim: int,
                       hook: FsdpHook) -> torch.Tensor:
    return FsdpGatherRobust.apply(w, dim, hook)


def block_dims_tree(template_blocks, fsdp_size: int, model_size: int = 1,
                    scan_dims: int = 1):
    """The sliced (per-layer) block tree's fsdp dim per leaf, -1 where no
    dim divides: such a leaf (dbrx's (d, E=16) router on 32 agents) is
    left un-hooked and aggregated after the backward, as embed and head
    are."""
    return pytree.tree_map(
        lambda leaf: fsdp_dim_for(tuple(leaf.shape[scan_dims:]), fsdp_size,
                                  model_size),
        template_blocks)


def make_fsdp_hook(mesh: AgentMesh, method: str, num_iters: int,
                   byzantine: Optional[attacks_lib.ByzantineConfig],
                   dims_tree, use_kernel: bool = False,
                   timer: Optional[PhaseTimer] = None) -> FsdpHook:
    """The Mode B ``layer_hook`` (the reference's, without its model-axis
    specs)."""
    return FsdpHook(mesh, dims_tree, method=method, num_iters=num_iters,
                    byzantine=byzantine, use_kernel=use_kernel, timer=timer)


def local_rows(batch: dict, mesh: AgentMesh) -> dict:
    """This agent's rows of a global batch (dim 0 split into K equal
    blocks, as the reference's batch specs shard it; a batch that K does
    not divide is replicated)."""
    k, r = num_agents(mesh), mesh.agent_index
    out = {}
    for name, t in batch.items():
        if t.shape[0] % k:
            out[name] = t
        else:
            n = t.shape[0] // k
            out[name] = t[r * n:(r + 1) * n]
    return out


class FsdpTrainStep:
    """Mode B train step on one agent rank: ``step(params, opt_state,
    batch) -> (params, opt_state, metrics)`` with this rank's parameter
    shards (``shard_params``), its optimizer state over them and its
    rows of the batch (``local_rows``); parameters and moments are
    updated in place.

    The batch splits into ``min(par.microbatches, rows)`` microbatches;
    the hook's robust scatter runs for each, and the gradients are
    averaged afterwards.  Embed, head, the norms and block leaves with
    no fsdp dim are corrupted on the attacker ranks (``apply_local``)
    and aggregated by ``robust_all_reduce`` with ``par.aggregation``.
    Then the optimizer runs on the local tree, as the reference's does
    inside its shard_map: its global-norm clip sees this rank's block
    shards and the replicated rest, so where the clip binds the factor
    differs between ranks (and the replicated leaves drift apart).
    ``loss`` is the mean over ranks, ``grad_norm`` the local tree's.

    ``traffic`` holds the bytes this rank sent in the last step (gathers,
    robust scatters, rest), ``phase_ms()`` the device time of each
    phase."""

    def __init__(self, model_cfg: ModelConfig, par: ParallelConfig,
                 opt_cfg: optimizers.OptimizerConfig, mesh: AgentMesh,
                 byzantine: Optional[attacks_lib.ByzantineConfig],
                 device):
        if model_cfg.arch_type not in FSDP_ARCH_TYPES:
            raise ValueError(f"Mode B takes the {FSDP_ARCH_TYPES} families, "
                             f"not {model_cfg.arch_type!r}")
        self.model_cfg = model_cfg
        self.par = par
        self.opt_cfg = opt_cfg
        self.mesh = mesh
        self.device = devices.resolve(device)
        self.byzantine = byzantine \
            if byzantine is not None and byzantine.num_malicious > 0 else None
        self.k_agents = num_agents(mesh)
        template = param_template(model_cfg)
        self.dims = pytree.flatten(fsdp_dims(template, self.k_agents))[0]
        self.roots = [path.split(".")[0]
                      for path in pytree.leaf_paths(template)]
        self.timer = PhaseTimer(self.device.type == "cuda")
        self.hook = make_fsdp_hook(
            mesh, par.aggregation, par.agg_num_iters, self.byzantine,
            block_dims_tree(template["blocks"], self.k_agents),
            par.use_kernel, self.timer)
        self.traffic: dict = {}

    def phase_ms(self) -> dict:
        return self.timer.phase_ms()

    def _rest_axis(self):
        """What the rest's ``robust_all_reduce`` reduces over: the pair of
        axes for ``hier_mm`` (which needs two), else every agent."""
        axes = agent_axes(self.mesh)
        if self.par.aggregation == "hier_mm":
            pair = tuple(self.mesh.axis(a) for a in axes)
            return pair if len(pair) > 1 else pair[0]
        return self.mesh.agents

    def _aggregate_rest(self, g: torch.Tensor) -> torch.Tensor:
        byz = self.byzantine
        if byz is not None:
            ax = self.mesh.agents
            g = attacks_lib.apply_local(
                g, ax.index >= ax.size - byz.num_malicious, byz.attack,
                dict(byz.attack_kwargs))
        return sharded_lib.robust_all_reduce(
            g, self._rest_axis(), method=self.par.aggregation,
            aggregator="mm_pallas" if self.par.use_kernel else "mm_tukey",
            num_iters=self.par.agg_num_iters)

    def __call__(self, params, opt_state, batch):
        self.timer.reset()
        self.hook.traffic = {"gather": 0, "scatter": 0}
        tree = M.param_tree(params)
        leaves, treedef = pytree.flatten(tree)
        for leaf in leaves:
            if not leaf.requires_grad:
                leaf.requires_grad_(True)
        rows = batch["tokens"].shape[0]
        nm = min(self.par.microbatches, rows)
        if rows % nm:
            raise ValueError(f"{rows} local rows do not split into {nm} "
                             "microbatches")
        per = rows // nm
        gsum, losses = None, []
        with self.timer.phase("forward_backward"):
            for j in range(nm):
                mb = {name: t[j * per:(j + 1) * per]
                      for name, t in batch.items()}
                with torch.enable_grad():
                    loss = M.loss_fn(tree, self.model_cfg, mb,
                                     layer_hook=self.hook,
                                     remat=self.par.remat)
                    g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
                losses.append(loss.detach())
                with torch.no_grad():
                    if gsum is None:
                        gsum = [x.float() for x in g]
                    else:
                        for acc, x in zip(gsum, g):
                            acc.add_(x)
                del g
        with torch.no_grad():
            grads = [x.div_(nm) for x in gsum]
            del gsum
            sent = _sent()
            with self.timer.phase("aggregate_rest"):
                for i, (root, d) in enumerate(zip(self.roots, self.dims)):
                    if root not in SCAN_DIMS or d < 0:
                        grads[i] = self._aggregate_rest(grads[i])
            self.traffic = dict(self.hook.traffic, rest=_sent() - sent)
            grads_tree = pytree.unflatten(treedef, grads)
            with self.timer.phase("update"):
                _, new_opt = optimizers.update(self.opt_cfg, tree, grads_tree,
                                               opt_state)
            loss = sharded_lib.mean_all_reduce(
                torch.mean(torch.stack(losses)), self.mesh.agents)
            metrics = {"loss": loss,
                       "grad_norm": optimizers.global_norm(grads_tree)}
        return params, new_opt, metrics


def make_train_step_fsdp(
        model_cfg: ModelConfig, par: ParallelConfig,
        opt_cfg: optimizers.OptimizerConfig, mesh: AgentMesh,
        byzantine: Optional[attacks_lib.ByzantineConfig] = None,
        device="cuda") -> FsdpTrainStep:
    """The Mode B train step (dense/moe/vlm) on this rank of ``mesh``."""
    return FsdpTrainStep(model_cfg, par, opt_cfg, mesh, byzantine, device)


# ===========================================================================
# serve steps
# ===========================================================================
# With ``fsdp=True`` the weights stay sharded as in training and each
# layer is gathered as it runs (forward only): a whole-model gather up
# front would hold every layer at once.  Each rank serves its own rows of
# the batch and of the cache (``local_rows``).

def make_serve_hook(mesh: AgentMesh, dims_tree) -> FsdpHook:
    """The bf16 per-layer gather without a robust backward."""
    return FsdpHook(mesh, dims_tree, robust=False)


def _serve_hook(model_cfg: ModelConfig, mesh: Optional[AgentMesh]):
    if mesh is None:
        raise ValueError("fsdp serving needs the agent mesh")
    template = param_template(model_cfg)
    return make_serve_hook(mesh, block_dims_tree(template["blocks"],
                                                 num_agents(mesh)))


def make_prefill_step(model_cfg: ModelConfig, device="cuda", *,
                      fsdp: bool = False, mesh: Optional[AgentMesh] = None):
    """``step(params, batch) -> (B, 1, V)`` last-position logits.  With
    ``fsdp``, ``params`` are this rank's shards and ``batch`` its rows."""
    devices.resolve(device)
    hook = _serve_hook(model_cfg, mesh) if fsdp else M._id_hook

    @torch.no_grad()
    def step(params, batch):
        return M.prefill(params, model_cfg, batch, layer_hook=hook,
                         remat=False)
    return step


def make_decode_step(model_cfg: ModelConfig, device="cuda", *,
                     fsdp: bool = False, mesh: Optional[AgentMesh] = None):
    """``step(params, tokens (B, 1), cache) -> (next tokens (B, 1) int32,
    cache)``: one greedy decode step on the KV cache.  With ``fsdp``,
    ``params`` are this rank's shards, and ``tokens`` and ``cache`` its
    rows."""
    devices.resolve(device)
    hook = _serve_hook(model_cfg, mesh) if fsdp else M._id_hook

    @torch.no_grad()
    def step(params, tokens, cache):
        logits, cache = M.decode_step(params, model_cfg, tokens, cache,
                                      layer_hook=hook)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return step
