"""The ``substrate`` paradigm (``repro.scenarios.substrate``): a
ScenarioSpec drives the real training stack -- the Mode A train step of
``launch.steps`` -- instead of the analytic linear loop.

``ScenarioSpec(paradigm="substrate", model_config=...)`` builds the
model and optimizer from ``configs/`` and runs the *same* train step the
``launch.train`` entry point runs: per-agent batch shards, per-agent
gradients, Byzantine masks and schedules, and the shared aggregation
resolution (``aggregate_stack`` -> ``engine_aggregator`` ->
``kernels.ops``; ``backend='pallas'`` selects the Hopper kernel exactly
like ``ParallelConfig.use_kernel``).

Two substrate models:

  ``model_config="paper_lsq"``
      The paper's Sec. 4 streaming least-squares problem run as a
      trained model (params {"w"}, per-agent sample losses, the LMS
      gradient) through the same stacked-gradient aggregation the train
      steps use.  Plain SGD with a constant schedule reproduces the
      paper's fixed-mu updates.

  ``model_config=<configs arch name>``  (e.g. "qwen3-0.6b")
      The arch's reduced ``smoke_config`` transformer trained on uniform
      token batches: the global batch is split into ``num_agents``
      per-agent shards and every update is one robustly aggregated step
      of ``launch.steps.make_train_step_gspmd`` with
      ``k_agents=spec.num_agents``.

Metric semantics (the uniform history dict):

  loss       -- mean training loss across agents (tokens for the LM,
                squared residuals for paper_lsq); ``finalize`` mirrors it
                into ``msd``, and attack summaries run on training loss
                with a loss-scale breakdown level.
  consensus  -- the benign agents' pre-aggregation gradient disagreement
                (``launch.steps.grad_consensus``).

``paradigm_kwargs`` (all optional, (key, value) tuples):
  batch_per_agent (2)   sequences per agent per step
  seq_len (16)          training sequence length
  microbatches (1)      gradient accumulation inside the step
  aggregation ("rs_mm") stack method for the MM family: rs_mm | gather_mm
  optimizer             "adam" (LM default) | "sgd" (paper_lsq default)
                        | "momentum"
  schedule              "cosine" (LM default) | "constant" (lsq default)
  warmup_steps          LM default min(100, num_steps // 10 + 1)
  grad_clip             LM default 1.0, paper_lsq 0
  num_layers / d_model  LM model-shape overrides (launch.train's
                        --layers / --d-model, applied the same way)
  model_parallel        the reference's mesh model axis; one card has
                        none, so only 1 is accepted
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data import synthetic
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.optim import optimizers
from repro_torch.scenarios import metrics, registry
from repro_torch.scenarios.spec import LSQ_SUBSTRATE, ScenarioSpec

DEFAULT_BATCH_PER_AGENT = 2
DEFAULT_SEQ_LEN = 16


def _pk(spec: ScenarioSpec) -> dict:
    return dict(spec.paradigm_kwargs)


def _opt_config(spec: ScenarioSpec, *, lsq: bool) -> optimizers.OptimizerConfig:
    pk = _pk(spec)
    if lsq:
        # the paper's update: w <- w - mu * aggregate(grads), exactly
        name, sched, warmup, clip = "sgd", "constant", 0, 0.0
    else:
        name, sched = "adam", "cosine"
        warmup = min(100, spec.num_steps // 10 + 1)
        clip = 1.0
    return optimizers.OptimizerConfig(
        name=pk.get("optimizer", name),
        learning_rate=spec.step_size,
        warmup_steps=int(pk.get("warmup_steps", warmup)),
        total_steps=spec.num_steps,
        grad_clip=float(pk.get("grad_clip", clip)),
        schedule_kind=pk.get("schedule", sched),
    )


def _agg_num_iters(spec: ScenarioSpec) -> int:
    return int(dict(spec.agg_kwargs).get("num_iters", 10))


def build_lm_components(spec: ScenarioSpec, device: torch.device):
    """Everything the LM substrate shares with ``launch.train``'s path:
    (model_cfg, par, opt_cfg, byzantine, state0, batch_fn).  Exposed so
    tests drive ``steps.make_train_step_gspmd`` with the identical
    configuration and inputs; ``batch_fn(generator)`` draws a step's
    batch."""
    pk = _pk(spec)
    if int(pk.get("model_parallel", 1)) != 1:
        raise NotImplementedError(
            "model_parallel > 1 shards the reference's mesh model axis; the "
            "port's Mode A runs on one card")
    model_cfg = configs.load_smoke(spec.model_config)
    # model-shape overrides, applied exactly as launch.train's
    # --layers / --d-model flags apply them
    if pk.get("num_layers"):
        model_cfg = dataclasses.replace(model_cfg,
                                        num_layers=int(pk["num_layers"]))
    if pk.get("d_model"):
        d_model = int(pk["d_model"])
        scale = d_model // model_cfg.d_model
        model_cfg = dataclasses.replace(
            model_cfg, d_model=d_model, d_ff=model_cfg.d_ff * max(scale, 1))
    method = "mean" if spec.aggregator == "mean" \
        else pk.get("aggregation", "rs_mm")
    par = configs.ParallelConfig(
        fsdp=False,
        microbatches=int(pk.get("microbatches", 1)),
        aggregation=method,
        use_kernel=(spec.backend == "pallas"),
        agg_num_iters=_agg_num_iters(spec),
    )
    opt_cfg = _opt_config(spec, lsq=False)
    byz = spec.byzantine()
    model = M.init_model(model_cfg, seed=spec.data_seed, device=device)
    state0 = (model, optimizers.init(opt_cfg, model.tree()))

    b = spec.num_agents * int(pk.get("batch_per_agent",
                                     DEFAULT_BATCH_PER_AGENT))
    seq = int(pk.get("seq_len", DEFAULT_SEQ_LEN))

    def batch_fn(generator: torch.Generator) -> dict:
        """One step's batch in launch.train's format."""
        batch = synthetic.make_lm_batch(generator, b, seq,
                                        model_cfg.vocab_size, device)
        if model_cfg.arch_type == "vlm":
            p = min(model_cfg.num_prefix_tokens, seq // 2)
            batch["prefix"] = torch.zeros((b, p, model_cfg.d_model),
                                          dtype=M.act_dtype(model_cfg),
                                          device=device)
        if model_cfg.arch_type == "audio":
            batch["frames"] = synthetic.make_frames(
                generator, b, model_cfg.num_prefix_tokens, model_cfg.d_model,
                M.act_dtype(model_cfg), device)
        return batch

    return model_cfg, par, opt_cfg, byz, state0, batch_fn


def _lm_pieces(spec: ScenarioSpec, device: torch.device) -> Tuple:
    model_cfg, par, opt_cfg, byz, state0, batch_fn = \
        build_lm_components(spec, device)
    step = steps.make_train_step_gspmd(
        model_cfg, par, opt_cfg, device, byz, k_agents=spec.num_agents,
        consensus_metric=True)

    def step_fn(state, generator, i):
        del i  # the byzantine schedule keys off opt_state.step inside
        params, opt_state = state
        params, opt_state, m = step(params, opt_state, batch_fn(generator))
        return (params, opt_state), {"loss": m["loss"],
                                     "consensus": m["consensus"]}

    # a broken-down LM run blows past the uniform-logits plateau ln(V)
    level = 5.0 * float(np.log(model_cfg.padded_vocab))
    return state0, step_fn, level


def _lsq_pieces(spec: ScenarioSpec, device: torch.device) -> Tuple:
    problem = synthetic.LinearModelProblem(
        dim=spec.dim, noise_var=spec.noise_var, seed=spec.data_seed)
    loss_grad = synthetic.make_stacked_loss_grad_fn(
        problem, spec.num_agents, data=spec.data,
        alpha=spec.dirichlet_alpha, seed=spec.data_seed, device=device)
    opt_cfg = _opt_config(spec, lsq=True)
    byz = spec.byzantine()
    k, num_iters = spec.num_agents, _agg_num_iters(spec)
    use_kernel = spec.backend == "pallas"
    mean_agg = spec.aggregator == "mean"
    params0 = {"w": torch.zeros((spec.dim,), dtype=torch.float32,
                                device=device)}
    state0 = (params0, optimizers.init(opt_cfg, params0))

    def step_fn(state, generator, i):
        params, opt_state = state
        w_stack = params["w"].expand(k, spec.dim)
        losses, g = loss_grad(w_stack, generator)
        grads = byz.apply_tree({"w": g}, generator, i)
        benign = ~byz.malicious_mask(k, i, device)
        if mean_agg:
            est = torch.mean(grads["w"].float(), dim=0)
        else:
            # the SAME aggregation resolution the train steps use
            est = steps._mm_axis0(grads["w"].float(), num_iters, use_kernel)
        loss = torch.mean(losses)
        params, opt_state = optimizers.update(opt_cfg, params, {"w": est},
                                              opt_state)
        return (params, opt_state), {
            "loss": loss, "consensus": steps.grad_consensus(grads, benign)}

    # loss ~ 0.5 * msd-projection + sigma_v^2 / 2: the linear breakdown
    # scale shifted by the irreducible noise floor
    level = metrics.breakdown_threshold(spec) + spec.noise_var
    return state0, step_fn, level


def _finalize(history: dict) -> dict:
    """Training loss IS the tracked error signal: mirror it into ``msd``
    so summaries stay uniform across paradigms."""
    history = dict(history)
    history["msd"] = np.array(history["loss"], copy=True)
    return history


def lower(spec: ScenarioSpec, device: torch.device) -> registry.Lowering:
    """The substrate paradigm adapter (imported lazily by the runner, so
    importing ``repro_torch.scenarios`` does not pull the training
    stack)."""
    if spec.model_config == LSQ_SUBSTRATE:
        state0, step_fn, level = _lsq_pieces(spec, device)
    else:
        state0, step_fn, level = _lm_pieces(spec, device)
    return registry.Lowering(state0=state0, step_fn=step_fn,
                             finalize=_finalize, breakdown_level=level)
