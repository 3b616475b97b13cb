"""Training entry point (``repro.launch.train``) on one card.

  python -m repro_torch.launch.train --arch qwen3-0.6b --full-config \\
      --agents 8 --use-kernel --malicious 1 --steps 3 --batch 8 --seq 1024

Uses the reduced smoke config by default; ``--full-config`` loads the
full architecture.  Simulates the paper's Byzantine agents: ``--agents
K`` agents share the card, each with its own shard of the batch, and
the last ``--malicious`` of them corrupt their gradients before the
robust aggregation.  ``--device cpu`` runs the plain PyTorch versions
of every kernel on the CPU.

``--scenario`` drives the same run through the scenario subsystem
instead of the local loop: the arguments are lowered to a
``ScenarioSpec(paradigm="substrate", ...)`` and executed by
``scenarios.run``, with the lowering and one warm-up step (the kernels'
build and first launch) and the steady run timed apart.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs, devices
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import attacks
from repro_torch.data import synthetic
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.optim import optimizers


def build(args, consensus_metric: bool = False):
    """(model config, parallel config, optimizer config, train step)."""
    if args.model_parallel != 1:
        raise SystemExit("--model-parallel shards the reference's mesh; the "
                         "port's Mode A runs on one card")
    if args.full_config:
        model = configs.load_arch(args.arch).model
    else:
        model = configs.load_smoke(args.arch)
    if args.layers:
        model = dataclasses.replace(model, num_layers=args.layers)
    if args.d_model:
        # keep head structure consistent when scaling width
        scale = args.d_model // model.d_model
        model = dataclasses.replace(
            model, d_model=args.d_model, d_ff=model.d_ff * max(scale, 1))
    par = configs.ParallelConfig(
        fsdp=False, microbatches=args.microbatches,
        aggregation=args.aggregation, use_kernel=args.use_kernel)
    opt_cfg = optimizers.OptimizerConfig(
        learning_rate=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
        total_steps=args.steps)
    byz = None
    if args.malicious:
        byz = attacks.ByzantineConfig(
            num_malicious=args.malicious, attack=args.attack,
            attack_kwargs=_attack_kwargs(args))
    step = steps.make_train_step_gspmd(model, par, opt_cfg, args.device, byz,
                                       k_agents=args.agents or None,
                                       consensus_metric=consensus_metric)
    return model, par, opt_cfg, step


def _attack_kwargs(args) -> tuple:
    # --delta only parameterizes the additive attack; every other
    # registry attack has its own kwargs (or none) and would reject it
    return (("delta", args.delta),) if args.attack == "additive" else ()


def run_scenario(args) -> list:
    """Lower the run to a substrate ScenarioSpec and execute it through
    scenarios.run."""
    from repro_torch import scenarios  # deferred: keep the direct path light

    if args.full_config:
        raise SystemExit(
            "--scenario runs the reduced smoke config (the substrate "
            "adapter builds configs.load_smoke); drop --full-config")
    k = args.agents or 1
    per_agent = max(1, args.batch // k)
    spec = scenarios.ScenarioSpec(
        paradigm="substrate", model_config=args.arch,
        aggregator="mean" if args.aggregation == "mean" else "mm_tukey",
        backend="pallas" if args.use_kernel else "jnp",
        attack=args.attack, num_malicious=args.malicious,
        attack_kwargs=_attack_kwargs(args) if args.malicious else (),
        num_agents=k, num_steps=args.steps, step_size=args.lr,
        paradigm_kwargs=(
            ("batch_per_agent", per_agent), ("seq_len", args.seq),
            ("microbatches", args.microbatches),
            ("aggregation", args.aggregation
             if args.aggregation != "mean" else "rs_mm"),
            ("num_layers", args.layers), ("d_model", args.d_model),
            ("model_parallel", args.model_parallel),
        ))
    print(f"# scenario {spec.label()}")
    res = scenarios.run(spec, device=args.device)
    losses = [float(x) for x in res.history["loss"]]
    for i in range(0, args.steps, max(1, args.log_every)):
        print(f"step {i:5d} loss {losses[i]:.4f} "
              f"consensus {float(res.history['consensus'][i]):.3f}")
    print(f"# compile {res.compile_s:.2f}s  steady wall "
          f"{res.wall_clock_s:.2f}s  broke_down={res.summary['broke_down']}")
    if res.launch_audit:
        n = res.launch_audit.get("n_layouts", 1)
        print(f"# launch audit: {n} aggregated leaf layout(s)")
    print(f"# first-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean {np.mean(losses[-10:]):.4f}")
    return losses


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--aggregation", default="rs_mm",
                    choices=["mean", "gather_mm", "rs_mm"])
    ap.add_argument("--use-kernel", action="store_true",
                    help="the Hopper MM kernel inside the aggregation")
    ap.add_argument("--agents", type=int, default=0,
                    help="simulate K aggregation agents on the card "
                         "(default 1)")
    ap.add_argument("--malicious", type=int, default=0)
    ap.add_argument("--attack", default="additive")
    ap.add_argument("--delta", type=float, default=1000.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--scenario", action="store_true",
                    help="run through scenarios.run as a substrate "
                         "ScenarioSpec instead of the local loop")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    if args.scenario:
        return run_scenario(args)

    dev = devices.resolve(args.device)
    model, par, opt_cfg, step = build(args)
    k = args.agents or 1
    batch = args.batch
    if batch % k:
        batch = k * max(1, batch // k)
        print(f"# rounding batch to {batch} (divisible by {k} agents)")

    params = M.init_model(model, seed=args.seed, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    opt = optimizers.init(opt_cfg, params.tree())
    stream = synthetic.token_batches(synthetic.TokenStreamConfig(
        vocab_size=model.vocab_size, seq_len=args.seq, batch_size=batch,
        seed=args.seed))

    print(f"# arch={model.name} params={n_params/1e6:.1f}M agents={k} "
          f"agg={par.aggregation} malicious={args.malicious} device={dev}")
    frames_gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        hb = next(stream)
        tb = {"tokens": torch.from_numpy(hb["tokens"]).to(dev)}
        if model.arch_type == "vlm":
            tb["prefix"] = torch.zeros(
                (batch, model.num_prefix_tokens, model.d_model),
                dtype=M.act_dtype(model), device=dev)
        if model.arch_type == "audio":
            tb["frames"] = synthetic.make_frames(
                frames_gen, batch, model.num_prefix_tokens, model.d_model,
                M.act_dtype(model), dev)
        params, opt, metrics = step(params, opt, tb)
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = (time.time() - t0) / (i + 1)
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{dt*1e3:.0f} ms/step", flush=True)
    if args.checkpoint:
        ckpt.save(args.checkpoint, params.tree(), step=args.steps)
        print(f"# saved {args.checkpoint}")
    print(f"# first-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean {np.mean(losses[-10:]):.4f}")
    return losses


if __name__ == "__main__":
    main()
