"""The ``train`` kind of traffic: Mode A robust training, the step that
``launch.train.build`` builds from the traffic's ``train_args``.  A mix
(``traffic/<mix>.json``) gives ``agents``, ``rows_per_agent``,
``seq_len``, ``malicious``, ``delta``, ``train_args``, ``optimizer``,
``setup_steps``, ``reference_steps`` and ``token_batches``; the
configuration's family (``families/<family>.py``) gives the weights'
initialisation, the reference's loss and the model FLOPs.

Set-up makes the weights (``harness.weights``) and ``token_batches``
batches of K x ``rows_per_agent`` sequences of ``seq_len`` + 1 token ids
on the device from the seed, builds the step, its model and its Adam
state, and drives that one object through ``setup_steps`` steps on
batches 0, 1, ...: the first warms every kernel up, and these steps are
the ones the reference follows.  The window then drives the same object
on the batches after them, one step after another, and finishes the step
that is running when its time is up.

What ``correct`` reads, against ``reference.train.follow`` from the same
weights and batches in float32 (each number the widest gap of the
program's and the reference's, over the reference's value or the median
leaf's, whichever is larger):
  loss_gap    each set-up step's mean loss
  grad_gap    each leaf's norm of the first step's clipped aggregate, as
              the program's Adam state holds it after that step
              (m = (1 - beta1) g)
  change_gap  each leaf's norm of the parameters' change over the set-up
              steps (the program's taken to the host before the window
              moves them); leaves whose first reference gradient is under
              a thousandth of the median leaf's are left out
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from harness import common, portcfg, trace, weights
from reference import lowp
from reference import train as ref_train

NEGLIGIBLE_GRAD = 1e-3


class Run:
    def __init__(self, cell: dict, seed: int, device, traced: bool):
        self.traffic, self.conf = cell["traffic"], cell["config"]
        self.seed, self.device, self.traced = int(seed), device, traced
        self.fam = common.family(cell)
        self.cfg = portcfg.model_config(self.conf, self.fam)
        self.shapes = portcfg.leaf_shapes(self.cfg)
        tr = self.traffic
        self.rows = tr["agents"] * tr["rows_per_agent"]
        self.records = {"step_s": [], "phase_ms": [], "trace": {}}
        self.setup_parts = {}

    def batches(self) -> torch.Tensor:
        tr = self.traffic
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        return torch.randint(0, self.conf["vocab_size"],
                             (tr["token_batches"], self.rows,
                              tr["seq_len"] + 1),
                             generator=gen, device=self.device)

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch import pytree
        from repro_torch.launch import train
        from repro_torch.models import model as M
        from repro_torch.optim import optimizers
        tr = self.traffic
        t0 = time.perf_counter()
        args = train.parser().parse_args(
            ["--arch", self.conf["port_config"], *tr["train_args"],
             "--device", str(self.device.type)])
        cfg, par, opt_cfg, step = train.build(args)
        if cfg != self.cfg:
            raise RuntimeError(f"launch.train built {cfg}, the configuration "
                               f"states {self.cfg}")
        for key, value in tr["optimizer"].items():
            if getattr(opt_cfg, key) != value:
                raise RuntimeError(f"launch.train set {key} = "
                                   f"{getattr(opt_cfg, key)!r}, the traffic "
                                   f"states {value!r}")
        self.opt_cfg, self.step = opt_cfg, step
        flat = self._weights()
        self.model = M.Model(cfg, weights.nest(flat))
        del flat
        self.opt = optimizers.init(opt_cfg, self.model.tree())
        self.tokens = self.batches()
        _sync(self.device)
        self.setup_parts["build"] = time.perf_counter() - t0
        self.losses, self.first_norms = [], None
        for t in range(tr["setup_steps"]):
            t0 = time.perf_counter()
            _, self.opt, metrics = step(self.model, self.opt,
                                        {"tokens": self.tokens[t]})
            self.losses.append(float(metrics["loss"]))
            self.setup_parts[f"step{t}"] = time.perf_counter() - t0
            if t == 0:
                m = pytree.flatten(self.opt.m)[0]
                self.first_norms = {
                    n: float(torch.linalg.vector_norm(x.double()))
                    / (1.0 - opt_cfg.beta1) for n, x in zip(self.shapes, m)}
        t0 = time.perf_counter()
        self.after = {n: p.detach().to("cpu", copy=True) for n, p in zip(
            self.shapes, pytree.flatten(self.model.tree())[0])}
        _sync(self.device)
        self.setup_parts["keep_params"] = time.perf_counter() - t0

    def _weights(self) -> dict:
        return weights.make(self.shapes, self.seed, self.device,
                            self.fam.init_rule)

    # -- the window --------------------------------------------------------

    def window(self, seconds: float) -> dict:
        tr = self.traffic
        n0, nb = tr["setup_steps"], tr["token_batches"]
        t_start = time.perf_counter()
        i, failed = 0, 0
        while i == 0 or time.perf_counter() - t_start < seconds:
            batch = {"tokens": self.tokens[(n0 + i) % nb]}
            profiled = self.traced and i == 0
            t0 = time.perf_counter()
            if profiled:
                with trace.traced(self.records["trace"]):
                    with trace.span("step", True):
                        loss = self._step(batch)
            else:
                loss = self._step(batch)
            t1 = time.perf_counter()
            failed += not torch.isfinite(torch.tensor(loss))
            self.records["step_s"].append((t1 - t0, profiled))
            self.records["phase_ms"].append((self.step.phase_ms(), profiled))
            i += 1
        t_end = time.perf_counter()
        tokens = i * self.rows * tr["seq_len"]
        for (s, profiled), (ph, _) in zip(self.records["step_s"],
                                          self.records["phase_ms"]):
            print(f"perfbench: step {s!r} s" + " traced" * profiled + "".join(
                f" {k}={v!r}ms" for k, v in ph.items()), file=sys.stderr)
        return {"train_tokens_per_s": tokens / (t_end - t_start),
                "steps": i, "failed": int(failed),
                "window_s": t_end - t_start}

    def attempted_failed(self, window: dict) -> tuple:
        """The window's steps, and those whose loss was not finite."""
        return window["steps"], window["failed"]

    def layer_record(self) -> dict:
        """The model FLOPs of a step and the frozen bound of its MM
        launches (one unweighted launch a leaf, K rows)."""
        from counts import mm_ops
        tr = self.traffic
        k = tr["agents"]
        return {
            "flops_per_step": self.fam.train_flops_per_token(
                self.conf, tr["seq_len"]) * self.rows * tr["seq_len"],
            "mm_bound_s": sum(mm_ops.bound_s(k, _numel(s), 1, False)[0]
                              for s in self.shapes.values())}

    def _step(self, batch) -> float:
        _, self.opt, metrics = self.step(self.model, self.opt, batch)
        loss = float(metrics["loss"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return loss

    def free_program(self) -> None:
        del self.step, self.model, self.opt
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self) -> dict:
        """The numbers ``correct`` compares: the program's set-up steps
        against the reference's."""
        return gaps(self.program_side(), self.reference())

    def controls(self) -> dict:
        """The control (the reference with float8 matmul operands, one
        precision below the configuration's bfloat16, in the program's
        place) and the planted fault (each agent's loss over half its
        tokens), each against the reference."""
        ref = self.reference()
        return {"control": gaps(self.reference(q=lowp.fp8), ref),
                "fault_half_rows": gaps(self.reference(half_rows=True), ref)}

    # -- the check ---------------------------------------------------------

    def reference(self, q=lowp.identity, half_rows: bool = False) -> dict:
        """The reference's set-up steps from the same weights and batches:
        losses, first-gradient norms and change norms by leaf."""
        tr = self.traffic
        params = self._weights()
        out = ref_train.follow(
            params, self.tokens,
            lambda p, rows, qq: self.fam.loss(p, rows, self.conf, qq),
            tr["optimizer"], {"num_malicious": tr["malicious"],
                              "delta": tr["delta"]},
            tr["agents"], tr["reference_steps"], q=q, half_rows=half_rows)
        start = self._weights()
        out["change_norms"] = {n: float(torch.linalg.vector_norm(
            (params[n] - start[n]).double())) for n in params}
        return out

    def program_side(self) -> dict:
        start = self._weights()
        change = {n: float(torch.linalg.vector_norm(
            (self.after[n].to(self.device) - start[n]).double()))
            for n in start}
        return {"losses": self.losses, "first_grad_norms": self.first_norms,
                "change_norms": change}


def _leaf_gap(side: dict, ref: dict, leaves) -> float:
    med = statistics.median(ref[n] for n in leaves)
    return max(abs(side[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in leaves)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gaps(side: dict, ref: dict) -> dict:
    """The numbers ``correct`` compares, of ``side`` against ``ref``."""
    steps = len(ref["losses"])
    grads = ref["first_grad_norms"]
    med = statistics.median(grads.values())
    moving = [n for n in grads if grads[n] >= NEGLIGIBLE_GRAD * med]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(
            side["losses"][:steps], ref["losses"])),
        "grad_gap": _leaf_gap(side["first_grad_norms"], grads, list(grads)),
        "change_gap": _leaf_gap(side["change_norms"], ref["change_norms"],
                                moving),
    }


def tiny(cell: dict) -> dict:
    """The cell at a size a CPU test holds: the port's smoke variant of
    the configuration, at its sizes, over 32-token sequences."""
    from repro_torch import configs
    conf = dict(cell["config"], port_variant="smoke")
    sm = configs.load_smoke(conf["port_config"])
    fam = common.family(cell)
    conf.update({key: getattr(sm, field) for key, field in fam.FIELDS.items()})
    conf["num_hidden_layers"] = sm.num_layers
    cell["config"] = conf
    tr = cell["traffic"]
    args = [a for a in tr["train_args"] if a != "--full-config"]
    args[args.index("--seq") + 1] = "32"
    tr.update(train_args=args, seq_len=32)
    return cell


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
