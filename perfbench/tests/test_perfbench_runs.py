"""Whole runs of the tiny cells on the CPU, past the harness's look for a
card: a sound run is ``correct``; a run with the timed path broken
underneath, or the control in the program's place, is not."""

import pytest
import torch

import cells_tiny
from harness import common, main

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242
BENCH = common.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SERVE = [n for n in CELLS if common.cell(BENCH, n)["traffic"]["kind"] == "serve"]
# the train traffic's pairs that have no cell yet (PERF.md, Open questions):
# Qwen3-0.6B under its limits, RWKV6 held to the port in float32
TRAIN = {
    "qwen3-0.6b.train-k8": ("qwen3-0.6b", "train-k8", common.load_json(
        common.ROOT / "perfbench" / "limits" / "qwen3-0.6b.train-k8.json"
    )["compared"]),
    "rwkv6-1.6b.train-k4": ("rwkv6-1.6b", "train-k4", {
        "loss_gap": {"limit": 1e-5}, "grad_gap": {"limit": 1e-4},
        "change_gap": {"limit": 1e-4}}),
}


def _tiny(name: str) -> dict:
    if name in TRAIN:
        return cells_tiny.from_files(*TRAIN[name])
    return cells_tiny.cell(name)


def _run(name: str, seconds: float = 0.2):
    return main.execute(_tiny(name), SEED, seconds, False, CPU, 0.0)


@pytest.mark.parametrize("name", CELLS + sorted(TRAIN))
def test_sound_run_is_correct(name):
    result, compared = _run(name)
    assert result["correct"], compared
    assert result["failed"] == 0 and result["attempted"] > 0


def _patch_launch(monkeypatch, change):
    from repro_torch.serve import service
    orig = service.AggregationService._launch

    def broken(self, rows, a, degraded):
        out, *rest = orig(self, rows, a, degraded)
        return (change(self, rows, a, out), *rest)

    monkeypatch.setattr(service.AggregationService, "_launch", broken)


def _half(svc, rows, a, out):
    from repro_torch.kernels import ops
    k = len(rows) // 2
    return ops.get_engine(num_iters=10, backend=svc.config.backend).aggregate(
        torch.stack([r.reshape(-1) for r in rows[:k]]),
        torch.from_numpy(a[:k]))


def _altered(svc, rows, a, out):
    out = out.clone()
    out[out.shape[0] // 2] += 1.0
    return out


SERVE_FAULTS = {
    "state_unchanged": lambda svc, rows, a, out: svc._w.clone(),
    "half_the_cohort": _half,
    "answer_altered": _altered,
}


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_serve_fault_is_not_correct(monkeypatch, name, fault):
    _patch_launch(monkeypatch, SERVE_FAULTS[fault])
    result, compared = _run(name)
    assert not result["correct"], compared


def _unchanged_update(monkeypatch):
    from repro_torch.optim import optimizers
    monkeypatch.setattr(optimizers, "update", lambda cfg, params, grads, st:
                        (params, type(st)(st.step + 1, st.m, st.v)))


def _half_rows(monkeypatch):
    from repro_torch.models import model
    orig = model.loss_fn

    def half(params, cfg, batch, **kw):
        t = batch["tokens"]
        return orig(params, cfg, dict(batch, tokens=t[:, :t.shape[1] // 2 + 1]),
                    **kw)

    monkeypatch.setattr(model, "loss_fn", half)


@pytest.mark.parametrize("name", sorted(TRAIN))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_rows"])
def test_train_fault_is_not_correct(monkeypatch, name, fault):
    {"state_unchanged": _unchanged_update,
     "half_the_rows": _half_rows}[fault](monkeypatch)
    result, compared = _run(name)
    assert not result["correct"], compared


@pytest.mark.parametrize("name", SERVE + ["qwen3-0.6b.train-k8"])
def test_control_is_not_correct(name):
    """The reference one precision below the configuration's, in the
    program's place, against the reference: fp8 matmul operands for the
    train cells, a bfloat16 estimator for the serve cells."""
    c = _tiny(name)
    r = common.kind(c).Run(c, SEED, CPU, False)
    r.setup()
    r.window(0.05)
    r.free_program()
    correct, compared = common.compare(r.controls()["control"], c["limits"])
    assert not correct, compared
