"""BENCHMARK.json against its schema, and every cell's files
found by name."""

import ast
import json
import pathlib
import re
import shutil

import pytest

from harness import common

ROOT = common.ROOT
BENCH = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    c = common.cell(BENCH, name)
    assert c["traffic"]["kind"] in ("train", "serve")
    assert set(c["limits"]["compared"])
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"}
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]
    for m in c["per_layer"]:
        assert callable(common.metric_reader(m["name"]))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cuts(conf):
    data = common.load_json(ROOT / conf["file"])
    assert data["name"] == conf["name"]
    assert data["reduced"] == conf["reduced"]
    assert all(k in data for k in conf["reduced"])
    assert not any(k.endswith(("_dim", "_rank", "_size")) or k in (
        "hidden_size", "intermediate_size") for k in conf["reduced"])


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    (ROOT / "perfbench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"repro_torch", "repro", "jax", "jaxlib",
                                 "flax"}


@pytest.mark.parametrize("path", sorted(
    p for p in (ROOT / "perfbench").rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"repro", "jax", "jaxlib", "flax"}


def test_guard_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("x"))
    assert "repro_torch_like" not in common.foreign_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("y"))
    assert common.foreign_modules() == ["repro.core"]


def _copy(tmp_path) -> tuple:
    """(perfbench in a copy, BENCHMARK.json's data, the copy's files and
    their bytes)."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    return (tmp_path / "perfbench",
            json.loads((ROOT / "BENCHMARK.json").read_text()), before)


def _add(tmp_path, bench: dict, files: dict, config: dict, cell: dict,
         metrics=()):
    """Write the new files, and the new entries into the copy's
    BENCHMARK.json; the new cell as a run takes it."""
    for rel, text in files.items():
        (tmp_path / "perfbench" / rel).write_text(text)
    bench["configs"].append(dict(config, source="test", reduced=[],
                                 why="test"))
    bench["workloads"].append(dict(cell, chips=1, why="test"))
    bench["end_to_end"].extend(metrics)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return common.cell(common.benchmark(tmp_path), cell["name"], tmp_path)


def _unchanged(before: dict) -> None:
    for p, data in before.items():
        assert p.read_bytes() == data, p


def _execute(c: dict):
    import torch
    from harness import main
    return main.execute(c, 2 ** 31 + 77, 0.2, False, torch.device("cpu"),
                        0.0)


def test_new_cell_taken_up_from_files_alone(tmp_path):
    """A serve cell added as new files and a new entry runs in a copy of
    the benchmark with no edit to any file there."""
    pb, bench, before = _copy(tmp_path)
    traffic = dict(common.load_json(pb / "traffic" / "serve-k8.json"),
                   clients=32, byzantine=4, k_min=6, honest_rows=6,
                   check_commit_below=4, check_columns=500)
    conf = dict(common.load_json(pb / "configs" / "qwen3-0.6b.json"),
                name="tiny-coords", payload="coordinates", parameters=2000)
    limits = common.load_json(pb / "limits" / "qwen3-0.6b.serve-k8.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "qwen3-0.6b.serve-k8" in m.get("workloads", ()):
            m["workloads"].append("tiny.serve-k6")
    c = _add(tmp_path, bench, {
        "traffic/serve-k6-small.json": json.dumps(traffic),
        "configs/tiny-coords.json": json.dumps(conf),
        "limits/tiny.serve-k6.json": json.dumps(limits)},
        {"name": "tiny-coords", "file": "perfbench/configs/tiny-coords.json"},
        {"name": "tiny.serve-k6", "config": "tiny-coords",
         "traffic": "serve-k6-small"})
    result, compared = _execute(c)
    assert result["correct"], compared
    assert set(result["metrics"]) == {"commits_per_s", "commit_ms_p95",
                                      "setup_s"}
    _unchanged(before)


def test_new_family_taken_up_from_files_alone(tmp_path):
    """A model family of its own (``families/<family>.py``, here a copy
    of Qwen3's under another name) and a train cell of it, as new files
    and entries, run with no edit to any file there."""
    pb, bench, before = _copy(tmp_path)
    conf = dict(common.load_json(pb / "configs" / "qwen3-0.6b.json"),
                name="dense-copy", family="dense_copy")
    limits = common.load_json(pb / "limits" / "qwen3-0.6b.train-k8.json")
    bench["end_to_end"].append({
        "name": "train_tokens_per_s", "unit": "tokens/s", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["dense-copy.train-k8"]})
    c = _add(tmp_path, bench, {
        "families/dense_copy.py": (pb / "families" / "qwen3.py").read_text(),
        "configs/dense-copy.json": json.dumps(conf),
        "limits/dense-copy.train-k8.json": json.dumps(limits)},
        {"name": "dense-copy", "file": "perfbench/configs/dense-copy.json"},
        {"name": "dense-copy.train-k8", "config": "dense-copy",
         "traffic": "train-k8"})
    c = common.kind(c).tiny(c)
    assert common.family(c).__file__ == str(
        (pb / "families" / "dense_copy.py").resolve())
    result, compared = _execute(c)
    assert result["correct"], compared
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    _unchanged(before)


KIND = '''"""A kind of traffic for the test: the program's MM estimate of one
(K, M) stack again and again; correct against the plain reference's."""

import time

import torch

from reference import mm


class Run:
    def __init__(self, cell, seed, device, traced):
        self.tr, self.seed, self.device = cell["traffic"], seed, device
        self.records, self.setup_parts = {"trace": {}}, {}

    def setup(self):
        from repro_torch.kernels import ops
        gen = torch.Generator().manual_seed(self.seed)
        self.x = torch.randn(self.tr["k"], self.tr["m"], generator=gen)
        self.x[-1] += self.tr["delta"]
        self.engine = ops.get_engine(num_iters=10)

    def window(self, seconds):
        t0, n = time.perf_counter(), 0
        while n == 0 or time.perf_counter() - t0 < seconds:
            self.est = self.engine.aggregate(self.x)
            n += 1
        return {"estimates_per_s": n / (time.perf_counter() - t0),
                "estimates": n}

    def attempted_failed(self, window):
        return window["estimates"], 0

    def layer_record(self):
        return {}

    def free_program(self):
        del self.engine

    def readings(self):
        ref = mm.estimate(self.x)
        return {"gap": float((self.est.reshape(-1) - ref).abs().max())}

    def controls(self):
        return {}


def tiny(cell):
    return cell
'''


def test_new_kind_taken_up_from_files_alone(tmp_path):
    """A kind of traffic of its own (``kinds/<kind>.py``), its mix, cell,
    limits and end-to-end metric, as new files and entries, run with no
    edit to any file there."""
    pb, bench, before = _copy(tmp_path)
    c = _add(tmp_path, bench, {
        "kinds/estimate.py": KIND,
        "traffic/estimate-k8.json": json.dumps(
            {"kind": "estimate", "k": 8, "m": 256, "delta": 1000.0}),
        "configs/stack.json": json.dumps({"name": "stack"}),
        "limits/stack.estimate-k8.json": json.dumps(
            {"compared": {"gap": {"limit": 1e-5}}})},
        {"name": "stack", "file": "perfbench/configs/stack.json"},
        {"name": "stack.estimate-k8", "config": "stack",
         "traffic": "estimate-k8"},
        [{"name": "estimates_per_s", "unit": "1/s", "better": "higher",
          "bound": 0.05, "source": "host_clock",
          "workloads": ["stack.estimate-k8"]}])
    result, compared = _execute(c)
    assert result["correct"], compared
    assert result["attempted"] > 0
    assert set(result["metrics"]) == {"estimates_per_s", "setup_s"}
    _unchanged(before)
