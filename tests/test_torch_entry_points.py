"""The port's entry points (``repro_torch.examples``) on the CPU.

Each example's ``main`` runs with ``--device cpu``: quickstart,
federated, the sweep's presets, serve_agg and serve_lm at the
reference's own sizes (seconds here), train_robust_lm at 3 steps.  The
gates are the reference examples' claims: REF's steady MSD under 1e-2
where the attacked mean breaks down, every sweep row finite with a
launch audit on the kernel backend (the two-pass path for the 512-agent
cohort), the service inside its band.  The specs each example builds are
held to the reference example's on the same arguments.
"""

import importlib.util
import json
import pathlib

import pytest

from repro_torch.examples import (federated, quickstart, scenario_sweep,
                                  serve_agg, serve_lm, train_robust_lm)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _reference(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table(out: str, names) -> dict:
    """{row name: its numbers} of a printed table."""
    rows = {}
    for line in out.splitlines():
        for name in names:
            if line.startswith(name + " "):
                rows[name] = [float(v) for v in line[len(name):].split()]
    return rows


def test_quickstart(capsys):
    assert quickstart.BASE == _reference("quickstart").BASE
    assert quickstart.main(["--device", "cpu"]) == 0
    rows = _table(capsys.readouterr().out,
                  ("mean (clean)", "mean (1 attacker)", "REF  (1 attacker)"))
    assert len(rows) == 3
    assert rows["REF  (1 attacker)"][2] < 1e-2
    assert rows["mean (clean)"][2] < 1e-2
    assert rows["mean (1 attacker)"][2] > 1.0          # broke down


def test_federated(capsys):
    assert federated.BASE == _reference("federated").BASE
    assert federated.main(["--device", "cpu"]) == 0
    rows = _table(capsys.readouterr().out, tuple(federated.SETTINGS))
    assert len(rows) == 4
    assert rows["Robust-FedAvg MM (6/32 malicious)"][1] < 1e-2
    assert rows["FedAvg (6/32 malicious)"][1] > 1.0


@pytest.mark.parametrize("argv", [
    ["--smoke"], ["--family", "large_cohort", "--smoke"],
    ["--paradigm", "diffusion", "--attack", "alie", "--agg", "mean",
     "mm_tukey", "--seeds", "0", "1", "--smoke", "--backend", "pallas"],
    ["--paradigm", "substrate", "--smoke", "--model", "paper_lsq"],
    ["--family", "large_cohort"]])
def test_sweep_builds_the_reference_specs(argv):
    ref = _reference("scenario_sweep")
    mine = scenario_sweep.build_specs(scenario_sweep.parser().parse_args(argv))
    theirs = ref.build_specs(_reference_args(argv))
    assert [s.label() for s in mine] == [s.label() for s in theirs]
    assert [s.backend for s in mine] == [s.backend for s in theirs]


def _reference_args(argv):
    """The reference sweep's namespace for ``argv``: its parser lives in
    its main, so parse with the port's (the same flags) minus --device."""
    ns = scenario_sweep.parser().parse_args(argv)
    del ns.device
    return ns


@pytest.mark.parametrize("family", [None, "large_cohort"])
def test_sweep_presets_launch_the_kernels(family, tmp_path, capsys):
    path = tmp_path / "rows.json"
    argv = ["--smoke", "--device", "cpu", "--json", str(path)]
    if family:
        argv += ["--family", family]
    assert scenario_sweep.main(argv) == 0
    out = capsys.readouterr().out
    assert "all metrics finite" in out
    rows = json.loads(path.read_text())["rows"]
    assert len(rows) == (2 if family else 3)
    for row in rows:
        assert row["finite"] and row["device"] == "cpu"
        assert row["backend"] == "pallas" and row["launch_audit"]
    paths = [r["launch_audit"]["path"] for r in rows]
    if family:
        assert rows[0]["num_agents"] == 1024 and paths[0] == "two_pass"
        assert rows[0]["launch_audit"]["k_pad"] >= 512
    else:
        assert paths == ["single"] * 3


@pytest.mark.parametrize("profile,extra", [
    ("clean", []), ("mixed", []), ("clean", ["--crash-at", "0.5"])])
def test_serve_agg(profile, extra, capsys):
    argv = ["--profile", profile, "--backend", "pallas", "--device",
            "cpu"] + extra
    assert serve_agg.main(argv) == 0
    out = capsys.readouterr().out
    assert "rounds committed : 30/30" in out
    assert "broke_down=False" in out
    if extra:
        assert "crash restarts   : 1 journal restore(s), 0 duplicate" in out


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b"])
def test_serve_lm(arch, capsys):
    assert serve_lm.main(["--arch", arch, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    assert "batch=4 prompt=16 generated=32" in out


def test_train_robust_lm(capsys):
    assert train_robust_lm.main(["--steps", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    summary = {}
    for line in out.splitlines():
        for name in ("mean clean", "mean attacked", "REF attacked"):
            if line.startswith(name + " ") and "first-10" in line:
                summary[name] = float(line.rsplit(" ", 1)[1])
    assert len(summary) == 3
    # the attacked mean stalls; REF tracks the clean run
    assert summary["REF attacked"] < summary["mean attacked"]
    assert abs(summary["REF attacked"] - summary["mean clean"]) < 0.1
    assert out.count("agents=8 agg=") == 3       # 8 simulated agents a run


def test_paper_fig1(tmp_path, capsys):
    from repro_torch.examples import paper_fig1
    rc = paper_fig1.main(["--iters", "20", "--device", "cpu",
                          "--out-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["setting", "steady", "MSD"]
    claims = [ln for ln in lines if ln.startswith("fig1/claim")]
    assert len(claims) == 3 and all(ln.split()[-1] in ("PASS", "FAIL")
                                    for ln in claims)
    assert len(lines) == 1 + 30 + 3 + 3 + 1
    assert lines[-1].startswith("C3 clean REF/mean steady MSD, seeds "
                                "(0, 1, 2, 3): ")
    assert (tmp_path / "fig1_left.csv").read_text().startswith("mean_d0,")
    assert rc == (1 if any(ln.endswith("FAIL") for ln in claims) else 0)
