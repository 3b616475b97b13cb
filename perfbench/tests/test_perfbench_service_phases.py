"""The readers of the service's admission, take and guard phases
(``admit_ms.serve``, ``take_ms.serve``, ``guard_ms.serve``): the median
of ``phase_ms()`` over the commits after the profiled ones, and nothing
where there is nothing to read."""

import pytest

from harness import common

READERS = {"admit_ms.serve": "admit", "take_ms.serve": "take",
           "guard_ms.serve": "guard"}


def _serve(phase_ms, traced):
    return {"kind": "serve",
            "records": {"traced_commits": traced, "phase_ms": phase_ms}}


@pytest.mark.parametrize("name", sorted(READERS))
def test_median_skips_the_profiled_commits(name):
    read = common.metric_reader(name)
    phase = READERS[name]
    ms = [{phase: 1000.0}, {phase: 900.0}] + [
        {phase: v, "outliers": 5.0} for v in (3.0, 1.0, 2.0)]
    assert read(_serve(ms, 2)) == 2.0
    assert read(_serve(ms, 0)) == 3.0


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_to_read_gives_none(name):
    read = common.metric_reader(name)
    # a program without the phase (the parent of the phase's metric)
    assert read(_serve([{"outliers": 5.0, "stage": 1.0}] * 3, 1)) is None
    assert read(_serve([{READERS[name]: 1.0}], 1)) is None   # all profiled
    assert read(_serve([], 0)) is None
    train = {"kind": "train", "records": {"phase_ms": [
        ({READERS[name]: 1.0}, False)]}}
    assert read(train) is None


def test_each_reader_has_its_benchmark_entry():
    bench = common.benchmark()
    cells = [w["name"] for w in bench["workloads"]
             if common.cell(bench, w["name"])["traffic"]["kind"] == "serve"]
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert (m["source"], m["layer"], m["moves"], m["unit"]) == (
            "program_span", "service", "commits_per_s", "ms")
        assert m["workloads"] == cells
