"""Tiny cells for the CPU tests: the benchmark's cells at the size each
kind's ``tiny`` gives (the port's smoke configurations, a few thousand
coordinates a payload)."""

from __future__ import annotations

import copy

from harness import common


def cell(name: str, root=common.ROOT) -> dict:
    return shrink(copy.deepcopy(common.cell(common.benchmark(root), name,
                                            root)))


def from_files(config: str, traffic: str, limits: dict) -> dict:
    """A cell that BENCHMARK.json does not list, from its data files."""
    pb = common.ROOT / "perfbench"
    return shrink({"name": f"{config}.{traffic}", "chips": 1,
                   "root": common.ROOT,
                   "config": common.load_json(pb / "configs" / f"{config}.json"),
                   "traffic": common.load_json(pb / "traffic" / f"{traffic}.json"),
                   "limits": {"compared": limits},
                   "end_to_end": [], "per_layer": []})


def shrink(c: dict) -> dict:
    return common.kind(c).tiny(c)
