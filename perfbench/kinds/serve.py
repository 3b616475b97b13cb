"""The ``serve`` kind of traffic: clients of ``AggregationService`` in a
closed loop.  A mix (``traffic/<mix>.json``) gives ``clients``,
``byzantine``, ``k_min``, ``honest_rows``, ``delta``, ``warmup_commits``,
``check_commit_below`` and ``check_columns``; a payload has the
configuration's ``parameters`` coordinates (a CPU test holds that number
to the port's parameter tree, as the configuration's ``payload`` says).

Set-up makes a pool of payload rows on the device from the seed:
``honest_rows`` rows of N(0, 1) values and one Byzantine row, the first
honest row + ``delta`` on every coordinate (the paper's additive attack).
Of ``clients`` clients, ``byzantine`` (drawn from the seed) send the
Byzantine row; an honest client sends the honest row of its place in the
cohort, so no two honest members of a cohort share a row.  Each round
draws ``k_min`` distinct clients from the seed and submits their updates
one after another; the last one pumps the commit, and the next round
starts when it returns.  A client the health gate refuses (quarantined)
is replaced by another draw: the service's designed behaviour, reported
apart.  ``warmup_commits`` rounds in set-up capture the launch program
and run every branch of a commit once.

What ``correct`` reads (the reference follows the service from its own
state before a commit; see ``reference.serve``):
  * the start: the first set-up commit, from the model of zeros, fresh
    health and no step-norm history, all of it the reference's own;
    compared on ``check_columns`` columns drawn from the seed;
  * one commit of the window drawn from the seed among its first
    ``check_commit_below`` (about the commits a window of the
    benchmark's ``run_seconds`` holds; a shorter window goes on, untimed,
    until that commit), from the program's model, health and EMA before
    it, compared on every column.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time

import numpy as np
import torch

from harness import trace
from reference import serve as ref_serve

REF_BLOCK = 1 << 24


class Run:
    def __init__(self, cell: dict, seed: int, device, traced: bool):
        self.seed, self.device = int(seed), device
        self.traffic, self.conf = cell["traffic"], cell["config"]
        self.traced = traced
        self.m = int(self.conf["parameters"])
        self.setup_parts = {}
        self.rng = np.random.default_rng(self.seed)
        self.records = {"commit_wall_s": [], "phase_ms": [], "trace": {}}
        self.counts = {"submitted": 0, "honest": 0, "honest_refused": 0,
                       "byzantine_refused": 0, "commits": 0}
        self.latencies = []

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.serve import AggregationService, ServeConfig
        from repro_torch.serve.clock import WallClock
        tr = self.traffic
        h, n = tr["honest_rows"], tr["clients"]
        t0 = time.perf_counter()
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.pool = torch.empty((h + 1, self.m), dtype=torch.float32,
                                device=self.device)
        self.pool[:h].normal_(generator=gen)
        torch.add(self.pool[0], tr["delta"], out=self.pool[h])
        self.byz = set(int(c) for c in self.rng.choice(n, tr["byzantine"],
                                                       replace=False))
        self.seq = [0] * n
        self.cols = torch.from_numpy(np.sort(self.rng.choice(
            self.m, min(tr["check_columns"], self.m), replace=False))
        ).to(self.device)
        self.check_at = int(self.rng.integers(tr["check_commit_below"]))
        _sync(self.device)
        t1 = time.perf_counter()
        self.svc = AggregationService(
            torch.zeros((self.m,), device=self.device),
            config=ServeConfig(k_min=tr["k_min"]), clock=WallClock(),
            seed=self.seed, device=self.device)
        _sync(self.device)
        t2 = time.perf_counter()
        first = self.round(record=False)
        t3 = time.perf_counter()
        self.start = {"ids": first["ids"], "rows": first["rows"],
                      "outliers": first["commit"].outliers,
                      "clipped": first["commit"].clipped,
                      "ema": self.svc._step_norm_ema,
                      "health": self._health(first["ids"]),
                      "model_cols": self.svc.model[self.cols]}
        for _ in range(tr["warmup_commits"] - 1):
            self.round(record=False)
        _sync(self.device)
        self.setup_parts = {"pool": t1 - t0, "service": t2 - t1,
                            "first_commit": t3 - t2,
                            "warmup_commits": time.perf_counter() - t3}

    def _health(self, ids) -> dict:
        out = {}
        for i in ids:
            h = self.svc.health_of(i)
            out[i] = (h.score, h.consecutive_rejections, h.quarantined_until)
        return out

    # -- one round ---------------------------------------------------------

    def round(self, record: bool) -> dict:
        from repro_torch.serve import AgentUpdate
        tr, svc = self.traffic, self.svc
        k, n = tr["k_min"], tr["clients"]
        ids, rows, marks = [], [], []
        honest_place = 0
        while len(ids) < k:
            cid = int(self.rng.integers(n))
            if cid in ids:
                continue
            byz = cid in self.byz
            row = tr["honest_rows"] if byz else honest_place
            self.seq[cid] += 1
            name = "commit" if len(ids) == k - 1 else "submit"
            t0 = time.perf_counter()
            with trace.span(name, self.traced and record):
                verdict = svc.submit(AgentUpdate(
                    agent_id=cid, round=svc.round, payload=self.pool[row],
                    seq=self.seq[cid]))
                if name == "commit" and self.traced and record:
                    torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            if record:
                self.counts["submitted"] += 1
                self.counts["honest"] += not byz
            if verdict != "buffered":
                key = "byzantine_refused" if byz else "honest_refused"
                self.counts[key] += 1
                continue
            ids.append(cid)
            rows.append(row)
            marks.append(t0)
            honest_place += not byz
        (commit,) = svc.drain_commits()
        if commit.kind != "aggregated":
            raise RuntimeError(f"a full cohort was not aggregated: {commit}")
        if record:
            self.counts["commits"] += 1
            self.latencies.extend(t1 - t for t in marks)
            self.records["commit_wall_s"].append(t1 - t0)
            if self.traced:
                self.records["phase_ms"].append(svc.phase_ms())
        return {"ids": ids, "rows": rows, "commit": commit}

    # -- the window --------------------------------------------------------

    def _before(self) -> dict:
        """The service's state before the checked commit (a copy of the
        model on the device, the EMA, every client's health)."""
        svc = self.svc
        return {"model": svc.model, "ema": svc._step_norm_ema,
                "round": svc.round,
                "health": self._health(range(self.traffic["clients"]))}

    def _after(self, before: dict, out: dict) -> None:
        svc = self.svc
        self.sampled = dict(before, ids=out["ids"], rows=out["rows"],
                            outliers=out["commit"].outliers,
                            clipped=out["commit"].clipped,
                            after_model=svc.model,
                            after_ema=svc._step_norm_ema,
                            after_health=self._health(out["ids"]))

    def window(self, seconds: float) -> dict:
        tr = self.traffic
        n_traced = tr.get("traced_commits", 20) if self.traced else 0
        t_start = time.perf_counter()
        i = 0
        with contextlib.ExitStack() as profiled:
            while i == 0 or time.perf_counter() - t_start < seconds:
                if i == 0 and n_traced:
                    profiled.enter_context(trace.traced(self.records["trace"]))
                if i == self.check_at:
                    before = self._before()
                out = self.round(record=True)
                if i == self.check_at:
                    self._after(before, out)
                i += 1
                if i == n_traced:
                    profiled.close()
        _sync(self.device)
        t_end = time.perf_counter()
        n = i
        while i <= self.check_at:
            # a window too short to reach the checked commit: go on, untimed
            before = self._before() if i == self.check_at else None
            out = self.round(record=False)
            if before is not None:
                self._after(before, out)
            i += 1
        self.records["traced_commits"] = min(n_traced, n)
        lat = np.asarray(self.latencies) * 1e3
        print(f"perfbench: updates {self.counts}, checked commit "
              f"{self.check_at}", file=sys.stderr)
        return {"commits_per_s": n / (t_end - t_start),
                "commit_ms_p95": float(np.percentile(lat, 95)),
                "window_s": t_end - t_start, "commits": n,
                "updates": len(self.latencies)}

    def attempted_failed(self, window: dict) -> tuple:
        """Every honest update submitted in the window, and those the
        service refused."""
        return self.counts["honest"], self.counts["honest_refused"]

    def layer_record(self) -> dict:
        """The frozen bound of one commit's estimate (the weighted
        (k_min, M, 1) launch at T = 10)."""
        from counts import mm_ops
        return {"bound_s": mm_ops.bound_s(self.traffic["k_min"], self.m, 1,
                                          True)[0]}

    def free_program(self) -> None:
        del self.svc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self) -> dict:
        """The numbers ``correct`` compares: the program's commits
        against the reference's."""
        return gaps(self.program_side(), self.reference(),
                    self.counts["honest_refused"])

    def controls(self) -> dict:
        """The control: the reference's estimator in bfloat16, one
        precision below the configuration's float32, in the program's
        place."""
        ref = self.reference()
        return {"control": gaps(self.reference(dtype=torch.bfloat16), ref,
                                0)}

    # -- the check ---------------------------------------------------------

    def _rows(self, rows):
        idx = torch.tensor(rows, device=self.device)
        return lambda lo, hi: self.pool[:, lo:hi].index_select(0, idx)

    def reference(self, dtype=torch.float32) -> dict:
        """The reference's commits at the start and at the sampled commit
        (``dtype``: its precision; bfloat16 is the control)."""
        st, sa = self.start, self.sampled
        k = len(st["ids"])
        start = ref_serve.commit(
            self._rows(st["rows"]), self.m, st["ids"], [1.0] * k, [0] * k, 0,
            torch.zeros((self.m,), device=self.device), None,
            block=REF_BLOCK, dtype=dtype)
        start["model_cols"] = start.pop("model")[self.cols]
        sampled = ref_serve.commit(
            self._rows(sa["rows"]), self.m, sa["ids"],
            [sa["health"][i][0] for i in sa["ids"]],
            [sa["health"][i][1] for i in sa["ids"]], sa["round"],
            sa["model"], sa["ema"], block=REF_BLOCK, dtype=dtype)
        return {"start": start, "sampled": sampled}

    def program_side(self) -> dict:
        st, sa = self.start, self.sampled
        return {"start": {"model_cols": st["model_cols"],
                          "outliers": st["outliers"], "clipped": st["clipped"],
                          "ema": st["ema"], "health": st["health"]},
                "sampled": {"model": sa["after_model"],
                            "outliers": sa["outliers"],
                            "clipped": sa["clipped"], "ema": sa["after_ema"],
                            "health": sa["after_health"]}}



def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _max_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max(1, max |b|), block by block."""
    num, den = 0.0, 1.0
    for lo in range(0, b.shape[0], REF_BLOCK):
        x, y = a[lo:lo + REF_BLOCK], b[lo:lo + REF_BLOCK]
        num = max(num, float(torch.max(torch.abs(x.float() - y.float()))))
        den = max(den, float(torch.max(torch.abs(y.float()))))
    return num / den


def _state(side: dict, ref: dict) -> tuple:
    """(mismatched verdicts, the widest relative gap of EMA and scores)."""
    bad = int(set(side["outliers"]) != set(ref["outliers"]))
    bad += int(bool(side["clipped"]) != bool(ref["clipped"]))
    gap = abs(side["ema"] - ref["ema"]) / max(abs(ref["ema"]), 1e-30)
    for i, (score, run, until) in ref["health"].items():
        p_score, p_run, p_until = side["health"][i]
        gap = max(gap, abs(p_score - score))
        bad += int(p_run != run) + int(until >= 0 and p_until != until)
    return bad, gap


def gaps(side: dict, ref: dict, honest_refused: int) -> dict:
    """The numbers ``correct`` compares, of ``side`` against ``ref``."""
    bad0, gap0 = _state(side["start"], ref["start"])
    bad1, gap1 = _state(side["sampled"], ref["sampled"])
    return {
        "start_gap": _max_gap(side["start"]["model_cols"],
                              ref["start"]["model_cols"]),
        "commit_gap": _max_gap(side["sampled"]["model"],
                               ref["sampled"]["model"]),
        "state_gap": max(gap0, gap1),
        "verdict_mismatch": float(bad0 + bad1),
        "honest_refused": float(honest_refused),
    }


def tiny(cell: dict) -> dict:
    """The cell at a size a CPU test holds: a few thousand coordinates a
    payload, the checked commit among the first five, and 16 times the
    clients (the same Byzantine share).  At the cells' sizes the
    residual check's floor, a thousandth of the median residual norm,
    lies far above the spread of the honest rows' residuals; at a few
    thousand coordinates it does not, so a few honest rows are flagged
    in every commit, and a client drawn to such a place in five commits
    running would be quarantined: with 16 times the clients none takes
    part in five commits of a test's run."""
    cell["config"] = dict(cell["config"], payload="coordinates",
                          parameters=3000)
    tr = cell["traffic"]
    tr.update(check_commit_below=5, check_columns=1000,
              clients=16 * tr["clients"], byzantine=16 * tr["byzantine"])
    return cell
