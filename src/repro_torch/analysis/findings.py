"""Findings and the checked-in baseline (``repro.analysis.findings``).

Every analysis pass of the port (contracts / launch audit) reports
``Finding`` records.  A finding's identity is its ``key`` --
``rule:path:where:ident`` -- deliberately excluding line numbers so the
baseline survives unrelated edits to the same file.

The port's baseline (``ANALYSIS_BASELINE_TORCH.json``, repo root) is the
explicit allowlist of *intentional* findings: a list of ``{"key": ...,
"reason": ...}`` entries, every entry carrying a non-empty reason
string.  ``apply`` splits a pass's findings into (unbaselined,
baselined); the CLI exits non-zero on any unbaselined finding, so adding
an exception is a reviewed diff to the baseline file, never a silent
skip.  The keys, the rendering and the errors are the reference's.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis finding.

    ``rule``   the rule slug (e.g. ``one-residency``, ``traced-branch``)
    ``path``   repo-relative file (lint) or logical target (``kernel``,
               ``engine``, ``scenario`` for the static passes)
    ``where``  the function / workload the finding is anchored to
    ``ident``  a short, line-number-free discriminator (variable name,
               workload tuple, ...) keeping keys stable across edits
    ``detail`` the human-readable message
    ``line``   informational only -- never part of the identity
    """

    rule: str
    path: str
    where: str
    detail: str
    ident: str = ""
    line: int = 0

    @property
    def key(self) -> str:
        parts = [self.rule, self.path, self.where]
        if self.ident:
            parts.append(self.ident)
        return ":".join(parts)

    def render(self, reason: Optional[str] = None) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        base = f"[{self.rule}] {loc} ({self.where}): {self.detail}"
        if reason is not None:
            base += f"\n    baselined: {reason}"
        return base

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["key"] = self.key
        return d


class BaselineError(ValueError):
    pass


def load_baseline(path) -> Dict[str, str]:
    """Load a baseline file -> {finding key: reason}.

    Every entry must carry a non-empty ``reason`` -- an exception
    without a rationale is rejected, not silently honored.
    """
    p = pathlib.Path(path)
    if not p.exists():
        return {}
    data = json.loads(p.read_text())
    entries = data.get("findings", data) if isinstance(data, dict) else data
    if not isinstance(entries, list):
        raise BaselineError(
            f"{p}: expected a list of entries (or {{'findings': [...]}}), "
            f"got {type(entries).__name__}")
    out: Dict[str, str] = {}
    for i, e in enumerate(entries):
        if not isinstance(e, dict) or "key" not in e:
            raise BaselineError(f"{p}: entry {i} has no 'key': {e!r}")
        reason = e.get("reason", "")
        if not isinstance(reason, str) or not reason.strip():
            raise BaselineError(
                f"{p}: entry {e['key']!r} has no reason string -- every "
                "baselined finding must say WHY it is intentional")
        if e["key"] in out:
            raise BaselineError(f"{p}: duplicate key {e['key']!r}")
        out[e["key"]] = reason
    return out


def apply(findings: Iterable[Finding], baseline: Dict[str, str],
          ) -> Tuple[List[Finding], List[Tuple[Finding, str]], List[str]]:
    """Split findings against the baseline.

    Returns ``(unbaselined, baselined, stale_keys)`` where ``baselined``
    pairs each suppressed finding with its reason and ``stale_keys`` are
    baseline entries that matched nothing (candidates for deletion --
    reported, not fatal, so a fixed finding doesn't break CI twice).
    """
    unbaselined: List[Finding] = []
    baselined: List[Tuple[Finding, str]] = []
    seen = set()
    for f in findings:
        if f.key in baseline:
            baselined.append((f, baseline[f.key]))
            seen.add(f.key)
        else:
            unbaselined.append(f)
    stale = [k for k in baseline if k not in seen]
    return unbaselined, baselined, stale
