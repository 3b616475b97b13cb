"""Write-ahead journal + snapshots: exactly-once admission across
crash/restart.

Counterpart of ``repro.serve.journal`` with the same byte format, so a
journal either package writes loads in the other.  Tensors cross to the
host here and only here: ``encode_array`` takes a tensor (or an array)
and writes its float32 bytes; ``decode_array`` gives a numpy array,
which the service moves to its device.

The durability problem a restart creates is *byzantine*, not just
operational: the admission buffer's per-agent sequence gates are what
stop a replayed delivery from being admitted twice.  A service that
restarts with empty gates would re-admit every update the transport
re-delivers -- a malicious agent could then get one payload counted in
two cohorts, defeating the breakdown-point math the kernel enforces.
The journal makes the gates (and everything else an admission decision
depends on) durable:

  * every delivered update is appended *before* it is gated/applied
    (write-ahead).  Crash after the append -> recovery replays the
    delivery through the same gate logic, so it is applied exactly as
    the live run would have; crash before -> the delivery simply never
    happened (the sender's retry path re-delivers it).  Either way an
    update is admitted at most once.
  * a commit becomes durable when its record is appended: the record
    carries the post-commit model, round, trust-region EMA, per-agent
    health state, and the (agent, seq) pairs the cohort consumed.
    Crash between the kernel launch and the append -> the entries are
    still pending after recovery and aggregate once, later; crash after
    -> recovery restores the committed state and the seq gates reject
    every re-delivery.  The append is the commit point.
  * a ``snapshot`` record (full state: model, round, EMA, seq gates,
    pending entries with payloads, health map) is written every
    ``snapshot_every`` commits; recovery starts from the last snapshot
    and replays only the suffix.

Records are JSON lines -- ``<crc32hex> <sorted-key json>`` -- with
payload arrays as base64 of the raw float32 bytes, and **no wall-clock
values anywhere** (all times are the service clock's): two runs of the
same chaos profile and seed under ``SimClock`` therefore produce
bit-identical journals, which the determinism regression test pins.
A torn final line (the crash landed mid-``write``) fails its CRC and is
dropped; corruption anywhere earlier raises -- a silently shortened
history would break the exactly-once argument.

Backends: ``Journal.memory()`` keeps the lines in-process (the chaos
harness and tests); ``Journal.file(path)`` appends to disk with an
``fsync`` per record (the real thing).  ``dump()`` returns the exact
byte stream either way.
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import io
import json
import os
import pathlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

RECORD_KINDS = ("init", "delivery", "commit", "snapshot", "recovered")


def encode_array(x) -> str:
    """Base64 of the raw float32 bytes of a tensor or an array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to(torch.float32).reshape(-1).cpu().numpy()
    return base64.b64encode(
        np.ascontiguousarray(x, dtype=np.float32).tobytes()).decode("ascii")


def decode_array(s: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s.encode("ascii")),
                         dtype=np.float32).copy()


def _crc(body: bytes) -> str:
    return format(binascii.crc32(body) & 0xFFFFFFFF, "08x")


class JournalCorrupt(RuntimeError):
    """A non-tail record failed its CRC / parse: history is untrusted."""


class _MemoryBackend:
    def __init__(self):
        self._buf = io.BytesIO()

    def append(self, line: bytes) -> None:
        self._buf.write(line)

    def read(self) -> bytes:
        return self._buf.getvalue()


class _FileBackend:
    def __init__(self, path, *, fsync: bool = True):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fsync = fsync

    def append(self, line: bytes) -> None:
        with open(self.path, "ab") as f:
            f.write(line)
            f.flush()
            if self._fsync:
                os.fsync(f.fileno())

    def read(self) -> bytes:
        if not self.path.exists():
            return b""
        return self.path.read_bytes()


class Journal:
    """Append-only record log; see module docstring for the format and
    the exactly-once argument."""

    def __init__(self, backend, *, snapshot_every: int = 64):
        if snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {snapshot_every}")
        self._backend = backend
        self.snapshot_every = snapshot_every
        self.commits_since_snapshot = 0
        self.n_records = 0

    @classmethod
    def memory(cls, **kw) -> "Journal":
        return cls(_MemoryBackend(), **kw)

    @classmethod
    def file(cls, path, *, fsync: bool = True, **kw) -> "Journal":
        return cls(_FileBackend(path, fsync=fsync), **kw)

    # -- writing -----------------------------------------------------------

    def append(self, kind: str, record: dict) -> None:
        if kind not in RECORD_KINDS:
            raise ValueError(f"unknown record kind {kind!r}")
        body = json.dumps(dict(record, t=kind), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")
        self._backend.append(_crc(body).encode("ascii") + b" " + body + b"\n")
        self.n_records += 1
        if kind == "commit":
            self.commits_since_snapshot += 1
        elif kind == "snapshot":
            self.commits_since_snapshot = 0

    def snapshot_due(self) -> bool:
        return self.commits_since_snapshot >= self.snapshot_every

    # -- reading -----------------------------------------------------------

    def dump(self) -> bytes:
        """The exact journal byte stream (determinism comparisons)."""
        return self._backend.read()

    def records(self, *, strict_tail: bool = False
                ) -> Iterator[Tuple[str, dict]]:
        """Parse ``(kind, record)`` pairs.  A bad *final* line is the
        torn write of the crash itself and is dropped (unless
        ``strict_tail``); a bad line anywhere earlier raises
        ``JournalCorrupt``."""
        raw = self._backend.read()
        lines = raw.split(b"\n")
        # a complete journal ends with a newline -> last element empty
        complete = lines and lines[-1] == b""
        lines = [ln for ln in lines if ln]
        for i, line in enumerate(lines):
            is_tail = (i == len(lines) - 1) and not complete
            try:
                crc, body = line.split(b" ", 1)
                if crc.decode("ascii") != _crc(body):
                    raise ValueError("crc mismatch")
                rec = json.loads(body.decode("utf-8"))
                kind = rec.pop("t")
            except (ValueError, KeyError, UnicodeDecodeError) as exc:
                if is_tail and not strict_tail:
                    return        # torn final write: crash landed mid-line
                raise JournalCorrupt(
                    f"journal record {i} unreadable: {exc}") from exc
            yield kind, rec


@dataclasses.dataclass(frozen=True, eq=False)
class RecoveredState:
    """What ``recover_state`` distilled from a journal (the *base*
    state; delivery/commit records after the last snapshot still need
    replaying -- ``AggregationService.recover`` does that through the
    live gate logic so recovery cannot drift from the running code)."""

    model: np.ndarray
    round: int
    ema: Optional[float]
    last_seq: Dict[int, int]
    pending: List[dict]
    health: Dict[int, list]
    tail: List[Tuple[str, dict]]     # records after the snapshot point
    n_records: int
    n_commits: int


def recover_state(journal: Journal) -> RecoveredState:
    """Scan the journal: the last ``init``/``snapshot`` record is the
    base; everything after it is the replay tail."""
    base: Optional[dict] = None
    tail: List[Tuple[str, dict]] = []
    n_records = 0
    n_commits = 0
    for kind, rec in journal.records():
        n_records += 1
        if kind in ("init", "snapshot"):
            base = rec
            tail = []
        elif kind == "recovered":
            continue              # informational marker
        else:
            if base is None:
                raise JournalCorrupt(
                    f"journal starts with {kind!r}, not init/snapshot")
            tail.append((kind, rec))
            if kind == "commit":
                n_commits += 1
    if base is None:
        raise JournalCorrupt("journal holds no init/snapshot record")
    return RecoveredState(
        model=decode_array(base["model"]),
        round=int(base["round"]),
        ema=base.get("ema"),
        last_seq={int(k): int(v)
                  for k, v in (base.get("last_seq") or {}).items()},
        pending=list(base.get("pending") or []),
        health={int(k): list(v)
                for k, v in (base.get("health") or {}).items()},
        tail=tail, n_records=n_records, n_commits=n_commits)
