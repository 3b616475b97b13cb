"""The one tally of the port's kernel launches on the card.

``COUNTS`` counts launches by ``(kernel, K, M, N)``:

  * the single-pass MM kernel under its variant (``regs``, ``warp``,
    ``smem``) and the two-pass kernel under ``two_pass``, with
    ``KernelCall.key``'s (K, M, N);
  * a finiteness check as ``("finite_scan", 1, elements, 1)``;
  * a residual-norm call as ``("residual", rows, length, 1)``.

Each wrapper calls ``note`` after a launch on the card succeeds; the
CPU's plain versions and the meta device count nothing.  A launch made
while a CUDA graph captures the stream runs only when the graph replays:
inside a ``captured()`` scope (``ops.capture_graph``, the port's one
capture) its key goes to the scope, and the program that replays the
graph counts those keys on each replay (``replay``).
"""

from __future__ import annotations

import collections
import contextlib

import torch

COUNTS: collections.Counter = collections.Counter()
# the key lists of the open captured() scopes
_SCOPES: list = []


def note(key: tuple) -> None:
    """Count one launch of ``key``, or, while a ``captured()`` scope is
    open and the stream is being captured, defer it to the scope."""
    if _SCOPES and torch.cuda.is_current_stream_capturing():
        for keys in _SCOPES:
            keys.append(key)
    else:
        COUNTS[key] += 1


@contextlib.contextmanager
def captured():
    """Collect the keys of the launches captured inside the scope: the
    launches each replay of that graph makes."""
    keys: list = []
    _SCOPES.append(keys)
    try:
        yield keys
    finally:
        _SCOPES.pop()


def replay(keys) -> None:
    """Count one replay of a graph that captured ``keys`` (an iterable
    of keys, or a mapping of key to launches)."""
    COUNTS.update(keys)


@contextlib.contextmanager
def uncounted():
    """Launches made inside the scope (a timing sweep, a comparison)
    leave the counts as they were."""
    saved = COUNTS.copy()
    try:
        yield
    finally:
        COUNTS.clear()
        COUNTS.update(saved)


def total(*kernels: str) -> int:
    """Launches of the given kernels, or of every kernel when none is
    given."""
    return sum(n for key, n in COUNTS.items()
               if not kernels or key[0] in kernels)
