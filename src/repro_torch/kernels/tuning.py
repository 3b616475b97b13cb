"""Tile-size + kernel-path choice for the MM-aggregation kernels.

Counterpart of ``repro.kernels.tuning`` without the timing sweep
(``autotune`` waits for a later slice).  ``get_choice`` returns a cached
``TuneChoice`` for the (K, M, N, dtype) workload on this device when one
exists, else ``heuristic_blocks``: on the single pass the widest tile,
in steps of one warp of columns (32), whose shared memory fits a Hopper
block; on the two-pass kernel the widest block of 8, 4, 2 or 1 columns
(one warp each) that fits and still gives every SM a tile.

The cache persists across processes when ``REPRO_TORCH_TUNING_CACHE``
names a JSON file (never the reference's ``REPRO_TUNING_CACHE``: its
entries describe TPU tiles).  Entries are keyed by the device name as
well as the workload, since a tile measured on one card says nothing of
another.  A missing or corrupt file reads as empty; writes are atomic
(tmp file + ``os.replace``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import mm_aggregate as _mm

WARP = 32
ENV_CACHE_PATH = "REPRO_TORCH_TUNING_CACHE"

BlockChoice = Tuple[int, Optional[int]]   # (block_m, block_k)


class TuneChoice(NamedTuple):
    """A tuning decision; ``path=None`` lets ``mm_aggregate.auto_path``
    decide."""
    block_m: int
    block_k: Optional[int]
    path: Optional[str] = None


class TuneKey(NamedTuple):
    k: int
    m: int
    n: int
    dtype: str
    device: str


_CACHE: Dict[TuneKey, TuneChoice] = {}
_persistent_loaded = False


def device_name() -> str:
    """The card the kernels run on ("cpu" where there is none)."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"


def _key(k, m, n, dtype, device: Optional[str] = None) -> TuneKey:
    return TuneKey(int(k), int(m), int(n), _mm.dtype_name(dtype),
                   device or device_name())


def cache_path() -> Optional[str]:
    return os.environ.get(ENV_CACHE_PATH) or None


def load_cache(path: Optional[str] = None, *, force: bool = True) -> int:
    """Merge the persistent JSON cache into the in-process cache; returns
    the number of entries merged (in-process entries win)."""
    global _persistent_loaded
    if path is None:
        if not force and _persistent_loaded:
            return 0
        _persistent_loaded = True
        path = cache_path()
    if not path:
        return 0
    try:
        with open(path) as f:
            entries = json.load(f)["entries"]
    except (OSError, ValueError, KeyError, TypeError):
        return 0
    merged = 0
    for e in entries:
        try:
            key = TuneKey(int(e["k"]), int(e["m"]), int(e["n"]),
                          str(e["dtype"]), str(e["device"]))
            bk = e["block_k"]
            kpath = e.get("path")
            if kpath is not None and kpath not in _mm.PATHS:
                continue
            choice = TuneChoice(int(e["block_m"]),
                                None if bk is None else int(bk), kpath)
        except (KeyError, TypeError, ValueError, AttributeError):
            continue
        if key not in _CACHE:
            _CACHE[key] = choice
            merged += 1
    return merged


def save_cache(path: Optional[str] = None) -> Optional[str]:
    """Atomically write the in-process cache (merged over the file)."""
    path = path or cache_path()
    if not path:
        return None
    load_cache(path, force=True)
    entries = [{"k": key.k, "m": key.m, "n": key.n, "dtype": key.dtype,
                "device": key.device, "block_m": c.block_m,
                "block_k": c.block_k, "path": c.path}
               for key, c in sorted(_CACHE.items())]
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"version": 1, "entries": entries}, f, indent=2)
            f.write("\n")
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return path


def heuristic_blocks(k: int, m: int, n: int = 1, dtype=torch.float32,
                     path: Optional[str] = None) -> BlockChoice:
    """The tile of ``path`` (None: the one ``auto_path`` takes).  Single
    pass: the widest (a multiple of 32 columns, at most 256 and at most
    the problem's width) whose shared memory fits a block.  Two-pass: the
    widest of ``TWO_PASS_BLOCK_MS`` whose block fits and whose column
    tiles number at least ``TWO_PASS_MIN_TILES`` (one per SM), else the
    narrowest that fits (1 where none does: the launch then raises on
    the card)."""
    del dtype  # the kernels hold f32 tiles whatever the input dtype
    k, n, m = int(k), max(int(n), 1), int(m)
    cap = min(_mm._MAX_BLOCK_M, max(WARP, -(-m // WARP) * WARP))

    def widest(model) -> int:
        bm = cap
        while bm >= WARP and model(bm) > _mm.SMEM_BUDGET_BYTES:
            bm -= WARP
        return max(bm, WARP)

    if (path or _mm.auto_path(k, n)) == "single":
        return widest(lambda bm: _mm.single_pass_smem_bytes(k, n, bm)), None
    bk = _mm.two_pass_block_k(k)
    fitting = [bm for bm in _mm.TWO_PASS_BLOCK_MS
               if _mm.two_pass_smem_bytes(
                   k, _mm.two_pass_n_chunk(k, n, bk, bm), bk, bm)
               <= _mm.SMEM_BUDGET_BYTES]
    for bm in fitting:
        if -(-m // bm) >= _mm.TWO_PASS_MIN_TILES:
            return bm, None
    return (fitting[-1] if fitting else 1), None


def _kernel_takes(k: int, n: int, choice: TuneChoice) -> bool:
    """Whether the kernel of the choice's path takes its tile: a two-pass
    entry cached for another kernel (a bm of 32 or more, a K block over
    512 rows) would raise at launch, so it is not used."""
    if (choice.path or _mm.auto_path(k, n)) != "two_pass":
        return True
    return choice.block_m in _mm.TWO_PASS_BLOCK_MS and (
        choice.block_k is None or choice.block_k <= _mm._MAX_BLOCK_K2)


def get_choice(k: int, m: int, n: int = 1, dtype=torch.float32,
               backend: str = "pallas") -> TuneChoice:
    """Cached choice for the workload on this device, else the heuristic."""
    if backend == "pallas":
        load_cache(force=False)
        cached = _CACHE.get(_key(k, m, n, dtype))
        if cached is not None and _kernel_takes(k, n, cached):
            return cached
    return TuneChoice(*heuristic_blocks(k, m, n, dtype))


def get_blocks(k: int, m: int, n: int = 1, dtype=torch.float32,
               backend: str = "pallas") -> BlockChoice:
    choice = get_choice(k, m, n, dtype, backend)
    return choice.block_m, choice.block_k


def set_blocks(k: int, m: int, n: int, dtype, choice) -> None:
    """Pin a (block_m, block_k[, path]) choice for this device."""
    bk = None if choice[1] is None else int(choice[1])
    kpath = choice[2] if len(choice) > 2 else None
    if kpath is not None and kpath not in _mm.PATHS:
        raise ValueError(f"unknown kernel path {kpath!r}; known: {_mm.PATHS}")
    _CACHE[_key(k, m, n, dtype)] = TuneChoice(int(choice[0]), bk, kpath)


def cache_state() -> tuple:
    """Hashable fingerprint of the tuning state that block/path
    resolution depends on.  Anything that caches a launch program whose
    geometry came from ``get_choice`` (the service's executable cache)
    keys on it: a new winner or another $REPRO_TORCH_TUNING_CACHE would
    otherwise serve a program built for the old geometry."""
    load_cache(force=False)
    return (tuple(sorted(_CACHE.items())), cache_path())


def clear_cache() -> None:
    _CACHE.clear()
