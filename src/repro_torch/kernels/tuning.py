"""Tile-size + kernel-path autotuner for the MM-aggregation kernels.

Counterpart of ``repro.kernels.tuning``.  A launch's knobs are
``block_m`` (the columns a block holds), ``block_k`` (the two-pass
kernel's K block) and the kernel path (``single`` | ``two_pass``); the
right choice depends on the workload (K, M, N, dtype) and the card.

  get_choice(k, m, n, dtype)  -- shape only, never times: the cached
      ``TuneChoice`` for the workload on this device when one exists,
      else ``heuristic_blocks``: on the single pass the widest tile, in
      steps of one warp of columns (32), whose shared memory fits a
      Hopper block; on the two-pass kernel the widest block of 8, 4, 2
      or 1 columns (one warp each) that fits and still gives every SM a
      tile.  ``mm_aggregate.launch_plan`` (and hence the engine)
      consults it.
  autotune(k, m, n, dtype)    -- times ``candidate_choices`` on
      synthetic data through the real launcher, caches the fastest
      (with its path, so the single<->two-pass crossover is measured for
      K >= 65) and writes it to the persistent cache.

The cache persists across processes when ``REPRO_TORCH_TUNING_CACHE``
names a JSON file (never the reference's ``REPRO_TUNING_CACHE``: its
entries describe TPU tiles).  Entries are keyed by the device name as
well as the workload, since a tile measured on one card says nothing of
another.  A missing or corrupt file reads as empty; every autotune
winner is written back atomically (tmp file + ``os.replace``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import devices
from repro_torch.kernels import launches
from repro_torch.kernels import mm_aggregate as _mm

WARP = 32
# single-pass tiles the sweep times beside the heuristic's
SWEEP_BLOCK_MS = (32, 64, 128, 256)
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
# each autotuned workload's last sweep: ((choice, microseconds), ...)
_SWEEPS: Dict[TuneKey, Tuple[Tuple[TuneChoice, float], ...]] = {}
_persistent_loaded = False


def device_name(device=None) -> str:
    """The card the kernels run on: ``device``'s, or (None) card 0's;
    "cpu" for a CPU device or where there is no card."""
    if device is None:
        return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
            else "cpu"
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


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


def _as_choice(choice) -> TuneChoice:
    bk = None if choice[1] is None else int(choice[1])
    kpath = choice[2] if len(choice) > 2 else None
    if kpath is not None and kpath not in _mm.PATHS:
        raise ValueError(f"unknown kernel path {kpath!r}; known: {_mm.PATHS}")
    return TuneChoice(int(choice[0]), bk, kpath)


def set_blocks(k: int, m: int, n: int, dtype, choice) -> None:
    """Pin a (block_m, block_k[, path]) choice for this device."""
    _CACHE[_key(k, m, n, dtype)] = _as_choice(choice)


def cache_size() -> int:
    """Workloads with a cached choice in this process."""
    return len(_CACHE)


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
    _SWEEPS.clear()


# ---------------------------------------------------------------------------
# the timing sweep
# ---------------------------------------------------------------------------

def _time_call_us(fn, *, reps: int = 3, device="cpu") -> float:
    """Mean microseconds of ``fn()`` over ``reps`` calls, after one warm
    call (so a kernel's build at first use and its first launch are never
    timed): CUDA events around the calls on a card, the host clock on the
    CPU, where each call returns its result."""
    dev = torch.device(device)
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def heuristic_choice(k: int, m: int, n: int = 1,
                     dtype=torch.float32) -> TuneChoice:
    """What a launch takes with no cached winner: ``auto_path``'s path,
    the heuristic's tile and, on the two-pass path, its default K
    block."""
    kpath = _mm.auto_path(k, n)
    bm, _ = heuristic_blocks(k, m, n, dtype)
    return TuneChoice(bm, _mm.two_pass_block_k(k) if kpath == "two_pass"
                      else None, kpath)


def candidate_blocks(k: int, m: int, n: int = 1,
                     dtype=torch.float32) -> List[BlockChoice]:
    """Single-pass tiles to time: ``SWEEP_BLOCK_MS`` and the heuristic's,
    at most the problem's width rounded up to a warp.  The single pass
    loads all K rows as one block, so ``block_k`` is None."""
    cap = max(WARP, -(-int(m) // WARP) * WARP)
    bms = sorted({*SWEEP_BLOCK_MS,
                  heuristic_blocks(k, m, n, dtype, path="single")[0]})
    return [(bm, None) for bm in bms if bm <= cap]


def _fits(k: int, m: int, n: int, dtype, choice: TuneChoice) -> bool:
    plan = _mm.launch_plan(k, m, n, dtype=dtype, block_m=choice.block_m,
                           block_k=choice.block_k, path=choice.path)
    return plan.smem_bytes <= _mm.SMEM_BUDGET_BYTES


def candidate_choices(k: int, m: int, n: int = 1,
                      dtype=torch.float32) -> List[TuneChoice]:
    """The default sweep: every single-pass tile of ``candidate_blocks``
    and, for K >= 65, the two-pass kernel at the heuristic's block of
    columns and the next narrower one, each with the default K block and
    with half of it where that half has at least 16 rows.  A candidate
    whose block would carve more shared memory than a Hopper block may
    use cannot launch, so it is dropped before anything is timed; the
    heuristic's own choice always stays, so the list is never empty."""
    out = [TuneChoice(bm, bk, "single")
           for bm, bk in candidate_blocks(k, m, n, dtype)]
    if int(k) >= _mm._TWO_PASS_MIN_K:
        bm0 = heuristic_blocks(k, m, n, dtype, path="two_pass")[0]
        bk0 = _mm.two_pass_block_k(k)
        i = _mm.TWO_PASS_BLOCK_MS.index(bm0)
        for bm in _mm.TWO_PASS_BLOCK_MS[i:i + 2]:
            out.append(TuneChoice(bm, bk0, "two_pass"))
            if bk0 // 2 >= 16:
                out.append(TuneChoice(bm, bk0 // 2, "two_pass"))
    out = [c for c in out if _fits(k, m, n, dtype, c)]
    first = heuristic_choice(k, m, n, dtype)
    return out if first in out else [first] + out


def autotune(k: int, m: int, n: int = 1, dtype=torch.float32, *,
             candidates: Optional[Sequence] = None,
             num_iters: int = 10, reps: int = 3, force: bool = False,
             device="cuda") -> BlockChoice:
    """Time (block_m, block_k[, path]) candidates (default
    ``candidate_choices``) through ``mm_aggregate_batched_2d`` on
    synthetic data made on ``device`` -- x ~ N(0, 1) of shape (K, M) and
    weights a ~ U(0.1, 1) of shape (K, N), from a generator seeded 0 --
    cache the fastest as a ``TuneChoice`` with its path, write it to the
    persistent cache, and return its (block_m, block_k).  Idempotent per
    (K, M, N, dtype, device) unless ``force``.  The sweep's launches
    leave the launch counts as they were.  An error of a candidate is
    not skipped: a CUDA error is sticky and would poison every later
    launch, so it propagates."""
    dev = devices.resolve(device)
    dtype = _mm._as_dtype(dtype)
    key = _key(k, m, n, dtype, device_name(dev))
    load_cache(force=False)
    if not force and key in _CACHE:
        return _CACHE[key].block_m, _CACHE[key].block_k
    choices = [_as_choice(c) for c in candidates] if candidates is not None \
        else candidate_choices(k, m, n, dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((int(k), int(m)), generator=g, device=dev).to(dtype)
    a = torch.rand((int(k), int(n)), generator=g, device=dev) * 0.9 + 0.1
    timed = []
    with launches.uncounted():
        for c in choices:
            def call(c=c):
                return _mm.mm_aggregate_batched_2d(
                    x, a, num_iters=num_iters, block_m=c.block_m,
                    block_k=c.block_k, path=c.path)
            timed.append((c, _time_call_us(call, reps=reps, device=dev)))
    del x, a
    best = min(timed, key=lambda t: t[1])[0]
    _CACHE[key] = best
    _SWEEPS[key] = tuple(timed)
    save_cache()
    return best.block_m, best.block_k


def sweep_times(k: int, m: int, n: int = 1, dtype=torch.float32,
                device="cuda") -> Optional[Tuple[Tuple[TuneChoice, float], ...]]:
    """The last ``autotune`` sweep of the workload on ``device`` in this
    process: ((candidate, microseconds), ...) in the order timed; None
    where none ran."""
    return _SWEEPS.get(_key(k, m, n, dtype, device_name(device)))
