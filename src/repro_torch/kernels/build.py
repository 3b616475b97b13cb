"""Build and load the hand-written CUDA kernels at first use.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  All
sources are compiled at once, one ``nvcc`` process each, into
``<checkout>/build/repro_torch/<hash>/`` where the hash covers the sources
and the flags, so an edited source never loads a stale library.  Nothing
is built when the module is imported: the CPU tests import every module
and have no ``nvcc``.

``nvcc`` is taken from ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``)
or the ``PATH``.  ``-Xptxas -v`` output (registers, shared memory,
spills per kernel) is kept in ``build.log`` beside the libraries.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# library name -> its source; each library exports the C functions below
SOURCES = {"mm_single_pass": "mm_single_pass.cu", "mm_two_pass": "mm_two_pass.cu"}

_P, _I, _I64, _F, _SZ = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float, ctypes.c_size_t)
_SIGNATURES = {
    "mm_single_pass": {
        "mm_single_pass_launch": (_I, [_P, _I, _I64, _I, _I64, _P, _I, _P, _I,
                                       _I, _I, _F, _I, _P]),
        "mm_single_pass_smem_bytes": (_SZ, [_I, _I, _I, _I]),
        "mm_single_pass_config": (_I, [_I, _I, _I64, _I, _I, _I, _P, _P, _I]),
    },
    "mm_two_pass": {
        "mm_two_pass_launch": (_I, [_P, _I, _I64, _I, _I64, _P, _I, _P, _I,
                                    _I, _I, _I, _F, _I, _P]),
        "mm_two_pass_smem_bytes": (_SZ, [_I, _I, _I, _I]),
        "mm_two_pass_blocks": (_I, [_I, _I, _I64, _I, _I, _I, _I, _I, _P]),
        "mm_two_pass_config": (_I, [_I, _I, _I64, _I, _I, _I, _I, _I, _P, _P,
                                    _I]),
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> pathlib.Path:
    return BUILD_ROOT / _digest()


def _compile_all(out_dir: pathlib.Path) -> None:
    """Start one nvcc per missing library, all at once, then wait."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for name, src in SOURCES.items():
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    failed = []
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name} (rc {proc.returncode})\n{out}")
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append(name)
        BUILD_SECONDS[name] = time.perf_counter() - t0
    if logs:
        with open(out_dir / "build.log", "a") as f:
            f.write("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library."""
    with _LOCK:
        if len(_LIBS) == len(SOURCES):
            return _LIBS
        out_dir = build_dir()
        _compile_all(out_dir)
        for name in SOURCES:
            lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[name] = lib
        return _LIBS


def library(name: str) -> ctypes.CDLL:
    return load_all()[name]


def build_log() -> str:
    p = build_dir() / "build.log"
    return p.read_text() if p.exists() else ""
