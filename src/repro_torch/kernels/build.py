"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/<name>-<hash>.so`` at the root of
the checkout, compiled for ``sm_90a`` the first time it is used; the hash is
of the source and the shared headers (``csrc/*.cuh``), so an edited kernel
is never served from a stale library.
All missing libraries are compiled at once, one ``nvcc`` process per
source; each one's ``ptxas`` report (registers, stack frame and spills of
every kernel, ``-Xptxas=-v``) is kept in ``build_logs``.  Each library
exports one C function that takes raw pointers, the sizes and the CUDA
stream, and returns ``cudaGetLastError()``.

Nothing here runs at import: the CPU tests import every module of the
package, and this machine-dependent step happens on the first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signature of each kernel's entry point (after the pointers: sizes, then
# the stream).  The function is named like its source file.
SIGNATURES = {
    "l2_rows": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "adc_rows": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "frontier_select": [_P] * 14 + [_I] * 6 + [_P],
    "robust_prune_fp": [_P] * 6 + [_I] * 4 + [ctypes.c_float, _P],
    "robust_prune_sdc": [_P] * 7 + [_I] * 6 + [ctypes.c_float, _P],
    "delete_repair_fp": [_P] * 6 + [_I] * 4 + [ctypes.c_float, _P],
    "delete_repair_sdc": [_P] * 7 + [_I] * 6 + [ctypes.c_float, _P],
    "gather_rows": [_P] * 3 + [_L, _I, _P],
    "block_topk": [_P] * 4 + [_I] * 3 + [_P],
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}
build_logs: dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or
    ``PATH``.  Raises if there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build only on a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every missing library (all ``nvcc`` processes run at once).
    Returns {name: seconds} for the libraries compiled by this call."""
    names = list(SIGNATURES if names is None else names)
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    took = {}
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        text = log.decode(errors="replace")
        if p.returncode != 0:
            errors.append(f"{name}: nvcc exited {p.returncode}\n{text}")
            continue
        build_logs[name] = text
        os.replace(tmp, out)             # atomic: never a half-written .so
        took[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    build_seconds.update(took)
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            fn = getattr(lib, name)
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib
