"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc into its own shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: a build takes seconds).
Libraries go into the package's build directory on first use, so a fresh
checkout builds everything it runs. nvcc and the GPU exist only on the card's
machine: nothing here runs when a module is imported.

Numerics: `-fmad=false` keeps every multiply and add separately rounded, as
the plain PyTorch versions compute them (parity first; a later change may
allow contraction). No fast-math flags: divisions and square roots stay
IEEE-rounded.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

from .._paths import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = ("dense_intersect", "mega", "packet", "bvh", "pair_variants", "shade",
           "walk")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
]

_lock = threading.Lock()
_libs: dict = {}
_bound: set = set()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    """Missing, or older than its source or any shared header."""

    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(os.path.getmtime(d) for d in deps)


def _start(name: str) -> subprocess.Popen:
    """Start nvcc on csrc/<name>.cu; `-Xptxas -v` puts each kernel's
    registers, shared memory and spills into the captured output."""

    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v",
           "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(f"{_lib_path(name)}.{os.getpid()}.tmp", _lib_path(name))
    return out


def build_all() -> dict:
    """Compile every source, one nvcc process each, all started together.
    Returns {name: (seconds since the start, compiler output)}."""

    t0 = time.perf_counter()
    procs = {n: _start(n) for n in SOURCES}
    report = {}
    for n, p in procs.items():
        out = _finish(n, p)
        report[n] = (time.perf_counter() - t0, out)
    return report


def load(name: str, bind=None) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if stale. `bind`,
    the caller's declaration of the library's signatures (restype and
    argtypes), is applied once, where the library is opened (or first
    asked for with it)."""

    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                _finish(name, _start(name))
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        if bind is not None and name not in _bound:
            bind(lib)
            _bound.add(name)
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaGetLastError() code returned by a launch."""

    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc})")
