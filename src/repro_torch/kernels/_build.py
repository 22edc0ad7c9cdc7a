"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/*.cu`` compiles to its own object (all ``nvcc`` processes run
at once), and the objects link into one shared library with a plain C
interface.  The library's name carries a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads at once.  The output
goes to ``build/repro_torch/`` at the root of the checkout, which
``.gitignore`` lists.  Nothing here runs at import time: the first kernel
call builds.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

__all__ = ["library", "check", "build_dir", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P, _I = ctypes.c_void_p, ctypes.c_int
_N = ctypes.POINTER(_I)
# C entry points: name -> argument types.  Every entry returns the
# cudaError_t of its launches as an int (0 = success); ebv_lu_fused and the
# ebv_band_* entries also report through their last argument how many
# kernels they launched.
_SIGNATURES = {
    "ebv_lu_fused": [_P, _I, _I, _P, _N],
    "ebv_solve_vmem": [_P, _P, _P, _I, _I, _I, _I, _P],
    "ebv_solve_tiled": [_P, _P, _P, _I, _I, _I, _I, _P],
    "ebv_solve_inverted": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ebv_band_lu_resident": [_P, _I, _I, _P, _N],
    "ebv_band_lu_steps": [_P, _I, _I, _I, _P, _N],
    "ebv_band_solve": [_P, _P, _P, _I, _I, _I, _I, _P, _N],
    "ebv_band_solve_inverted": [_P] * 9 + [_I] * 4 + [_P, _N],
}


def build_dir() -> str:
    """``build/repro_torch`` at the root of the checkout."""
    return os.path.join(os.path.dirname(os.path.dirname(_PKG)), "build", "repro_torch")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _digest(sources: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(sources: list[str], target: str) -> None:
    nvcc = _nvcc()
    out = build_dir()
    os.makedirs(out, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                errors.append(f"{os.path.basename(src)}:\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib = os.path.join(tmp, os.path.basename(target))
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", lib],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(lib, target)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            sources = _sources()
            target = os.path.join(build_dir(), f"librepro_torch_{_digest(sources)}.so")
            if not os.path.exists(target):
                _compile(sources, target)
            lib = ctypes.CDLL(target)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ebv_error_string.argtypes = [ctypes.c_int]
            lib.ebv_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code:
        msg = library().ebv_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
