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

import contextlib
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

__all__ = ["library", "check", "build_dir", "device_guard", "sm_count", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P, _I = ctypes.c_void_p, ctypes.c_int
_N = ctypes.POINTER(_I)
_NL = ctypes.POINTER(ctypes.c_longlong)
# C entry points: name -> argument types.  Every entry returns the
# cudaError_t of its launches as an int (0 = success); ebv_lu_fused,
# ebv_solve_vmem, ebv_solve_tiled, ebv_solve_inverted, the ebv_band_* and
# ebv_batched_* entries, ebv_legacy_walk and ebv_legacy_fused_step also
# report how many kernels they launched, through their last argument or,
# for ebv_solve_tiled and ebv_solve_inverted, the one before it (the last
# reports the most blocks a step's grid takes).
_SIGNATURES = {
    "ebv_lu_fused": [_P, _I, _I, _P, _I, _I, _I, _P, _N],
    "ebv_solve_vmem": [_P] * 4 + [_I] * 6 + [_P, _N, _N],
    "ebv_solve_tiled": [_P] * 4 + [_I] * 4 + [_P, _N, _NL],
    "ebv_solve_inverted": [_P] * 6 + [_I] * 4 + [_P, _N, _NL],
    "ebv_band_lu_resident": [_P, _I, _I, _N, _P, _N],
    "ebv_band_lu_steps": [_P, _I, _I, _I, _I, _I, _I, _N, _P, _N],
    "ebv_band_lu_scalar": [_P, _I, _I, _N, _P, _N],
    "ebv_band_solve": [_P, _P, _P] + [_I] * 9 + [_N, _P, _N],
    "ebv_band_solve_inverted": [_P] * 9 + [_I] * 5 + [_P, _N],
    "ebv_batched_lu": [_P, _I, _I, _N, _P, _N],
    "ebv_batched_cluster_room": [_N],
    "ebv_batched_solve_cluster_room": [_N],
    "ebv_batched_lu_solve": [_P, _P, _P] + [_I] * 6 + [_N, _P, _N],
    "ebv_batched_band_lu": [_P, _I, _I, _I, _N, _P, _N],
    "ebv_legacy_walk": [_P, _I, _I, _I, _I, _P, _P, _N, _N],
    "ebv_legacy_fused_step": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _N],
    "ebv_legacy_update": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ebv_paged_decode_attention": [_P] * 7 + [_I] * 9 + [ctypes.c_float, _I, _N, _P],
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


GRID_PAST_AXIS = 100_000  # a step of the dense solves past one grid axis (csrc/trsm.cu:kGridPastAxis)


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error: ``ValueError`` where a
    launch would need more blocks than one grid axis holds (nothing was
    launched), else ``RuntimeError``."""
    if code == GRID_PAST_AXIS:
        raise ValueError(f"{what}: a step needs more than 2^31 - 1 blocks, past one grid axis")
    if code:
        msg = library().ebv_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def device_guard(device: torch.device):
    """A context that makes the CUDA ``device`` current for a launch: none
    where it already is, since entering ``torch.cuda.device`` costs
    microseconds of host time a launch."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
