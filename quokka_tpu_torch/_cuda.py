"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels are compiled at first use with ``nvcc`` into one shared library
with a plain C interface, loaded through ``ctypes``. The library lands in
``_build/`` beside this file, named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads at once.

Flags: ``sm_90a`` (Hopper), ``-O3``, no fast math (IEEE division and
``sqrtf``), and ``-fmad=false``: each product and sum rounds on its own, as
each PyTorch op of the plain versions does, which keeps the kernels within
a few ulps of their plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
build_info: dict = {}

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "qk_transverse": [_P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _I,
                      _F, _F, _F, _F, _I, _P],
    "qk_axis_flux": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I,
                     _I, _I, _F, _F, _F, _F, _F, _I, _P],
    "qk_axis_div": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _I,
                    _I, _F, _P],
    "qk_apply": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L,
                 _F, _F, _F, _F, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                           "the CUDA kernels cannot be built")
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    so = BUILD_DIR / f"libquokka_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        so.with_suffix(".log").write_text(" ".join(cmd) + "\n" + log)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {res.returncode}:\n{log[-6000:]}")
        os.replace(tmp, so)
        build_info.update(seconds=time.perf_counter() - t0, log=log, built=True)
    else:
        build_info.update(seconds=0.0, log=so.with_suffix(".log").read_text()
                          if so.with_suffix(".log").exists() else "", built=False)
    build_info["path"] = str(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
