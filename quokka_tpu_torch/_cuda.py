"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels are compiled at first use with ``nvcc`` into one shared library
with a plain C interface, loaded through ``ctypes``: one ``nvcc -c`` per
source, all started together, then one link. The library lands in
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
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lib = None
build_info: dict = {}

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "qk_transverse": [_P] * 11 + [_L, _L, _L, _L, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I,
                                  _I, _I, _P],
    "qk_transverse_smem": [_I, _I],
    # K2's entry points end with its form (csrc/sweep.cuh): the order, the
    # scalars and the mass scalars
    "qk_axis_flux": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _I, _I, _I,
                     _I, _I, _F, _I, _I, _F, _F, _F, _F, _I, _I, _I, _I, _P],
    "qk_axis_lean": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I,
                     _I, _I, _F, _F, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I, _I, _P],
    "qk_lean_smem": [_I, _I, _I],
    "qk_axis_sweep": [_P] * 17 + [_L, _L, _L, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                                  _F, _F, _F, _F, _I, _I, _I, _I, _P],
    "qk_apply": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L,
                 _F, _F, _F, _F, _I, _I, _P],
    # radiation kernels: the last pointer before the stream is a host
    # `RadParams` (radiation/sweep.py), copied into the launch by value
    "qk_rad_div": [_P, _P, _L, _L, _L, _I, _I, _I, _P, _P],
    "qk_rad_axis_flux": [_P, _P, _L, _L, _L, _L, _I, _P, _P],
    "qk_rad_source": [_P, _F, _I, _P, _P],  # a host `SourceViews` (radiation/source.py)
    "qk_rad_stage1": [_P, _P, _P, _P, _L, _L, _L, _F, _P, _P],
    "qk_rad_stage2": [_P, _P, _P, _P, _P, _P, _L, _L, _L, _F, _P, _P],
    "qk_rad_stage_smem": [],
    "qk_mhd_axis": [_P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P],
    "qk_mhd_smem": [_I, _I, _I],
    "qk_row_gather": [_P, _P, _P, _L, _L, _L, _P, _P, _P],
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    so = BUILD_DIR / f"libquokka_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        t0 = time.perf_counter()
        nvcc = _nvcc()
        jobs = []
        for src in sources:
            obj = BUILD_DIR / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = "", []
        for cmd, obj, proc in jobs:
            out, _ = proc.communicate()
            log += " ".join(cmd) + "\n" + out
            if proc.returncode != 0:
                failed.append(f"{Path(cmd[-1]).name} (code {proc.returncode})")
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        if not failed:
            cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            log += " ".join(cmd) + "\n" + res.stdout + res.stderr
            if res.returncode != 0:
                failed.append(f"link (code {res.returncode})")
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        so.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed: {failed}:\n{log[-6000:]}")
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
