"""Fused substep kernel K4: wrapper and plain version.

Counterpart of `quokka_tpu.radiation.pallas_substep.fused_substep_pallas`:
one IMEX PD-ARS radiation substep of the periodic single-group f32 state
as two stages (``csrc/rad_substep.cu``), each the three-axis transport
divergence (one tiled pass an axis: each face solved once, from a
shared-memory tile), then, one thread a cell, the predict (stage 1) or
combine (stage 2) with `amend_rad_state` and the implicit matter
coupling. The plain version is the composition of plain K6 over three
axes, `predict_step` / `add_fluxes_rk2` and plain K5, in the JAX kernels'
order.
"""

from __future__ import annotations

import ctypes

import torch

from ..hydro.sweep import _on_cuda, _stream
from .source import RAD_START, check_coupling, source_update_plain
from .sweep import check_kernel_inputs, launch_counts, rad_div_plain, rad_params
from .system import RadOptions, add_fluxes_rk2, predict_step


# csrc/rad_common.cuh `transport_axis_tile` (K4's transport passes and K6):
# a block of K4_THREADS threads owns a tile of K4_TILE_ALONG cells along the
# axis by K4_TILE_ACROSS lines
K4_TILE_ALONG = 32
K4_TILE_ACROSS = 16
K4_THREADS = 256
K4_SMEM_MAX = 48 * 1024  # the static shared memory a block can take


def k4_smem_bytes() -> int:
    """Shared-memory bytes of a block of K4's transport and of K6
    (`qk_rad_stage_smem` of csrc/rad_substep.cu): the conserved values and
    the primitives (then the fluxes) of the staged cells [2][4][(TA + 6)
    TW], and the face states of the reconstructed cells [2][4][(TA + 2)
    TW]."""
    ta, tw = K4_TILE_ALONG, K4_TILE_ACROSS
    return 4 * (2 * 4 * (ta + 6) * tw + 2 * 4 * (ta + 2) * tw)


def _div3_plain(R, opts, dx):
    out = None
    for d in range(3):
        contrib = rad_div_plain(R, d, opts, dx[d])
        out = contrib if out is None else out + contrib
    return out


def stage1_plain(U, rad_src, dt: float, opts: RadOptions, eos, problem, dx,
                 counts: dict | None = None):
    """Plain version of the stage-1 kernel: returns (U1, divF0[G,4,...])."""
    rs = RAD_START
    R0 = U[rs:].reshape(1, 4, *U.shape[1:])
    div0 = _div3_plain(U[rs:], opts, dx)
    R1 = predict_step(R0, div0, dt, opts)
    U1 = torch.cat([U[:rs], R1.reshape(4, *U.shape[1:])])
    return source_update_plain(U1, rad_src, dt, 1, opts, eos, problem, rs, counts), div0


def stage2_plain(U1, R0, div0, rad_src, dt: float, opts: RadOptions, eos,
                 problem, dx, counts: dict | None = None):
    """Plain version of the stage-2 kernel: returns U2."""
    rs = RAD_START
    shape = U1.shape[1:]
    div1 = _div3_plain(U1[rs:], opts, dx)
    R2 = add_fluxes_rk2(R0.reshape(1, 4, *shape), U1[rs:].reshape(1, 4, *shape),
                        div0, div1, dt, opts)
    U2 = torch.cat([U1[:rs], R2.reshape(4, *shape)])
    return source_update_plain(U2, rad_src, dt, 2, opts, eos, problem, rs, counts)


def fused_stage1(U, rad_src, dt: float, opts: RadOptions, eos, problem, dx):
    """K4 stage-1 kernel (pallas_substep.py `k1`): (U1, divF0)."""
    if not _on_cuda(U):
        return stage1_plain(U, rad_src, dt, opts, eos, problem, dx)
    from .._cuda import check, library

    lib = library()
    check_coupling(opts, eos, U.shape[0] - 4, "K4")  # passive scalars raise
    check_kernel_inputs(opts, 4 + RAD_START, U, rad_src, kernel="K4")
    params = rad_params(opts, dx, eos, problem.opacity_laws())
    X, Y, Z = U.shape[1:]
    U1 = torch.empty_like(U)
    div0 = torch.empty((1, 4, X, Y, Z), dtype=U.dtype, device=U.device)
    err = lib.qk_rad_stage1(U.data_ptr(), None if rad_src is None else rad_src.data_ptr(),
                            U1.data_ptr(), div0.data_ptr(), X, Y, Z, dt,
                            ctypes.addressof(params), _stream(U))
    check(err, "rad_stage1")
    launch_counts["rad_stage1"] += 1
    return U1, div0


def fused_stage2(U1, R0, div0, rad_src, dt: float, opts: RadOptions, eos,
                 problem, dx):
    """K4 stage-2 kernel (pallas_substep.py `k2`): U2 from U1, the
    substep's initial radiation block R0 [4, ...] and divF0."""
    if not _on_cuda(U1):
        return stage2_plain(U1, R0, div0, rad_src, dt, opts, eos, problem, dx)
    from .._cuda import check, library

    lib = library()
    check_coupling(opts, eos, U1.shape[0] - 4, "K4")  # passive scalars raise
    check_kernel_inputs(opts, 4 + RAD_START, U1, R0, div0, rad_src, kernel="K4")
    if R0.shape[0] != 4 or div0.numel() != R0.numel():
        raise ValueError("R0 and divF0 hold the 4 radiation components")
    params = rad_params(opts, dx, eos, problem.opacity_laws())
    X, Y, Z = U1.shape[1:]
    U2 = torch.empty_like(U1)
    div1 = torch.empty_like(R0)  # the transport's output, read by the cell kernel
    err = lib.qk_rad_stage2(U1.data_ptr(), R0.data_ptr(), div0.data_ptr(), div1.data_ptr(),
                            None if rad_src is None else rad_src.data_ptr(),
                            U2.data_ptr(), X, Y, Z, dt, ctypes.addressof(params),
                            _stream(U1))
    check(err, "rad_stage2")
    launch_counts["rad_stage2"] += 1
    return U2


def fused_substep(U, rad_src, dt: float, opts: RadOptions, eos, problem, dx):
    """K4 (`pallas_substep.fused_substep_pallas`): one full radiation
    substep of the [10, X, Y, Z] state. `dt` is a float rounded to the
    state's dtype. Returns U2."""
    U1, div0 = fused_stage1(U, rad_src, dt, opts, eos, problem, dx)
    return fused_stage2(U1, U[RAD_START:], div0, rad_src, dt, opts, eos, problem, dx)
