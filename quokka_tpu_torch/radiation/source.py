"""Matter-coupling kernel K5: wrapper and plain version.

Counterpart of `quokka_tpu.radiation.pallas_source.source_update_pallas`.
The plain version is `source_terms.add_source_terms_single_group`, called
with the problem's opacity hooks; `source_update` takes it for a CPU tensor
and launches the CUDA kernel (``csrc/rad_source.cu``) for a CUDA tensor,
which evaluates the problem's `PowerLawOpacity` laws per cell.
"""

from __future__ import annotations

import ctypes

import torch

from ..hydro.sweep import _on_cuda, _stream
from .source_terms import add_source_terms_single_group
from .sweep import check_kernel_inputs, launch_counts, rad_params
from .system import RadOptions

RAD_START = 6  # the kernels' layout: 6 gas components, then E, Fx, Fy, Fz


def source_update_plain(U, rad_src, dt: float, stage: int, opts: RadOptions,
                        eos, problem, rad_start: int, counts: dict | None = None):
    """Plain version of K5."""
    return add_source_terms_single_group(
        U, rad_src, dt, stage, opts, eos, problem.compute_planck_opacity,
        problem.compute_energy_mean_opacity, problem.compute_flux_mean_opacity,
        rad_start, counts)


def check_coupling(opts: RadOptions, eos, rad_start: int) -> None:
    """What the CUDA matter coupling (K4, K5) takes beyond the layout."""
    if eos.is_isothermal:
        raise NotImplementedError("the CUDA radiation coupling needs a gamma-law EOS")
    if opts.mixed_precision_coupling:
        raise NotImplementedError("radiation.mixed_precision_coupling is not ported yet")
    if opts.beta_order not in (0, 1):
        raise NotImplementedError(f"beta_order {opts.beta_order}: the coupling takes 0 or 1")
    if rad_start != RAD_START:
        raise NotImplementedError("the CUDA radiation kernels take no passive scalars")


def source_update(U, rad_src, dt: float, stage: int, opts: RadOptions, eos,
                  problem, rad_start: int):
    """K5 (`pallas_source.source_update_pallas`): the matter-coupling
    update of stage `stage` (1 or 2) of a substep of length `dt` (a float
    rounded to the state's dtype). `rad_src` [X, Y, Z] or None (no
    source). Returns the new state."""
    if not _on_cuda(U):
        return source_update_plain(U, rad_src, dt, stage, opts, eos, problem, rad_start)
    from .._cuda import check, library

    lib = library()
    check_coupling(opts, eos, rad_start)
    check_kernel_inputs(opts, 4 + RAD_START, U, rad_src)
    params = rad_params(opts, (1.0, 1.0, 1.0), eos, problem.opacity_laws())
    out = torch.empty_like(U)
    err = lib.qk_rad_source(U.data_ptr(), None if rad_src is None else rad_src.data_ptr(),
                            out.data_ptr(), U[0].numel(), dt, stage,
                            ctypes.addressof(params), _stream(U))
    check(err, "rad_source")
    launch_counts["rad_source"] += 1
    return out
