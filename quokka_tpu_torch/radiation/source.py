"""Matter-coupling kernel K5: wrappers and plain versions.

Counterpart of `quokka_tpu.radiation.pallas_source.source_update_pallas`.
The plain version is `source_terms.add_source_terms_single_group`, called
with the problem's opacity hooks; a wrapper takes it for a CPU tensor and
launches the CUDA kernel (``csrc/rad_source.cu``) for a CUDA tensor, which
evaluates the problem's `PowerLawOpacity` laws per cell.

Two entry points share the one kernel:

- `source_update`: the unigrid (and dense-level) state [10, X, Y, Z];
- `source_update_batched`: the packed AMR engine's chunk, B blocks whose
  gas [B, 6, X, Y, Z] and radiation [B, 4, X, Y, Z] are two views (a crop
  of a larger block is one), with an optional per-cell keep mask and
  output views to write into; the kernel reads and writes them where they
  lie.
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


def check_coupling(opts: RadOptions, eos, rad_start: int, kernel: str) -> None:
    """What the CUDA matter coupling (`kernel`: K4, K5) takes beyond the
    layout: one photon group first (a G-group state would otherwise read
    as passive scalars), a gamma-law EOS, beta_order 0 or 1, no scalars."""
    if opts.n_groups != 1:
        raise NotImplementedError(
            f"{kernel} takes one photon group, got radiation n_groups = {opts.n_groups}")
    if eos.is_isothermal:
        raise NotImplementedError("the CUDA radiation coupling needs a gamma-law EOS")
    if opts.mixed_precision_coupling:
        raise NotImplementedError("radiation.mixed_precision_coupling is not ported yet")
    if opts.beta_order not in (0, 1):
        raise NotImplementedError(f"beta_order {opts.beta_order}: the coupling takes 0 or 1")
    if rad_start != RAD_START:
        raise NotImplementedError("the CUDA radiation kernels take no passive scalars")


class _View5(ctypes.Structure):
    """``struct View5`` of csrc/rad_source.cu: a [B, C, X, Y, Z] view with
    unit z stride, by its data pointer and its other strides (elements)."""

    _fields_ = [("p", ctypes.c_void_p)] + [(n, ctypes.c_longlong)
                                          for n in ("sb", "sc", "sx", "sy")]


class _SourceViews(ctypes.Structure):
    """``struct SourceViews`` of csrc/rad_source.cu, same field order."""

    _fields_ = [(n, _View5) for n in ("gas", "rad", "gas_out", "rad_out", "src")] + [
        ("keep", ctypes.c_void_p)] + [(n, ctypes.c_longlong) for n in "BXYZ"]


def _view5(t: torch.Tensor | None, name: str) -> _View5:
    """The kernel's view of a [B, C, X, Y, Z] (or, for the source, [B, X, Y,
    Z]) float32 tensor; z must be contiguous."""
    if t is None:
        return _View5(None, 0, 0, 0, 0)
    if t.dtype != torch.float32:
        raise TypeError(f"the CUDA radiation kernels take float32, got {t.dtype} ({name})")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the CUDA matter coupling reads z contiguously")
    st = t.stride()
    if t.dim() == 4:  # the source: no component axis
        return _View5(t.data_ptr(), st[0], 0, st[1], st[2])
    return _View5(t.data_ptr(), *st[:4])


def _check_batched(gas, rad, rad_src, keep, out):
    if gas.dim() != 5 or gas.shape[1] != RAD_START:
        raise NotImplementedError(
            f"the gas blocks are [B, {RAD_START}, X, Y, Z], got {tuple(gas.shape)}")
    B = gas.shape[0]
    spatial = tuple(gas.shape[2:])
    if tuple(rad.shape) != (B, 4) + spatial:
        raise NotImplementedError(
            f"the radiation blocks are [B, 4, X, Y, Z] beside the gas, got {tuple(rad.shape)}")
    if rad_src is not None and tuple(rad_src.shape) != (B,) + spatial:
        raise ValueError(f"rad_src has shape {tuple(rad_src.shape)}, expected {(B,) + spatial}")
    if keep is not None:
        if tuple(keep.shape) != (B,) + spatial or keep.dtype != torch.bool:
            raise ValueError(f"keep must be bool [B, X, Y, Z], got {keep.dtype} "
                             f"{tuple(keep.shape)}")
    if out is not None and (tuple(out[0].shape) != tuple(gas.shape)
                            or tuple(out[1].shape) != tuple(rad.shape)):
        raise ValueError("out holds (gas, radiation) tensors of the inputs' shapes")


def source_update_batched_plain(gas, rad, rad_src, dt: float, stage: int,
                                opts: RadOptions, eos, problem, rad_start: int, *,
                                keep=None, out=None):
    """Plain version of the batched K5: the state [B, 10, X, Y, Z] put
    together, folded into one [10, B X, Y, Z] state for `source_update_plain`
    (the coupling is pointwise, so the folded call equals the blocks' calls
    one by one), the cells outside `keep` taken from the input, and the
    result written into `out` (gas, radiation) or into new tensors."""
    _check_batched(gas, rad, rad_src, keep, out)
    Ub = torch.cat([gas, rad], dim=1)
    B, nv, X, Y, Z = Ub.shape
    Uf = Ub.transpose(0, 1).reshape(nv, B * X, Y, Z)
    rf = None if rad_src is None else rad_src.reshape(B * X, Y, Z)
    U2 = source_update_plain(Uf, rf, dt, stage, opts, eos, problem, rad_start)
    U2 = U2.reshape(nv, B, X, Y, Z).transpose(0, 1)
    if keep is not None:
        U2 = torch.where(keep[:, None], U2, Ub)
    if out is None:
        return U2[:, :rad_start].contiguous(), U2[:, rad_start:].contiguous()
    out[0].copy_(U2[:, :rad_start])
    out[1].copy_(U2[:, rad_start:])
    return out


def _launch(views: _SourceViews, dt: float, stage: int, opts, eos, problem,
            rad_start: int, like: torch.Tensor):
    from .._cuda import check, library

    lib = library()
    check_coupling(opts, eos, rad_start, "K5")
    if views.X * views.Y * views.Z >= 2**31 or views.B > 65535:
        raise ValueError("the CUDA matter coupling takes < 2^31 cells a block and "
                         "<= 65535 blocks")
    params = rad_params(opts, (1.0, 1.0, 1.0), eos, problem.opacity_laws())
    err = lib.qk_rad_source(ctypes.addressof(views), dt, stage, ctypes.addressof(params),
                            _stream(like))
    check(err, "rad_source")
    launch_counts["rad_source"] += 1


def source_update_batched(gas, rad, rad_src, dt: float, stage: int, opts: RadOptions,
                          eos, problem, rad_start: int, *, keep=None, out=None):
    """K5 over B blocks (the packed engine's chunk): gas [B, 6, X, Y, Z] and
    radiation [B, 4, X, Y, Z] views (z contiguous; any other strides),
    `rad_src` [B, X, Y, Z] or None, `keep` bool [B, X, Y, Z] or None (where
    False the input is copied and no Newton runs). Writes into `out` = (gas,
    radiation) views of the same shapes, or new tensors; returns them."""
    if not _on_cuda(gas):
        return source_update_batched_plain(gas, rad, rad_src, dt, stage, opts, eos, problem,
                                           rad_start, keep=keep, out=out)
    _check_batched(gas, rad, rad_src, keep, out)
    for t in (rad, rad_src, keep) + tuple(out or ()):
        if t is not None and t.device != gas.device:
            raise ValueError(f"tensor on {t.device}, expected {gas.device}")
    if keep is not None and not keep.is_contiguous():
        raise ValueError("keep must be contiguous")
    if out is None:
        out = (torch.empty(gas.shape, dtype=gas.dtype, device=gas.device),
               torch.empty(rad.shape, dtype=rad.dtype, device=rad.device))
    B, _, X, Y, Z = gas.shape
    views = _SourceViews(_view5(gas, "gas"), _view5(rad, "radiation"),
                         _view5(out[0], "gas out"), _view5(out[1], "radiation out"),
                         _view5(rad_src, "rad_src"),
                         None if keep is None else keep.data_ptr(), B, X, Y, Z)
    _launch(views, dt, stage, opts, eos, problem, rad_start, gas)
    return out


def source_update(U, rad_src, dt: float, stage: int, opts: RadOptions, eos,
                  problem, rad_start: int):
    """K5 (`pallas_source.source_update_pallas`): the matter-coupling
    update of stage `stage` (1 or 2) of a substep of length `dt` (a float
    rounded to the state's dtype). `rad_src` [X, Y, Z] or None (no
    source). Returns the new state: on the card the batched kernel's B = 1
    case."""
    if not _on_cuda(U):
        return source_update_plain(U, rad_src, dt, stage, opts, eos, problem, rad_start)
    # pointwise: any extent (a 1D or 2D box's state too)
    check_kernel_inputs(opts, 4 + RAD_START, U, rad_src, kernel="K5", min_extent=1)
    out = torch.empty_like(U)
    views = _SourceViews(_view5(U[None, :RAD_START], "gas"),
                         _view5(U[None, RAD_START:], "radiation"),
                         _view5(out[None, :RAD_START], "gas out"),
                         _view5(out[None, RAD_START:], "radiation out"),
                         _view5(None if rad_src is None else rad_src[None], "rad_src"),
                         None, 1, *U.shape[1:])
    _launch(views, dt, stage, opts, eos, problem, rad_start, U)
    return out
