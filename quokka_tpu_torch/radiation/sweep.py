"""Radiation transport kernels K6 and K7: wrappers, plain PyTorch
versions, and what the radiation kernels K4-K7 share (launch counts, the
kernels' constant block, input checks).

Counterparts of `quokka_tpu.radiation.pallas_sweep`:

- K6 `compute_rad_div_pallas`: the per-axis M1 transport divergence
  [G, 4, X, Y, Z] of the conserved radiation block of G photon groups
  (`compute_rad_div`, ``csrc/rad_sweep.cu``; plain version `rad_div_plain`);
- K7 `compute_rad_axis_flux_pallas`: the per-axis M1 face flux
  [G, 4, X, Y, Z] that the AMR flux registers consume
  (`compute_rad_axis_flux`, ``csrc/rad_axis_flux.cu``; plain version
  `rad_axis_flux_plain`).

Each wrapper takes its plain version for a CPU tensor and launches the CUDA
kernel for a CUDA tensor, and raises for anything the kernel does not take:
K4, K5 and K7 take one photon group, K6 any number.

`launch_counts` counts kernel launches of K4 (both stage kernels), K5, K6
and K7, so a run can show that it went through them.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..hydro import reconstruct
from ..hydro.sweep import _on_cuda, _stream
from ..stencil import sh
from .system import RadOptions, _hll_group_flux, rad_cons_to_prim

launch_counts = {"rad_div": 0, "rad_source": 0, "rad_stage1": 0, "rad_stage2": 0,
                 "rad_axis_flux": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


class _Opacity(ctypes.Structure):
    _fields_ = [("k0", ctypes.c_float), ("rho_exp", ctypes.c_float),
                ("T_exp", ctypes.c_float)]


class RadParams(ctypes.Structure):
    """The kernels' constant block (``struct RadParams`` of
    csrc/rad_common.cuh, same field order). Each float is a double
    expression rounded once, as a Python float meeting an f32 tensor is."""

    _fields_ = [(n, ctypes.c_float) for n in (
        "c", "chat", "chat_over_c", "chat_times_c", "cscale", "c_times_chat",
        "c_sq", "arad", "four_arad", "erad_floor", "c_v", "resid_tol",
        "lag_tol", "work_rtol")] + [
        ("inv_dx", ctypes.c_float * 3), ("kP", _Opacity), ("kE", _Opacity),
        ("kF", _Opacity), ("beta_order", ctypes.c_int),
        ("include_work", ctypes.c_int), ("recon_order", ctypes.c_int)]


def rad_params(opts: RadOptions, dx: Sequence[float], eos=None, laws=None) -> RadParams:
    """RadParams for the kernels; `eos` and `laws` (Planck, energy-mean,
    flux-mean `PowerLawOpacity`) are needed by the matter coupling only."""
    from .source_terms import LAG_TOL, resid_tol

    c, chat = opts.c, opts.chat
    p = RadParams(c=c, chat=chat, chat_over_c=chat / c, chat_times_c=chat * c,
                  cscale=c / chat, c_times_chat=c * chat, c_sq=c * c,
                  arad=opts.arad, four_arad=4.0 * opts.arad,
                  erad_floor=opts.erad_floor / opts.n_groups,
                  c_v=0.0 if eos is None else eos.c_v,
                  resid_tol=resid_tol(torch.float32), lag_tol=LAG_TOL,
                  work_rtol=1.0e-8, beta_order=opts.beta_order,
                  include_work=int(opts.include_work_term),
                  recon_order=opts.reconstruction_order)
    for d in range(3):
        p.inv_dx[d] = 1.0 / dx[d]
    if laws is not None:
        for name, law in zip(("kP", "kE", "kF"), laws):
            setattr(p, name, _Opacity(law.kappa0, law.rho_exp, law.T_exp))
    return p


def check_kernel_inputs(opts: RadOptions, shape0: int, *tensors, kernel: str,
                        groups: bool = False, min_extent: int = 4) -> None:
    """What every radiation kernel takes: float32, contiguous [shape0, X, Y,
    Z] tensors on one device with extents >= `min_extent` (4: a transport
    tile's periodic halo; 1 for the pointwise coupling), and one photon group
    unless `groups` (K6 alone takes G groups)."""
    if opts.n_groups != 1 and not groups:
        raise NotImplementedError(
            f"{kernel} takes one photon group, got radiation n_groups = {opts.n_groups} "
            "(multigroup runs the plain coupling and K6 over its groups)")
    if opts.use_wavespeed_correction:
        raise NotImplementedError("radiation.wavespeed_correction is not ported yet")
    if opts.reconstruction_order not in (1, 2, 3):
        raise ValueError(f"invalid reconstruction order {opts.reconstruction_order}")
    ref = tensors[0]
    if ref.dim() != 4 or ref.shape[0] != shape0:
        raise NotImplementedError(
            f"the CUDA radiation kernel takes a [{shape0}, X, Y, Z] tensor, got "
            f"{tuple(ref.shape)}")
    if min(ref.shape[1:]) < min_extent:
        raise ValueError(f"every extent must be >= {min_extent}, got {tuple(ref.shape)}")
    for t in tensors:
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"tensor on {t.device}, expected {ref.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA radiation kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA radiation kernels take contiguous tensors")
        if tuple(t.shape[-3:]) != tuple(ref.shape[1:]):
            raise ValueError(f"spatial shape {tuple(t.shape[-3:])} != "
                             f"{tuple(ref.shape[1:])}")


def _prim_flat(cons_flat: torch.Tensor, opts: RadOptions) -> torch.Tensor:
    """(E, f = F / (c E)) of the conserved block [4G, X, Y, Z]."""
    nv, *bs = cons_flat.shape
    return rad_cons_to_prim(cons_flat.reshape(opts.n_groups, 4, *bs),
                            opts.c).reshape(nv, *bs)


def rad_axis_flux_plain(cons_flat: torch.Tensor, axis: int,
                        opts: RadOptions) -> torch.Tensor:
    """Plain version of K7: the HLL face flux along `axis` of the conserved
    block [4G, X, Y, Z] (roll semantics), [G, 4, X, Y, Z], slot f the face
    between cells f-1 and f."""
    G = opts.n_groups
    nv, *bs = cons_flat.shape
    qL, qR = reconstruct.reconstruct_faces(_prim_flat(cons_flat, opts), axis,
                                           opts.reconstruction_order)
    cL = sh(cons_flat, -1, axis + 1).reshape(G, 4, *bs)
    cR = cons_flat.reshape(G, 4, *bs)
    qL = qL.reshape(G, 4, *bs)
    qR = qR.reshape(G, 4, *bs)
    return torch.stack([_hll_group_flux(qL[g], qR[g], cL[g], cR[g], axis, opts)
                        for g in range(G)])


def compute_rad_axis_flux(cons_flat: torch.Tensor, axis: int,
                          opts: RadOptions) -> torch.Tensor:
    """K7 (`pallas_sweep.compute_rad_axis_flux_pallas`): the face flux of
    `axis`, [G, 4, X, Y, Z]. On a CUDA tensor it launches the kernel or
    raises: one group, float32 (else TypeError), no wavespeed correction."""
    if not _on_cuda(cons_flat):
        return rad_axis_flux_plain(cons_flat, axis, opts)
    return compute_rad_axis_flux_batched(cons_flat[None], axis, opts)[0]


def compute_rad_axis_flux_batched(cons5: torch.Tensor, axis: int,
                                  opts: RadOptions) -> torch.Tensor:
    """K7 over a batch of radiation blocks [B, 4, X, Y, Z] (B = 1 for one
    block; the packed AMR engine's chunks of ghost-padded blocks, over which
    the JAX package vmaps its flux function): [B, 1, 4, X, Y, Z], one launch
    on a CUDA tensor, the plain version block by block on the CPU."""
    if not _on_cuda(cons5):
        return torch.stack([rad_axis_flux_plain(c, axis, opts) for c in cons5])
    from .._cuda import check, library

    lib = library()
    if cons5.dim() != 5:
        raise ValueError(f"expected [B, 4, X, Y, Z] blocks, got {tuple(cons5.shape)}")
    check_kernel_inputs(opts, 4, cons5[0], cons5, kernel="K7")
    B, _, X, Y, Z = cons5.shape
    if 4 * X * Y * Z >= 2**31 or B >= 2**16:
        raise ValueError(f"K7 takes blocks of 4 X Y Z < 2^31 values, B < 65536; got "
                         f"{tuple(cons5.shape)}")
    params = rad_params(opts, (1.0, 1.0, 1.0))
    out = torch.empty((B, 1, 4, X, Y, Z), dtype=cons5.dtype, device=cons5.device)
    err = lib.qk_rad_axis_flux(cons5.data_ptr(), out.data_ptr(), X, Y, Z, B, axis,
                               ctypes.addressof(params), _stream(cons5))
    check(err, "rad_axis_flux")
    launch_counts["rad_axis_flux"] += 1
    return out


def rad_div_plain(cons_flat: torch.Tensor, axis: int, opts: RadOptions,
                  dx_axis: float, acc: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K6: (F(f) - F(f+1)) * (1/dx) along `axis` of the
    conserved block [4G, X, Y, Z], with roll (periodic) semantics.
    Returns [G, 4, X, Y, Z], or adds it onto `acc` [G, 4, X, Y, Z] in place
    and returns `acc`."""
    G = opts.n_groups
    nv, *bs = cons_flat.shape
    ax = axis + 1
    consg = cons_flat.reshape(G, 4, *bs)
    E = consg[:, 0:1]
    prim = torch.cat([E, consg[:, 1:4] / (opts.c * E)], dim=1).reshape(nv, *bs)
    qL, qR = reconstruct.reconstruct_faces(prim, axis, opts.reconstruction_order)
    cL = sh(cons_flat, -1, ax).reshape(G, 4, *bs)
    qLg = qL.reshape(G, 4, *bs)
    qRg = qR.reshape(G, 4, *bs)
    F = torch.stack([_hll_group_flux(qLg[g], qRg[g], cL[g], consg[g], axis, opts)
                     for g in range(G)]).reshape(nv, *bs)
    div = ((F - sh(F, 1, ax)) * (1.0 / dx_axis)).reshape(G, 4, *bs)
    return div if acc is None else acc.add_(div)


def compute_rad_div(cons_flat: torch.Tensor, axis: int, opts: RadOptions,
                    dx_axis: float, acc: torch.Tensor | None = None) -> torch.Tensor:
    """K6 (`pallas_sweep.compute_rad_div_pallas`): the divergence
    contribution of `axis` of the conserved block [4G, X, Y, Z], [G, 4, X,
    Y, Z]; with `acc` [G, 4, X, Y, Z] added onto it in place (one launch
    either way, every group in it) and `acc` returned."""
    if not _on_cuda(cons_flat):
        return rad_div_plain(cons_flat, axis, opts, dx_axis, acc)
    from .._cuda import check, library

    lib = library()
    G = opts.n_groups
    check_kernel_inputs(opts, 4 * G, cons_flat, acc, kernel="K6", groups=True)
    X, Y, Z = cons_flat.shape[1:]
    if 4 * G * X * Y * Z >= 2**31:
        raise ValueError(f"K6 takes fewer than 2^31 values, got {G} groups of "
                         f"{(4, X, Y, Z)}")
    if acc is not None:
        if tuple(acc.shape) != (G, 4, X, Y, Z):
            raise ValueError(f"acc has shape {tuple(acc.shape)}, expected {(G, 4, X, Y, Z)}")
        if acc.untyped_storage().data_ptr() == cons_flat.untyped_storage().data_ptr():
            raise ValueError("acc must not share memory with the state K6 reads")
    dx = [1.0, 1.0, 1.0]
    dx[axis] = dx_axis
    params = rad_params(opts, dx)
    out = acc
    if out is None:
        out = torch.empty((G, 4, X, Y, Z), dtype=cons_flat.dtype, device=cons_flat.device)
    err = lib.qk_rad_div(cons_flat.data_ptr(), out.data_ptr(), X, Y, Z, G, axis,
                         int(acc is None), ctypes.addressof(params), _stream(cons_flat))
    check(err, "rad_div")
    launch_counts["rad_div"] += 1
    return out
