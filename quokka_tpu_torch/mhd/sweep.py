"""Constrained-transport MHD sweep kernel K8: wrapper and plain PyTorch
version.

Counterpart of `quokka_tpu.mhd.pallas_sweep.compute_mhd_axis_pallas`. For
one sweep axis of the periodic, unpadded state it takes the cell-centred
primitives [rho, vx, vy, vz, P, Bx, By, Bz] and the staggered normal field
on the axis's lo faces, and returns one [8, X, Y, Z] tensor:

  rows 0..4  (F(i-1/2) - F(i+1/2)) * (1/dx) in state order [rho, mx, my, mz, E]
  row  5     the lo-face mass flux (the corner-EMF upwinding input)
  row  6     F[by'], the canonical transverse-1 induction flux (-E_wax)
  row  7     F[bz'], the canonical transverse-2 induction flux (+E_vax)

`mhd_axis_plain` is the JAX kernel's body in PyTorch (PLM-minmod / PPM /
donor-cell faces, the density and pressure floors on the face states, the
full HLLD flux); `compute_mhd_axis` takes it for a CPU tensor at any dtype
and shape, and for a CUDA tensor launches the CUDA kernel
(``csrc/mhd_sweep.cu``) or raises for anything the kernel does not take
(float64, an extent < 4, a non-contiguous tensor, an order other than
1-3). `launch_counts` counts the launches.
"""

from __future__ import annotations

import torch

from ..hydro import reconstruct
from ..hydro.riemann import FaceState, hlld
from ..hydro.sweep import _on_cuda, _split, _stream
from ..stencil import sh

# canonical frames (axis -> (v_axis, w_axis)), as quokka_tpu.mhd.advance._FRAMES
_FRAMES = {0: (1, 2), 1: (2, 0), 2: (0, 1)}

launch_counts = {"mhd_axis": 0}

K8_LINES = 16  # lines of a K8 tile across the axis, at most (64 B of a row)
K8_FACES = 512  # faces of a K8 tile, at most (two a thread)
K8_SMEM_MAX = 48 * 1024  # bytes of shared memory a K8 block takes at most


def k8_tile(n: int, n_across: int):
    """(cells along the axis, lines across) of one tile of K8
    (``csrc/mhd_sweep.cu`` `mhd_tile_kernel`): at most K8_LINES lines
    across, split evenly, and as many cells along as keep the tile's ta + 1
    faces at or below K8_FACES, split evenly (29 x 16 at 256^3)."""
    tw = _split(n_across, min(n_across, K8_LINES))
    return _split(n, max(1, K8_FACES // tw - 1)), tw


def k8_smem_bytes(tile, order: int) -> int:
    """Shared-memory bytes of a K8 block (`qk_mhd_smem`): the 7 staged
    primitives of ta + 2 + 2g cells a line (g = 2, 1, 0 for PPM, PLM, donor
    cell), both face states of ta + 2 cells, and bxf at ta + 1 faces."""
    ta, tw = tile
    g = {3: 2, 2: 1, 1: 0}[order]
    return 4 * (7 * (ta + 2 + 2 * g) * tw + 14 * (ta + 2) * tw + (ta + 1) * tw)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _face_state(q: torch.Tensor, axis: int, opts) -> FaceState:
    """Canonical-frame MHD face state; the floors apply when they are > 0."""
    vax, wax = _FRAMES[axis]
    zero = torch.zeros_like(q[0])
    rho, P = q[0], q[4]
    if opts.density_floor > 0.0:
        rho = torch.clamp(rho, min=opts.density_floor)
    if opts.pressure_floor > 0.0:
        P = torch.clamp(P, min=opts.pressure_floor)
    return FaceState(rho=rho, u=q[1 + axis], v=q[1 + vax], w=q[1 + wax], P=P,
                     cs=zero, E=zero, Eint=zero, by=q[5 + vax], bz=q[5 + wax])


def mhd_axis_plain(prim: torch.Tensor, bxf: torch.Tensor, axis: int, opts,
                   counts: dict | None = None) -> torch.Tensor:
    """Plain version of K8 (the module docstring's row layout): the faces of
    the 8 primitives, then `hlld` with the staggered normal field `bxf`
    (single-valued at a face) for the canonical flux [rho, m_ax, m_vax,
    m_wax, E, 0, by', bz'] on the lo faces (roll semantics). `counts`, if
    given, accumulates the faces in each HLLD region and branch."""
    qL, qR = reconstruct.reconstruct_faces(prim, axis, opts.reconstruction_order)
    F = hlld(_face_state(qL, axis, opts), _face_state(qR, axis, opts), opts.gamma, bxf,
             counts)
    vax, wax = _FRAMES[axis]
    comps = {0: F[0], 1 + axis: F[1], 1 + vax: F[2], 1 + wax: F[3], 4: F[4]}
    rows = torch.stack([comps[i] for i in range(5)])
    div = (rows - sh(rows, 1, axis + 1)) * (1.0 / opts.dx[axis])
    return torch.cat([div, F[0][None], F[6][None], F[7][None]])


def compute_mhd_axis(prim: torch.Tensor, bxf: torch.Tensor, axis: int,
                     opts) -> torch.Tensor:
    """K8 (`pallas_sweep.compute_mhd_axis_pallas`): the [8, X, Y, Z] sweep
    output of `axis`."""
    if not _on_cuda(prim):
        return mhd_axis_plain(prim, bxf, axis, opts)
    from .._cuda import check, library

    if opts.reconstruction_order not in (1, 2, 3):
        raise ValueError(f"invalid reconstruction order {opts.reconstruction_order}")
    if prim.dim() != 4 or prim.shape[0] != 8:
        raise ValueError(f"K8 takes [8, X, Y, Z] primitives, got {tuple(prim.shape)}")
    if tuple(bxf.shape) != tuple(prim.shape[1:]):
        raise ValueError(f"face field shape {tuple(bxf.shape)} != {tuple(prim.shape[1:])}")
    if min(prim.shape[1:]) < 4:
        raise ValueError(f"every extent must be >= 4, got {tuple(prim.shape)}")
    for t in (prim, bxf):
        if t.device != prim.device:
            raise ValueError(f"tensor on {t.device}, expected {prim.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"K8 takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("K8 takes contiguous tensors")
    lib = library()
    X, Y, Z = prim.shape[1:]
    out = torch.empty_like(prim)
    gamma = opts.gamma
    ta, tw = k8_tile((X, Y, Z)[axis], Y if axis == 2 else Z)
    err = lib.qk_mhd_axis(prim.data_ptr(), bxf.data_ptr(), out.data_ptr(), X, Y, Z,
                          axis, opts.reconstruction_order, ta, tw, gamma, gamma - 1.0,
                          1.0 / opts.dx[axis], opts.density_floor, opts.pressure_floor,
                          _stream(prim))
    check(err, "mhd_axis")
    launch_counts["mhd_axis"] += 1
    return out
