"""Tile-face helpers of the pool levels' flux registers.

Counterpart of `quokka_tpu.amr.pool_advance` ``:349-441`` for what the
packed engine uses: the tiles' own faces sliced from their padded face
arrays (`slice_tile_faces`), restricted to the parent's resolution
(`restrict_tile_faces`), and the reflux of a pool parent against its pool
child (`reflux_pool_parent`). The unpacked pool advance is not ported.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import tilepool as tp


def slice_tile_faces(F_pool: Dict[int, torch.Tensor], g: int,
                     tile_shape) -> Dict[int, torch.Tensor]:
    """Padded-face-coordinate per-tile fluxes -> the interior faces
    [0..t] inclusive along the flux axis, interior cells transversally."""
    out = {}
    for d, F in F_pool.items():
        idx = [slice(None), slice(None)]
        for e in range(3):
            t = tile_shape[e]
            idx.append(slice(g, g + t + 1) if e == d else slice(g, g + t))
        out[d] = F[tuple(idx)]
    return out


def restrict_tile_faces(F_faces: Dict[int, torch.Tensor],
                        active_axes) -> Dict[int, torch.Tensor]:
    """Per-tile fine face fluxes (faces [0..t] along d) at the parent's
    resolution: the even faces along d, 2 x 2 transverse averages
    (`ops.restrict_face_flux` without the padding)."""
    out = {}
    for d, F in F_faces.items():
        cur = F
        for e in active_axes:
            ax = cur.dim() - 3 + e
            n = cur.shape[ax]
            if e == d:
                sub = [slice(None)] * cur.dim()
                sub[ax] = slice(0, n, 2)
                cur = cur[tuple(sub)]
            else:
                shape = list(cur.shape)
                cur = cur.reshape(shape[:ax] + [n // 2, 2] + shape[ax + 1:]).mean(dim=ax + 1)
        out[d] = cur
    return out


def _pad_cov_1(covf: torch.Tensor, nbr: torch.Tensor, tile_shape) -> torch.Tensor:
    """Per-tile coverage [T, tx, ty, tz] padded by one cell through the
    neighbour table (False where no neighbour tile exists;
    `tilepool.fill_pool_ghosts_like(cov, nbr, 1)`)."""
    T = covf.shape[0]
    out = torch.zeros((T,) + tuple(t + 2 for t in tile_shape), dtype=covf.dtype,
                      device=covf.device)
    out[:, 1:-1, 1:-1, 1:-1] = covf
    for q, d3 in enumerate(tp.DIRS):
        src, dst = tp._region(tile_shape, 1, d3)
        idx = nbr[:, q].to(torch.int64)
        got = covf.index_select(0, torch.clamp(idx, min=0))[(slice(None),) + src]
        ok = (idx >= 0).reshape(T, 1, 1, 1)
        out[(slice(None),) + dst] = torch.where(ok, got, out[(slice(None),) + dst])
    return out


def reflux_pool_parent(U_parent: torch.Tensor, F_crse: Dict[int, torch.Tensor],
                       F_fine: Dict[int, torch.Tensor], child_slots: torch.Tensor,
                       parent_nbr: torch.Tensor, dt_c, dx, tile_shape) -> torch.Tensor:
    """The coarse-fine flux mismatch applied to the uncovered parent-tile
    cells (reference `YAFluxRegister::Reflux`): boundary faces are those
    where the child coverage flips across the face, the coverage padded by
    one cell across tile boundaries through the neighbour table.
    F_crse[d]: the parent tiles' own faces [0..t]; F_fine[d]: the
    children's restricted fluxes on the parent faces."""
    covf = tp.coverage_cells(child_slots, tile_shape)
    cp = _pad_cov_1(covf, parent_nbr, tile_shape)
    corr = None
    for d in sorted(F_crse):
        t = tile_shape[d]
        lo = [slice(1, 1 + tile_shape[e]) for e in range(3)]
        hi = list(lo)
        lo[d] = slice(0, t + 1)
        hi[d] = slice(1, t + 2)
        boundary = cp[(slice(None),) + tuple(lo)] != cp[(slice(None),) + tuple(hi)]
        dF = torch.where(boundary[:, None], F_fine[d] - F_crse[d], 0.0)
        n = dF.shape[2 + d]
        # dt_c / dx in the state's dtype, as the JAX program divides a
        # dtype scalar by a Python float
        npdt = np.float32 if U_parent.dtype == torch.float32 else np.float64
        factor = float(npdt(dt_c) / npdt(dx[d]))
        contrib = (dF.narrow(2 + d, 0, n - 1) - dF.narrow(2 + d, 1, n - 1)) * factor
        corr = contrib if corr is None else corr + contrib
    nc = corr.shape[1]
    if nc < U_parent.shape[1]:
        corr = torch.cat([corr, corr.new_zeros((corr.shape[0], U_parent.shape[1] - nc,
                                                *corr.shape[2:]))], dim=1)
    return U_parent + torch.where(covf[:, None], 0.0, corr)
