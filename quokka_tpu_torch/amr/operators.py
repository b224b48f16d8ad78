"""Inter-level grid operators: restriction, prolongation, mask morphology,
and the face-flux masking and restriction of the flux registers.

Counterpart of `quokka_tpu.amr.operators` (AMReX's coarse-fine machinery as
the reference uses it: `amrex::average_down`, the limited linear
conservative interpolation `lincc_interp`, the tag buffering of the regrid
step). Every operator acts on full-domain dense level tensors with
refinement ratio 2 along the active axes, as reshapes and rolls, in the
JAX package's operation order, so float64 results are bitwise equal.

Face arrays keep the padded face-slot convention of the hydro and radiation
sweeps: along `axis`, slot i of a padded array is the face between padded
cells i-1 and i.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F_nn

from ..stencil import sh


def restrict(U: torch.Tensor, active_axes: Sequence[int]) -> torch.Tensor:
    """Conservative average-down by 2 along the active axes (the last three
    tensor axes are spatial)."""
    out = U
    for d in active_axes:
        ax = out.dim() - 3 + d
        shape = list(out.shape)
        n = shape[ax]
        out = out.reshape(shape[:ax] + [n // 2, 2] + shape[ax + 1:]).mean(dim=ax + 1)
    return out


def _mc_slope(U: torch.Tensor, ax: int) -> torch.Tensor:
    """Monotonized-central limited slope along tensor axis `ax`."""
    dp = sh(U, 1, ax) - U
    dm = U - sh(U, -1, ax)
    dc = 0.5 * (dp + dm)
    mag = torch.minimum(dc.abs(), 2.0 * torch.minimum(dp.abs(), dm.abs()))
    return torch.where(dp * dm > 0.0, torch.sign(dc) * mag, 0.0)


def prolong(U: torch.Tensor, active_axes: Sequence[int]) -> torch.Tensor:
    """Limited-linear conservative interpolation to the 2x finer grid: child
    = parent +- slope/4 per axis, with the per-axis MC slopes scaled by one
    factor per cell so that every child stays within the 3^d neighbourhood's
    min/max (AMReX `CellConservativeLinear`)."""
    slopes = {d: _mc_slope(U, U.dim() - 3 + d) for d in active_axes}
    if len(active_axes) > 1:
        mn = U
        mx = U
        for d in active_axes:
            ax = U.dim() - 3 + d
            mn = torch.minimum(mn, torch.minimum(sh(mn, 1, ax), sh(mn, -1, ax)))
            mx = torch.maximum(mx, torch.maximum(sh(mx, 1, ax), sh(mx, -1, ax)))
        s_sum = None
        for d in active_axes:
            s_sum = slopes[d].abs() if s_sum is None else s_sum + slopes[d].abs()
        s_sum = s_sum * 0.25
        # a select, not a tiny clamp, guards the flat cells (every slope 0)
        flat = s_sum <= 0.0
        denom = torch.where(flat, 1.0, s_sum)
        alpha = torch.clamp(torch.minimum(U - mn, mx - U) / denom, max=1.0)
        alpha = torch.where(flat, 1.0, torch.clamp(alpha, min=0.0))
        del mn, mx, s_sum, denom, flat
        slopes = {d: alpha * s for d, s in slopes.items()}
        del alpha
    out = U
    for d in active_axes:
        ax = out.dim() - 3 + d
        n = out.shape[ax]
        s = slopes.pop(d)
        q = 0.25 * s
        new_shape = list(out.shape)
        new_shape[ax] = 2 * n
        out = torch.stack([out - q, out + q], dim=ax + 1).reshape(new_shape)
        del s, q
        # the remaining slopes are refined along this axis (piecewise constant)
        slopes = {e: torch.repeat_interleave(se, 2, dim=ax) for e, se in slopes.items()}
    return out


def prolong_mask(mask: torch.Tensor, active_axes: Sequence[int]) -> torch.Tensor:
    """Refine a boolean mask: each parent becomes 2^d children."""
    out = mask
    for d in active_axes:
        out = torch.repeat_interleave(out, 2, dim=out.dim() - 3 + d)
    return out


def restrict_mask_any(mask: torch.Tensor, active_axes: Sequence[int]) -> torch.Tensor:
    """Coarsen a boolean mask: a parent is set if any child is."""
    out = mask
    for d in active_axes:
        ax = out.dim() - 3 + d
        shape = list(out.shape)
        n = shape[ax]
        out = out.reshape(shape[:ax] + [n // 2, 2] + shape[ax + 1:]).any(dim=ax + 1)
    return out


def dilate(mask: torch.Tensor, n: int, active_axes: Sequence[int],
           periodic: Sequence[bool]) -> torch.Tensor:
    """Binary dilation by `n` cells along the active axes (the reference's
    `amr.n_error_buf`); non-periodic edges do not wrap."""
    out = mask
    for _ in range(n):
        grown = out
        for d in active_axes:
            ax = out.dim() - 3 + d
            up = sh(out, 1, ax)
            dn = sh(out, -1, ax)
            if not periodic[d]:
                up = up.clone()
                dn = dn.clone()
                up.narrow(ax, up.shape[ax] - 1, 1).fill_(False)
                dn.narrow(ax, 0, 1).fill_(False)
            grown = grown | up | dn
        out = grown
    return out


def pad_mask_zero(mask: torch.Tensor, ng: Sequence[int]) -> torch.Tensor:
    """An interior boolean mask padded with False ghosts (`jnp.pad`)."""
    pad = []
    for g in reversed(ng):
        pad += [g, g]
    return F_nn.pad(mask, pad)


def mask_face_flux(F: torch.Tensor, mask: torch.Tensor, axis: int,
                   ng: Sequence[int]) -> torch.Tensor:
    """Zero a level's face fluxes on faces adjacent to no active cell, so
    that the inactive region's fluxes never reach the parent's flux register
    (`restrict_face_flux` averages transversely). F: [nc, padded spatial];
    mask: interior. Face i lies between padded cells i-1 and i."""
    m_p = pad_mask_zero(mask, ng)
    ok = m_p | sh(m_p, -1, axis)
    return torch.where(ok[None], F, 0.0)


def restrict_face_flux(F: torch.Tensor, axis: int, active_axes: Sequence[int],
                       ng_f: Sequence[int], ng_c: Sequence[int]) -> torch.Tensor:
    """Restrict fine face fluxes (padded face coordinates) to the coarse
    faces: the even fine faces along `axis`, averaged over the 2^k fine faces
    covering each coarse face transversely. Returns a coarse padded face
    array with zero ghost faces."""
    nd = F.dim()
    idx = [slice(None)] * (nd - 3)
    for d in range(3):
        g = ng_f[d]
        n = F.shape[nd - 3 + d] - 2 * g
        if d == axis:
            idx.append(slice(g, g + n + 1))
        elif g > 0:
            idx.append(slice(g, g + n))
        else:
            idx.append(slice(None))
    out = F[tuple(idx)]
    for d in active_axes:
        ax = nd - 3 + d
        n = out.shape[ax]
        if d == axis:
            sub = [slice(None)] * nd
            sub[ax] = slice(0, n, 2)
            out = out[tuple(sub)]
        else:
            shape = list(out.shape)
            out = out.reshape(shape[:ax] + [n // 2, 2] + shape[ax + 1:]).mean(dim=ax + 1)
    # along `axis` the N_c + 1 coarse faces sit at [g_c, g_c + N_c]: the
    # high pad is g_c - 1
    pad = []
    for d in reversed(range(3)):
        g = ng_c[d]
        pad += [g, max(g - 1, 0)] if d == axis else [g, g]
    return F_nn.pad(out.contiguous(), pad)
