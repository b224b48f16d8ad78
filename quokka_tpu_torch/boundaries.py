"""Ghost-cell filling of a padded state (single device).

Counterpart of `quokka_tpu.boundaries.fill_ghosts` (reference
`fillBoundaryConditions`, ``src/simulation.hpp:1706-1789``): periodic
(int_dir), outflow (foextrap: the edge cell copied), reflecting (mirrored,
the normal momentum's sign flipped) and user walls (ext_dir: edge copies,
then the problem's `fill_user_boundary` hook). The padded tensor is
allocated once and the ghost slabs are copied axis by axis (x, then y over
the x-padded extent, then z), which gives the edge and corner ghosts the
values the JAX package's per-axis concatenation (`physical_slabs`,
`pad_axis`) gives them; the hook of axis d sees the tensor padded along the
axes up to d and unpadded along the later ones, as in the JAX package.

Periodic padding needs no state layout, so the radiation fills pass the 4G
radiation components alone. A reflecting wall flips the normal momentum
MX1 + axis: it pads a hydro block (the JAX package's `_odd_components` of
the hydro layout; the port's radiation refuses walls). The characteristic
NSCBC walls raise NotImplementedError naming their kind
(`quokka_tpu/hydro/nscbc.py` is not ported).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .indices import MX1
from .registry import (BC_NSCBC_INFLOW, BC_NSCBC_OUTFLOW, BC_OUTFLOW, BC_PERIODIC,
                       BC_REFLECT, BC_USER, BCSpec)

_KINDS = (BC_PERIODIC, BC_REFLECT, BC_OUTFLOW, BC_USER)


def fill_ghosts(U: torch.Tensor, ng: Sequence[int], bcs: BCSpec, problem=None,
                grid=None, time: float = 0.0) -> torch.Tensor:
    """Pad U[nvar, nx, ny, nz] with `ng` ghosts per axis, filled according
    to `bcs`; a BC_USER side calls `problem.fill_user_boundary(Ug, grid,
    ng, time, axis, side)`. Returns a new contiguous tensor."""
    for d in range(3):
        if ng[d] == 0:
            continue
        for kind in bcs.axis(d):
            if kind in (BC_NSCBC_INFLOW, BC_NSCBC_OUTFLOW):
                raise NotImplementedError(
                    f"fill_ghosts: axis {d} boundary {kind!r}: the NSCBC walls "
                    "(quokka_tpu/hydro/nscbc.py) are not ported yet")
            if kind not in _KINDS:
                raise ValueError(f"fill_ghosts: unknown boundary kind {kind!r}")
            if kind == BC_USER and problem is None:
                raise ValueError(f"fill_ghosts: axis {d} has a {BC_USER!r} wall and no "
                                 "problem to fill it")
    nv, *n = U.shape
    g = list(ng)
    if any(g[d] > n[d] for d in range(3)):
        raise ValueError(f"ghost width {tuple(g)} exceeds the extent {tuple(n)}")
    out = U.new_empty((nv, *(n[d] + 2 * g[d] for d in range(3))))
    out[:, g[0]:g[0] + n[0], g[1]:g[1] + n[1], g[2]:g[2] + n[2]] = U
    for d in range(3):
        if g[d] == 0:
            continue
        # the slabs cover the interior of the later axes and the padded
        # extent of the earlier ones
        sl = [slice(None)] + [slice(None) if a < d else slice(g[a], g[a] + n[a])
                              for a in range(3)]

        def at(lo, hi):
            s = list(sl)
            s[1 + d] = slice(lo, hi)
            return tuple(s)

        lo_kind, hi_kind = bcs.axis(d)
        lo_side, hi_side = at(0, g[d]), at(n[d] + g[d], n[d] + 2 * g[d])
        if lo_kind == BC_PERIODIC:
            out[lo_side] = out[at(n[d], n[d] + g[d])]
        elif lo_kind == BC_REFLECT:
            out[lo_side] = out[at(g[d], 2 * g[d])]
        else:  # outflow / user: the edge cell (the hook overwrites a user side)
            out[lo_side] = out[at(g[d], g[d] + 1)]
        if hi_kind == BC_PERIODIC:
            out[hi_side] = out[at(g[d], 2 * g[d])]
        elif hi_kind == BC_REFLECT:
            out[hi_side] = out[at(n[d], n[d] + g[d])]
        else:
            out[hi_side] = out[at(n[d] + g[d] - 1, n[d] + g[d])]
        for side, kind in ((lo_side, lo_kind), (hi_side, hi_kind)):
            if kind == BC_REFLECT:
                slab = out[side].flip(1 + d)
                slab[MX1 + d] = -slab[MX1 + d]
                out[side] = slab
        if BC_USER in (lo_kind, hi_kind):
            # the hook's view: padded along the axes up to d, unpadded after
            view = out[tuple(slice(None) if a <= d else slice(g[a], g[a] + n[a])
                             for a in range(-1, 3))]
            for side, kind in enumerate((lo_kind, hi_kind)):
                if kind == BC_USER:
                    res = problem.fill_user_boundary(view, grid, ng, time, d, side)
                    if res is not view:
                        view.copy_(res)
    return out
