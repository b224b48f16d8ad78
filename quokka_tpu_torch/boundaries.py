"""Ghost-cell filling of a padded state (single device).

Counterpart of `quokka_tpu.boundaries.fill_ghosts` (reference
`fillBoundaryConditions`, ``src/simulation.hpp:1706-1789``) for what the
port pads: periodic axes (the dense AMR levels) and reflecting walls (the
classic float64 hydro step, as the JAX package pads it). The padded tensor
is allocated once and the ghost slabs are copied axis by axis (x, then y
over the x-padded extent, then z), which gives the edge and corner ghosts
the values the JAX package's per-axis concatenation gives them.

Periodic padding needs no state layout, so the radiation fills pass the 4G
radiation components alone. A reflecting wall mirrors the interior and
flips the sign of the normal momentum: it pads a hydro block (the JAX
package's `_odd_components` of the hydro layout; the port's radiation
refuses walls). Outflow, user and NSCBC boundaries raise
NotImplementedError.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .indices import MX1
from .registry import BC_PERIODIC, BC_REFLECT, BCSpec


def fill_ghosts(U: torch.Tensor, ng: Sequence[int], bcs: BCSpec) -> torch.Tensor:
    """Pad U[nvar, nx, ny, nz] with `ng` ghosts per axis, filled according
    to `bcs` (a reflecting wall flips the normal momentum MX1 + axis).
    Returns a new contiguous tensor."""
    for d in range(3):
        if ng[d] > 0 and any(k not in (BC_PERIODIC, BC_REFLECT) for k in bcs.axis(d)):
            raise NotImplementedError(
                f"fill_ghosts: axis {d} boundary {bcs.axis(d)}: only periodic and "
                "reflecting walls are ported")
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
        lo_src = (at(g[d], 2 * g[d]) if lo_kind == BC_REFLECT
                  else at(n[d], n[d] + g[d]))
        hi_src = (at(n[d], n[d] + g[d]) if hi_kind == BC_REFLECT
                  else at(g[d], 2 * g[d]))
        out[at(0, g[d])] = out[lo_src]
        out[at(n[d] + g[d], n[d] + 2 * g[d])] = out[hi_src]
        for side, kind in ((at(0, g[d]), lo_kind), (at(n[d] + g[d], n[d] + 2 * g[d]), hi_kind)):
            if kind == BC_REFLECT:
                slab = out[side].flip(1 + d)
                slab[MX1 + d] = -slab[MX1 + d]
                out[side] = slab
    return out
