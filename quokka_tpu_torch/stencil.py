"""Stencil utilities for dense-tensor finite-volume code.

Counterpart of `quokka_tpu.stencil`: every stencil operator is written with
`sh(A, k, ax)` = "A evaluated at index i+k along axis ax", a roll, so shapes
never change. On an unpadded (ghost-free) tensor the roll wrap is the
periodic boundary; `sh_bc` corrects the positions whose stencil crosses a
reflecting or outflow wall.

Face-indexed arrays share the cell shape: position ``f`` along an axis holds
the value at the interface between cells ``f-1`` and ``f``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def sh(A: torch.Tensor, k: int, ax: int) -> torch.Tensor:
    """A shifted so that result[i] = A[i+k] along tensor axis `ax`."""
    if k == 0:
        return A
    return torch.roll(A, -k, dims=ax)


def interior(A: torch.Tensor, ng: Sequence[int]) -> torch.Tensor:
    """Slice off the ghost margin. `ng` = ghost width per spatial axis; A's
    spatial axes are the last three."""
    idx = [slice(None)] * (A.dim() - 3)
    for g in ng:
        idx.append(slice(g, -g) if g > 0 else slice(None))
    return A[tuple(idx)]


def sh_bc(A: torch.Tensor, k: int, ax: int, lo_kind: str, hi_kind: str,
          odd: bool = False) -> torch.Tensor:
    """`sh` with physical-wall-corrected values on an UNPADDED field.

    The positions whose stencil crosses a reflecting or outflow wall read
    the mirrored (reflect, sign-flipped when `odd`) or edge (outflow) plane,
    matching a ghost-padded fill exactly (reference reflect_odd /
    reflect_even / foextrap). `|k|` is at most the ghost depth, 4.
    """
    from .registry import BC_PERIODIC, BC_REFLECT

    out = sh(A, k, ax)
    if k == 0:
        return out
    n = A.shape[ax]
    sgn = -1.0 if odd else 1.0
    if k < 0 and lo_kind != BC_PERIODIC:
        m = -k
        for i in range(m):
            if lo_kind == BC_REFLECT:
                val = sgn * A.narrow(ax, m - 1 - i, 1)
            else:  # outflow / edge extrapolation
                val = A.narrow(ax, 0, 1)
            out.narrow(ax, i, 1).copy_(val)
    if k > 0 and hi_kind != BC_PERIODIC:
        for i in range(k):
            pos = n - k + i
            if hi_kind == BC_REFLECT:
                val = sgn * A.narrow(ax, n - 1 - (pos + k - n), 1)
            else:
                val = A.narrow(ax, n - 1, 1)
            out.narrow(ax, pos, 1).copy_(val)
    return out


def ghost_widths(grid, ng_active: int) -> Tuple[int, int, int]:
    """Ghost width per axis: `ng_active` on active axes, 0 on size-1 axes."""
    return tuple(ng_active if grid.n_cell[d] > 1 else 0 for d in range(3))
