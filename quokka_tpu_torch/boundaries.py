"""Ghost-cell filling of a padded state (single device).

Counterpart of `quokka_tpu.boundaries.fill_ghosts` (reference
`fillBoundaryConditions`, ``src/simulation.hpp:1706-1789``) for what the
dense-level AMR path pads: periodic axes. The padded tensor is allocated
once and the ghost slabs are copied axis by axis (x, then y over the
x-padded extent, then z), which gives the edge and corner ghosts the values
the JAX package's per-axis concatenation gives them.

Periodic padding needs no state layout (the JAX package's layout argument
names the components a wall reflection flips), so the radiation fills pass
the 4G radiation components alone. Reflecting, outflow, user and NSCBC
boundaries raise NotImplementedError: the unigrid port assembles its walls
inside the kernels (ghost-free stepping), and no padded path of the port
meets a wall yet.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .registry import BC_PERIODIC, BCSpec


def fill_ghosts(U: torch.Tensor, ng: Sequence[int], bcs: BCSpec) -> torch.Tensor:
    """Pad U[nvar, nx, ny, nz] with `ng` ghosts per axis, filled according
    to `bcs`. Returns a new contiguous tensor."""
    for d in range(3):
        if ng[d] > 0 and bcs.axis(d) != (BC_PERIODIC, BC_PERIODIC):
            raise NotImplementedError(
                f"fill_ghosts: axis {d} boundary {bcs.axis(d)}: only periodic "
                "padding is ported (walls are assembled in the kernels)")
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

        out[at(0, g[d])] = out[at(n[d], n[d] + g[d])]
        out[at(n[d] + g[d], n[d] + 2 * g[d])] = out[at(g[d], 2 * g[d])]
    return out
