"""What the packed radiation subcycle reads of the pool radiation.

Counterpart of `quokka_tpu.radiation.pool` ``:37-100``: `TileGridView`, the
grid-like coordinate view of tiles that a problem's per-tile hooks
(`set_radiation_energy_source`) evaluate on, and `PoolLevelRadiation`, the
pool level's radiation options (the base options; the JAX package turns
its Pallas switch off there, which the port does not have). The unpacked
pool subcycle is not ported.
"""

from __future__ import annotations

import torch


class TileGridView:
    """Coordinates of a chunk of tiles for per-tile problem hooks: it
    duck-types the `Grid` surface they read (prob_lo/hi, n_cell, dx,
    cell_centers, cell_center_mesh). `origin` is an int tensor [c, 3] of
    the tiles' origins in the level's cells; `n_cell` is (c, tx, ty, tz),
    so a hook that broadcasts to `grid.n_cell` returns [c, tx, ty, tz]."""

    def __init__(self, level_grid, origin: torch.Tensor, tile_shape):
        self.prob_lo = level_grid.prob_lo
        self.prob_hi = level_grid.prob_hi
        self.dx = level_grid.dx
        self.n_cell = (origin.shape[0],) + tuple(tile_shape)
        self._origin = origin

    def cell_centers(self, axis: int, dtype=torch.float64, device=None) -> torch.Tensor:
        """[c, n] cell-centre coordinates along `axis` of each tile."""
        lo, dx, n = self.prob_lo[axis], self.dx[axis], self.n_cell[1 + axis]
        o = self._origin[:, axis].to(dtype)[:, None]
        ar = torch.arange(n, dtype=dtype, device=self._origin.device)[None]
        return lo + (o + ar + 0.5) * dx

    def cell_center_mesh(self, dtype=torch.float64, device=None):
        x = self.cell_centers(0, dtype)[:, :, None, None]
        y = self.cell_centers(1, dtype)[:, None, :, None]
        z = self.cell_centers(2, dtype)[:, None, None, :]
        return x, y, z


class PoolLevelRadiation:
    """The radiation options of one packed pool level."""

    def __init__(self, sim, level: int, grid):
        base = getattr(sim, "_radiation", None)
        if base is None:
            raise RuntimeError("PoolLevelRadiation requires RadiationAdvance")
        self.level = level
        self.grid = grid
        self.opts = base.opts
