"""Uniform-grid geometry descriptor (one level).

Counterpart of `quokka_tpu.grid` (reference ``src/grid.hpp:16``). The state
is a dense tensor ``U[nvar, nx, ny, nz]``; all three spatial axes are always
present (size 1 for inactive dimensions).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import torch


@dataclass(frozen=True)
class Grid:
    """Geometry of a uniform grid patch/level."""

    n_cell: Tuple[int, int, int]
    prob_lo: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    prob_hi: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    def __post_init__(self):
        object.__setattr__(self, "n_cell", tuple(int(n) for n in self.n_cell))
        object.__setattr__(self, "prob_lo", tuple(float(x) for x in self.prob_lo))
        object.__setattr__(self, "prob_hi", tuple(float(x) for x in self.prob_hi))

    @cached_property
    def active_axes(self) -> Tuple[int, ...]:
        """Spatial axes with more than one cell (the problem dimensionality)."""
        return tuple(d for d in range(3) if self.n_cell[d] > 1)

    @property
    def ndim(self) -> int:
        return max(1, len(self.active_axes))

    @cached_property
    def dx(self) -> Tuple[float, float, float]:
        return tuple(
            (self.prob_hi[d] - self.prob_lo[d]) / self.n_cell[d] for d in range(3)
        )

    @property
    def dx_min(self) -> float:
        active = self.active_axes or (0,)
        return min(self.dx[d] for d in active)

    @property
    def num_cells(self) -> int:
        return self.n_cell[0] * self.n_cell[1] * self.n_cell[2]

    def cell_centers(self, axis: int, dtype=torch.float64, device="cuda") -> torch.Tensor:
        """1D tensor of cell-center coordinates along `axis`."""
        lo, dx, n = self.prob_lo[axis], self.dx[axis], self.n_cell[axis]
        return lo + (torch.arange(n, dtype=dtype, device=device) + 0.5) * dx

    def cell_center_mesh(self, dtype=torch.float64, device="cuda"):
        """Broadcastable (x, y, z) coordinates of shape [nx,1,1], [1,ny,1],
        [1,1,nz]."""
        return tuple(self.cell_centers(d, dtype, device).reshape(
            [-1 if a == d else 1 for a in range(3)]) for d in range(3))

    def refine(self, ratio: int = 2) -> "Grid":
        """The grid refined by `ratio` along the active axes (same domain)."""
        n_new = tuple(n * ratio if d in self.active_axes else n
                      for d, n in enumerate(self.n_cell))
        return Grid(n_new, self.prob_lo, self.prob_hi)

    def cell_volume(self) -> float:
        v = 1.0
        for d in range(3):
            v *= self.dx[d]
        return v
