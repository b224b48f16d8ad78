"""MHD problem catalog for the constrained-transport solver.

Counterpart of `quokka_tpu.problems.mhd`; setups follow the standard MHD
test literature: Toth 2000 (circularly polarized Alfven wave), Gardiner &
Stone 2005 (field loop advection), Orszag & Tang 1979, Brio & Wu 1988. The
initial conditions are numpy arrays in float64: the conserved state
U[5, nx, ny, nz] and the staggered face field [Bf_x, Bf_y, Bf_z].
"""

from __future__ import annotations

import numpy as np

from ..registry import register_problem

# The JAX package's MHD bench deck (bench.py:310-318): Orszag-Tang, 256^3,
# periodic, PLM + HLLD + upwind CT by default; run it in f32
# (`precision="single"`).
DECK_256 = """
geometry.prob_hi = 1.0 1.0 1.0
amr.n_cell = 256 256 256
cfl = 0.3
max_timesteps = 2
stop_time = 1.0e10
verbose = 0
"""


def _energy(rho, vx, vy, vz, P, bx, by, bz, gamma):
    ke = 0.5 * rho * (vx * vx + vy * vy + vz * vz)
    pb = 0.5 * (bx * bx + by * by + bz * bz)
    return P / (gamma - 1.0) + ke + pb


def _centers(grid, axis):
    return grid.cell_centers(axis, device="cpu").numpy()


def _faces_and_cells(grid, A_z):
    """Face B from the z vector potential `A_z` and its cell average."""
    from ..mhd.advance import b_cell_from_faces
    from ..mhd.simulation import faces_from_vector_potential

    Bf = faces_from_vector_potential(grid, (None, None, A_z))
    return [b.numpy() for b in Bf], b_cell_from_faces(Bf).numpy()


@register_problem
class CPAlfvenWaveProblem:
    """Circularly polarized Alfven wave (Toth 2000 sec. 6.3.1): an exact
    nonlinear solution of ideal MHD, propagating along x at the Alfven speed
    v_A = B_x/sqrt(rho) = 1."""

    name = "CPAlfvenWave"
    gamma = 5.0 / 3.0
    rho0 = 1.0
    P0 = 0.1
    Bx0 = 1.0
    amp = 0.1

    def set_initial_conditions_mhd(self, grid):
        n = grid.n_cell
        x_c = _centers(grid, 0).reshape(-1, 1, 1)
        k = 2.0 * np.pi / (grid.prob_hi[0] - grid.prob_lo[0])

        # travelling wave moving in +x: delta v = -delta B / sqrt(rho)
        by = self.amp * np.sin(k * x_c)
        bz = self.amp * np.cos(k * x_c)
        vy = -by / np.sqrt(self.rho0)
        vz = -bz / np.sqrt(self.rho0)

        rho = np.full(n, self.rho0)
        vx = np.zeros(n)
        vy = np.broadcast_to(vy, n).copy()
        vz = np.broadcast_to(vz, n).copy()
        P = np.full(n, self.P0)

        # By/Bz vary only with x, so their staggering is along homogeneous
        # axes: exact, div B = 0
        Bfx = np.full(n, self.Bx0)
        Bfy = np.broadcast_to(by, n).copy()
        Bfz = np.broadcast_to(bz, n).copy()

        E = _energy(rho, vx, vy, vz, P, np.full(n, self.Bx0), np.broadcast_to(by, n),
                    np.broadcast_to(bz, n), self.gamma)
        U = np.stack([rho, rho * vx, rho * vy, rho * vz, E])
        return U, [Bfx, Bfy, Bfz]


@register_problem
class FieldLoopProblem:
    """Weak magnetic field loop advected by a uniform flow (Gardiner & Stone
    2005 sec. 5.1): beta ~ 2e6, a passive tracer of the CT scheme's
    dissipation and div-B maintenance."""

    name = "FieldLoop"
    gamma = 5.0 / 3.0
    rho0 = 1.0
    P0 = 1.0
    v0 = (2.0, 1.0, 0.0)
    A0 = 1.0e-3
    R0 = 0.3

    def set_initial_conditions_mhd(self, grid):
        n = grid.n_cell
        cx = 0.5 * (grid.prob_lo[0] + grid.prob_hi[0])
        cy = 0.5 * (grid.prob_lo[1] + grid.prob_hi[1])

        def A_z(x, y, z):
            r = np.sqrt((x - cx) ** 2 + (y - cy) ** 2)
            return np.maximum(self.A0 * (self.R0 - r), 0.0)

        Bf, B_cc = _faces_and_cells(grid, A_z)
        rho = np.full(n, self.rho0)
        vx = np.full(n, self.v0[0])
        vy = np.full(n, self.v0[1])
        vz = np.full(n, self.v0[2])
        P = np.full(n, self.P0)
        E = _energy(rho, vx, vy, vz, P, B_cc[0], B_cc[1], B_cc[2], self.gamma)
        U = np.stack([rho, rho * vx, rho * vy, rho * vz, E])
        return U, Bf


@register_problem
class OrszagTangProblem:
    """Orszag-Tang vortex (the canonical 2D MHD turbulence test), z-invariant
    in a 3D box."""

    name = "OrszagTang"
    gamma = 5.0 / 3.0

    def set_initial_conditions_mhd(self, grid):
        n = grid.n_cell
        x_c = _centers(grid, 0).reshape(-1, 1, 1)
        y_c = _centers(grid, 1).reshape(1, -1, 1)

        rho = np.full(n, 25.0 / (36.0 * np.pi))
        P = np.full(n, 5.0 / (12.0 * np.pi))
        vx = np.broadcast_to(-np.sin(2.0 * np.pi * y_c), n).copy()
        vy = np.broadcast_to(np.sin(2.0 * np.pi * x_c), n).copy()
        vz = np.zeros(n)

        B0 = 1.0 / np.sqrt(4.0 * np.pi)

        def A_z(x, y, z):
            return B0 * (np.cos(4.0 * np.pi * x) / (4.0 * np.pi)
                         + np.cos(2.0 * np.pi * y) / (2.0 * np.pi))

        Bf, B_cc = _faces_and_cells(grid, A_z)
        E = _energy(rho, vx, vy, vz, P, B_cc[0], B_cc[1], B_cc[2], self.gamma)
        U = np.stack([rho, rho * vx, rho * vy, rho * vz, E])
        return U, Bf


@register_problem
class BrioWuProblem:
    """Brio & Wu 1988 MHD shocktube (gamma = 2, Bx = 0.75, By: +1 -> -1),
    doubled onto a periodic domain (interface at x = 0.5)."""

    name = "BrioWu"
    gamma = 2.0

    def set_initial_conditions_mhd(self, grid):
        n = grid.n_cell
        x_c = _centers(grid, 0).reshape(-1, 1, 1)
        left = np.broadcast_to(x_c < 0.5, n)

        rho = np.where(left, 1.0, 0.125)
        P = np.where(left, 1.0, 0.1)
        by = np.where(left, 1.0, -1.0)
        v0 = np.zeros(n)

        Bfx = np.full(n, 0.75)
        Bfy = by.copy()
        Bfz = np.zeros(n)
        E = _energy(rho, v0, v0, v0, P, Bfx, by, 0.0 * by, self.gamma)
        U = np.stack([rho, v0, v0, v0, E])
        return U, [Bfx, Bfy, Bfz]


__all__ = ["BrioWuProblem", "CPAlfvenWaveProblem", "FieldLoopProblem",
           "OrszagTangProblem"]
