"""Sod-type shocktube (reference
``src/problems/HydroShocktube/test_hydro_shocktube.cpp:26-383``), the
port's counterpart of `quokka_tpu.problems.shocktube`.

Left state (rho=10, P=100), right state (rho=1, P=1), gamma=1.4, diaphragm
at x=2 in [0,5], Dirichlet (ext_dir) boundaries pinned to the initial
states, run to t=0.4 (``decks/shocktube.in``). Pass criterion: relative
rms-L1 error against the exact Riemann solution < 0.002
(``test_hydro_shocktube.cpp:377-382``), `Simulation.error_norm`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..indices import EGAS, EINT, MX1, RHO
from ..registry import (
    BC_PERIODIC,
    BC_USER,
    BCSpec,
    EOSTraits,
    PhysicsTraits,
    Problem,
    register_problem,
)
from ..utils.exact_riemann import shocktube_exact


@register_problem
class ShocktubeProblem(Problem):
    name = "HydroShocktube"
    physics = PhysicsTraits(hydro_enabled=True)
    eos_traits = EOSTraits(gamma=1.4)
    bcs = BCSpec(x=(BC_USER, BC_USER), y=(BC_PERIODIC, BC_PERIODIC),
                 z=(BC_PERIODIC, BC_PERIODIC))

    rho_L, P_L = 10.0, 100.0
    rho_R, P_R = 1.0, 1.0
    x_diaphragm = 2.0

    def _state_lr(self, left: bool):
        g = self.eos_traits.gamma
        rho, P = (self.rho_L, self.P_L) if left else (self.rho_R, self.P_R)
        return rho, P / (g - 1.0)

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        """Built in float64 on `device`, then rounded once to `dtype`."""
        x = grid.cell_centers(0, torch.float64, device)[:, None, None]
        g = self.eos_traits.gamma
        left = x < self.x_diaphragm
        rho = torch.where(left, torch.tensor(self.rho_L, dtype=torch.float64, device=device),
                          self.rho_R)
        eint = torch.where(left, torch.tensor(self.P_L, dtype=torch.float64, device=device),
                           self.P_R) / (g - 1.0)
        U = torch.zeros((6, *grid.n_cell), dtype=torch.float64, device=device)
        U[RHO] = rho
        U[EGAS] = eint
        U[EINT] = eint
        return U.to(dtype)

    def fill_user_boundary(self, Ug, grid, ng, time, axis, side):
        """Dirichlet: pin the ghost cells to the constant L/R states."""
        assert axis == 0
        g = ng[0]
        rho, eint = self._state_lr(left=(side == 0))
        sl = slice(0, g) if side == 0 else slice(Ug.shape[1] - g, Ug.shape[1])
        Ug[:, sl] = 0.0
        Ug[RHO, sl] = rho
        Ug[EGAS, sl] = eint
        Ug[EINT, sl] = eint
        return Ug

    def compute_reference_solution(self, sim):
        grid = sim.grid
        x = grid.cell_centers(0, torch.float64, "cpu").numpy()
        gamma = self.eos_traits.gamma
        rho, u, p = shocktube_exact(
            x, sim.t, self.x_diaphragm,
            (self.rho_L, 0.0, self.P_L), (self.rho_R, 0.0, self.P_R), gamma,
        )
        eint = p / (gamma - 1.0)
        etot = eint + 0.5 * rho * u * u
        ref = np.zeros((sim.layout.nvar, grid.n_cell[0], 1, 1))
        ref[RHO, :, 0, 0] = rho
        ref[MX1, :, 0, 0] = rho * u
        ref[EGAS, :, 0, 0] = etot
        ref[EINT, :, 0, 0] = eint
        return ref
