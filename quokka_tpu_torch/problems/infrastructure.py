"""Scalar problems of the JAX package's `quokka_tpu.problems.infrastructure`
catalog (the reference's problem directories whose checks live in the
tests), the subset the port carries:

- PassiveScalar (``src/problems/PassiveScalar``): a Gaussian scalar blob
  advected by a uniform flow;
- HydroShocktubeCMA (``src/problems/HydroShocktubeCMA``): the Sod
  shocktube with two mass scalars split 60/40, which consistent
  multi-species advection keeps summing to the density.
"""

from __future__ import annotations

import torch

from ..indices import RHO, SCALAR0
from ..registry import EOSTraits, PhysicsTraits, Problem, register_problem
from .shocktube import ShocktubeProblem


@register_problem
class PassiveScalarProblem(Problem):
    """Gaussian passive-scalar profile advected by a uniform flow."""

    name = "PassiveScalar"
    physics = PhysicsTraits(hydro_enabled=True, n_scalars=1)
    eos_traits = EOSTraits(gamma=1.4)

    rho0, P0, v0 = 1.0, 1.0, 1.0

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        """Built in float64 on `device`, then rounded once to `dtype`."""
        x = grid.cell_centers(0, torch.float64, device)[:, None, None]
        shape = grid.n_cell
        scal = torch.exp(-((x - 0.3) ** 2) / 0.005)
        eint = self.P0 / (self.eos_traits.gamma - 1.0)
        U = torch.zeros((self.physics.layout().nvar, *shape), dtype=torch.float64,
                        device=device)
        U[0] = self.rho0
        U[1] = self.rho0 * self.v0
        U[4] = eint + 0.5 * self.rho0 * self.v0**2
        U[5] = eint
        U[SCALAR0] = scal
        return U.to(dtype)


@register_problem
class ShocktubeCMAProblem(ShocktubeProblem):
    """Sod shocktube with two mass scalars split 60/40 (consistent
    multi-species advection: the species must sum to the density)."""

    name = "HydroShocktubeCMA"
    physics = PhysicsTraits(hydro_enabled=True, n_scalars=2, n_mscalars=2)

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        U = super().set_initial_conditions(grid, torch.float64, device)
        full = torch.zeros((self.physics.layout().nvar, *grid.n_cell), dtype=torch.float64,
                           device=device)
        full[:U.shape[0]] = U
        full[SCALAR0] = 0.6 * U[RHO]
        full[SCALAR0 + 1] = 0.4 * U[RHO]
        return full.to(dtype)

    def fill_user_boundary(self, Ug, grid, ng, time, axis, side):
        Ug = super().fill_user_boundary(Ug, grid, ng, time, axis, side)
        g = ng[0]
        rho, _ = self._state_lr(left=(side == 0))
        sl = slice(0, g) if side == 0 else slice(Ug.shape[1] - g, Ug.shape[1])
        Ug[SCALAR0, sl] = 0.6 * rho
        Ug[SCALAR0 + 1, sl] = 0.4 * rho
        return Ug

    def compute_reference_solution(self, sim):
        return None  # CMA consistency is the check (tests/test_cma_scalars.py)
