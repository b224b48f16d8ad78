"""RadhydroBB: blackbody spectrum formation in a uniformly moving gas.

Counterpart of `quokka_tpu.problems.radhydro_bb` (the reference's
RadhydroBB problem, ``src/problems/RadhydroBB/test_radhydro_bb.cpp``, its
"model 3"): a uniform gas at T0 = 1 moving at v0 = 1e-3 c with no initial
radiation (Erad = floor) thermalizes against kappa = 1e5 (tau/cell ~ 1e5:
an asymptotic-preserving stress test), 4 photon groups, periodic. Total
energy conservation fixes the equilibrium temperature

    rho c_v T0 = rho c_v T_eq + a T_eq^4   ->  T_eq = 0.768032502191

and the final group spectrum is the Planck distribution of T_eq.
"""

from __future__ import annotations

import torch

from ..indices import EGAS, EINT, MX1, RHO
from ..registry import (BC_PERIODIC, BCSpec, EOSTraits, PhysicsTraits, Problem, RadTraits,
                        register_problem)

N_GROUPS = 4
GROUP_EDGES = (1.0e-3, 1.77827941e-2, 3.16227766e-1, 5.62341325, 1.0e2)
C_CODE = 1.0e8
V0 = 1.0e-3 * C_CODE
KAPPA0 = 1.0e5
T0 = 1.0
RHO0 = 1.0
A_RAD = 1.0
GAMMA = 5.0 / 3.0
T_EQUILIBRIUM = 0.768032502191
ERAD_FLOOR = A_RAD * 1e-30


@register_problem
class RadhydroBBProblem(Problem):
    name = "RadhydroBB"
    physics = PhysicsTraits(hydro_enabled=True, radiation_enabled=True,
                            n_groups=N_GROUPS)
    eos_traits = EOSTraits(gamma=GAMMA, mean_molecular_weight=1.0,
                           boltzmann_constant=1.0)
    rad = RadTraits(c_light=C_CODE, c_hat=C_CODE, radiation_constant=A_RAD,
                    Erad_floor=ERAD_FLOOR, beta_order=1,
                    group_edges=GROUP_EDGES, energy_unit=1.0)
    bcs = BCSpec(x=(BC_PERIODIC, BC_PERIODIC), y=(BC_PERIODIC, BC_PERIODIC),
                 z=(BC_PERIODIC, BC_PERIODIC))

    def compute_group_opacities(self, boundaries, rho, T):
        return torch.full((N_GROUPS, *rho.shape), KAPPA0, dtype=rho.dtype,
                          device=rho.device)

    def define_opacity_exponents_and_lower_values(self, boundaries, rho, T):
        k = torch.full((N_GROUPS, *rho.shape), KAPPA0, dtype=rho.dtype, device=rho.device)
        return torch.zeros_like(k), k

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        layout = self.physics.layout()
        eint = self.make_eos().eint_from_tgas(RHO0, T0)
        U = torch.zeros((layout.nvar, *grid.n_cell), dtype=dtype, device=device)
        U[RHO] = RHO0
        U[MX1] = RHO0 * V0
        U[EGAS] = eint + 0.5 * RHO0 * V0 * V0
        U[EINT] = eint
        for g in range(N_GROUPS):
            U[layout.rad_index(g, 0)] = ERAD_FLOOR
        return U
