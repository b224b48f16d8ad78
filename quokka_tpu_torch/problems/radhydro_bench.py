"""Radiation-hydrodynamics benchmark problem (3D), `RadhydroBench`.

Counterpart of `quokka_tpu.problems.radhydro_bench` (the analog of the
reference's radiation-driven-shell weak-scaling benchmark,
``tests/radhydro_shell_256.in``): a full radhydro step -- PPM+HLLC hydro
plus ~10 IMEX radiation substeps with implicit coupling per hydro step.

Setup: periodic box, gas in thermal equilibrium with radiation, a smooth
central radiation/temperature pulse driving outflow. Scaled units (c = 1e3,
c_hat = 1e2, a_rad = 1, rho = 1, T ~ 1, kappa = 10) keep every
intermediate well inside the float32 exponent range.
"""

from __future__ import annotations

import torch

from ..indices import EGAS, EINT, RHO
from ..registry import (EOSTraits, PhysicsTraits, PowerLawOpacity, Problem,
                        RadTraits, register_problem)

C_CODE = 1.0e3  # speed of light >> gas signal speeds (~1)
CHAT = 1.0e2  # reduced speed of light: ~10 radiation substeps/hydro step
KAPPA0 = 10.0  # tau per cell ~ rho kappa dx: mixed regime at 256^3
A_RAD = 1.0
T0 = 1.0
RHO0 = 1.0

# the JAX package's radhydro benchmark deck (bench.py:54-62), 256^3
DECK_256 = """
geometry.prob_hi = 1.0 1.0 1.0
amr.n_cell = 256 256 256
cfl = 0.3
radiation.cfl = 0.3
"""


@register_problem
class RadhydroBenchProblem(Problem):
    name = "RadhydroBench"
    physics = PhysicsTraits(hydro_enabled=True, radiation_enabled=True)
    eos_traits = EOSTraits(gamma=5.0 / 3.0, mean_molecular_weight=1.0,
                           boltzmann_constant=1.0)
    rad = RadTraits(c_light=C_CODE, c_hat=CHAT, radiation_constant=A_RAD,
                    Erad_floor=1e-10, beta_order=1)
    planck_opacity = PowerLawOpacity(KAPPA0)  # energy and flux means: the same

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        """Built in float64 on `device`, then cast to `dtype`, as the JAX
        package builds it in f64 and casts."""
        x, y, z = grid.cell_center_mesh(torch.float64, device)
        layout = self.physics.layout()
        eos = self.make_eos()
        dx2, dy2, dz2 = ((a - 0.5) * (a - 0.5) for a in (x, y, z))
        T = T0 * (1.0 + 0.5 * torch.exp(-(dx2 + dy2 + dz2) / 0.02))
        T = T.expand(grid.n_cell)
        eint = eos.eint_from_tgas(RHO0, T)
        U = torch.zeros((layout.nvar, *grid.n_cell), dtype=dtype, device=device)
        U[RHO] = RHO0
        U[EGAS] = eint
        U[EINT] = eint
        U[layout.rad_index(0, 0)] = A_RAD * ((T * T) * (T * T))  # T**4 as XLA
        return U
