"""Shock-cloud interaction (3D, dimensionless), the port's counterpart of
`quokka_tpu.problems.shock_cloud` (the analog of the reference's
ShockCloud science problem, ``src/problems/ShockCloud/cloud.cpp``).

A dense cloud (density contrast chi = 100) embedded in a supersonic hot
wind; the cloud is crushed and stripped on the cloud-crushing time
t_cc = sqrt(chi) R_cloud / v_wind. The wind enters through a user (inflow)
wall at x-lo and leaves through an outflow wall at x-hi; y and z are
periodic. The JAX package adds Strang-split cooling only with
`cooling.enabled`, which the port refuses; this is its hydro-only run.

On the card a float32 run steps in the hybrid ghost-free mode: x padded
by 4 ghosts that the hook fills, y and z unpadded (`Simulation.
_ghost_free_config`).
"""

from __future__ import annotations

import torch

from ..indices import EGAS, EINT, MX1, RHO
from ..registry import (
    BC_OUTFLOW,
    BC_PERIODIC,
    BC_USER,
    BCSpec,
    EOSTraits,
    PhysicsTraits,
    Problem,
    register_problem,
)

RHO_BG = 1.0
CHI = 100.0  # density contrast
RHO_CLOUD = CHI * RHO_BG
P0 = 1.0
V_WIND = 5.0  # supersonic wind (cs_bg = sqrt(5/3) ~ 1.29)
R_CLOUD = 0.15

# The path `chip_smoke.py` runs on the card: 256^3 cells on the unit cube
# (cubic cells), f32, 10 steps.
DECK_256 = """
geometry.prob_lo = 0.0 0.0 0.0
geometry.prob_hi = 1.0 1.0 1.0
amr.n_cell = 256 256 256
cfl = 0.3
stop_time = 10.0
max_timesteps = 10
precision = single
verbose = 0
"""


@register_problem
class ShockCloudProblem(Problem):
    name = "ShockCloud"
    physics = PhysicsTraits(hydro_enabled=True)
    eos_traits = EOSTraits(gamma=5.0 / 3.0, mean_molecular_weight=1.0,
                           boltzmann_constant=1.0)
    bcs = BCSpec(x=(BC_USER, BC_OUTFLOW), y=(BC_PERIODIC, BC_PERIODIC),
                 z=(BC_PERIODIC, BC_PERIODIC))

    def fill_user_boundary(self, Ug, grid, ng, time, axis, side):
        """The wind at x-lo: rho_bg moving at v_wind with P0."""
        if axis != 0 or side != 0:
            return Ug
        sl = slice(0, ng[0])
        gmm = self.eos_traits.gamma
        eint = P0 / (gmm - 1.0)
        Ug[RHO, sl] = RHO_BG
        Ug[MX1, sl] = RHO_BG * V_WIND
        Ug[MX1 + 1, sl] = 0.0
        Ug[MX1 + 2, sl] = 0.0
        Ug[EGAS, sl] = eint + 0.5 * RHO_BG * V_WIND**2
        Ug[EINT, sl] = eint
        return Ug

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        """Built in float64 on `device`, then rounded once to `dtype`."""
        x, y, z = grid.cell_center_mesh(torch.float64, device)
        gmm = self.eos_traits.gamma
        c = [grid.prob_lo[0] + 0.3 * (grid.prob_hi[0] - grid.prob_lo[0]),
             0.5 * (grid.prob_lo[1] + grid.prob_hi[1]),
             0.5 * (grid.prob_lo[2] + grid.prob_hi[2])]
        R = torch.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
        # tanh-smoothed contact (reference cloud.cpp:113-115)
        ramp = 0.5 * (1.0 - torch.tanh((R - R_CLOUD) / (R_CLOUD / 20.0)))
        rho = RHO_BG + (RHO_CLOUD - RHO_BG) * ramp
        # wind everywhere outside the cloud, cloud at rest
        vx = V_WIND * (1.0 - ramp)
        eint = P0 / (gmm - 1.0)
        U = torch.zeros((6, *grid.n_cell), dtype=torch.float64, device=device)
        U[RHO] = rho
        U[MX1] = rho * vx
        U[EGAS] = eint + 0.5 * rho * vx * vx
        U[EINT] = eint
        return U.to(dtype)
