"""Rayleigh-Taylor instability under a constant external gravity, the
port's counterpart of `quokka_tpu.problems.rayleigh_taylor` (reference
``src/problems/RayleighTaylor2D/test_hydro2d_rt.cpp`` and
``src/problems/RayleighTaylor3D/test_hydro3d_rt.cpp``).

Heavy fluid (rho = 2) over light (rho = 1) in a downward gravity g = -0.1,
in hydrostatic balance P = P0 + rho g y (2D; z in 3D), with a seeded random
velocity perturbation at the interface, amp (1 + cos(8 pi y / 3)) / 2, amp
uniform in [0, 0.01) from `np.random.default_rng(42)` (the JAX package's
numbers exactly). Periodic across, reflecting along gravity. The gravity is
`Problem.external_acceleration`, kicked after each hydro step. The 3D
problem carries a passive scalar, rho on the heavy side and 0 on the light
one, so s / rho marks the heavy fluid's fraction.

On the card a float32 3D run steps ghost-free, the z walls assembled in the
kernels; the scalar rides K2 and K3 as the seventh component.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..registry import (
    BC_PERIODIC,
    BC_REFLECT,
    BCSpec,
    EOSTraits,
    PhysicsTraits,
    Problem,
    register_problem,
)

RHO_TOP = 2.0
RHO_BOT = 1.0
G_Y = -0.1
P0 = 2.5
AMP = 0.01

# The paths `chip_smoke.py` runs on the card, f32, 10 steps each: the JAX
# package's test domain (tests/test_rayleigh_taylor.py:67-68) at 256 x 256 x
# 384 cubic cells, whose 384 takes the lean step (K1 + K2c, above 272 cells
# an axis), and 256^3 on [-0.375, 0.375]^3, the fused step (K1, K2, K3).
DECK_3D_LEAN = """
geometry.prob_lo = -0.25 -0.25 -0.375
geometry.prob_hi = 0.25 0.25 0.375
amr.n_cell = 256 256 384
cfl = 0.3
stop_time = 2.0
max_timesteps = 10
precision = single
verbose = 0
"""
DECK_3D_FUSED = """
geometry.prob_lo = -0.375 -0.375 -0.375
geometry.prob_hi = 0.375 0.375 0.375
amr.n_cell = 256 256 256
cfl = 0.3
stop_time = 2.0
max_timesteps = 10
precision = single
verbose = 0
"""


def _perturbation(shape, coord):
    """amp (1 + cos(8 pi c / 3)) / 2 over `shape`, amp seeded as in the JAX
    package (float64, on the CPU)."""
    rng = np.random.default_rng(42)
    amp = AMP * torch.from_numpy(rng.random(shape))
    c = torch.broadcast_to(coord.cpu(), shape)
    return amp * (1.0 + torch.cos(8.0 * math.pi * c / 3.0)) / 2.0


@register_problem
class RayleighTaylor2DProblem(Problem):
    name = "RayleighTaylor2D"
    physics = PhysicsTraits(hydro_enabled=True)
    eos_traits = EOSTraits(gamma=1.4, mean_molecular_weight=1.0, boltzmann_constant=1.0)
    bcs = BCSpec(x=(BC_PERIODIC, BC_PERIODIC), y=(BC_REFLECT, BC_REFLECT))

    perturb: bool = True

    def external_acceleration(self, grid, dtype=torch.float64, device="cuda"):
        g = torch.zeros((3, *grid.n_cell), dtype=dtype, device=device)
        g[1] = G_Y
        return g

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        """Built in float64 on the CPU, then rounded once to `dtype` on
        `device`."""
        _, y, _ = grid.cell_center_mesh(torch.float64, "cpu")
        shape = grid.n_cell
        gmm = self.eos_traits.gamma
        rho = torch.where(y > 0.0, RHO_TOP, RHO_BOT).to(torch.float64)
        P = P0 + rho * G_Y * y
        vy = _perturbation(shape, y) if self.perturb else torch.zeros(shape,
                                                                      dtype=torch.float64)
        rho = torch.broadcast_to(rho, shape)
        eint = torch.broadcast_to(P, shape) / (gmm - 1.0)
        U = torch.zeros((self.physics.layout().nvar, *shape), dtype=torch.float64)
        U[0] = rho
        U[2] = rho * vy
        U[4] = eint + 0.5 * rho * vy * vy
        U[5] = eint
        return U.to(dtype=dtype, device=device)


@register_problem
class RayleighTaylor3DProblem(Problem):
    """Heavy over light along z, with a passive scalar marking the heavy
    fluid; periodic in x and y, reflecting in z."""

    name = "RayleighTaylor3D"
    physics = PhysicsTraits(hydro_enabled=True, n_scalars=1)
    eos_traits = EOSTraits(gamma=1.4, mean_molecular_weight=1.0, boltzmann_constant=1.0)
    bcs = BCSpec(x=(BC_PERIODIC, BC_PERIODIC), y=(BC_PERIODIC, BC_PERIODIC),
                 z=(BC_REFLECT, BC_REFLECT))

    perturb: bool = True

    def external_acceleration(self, grid, dtype=torch.float64, device="cuda"):
        g = torch.zeros((3, *grid.n_cell), dtype=dtype, device=device)
        g[2] = G_Y
        return g

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        """Built in float64 on the CPU, then rounded once to `dtype` on
        `device`."""
        _, _, z = grid.cell_center_mesh(torch.float64, "cpu")
        shape = grid.n_cell
        gmm = self.eos_traits.gamma
        heavy = torch.broadcast_to(z > 0.0, shape)
        rho = torch.where(heavy, RHO_TOP, RHO_BOT).to(torch.float64)
        scalar = torch.where(heavy, 1.0, 0.0).to(torch.float64)
        P = torch.broadcast_to(P0 + rho * G_Y * z, shape)
        vz = _perturbation(shape, z) if self.perturb else torch.zeros(shape,
                                                                      dtype=torch.float64)
        eint = P / (gmm - 1.0)
        U = torch.zeros((self.physics.layout().nvar, *shape), dtype=torch.float64)
        U[0] = rho
        U[3] = rho * vz
        U[4] = eint + 0.5 * rho * vz * vz
        U[5] = eint
        U[6] = scalar * rho
        return U.to(dtype=dtype, device=device)
