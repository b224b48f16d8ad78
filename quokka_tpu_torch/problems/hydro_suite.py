"""Classic hydro test problems (catalog breadth), the port's counterpart of
`quokka_tpu.problems.hydro_suite`.

Rebuilds of the reference's 1D/2D hydro validation problems:
  - Shu & Osher (1989) shock/entropy-wave interaction
    (``src/problems/HydroShuOsher``)
  - slow-moving shock (Jones et al. test; ``src/problems/HydroSMS``)
  - pressureless high-Mach collapse (``src/problems/HydroHighMach``)
  - double-rarefaction vacuum and stationary contact
    (``src/problems/HydroVacuum``, ``src/problems/HydroContact``)
  - Quirk's odd-even decoupling (carbuncle) test, 2D
    (``src/problems/HydroQuirk``)
  - the Richtmyer-Meshkov instability, 2D (and, on a 3D grid, the
    outflow-walled run `chip_smoke.py` takes to the card: `DECK_RM_3D`)
  - the cylindrical Sedov blast, 2D (``src/problems/HydroBlast2D``)

Each initial condition is built in float64 on the caller's device and
rounded once to the caller's dtype; each user wall is filled in place.
"""

from __future__ import annotations

import math

import numpy as np
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

# Richtmyer-Meshkov on a 3D grid with cubic cells: x's outflow walls are
# assembled in the kernels (K1 writes their chi planes, every K2 sweep reads
# them), y and z periodic; f32, 10 steps (`chip_smoke.py`).
DECK_RM_3D = """
geometry.prob_lo = 0.0 0.0 0.0
geometry.prob_hi = 1.0 1.0 0.25
amr.n_cell = 256 256 64
cfl = 0.3
stop_time = 10.0
max_timesteps = 10
precision = single
verbose = 0
"""


def _prim_state(grid, rho, vx, P, gamma, dtype, device):
    shape = grid.n_cell
    rho = torch.as_tensor(rho, dtype=torch.float64, device=device).expand(shape)
    vx = torch.as_tensor(vx, dtype=torch.float64, device=device).expand(shape)
    P = torch.as_tensor(P, dtype=torch.float64, device=device).expand(shape)
    eint = P / (gamma - 1.0)
    zeros = torch.zeros(shape, dtype=torch.float64, device=device)
    return torch.stack([rho, rho * vx, zeros, zeros, eint + 0.5 * rho * vx * vx,
                        eint]).to(dtype)


def _set_prim_slab(Ug, sl, rho, vx, P, gamma):
    eint = P / (gamma - 1.0)
    Ug[RHO, sl] = rho
    Ug[MX1, sl] = rho * vx
    Ug[MX1 + 1, sl] = 0.0
    Ug[MX1 + 2, sl] = 0.0
    Ug[EGAS, sl] = eint + 0.5 * rho * vx * vx
    Ug[EINT, sl] = eint
    return Ug


def _mesh(grid, device):
    return grid.cell_center_mesh(torch.float64, device)


def _where(cond, a, b):
    """torch.where in float64 (two Python numbers would give PyTorch's
    default float32)."""
    def f64(v):
        return torch.as_tensor(v, dtype=torch.float64, device=cond.device)

    return torch.where(cond, f64(a), f64(b))


@register_problem
class ShuOsherProblem(Problem):
    """Mach-3 shock running into a sinusoidal entropy wave (Shu & Osher
    1989); reference deck: domain [0, 10], t_end = 1.8, gamma = 1.4."""

    name = "HydroShuOsher"
    physics = PhysicsTraits(hydro_enabled=True)
    eos_traits = EOSTraits(gamma=1.4)
    bcs = BCSpec(x=(BC_USER, BC_USER))

    RHO_L, VX_L, P_L = 3.857143, 2.629369, 10.33333

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        x, _y, _z = _mesh(grid, device)
        left = x < 1.0
        rho = _where(left, self.RHO_L, 1.0 + 0.2 * torch.sin(5.0 * x))
        vx = _where(left, self.VX_L, 0.0)
        P = _where(left, self.P_L, 1.0)
        return _prim_state(grid, rho, vx, P, self.eos_traits.gamma, dtype, device)

    def fill_user_boundary(self, Ug, grid, ng, time, axis, side):
        if axis != 0:
            return Ug
        g = ng[0]
        gamma = self.eos_traits.gamma
        if side == 0:
            return _set_prim_slab(Ug, slice(0, g), self.RHO_L, self.VX_L, self.P_L, gamma)
        n = Ug.shape[1]
        x_hi = 10.0  # rho = 1 + 0.2 sin(5 x) evaluated at the edge
        return _set_prim_slab(Ug, slice(n - g, n), 1.0 + 0.2 * math.sin(5.0 * x_hi), 0.0,
                              1.0, gamma)


@register_problem
class SlowMovingShockProblem(Problem):
    """Slow-moving shock (v_shock = 0.1096): tests against the exact
    translated jump at t = 1 with the reference's 0.5% L1 criterion
    (``src/problems/HydroSMS/test_hydro_sms.cpp:230-296``)."""

    name = "HydroSMS"
    physics = PhysicsTraits(hydro_enabled=True)
    eos_traits = EOSTraits(gamma=1.4)
    bcs = BCSpec(x=(BC_USER, BC_USER))

    L = (3.86, -0.81, 10.3334)
    R = (1.0, -3.44, 1.0)
    VSHOCK = 0.1096

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        x, _y, _z = _mesh(grid, device)
        left = x < 0.5
        rho = _where(left, self.L[0], self.R[0])
        vx = _where(left, self.L[1], self.R[1])
        P = _where(left, self.L[2], self.R[2])
        return _prim_state(grid, rho, vx, P, self.eos_traits.gamma, dtype, device)

    def fill_user_boundary(self, Ug, grid, ng, time, axis, side):
        if axis != 0:
            return Ug
        g = ng[0]
        gamma = self.eos_traits.gamma
        if side == 0:
            return _set_prim_slab(Ug, slice(0, g), *self.L, gamma)
        n = Ug.shape[1]
        return _set_prim_slab(Ug, slice(n - g, n), *self.R, gamma)

    def exact_solution(self, x, t):
        left = x < 0.5 + self.VSHOCK * t
        rho = np.where(left, self.L[0], self.R[0])
        vx = np.where(left, self.L[1], self.R[1])
        P = np.where(left, self.L[2], self.R[2])
        return rho, vx, P


@register_problem
class HighMachProblem(Problem):
    """Pressureless high-Mach sinusoidal collapse (P = 1e-10): stresses
    positivity and the dual-energy machinery at Mach ~ 1e5."""

    name = "HydroHighMach"
    physics = PhysicsTraits(hydro_enabled=True)
    eos_traits = EOSTraits(gamma=5.0 / 3.0)
    bcs = BCSpec()  # periodic

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        x, _y, _z = _mesh(grid, device)
        vx = torch.sin(2.0 * math.pi * x)
        return _prim_state(grid, 1.0, vx, 1.0e-10, self.eos_traits.gamma, dtype, device)


@register_problem
class HydroVacuumProblem(Problem):
    """Double rarefaction into (near-)vacuum (Toro test 2)."""

    name = "HydroVacuum"
    physics = PhysicsTraits(hydro_enabled=True)
    eos_traits = EOSTraits(gamma=1.4)
    bcs = BCSpec(x=(BC_OUTFLOW, BC_OUTFLOW))

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        x, _y, _z = _mesh(grid, device)
        vx = _where(x < 0.5, -2.0, 2.0)
        return _prim_state(grid, 1.0, vx, 0.4, self.eos_traits.gamma, dtype, device)


@register_problem
class HydroContactProblem(Problem):
    """Stationary contact discontinuity: must be preserved exactly."""

    name = "HydroContact"
    physics = PhysicsTraits(hydro_enabled=True)
    eos_traits = EOSTraits(gamma=1.4)
    bcs = BCSpec(x=(BC_OUTFLOW, BC_OUTFLOW))

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        x, _y, _z = _mesh(grid, device)
        rho = _where(x < 0.5, 1.4, 1.0)
        return _prim_state(grid, rho, 0.0, 1.0, self.eos_traits.gamma, dtype, device)


@register_problem
class QuirkProblem(Problem):
    """Quirk (1994) odd-even decoupling: a strong shock with an odd-even
    perturbed column must stay planar (the Minoshima & Miyoshi 2021
    carbuncle-suppressed HLLC keeps it so); reference
    ``src/problems/HydroQuirk/test_quirk.cpp`` (PLM, t = 0.4)."""

    name = "HydroQuirk"
    physics = PhysicsTraits(hydro_enabled=True)
    eos_traits = EOSTraits(gamma=5.0 / 3.0)
    bcs = BCSpec(x=(BC_USER, BC_USER), y=(BC_PERIODIC, BC_PERIODIC))

    DL = (3.692, -0.625, 26.85)
    DR = (1.0, -5.0, 0.6)
    DD = (3.692 - 0.135, -0.625 + 0.219, 26.85 - 1.31)
    XSHOCK = 0.4

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        x, _y, _z = _mesh(grid, device)
        shape = grid.n_cell
        left = x < self.XSHOCK
        rho = _where(left, self.DL[0], self.DR[0]).expand(shape)
        vx = _where(left, self.DL[1], self.DR[1]).expand(shape)
        P = _where(left, self.DL[2], self.DR[2]).expand(shape)
        # odd-even perturbed column at the last pre-shock cell
        i = torch.arange(shape[0], device=device)[:, None, None]
        j = torch.arange(shape[1], device=device)[None, :, None]
        ishock = int(self.XSHOCK / grid.dx[0]) - 1
        pert = (i == ishock) & (j % 2 == 0)
        rho = _where(pert, self.DD[0], rho)
        vx = _where(pert, self.DD[1], vx)
        P = _where(pert, self.DD[2], P)
        return _prim_state(grid, rho, vx, P, self.eos_traits.gamma, dtype, device)

    def fill_user_boundary(self, Ug, grid, ng, time, axis, side):
        if axis != 0:
            return Ug
        g = ng[0]
        gamma = self.eos_traits.gamma
        if side == 0:
            return _set_prim_slab(Ug, slice(0, g), *self.DL, gamma)
        n = Ug.shape[1]
        return _set_prim_slab(Ug, slice(n - g, n), *self.DR, gamma)


@register_problem
class RichtmeyerMeshkovProblem(Problem):
    """Richtmyer-Meshkov instability (2D): a shock crossing a sinusoidally
    perturbed contact discontinuity (reference
    ``src/problems/HydroRichtmeyerMeshkov``). On a 3D grid (`DECK_RM_3D`)
    the same setup is z-invariant, with x's outflow walls and y and z
    periodic."""

    name = "HydroRichtmeyerMeshkov"
    physics = PhysicsTraits(hydro_enabled=True)
    eos_traits = EOSTraits(gamma=1.4)
    bcs = BCSpec(x=(BC_OUTFLOW, BC_OUTFLOW), y=(BC_PERIODIC, BC_PERIODIC))

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        x, y, _z = _mesh(grid, device)
        shape = grid.n_cell
        # perturbed interface at x = 0.5 + 0.02 cos(2 pi y); shock at x = 0.3
        x_if = 0.5 + 0.02 * torch.cos(2.0 * math.pi * y)
        heavy = (x > x_if).expand(shape)
        shocked = (x < 0.3).expand(shape)
        rho = _where(heavy, 3.0, 1.0)
        rho = _where(shocked, 2.667, rho)  # Mach-2 post-shock (gamma 1.4)
        vx = _where(shocked, 1.479, 0.0)
        P = _where(shocked, 4.5, 1.0)
        return _prim_state(grid, rho, vx, P, self.eos_traits.gamma, dtype, device)


@register_problem
class Blast2DProblem(Problem):
    """Cylindrical Sedov blast (2D), the reference's HydroBlast2D."""

    name = "HydroBlast2D"
    physics = PhysicsTraits(hydro_enabled=True)
    eos_traits = EOSTraits(gamma=1.4)
    bcs = BCSpec()

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        x, y, _z = _mesh(grid, device)
        r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2
        P = _where(r2 < 0.01, 10.0, 0.1)
        return _prim_state(grid, 1.0, 0.0, P, self.eos_traits.gamma, dtype, device)
