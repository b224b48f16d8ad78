"""Advecting radiation pulse in the diffusion regime (1D, CGS), and its
multigroup variants.

Counterpart of `quokka_tpu.problems.radhydro_pulse` (the reference's
RadhydroPulse problems, ``src/problems/RadhydroPulse*/``): a Gaussian
temperature pulse in pressure balance (gas + radiation pressure constant,
rho(x) = rho0 T0/T + (a mu / 3 k_B)(T0^4/T - T^3)) with tau = 2e3 per
pulse width (static diffusion) and optional advection at `v0` (beta tau =
6e-2). The acceptance criterion is frame invariance: the advected pulse,
shifted back by v0 t, matches the comoving solution (and Tgas tracks
Trad), the test of the O(beta tau) work terms.

- `RadhydroPulse` (and its alias `RadhydroPulseGrey`): grey, kappa0 = 100;
- `RadhydroPulseDyn`: kappa0 = 500, v0 = 3e7 cm/s;
- `RadhydroPulseMGconst`: 4 groups with the same constant opacity, whose
  group sum reproduces the grey pulse;
- `RadhydroPulseMGint`: 4 groups with a nu- and T-dependent opacity,
  integrated by the PPL fixed-slope model.
"""

from __future__ import annotations

import math

import torch

from .._numerics import div, exp, log, pow
from ..indices import EGAS, EINT, MX1, RHO
from ..radiation.planck import planck_energy_fractions
from ..registry import (BCSpec, EOSTraits, PhysicsTraits, PowerLawOpacity, Problem,
                        RadTraits, register_problem)

C_CGS = 2.99792458e10
A_RAD = 7.565731356724124e-15
K_B = 1.380649e-16
M_U = 1.66053906892e-24
MU = 2.33 * M_U
T0 = 1.0e7
T1 = 2.0e7
RHO0 = 1.2
WIDTH = 24.0
KAPPA0 = 100.0
V0_ADV = 1.0e6
ERAD_FLOOR = A_RAD * T0**4 * 1.0e-10


def _over(a: float, t: torch.Tensor) -> torch.Tensor:
    """a / t for a Python float a, divided (PyTorch's reflected division
    multiplies by a reciprocal)."""
    return torch.full((), a, dtype=t.dtype, device=t.device) / t


def exact_T(x: torch.Tensor) -> torch.Tensor:
    return T0 + (T1 - T0) * exp(div(-x * x, 2.0 * WIDTH**2))


def exact_rho(x: torch.Tensor) -> torch.Tensor:
    T = exact_T(x)
    return _over(RHO0 * T0, T) + (A_RAD * MU / (3.0 * K_B)) * (
        _over(T0**4, T) - T * (T * T))


def _pulse_state(problem, grid, dtype, device, fractions):
    """The pulse's state [nvar, ...] in float64 on `device`, cast to
    `dtype`: the grey radiation energy split among the groups by
    `fractions` (a callable of T, [G, ...]; ones for one group, whose
    product with them is exact)."""
    x, _y, _z = grid.cell_center_mesh(torch.float64, device)
    layout = problem.physics.layout()
    eos = problem.make_eos()
    x0 = 0.5 * (grid.prob_lo[0] + grid.prob_hi[0])
    T = exact_T(x - x0).expand(grid.n_cell)
    rho = exact_rho(x - x0).expand(grid.n_cell)
    Erad = A_RAD * ((T * T) * (T * T))  # T**4 as XLA's integer_pow
    eint = eos.eint_from_tgas(rho, T)
    v0 = problem.v0
    beta2 = (v0 / C_CGS) ** 2
    U = torch.zeros((layout.nvar, *grid.n_cell), dtype=dtype, device=device)
    U[RHO] = rho
    U[MX1] = rho * v0
    U[EGAS] = eint + 0.5 * rho * v0 * v0
    U[EINT] = eint
    # comoving -> lab frame to O(beta^2) (reference :168-176)
    fr = fractions(T)
    for g in range(layout.n_groups):
        U[layout.rad_index(g, 0)] = (1.0 + (4.0 / 3.0) * beta2) * fr[g] * Erad
        U[layout.rad_index(g, 1)] = (4.0 / 3.0) * v0 * fr[g] * Erad
    return U


@register_problem
class RadhydroPulseProblem(Problem):
    name = "RadhydroPulse"
    physics = PhysicsTraits(hydro_enabled=True, radiation_enabled=True)
    eos_traits = EOSTraits(gamma=5.0 / 3.0, mean_molecular_weight=MU,
                           boltzmann_constant=K_B)
    rad = RadTraits(c_light=C_CGS, c_hat=C_CGS, radiation_constant=A_RAD,
                    Erad_floor=ERAD_FLOOR, beta_order=1)
    bcs = BCSpec()  # periodic
    planck_opacity = PowerLawOpacity(KAPPA0)  # flux mean: the same

    v0: float = 0.0  # V0_ADV for the advecting variant

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        return _pulse_state(self, grid, dtype, device, lambda T: torch.ones_like(T)[None])


# ------------------------------------------------------------------ variants
# (the reference splits the pulse across four problem dirs; the base
# RadhydroPulse above is the "Grey" configuration, kappa0 = 100)
H_PLANCK = 6.62607015e-27
PULSE_MG_EDGES = (1.0e15, 1.0e16, 1.0e17, 1.0e18, 1.0e19)
KAPPA0_DYN = 500.0
V0_DYN = 3.0e7
NU_REF = 1.0e18
COEFF_NU = H_PLANCK * NU_REF / (K_B * T0)  # = 4.799...


@register_problem
class RadhydroPulseGreyProblem(RadhydroPulseProblem):
    """Alias configuration (reference RadhydroPulseGrey, kappa0 = 100, the
    base RadhydroPulse; registered for catalog parity)."""

    name = "RadhydroPulseGrey"


@register_problem
class RadhydroPulseDynProblem(RadhydroPulseProblem):
    """Dynamic-diffusion variant (reference RadhydroPulseDyn): kappa0 = 500,
    v0 = 3e7 cm/s, so beta tau is an order of magnitude larger and the
    radiation is advected with the gas."""

    name = "RadhydroPulseDyn"
    v0: float = V0_DYN
    planck_opacity = PowerLawOpacity(KAPPA0_DYN)


def _kappa_nu(nu: float, T: torch.Tensor) -> torch.Tensor:
    """kappa(nu, T) of the MG-integrated variant (reference
    ``test_radhydro_pulse_MG_int.cpp:163-169``), in cm^2/g at rho = 1."""
    T_ = div(T, T0)
    nu_ = nu / NU_REF
    return (KAPPA0 * pow(T_, -0.5) * nu_**-3.0
            * (1.0 - exp(_over(-COEFF_NU * nu_, T_))))


class _PulseMGBase(RadhydroPulseProblem):
    physics = PhysicsTraits(hydro_enabled=True, radiation_enabled=True, n_groups=4)
    rad = RadTraits(c_light=C_CGS, c_hat=C_CGS, radiation_constant=A_RAD,
                    Erad_floor=ERAD_FLOOR / 4, beta_order=1,
                    group_edges=PULSE_MG_EDGES, energy_unit=H_PLANCK)

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        return _pulse_state(self, grid, dtype, device, lambda T: planck_energy_fractions(
            PULSE_MG_EDGES, T, K_B, H_PLANCK))


@register_problem
class RadhydroPulseMGconstProblem(_PulseMGBase):
    """4 groups with the same constant opacity in every group (reference
    RadhydroPulseMGconst): the group-summed solution reproduces the grey
    pulse."""

    name = "RadhydroPulseMGconst"

    def compute_group_opacities(self, boundaries, rho, T):
        return torch.full((4, *rho.shape), KAPPA0, dtype=rho.dtype, device=rho.device)


@register_problem
class RadhydroPulseMGintProblem(_PulseMGBase):
    """4 groups with the nu- and T-dependent kappa integrated by the PPL
    fixed-slope model (reference RadhydroPulseMGint: the exponents from the
    log-ratio of the edge opacities, the values at the groups' lower
    edges)."""

    name = "RadhydroPulseMGint"

    def define_opacity_exponents_and_lower_values(self, boundaries, rho, T):
        alphas, ks = [], []
        for g in range(4):
            k_dn = _kappa_nu(boundaries[g], T)
            k_up = _kappa_nu(boundaries[g + 1], T)
            alpha = div(log(k_up / k_dn),
                        math.log(boundaries[g + 1] / boundaries[g]))
            alphas.append(alpha * torch.ones_like(rho))
            ks.append(k_dn / rho)
        return torch.stack(alphas), torch.stack(ks)

    def compute_group_opacities(self, boundaries, rho, T):
        ks = []
        for g in range(4):
            nu_c = (boundaries[g] * boundaries[g + 1]) ** 0.5
            ks.append(_kappa_nu(nu_c, T) / rho)
        return torch.stack(ks)
