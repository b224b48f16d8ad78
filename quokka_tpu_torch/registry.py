"""Problem definition API: traits + problem classes + a name registry.

Counterpart of `quokka_tpu.registry` for the unigrid hydro and single-group
radhydro slices: the traits, the boundary-condition spec and the problem
hooks that the Simulation calls. The cooling, gravity and particle hooks
are not part of the port yet.

Opacities: a CUDA kernel cannot call a Python hook, so a problem states
each mean opacity as a `PowerLawOpacity` (kappa = kappa0 rho^a T^b), which
the kernels evaluate per cell. The hooks of the JAX package
(`compute_planck_opacity`, `compute_energy_mean_opacity`,
`compute_flux_mean_opacity`, energy and flux defaulting to Planck) keep
their names and evaluate the same laws; a problem may still override a
hook for the plain path, and the kernels then refuse it. Multigroup
problems state their group opacities in the hooks
`compute_group_opacities` and `define_opacity_exponents_and_lower_values`,
which the plain multigroup coupling calls (no kernel evaluates them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Type

import torch

from ._numerics import sqrt
from .eos import C_LIGHT_CGS, IdealGasEOS
from .indices import StateLayout


@dataclass(frozen=True)
class PhysicsTraits:
    """Which physics are enabled (reference `Physics_Traits`)."""

    hydro_enabled: bool = True
    radiation_enabled: bool = False
    mhd_enabled: bool = False
    gravity_enabled: bool = False
    n_scalars: int = 0  # passive scalars
    n_mscalars: int = 0  # mass scalars (subset of passive scalars)
    n_groups: int = 1  # radiation groups

    def layout(self) -> StateLayout:
        return StateLayout(
            hydro_enabled=self.hydro_enabled,
            radiation_enabled=self.radiation_enabled,
            n_scalars=self.n_scalars,
            n_mscalars=self.n_mscalars,
            n_groups=self.n_groups,
        )


@dataclass(frozen=True)
class EOSTraits:
    """EOS constants (reference `quokka::EOS_Traits`)."""

    gamma: float = 5.0 / 3.0
    mean_molecular_weight: float = 1.66053906892e-24
    boltzmann_constant: float = 1.380649e-16
    cs_isothermal: float = float("nan")

    def make_eos(self) -> IdealGasEOS:
        return IdealGasEOS(
            gamma=self.gamma,
            mean_molecular_weight=self.mean_molecular_weight,
            boltzmann_constant=self.boltzmann_constant,
            cs_isothermal=self.cs_isothermal,
        )


@dataclass(frozen=True)
class HydroTraits:
    """Hydro solver options (reference `HydroSystem_Traits`)."""

    reconstruct_eint: bool = True  # reconstruct e_int instead of pressure


@dataclass(frozen=True)
class RadTraits:
    """Radiation solver constants (reference `RadSystem_Traits`,
    ``src/radiation/radiation_system.hpp:73-84``)."""

    c_light: float = C_LIGHT_CGS
    c_hat: float = C_LIGHT_CGS  # reduced speed of light
    radiation_constant: float = 7.565731356724124e-15
    Erad_floor: float = 0.0
    beta_order: int = 1  # relativistic correction order in v/c
    energy_unit: float = 1.0  # converts group boundaries to erg if needed
    group_edges: Tuple[float, ...] = ()  # photon energy group boundaries


@dataclass(frozen=True)
class PowerLawOpacity:
    """kappa = kappa0 * rho**rho_exp * T**T_exp [cm^2/g], the form the CUDA
    radiation kernels evaluate. Each factor is applied only when its
    exponent is non-zero, in this order, with `power`, so the kernels and
    this plain evaluation round alike."""

    kappa0: float
    rho_exp: float = 0.0
    T_exp: float = 0.0

    def __call__(self, rho, T):
        k = torch.full_like(rho, self.kappa0)
        if self.rho_exp != 0.0:
            k = k * power(rho, self.rho_exp)
        if self.T_exp != 0.0:
            k = k * power(T, self.T_exp)
        return k


def power(x: torch.Tensor, a: float) -> torch.Tensor:
    """x**a as the CUDA kernels evaluate it (`ipow` of csrc/rad_common.cuh):
    exponents 1, -1, 2 and 0.5 by exact operations, any other by pow (CUDA's
    powf on the card)."""
    if a == 1.0:
        return x
    if a == -1.0:
        return 1.0 / x
    if a == 2.0:
        return x * x
    if a == 0.5:
        return sqrt(x)
    return torch.pow(x, a)


# Boundary condition kinds per (axis, side); mirrors amrex::BCType.
BC_PERIODIC = "periodic"
BC_OUTFLOW = "outflow"
BC_REFLECT = "reflect"
BC_USER = "user"
BC_NSCBC_OUTFLOW = "nscbc_outflow"
BC_NSCBC_INFLOW = "nscbc_inflow"


@dataclass(frozen=True)
class BCSpec:
    """Boundary conditions: one kind per (axis, lo/hi side)."""

    x: Tuple[str, str] = (BC_PERIODIC, BC_PERIODIC)
    y: Tuple[str, str] = (BC_PERIODIC, BC_PERIODIC)
    z: Tuple[str, str] = (BC_PERIODIC, BC_PERIODIC)

    def axis(self, d: int) -> Tuple[str, str]:
        return (self.x, self.y, self.z)[d]

    def is_periodic(self, d: int) -> bool:
        lo, hi = self.axis(d)
        return lo == BC_PERIODIC and hi == BC_PERIODIC


class Problem:
    """Base class for problem definitions.

    Subclasses override trait attributes and hooks:
      - set_initial_conditions(grid, dtype, device) -> U[nvar, nx, ny, nz]
      - fill_user_boundary(Ug, grid, ng, time, axis, side) (BC_USER walls)
      - compute_reference_solution(sim) -> U_exact or None (the error norm)
      - compute_before_timestep(sim), compute_after_evolve(sim)
      - external_acceleration(grid, dtype, device) -> g[3, nx, ny, nz] or
        None (a static external acceleration, kicked after each hydro step)
      - radiation: the opacity laws (`planck_opacity`, and optionally
        `energy_mean_opacity` / `flux_mean_opacity`), the multigroup
        opacity hooks and set_radiation_energy_source(grid, time, dtype,
        device)
    """

    name: str = "problem"
    physics: PhysicsTraits = PhysicsTraits()
    eos_traits: EOSTraits = EOSTraits()
    hydro: HydroTraits = HydroTraits()
    rad: RadTraits = RadTraits()
    bcs: BCSpec = BCSpec()
    planck_opacity: Optional[PowerLawOpacity] = None
    energy_mean_opacity: Optional[PowerLawOpacity] = None  # None: Planck's
    flux_mean_opacity: Optional[PowerLawOpacity] = None  # None: Planck's

    def make_eos(self):
        return self.eos_traits.make_eos()

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        raise NotImplementedError

    def fill_user_boundary(self, Ug, grid, ng, time, axis, side):
        """Fill the BC_USER ghost cells of side `side` (0 lo, 1 hi) of `axis`
        in the padded tensor Ug (padded along the axes up to `axis`, `ng`
        the ghost widths of the fill) and return it; writing into Ug in
        place is allowed (`quokka_tpu/registry.py:150-155`)."""
        raise NotImplementedError(
            f"{type(self).__name__} declares BC_USER but does not implement "
            "fill_user_boundary()")

    def compute_reference_solution(self, sim):
        """The exact solution at `sim.t` ([nvar, nx, ny, nz], any array), for
        the error norm that `Simulation.evolve` reports; None: no norm."""
        return None

    # ---- radiation opacity hooks (reference `ComputePlanckOpacity` etc.,
    # ``src/radiation/radiation_system.hpp:1141-1154``; energy-mean and
    # flux-mean default to the Planck mean)
    def compute_planck_opacity(self, rho, T):
        if self.planck_opacity is None:
            raise NotImplementedError(
                f"{type(self).__name__} enables radiation but defines no Planck opacity")
        return self.planck_opacity(rho, T)

    def compute_energy_mean_opacity(self, rho, T):
        if self.energy_mean_opacity is not None:
            return self.energy_mean_opacity(rho, T)
        return self.compute_planck_opacity(rho, T)

    def compute_flux_mean_opacity(self, rho, T):
        if self.flux_mean_opacity is not None:
            return self.flux_mean_opacity(rho, T)
        return self.compute_planck_opacity(rho, T)

    # ---- multigroup opacity hooks (`quokka_tpu/registry.py:258-275`)
    def define_opacity_exponents_and_lower_values(self, boundaries, rho, T):
        """PPL opacity model: per-group power-law exponent alpha_g and
        opacity at the group's lower edge kappa_g(nu_g), both [G, ...]
        (reference `DefineOpacityExponentsAndLowerValues`,
        ``src/radiation/radiation_system.hpp:280-282``). Default: a flat
        spectrum (alpha = 0) at the piecewise-constant group opacities."""
        k = self.compute_group_opacities(boundaries, rho, T)
        return torch.zeros_like(k), k

    def compute_group_opacities(self, boundaries, rho, T):
        """Per-group opacities [G, ...] of the piecewise-constant model
        (reference `DefineOpacityExponentsAndLowerValues` with
        `piecewise_constant_opacity`). Default: the Planck opacity in every
        group."""
        G = len(boundaries) - 1
        k = self.compute_planck_opacity(rho, T)
        return k[None].expand(G, *k.shape)

    def opacity_laws(self) -> Tuple[PowerLawOpacity, PowerLawOpacity, PowerLawOpacity]:
        """(Planck, energy-mean, flux-mean) laws for the CUDA kernels. A
        problem that computes an opacity in an overridden hook has no law the
        kernels can evaluate: NotImplementedError names it."""
        for hook in ("compute_planck_opacity", "compute_energy_mean_opacity",
                     "compute_flux_mean_opacity"):
            if getattr(type(self), hook) is not getattr(Problem, hook):
                raise NotImplementedError(
                    f"problem {self.name!r} computes its opacity in {hook}(); the "
                    "CUDA radiation kernels evaluate only a PowerLawOpacity")
        if self.planck_opacity is None:
            raise NotImplementedError(
                f"problem {self.name!r} enables radiation but defines no Planck opacity")
        P = self.planck_opacity
        return P, self.energy_mean_opacity or P, self.flux_mean_opacity or P

    def set_radiation_energy_source(self, grid, time, dtype=torch.float64,
                                    device="cuda"):
        """User radiation energy source dE/dt (reference `SetRadEnergySource`);
        zero by default."""
        return torch.zeros(grid.n_cell, dtype=dtype, device=device)

    def external_acceleration(self, grid, dtype=torch.float64, device="cuda"):
        """Static external acceleration field g[3, nx, ny, nz] (the constant
        gravity of the Rayleigh-Taylor problems), or None for none
        (`quokka_tpu/registry.py:190-193`); `Simulation` applies it as an
        operator-split kick after each hydro step."""
        return None

    def compute_before_timestep(self, sim):
        pass

    def compute_after_evolve(self, sim):
        pass


_PROBLEMS: Dict[str, Type[Problem]] = {}


def register_problem(cls: Type[Problem]) -> Type[Problem]:
    """Class decorator: register a problem under its `name` attribute."""
    _PROBLEMS[cls.name] = cls
    return cls


def get_problem(name: str) -> Type[Problem]:
    return _PROBLEMS[name]
