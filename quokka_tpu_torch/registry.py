"""Problem definition API: traits + problem classes + a name registry.

Counterpart of `quokka_tpu.registry` for the hydro slice: the traits, the
boundary-condition spec and the problem hooks that the unigrid hydro Simulation
calls. The radiation, cooling and particle hooks are not part of the port
yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Type

import torch

from .eos import IdealGasEOS
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
      - compute_before_timestep(sim), compute_after_evolve(sim)
    """

    name: str = "problem"
    physics: PhysicsTraits = PhysicsTraits()
    eos_traits: EOSTraits = EOSTraits()
    hydro: HydroTraits = HydroTraits()
    bcs: BCSpec = BCSpec()

    def make_eos(self):
        return self.eos_traits.make_eos()

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cpu"):
        raise NotImplementedError

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
