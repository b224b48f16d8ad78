"""Equation of state: gamma-law ideal gas (+ isothermal mode), on tensors.

Counterpart of `quokka_tpu.eos` (reference ``src/hydro/EOS.hpp:39``):

    P = (gamma - 1) rho e          cs = sqrt(gamma P / rho)
    T = (mu / k_B) (gamma - 1) e   e = specific internal energy

Python-float constants combine in double precision before they meet a
tensor, exactly as the JAX package's weakly typed scalars do, so an f32
state rounds the same way in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ._numerics import div, sqrt

# CGS constants (match AMReX-Microphysics usage in the reference)
K_BOLTZMANN_CGS = 1.380649e-16  # erg/K
M_U_CGS = 1.66053906892e-24  # atomic mass unit, g
C_LIGHT_CGS = 2.99792458e10  # cm/s


@dataclass(frozen=True)
class IdealGasEOS:
    """Gamma-law EOS with configurable constants."""

    gamma: float = 5.0 / 3.0
    mean_molecular_weight: float = M_U_CGS  # mu (grams)
    boltzmann_constant: float = K_BOLTZMANN_CGS
    cs_isothermal: float = float("nan")  # used only when gamma == 1

    @property
    def is_isothermal(self) -> bool:
        return self.gamma == 1.0

    @property
    def c_v(self) -> float:
        """Specific heat at constant volume (per unit mass)."""
        return self.boltzmann_constant / (
            self.mean_molecular_weight * (self.gamma - 1.0)
        )

    def pressure(self, rho, eint):
        """P(rho, Eint) with Eint = rho*e the internal energy density."""
        if self.is_isothermal:
            return rho * self.cs_isothermal**2
        return (self.gamma - 1.0) * eint

    def eint_from_pres(self, rho, P):
        """Internal energy density (rho*e) from pressure, divided on every
        device (`_numerics.div`: the CUDA kernels divide, where PyTorch's
        CUDA division by a Python number multiplies by its reciprocal)."""
        del rho
        if self.is_isothermal:
            return torch.zeros_like(P)
        return div(P, self.gamma - 1.0)

    def sound_speed(self, rho, P):
        if self.is_isothermal:
            return torch.full_like(rho, self.cs_isothermal)
        return sqrt(self.gamma * P / rho)

    def tgas_from_eint(self, rho, eint):
        """T from internal energy density (rho*e); ideal gas."""
        return eint / (rho * self.c_v)

    def eint_from_tgas(self, rho, T):
        return rho * self.c_v * T

    def eint_temp_derivative(self, rho, T):
        """d(Eint)/dT at constant rho (= rho * c_v)."""
        del T
        return rho * self.c_v
