r"""Planck integral: photon-group energy fractions.

Counterpart of `quokka_tpu.radiation.planck` (the reference's tabulated
Planck integral, ``src/radiation/planck_integral.hpp:14-40``): the
normalized integral y(x) = (15/pi^4) \int_0^x t^3/(e^t - 1) dt is tabulated
on a fine grid in numpy float64 at import and evaluated by linear
interpolation in the input's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

_X_MAX = 100.0
_N_TAB = 4000


def _build_table():
    # the integrand is smooth; resolve the small-x region logarithmically
    x = np.concatenate([
        np.array([0.0]),
        np.logspace(-3, np.log10(_X_MAX), _N_TAB - 1),
    ])
    t = x
    with np.errstate(over="ignore", invalid="ignore"):
        f = np.where(t > 0, t**3 / np.expm1(t), 0.0)
    # cumulative trapezoid
    y = np.concatenate([[0.0], np.cumsum(0.5 * (f[1:] + f[:-1]) * np.diff(t))])
    y *= 15.0 / np.pi**4
    return x, y


_X_TAB, _Y_TAB = _build_table()
_TABLES: dict = {}


def _tables(dtype, device):
    """The tables cast once to `dtype` on `device`, as the JAX package casts
    them to the input's dtype."""
    key = (dtype, str(device))
    if key not in _TABLES:
        _TABLES[key] = (torch.tensor(_X_TAB, dtype=dtype, device=device),
                        torch.tensor(_Y_TAB, dtype=dtype, device=device))
    return _TABLES[key]


def integrate_planck_from_0_to_x(x: torch.Tensor) -> torch.Tensor:
    """Normalized Planck integral y(x) in [0, 1], in x's dtype: 1 from
    x >= 100, else the table interpolated in the form of `jnp.interp`,
    fp[i-1] + ((x - xp[i-1]) / (xp[i] - xp[i-1])) * (fp[i] - fp[i-1]) with
    i the right insertion index clipped to [1, n-1], the end values outside
    the table."""
    xp, fp = _tables(x.dtype, x.device)
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.numel() - 1)
    xl, xr, fl, fr = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = xr - xl
    # jnp.interp guards a zero-width interval; the table has none
    f = fl + ((x - xl) / dx) * (fr - fl)
    f = torch.where(x < xp[0], fp[0], f)
    f = torch.where(x > xp[-1], fp[-1], f)
    return torch.where(x >= _X_MAX, torch.ones((), dtype=x.dtype, device=x.device), f)


def planck_energy_fractions(boundaries, T: torch.Tensor, boltzmann_constant: float = 1.0,
                            energy_unit: float = 1.0) -> torch.Tensor:
    """Radiation energy fraction per photon group at temperature T
    (reference `ComputePlanckEnergyFractions`, ``radiation_system.hpp:
    744-771``): the fractions of a T^4 between the group boundaries (in
    energy units), the last group taking the remainder so that the total
    is exactly 1. boundaries: G + 1 floats; returns [G, *T.shape]."""
    G = len(boundaries) - 1
    if G == 1:
        return torch.ones((1, *T.shape), dtype=T.dtype, device=T.device)
    kT = boltzmann_constant * T
    fracs = []
    prev = torch.zeros_like(T)
    for g in range(G - 1):
        # a Python float over a tensor divides (PyTorch's reflected division
        # multiplies by a reciprocal)
        x = torch.full((), boundaries[g + 1] * energy_unit, dtype=T.dtype,
                       device=T.device) / kT
        y = integrate_planck_from_0_to_x(x)
        fracs.append(y - prev)
        prev = y
    fracs.append(1.0 - prev)
    return torch.stack(fracs)
