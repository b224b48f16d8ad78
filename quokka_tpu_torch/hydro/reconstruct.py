"""Reconstruction operators: donor-cell, PLM (minmod/MC), PPM + flattening.

Counterpart of `quokka_tpu.hydro.reconstruct` (reference
``src/hyperbolic_system.hpp:44-432`` and the Miller & Colella 2002 shock
flattening, ``src/hydro/hydro_system.hpp:531-696``). Face arrays use the
"face f lies between cells f-1 and f" convention.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..eos import IdealGasEOS
from ..indices import PRHO, PVX1
from ..stencil import sh, sh_bc
from .euler import pressure_from_prim


def minmod(a, b):
    return 0.5 * (torch.sign(a) + torch.sign(b)) * torch.minimum(
        torch.abs(a), torch.abs(b))


def mc_limiter(a, b):
    """Monotonized-central limiter (reference `MC`)."""
    return 0.5 * (torch.sign(a) + torch.sign(b)) * torch.minimum(
        0.5 * torch.abs(a + b),
        torch.minimum(2.0 * torch.abs(a), 2.0 * torch.abs(b)))


def donor_cell_faces(P: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-order: face f gets the adjacent cell averages."""
    return sh(P, -1, axis + 1), P


def plm_faces(P: torch.Tensor, axis: int, limiter: str = "minmod"):
    """Piecewise-linear with limited slopes (reference `ReconstructStatesPLM`)."""
    ax = axis + 1
    lim = minmod if limiter == "minmod" else mc_limiter
    slope = lim(sh(P, 1, ax) - P, P - sh(P, -1, ax))
    qL = sh(P, -1, ax) + 0.5 * sh(slope, -1, ax)
    qR = P - 0.5 * slope
    return qL, qR


def ppm_faces(P: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """PPM interface states (CW84 + Mignone 2014 monotonicity): a 4th-order
    interface estimate grouped for FP symmetry, clamped to the 3-cell range,
    PLM (MC slope) at local extrema, CW84 overshoot resets elsewhere.
    Returns (qL, qR) at faces: qL(f) from cell f-1, qR(f) from cell f."""
    ax = axis + 1
    qm2, qm1, q0, qp1, qp2 = (sh(P, -2, ax), sh(P, -1, ax), P,
                              sh(P, 1, ax), sh(P, 2, ax))
    lo = torch.minimum(torch.minimum(qm1, q0), qp1)
    hi = torch.maximum(torch.maximum(qm1, q0), qp1)

    c1 = 7.0 / 12.0
    c2 = -1.0 / 12.0
    # grouped to preserve exact FP symmetry (Athena++-style)
    a_minus = (c1 * q0 + c2 * qp1) + (c1 * qm1 + c2 * qm2)
    a_plus = (c1 * qp1 + c2 * qp2) + (c1 * q0 + c2 * qm1)
    a_minus = torch.clamp(a_minus, lo, hi)
    a_plus = torch.clamp(a_plus, lo, hi)

    dq_minus = q0 - a_minus
    dq_plus = a_plus - q0
    extremum = (dq_plus * dq_minus) <= 0.0

    dq0 = mc_limiter(qp1 - q0, q0 - qm1)
    ext_minus = q0 - 0.5 * dq0
    ext_plus = q0 + 0.5 * dq0

    reset_minus = torch.abs(dq_minus) >= 2.0 * torch.abs(dq_plus)
    reset_plus = torch.abs(dq_plus) >= 2.0 * torch.abs(dq_minus)
    mono_minus = torch.where(reset_minus, q0 - 2.0 * dq_plus, a_minus)
    mono_plus = torch.where(reset_plus, q0 + 2.0 * dq_minus, a_plus)

    new_minus = torch.where(extremum, ext_minus, mono_minus)
    new_plus = torch.where(extremum, ext_plus, mono_plus)
    return sh(new_plus, -1, ax), new_minus


def reconstruct_faces(P: torch.Tensor, axis: int, order: int):
    if order == 3:
        return ppm_faces(P, axis)
    if order == 2:
        return plm_faces(P, axis, "minmod")
    if order == 1:
        return donor_cell_faces(P, axis)
    raise ValueError(f"invalid reconstruction order {order}")


def flattening_chi(prim: torch.Tensor, axis: int, eos: IdealGasEOS,
                   reconstruct_eint: bool, bc_axis=None) -> torch.Tensor:
    """Per-cell flattening coefficient chi for sweeps along `axis`
    (reference `ComputeFlatteningCoefficients`; Miller & Colella 2002 eqs
    74-77). `bc_axis=(lo_kind, hi_kind)` reads across walls of an unpadded
    field with `sh_bc`; None keeps plain roll semantics."""
    beta_max, beta_min = 0.85, 0.75
    Zmax, Zmin = 0.75, 0.25

    if bc_axis is None:
        def shp(A, k, odd=False):
            return sh(A, k, axis)
    else:
        lo_k, hi_k = bc_axis

        def shp(A, k, odd=False):
            return sh_bc(A, k, axis, lo_k, hi_k, odd)

    Pg = pressure_from_prim(prim, eos, reconstruct_eint)
    Pp1, Pm1 = shp(Pg, 1), shp(Pg, -1)
    Pp2, Pm2 = shp(Pg, 2), shp(Pg, -2)

    beta_denom = torch.abs(Pp2 - Pm2)
    nz = beta_denom != 0.0
    beta = torch.where(
        nz, torch.abs(Pp1 - Pm1) / torch.where(nz, beta_denom, torch.ones_like(Pg)),
        torch.zeros_like(Pg))
    chi_min = torch.clamp((beta_max - beta) / (beta_max - beta_min), 0.0, 1.0)

    rho = prim[PRHO]
    if eos.is_isothermal:
        K_S = rho * eos.cs_isothermal**2
    else:
        cs = eos.sound_speed(rho, Pg)
        K_S = cs * cs * rho
    Z = torch.abs(Pp1 - Pm1) / K_S

    vel = prim[PVX1 + axis]
    converging = shp(vel, 1, odd=True) < shp(vel, -1, odd=True)
    chi_conv = torch.maximum(
        chi_min, torch.clamp((Zmax - Z) / (Zmax - Zmin), max=1.0))
    return torch.where(converging, chi_conv, torch.ones_like(chi_conv))
