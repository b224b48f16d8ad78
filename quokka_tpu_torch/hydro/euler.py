"""Compressible Euler per-cell functions (cons<->prim, floors, dual energy).

Counterpart of `quokka_tpu.hydro.euler` (reference `HydroSystem`,
``src/hydro/hydro_system.hpp:47``). State layout ``U[nvar, nx, ny, nz]``
with components rho, mx, my, mz, E_total, rho*e_aux [, scalars...].
Every expression keeps the JAX package's operation order, so both packages
round alike.
"""

from __future__ import annotations

import torch

from .._numerics import sqrt
from ..eos import IdealGasEOS
from ..indices import EGAS, EINT, MX1, MX2, MX3, PPRES, PRHO, RHO, SCALAR0


def cons_to_prim(U: torch.Tensor, eos: IdealGasEOS,
                 reconstruct_eint: bool) -> torch.Tensor:
    """Conserved -> primitive variables (reference `ConservedToPrimitive`).

    Primitive components: rho, vx, vy, vz, (P or e_spec), (rho*e_aux or
    e_aux_spec), scalars... depending on `reconstruct_eint`."""
    rho = U[RHO]
    inv_rho = 1.0 / rho
    vx = U[MX1] * inv_rho
    vy = U[MX2] * inv_rho
    vz = U[MX3] * inv_rho
    ke = 0.5 * rho * (vx * vx + vy * vy + vz * vz)
    Eint_cons = U[EGAS] - ke
    Eint_aux = U[EINT]
    if reconstruct_eint:
        p_slot = Eint_cons * inv_rho
        e_slot = Eint_aux * inv_rho
    else:
        p_slot = eos.pressure(rho, Eint_cons)
        e_slot = Eint_aux
    prim = torch.stack([rho, vx, vy, vz, p_slot, e_slot])
    if U.shape[0] > SCALAR0:
        prim = torch.cat([prim, U[SCALAR0:]], dim=0)
    return prim


def pressure_from_prim(prim: torch.Tensor, eos: IdealGasEOS,
                       reconstruct_eint: bool) -> torch.Tensor:
    """Gas pressure from the primitive array (slot meaning depends on mode)."""
    rho = prim[PRHO]
    if eos.is_isothermal:
        return rho * eos.cs_isothermal**2
    if reconstruct_eint:
        return eos.pressure(rho, rho * prim[PPRES])
    return prim[PPRES]


def _ke(U: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    return 0.5 * (U[MX1] * U[MX1] + U[MX2] * U[MX2] + U[MX3] * U[MX3]) / rho


def pressure(U: torch.Tensor, eos: IdealGasEOS) -> torch.Tensor:
    """Gas pressure from conserved variables (from E - KE)."""
    rho = U[RHO]
    ke = _ke(U, rho)
    if eos.is_isothermal:
        return rho * eos.cs_isothermal**2
    return eos.pressure(rho, U[EGAS] - ke)


def max_signal_speed(U: torch.Tensor, eos: IdealGasEOS) -> torch.Tensor:
    """|v| + cs per cell (reference `ComputeMaxSignalSpeed`)."""
    rho = U[RHO]
    vx = U[MX1] / rho
    vy = U[MX2] / rho
    vz = U[MX3] / rho
    vmag = sqrt(vx * vx + vy * vy + vz * vz)
    return eos.sound_speed(rho, pressure(U, eos)) + vmag


def is_state_valid(U: torch.Tensor, eos: IdealGasEOS) -> torch.Tensor:
    """Per-cell validity mask (reference `isStateValid`): positive density
    (+ positive conserved internal energy for a non-isothermal EOS, + finite
    values)."""
    rho = U[RHO]
    ok = rho > 0.0
    if not eos.is_isothermal:
        ke = _ke(U, torch.where(ok, rho, torch.ones_like(rho)))
        ok = ok & ((U[EGAS] - ke) > 0.0)
    return ok & torch.isfinite(U).all(dim=0)


def enforce_limits(U: torch.Tensor, eos: IdealGasEOS, density_floor: float,
                   temperature_floor: float, n_scalars: int = 0) -> torch.Tensor:
    """Density/temperature floors (reference `EnforceLimits`): raise rho
    and rescale passive scalars; the temperature floor applies to E - KE and
    to the auxiliary internal energy independently. Returns a new tensor."""
    rho = U[RHO]
    rho_new = torch.clamp(rho, min=density_floor)
    out = U.clone()
    out[RHO] = rho_new
    if n_scalars > 0:
        scale = torch.where(rho_new > 0.0, rho / rho_new, torch.zeros_like(rho))
        scale = torch.where(rho < density_floor, scale, torch.ones_like(rho))
        out[SCALAR0:] = out[SCALAR0:] * scale[None]
    if not eos.is_isothermal and temperature_floor > 0.0:
        ke = _ke(out, rho_new)
        eint_floor = eos.eint_from_tgas(rho_new, temperature_floor)
        out[EGAS] = ke + torch.maximum(out[EGAS] - ke, eint_floor)
        out[EINT] = torch.maximum(out[EINT], eint_floor)
    return out


def sync_dual_energy(U: torch.Tensor, eta: float = 1.0e-3) -> torch.Tensor:
    """Li et al. dual-energy sync after each RK stage (reference
    `SyncDualEnergy`): if (E - KE) > eta*E, set Eint_aux = E - KE; else set
    E = Eint_aux + KE. Returns a new tensor."""
    ke = _ke(U, U[RHO])
    Etot = U[EGAS]
    Eint_cons = Etot - ke
    use_cons = Eint_cons > eta * Etot
    out = U.clone()
    out[EINT] = torch.where(use_cons, Eint_cons, U[EINT])
    out[EGAS] = torch.where(use_cons, Etot, U[EINT] + ke)
    return out
