"""Gas-radiation matter coupling: per-cell implicit Newton-Raphson solve.

Counterpart of `quokka_tpu.radiation.source_terms` (reference
`RadSystem::AddSourceTermsSingleGroup`,
``src/radiation/source_terms_single_group.hpp:10-565``), the Howell &
Greenough 2003 scheme as modified by He, Wibking & Krumholz 2024:

  - Newton-Raphson in (Egas, R) with R = D*tau the energy-exchange
    increment and the 2x2 Jacobian of the reference;
  - the velocity-dependent work term v.F (2 kappa_E - kappa_F) chat/c^2 dt,
    lagged through an outer iteration (at most 5);
  - the implicit flux/momentum update with the frozen Eddington tensor;
  - the stage-dependent gas update factor (IMEX_a32) and dt scaling.

This is the plain version of kernel K5 (`source.source_update`): whole-array
loops with per-cell convergence masks. A converged cell is frozen, so each
cell's result equals a per-cell loop that stops when that cell converges,
which is what the CUDA kernel runs. Single group (`multigroup.py` holds
the G-group coupling; `advance.RadiationAdvance._coupling` picks one, as
the JAX package's `source_update` does), beta_order 0 or 1, no dust;
`mixed_precision_coupling` is not ported.
"""

from __future__ import annotations

import torch

from .._numerics import div as _div
from .._numerics import sqrt
from ..indices import EGAS, EINT, MX1, RHO
from .system import IMEX_A32, RadOptions, eddington_tensor

RESID_TOL = 1.0e-11  # reference source_terms_single_group.hpp:158
MAX_NEWTON_ITER = 100
MAX_OUTER_ITER = 5
LAG_TOL = 1.0e-13


def resid_tol(dtype) -> float:
    """The reference's 1e-11 is out of reach in f32: max(1e-11, 50 eps)."""
    return max(RESID_TOL, 50.0 * torch.finfo(dtype).eps)


def _in_dtype(x: float, dtype) -> float:
    """A Python float rounded to `dtype` (-1e100 is -inf in float32, as a
    weakly typed JAX scalar becomes)."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _pow4(x):
    return (x * x) * (x * x)  # x**4 as XLA's integer_pow computes it


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def add_source_terms_single_group(U, rad_src, dt_radiation, stage: int,
                                  opts: RadOptions, eos, kappa_p, kappa_e,
                                  kappa_f, rad_start: int, counts: dict | None = None):
    """The implicit matter-coupling update of the state U [nvar, X, Y, Z];
    returns the new state. kappa_p/e/f: callables (rho, T) -> opacity.
    rad_src: the radiation energy source dE/dt [X, Y, Z], or None for none.
    `counts`, if given, accumulates the work this input needs, per cell as
    the kernel does it: ``newton_iters`` (Newton updates), ``newton_resid``
    (residual evaluations) and ``outer_iters`` (work-term re-solves); where
    it holds a list under ``cell_resid``, each Newton solve appends the
    residual evaluations of every cell (int32 [X, Y, Z]; 0 for a cell that
    the solve leaves frozen), the first solve, then each work-term
    re-solve."""
    if opts.mixed_precision_coupling:
        raise NotImplementedError("radiation.mixed_precision_coupling is not ported yet")
    if opts.n_groups != 1:
        raise ValueError("add_source_terms_single_group takes one photon group; G > 1 "
                         "goes to multigroup.add_source_terms_multi_group")
    c, chat = opts.c, opts.chat
    cscale = c / chat
    dt = dt_radiation if stage == 1 else (1.0 - IMEX_A32) * dt_radiation
    gas_update_factor = IMEX_A32 if stage == 1 else 1.0
    iE = rad_start

    rho = U[RHO]
    mom0 = [U[MX1], U[MX1 + 1], U[MX1 + 2]]
    Egastot0 = U[EGAS]
    Erad0 = U[iE]
    Frad0 = [U[iE + 1], U[iE + 2], U[iE + 3]]

    Src = 0.0 if rad_src is None else rad_src * dt * chat
    ke0 = 0.5 * _dot3(mom0, mom0) / rho
    Egas0 = Egastot0 - ke0
    Etot0 = Egas0 + cscale * (Erad0 + Src)
    isothermal = eos.is_isothermal
    cnt = counts
    if cnt is not None:
        for k in ("newton_iters", "newton_resid", "outer_iters"):
            cnt.setdefault(k, 0)

    def newton(work_init, active):
        return _newton_energy_exchange(Egas0, Erad0, rho, mom0, Frad0, Src, Etot0,
                                       dt, opts, eos, kappa_p, kappa_e, kappa_f,
                                       work_init, active, cnt)

    if not isothermal:
        (Egas_guess, Erad_guess, R, work, kappaP, kappaE, kappaF,
         fourPiBoverC) = newton(None, None)
    else:
        T_gas = torch.zeros_like(rho)
        kappaF = kappa_f(rho, T_gas)
        kappaP = kappa_p(rho, T_gas)
        kappaE = kappa_e(rho, T_gas)
        Egas_guess, Erad_guess = Egas0, Erad0
        fourPiBoverC = torch.zeros_like(rho)
        work = torch.zeros_like(rho)
        R = None

    def flux_update(Erad_g, kP, kE, kF, fourPiB):
        """Implicit flux update + momentum deposition (reference
        source_terms_single_group.hpp:389-478, beta_order <= 1)."""
        if opts.beta_order != 0 and not isothermal:
            erad = Erad_g
            Tedd = eddington_tensor(Frad0[0] / (c * erad), Frad0[1] / (c * erad),
                                    Frad0[2] / (c * erad))
            F_coeff = chat * rho * kF * dt
            Planck_term = kP * fourPiB + (kF - kE) * erad
            Frad_t1 = []
            for n in range(3):
                p_term = Planck_term * chat * dt * mom0[n]
                pressure_term = torch.zeros_like(erad)
                for z in range(3):
                    pressure_term = pressure_term + mom0[z] * Tedd[n][z] * erad
                pressure_term = pressure_term * chat * dt * kF
                Frad_t1.append((Frad0[n] + p_term + pressure_term) / (1.0 + F_coeff))
        else:
            denom = 1.0 + rho * kF * chat * dt
            Frad_t1 = [F / denom for F in Frad0]
        dMom = [_div(-(Frad_t1[n] - Frad0[n]), c * chat) for n in range(3)]
        return Frad_t1, dMom

    def work_term(Frad, dMom, kE, kF):
        mom1 = [mom0[n] + dMom[n] for n in range(3)]
        return _div(_dot3(mom1, Frad) * chat, c * c) * (2.0 * kE - kF) * dt

    def lag_converged(work_new, work_old, R_n):
        dwork = torch.abs(work_new - work_old)
        return ((torch.abs(work_new) == 0.0)
                | (cscale * dwork < LAG_TOL * Etot0)
                | (dwork <= LAG_TOL * torch.abs(R_n))
                | (dwork <= 1.0e-8 * torch.abs(work_new)))

    include_work = (not isothermal) and opts.beta_order != 0 and opts.include_work_term
    Frad_t1, dMom = flux_update(Erad_guess, kappaP, kappaE, kappaF, fourPiBoverC)
    if include_work:
        # outer loop: lag the work term, re-solving the energy exchange
        work_i = work_term(Frad_t1, dMom, kappaE, kappaF)
        done = lag_converged(work_i, work, R)
        work = torch.where(done, work, work_i)
        ite = 1
        while ite < MAX_OUTER_ITER and not bool(done.all()):
            active = ~done
            if cnt is not None:
                cnt["outer_iters"] += int(active.sum())
            Egas_n, Erad_n, R_n, _w, kP, kE, kF, fourPiB = newton(work, active)
            Frad_n, dMom_n = flux_update(Erad_n, kP, kE, kF, fourPiB)
            work_new = work_term(Frad_n, dMom_n, kE, kF)
            conv = lag_converged(work_new, work, R_n)
            Egas_guess = torch.where(done, Egas_guess, Egas_n)
            Erad_guess = torch.where(done, Erad_guess, Erad_n)
            R = torch.where(done, R, R_n)
            work = torch.where(done, work, work_new)
            Frad_t1 = [torch.where(done, Frad_t1[n], Frad_n[n]) for n in range(3)]
            dMom = [torch.where(done, dMom[n], dMom_n[n]) for n in range(3)]
            done = done | conv
            ite += 1

    # final state update with the stage factor
    mom1 = [mom0[n] + dMom[n] * gas_update_factor for n in range(3)]
    comps = list(U.unbind(0))
    comps[MX1:MX1 + 3] = mom1
    if not isothermal:
        Egas_final = Egas0 + (Egas_guess - Egas0) * gas_update_factor
        ke1 = 0.5 * _dot3(mom1, mom1) / rho
        comps[EINT] = Egas_final
        comps[EGAS] = Egas_final + ke1
        comps[iE] = Erad_guess
    comps[iE + 1:iE + 4] = Frad_t1
    return torch.stack(comps)


def _newton_energy_exchange(Egas0, Erad0, rho, mom0, Frad0, Src, Etot0, dt,
                            opts: RadOptions, eos, kappa_p, kappa_e, kappa_f,
                            work_init, active, cnt: dict | None):
    """Whole-array Newton-Raphson for the (Egas, R) system (reference
    source_terms_single_group.hpp:104-360, single group, no dust). `active`
    (None: every cell) selects the cells whose work `cnt` counts (None: no
    counting). Returns (Egas, Erad, R, work, kappaP, kappaE, kappaF,
    fourPiBoverC)."""
    c, chat = opts.c, opts.chat
    cscale = c / chat
    arad = opts.arad
    dtype = Egas0.dtype

    T0 = eos.tgas_from_eint(rho, Egas0)
    fourPiB = arad * _pow4(T0)
    kP = kappa_p(rho, T0)
    kE = kappa_e(rho, T0)
    kF = kappa_f(rho, T0)
    kPoE = torch.where(kE > 0.0, kP / kE, 1.0)
    if work_init is None:
        if opts.beta_order != 0 and opts.include_work_term:
            work = _div(_dot3(mom0, Frad0) * (2.0 * kE - kF) * chat, c * c) * dt
        else:
            work = torch.zeros_like(rho)
    else:
        work = work_init
    tau = dt * rho * kP * chat
    R = (fourPiB - Erad0 / kPoE) * tau + work
    tol = resid_tol(dtype)
    neg_big = _in_dtype(-1.0e100, dtype)

    Egas, Erad, T = Egas0, Erad0, T0
    done = torch.zeros_like(rho, dtype=torch.bool)
    per_cell = None
    if cnt is not None and "cell_resid" in cnt:
        per_cell = torch.zeros_like(rho, dtype=torch.int32)
        cnt["cell_resid"].append(per_cell)
    n = 0
    while n < MAX_NEWTON_ITER and not bool(done.all()):
        if cnt is not None:
            live = ~done if active is None else ~done & active
            cnt["newton_resid"] += int(live.sum())
            if per_cell is not None:
                per_cell += live
        F_G = Egas - Egas0 + cscale * R
        F_D = Erad - Erad0 - (R + Src)
        F_D_abs = torch.where(tau > 0.0, torch.abs(F_D), torch.abs(F_D + R))
        conv = (torch.abs(F_G) < tol * Etot0) & (cscale * F_D_abs < tol * Etot0)
        done = done | conv
        if cnt is not None:
            cnt["newton_iters"] += int((live & ~conv).sum())

        c_v = eos.eint_temp_derivative(rho, T)
        d_fourpiB_dT = 4.0 * arad * (T * (T * T))
        dEg_dT = kPoE * d_fourpiB_dT
        J00 = torch.ones_like(rho)
        J01 = torch.full_like(rho, cscale)
        J10 = dEg_dT / c_v
        J11 = torch.where(tau > 0.0, -kPoE / torch.where(tau > 0.0, tau, 1.0) - 1.0,
                          neg_big)
        det = J00 * J11 - J01 * J10
        y0 = -F_G
        y1 = -F_D
        dEgas = (J11 * y0 - J01 * y1) / det
        dR = (J00 * y1 - J10 * y0) / det

        # enable_dE_constrain (reference :323-335): a temperature jump larger
        # than max(T_gas, T_rad) is clamped to the radiation temperature
        T_rad = sqrt(sqrt(_div(torch.clamp(Erad, min=0.0), arad)))
        constrain = dEgas / c_v > torch.maximum(T, T_rad)
        Egas_new = torch.where(constrain, eos.eint_from_tgas(rho, T_rad), Egas + dEgas)
        R_new = torch.where(constrain, R, R + dR)
        Egas_new = torch.where(done, Egas, Egas_new)
        R_new = torch.where(done, R, R_new)

        # T-dependent quantities and Erad from R (reference :213-216)
        T_new = eos.tgas_from_eint(rho, Egas_new)
        fourPiB_new = arad * _pow4(T_new)
        kP_new = kappa_p(rho, T_new)
        kE_new = kappa_e(rho, T_new)
        kPoE_new = torch.where(kE_new > 0.0, kP_new / kE_new, 1.0)
        tau_new = dt * rho * kP_new * chat
        Erad_new = torch.where(
            tau_new > 0.0,
            kPoE_new * (fourPiB_new - (R_new - work)
                        / torch.where(tau_new > 0.0, tau_new, 1.0)),
            Erad)
        Egas, R = Egas_new, R_new
        Erad = torch.where(done, Erad, Erad_new)
        T = torch.where(done, T, T_new)
        fourPiB = torch.where(done, fourPiB, fourPiB_new)
        kP = torch.where(done, kP, kP_new)
        kE = torch.where(done, kE, kE_new)
        kPoE = torch.where(done, kPoE, kPoE_new)
        tau = torch.where(done, tau, tau_new)
        n += 1

    # kappaF at the final temperature (reference :363-366)
    kF = kappa_f(rho, T)
    return Egas, Erad, R, work, kP, kE, kF, fourPiB
