"""Multigroup gas-radiation matter coupling.

Counterpart of `quokka_tpu.radiation.multigroup` (reference
`RadSystem::AddSourceTermsMultiGroup` + `SolveGasRadiationEnergyExchange` +
`UpdateFlux`, ``src/radiation/source_terms_multi_group.hpp``): the
Newton-Raphson solve in (Egas, R_g) with the group-resolved Jacobian

    J00 = 1,  J0g = c/chat,  Jg0 = (kappaP/kappaE)_g dB_g/dT / c_v,
    Jgg = -(kappaP/kappaE)_g / tau_g - 1

reduced in closed form (the reference's `SolveLinearEqs`):

    dx0 = (sum_g (J0g/Jgg) Fg - F0) / (J00 - sum_g (J0g/Jgg) Jg0)
    dRg = (-Fg - Jg0 dx0) / Jgg

with the dE constraint, the per-group implicit flux/momentum update (with
the PPL emission and pressure terms) and the lagged v.F work term. The
opacity model is piecewise constant per group or one of the two PPL
models (`radiation.opacity`); group emission uses the tabulated Planck
fractions.

Plain PyTorch, on the state's device: the JAX package runs this coupling
in XLA, outside any Pallas kernel. Fields carry a leading group axis [G,
X, Y, Z]. The JAX `lax.while_loop`s run until every cell is done; a
converged cell is frozen by `where(done, ...)`, and the only carry that is
not masked (the PPL exponents `alpha_E`, `alpha_P`) feeds cells that still
iterate, so testing `done.all()` (a host sync) every DONE_CHECK_EVERY
Newton iterations gives the same bits as testing it every iteration, as
long as the loop stops at MAX_NEWTON_ITER.
"""

from __future__ import annotations

import functools

import torch

from .._numerics import div, sqrt
from ..indices import EGAS, EINT, MX1, RHO
from .planck import planck_energy_fractions
from .source_terms import (LAG_TOL, MAX_NEWTON_ITER, MAX_OUTER_ITER, _in_dtype, _pow4,
                           resid_tol)
from .system import IMEX_A32, RadOptions, eddington_tensor

OPACITY_MODELS = ("piecewise_constant", "ppl_fixed_slope", "ppl_full_spectrum")
# the full-spectrum model re-estimates the spectral exponents only during
# the first iterations (reference max_iter_to_update_alpha_E = 5)
MAX_ALPHA_UPDATE_ITER = 5
# Newton iterations between two tests of "every cell done" (host syncs)
DONE_CHECK_EVERY = 4
# host syncs of the loops' exit tests, and coupling calls, since the reset
sync_counts = {"calls": 0, "newton": 0, "outer": 0}


def check_opacity_model(name: str) -> str:
    """`radiation.opacity_model`, one of OPACITY_MODELS, else ValueError
    (`quokka_tpu/radiation/advance.py:_check_opacity_model`)."""
    if name not in OPACITY_MODELS:
        raise ValueError(f"radiation.opacity_model = '{name}' is not one of {OPACITY_MODELS}")
    return name


def reset_sync_counts() -> None:
    for k in sync_counts:
        sync_counts[k] = 0


def _gsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis, left to right (the same order on every
    device)."""
    return functools.reduce(torch.add, x.unbind(0))


def make_opacity_model_fns(opts: RadOptions, problem, boundaries, rho: torch.Tensor,
                           spatial, boltzmann_constant: float):
    """(opacity_PE, opacity_F) closures for the configured opacity model
    (reference ComputeModelDependentKappaEAndKappaP /
    ComputeModelDependentKappaFAndDeltaTerms, source_terms_multi_group.hpp).
    `quokka_tpu/radiation/multigroup.py:41-107`."""
    G = opts.n_groups
    opacity_model = opts.opacity_model
    ppl = opacity_model != "piecewise_constant"
    if ppl:
        from .opacity import (boundary_ratios, diffusion_flux_mean_opacity,
                              edge_delta_terms, group_mean_opacity, rad_quantity_exponents)

        energy_unit = getattr(problem.rad, "energy_unit", 1.0)
        ratios_b = torch.tensor(boundary_ratios(boundaries), dtype=rho.dtype,
                                device=rho.device).reshape((G,) + (1,) * len(spatial))

        def expo_lower(T):
            return problem.define_opacity_exponents_and_lower_values(boundaries, rho, T)

    def opacity_PE(T, Erad_g, B_g, alpha_E_prev, alpha_P_prev, n: int):
        """(kappaP, kappaE, kappaPoverE, alpha_E, alpha_P) at temperature T."""
        if opacity_model == "piecewise_constant":
            kP = problem.compute_group_opacities(boundaries, rho, T)
            return kP, kP, torch.ones_like(kP), alpha_E_prev, alpha_P_prev
        alpha_k, k_lower = expo_lower(T)
        if opacity_model == "ppl_fixed_slope":
            aq = torch.full_like(B_g, -1.0)
            kP = group_mean_opacity(alpha_k, k_lower, ratios_b, aq)
            kE = kP
            aE, aP = alpha_E_prev, alpha_P_prev
        else:
            if n < MAX_ALPHA_UPDATE_ITER:
                aE = rad_quantity_exponents(Erad_g, boundaries)
                aP = rad_quantity_exponents(B_g, boundaries)
            else:
                aE, aP = alpha_E_prev, alpha_P_prev
            kE = group_mean_opacity(alpha_k, k_lower, ratios_b, aE)
            kP = group_mean_opacity(alpha_k, k_lower, ratios_b, aP)
        pos = kE > 0.0
        kPoE = torch.where(pos, kP / torch.where(pos, kE, 1.0), 1.0)
        return kP, kE, kPoE, aE, aP

    def opacity_F(T, B_g, kP, kE):
        """(kappaF, delta(nu kappa B) at the edges, alpha_kappa) at T."""
        if opacity_model == "piecewise_constant":
            return kP, torch.zeros_like(B_g), torch.zeros_like(B_g)
        alpha_k, k_lower = expo_lower(T)
        d_nkB, d_nB = edge_delta_terms(boundaries, T, alpha_k, k_lower, boltzmann_constant,
                                       opts.arad, energy_unit)
        kF = diffusion_flux_mean_opacity(kP, kE, B_g, d_nkB, d_nB, alpha_k)
        return kF, d_nkB, alpha_k

    return opacity_PE, opacity_F


def add_source_terms_multi_group(U, rad_src, dt_radiation: float, stage: int,
                                 opts: RadOptions, eos, problem, rad_start: int,
                                 boundaries, boltzmann_constant: float):
    """The multigroup matter-coupling update of the state U [nvar, X, Y, Z]
    (`quokka_tpu/radiation/multigroup.py:109-358`). `rad_src` is the
    radiation energy source [G, X, Y, Z], or None for none; `boundaries` the
    G + 1 group edges. DONE_CHECK_EVERY Newton iterations go between two
    tests of convergence. Returns (new state, {"newton_iters_max": 0}), the JAX
    package's stats."""
    if opts.mixed_precision_coupling:
        raise NotImplementedError("radiation.mixed_precision_coupling is not ported yet")
    sync_counts["calls"] += 1
    G = opts.n_groups
    c, chat = opts.c, opts.chat
    cscale = c / chat
    dt = dt_radiation if stage == 1 else (1.0 - IMEX_A32) * dt_radiation
    gas_update_factor = IMEX_A32 if stage == 1 else 1.0
    arad = opts.arad
    dtype = U.dtype

    spatial = U.shape[1:]
    R_state = U[rad_start:].reshape(G, 4, *spatial)
    Erad0 = R_state[:, 0]
    Frad0 = R_state[:, 1:4]

    rho = U[RHO]
    mom0 = U[MX1:MX1 + 3]
    Egastot0 = U[EGAS]
    ke0 = 0.5 * _gsum(mom0 * mom0) / rho
    Egas0 = Egastot0 - ke0

    Src = 0.0 if rad_src is None else rad_src * dt * chat
    Etot0 = Egas0 + cscale * _gsum(Erad0 + Src)
    energy_unit = getattr(problem.rad, "energy_unit", 1.0)
    floor = opts.erad_floor / G

    def fourPiB_groups(T):
        fr = planck_energy_fractions(boundaries, T, boltzmann_constant, energy_unit)
        return torch.clamp(arad * _pow4(T) * fr, min=floor)

    ppl = opts.opacity_model in ("ppl_fixed_slope", "ppl_full_spectrum")
    opacity_PE, opacity_F = make_opacity_model_fns(opts, problem, boundaries, rho, spatial,
                                                   boltzmann_constant)
    include_work = opts.beta_order != 0 and opts.include_work_term
    tol = resid_tol(dtype)
    neg_big = _in_dtype(-1.0e100, dtype)

    def newton(work):
        T0 = eos.tgas_from_eint(rho, Egas0)
        B0 = fourPiB_groups(T0)
        zeros = torch.zeros_like(B0)
        kP, _kE, kPoE, aE, aP = opacity_PE(T0, Erad0, B0, zeros, zeros, 0)
        tau = dt * rho[None] * kP * chat
        R = (B0 - Erad0 / kPoE) * tau + work
        Egas, Erad, T, B = Egas0, Erad0, T0, B0
        done = torch.zeros_like(rho, dtype=torch.bool)
        n = 0
        while n < MAX_NEWTON_ITER:
            if n > 0 and n % DONE_CHECK_EVERY == 0:
                sync_counts["newton"] += 1
                if bool(done.all()):
                    break
            F0 = Egas - Egas0 + cscale * _gsum(R)
            Fg = Erad - Erad0 - (R + Src)
            Fg_abs_sum = _gsum(torch.where(tau > 0.0, torch.abs(Fg), 0.0))
            conv = ((torch.abs(F0) < tol * Etot0)
                    & (cscale * Fg_abs_sum < tol * Etot0))
            done_new = done | conv

            c_v = eos.eint_temp_derivative(rho, T)
            dB_dT = 4.0 * arad * (T * (T * T)) * (
                B / torch.clamp(arad * _pow4(T), min=1e-300))
            dEg_dT = kPoE * dB_dT

            J0g = torch.full_like(R, cscale)
            Jg0 = dEg_dT / c_v[None]
            pos = tau > 0.0
            Jgg = torch.where(pos, -kPoE / torch.where(pos, tau, 1.0) - 1.0, neg_big)

            ratios = J0g / Jgg
            dx0 = (_gsum(ratios * Fg) - F0) / (1.0 - _gsum(ratios * Jg0))
            dR = (-Fg - Jg0 * dx0[None]) / Jgg

            # dE constraint (reference enable_dE_constrain)
            T_rad = sqrt(sqrt(div(torch.clamp(_gsum(Erad), min=0.0), arad)))
            constrain = dx0 / c_v > torch.maximum(T, T_rad)
            Egas_new = torch.where(constrain, eos.eint_from_tgas(rho, T_rad), Egas + dx0)
            R_new = torch.where(constrain[None], R, R + dR)

            Egas_new = torch.where(done_new, Egas, Egas_new)
            R_new = torch.where(done_new[None], R, R_new)

            T_new = eos.tgas_from_eint(rho, Egas_new)
            B_new = fourPiB_groups(T_new)
            kP_new, _kE, kPoE_new, aE, aP = opacity_PE(T_new, Erad, B_new, aE, aP, n + 1)
            tau_new = dt * rho[None] * kP_new * chat
            pos = tau_new > 0.0
            Erad_new = torch.where(
                pos, kPoE_new * (B_new - (R_new - work) / torch.where(pos, tau_new, 1.0)),
                Erad)
            keep = done_new[None]
            Egas, R = Egas_new, R_new
            Erad = torch.where(keep, Erad, Erad_new)
            T = torch.where(done_new, T, T_new)
            B = torch.where(keep, B, B_new)
            kP = torch.where(keep, kP, kP_new)
            kPoE = torch.where(keep, kPoE, kPoE_new)
            tau = torch.where(keep, tau, tau_new)
            done = done_new
            n += 1
        pos = kPoE > 0.0
        kE = torch.where(pos, kP / torch.where(pos, kPoE, 1.0), kP)
        kF, d_nkB, alpha_k = opacity_F(T, B, kP, kE)
        return Egas, Erad, R, T, B, kP, kE, kF, d_nkB, alpha_k

    def flux_update(Erad_g, B_g, kP, kE, kF, d_nkB, alpha_k):
        """Per-group implicit flux + momentum update (reference `UpdateFlux`,
        ``source_terms_multi_group.hpp:430-490``). For the PPL models the
        emission term subtracts the inter-group transport (1/3) d(nu kappa
        B) and the pressure term carries the (1 + alpha_kappa) factor."""
        if opts.beta_order == 0 or eos.is_isothermal:
            denom = 1.0 + rho[None, None] * kF[:, None] * chat * dt
            Frad_t1 = Frad0 / denom
        else:
            erad = Erad_g
            f = Frad0 / (c * erad[:, None])
            groups = []
            for g in range(G):
                Tedd = eddington_tensor(f[g, 0], f[g, 1], f[g, 2])
                F_coeff = chat * rho * kF[g] * dt
                emission = kP[g] * B_g[g]
                if ppl:
                    emission = emission - div(d_nkB[g], 3.0)
                    press_k = (1.0 + alpha_k[g]) * kE[g]
                else:
                    press_k = kE[g]
                comps = []
                for n in range(3):
                    planck_term = emission * chat * dt * mom0[n]
                    pressure_term = torch.zeros_like(rho)
                    for z in range(3):
                        pressure_term = pressure_term + mom0[z] * Tedd[n][z] * erad[g]
                    pressure_term = pressure_term * chat * dt * press_k
                    comps.append((Frad0[g, n] + planck_term + pressure_term)
                                 / (1.0 + F_coeff))
                groups.append(torch.stack(comps))
            Frad_t1 = torch.stack(groups)
        dMom = div(-_gsum(Frad_t1 - Frad0), c * chat)
        return Frad_t1, dMom

    def work_chi(kF, alpha_k):
        """Opacity factor of the v.F work term: kappaF, with the (1 +
        alpha_kappa) PPL spectral correction (reference
        ``source_terms_multi_group.hpp:510-527``)."""
        return (1.0 + alpha_k) * kF if ppl else kF

    def work_of(mom, Frad, kF, alpha_k):
        """The lagged work term [G, ...]: (v.F)_g chi_g chat / c^2 dt."""
        v_dot_F = _gsum((mom[None] * Frad).transpose(0, 1))
        return div(v_dot_F * work_chi(kF, alpha_k) * chat, c * c) * dt

    if not include_work:
        work = torch.zeros_like(Erad0)
        Egas_g, Erad_g, _R, _T, B_g, kP, kE, kF, d_nkB, alpha_k = newton(work)
        Frad_t1, dMom = flux_update(Erad_g, B_g, kP, kE, kF, d_nkB, alpha_k)
    else:
        # the initial work from the old state (first outer iteration)
        T_init = eos.tgas_from_eint(rho, Egas0)
        B_init = fourPiB_groups(T_init)
        zeros = torch.zeros_like(B_init)
        kP_i, kE_i, _kPoE, _aE, _aP = opacity_PE(T_init, Erad0, B_init, zeros, zeros, 0)
        kF0, _d, alpha0 = opacity_F(T_init, B_init, kP_i, kE_i)
        work = work_of(mom0, Frad0, kF0, alpha0)

        def outer_step(work_g):
            Egas_n, Erad_n, R_n, _T, B_n, kP, kE, kF, d_nkB, alpha_k = newton(work_g)
            Frad_n, dMom_n = flux_update(Erad_n, B_n, kP, kE, kF, d_nkB, alpha_k)
            work_new = work_of(mom0 + dMom_n, Frad_n, kF, alpha_k)
            return Egas_n, Erad_n, R_n, Frad_n, dMom_n, work_new

        Egas_g, Erad_g, R_g, Frad_t1, dMom, work_1 = outer_step(work)
        dwork = _gsum(torch.abs(work_1 - work))
        done = (cscale * dwork < LAG_TOL * Etot0) | (
            dwork <= 1.0e-8 * torch.clamp(_gsum(torch.abs(work_1)), min=1e-300))
        work = torch.where(done[None], work, work_1)
        ite = 1
        while ite < MAX_OUTER_ITER:
            sync_counts["outer"] += 1
            if bool(done.all()):
                break
            Egas_n, Erad_n, R_n, Frad_n, dMom_n, work_new = outer_step(work)
            dwork = _gsum(torch.abs(work_new - work))
            abs_new = _gsum(torch.abs(work_new))
            conv = ((abs_new == 0.0) | (cscale * dwork < LAG_TOL * Etot0)
                    | (dwork <= 1.0e-8 * abs_new))
            keep = done[None]
            Egas_g = torch.where(done, Egas_g, Egas_n)
            Erad_g = torch.where(keep, Erad_g, Erad_n)
            R_g = torch.where(keep, R_g, R_n)
            Frad_t1 = torch.where(done[None, None], Frad_t1, Frad_n)
            dMom = torch.where(keep, dMom, dMom_n)
            work = torch.where(keep, work, work_new)
            done = done | conv
            ite += 1

    # the final state update with the stage factor
    mom1 = mom0 + dMom * gas_update_factor
    comps = list(U.unbind(0))
    comps[MX1:MX1 + 3] = mom1.unbind(0)
    isothermal = eos.is_isothermal
    if not isothermal:
        Egas_final = Egas0 + (Egas_g - Egas0) * gas_update_factor
        ke1 = 0.5 * _gsum(mom1 * mom1) / rho
        comps[EINT] = Egas_final
        comps[EGAS] = Egas_final + ke1
    for g in range(G):
        i = rad_start + 4 * g
        if not isothermal:
            comps[i] = Erad_g[g]
        comps[i + 1:i + 4] = Frad_t1[g].unbind(0)
    return torch.stack(comps), {"newton_iters_max": 0}
