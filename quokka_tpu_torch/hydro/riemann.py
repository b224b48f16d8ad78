"""Riemann solvers: HLLC (with low-dissipation corrections), LLF and HLLD.

Counterpart of `quokka_tpu.hydro.riemann` (reference ``src/hydro/HLLC.hpp``,
``src/hydro/LLF.hpp`` and ``src/hydro/HLLD.hpp``), vectorized over whole
face arrays. Canonical frame: `u` is the velocity normal to the face,
`v`/`w` the transverse components. Flux component order (canonical): [rho,
mom_u, mom_v, mom_w, E, Eint, scalars...]; HLLD returns the transverse
field fluxes [by, bz] after Eint instead of scalars.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .._numerics import div, sqrt
from ..eos import IdealGasEOS


@dataclass
class FaceState:
    """Primitive state on one side of a face (tensors over all faces)."""

    rho: torch.Tensor
    u: torch.Tensor  # normal velocity
    v: torch.Tensor
    w: torch.Tensor
    P: torch.Tensor
    cs: torch.Tensor
    E: torch.Tensor  # total energy density
    Eint: torch.Tensor  # auxiliary internal energy density (rho*e)
    scalars: Optional[torch.Tensor] = None  # [nscal, ...faces], conserved densities
    by: torch.Tensor | float = 0.0  # transverse B (MHD / HLLD only)
    bz: torch.Tensor | float = 0.0
    # cached reciprocal density: the solver multiplies by it instead of
    # dividing by rho (ulp-level difference only)
    rinv: Optional[torch.Tensor] = None

    def rho_inv(self):
        return self.rinv if self.rinv is not None else 1.0 / self.rho

    def conserved_list(self) -> list:
        comps = [self.rho, self.rho * self.u, self.rho * self.v,
                 self.rho * self.w, self.E, self.Eint]
        if self.scalars is not None:
            comps += list(self.scalars.unbind(0))
        return comps

    def flux_list(self) -> list:
        """Canonical physical flux F = u*U + P*D, as a component list."""
        F = [self.u * c for c in self.conserved_list()]
        F[1] = F[1] + self.P
        F[4] = F[4] + self.P * self.u
        return F

    def conserved(self) -> torch.Tensor:
        return torch.stack(self.conserved_list())


def llf(sL: FaceState, sR: FaceState) -> torch.Tensor:
    """Local Lax-Friedrichs / Rusanov flux (Toro eq. 10.56), used for the
    first-order flux correction."""
    Sp = torch.maximum(torch.abs(sL.u) + sL.cs, torch.abs(sR.u) + sR.cs)
    U_L, U_R = sL.conserved_list(), sR.conserved_list()
    F_L, F_R = sL.flux_list(), sR.flux_list()
    return torch.stack([
        0.5 * (fl + fr) - 0.5 * Sp * (ur - ul)
        for fl, fr, ul, ur in zip(F_L, F_R, U_L, U_R)
    ])


def hllc(sL: FaceState, sR: FaceState, eos: IdealGasEOS,
         du: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """HLLC flux following Toro/Balsara with the reference's refinements:
    Roe-averaged wavespeeds with the Kershaw+1998 sound speed, the Rider
    1999 nonlinear wavespeed correction in compressions, and the Minoshima
    & Miyoshi 2021 carbuncle theta(du, dw) and low-dissipation phi.

    `du` = normal velocity difference across the face (q_i - q_{i-1});
    `dw` = min transverse velocity difference."""
    gamma = eos.gamma
    rinv_L = sL.rho_inv()
    rinv_R = sR.rho_inv()

    wl = sqrt(sL.rho)
    wr = sqrt(sR.rho)
    norm = 1.0 / (wl + wr)
    u_t = (wl * sL.u + wr * sR.u) * norm
    v_t = (wl * sL.v + wr * sR.v) * norm
    w_t = (wl * sL.w + wr * sR.w) * norm
    vsq_t = u_t * u_t + v_t * v_t + w_t * w_t
    H_L = (sL.E + sL.P) * rinv_L
    H_R = (sR.E + sR.P) * rinv_R
    H_t = (wl * H_L + wr * H_R) * norm

    dU = sL.u - sR.u  # positive in compression
    zero = torch.zeros_like(dU)

    if gamma != 1.0:
        # gamma-law closed-form derivatives (reference
        # `EOS::ComputeOtherDerivatives`), via the reciprocal densities
        inv_gm1 = 1.0 / (gamma - 1.0)
        G = 0.5 * (gamma + 1.0)

        def derivs(rho, P, rinv):
            return (-P * inv_gm1 * (rinv * rinv), inv_gm1 * rinv, rho / P)

        dedr_L, dedp_L, drdp_L = derivs(sL.rho, sL.P, rinv_L)
        dedr_R, dedp_R, drdp_R = derivs(sR.rho, sR.P, rinv_R)

        e_L = sL.Eint * rinv_L
        e_R = sR.Eint * rinv_R
        C_rho = 0.5 * (e_L + e_R + sL.rho * dedr_L + sR.rho * dedr_R)
        C_P = 0.5 * (e_L * drdp_L + e_R * drdp_R + sL.rho * dedp_L
                     + sR.rho * dedp_R)

        cs_exp = H_t - 0.5 * vsq_t - C_rho
        cs_avg = 0.5 * (sL.cs + sR.cs)
        cs_t = torch.where(cs_exp > 0.0,
                           sqrt(torch.abs(cs_exp) / C_P), cs_avg)

        s_NL = 0.5 * G * torch.maximum(dU, zero)
        s_NR = s_NL
    else:
        cs_t = 0.5 * (sL.cs + sR.cs)
        s_NL = 0.5 * 1.0 * torch.maximum(dU, zero)
        s_NR = s_NL

    # Batten et al. 1997 wavespeed bounds
    S_L = torch.minimum(sL.u - (sL.cs + s_NL), u_t - (cs_t + s_NL))
    S_R = torch.maximum(sR.u + (sR.cs + s_NR), u_t + (cs_t + s_NR))

    # carbuncle correction [Minoshima & Miyoshi 2021, eq. 10]
    cs_max = torch.maximum(sL.cs, sR.cs)
    tp = torch.clamp((cs_max - torch.minimum(du, zero))
                     / (cs_max - torch.minimum(dw, zero)), max=1.0)
    tp2 = tp * tp
    theta = tp2 * tp2

    denom = sL.rho * (S_L - sL.u) - sR.rho * (S_R - sR.u)
    S_star = (theta * (sR.P - sL.P)
              + (sL.rho * sL.u * (S_L - sL.u) - sR.rho * sR.u * (S_R - sR.u))
              ) / denom

    # low-dissipation pressure correction phi [M&M 2021, eq. 23]
    vsq_L = sL.u * sL.u + sL.v * sL.v + sL.w * sL.w
    vsq_R = sR.u * sR.u + sR.v * sR.v + sR.w * sR.w
    chi = torch.clamp(sqrt(torch.maximum(vsq_L, vsq_R)) / cs_max, max=1.0)
    phi = chi * (2.0 - chi)

    P_LR = 0.5 * (sL.P + sR.P) + 0.5 * phi * (
        sL.rho * (S_L - sL.u) * (S_star - sL.u)
        + sR.rho * (S_R - sR.u) * (S_star - sR.u)
    )

    U_L, U_R = sL.conserved_list(), sR.conserved_list()
    F_L, F_R = sL.flux_list(), sR.flux_list()

    # F* = (S*(S U - F) + S P_LR D*) / (S - S*)
    def star_flux(S, U, F):
        coef = 1.0 / (S - S_star)
        Fs = [(S_star * (S * c - f)) * coef for c, f in zip(U, F)]
        Fs[1] = Fs[1] + S * P_LR * coef
        Fs[4] = Fs[4] + S * P_LR * S_star * coef
        return Fs

    F_starL = star_flux(S_L, U_L, F_L)
    F_starR = star_flux(S_R, U_R, F_R)

    in_L = S_L > 0.0
    in_sL = S_star > 0.0
    in_sR = S_R >= 0.0
    return torch.stack([
        torch.where(in_L, fl, torch.where(in_sL, fsl, torch.where(in_sR, fsr, fr)))
        for fl, fsl, fsr, fr in zip(F_L, F_starL, F_starR, F_R)
    ])


# --------------------------------------------------------------------- HLLD
_HLLD_DELTA = 1.0e-4  # degeneracy threshold (reference src/hydro/HLLD.hpp:15)

# HLLD regions and branches, in the order `hlld(..., counts=...)` reports them
HLLD_REGIONS = ("F_L (S0 >= 0)", "F_R (S4 <= 0)", "F*_L (S1 >= 0)",
                "F**_L (S2 >= 0)", "F**_R (S3 > 0)", "F*_R",
                "degenerate L", "degenerate R", "bx ~ 0")


def _fast_magnetosonic_speed(gamma, s: FaceState, bx):
    """Fast magnetosonic speed (reference `FastMagnetoSonicSpeed`,
    ``src/hydro/HLLD.hpp:31-41``)."""
    gp = gamma * s.P
    bx_sq = bx * bx
    byz_sq = s.by * s.by + s.bz * s.bz
    b_sq = bx_sq + byz_sq
    bgp_p = b_sq + gp
    bgp_m = b_sq - gp
    return sqrt(0.5 * (bgp_p + sqrt(bgp_m * bgp_m + 4.0 * gp * byz_sq)) / s.rho)


def hlld(sL: FaceState, sR: FaceState, gamma: float, bx: torch.Tensor,
         counts: dict | None = None) -> torch.Tensor:
    """HLLD MHD Riemann solver (Miyoshi & Kusano 2005; reference
    ``src/hydro/HLLD.hpp:43-334``), vectorized with masked branch selection.

    FaceState carries the transverse field `by`/`bz`; `bx` is the face-normal
    field. Returns the canonical flux [rho, mom_u, mom_v, mom_w, E, Eint(=0),
    by, bz]. `counts`, if given, accumulates the faces in each region and
    branch (keys `HLLD_REGIONS`). Every sum keeps the JAX package's grouping
    and every square is one product, as the CUDA kernel K8 computes them."""
    bx_sq = bx * bx

    def cons(s):
        pb = 0.5 * (bx_sq + (s.by * s.by + s.bz * s.bz))
        ke = 0.5 * s.rho * (s.u * s.u + (s.v * s.v + s.w * s.w))
        E = ke + pb + div(s.P, gamma - 1.0)
        return dict(rho=s.rho, mx=s.rho * s.u, my=s.rho * s.v, mz=s.rho * s.w,
                    E=E, by=s.by, bz=s.bz), pb

    u_L, pb_L = cons(sL)
    u_R, pb_R = cons(sR)

    cfs_L = _fast_magnetosonic_speed(gamma, sL, bx)
    cfs_R = _fast_magnetosonic_speed(gamma, sR, bx)
    S0 = torch.minimum(sL.u - cfs_L, sR.u - cfs_R)
    S4 = torch.maximum(sL.u + cfs_L, sR.u + cfs_R)

    ptot_L = sL.P + pb_L
    ptot_R = sR.P + pb_R

    def phys_flux(s, u, ptot):
        # transverse momentum fluxes rho*u*v - Bx*By and rho*u*w - Bx*Bz
        # (Miyoshi & Kusano 2005 eq. 2), as the JAX package has them; the
        # reference's stub HLLD has "+" there (src/hydro/HLLD.hpp:108-109)
        return dict(
            rho=u["mx"],
            mx=u["mx"] * s.u + ptot - bx_sq,
            my=u["my"] * s.u - bx * u["by"],
            mz=u["mz"] * s.u - bx * u["bz"],
            E=s.u * (u["E"] + ptot - bx_sq) - bx * (s.v * u["by"] + s.w * u["bz"]),
            by=u["by"] * s.u - bx * s.v,
            bz=u["bz"] * s.u - bx * s.w,
        )

    f_L = phys_flux(sL, u_L, ptot_L)
    f_R = phys_flux(sR, u_R, ptot_R)

    siui_L = S0 - sL.u
    siui_R = S4 - sR.u
    S2 = (siui_R * u_R["mx"] - siui_L * u_L["mx"] + (ptot_L - ptot_R)) / (
        siui_R * u_R["rho"] - siui_L * u_L["rho"])
    sism_L = S0 - S2
    sism_R = S4 - S2

    rho_star_L = u_L["rho"] * siui_L / sism_L
    rho_star_R = u_R["rho"] * siui_R / sism_R
    rs_L = sqrt(rho_star_L)
    rs_R = sqrt(rho_star_R)
    S1 = S2 - torch.abs(bx) / rs_L
    S3 = S2 + torch.abs(bx) / rs_R

    ptot_star = 0.5 * ((ptot_L - u_L["rho"] * siui_L * (S2 - sL.u))
                       + (ptot_R - u_R["rho"] * siui_R * (S2 - sR.u)))
    one = torch.ones_like(ptot_star)

    def star_state(s, u, siui, sism, rho_star, ptot, side):
        denom = u["rho"] * siui * sism - bx_sq
        degen = torch.abs(denom) < _HLLD_DELTA * ptot_star
        if counts is not None:
            counts[f"degenerate {side}"] += int(degen.sum())
        safe = torch.where(degen, one, denom)
        tmp_m = bx * (siui - sism) / safe
        my = torch.where(degen, rho_star * s.v, rho_star * (s.v - u["by"] * tmp_m))
        mz = torch.where(degen, rho_star * s.w, rho_star * (s.w - u["bz"] * tmp_m))
        tmp_b = (u["rho"] * (siui * siui) - bx_sq) / safe
        by = torch.where(degen, u["by"], u["by"] * tmp_b)
        bz = torch.where(degen, u["bz"], u["bz"] * tmp_b)
        mx = rho_star * S2
        vb_star = (mx * bx + (my * by + mz * bz)) / rho_star
        E = (siui * u["E"] - ptot * s.u + ptot_star * S2
             + bx * (s.u * bx + (s.v * u["by"] + s.w * u["bz"]) - vb_star)) / sism
        return dict(rho=rho_star, mx=mx, my=my, mz=mz, E=E, by=by, bz=bz), vb_star

    us_L, vb_star_L = star_state(sL, u_L, siui_L, sism_L, rho_star_L, ptot_L, "L")
    us_R, vb_star_R = star_state(sR, u_R, siui_R, sism_R, rho_star_R, ptot_R, "R")

    # double-star states (Alfven-wave rotations), MK05 eqs 59-63
    bx_near_zero = 0.5 * bx_sq < _HLLD_DELTA * ptot_star
    rho_sum_inv = 1.0 / (rs_L + rs_R)
    bx_sign = torch.where(bx > 0.0, one, -one)

    vdm = rho_sum_inv * (
        rs_L * (us_L["my"] / us_L["rho"]) + rs_R * (us_R["my"] / us_R["rho"])
        + bx_sign * (us_R["by"] - us_L["by"]))
    wdm = rho_sum_inv * (
        rs_L * (us_L["mz"] / us_L["rho"]) + rs_R * (us_R["mz"] / us_R["rho"])
        + bx_sign * (us_R["bz"] - us_L["bz"]))
    byd = rho_sum_inv * (
        rs_L * us_R["by"] + rs_R * us_L["by"]
        + bx_sign * rs_L * rs_R * (us_R["my"] / us_R["rho"] - us_L["my"] / us_L["rho"]))
    bzd = rho_sum_inv * (
        rs_L * us_R["bz"] + rs_R * us_L["bz"]
        + bx_sign * rs_L * rs_R * (us_R["mz"] / us_R["rho"] - us_L["mz"] / us_L["rho"]))
    vb_d = S2 * bx + (vdm * byd + wdm * bzd)

    def dstar(us, vb_star, sgn_rs):
        # E_dstar = E_star + sgn_rs * sign(bx) * (vb_d - vb_star), sgn_rs =
        # +rs_L on the left and -rs_R on the right (exact negation)
        return dict(
            rho=us["rho"], mx=us["mx"],
            my=torch.where(bx_near_zero, us["my"], us["rho"] * vdm),
            mz=torch.where(bx_near_zero, us["mz"], us["rho"] * wdm),
            by=torch.where(bx_near_zero, us["by"], byd),
            bz=torch.where(bx_near_zero, us["bz"], bzd),
            E=torch.where(bx_near_zero, us["E"],
                          us["E"] + sgn_rs * bx_sign * (vb_d - vb_star)),
        )

    ud_L = dstar(us_L, vb_star_L, rs_L)
    ud_R = dstar(us_R, vb_star_R, -rs_R)

    keys = ("rho", "mx", "my", "mz", "E", "by", "bz")
    in_L, in_R = S0 >= 0.0, S4 <= 0.0
    in_sL, in_dL, in_dR = S1 >= 0.0, S2 >= 0.0, S3 > 0.0
    if counts is not None:
        rest = torch.ones_like(in_L)
        for name, m in zip(HLLD_REGIONS[:5], (in_L, in_R, in_sL, in_dL, in_dR)):
            counts[name] += int((rest & m).sum())
            rest = rest & ~m
        counts[HLLD_REGIONS[5]] += int(rest.sum())
        counts["bx ~ 0"] += int(bx_near_zero.sum())

    out = []
    for k in keys:
        d_us_L = S0 * (us_L[k] - u_L[k])
        d_us_R = S4 * (us_R[k] - u_R[k])
        F_sL = f_L[k] + d_us_L
        F_dL = f_L[k] + (d_us_L + S1 * (ud_L[k] - us_L[k]))
        F_dR = f_R[k] + (d_us_R + S3 * (ud_R[k] - us_R[k]))
        F_sR = f_R[k] + d_us_R
        out.append(torch.where(in_L, f_L[k], torch.where(in_R, f_R[k], torch.where(
            in_sL, F_sL, torch.where(in_dL, F_dL, torch.where(in_dR, F_dR, F_sR))))))
    zero = torch.zeros_like(out[0])
    return torch.stack(out[:5] + [zero] + out[5:])
