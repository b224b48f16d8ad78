"""Riemann solvers: HLLC (with low-dissipation corrections) and LLF.

Counterpart of `quokka_tpu.hydro.riemann` (reference ``src/hydro/HLLC.hpp``
and ``src/hydro/LLF.hpp``), vectorized over whole face arrays. Canonical
frame: `u` is the velocity normal to the face, `v`/`w` the transverse
components. Flux component order (canonical): [rho, mom_u, mom_v, mom_w, E,
Eint]; passive scalars are not ported yet. HLLD waits for the MHD slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

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
    # cached reciprocal density: the solver multiplies by it instead of
    # dividing by rho (ulp-level difference only)
    rinv: Optional[torch.Tensor] = None

    def rho_inv(self):
        return self.rinv if self.rinv is not None else 1.0 / self.rho

    def conserved_list(self) -> list:
        return [self.rho, self.rho * self.u, self.rho * self.v,
                self.rho * self.w, self.E, self.Eint]

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

    wl = torch.sqrt(sL.rho)
    wr = torch.sqrt(sR.rho)
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
                           torch.sqrt(torch.abs(cs_exp) / C_P), cs_avg)

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
    chi = torch.clamp(torch.sqrt(torch.maximum(vsq_L, vsq_R)) / cs_max, max=1.0)
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
