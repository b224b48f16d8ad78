"""Piecewise power-law (PPL) opacity models for multigroup radiation.

Counterpart of `quokka_tpu.radiation.opacity` (reference
``src/radiation/radiation_system.hpp:1171-1310`` and
``src/radiation/source_terms_multi_group.hpp:7-100``): within each photon
group the opacity is a power law kappa(nu) = kappa_g (nu/nu_g)^alpha_g and
the radiation quantities (E_g, B_g) are fitted as piecewise power laws, so
group-mean opacities are evaluated in closed form. Two modes on top of the
piecewise-constant default:

  - ``ppl_fixed_slope``: the radiation quantity's spectral exponent is
    fixed at -1 in every group (reference
    ``OpacityModel::PPL_opacity_fixed_slope_spectrum``);
  - ``ppl_full_spectrum``: the exponents are estimated on the fly from the
    group-resolved radiation energy / Planck spectrum by minmod-limited log
    slopes (reference ``OpacityModel::PPL_opacity_full_spectrum``,
    `ComputeRadQuantityExponents`).

Every function is whole-array: fields carry a leading group axis [G, ...].
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from .._numerics import div, expm1, log, pow, sqrt

_BIG = 1.0e100


def _scalar_like(x: float, t: torch.Tensor) -> torch.Tensor:
    """A Python float as a 0-d tensor of t's dtype and device, rounded once
    as a weakly typed JAX scalar is (1e100 is inf in float32)."""
    return torch.tensor(x, dtype=torch.float64, device=t.device).to(t.dtype)


def planck_function(nu: float, T: torch.Tensor, kB: float, arad: float,
                    energy_unit: float = 1.0) -> torch.Tensor:
    """4 pi B(nu) / c (reference `PlanckFunction`, ``radiation_system.hpp:
    1311-1331``): a T^4 (15/pi^4) x^3/(e^x - 1) * coeff, x = (energy_unit
    nu)/(kB T), with the x -> 0 Taylor series and the x > 100 cutoff."""
    coeff = _scalar_like(energy_unit, T) / (kB * T)
    x = coeff * nu
    small = x * x - 0.5 * (x * (x * x))
    x_safe = torch.clamp(x, 1.0e-12, 100.0)
    core = (x_safe * (x_safe * x_safe)) / expm1(x_safe)
    integrand = torch.where(x <= 1.0e-10, small, torch.where(x > 100.0, 0.0, core))
    return coeff * (15.0 / math.pi**4) * (arad * ((T * T) * (T * T))) * integrand


def _minmod(a, b):
    same = a * b > 0.0
    return torch.where(same, torch.where(torch.abs(a) < torch.abs(b), a, b), 0.0)


def rad_quantity_exponents(quant: torch.Tensor, boundaries: Sequence[float],
                           special_edges: bool = False) -> torch.Tensor:
    """Per-group spectral exponents of a group-integrated quantity
    (reference `ComputeRadQuantityExponents`, ``radiation_system.hpp:
    1171-1230``). quant: [G, ...]; boundaries: G + 1 floats. Log slopes
    between geometric bin centres, minmod-limited; the edge groups get -1
    (2 and -4 with `special_edges`)."""
    G = quant.shape[0]
    b = [float(x) for x in boundaries]
    centers = [sqrt(_scalar_like(b[g] * b[g + 1], quant)) if b[g + 1] != math.inf
               else None for g in range(G)]
    means = [div(quant[g], b[g + 1] - b[g]) if b[g + 1] != math.inf
             else torch.zeros_like(quant[g]) for g in range(G)]

    slopes = []
    for g in range(1, G):
        qm0, qm1 = means[g - 1], means[g]
        both_zero = (qm1 == 0.0) & (qm0 == 0.0)
        sign_change = qm0 * qm1 <= 0.0
        up = qm1 > qm0
        ratio = log(torch.abs(qm1 / torch.where(qm0 == 0.0, 1.0, qm0)))
        dlognu = log(centers[g] / centers[g - 1])
        ls = ratio / dlognu
        big = torch.where(up, _scalar_like(_BIG, ls), _scalar_like(-_BIG, ls))
        ls = torch.where(sign_change, big, ls)
        ls = torch.where(both_zero, 0.0, ls)
        slopes.append(ls)

    lo_edge = 2.0 if special_edges else -1.0
    hi_edge = -4.0 if special_edges else -1.0
    exps = []
    for g in range(G):
        if g == 0:
            exps.append(torch.full_like(quant[0], lo_edge))
        elif g == G - 1:
            exps.append(torch.full_like(quant[0], hi_edge))
        else:
            exps.append(_minmod(slopes[g - 1], slopes[g]))
    return torch.stack(exps)


def group_mean_opacity(alpha_kappa, kappa_lower, ratios, alpha_quant):
    """Group-mean opacity of a PPL opacity weighted by a PPL radiation
    quantity (reference `ComputeGroupMeanOpacity`, ``radiation_system.hpp:
    1250-1290``):

      kappa_g = kappa_lower_g * part2(alpha + alpha_kappa) / part1(alpha),
      part(a) = (r^a - 1)/a   (-> log r as a -> 0),  alpha = alpha_quant + 1

    with the alpha > 100 (quantity at the group's upper edge) and alpha <
    -100 (lower edge) saturation guards. ratios = nu_{g+1}/nu_g, a tensor
    broadcastable against the fields."""
    r = ratios
    alpha = alpha_quant + 1.0
    logr = log(r)

    def part(a):
        tiny = torch.abs(a) < 1.0e-8
        a_safe = torch.where(tiny, 1.0, a)
        # clamped so that the saturated branches (selected away) stay finite
        a_clamped = torch.clamp(a_safe, -100.0, 100.0)
        val = (pow(r, a_clamped) - 1.0) / a_clamped
        return torch.where(tiny, logr, val)

    p1 = part(alpha)
    p2 = part(alpha + alpha_kappa)
    kappa = kappa_lower * p2 / p1
    kappa = torch.where(alpha > 100.0, kappa_lower * pow(r, alpha_kappa), kappa)
    return torch.where(alpha < -100.0, kappa_lower, kappa)


def diffusion_flux_mean_opacity(kappaP, kappaE, fourPiBoverC, delta_nu_kappa_B,
                                delta_nu_B, alpha_kappa):
    """Diffusion-limit flux-mean opacity (reference
    `ComputeDiffusionFluxMeanOpacity`, ``radiation_system.hpp``):
    kappaF = [(kP + kE/3) B + (alpha kE B - d(nu kappa B))/3] /
             [4B/3 - d(nu B)/3]."""
    num = (kappaP + div(kappaE, 3.0)) * fourPiBoverC + div(
        alpha_kappa * kappaE * fourPiBoverC - delta_nu_kappa_B, 3.0)
    denom = 4.0 / 3.0 * fourPiBoverC - div(delta_nu_B, 3.0)
    pos = denom > 0.0
    return torch.where(pos, num / torch.where(pos, denom, 1.0), 0.0)


def edge_delta_terms(boundaries: Sequence[float], T, alpha_kappa, kappa_lower,
                     kB: float, arad: float, energy_unit: float = 1.0):
    """(delta(nu kappa B), delta(nu B)) across each group's edges (reference
    `ComputeModelDependentKappaFAndDeltaTerms`, ``source_terms_multi_group.hpp:
    62-100``). Returns two [G, ...] tensors."""
    G = len(boundaries) - 1
    d_nkB, d_nB = [], []
    for g in range(G):
        nu_L = float(boundaries[g])
        nu_R = float(boundaries[g + 1])
        B_L = planck_function(nu_L, T, kB, arad, energy_unit)
        if nu_R == math.inf:
            # open-topped last group: B(nu) -> 0 faster than nu grows
            d_nkB.append(-nu_L * kappa_lower[g] * B_L)
            d_nB.append(-nu_L * B_L)
            continue
        B_R = planck_function(nu_R, T, kB, arad, energy_unit)
        kappa_L = kappa_lower[g]
        kappa_R = kappa_L * pow(_scalar_like(nu_R / nu_L, T), alpha_kappa[g])
        d_nkB.append(nu_R * kappa_R * B_R - nu_L * kappa_L * B_L)
        d_nB.append(nu_R * B_R - nu_L * B_L)
    return torch.stack(d_nkB), torch.stack(d_nB)


def boundary_ratios(boundaries: Sequence[float]) -> Tuple[float, ...]:
    """nu_{g+1}/nu_g per group (1e30 for an open-topped last group, whose
    group means saturate through the guards instead)."""
    G = len(boundaries) - 1
    out = []
    for g in range(G):
        hi = float(boundaries[g + 1])
        lo = float(boundaries[g])
        out.append(hi / lo if hi != math.inf and lo > 0.0 else 1.0e30)
    return tuple(out)
