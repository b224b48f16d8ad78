"""Hydro level advance: RK2-SSP with the first-order flux correction (FOFC).

Counterpart of `quokka_tpu.hydro.advance`, with the JAX package's three
formulations and its dispatch (`_branch`):

- the kernel-fused divergence path (`_advance_hydro_rk2_fused`, reference
  ``src/QuokkaSimulation.hpp:1033-1325``): per stage, K1 (transverse
  fields) and K2 (one sweep per axis, emitting flux divergences; stage 2
  averages with stage 1's faces) feed K3, which applies the update
  pointwise, counts invalid cells and applies the floors and the
  dual-energy sync. A ghost-padded level (the AMR path) runs the same
  sweeps on its padded state, K2d in stage 2 when the flux registers need
  the time-averaged face fluxes, and applies the update in plain torch as
  the JAX package does there;
- the lean formulation (`_advance_hydro_rk2_lean`, K1 + K2c) above 272
  cells an axis, and at any extent when the AMR root seeds its flux
  register in the kernels (K2e): the sweeps emit only divergence totals,
  the FOFC blend happens in the kernel, and the update is applied in
  plain torch;
- the classic flux formulation (`_advance_hydro_rk2_classic`, `rk2_stage`)
  where the JAX package runs XLA: any float64 state, f32 above 1088 cells
  an axis, with ``QUOKKA_PALLAS_LEAN=0`` above 272, and `rk_order` 1 above
  272. Its face fluxes come from `compute_fluxes`: K1 + K2's face mode for
  an f32 state, the plain sweep for any other dtype (on the card too), as
  the JAX package sends f64 to XLA.

The FOFC fallback is a Python `if` on the invalid count, where the JAX
package has a `lax.cond`: one host sync per stage. The fallback rebuilds
the classic flux formulation with the first-order (donor-cell + LLF)
fluxes on every face adjacent to an invalid cell (reference
`replaceFluxes`, ``src/QuokkaSimulation.hpp:1325-1369``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from .._numerics import div as true_div
from ..eos import IdealGasEOS
from ..indices import EINT, MX1, RHO
from ..stencil import interior, sh, sh_bc
from ..utils.profiler import prof
from . import euler
from .sweep import (_sum_divs, apply_update, compute_axis_flux,
                    compute_fluxes_pallas, compute_fluxes_pallas_div, finalize,
                    precompute_transverse)


@dataclass(frozen=True)
class HydroOptions:
    """Static solver configuration; mirrors the runtime knobs read by the
    reference (``src/QuokkaSimulation.hpp:340-396``)."""

    eos: IdealGasEOS
    active_axes: Tuple[int, ...]  # spatial axes with >1 cell
    dx: Tuple[float, float, float]
    reconstruction_order: int = 3  # 3=PPM, 2=PLM, 1=donor cell
    use_flattening: bool = True
    reconstruct_eint: bool = True
    riemann: str = "hllc"
    K_visc: float = 0.0  # artificial viscosity coefficient
    n_scalars: int = 0
    n_mscalars: int = 0
    density_floor: float = 0.0
    temperature_floor: float = 0.0
    use_dual_energy: bool = True
    rk_order: int = 2
    # kernel-fused divergence update: the only formulation ported so far
    fuse_update: bool = True

    @property
    def ndim(self) -> int:
        return len(self.active_axes)


def compute_fluxes(Ug, opts: HydroOptions, first_order: bool = False,
                   bc_kinds: dict | None = None):
    """All-axis face fluxes (`first_order=True`: the donor-cell + LLF backup
    fluxes of FOFC). With `bc_kinds` the state is unpadded and the return is
    (fluxes, facevels, flux_hi, vel_hi); without, the state is ghost-padded
    (roll semantics; the wrap reaches ghost faces only) and the return is
    (fluxes, facevels).

    An f32 state with three active axes takes the K1/K2 sweep (on the card
    the kernels or an error); any other dtype, and a state with fewer than
    three active axes, takes the plain sweep on its own device, as the JAX
    package's `compute_fluxes` sends them to XLA (`quokka_tpu/hydro/
    advance.py:280-313`; its kernels need three axes), and refuses
    ghost-free stepping as it does."""
    plain = Ug.dtype != torch.float32 or len(opts.active_axes) != 3
    if plain and bc_kinds is not None:
        raise ValueError("ghost-free stepping (bc_kinds) requires the kernel sweep "
                         f"(float32, 3D); got {Ug.dtype}, axes {opts.active_axes}")
    return compute_fluxes_pallas(Ug, opts, first_order, bc_kinds, plain=plain)


def _last_idx(n: int, ax: int, device) -> torch.Tensor:
    shape = [1, 1, 1]
    shape[ax] = n
    return torch.arange(n, device=device).reshape(shape)


def rhs_from_fluxes(fluxes: dict, opts: HydroOptions,
                    flux_hi: dict | None = None) -> torch.Tensor:
    """Flux divergence rhs(i) = sum_d (F_d(i) - F_d(i+1)) / dx_d; on wall
    axes the last cell reads the hi-wall plane `flux_hi[d]`."""
    rhs = None
    for d, F in fluxes.items():
        ax = d + 1
        contrib = (F - sh(F, 1, ax)) / opts.dx[d]
        if flux_hi is not None and d in flux_hi:
            n = F.shape[ax]
            last = (F.narrow(ax, n - 1, 1) - flux_hi[d].unsqueeze(ax)) / opts.dx[d]
            contrib = torch.where(_last_idx(n, d, F.device) == n - 1, last, contrib)
        rhs = contrib if rhs is None else rhs + contrib
    return rhs


def add_internal_energy_pdv(rhs, Ug, facevels: dict, opts: HydroOptions,
                            redo_mask=None, vel_hi: dict | None = None,
                            bc_kinds: dict | None = None):
    """-P div(v) source for the auxiliary internal energy (reference
    `AddInternalEnergyPdV`): face-velocity divergence, or central
    differences of cell velocities on FOFC-redo cells."""
    P = euler.pressure(Ug, opts.eos)
    div_v = None
    for d, v in facevels.items():
        c = (sh(v, 1, d) - v) / opts.dx[d]
        if vel_hi is not None and d in vel_hi:
            n = v.shape[d]
            last = (vel_hi[d].unsqueeze(d) - v.narrow(d, n - 1, 1)) / opts.dx[d]
            c = torch.where(_last_idx(n, d, v.device) == n - 1, last, c)
        div_v = c if div_v is None else div_v + c
    if redo_mask is not None:
        div_v = torch.where(redo_mask, _cell_div_v(Ug, opts, bc_kinds), div_v)
    rhs = rhs.clone()
    rhs[EINT] = rhs[EINT] + (-P * div_v)
    return rhs


def _cell_div_v(Ug, opts: HydroOptions, bc_kinds):
    """Central-difference divergence of the cell velocities."""
    div_cc = None
    for d in opts.active_axes:
        vel = Ug[MX1 + d] / Ug[RHO]
        bc_axis = None if bc_kinds is None else bc_kinds.get(d)
        if bc_axis is None:
            vp, vm = sh(vel, 1, d), sh(vel, -1, d)
        else:
            vp = sh_bc(vel, 1, d, *bc_axis, odd=True)
            vm = sh_bc(vel, -1, d, *bc_axis, odd=True)
        c = true_div(0.5 * (vp - vm), opts.dx[d])
        div_cc = c if div_cc is None else div_cc + c
    return div_cc


def _pad_mask(mask, ng: Sequence[int], periodic: Sequence[bool]):
    """Pad a boolean interior mask into ghost cells: periodic wrap where
    periodic, False elsewhere (reference `redoFlag.FillBoundary`)."""
    out = mask
    for d in range(3):
        g = ng[d]
        if g == 0:
            continue
        n = out.shape[d]
        if periodic[d]:
            lo, hi = out.narrow(d, n - g, g), out.narrow(d, 0, g)
        else:
            shape = list(out.shape)
            shape[d] = g
            lo = hi = torch.zeros(shape, dtype=out.dtype, device=out.device)
        out = torch.cat([lo, out, hi], dim=d)
    return out


def _blend_fofc(fluxes, facevels, fo_fluxes, fo_facevels, mask_p, opts,
                bc_kinds: dict, hi_planes: tuple):
    """First-order fluxes/face velocities on every face adjacent to a
    flagged cell (reference `replaceFluxes`). On wall axes the lo-wall face
    (slot 0) is flagged by cell 0 only, and the hi-wall planes (`hi_planes`
    = (flux_hi, vel_hi, fo_flux_hi, fo_vel_hi)) by the last cell."""
    new_f, new_v, new_fh, new_vh = {}, {}, {}, {}
    for d in fluxes:
        prev = sh(mask_p, -1, d)
        wall = bc_kinds is not None and bc_kinds.get(d) is not None
        if wall:
            n = mask_p.shape[d]
            prev = prev & (_last_idx(n, d, mask_p.device) > 0)
        face_flag = prev | mask_p
        new_f[d] = torch.where(face_flag[None], fo_fluxes[d], fluxes[d])
        new_v[d] = torch.where(face_flag, fo_facevels[d], facevels[d])
        if wall:
            flux_hi, vel_hi, fo_flux_hi, fo_vel_hi = hi_planes
            flag_hi = mask_p.select(d, mask_p.shape[d] - 1)
            new_fh[d] = torch.where(flag_hi[None], fo_flux_hi[d], flux_hi[d])
            new_vh[d] = torch.where(flag_hi, fo_vel_hi[d], vel_hi[d])
    return new_f, new_v, new_fh, new_vh


def rk2_stage(U0_int, Ug_old, fluxes: dict, facevels: dict, fo_fluxes_fn, dt, ng,
              periodic, opts: HydroOptions, bc_kinds: dict | None = None,
              flux_hi: dict | None = None, vel_hi: dict | None = None):
    """One flux-application stage with masked FOFC (`quokka_tpu/hydro/
    advance.py:464-567`): U_new = U0 + dt rhs(fluxes); where that leaves an
    invalid cell, the fluxes of every adjacent face are replaced by the
    first-order ones (`fo_fluxes_fn()`, computed only then) and the update
    is applied again. The JAX `lax.cond` is a Python `if` on one host read.

    Returns (U_new interior, final fluxes, final facevels, n_fofc), plus
    the final hi-wall planes (flux_hi, vel_hi) when ghost-free (`bc_kinds`)."""
    ghost_free = bc_kinds is not None

    def apply(fl, fv, redo_mask, fl_hi=None, fv_hi=None):
        rhs = rhs_from_fluxes(fl, opts, fl_hi)
        rhs = add_internal_energy_pdv(rhs, Ug_old, fv, opts, redo_mask, vel_hi=fv_hi,
                                      bc_kinds=bc_kinds)
        return U0_int + dt * interior(rhs, ng)

    U1 = apply(fluxes, facevels, None, flux_hi, vel_hi)
    redo = torch.logical_not(euler.is_state_valid(U1, opts.eos))
    n_redo = redo.sum()
    if not bool(n_redo > 0):  # host sync
        return ((U1, fluxes, facevels, n_redo)
                + ((flux_hi or {}, vel_hi or {}) if ghost_free else ()))
    fo = fo_fluxes_fn()
    mask_p = _pad_mask(redo, ng, periodic)
    if ghost_free:
        fl2, fv2, flh2, fvh2 = _blend_fofc(fluxes, facevels, fo[0], fo[1], mask_p, opts,
                                           bc_kinds, (flux_hi, vel_hi, fo[2], fo[3]))
        return apply(fl2, fv2, mask_p, flh2, fvh2), fl2, fv2, n_redo, flh2, fvh2
    fl2, fv2, _, _ = _blend_fofc(fluxes, facevels, fo[0], fo[1], mask_p, opts, {}, ())
    return apply(fl2, fv2, mask_p), fl2, fv2, n_redo


def _apply_from_divs(U0_int, Ug_old, div, dvel, dt, ng, opts: HydroOptions,
                     consume: bool = False, redo_mask=None, bc_kinds: dict | None = None):
    """Pointwise flux application from the divergence totals (+ PdV).
    `consume`: the caller hands `div` over, and the PdV source is added to
    it in place (the same rounding; a padded level's divergence total is
    3.4 GB at 520^3). `redo_mask` (bool, padded like `Ug_old`): FOFC-redo
    cells take the central-difference divergence of the cell velocities
    for the PdV source instead of the face-velocity one
    (`quokka_tpu/hydro/advance.py:577-608`)."""
    P = euler.pressure(Ug_old, opts.eos)
    rhs = div if consume else div.clone()
    del div
    if redo_mask is not None:
        dvel = torch.where(redo_mask, _cell_div_v(Ug_old, opts, bc_kinds), dvel)
    rhs[EINT] = rhs[EINT] + (-P * dvel)
    del P
    upd = dt * interior(rhs, ng)
    del rhs
    return upd.add_(U0_int) if consume else U0_int + upd


def _advance_hydro_rk2_fused(U, dt, opts: HydroOptions, ng, periodic,
                             bc_kinds: dict, fill_fn=None):
    """RK2-SSP step on the kernel-fused divergence path, with K3 finishing
    every stage (at every grid size: the CUDA kernel has no tiling rule).
    With `fill_fn` (the hybrid ghost-free mode: a hook-filled axis padded
    by `ng`, the others unpadded) each stage's input is padded first and K3
    reads the padded input and divergences at the interior, where the JAX
    package applies the update in XLA (`quokka_tpu/hydro/advance.py:
    703-712`). Returns (U_new, stats) with stats ``n_fofc`` (invalid cells
    before the floors, summed over stages, a 0-d tensor) and
    ``fofc_fallbacks`` (how many times a stage took the FOFC fallback, an
    int)."""
    if fill_fn is None:
        fill_fn = _identity
    Ug0 = fill_fn(U)

    def fo_fluxes():
        return compute_fluxes(Ug0, opts, first_order=True, bc_kinds=bc_kinds)

    def apply_fluxes(fl, fv, redo_mask, fl_hi, fv_hi):
        rhs = rhs_from_fluxes(fl, opts, fl_hi or None)
        rhs = add_internal_energy_pdv(rhs, Ug0, fv, opts, redo_mask,
                                      vel_hi=fv_hi or None, bc_kinds=bc_kinds)
        return U + dt * interior(rhs, ng)

    def redo1_mask():
        U1_try = _apply_from_divs(U, Ug0, _sum_divs(r1["divs"]),
                                  _sum_divs(r1["dvels"]), dt, ng, opts)
        return torch.logical_not(euler.is_state_valid(U1_try, opts.eos))

    def blend_stage1(redo1):
        mask_p = _pad_mask(redo1, ng, periodic)
        fo_fl, fo_fv, fo_flh, fo_fvh = fo_fluxes()
        fl, fv, flh, fvh = _blend_fofc(
            r1["fluxes"], r1["facevels"], fo_fl, fo_fv, mask_p, opts,
            bc_kinds, (r1["flux_hi"], r1["vel_hi"], fo_flh, fo_fvh))
        return fl, fv, flh, fvh, mask_p

    # ---- stage 1
    r1 = compute_fluxes_pallas_div(Ug0, opts, bc_kinds)
    U1, n1 = apply_update(U, Ug0, r1["divs"], r1["dvels"], dt, opts, ng)
    fired1 = bool(n1 > 0)  # host sync
    fallbacks = int(fired1)
    if fired1:
        fl, fv, flh, fvh, mask_p = blend_stage1(redo1_mask())
        U1 = finalize(apply_fluxes(fl, fv, mask_p, flh, fvh), opts)
    if opts.rk_order == 1:
        return U1, {"n_fofc": n1, "fofc_fallbacks": fallbacks}

    # ---- stage 2: divergence of the time-averaged flux
    Ug1 = fill_fn(U1)
    r2 = compute_fluxes_pallas_div(Ug1, opts, bc_kinds, avg_with=r1)
    U2, n2 = apply_update(U, Ug0, r2["divs"], r2["dvels"], dt, opts, ng)
    fired2 = bool(n2 > 0)  # host sync
    if not (fired1 or fired2):
        return U2, {"n_fofc": n1 + n2, "fofc_fallbacks": fallbacks}

    # fallback: stage-1 final (blended) fluxes, the raw stage-2 sweep, the
    # time average, flux application, and the stage-2 FOFC blend
    fallbacks += 1
    fl1f, fv1f, flh1f, fvh1f, _ = blend_stage1(redo1_mask())
    fl2r, fv2r, flh2r, fvh2r = compute_fluxes(Ug1, opts, bc_kinds=bc_kinds)
    flux_avg = {d: 0.5 * (fl1f[d] + fl2r[d]) for d in fl1f}
    vel_avg = {d: 0.5 * (fv1f[d] + fv2r[d]) for d in fv1f}
    flh_avg = {d: 0.5 * (flh1f[d] + flh2r[d]) for d in flh1f}
    fvh_avg = {d: 0.5 * (fvh1f[d] + fvh2r[d]) for d in fvh1f}
    U2a = apply_fluxes(flux_avg, vel_avg, None, flh_avg, fvh_avg)
    redo2b = torch.logical_not(euler.is_state_valid(U2a, opts.eos))
    n2 = redo2b.sum()
    if bool(redo2b.any()):  # host sync
        mask_p = _pad_mask(redo2b, ng, periodic)
        fo_fl, fo_fv, fo_flh, fo_fvh = fo_fluxes()
        fl, fv, flh, fvh = _blend_fofc(
            flux_avg, vel_avg, fo_fl, fo_fv, mask_p, opts, bc_kinds,
            (flh_avg, fvh_avg, fo_flh, fo_fvh))
        U2 = finalize(apply_fluxes(fl, fv, mask_p, flh, fvh), opts)
    else:
        U2 = finalize(U2a, opts)
    return U2, {"n_fofc": n1 + n2, "fofc_fallbacks": fallbacks}


# The lean step's stage-2 FOFC takes its first-order fluxes from the
# post-FOFC stage-1 state above this extent (`quokka_tpu/hydro/advance.py:
# 1041-1057`); the JAX dispatch sends ghost-free f32 steps of extent above
# it, up to LEAN_MAX_EXTENT, to the lean step (`:1139-1162`, `:250`).
LEAN_MIN_EXTENT = 272
LEAN_MAX_EXTENT = 1088
# profiler regions of the lean step's two RK stages (step_profile.py)
LEAN_STAGES = ("lean_stage1", "lean_stage2")


def _advance_hydro_rk2_lean(U, dt, opts: HydroOptions, ng, periodic, bc_kinds: dict,
                            corr_masks: dict | None = None, fill_fn=None):
    """RK2-SSP step in the lean divergence formulation (`quokka_tpu/hydro/
    advance.py:925-1078`), the JAX package's path for unigrid steps above
    272 cells an axis. K2c emits only accumulated divergence totals, so no
    face array is ever held:

    - stage 1: div1 = sum_d div(F1_d) chained through the kernels'
      accumulators, applied pointwise; a FOFC fallback sweeps again with
      the flag mask as a kernel input (the first-order blend happens in the
      kernel);
    - stage 2: the kernels add div2 onto stage 1's totals in place and the
      update is U + 0.5 dt (div1 + div2), the time average by linearity;
    - a stage-2 fallback sweeps G1 = blend(F(U0), fo, m1 | m2) and chains
      G2 = blend(F(U1), fo, m2) onto it. Above 272 cells an axis the
      first-order fluxes of G2 come from U1 itself, at or below from U0
      (`fo_from`), as the JAX step does.

    With `corr_masks` ({axis: [X, Y, Z] 0/1 coarse-fine boundary-face
    mask}, the AMR root's flux-register seeding, `quokka_tpu/hydro/
    advance.py:936-1077`) every sweep is K2e: it also emits the divergence
    of the boundary-masked blended fluxes, chained over the axes and, in
    stage 2, onto stage 1's (`corr_init`); ``stats["reflux_corr"]`` is the
    time-averaged seed 0.5 (corr1 + corr2) (stage 1's alone with
    `rk_order` 1), so the register uses the very fluxes of the update in
    every FOFC branch.

    With `fill_fn` (the hybrid ghost-free mode) each stage's input is
    padded by `ng` first, as in the JAX step. The FOFC checks are a Python
    `if` on one host read a stage, where the JAX package has a `lax.cond`.
    Returns (U_new, stats) with ``n_fofc`` (invalid cells of the two try
    states, a 0-d tensor) and ``fofc_fallbacks`` (stages that fell back, an
    int)."""
    eos = opts.eos
    dtype = U.dtype
    if fill_fn is None:
        fill_fn = _identity
    Ug0 = fill_fn(U)

    def sweeps(Ug, fo_mask=None, fo_from=None, acc_init=None, corr_init=None):
        return compute_fluxes_pallas_div(Ug, opts, bc_kinds, accumulate=True,
                                         div_only=True, fo_mask=fo_mask,
                                         fo_from=fo_from, acc_init=acc_init,
                                         corr_masks=corr_masks, corr_init=corr_init)

    with prof.region(LEAN_STAGES[0]):
        r1 = sweeps(Ug0)
        U1_try = _apply_from_divs(U, Ug0, r1["div"], r1["dvel"], dt, ng, opts)
        redo1 = torch.logical_not(euler.is_state_valid(U1_try, eos))
        n1 = redo1.sum()
        fired1 = bool(n1 > 0)  # host sync
        m1b = _pad_mask(redo1, ng, periodic)
        if fired1:
            del U1_try, r1
            rb = sweeps(Ug0, fo_mask=m1b.to(dtype))
            div1, dvel1, corr1 = rb["div"], rb["dvel"], rb.get("corr")
            U1 = finalize(_apply_from_divs(U, Ug0, div1, dvel1, dt, ng, opts,
                                           redo_mask=m1b, bc_kinds=bc_kinds), opts)
            del rb
        else:
            U1 = finalize(U1_try, opts)
            div1, dvel1, corr1 = r1["div"], r1["dvel"], r1.get("corr")
            del U1_try, r1
    if opts.rk_order == 1:
        stats1 = {"n_fofc": n1, "fofc_fallbacks": int(fired1)}
        if corr_masks is not None:
            stats1["reflux_corr"] = corr1
        return U1, stats1

    # ---- stage 2: the averaged divergences, added onto stage 1's totals
    with prof.region(LEAN_STAGES[1]):
        Ug1 = fill_fn(U1)
        r2 = sweeps(Ug1, acc_init=(div1, dvel1), corr_init=corr1)
        del div1, dvel1, corr1
        U2_try = _apply_from_divs(U, Ug0, r2["div"], r2["dvel"], 0.5 * dt, ng, opts,
                                  consume=True)
        corr2t = r2.get("corr")
        del r2
        redo2 = torch.logical_not(euler.is_state_valid(U2_try, eos))
        n2 = redo2.sum()
        stats = {"n_fofc": n1 + n2, "fofc_fallbacks": int(fired1)}
        if not bool(n2 > 0):  # host sync
            U2 = finalize(U2_try, opts)
        else:
            # fallback: G1 = blend(F(U0), fo(U0), m1 | m2), then G2 =
            # blend(F(U1), fo, m2) chained onto it; 0.5 (G1 + G2) is the
            # blended average
            del U2_try, corr2t
            stats["fofc_fallbacks"] += 1
            m2b = _pad_mask(redo2, ng, periodic)
            g1 = sweeps(Ug0, fo_mask=(m1b | m2b).to(dtype))
            acc, corr_g1 = (g1["div"], g1["dvel"]), g1.get("corr")
            del g1
            if max(U.shape[1:]) > LEAN_MIN_EXTENT:
                # quokka_tpu/hydro/advance.py:1041-1057: first order from U1
                g2 = sweeps(Ug1, fo_mask=m2b.to(dtype), acc_init=acc, corr_init=corr_g1)
            else:
                g2 = sweeps(Ug1, fo_mask=m2b.to(dtype), fo_from=Ug0, acc_init=acc,
                            corr_init=corr_g1)
            del acc, corr_g1
            corr2t = g2.get("corr")
            U2 = finalize(_apply_from_divs(U, Ug0, g2["div"], g2["dvel"], 0.5 * dt, ng,
                                           opts, consume=True, redo_mask=m2b,
                                           bc_kinds=bc_kinds), opts)
            del g2
        if corr_masks is not None:
            # corr2t = corr1 + corr2 (chained); the register takes the
            # time-averaged seed
            stats["reflux_corr"] = 0.5 * corr2t
        return U2, stats


def _identity(X):
    return X


def _padded_sweeps(Ug, opts: HydroOptions, r1: dict | None = None,
                   emit_avg_flux: bool = False) -> dict:
    """K1, then K2 along every axis of the ghost-padded state `Ug` (the
    padded form of `compute_fluxes_pallas_div`). Returns ``fluxes``,
    ``facevels`` (stage 1), ``div`` (the sorted-axis sum of the per-axis
    flux divergences, which is all the update reads of them) and per-axis
    ``dvels``.

    Stage 2 (`r1` = stage 1's dict): K2 averages with stage 1's faces, each
    axis's stage-1 faces being dropped from `r1` once its sweep has read
    them; with `emit_avg_flux` (K2d) the sweep also returns the time-averaged
    face fluxes as ``fluxes`` and its ``dvels`` are the RAW stage-2
    velocity divergences."""
    dmins, chi_cell, _ = precompute_transverse(Ug, opts, None, state_is_cons=True)
    out = {"fluxes": {}, "facevels": {}, "div": None, "dvels": {}}
    for d in opts.active_axes:
        if r1 is None:
            F, v, dv, dl = compute_axis_flux(Ug, d, opts, chi_cell, dmins,
                                             dx_axis=opts.dx[d], state_is_cons=True)
            out["fluxes"][d], out["facevels"][d] = F, v
        else:
            avg = (r1["fluxes"].pop(d), r1["facevels"].pop(d))
            res = compute_axis_flux(Ug, d, opts, chi_cell, dmins, dx_axis=opts.dx[d],
                                    avg_with=avg, state_is_cons=True,
                                    emit_avg_flux=emit_avg_flux)
            del avg
            dv, dl = res[0], res[1]
            if emit_avg_flux:
                out["fluxes"][d] = res[2]
            del res
        out["div"] = dv if out["div"] is None else out["div"] + dv
        out["dvels"][d] = dl
        del dv
    return out


def _advance_hydro_rk2_padded(U, dt, opts: HydroOptions, fill_fn, ng, periodic,
                              fill_fn2=None, return_fluxes: bool = False):
    """RK2-SSP step of a level whose ghosts `fill_fn` pads (the padded form
    of `_advance_hydro_rk2_fused`, the AMR path): K1 + K2 per stage on the
    padded state, the update applied from the divergence totals in plain
    torch (`_apply_from_divs`; K3 takes unpadded states only, as in the JAX
    package), and the FOFC fallback reproducing the classic flux blending.

    With `return_fluxes` the stage-2 sweeps are K2d: they also emit the
    time-averaged face fluxes 0.5 (F1 + F2) for the flux registers, and
    their velocity divergences come back raw, so they are averaged with
    stage 1's here (divergence is linear). Returns (U_new, stats) with
    ``n_fofc``, ``fofc_fallbacks`` and, with `return_fluxes`, ``fluxes``
    {axis: [nv, padded X, Y, Z]}, the final (post-blend) averaged fluxes.

    Host syncs: one FOFC check per stage, as on the ghost-free path. Each
    intermediate is dropped where the JAX program lets it die: stage 1's
    faces axis by axis as stage 2's sweeps read them (the rare fallback
    sweeps stage 1 again, which the deterministic kernels reproduce
    bitwise)."""
    eos = opts.eos
    if fill_fn2 is None:
        fill_fn2 = fill_fn
    no_walls = {}

    Ug0 = fill_fn(U)

    def fo_fluxes():
        return compute_fluxes(Ug0, opts, first_order=True)

    def apply_fluxes(fl, fv, redo_mask):
        rhs = rhs_from_fluxes(fl, opts)
        rhs = add_internal_energy_pdv(rhs, Ug0, fv, opts, redo_mask)
        return U + dt * interior(rhs, ng)

    def blend_stage1(r1_faces, redo1):
        mask_p = _pad_mask(redo1, ng, periodic)
        fo_fl, fo_fv = fo_fluxes()
        fl, fv, _, _ = _blend_fofc(r1_faces["fluxes"], r1_faces["facevels"], fo_fl,
                                   fo_fv, mask_p, opts, no_walls, ())
        return fl, fv, mask_p

    # ---- stage 1
    r1 = _padded_sweeps(Ug0, opts)
    U1_try = _apply_from_divs(U, Ug0, r1.pop("div"), _sum_divs(r1["dvels"]), dt, ng, opts,
                              consume=True)
    redo1 = torch.logical_not(euler.is_state_valid(U1_try, eos))
    n1 = redo1.sum()
    fired1 = bool(n1 > 0)  # host sync
    fallbacks = int(fired1)
    if fired1:
        del U1_try
        fl, fv, mask_p = blend_stage1(r1, redo1)
        U1 = finalize(apply_fluxes(fl, fv, mask_p), opts)
        del fl, fv, mask_p
    else:
        U1 = finalize(U1_try, opts)
        del U1_try
    if opts.rk_order == 1:
        return U1, {"n_fofc": n1, "fofc_fallbacks": fallbacks}

    # ---- stage 2: divergence of the time-averaged flux (K2, or K2d with
    # return_fluxes)
    Ug1 = fill_fn2(U1)
    del U1
    dvels1 = r1["dvels"]
    r2 = _padded_sweeps(Ug1, opts, r1=r1, emit_avg_flux=return_fluxes)
    del r1
    dvels2 = r2.pop("dvels")
    if return_fluxes:
        dvels2 = {d: 0.5 * (dvels1[d] + dvels2[d]) for d in dvels2}
    del dvels1
    U2_try = _apply_from_divs(U, Ug0, r2.pop("div"), _sum_divs(dvels2), dt, ng, opts,
                              consume=True)
    del dvels2
    redo2 = torch.logical_not(euler.is_state_valid(U2_try, eos))
    n2 = redo2.sum()
    if not (fired1 or bool(n2 > 0)):  # host sync
        del redo2
        stats = {"n_fofc": n1 + n2, "fofc_fallbacks": fallbacks}
        if return_fluxes:
            stats["fluxes"] = r2["fluxes"]
        return finalize(U2_try, opts), stats

    # fallback: stage-1 final (blended) fluxes, the raw stage-2 sweep, the
    # time average, flux application, and the stage-2 FOFC blend
    del U2_try, r2, redo2
    fallbacks += 1
    fl1f, fv1f, _ = blend_stage1(_padded_sweeps(Ug0, opts), redo1)
    fl2r, fv2r = compute_fluxes(Ug1, opts)
    flux_avg = {d: 0.5 * (fl1f[d] + fl2r[d]) for d in fl1f}
    vel_avg = {d: 0.5 * (fv1f[d] + fv2r[d]) for d in fv1f}
    del fl1f, fv1f, fl2r, fv2r
    U2a = apply_fluxes(flux_avg, vel_avg, None)
    redo2b = torch.logical_not(euler.is_state_valid(U2a, eos))
    n2 = redo2b.sum()
    fl_out = flux_avg
    if bool(n2 > 0):  # host sync
        mask_p = _pad_mask(redo2b, ng, periodic)
        fo_fl, fo_fv = fo_fluxes()
        fl_out, fv, _, _ = _blend_fofc(flux_avg, vel_avg, fo_fl, fo_fv, mask_p, opts,
                                       no_walls, ())
        U2a = apply_fluxes(fl_out, fv, mask_p)
    stats = {"n_fofc": n1 + n2, "fofc_fallbacks": fallbacks}
    if return_fluxes:
        stats["fluxes"] = fl_out
    return finalize(U2a, opts), stats


def _advance_hydro_rk2_classic(U, dt, opts: HydroOptions, fill_fn, ng, periodic,
                               fill_fn2=None, return_fluxes: bool = False,
                               bc_kinds: dict | None = None):
    """RK2-SSP step in the classic flux formulation (`quokka_tpu/hydro/
    advance.py:1182-1243`): the face fluxes of each stage, `rk2_stage` for
    the update and its FOFC, stage 2 on the time-averaged fluxes. Padded
    (`fill_fn` pads, `bc_kinds` None) or ghost-free (`bc_kinds`, the state
    unpadded, the hi-wall planes carried beside the face arrays). Returns
    (U_new, stats) with ``n_fofc``, ``fofc_fallbacks`` and, with
    `return_fluxes`, ``fluxes`` (stage 1's with `rk_order` 1, else the
    final averaged ones)."""
    eos = opts.eos
    ghost_free = bc_kinds is not None
    if fill_fn2 is None:
        fill_fn2 = fill_fn

    def lim(Ux):
        return finalize(Ux, opts)

    Ug0 = fill_fn(U)

    def fo_fluxes_fn():
        return compute_fluxes(Ug0, opts, first_order=True, bc_kinds=bc_kinds)

    fallbacks = 0
    if ghost_free:
        fl, fv, flh, fvh = compute_fluxes(Ug0, opts, bc_kinds=bc_kinds)
        U1, fl1, fv1, n1, flh1, fvh1 = rk2_stage(U, Ug0, fl, fv, fo_fluxes_fn, dt, ng,
                                                 periodic, opts, bc_kinds, flh, fvh)
    else:
        fl, fv = compute_fluxes(Ug0, opts)
        U1, fl1, fv1, n1 = rk2_stage(U, Ug0, fl, fv, fo_fluxes_fn, dt, ng, periodic, opts)
    del fl, fv
    fallbacks += int(bool(n1 > 0))
    U1 = lim(U1)
    if opts.rk_order == 1:
        stats = {"n_fofc": n1, "fofc_fallbacks": fallbacks}
        if return_fluxes:
            stats["fluxes"] = fl1
        return U1, stats

    # ---- stage 2: the time-averaged flux (Heun / RK2-SSP)
    Ug1 = fill_fn2(U1)
    if ghost_free:
        fl2r, fv2r, flh2r, fvh2r = compute_fluxes(Ug1, opts, bc_kinds=bc_kinds)
        flux_avg = {d: 0.5 * (fl1[d] + fl2r[d]) for d in fl1}
        vel_avg = {d: 0.5 * (fv1[d] + fv2r[d]) for d in fv1}
        flh_avg = {d: 0.5 * (flh1[d] + flh2r[d]) for d in flh1}
        fvh_avg = {d: 0.5 * (fvh1[d] + fvh2r[d]) for d in fvh1}
        del fl2r, fv2r, flh2r, fvh2r
        U2, fl2, _, n2, _, _ = rk2_stage(U, Ug0, flux_avg, vel_avg, fo_fluxes_fn, dt, ng,
                                         periodic, opts, bc_kinds, flh_avg, fvh_avg)
    else:
        fl2r, fv2r = compute_fluxes(Ug1, opts)
        flux_avg = {d: 0.5 * (fl1[d] + fl2r[d]) for d in fl1}
        vel_avg = {d: 0.5 * (fv1[d] + fv2r[d]) for d in fv1}
        del fl2r, fv2r
        U2, fl2, _, n2 = rk2_stage(U, Ug0, flux_avg, vel_avg, fo_fluxes_fn, dt, ng,
                                   periodic, opts)
    fallbacks += int(bool(n2 > 0))
    stats = {"n_fofc": n1 + n2, "fofc_fallbacks": fallbacks}
    if return_fluxes:
        stats["fluxes"] = fl2
    return lim(U2), stats


def advance_hydro_rk2(U, dt, opts: HydroOptions, fill_fn=None,
                      ng: Sequence[int] = (0, 0, 0),
                      periodic: Sequence[bool] = (True, True, True),
                      mask_fill_fn=None, fill_fn2=None,
                      return_fluxes: bool = False, redo_any_fn=None,
                      bc_kinds: dict | None = None,
                      reflux_corr_masks: dict | None = None):
    """Full RK2-SSP hydro step (reference `advanceHydroAtLevel`), in one of
    two forms:

    - ghost-free (`bc_kinds` = {axis: (lo, hi) | None}, None = periodic or
      padded): the unigrid path. With `ng` all 0 and no `fill_fn` every
      axis is unpadded and the kernels assemble the walls; in the hybrid
      mode `fill_fn` pads the hook-filled axes by `ng` (a BC_USER x axis:
      `ng = (4, 0, 0)`), which the kernels see padded with roll semantics,
      while the others stay unpadded (`quokka_tpu/simulation.py:222-294`);
    - ghost-padded (`bc_kinds` None): `fill_fn(U)` pads the ghosts (and
      `fill_fn2` the stage-2 state; AMR fills interpolate the parent in
      time there), `ng` the ghost widths; `return_fluxes` adds the
      time-averaged face fluxes for the flux registers. A state with fewer
      than three active axes steps so, in the classic form on the plain
      sweep, as the JAX package steps it in XLA.

    The formulation is the one the JAX package's dispatch takes
    (`_branch`): lean (K1 + K2c, K2e with `reflux_corr_masks`), fused
    (K1-K3, or K1 + K2 + K2d on a padded level), or classic (the flux
    dicts of `compute_fluxes`). `reflux_corr_masks` ({axis: boundary-face
    mask}, the AMR root's in-kernel register seed) forces the lean step and
    adds ``reflux_corr`` to the stats. Any other configuration raises
    NotImplementedError. `dt` is a float or a one-element tensor on the
    state's device. Returns (U_new, stats)."""
    padded = bc_kinds is None
    unsupported = {
        "redo_any_fn": redo_any_fn is not None,
        "mask_fill_fn": mask_fill_fn is not None,
        "rk_order not in (1, 2)": opts.rk_order not in (1, 2),
        "riemann != hllc": opts.riemann != "hllc",
    }
    if padded:
        unsupported["ghost-padded stepping without fill_fn"] = fill_fn is None
    else:
        unsupported.update({
            "fill_fn2 (ghost-free stepping)": fill_fn2 is not None,
            "return_fluxes (ghost-free stepping)": return_fluxes,
            "ng != 0 without fill_fn (ghost-free stepping)": (
                fill_fn is None and any(g != 0 for g in ng)),
            "a padded wall axis (ghost-free stepping)": any(
                ng[d] and bc_kinds.get(d) is not None for d in range(3)),
        })
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"advance_hydro_rk2: not ported yet: {bad}")
    branch = _branch(U, opts, padded, return_fluxes, ng,
                     corr=reflux_corr_masks is not None)
    if U.device.type == "cuda":
        dt = torch.as_tensor(dt, dtype=U.dtype, device=U.device).reshape(())
    if branch == "classic":
        return _advance_hydro_rk2_classic(U, dt, opts, fill_fn or (lambda X: X), ng,
                                          periodic, fill_fn2, return_fluxes, bc_kinds)
    if branch == "lean":
        return _advance_hydro_rk2_lean(U, dt, opts, ng, periodic, bc_kinds,
                                       corr_masks=reflux_corr_masks, fill_fn=fill_fn)
    if padded:
        return _advance_hydro_rk2_padded(U, dt, opts, fill_fn, ng, periodic,
                                         fill_fn2, return_fluxes)
    return _advance_hydro_rk2_fused(U, dt, opts, ng, periodic, bc_kinds, fill_fn)


def _branch(U, opts: HydroOptions, padded: bool, return_fluxes: bool, ng,
            corr: bool = False) -> str:
    """"lean", "fused" or "classic": the JAX package's dispatch
    (`quokka_tpu/hydro/advance.py:1139-1181`). The lean step takes a
    float32 RK2 step of three active axes with the fused update and no face
    outputs when the register seed (`corr`) asks for it, when
    ``QUOKKA_PALLAS_LEAN`` is "1", or when it is "auto" (the default) and
    the extent lies in (272, 1088]: the padded one on a padded level, the
    unpadded one in a ghost-free step (the hybrid mode's padded axes
    included, as in the JAX package). The fused step takes float32 at or
    below 272 without face outputs. Every other step is classic: any
    float64 state, fewer than three active axes, f32 above 1088, above 272
    with ``QUOKKA_PALLAS_LEAN=0``, `rk_order` 1 above 272, `fuse_update =
    False`. Two deviations: a padded f32 RK2 level with flux outputs (the
    AMR levels) runs the fused kernels at every extent, where the JAX
    package leaves the fused form above 176 padded cells (a TPU VMEM
    limit, `fits_vmem`); and the padded lean form is not ported (the port
    steps its unigrid ghost-free), so it raises."""
    f32 = U.dtype == torch.float32 and len(opts.active_axes) == 3
    ext = max(U.shape[1:]) + (2 * max(ng) if padded else 0)
    pref = os.environ.get("QUOKKA_PALLAS_LEAN", "auto")
    pallas_ok = ext <= LEAN_MIN_EXTENT
    lean_form = opts.fuse_update and f32 and not return_fluxes and opts.rk_order == 2
    if lean_form and (corr or pref == "1"
                      or (pref == "auto" and not pallas_ok and ext <= LEAN_MAX_EXTENT)):
        if padded:
            raise NotImplementedError(
                "advance_hydro_rk2: the padded (ghost-padded) lean step is not ported; "
                "the port steps a unigrid ghost-free")
        return "lean"
    if corr:
        raise NotImplementedError(
            "reflux_corr_masks requires the lean path (float32, 3D, fuse_update, "
            "rk_order 2, no flux outputs)")
    if opts.fuse_update and f32:
        if padded and return_fluxes and opts.rk_order == 2:
            return "fused"
        if pallas_ok and not return_fluxes:
            return "fused"
    return "classic"
