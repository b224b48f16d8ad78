"""Hydro sweep kernels K1-K3 (and K2's variants K2c, K2d): wrappers, plain
PyTorch versions, and the all-axis sweeps.

Counterpart of `quokka_tpu.hydro.pallas_sweep`. Each kernel has

  - a plain PyTorch version (`precompute_transverse_plain`,
    `axis_flux_plain`, `apply_update_plain`), built from the ported
    `euler` / `reconstruct` / `riemann` functions on a wall-ghost-assembled
    tensor, exactly as the JAX kernel bodies compute in VMEM;
  - a wrapper (`precompute_transverse`, `compute_axis_flux`,
    `apply_update`) that takes the plain version for a tensor on the CPU and
    launches the CUDA kernel (``csrc/``) for a tensor on a CUDA device. It
    raises for any other device and for what the kernel does not take.

`launch_counts` counts kernel launches per wrapper, so a run can show that
it went through the kernels: ``axis_flux`` counts K2, ``axis_flux_avg`` its
K2d variant (`emit_avg_flux`, the stage-2 sweep of a padded AMR level that
also emits the time-averaged face flux for the flux registers) and
``axis_flux_lean`` its K2c variant (`div_only`, the lean large-domain
sweep: only the divergences leave the kernel, optionally added onto running
totals in place (`acc`) and with the FOFC first-order blend done in the
kernel (`fo_mask`, `fo_from`)) and ``axis_flux_corr`` its K2e form (K2c
with `corr_mask`: the AMR root's flux-register seed, the divergence of the
boundary-masked blended faces, optionally added onto `corr_acc` in place).
K1 and K2's face mode also take a chunk of ghost-padded blocks [B, 6, X, Y,
Z] in one launch an axis (`compute_fluxes_batched`, the packed AMR
engine).

Layout: ``[nvar, X, Y, Z]``, contiguous, z fastest. Face arrays keep the
JAX convention: slot i is the face between cells i-1 and i (slot 0 is the
lo-wall face on a wall axis), and the hi-wall face comes back as separate
``flux_hi`` / ``vel_hi`` planes. Walls are given per axis as
``bc_axis = (lo_kind, hi_kind)``, each side reflect or outflow; None means
periodic. An outflow side's wall-adjacent chi_cell ghost is K1's exact
plane (`outflow_chi_planes`, K2's `chi_ghost_axis`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .._numerics import sqrt
from ..indices import EGAS, EINT, MX1, PEINT, PPRES, PRHO, PVX1, RHO, SCALAR0
from ..registry import BC_OUTFLOW, BC_REFLECT
from ..stencil import interior, sh
from . import euler, reconstruct
from .riemann import FaceState, hllc, llf

launch_counts = {"transverse": 0, "axis_flux": 0, "axis_flux_avg": 0,
                 "axis_flux_lean": 0, "axis_flux_corr": 0, "apply_update": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _transverse_axes(axis: int, ndim: int) -> Tuple[int, int]:
    """(v_axis, w_axis) of the canonical Riemann frame (reference
    ``src/hydro/hydro_system.hpp:952-976``)."""
    if axis == 0:
        return 1, 2
    if axis == 1:
        return (0, 2) if ndim == 2 else (2, 0)
    return 0, 1


def _on_cuda(t: torch.Tensor) -> bool:
    """True: launch the kernel; False: plain version (CPU tensor only)."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise NotImplementedError(f"no kernel for device {t.device}")


# ------------------------------------------------------------ plain versions
def _check_bc(bc_axis):
    if bc_axis is None:
        return
    for kind in bc_axis:
        if kind not in (BC_REFLECT, BC_OUTFLOW):
            raise NotImplementedError(
                f"wall kind {kind!r}: the hydro sweep assembles periodic, reflect and "
                "outflow walls (the NSCBC and user walls are padded by "
                "boundaries.fill_ghosts, and NSCBC is not ported yet)")


def _assemble_wall_ghosts(blk: torch.Tensor, ax: int, lo_kind: str, hi_kind: str,
                          odd_comp: int | None, g: int = 4, adj_lo=None,
                          adj_hi=None) -> torch.Tensor:
    """Extend `blk` by `g` ghost entries on each side of spatial axis `ax`
    (`pallas_sweep._assemble_wall_ghosts`, `:250-312`): a reflecting side
    mirrors the block, flipping the sign of component `odd_comp` (the normal
    velocity or momentum); an outflow side copies the edge entry, and with
    `adj_lo` / `adj_hi` (a plane, the axis kept with extent 1) the
    wall-adjacent ghost takes that plane instead: g - 1 edge copies, then
    the plane. The padded fill's values exactly."""
    nax = blk.dim() - 3 + ax
    n = blk.shape[nax]

    def side(kind, mirror_from, edge, adj, adj_first):
        if kind == BC_REFLECT:
            out = blk.narrow(nax, mirror_from, g).flip(nax)
            if odd_comp is not None:
                out = out.clone()
                out[odd_comp] = -out[odd_comp]
            return out
        shape = list(blk.shape)
        shape[nax] = g if adj is None else g - 1
        out = blk.narrow(nax, edge, 1).expand(shape)
        if adj is None:
            return out
        adj = adj.reshape(blk.narrow(nax, 0, 1).shape)
        return torch.cat([adj, out] if adj_first else [out, adj], dim=nax)

    lo = side(lo_kind, 0, 0, adj_lo, False)
    hi = side(hi_kind, n - g, n - 1, adj_hi, True)
    return torch.cat([lo, blk, hi], dim=nax)


def _face_state(q: torch.Tensor, axis: int, opts) -> FaceState:
    """Canonical-frame FaceState from reconstructed face primitives (the
    in-kernel `face_state` of `pallas_sweep._sweep_body`)."""
    eos = opts.eos
    vax, wax = _transverse_axes(axis, max(opts.ndim, 1))
    rho = q[PRHO]
    rinv = 1.0 / rho
    u, v, w = q[PVX1 + axis], q[PVX1 + vax], q[PVX1 + wax]
    ke = 0.5 * rho * (u * u + v * v + w * w)
    if eos.is_isothermal:
        P = rho * eos.cs_isothermal**2
        cs = torch.full_like(rho, eos.cs_isothermal)
        E = torch.zeros_like(rho)
        Eint = torch.zeros_like(rho)
    else:
        if opts.reconstruct_eint:
            P = eos.pressure(rho, q[PPRES] * rho)
            Eint = rho * q[PEINT]
        else:
            P = q[PPRES]
            Eint = q[PEINT]
        cs = sqrt(eos.gamma * P * rinv)
        E = eos.eint_from_pres(rho, P) + ke
    scalars = q[SCALAR0:] if q.shape[0] > SCALAR0 else None
    return FaceState(rho=rho, u=u, v=v, w=w, P=P, cs=cs, E=E, Eint=Eint,
                     scalars=scalars, rinv=rinv)


def _sweep_body(prim, chi, dminv, dminw, axis: int, opts, first_order: bool):
    """Flux + face velocity along `axis` of a primitive tensor (roll
    semantics along the axis). Returns (flux[nv, ...], facevel[...]) in
    state component order."""
    eos = opts.eos
    ax = axis + 1
    if first_order:
        qL, qR = reconstruct.donor_cell_faces(prim, axis)
    else:
        qL, qR = reconstruct.reconstruct_faces(prim, axis,
                                               opts.reconstruction_order)
        if chi is not None:
            chi_m1 = sh(chi, -1, axis)[None]
            chi_0 = chi[None]
            qL = chi_m1 * qL + (1.0 - chi_m1) * sh(prim, -1, ax)
            qR = chi_0 * qR + (1.0 - chi_0) * prim
    vax, wax = _transverse_axes(axis, max(opts.ndim, 1))
    sL = _face_state(qL, axis, opts)
    sR = _face_state(qR, axis, opts)

    if first_order:
        F = llf(sL, sR)
    else:
        un = prim[PVX1 + axis]
        du = un - sh(un, -1, axis)
        dvl = dvr = dwl = dwr = None
        dw = None
        if dminv is not None:
            dvl, dvr = sh(dminv, -1, axis), dminv
            dw = torch.minimum(dvl, dvr)
        if dminw is not None:
            dwl, dwr = sh(dminw, -1, axis), dminw
            m2 = torch.minimum(dwl, dwr)
            dw = m2 if dw is None else torch.minimum(dw, m2)
        if dw is None:
            dw = torch.zeros_like(du)
        F = hllc(sL, sR, eos, du, dw)
        if opts.K_visc > 0.0:
            div_v = du
            if dvl is not None:
                div_v = div_v + 0.5 * (dvl + dvr)
            if dwl is not None:
                div_v = div_v + 0.5 * (dwl + dwr)
            viscosity = opts.K_visc * torch.clamp(-div_v, min=0.0)
            F = F + viscosity[None] * (sL.conserved() - sR.conserved())

    comps = [None] * F.shape[0]
    comps[RHO] = F[0]
    comps[MX1 + axis] = F[1]
    comps[MX1 + vax] = F[2]
    comps[MX1 + wax] = F[3]
    comps[EGAS] = F[4]
    comps[EINT] = F[5]
    comps[SCALAR0:] = F[SCALAR0:].unbind(0)
    if opts.n_mscalars > 0:
        comps[SCALAR0:SCALAR0 + opts.n_mscalars] = _cma_fluxes(comps[RHO], sL, sR,
                                                               opts.n_mscalars)
    Fout = torch.stack(comps)
    if eos.is_isothermal:
        Fout[EGAS] = 0.0
        Fout[EINT] = 0.0
    facevel = Fout[RHO] * torch.where(Fout[RHO] >= 0.0, sR.rinv, sL.rinv)
    return Fout, facevel


def _cma_fluxes(mrho, sL: FaceState, sR: FaceState, n_m: int) -> list:
    """The mass scalars' fluxes rescaled to sum to the mass flux `mrho`
    (consistent multi-species advection, Plewa & Muller 1999 eqs 8 and 12;
    `pallas_sweep.py:408-416`): upwind side's mrho s_n / sum of its mass
    scalars, summed in index order as the CUDA kernels sum them."""
    sums = []
    for s in (sL, sR):
        tot = s.scalars[0]
        for k in range(1, n_m):
            tot = tot + s.scalars[k]
        sums.append(tot)
    upwind_is_L = mrho >= 0.0
    return [torch.where(upwind_is_L, mrho * sL.scalars[k] / sums[0],
                        mrho * sR.scalars[k] / sums[1]) for k in range(n_m)]


def _transverse_axis_plain(U, t: int, opts, bc_axis, state_is_cons: bool):
    """(dmin_t, m3_t, chi_t) for one axis t (m3/chi None without PPM
    flattening)."""
    _check_bc(bc_axis)
    n = U.shape[1 + t]
    blk, g = U, 0
    if bc_axis is not None:
        g = 4
        blk = _assemble_wall_ghosts(U, t, *bc_axis, odd_comp=MX1 + t, g=g)
    if state_is_cons:
        blk = euler.cons_to_prim(blk, opts.eos, opts.reconstruct_eint)

    def islice(A):
        return A if g == 0 else A.narrow(t, g, n).contiguous()

    v = blk[PVX1 + t]
    dmin = islice(torch.minimum(sh(v, 1, t) - v, v - sh(v, -1, t)))
    if not (opts.use_flattening and opts.reconstruction_order == 3):
        return dmin, None, None
    chi = reconstruct.flattening_chi(blk, t, opts.eos, opts.reconstruct_eint)
    m3 = torch.minimum(torch.minimum(sh(chi, -1, t), chi), sh(chi, 1, t))
    return dmin, islice(m3), islice(chi)


def outflow_chi_planes(chis: dict, m3s: dict, opts, bc_kinds: dict | None) -> dict:
    """The exact chi_cell of the wall-adjacent ghost on each outflow side
    (`pallas_sweep.py:215-245`): with edge-copied ghosts the along-axis chi
    is 1 at every ghost, so the padded path's value there is chi_d(edge)
    folded with the other axes' 3-point mins at the edge,
    min(chi_d, min over t != d of m3_t), not the edge cell's chi_cell.
    {axis: (lo plane or None, hi plane or None)}, each plane keeping the
    axis with extent 1; only axes with an outflow side."""
    planes = {}
    if bc_kinds is None or not chis:
        return planes
    for d in opts.active_axes:
        bc_axis = bc_kinds.get(d)
        if bc_axis is None or BC_OUTFLOW not in bc_axis:
            continue
        E = None
        for t in opts.active_axes:
            if t != d:
                E = m3s[t] if E is None else torch.minimum(E, m3s[t])
        ghost = chis[d] if E is None else torch.minimum(chis[d], E)
        n = ghost.shape[d]
        planes[d] = tuple(ghost.narrow(d, i, 1).contiguous() if kind == BC_OUTFLOW else None
                          for kind, i in zip(bc_axis, (0, n - 1)))
    return planes


def precompute_transverse_plain(U, opts, bc_kinds: dict | None,
                                state_is_cons: bool = False):
    """Plain version of K1 over all active axes: (dmins, chi_cell,
    chi_ghost) like `pallas_sweep.precompute_transverse_pallas`; chi_ghost
    holds the exact outflow ghost planes (`outflow_chi_planes`)."""
    dmins, chi_cell, chis, m3s = {}, None, {}, {}
    for t in opts.active_axes:
        bc_axis = None if bc_kinds is None else bc_kinds.get(t)
        dmins[t], m3, chi = _transverse_axis_plain(U, t, opts, bc_axis, state_is_cons)
        if m3 is not None:
            chis[t], m3s[t] = chi, m3
            chi_cell = m3 if chi_cell is None else torch.minimum(chi_cell, m3)
    return dmins, chi_cell, outflow_chi_planes(chis, m3s, opts, bc_kinds)


def axis_flux_plain(U, axis: int, opts, chi_cell, dmins: dict,
                    first_order: bool = False, bc_axis=None, dx_axis=None,
                    avg_with: tuple | None = None, state_is_cons: bool = False,
                    emit_avg_flux: bool = False, *, div_only: bool = False,
                    acc: tuple | None = None, fo_mask=None, fo_from=None,
                    corr_mask=None, corr_acc=None, chi_ghost_axis=None):
    """Plain version of K2: one sweep along `axis`. Returns what
    `pallas_sweep.compute_axis_flux_pallas` returns for these arguments:
    (F, v[, F_hi, v_hi][, div, dvel]), or (div, dvel) with `avg_with`, or
    with `emit_avg_flux` (K2d, padded periodic arrays) (div, dvel, F_avg):
    the divergence of the averaged flux, the RAW stage-2 velocity
    divergence and the averaged flux 0.5 (F1 + F2).

    K2c (`div_only`, `pallas_sweep.py:703-718`): only (div, dvel). With
    `fo_mask` (0/1 per cell) every face next to a flagged cell takes the
    first-order (donor-cell + LLF) flux and face velocity of `fo_from`
    (the state itself when None; conserved like `U` with
    `state_is_cons`), as `pallas_sweep._window_flux` (`:543-561`) blends;
    on a wall axis the ghost cells count as unflagged. With `acc` =
    (div_acc, dvel_acc) the contributions are added onto the running totals
    in place, and the totals are returned.

    K2e (`corr_mask`, `pallas_sweep.py:623-633`): also the divergence of
    the boundary-masked flux, corr = (m_lo F_lo - m_hi F_hi) / dx from the
    blended faces, added onto `corr_acc` in place when given; the return
    is then (div, dvel, corr).

    `chi_ghost_axis` = (lo plane, hi plane) (`precompute_transverse`'s
    chi_ghost[axis]): on an outflow side the wall-adjacent ghost's chi_cell
    (`pallas_sweep.py:828-843`, `:963-970`); the other ghosts copy the edge
    cell's, and a dmin ghost on an outflow side is an edge copy."""
    _check_bc(bc_axis)
    _check_chi_ghost(chi_ghost_axis, bc_axis)
    _check_avg_flux(emit_avg_flux, avg_with, bc_axis, dx_axis)
    _check_lean(div_only, acc, fo_mask, fo_from, dx_axis, avg_with)
    _check_corr(corr_mask, corr_acc, div_only, bc_axis)
    vax, wax = _transverse_axes(axis, max(opts.ndim, 1))
    dminv = dmins.get(vax) if (vax in opts.active_axes and not first_order) else None
    dminw = dmins.get(wax) if (wax in opts.active_axes and not first_order) else None
    chi = chi_cell if not first_order else None
    n = U.shape[1 + axis]
    wall = bc_axis is not None

    blk, g = U, 0
    if wall:
        g = 4
        blk = _assemble_wall_ghosts(U, axis, *bc_axis, odd_comp=MX1 + axis, g=g)
        adj = chi_ghost_axis or (None, None)
        chi = None if chi is None else _assemble_wall_ghosts(chi, axis, *bc_axis, None, g,
                                                             *adj)
        dminv = None if dminv is None else _assemble_wall_ghosts(dminv, axis, *bc_axis,
                                                                 None, g)
        dminw = None if dminw is None else _assemble_wall_ghosts(dminw, axis, *bc_axis,
                                                                 None, g)
    if state_is_cons:
        blk = euler.cons_to_prim(blk, opts.eos, opts.reconstruct_eint)
    F, v = _sweep_body(blk, chi, dminv, dminw, axis, opts, first_order)
    if fo_mask is not None:
        fblk = blk
        if fo_from is not None:
            fblk = fo_from
            if wall:
                fblk = _assemble_wall_ghosts(fo_from, axis, *bc_axis, odd_comp=MX1 + axis,
                                             g=g)
            if state_is_cons:
                fblk = euler.cons_to_prim(fblk, opts.eos, opts.reconstruct_eint)
        Ff, vf = _sweep_body(fblk, None, None, None, axis, opts, True)
        del fblk
        mb = fo_mask
        if wall:
            z = torch.zeros_like(mb.narrow(axis, 0, g))
            mb = torch.cat([z, mb, z], dim=axis)
        flag = (sh(mb, -1, axis) > 0) | (mb > 0)
        F = torch.where(flag[None], Ff, F)
        v = torch.where(flag, vf, v)
        del Ff, vf, flag

    Fh = vh = None
    if wall:
        Fh = F.select(1 + axis, g + n).contiguous()
        vh = v.select(axis, g + n).contiguous()
        F = F.narrow(1 + axis, g, n).contiguous()
        v = v.narrow(axis, g, n).contiguous()
    if dx_axis is None:
        return (F, v, Fh, vh) if wall else (F, v)

    Fd, vd, Fhd, vhd = F, v, Fh, vh
    if avg_with is not None:
        Fd = 0.5 * (avg_with[0] + F)
        if not emit_avg_flux:
            vd = 0.5 * (avg_with[1] + v)
        if wall:
            Fhd = 0.5 * (avg_with[2] + Fh)
            vhd = 0.5 * (avg_with[3] + vh)
    F_next = sh(Fd, 1, 1 + axis)
    v_next = sh(vd, 1, axis)
    if wall:
        F_next = torch.cat([Fd.narrow(1 + axis, 1, n - 1), Fhd.unsqueeze(1 + axis)],
                           dim=1 + axis)
        v_next = torch.cat([vd.narrow(axis, 1, n - 1), vhd.unsqueeze(axis)], dim=axis)
    div = (Fd - F_next) / dx_axis
    dvel = (v_next - vd) / dx_axis
    if emit_avg_flux:
        return div, dvel, Fd
    if div_only:
        out = (div, dvel) if acc is None else (acc[0].add_(div), acc[1].add_(dvel))
        if corr_mask is None:
            return out
        dFm = torch.where((corr_mask > 0.5)[None], Fd, 0.0)
        corr = (dFm - sh(dFm, 1, 1 + axis)) / dx_axis
        return out + (corr if corr_acc is None else corr_acc.add_(corr),)
    if avg_with is not None:
        return div, dvel
    return ((F, v, Fh, vh) if wall else (F, v)) + (div, dvel)


def apply_update_plain(U, Ug0, divs: dict, dvels: dict, dt, opts, ng=(0, 0, 0)):
    """Plain version of K3: the RK apply from per-axis divergences + PdV
    source, the pre-floor invalid-cell count, EnforceLimits and
    SyncDualEnergy. Returns (U_finalized, n_invalid as a 0-d tensor). With
    `ng` the stage input Ug0 and the divergences are ghost-padded by `ng`
    and U is the interior (the hybrid ghost-free step)."""
    rhs = _sum_divs(divs)
    dv = _sum_divs(dvels)
    P = euler.pressure(Ug0, opts.eos)
    rhs = rhs.clone()
    rhs[EINT] = rhs[EINT] - P * dv
    U_try = U + dt * interior(rhs, ng)
    n_bad = torch.logical_not(euler.is_state_valid(U_try, opts.eos)).sum()
    return finalize(U_try, opts), n_bad


def _check_chi_ghost(chi_ghost_axis, bc_axis):
    """A chi ghost plane belongs to an outflow side of a wall axis."""
    if chi_ghost_axis is None:
        return
    kinds = bc_axis or (None, None)
    for plane, kind, name in zip(chi_ghost_axis, kinds, ("lo", "hi")):
        if plane is not None and kind != BC_OUTFLOW:
            raise ValueError(f"chi_ghost_axis has a {name} plane on a {kind or 'periodic'} "
                             "side; the planes belong to outflow walls")


def _check_avg_flux(emit_avg_flux, avg_with, bc_axis, dx_axis):
    if emit_avg_flux and (avg_with is None or bc_axis is not None or dx_axis is None):
        raise ValueError("emit_avg_flux (K2d) takes avg_with and dx_axis on a "
                         "periodic (padded) axis")


def _check_lean(div_only, acc, fo_mask, fo_from, dx_axis, avg_with):
    """The K2c arguments' contract (`pallas_sweep.py:786-800`); the
    accumulators and the in-kernel blend are ported for the div-only sweep,
    the one form the lean step runs."""
    if div_only and (dx_axis is None or avg_with is not None):
        raise ValueError("div_only requires dx_axis and excludes avg_with")
    if fo_from is not None and fo_mask is None:
        raise ValueError("fo_from requires fo_mask")
    if not div_only and (acc is not None or fo_mask is not None):
        raise NotImplementedError(
            "acc and fo_mask are ported for the div_only sweep (K2c) only")


def _check_corr(corr_mask, corr_acc, div_only, bc_axis):
    """The K2e arguments' contract (`pallas_sweep.py:811-814`)."""
    if corr_acc is not None and corr_mask is None:
        raise ValueError("corr_acc requires corr_mask")
    if corr_mask is not None and (not div_only or bc_axis is not None):
        raise ValueError("corr_mask (flux-register seeding) requires the div_only "
                         "ghost-free periodic path")


def _sum_divs(divs: dict) -> torch.Tensor:
    """Sum per-axis contributions in sorted-axis order."""
    rhs = None
    for d in sorted(divs):
        rhs = divs[d] if rhs is None else rhs + divs[d]
    return rhs


def finalize(Ux, opts):
    """Floors + dual-energy sync (the end of every RK stage)."""
    eos = opts.eos
    Ux = euler.enforce_limits(Ux, eos, opts.density_floor,
                              opts.temperature_floor, opts.n_scalars)
    if opts.use_dual_energy and not eos.is_isothermal:
        Ux = euler.sync_dual_energy(Ux)
    return Ux


# ------------------------------------------------------------ CUDA wrappers
def _eos_args(opts):
    g = opts.eos.gamma
    return (g, g - 1.0, 1.0 / (g - 1.0), 0.5 * (0.5 * (g + 1.0)),
            int(opts.reconstruct_eint))


# the passive scalar counts the CUDA hydro kernels are instantiated for
# (csrc/sweep_ppm1.cu, sweep_ppm2.cu, sweep_plm1.cu, sweep_plm2.cu, apply.cu)
MAX_KERNEL_SCALARS = 2


def _form_args(opts, first_order: bool):
    """(order, scalars, mass scalars) of K2's template form (csrc/sweep.cuh):
    the reconstruction, 3 PPM or 2 PLM (a first-order sweep skips it, and
    takes the run's form or PPM's), and the scalar counts."""
    order = opts.reconstruction_order
    if not first_order and order not in (2, 3):
        raise NotImplementedError(f"the CUDA sweep reconstructs with PPM (3) or PLM (2), "
                                  f"got reconstruction_order = {order}")
    return (order if order in (2, 3) else 3, opts.n_scalars, opts.n_mscalars)


def _check_kernel_inputs(opts, *tensors):
    if opts.eos.is_isothermal:
        raise NotImplementedError("the CUDA hydro kernels need a gamma-law EOS "
                                  "(the isothermal EOS is not ported to them)")
    if opts.n_scalars > MAX_KERNEL_SCALARS:
        raise NotImplementedError(
            f"the CUDA hydro kernels take at most {MAX_KERNEL_SCALARS} passive scalars, "
            f"got n_scalars = {opts.n_scalars}")
    ref = tensors[0]
    nv = 6 + opts.n_scalars
    if ref.dim() != 4 or ref.shape[0] != nv:
        raise ValueError(
            f"the CUDA hydro kernels take a [6 + n_scalars, X, Y, Z] = [{nv}, X, Y, Z] "
            f"state, got {tuple(ref.shape)}")
    if min(ref.shape[1:]) < 4:
        raise ValueError(f"every extent must be >= 4, got {tuple(ref.shape)}")
    for t in tensors:
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"tensor on {t.device}, expected {ref.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA hydro kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA hydro kernels take contiguous tensors")


def _check_shapes(pairs):
    """Each (tensor or None, expected shape, name) must match."""
    for t, shape, name in pairs:
        if t is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


BC_CODES = {BC_REFLECT: 1, BC_OUTFLOW: 2}  # csrc/common.cuh BC_*; 0 is periodic


def _bc_codes(bc_axis):
    """(lo, hi) codes of csrc/common.cuh: 0 periodic, 1 reflect, 2 outflow."""
    _check_bc(bc_axis)
    return (0, 0) if bc_axis is None else tuple(BC_CODES[k] for k in bc_axis)


K1_THREADS = 256
K1_SMEM_MAX = 48 * 1024  # bytes of shared memory a K1 block takes at most
K1_MARCH_PLANES = 64  # K1's planes a block, at most


def _split(n: int, most: int) -> int:
    """The smallest tile extent that covers n in as few tiles of at most
    `most` cells as possible."""
    return -(-n // -(-n // most))


def k1_tile(X: int, Y: int, Z: int) -> Tuple[int, int, int]:
    """K1's tile for extents (X, Y, Z): (SX, TY, TZ), SX planes of TY x TZ
    columns a block, at most K1_THREADS columns (TY at most 64, so that a
    plane's halo of 6 (TY + TZ) cells is at most two a thread)."""
    tz = _split(Z, 32)
    return _split(X, K1_MARCH_PLANES), _split(Y, min(64, K1_THREADS // tz)), tz


def k1_smem_bytes(tile) -> int:
    """Shared-memory bytes of a K1 block (`k1_smem_bytes` of
    csrc/transverse.cu): two buffers of a plane's y and z stencils [3][(TY +
    6) TZ], [3][TY (TZ + 6)] and their chi [(TY + 2) TZ], [TY (TZ + 2)]."""
    _, ty, tz = tile
    return 8 * (3 * (ty + 6) * tz + 3 * ty * (tz + 6) + (ty + 2) * tz + ty * (tz + 2))


def _transverse_cuda(U5, opts, bc_kinds: dict | None, state_is_cons: bool):
    """K1 over all active axes of a batch [B, 6, X, Y, Z] in one launch:
    (dmins, chi_cell, chi_ghost), dmins[t] [B, X, Y, Z], chi_cell the min
    over axes of each axis's 3-point min of chi, folded in the kernel (None
    without PPM flattening), and chi_ghost the outflow sides' planes
    [B, ...] (`outflow_chi_planes`), written by the kernel too."""
    from .._cuda import check, library

    lib = library()
    if U5.dim() != 5:
        raise ValueError(f"expected [B, 6, X, Y, Z] states, got {tuple(U5.shape)}")
    _check_kernel_inputs(opts, U5[0], U5)
    B, _, X, Y, Z = U5.shape
    if B > 1 and opts.n_scalars > 0:
        # K1 reads components 0-5 and strides a batch by 6 components: a
        # batch of states with scalars (the packed AMR engine's chunks) is
        # not ported
        raise NotImplementedError("K1 over a batch of states with passive scalars")
    axes = tuple(opts.active_axes)
    do_chi = opts.use_flattening and opts.reconstruction_order == 3
    dmin = torch.empty((len(axes), B, X, Y, Z), dtype=U5.dtype, device=U5.device)
    chi = torch.empty((B, X, Y, Z), dtype=U5.dtype, device=U5.device) if do_chi else None
    ptrs, mask, walls = [None] * 3, 0, 0
    planes, plane_ptrs = {}, [None] * 6
    for i, t in enumerate(axes):
        bc_axis = None if bc_kinds is None else bc_kinds.get(t)
        lo, hi = _bc_codes(bc_axis)
        ptrs[t] = dmin[i].data_ptr()
        mask |= 1 << t
        walls |= lo << (4 * t) | hi << (4 * t + 2)
        if do_chi and bc_axis is not None and BC_OUTFLOW in bc_axis:
            shape = [B, X, Y, Z]
            shape[1 + t] = 1
            planes[t] = tuple(torch.empty(shape, dtype=U5.dtype, device=U5.device)
                              if k == BC_OUTFLOW else None for k in bc_axis)
            plane_ptrs[2 * t:2 * t + 2] = map(_ptr, planes[t])
    err = lib.qk_transverse(U5.data_ptr(), *ptrs, _ptr(chi), *plane_ptrs, X, Y, Z, B, mask,
                            walls, int(state_is_cons), int(do_chi), *_eos_args(opts),
                            *k1_tile(X, Y, Z), _stream(U5))
    check(err, "transverse")
    launch_counts["transverse"] += 1
    return {t: dmin[i] for i, t in enumerate(axes)}, chi, planes


def precompute_transverse_batched(U5, opts, bc_kinds: dict | None,
                                  state_is_cons: bool = False):
    """K1 over a batch of states [B, 6, X, Y, Z]: (dmins [B, X, Y, Z] by
    axis, chi_cell [B, X, Y, Z] or None); one launch on the card, the plain
    version block by block on the CPU."""
    if _on_cuda(U5):
        return _transverse_cuda(U5, opts, bc_kinds, state_is_cons)[:2]
    return precompute_transverse_batched_plain(U5, opts, bc_kinds, state_is_cons)


def precompute_transverse_batched_plain(U5, opts, bc_kinds: dict | None,
                                        state_is_cons: bool = False):
    """The plain version of `precompute_transverse_batched`, block by block."""
    fields = [precompute_transverse_plain(u, opts, bc_kinds, state_is_cons)[:2] for u in U5]
    dmins = {t: torch.stack([f[0][t] for f in fields]) for t in fields[0][0]}
    return dmins, None if fields[0][1] is None else torch.stack([f[1] for f in fields])


def precompute_transverse(U, opts, bc_kinds: dict | None,
                          state_is_cons: bool = False):
    """K1 over all active axes (`pallas_sweep.precompute_transverse_pallas`):
    returns (dmins, chi_cell, chi_ghost); chi_cell = min over axes of each
    axis's 3-point min of chi, chi_ghost {axis: (lo, hi)} the exact outflow
    ghost planes (`outflow_chi_planes`)."""
    if not _on_cuda(U):
        return precompute_transverse_plain(U, opts, bc_kinds, state_is_cons)
    dmins, chi_cell, planes = _transverse_cuda(U[None], opts, bc_kinds, state_is_cons)
    return ({t: m[0] for t, m in dmins.items()}, _unbatch(chi_cell),
            {t: tuple(map(_unbatch, pl)) for t, pl in planes.items()})


def compute_axis_flux(U, axis: int, opts, chi_cell, dmins: dict,
                      first_order: bool = False, bc_axis=None,
                      chi_ghost_axis=None, dx_axis=None,
                      avg_with: tuple | None = None,
                      state_is_cons: bool = False, *, acc=None,
                      div_only=False, fo_mask=None, fo_from=None,
                      emit_avg_flux=False, corr_mask=None, corr_acc=None):
    """K2: one sweep along `axis` (`pallas_sweep.compute_axis_flux_pallas`
    for the variants of the unigrid and AMR paths). Returns (F, v[, F_hi,
    v_hi][, div, dvel]), or (div, dvel) with `avg_with`, or (div, dvel,
    F_avg) with `emit_avg_flux` (K2d), or (div, dvel) with `div_only` (K2c;
    with `acc` the accumulator tensors, updated in place), or (div, dvel,
    corr) with `corr_mask` (K2e): `axis_flux_plain` says what each
    holds, and what `chi_ghost_axis` (the outflow sides' chi planes) is."""
    _check_bc(bc_axis)
    _check_chi_ghost(chi_ghost_axis, bc_axis)
    _check_avg_flux(emit_avg_flux, avg_with, bc_axis, dx_axis)
    _check_lean(div_only, acc, fo_mask, fo_from, dx_axis, avg_with)
    _check_corr(corr_mask, corr_acc, div_only, bc_axis)
    if not _on_cuda(U):
        return axis_flux_plain(U, axis, opts, chi_cell, dmins, first_order,
                               bc_axis, dx_axis, avg_with, state_is_cons,
                               emit_avg_flux, div_only=div_only, acc=acc,
                               fo_mask=fo_mask, fo_from=fo_from,
                               corr_mask=corr_mask, corr_acc=corr_acc,
                               chi_ghost_axis=chi_ghost_axis)
    from .._cuda import library

    lib = library()
    vax, wax = _transverse_axes(axis, max(opts.ndim, 1))
    dminv = dmins.get(vax) if (vax in opts.active_axes and not first_order) else None
    dminw = dmins.get(wax) if (wax in opts.active_axes and not first_order) else None
    chi = chi_cell if not first_order else None
    planes = (None, None) if chi is None or chi_ghost_axis is None else tuple(chi_ghost_axis)
    if div_only:
        return _axis_flux_lean_cuda(lib, U, axis, opts, chi, dminv, dminw, first_order,
                                    bc_axis, dx_axis, state_is_cons, acc, fo_mask,
                                    fo_from, corr_mask, corr_acc, planes)
    if dx_axis is None:
        F, v, Fh, vh = map(_unbatch, _axis_faces_cuda(
            lib, U[None], axis, opts, _batch(chi), _batch(dminv), _batch(dminw), bc_axis,
            state_is_cons, first_order, planes))
        launch_counts["axis_flux"] += 1
        return (F, v) if bc_axis is None else (F, v, Fh, vh)
    return _axis_sweep_cuda(lib, U, axis, opts, chi, dminv, dminw, first_order, bc_axis,
                            dx_axis, avg_with, state_is_cons, emit_avg_flux, planes)


def _plane_args(planes, U, axis: int):
    """The (lo, hi) chi plane pointers of an outflow wall axis of the state
    U [.., 6, X, Y, Z], each plane checked to be a contiguous float32 tensor
    on U's device with the cells of the plane across `axis` (the axis kept
    with extent 1, or dropped)."""
    shape = list(U.shape[-3:])
    shape[axis] = 1
    for pl in planes:
        if pl is None:
            continue
        if (pl.numel() != shape[0] * shape[1] * shape[2] or pl.dtype != torch.float32
                or not pl.is_contiguous() or pl.device != U.device):
            raise ValueError(f"a chi ghost plane must be a contiguous float32 "
                             f"{tuple(shape)} on {U.device}, got {tuple(pl.shape)} "
                             f"{pl.dtype} on {pl.device}")
    return tuple(map(_ptr, planes))


def _batch(t):
    return None if t is None else t[None]


def _unbatch(t):
    return None if t is None else t[0]


def _face_tile(n_faces: int, n_across: int, nv: int = 6) -> Tuple[int, int]:
    """(faces along the axis, lines across) of one tile of K2's face kernel
    (``csrc/sweep.cu`` `face_tile_kernel`) for a state of `nv` components:
    at most 40 faces along, split evenly (a packed block's line of 28 or 36
    faces is one tile), and as many lines as keep a tile at or below 512
    faces (two a thread) and its shared memory (`face_smem_bytes`) at or
    below LEAN_SMEM_MAX, split evenly across."""
    ta = -(-n_faces // -(-n_faces // 40))
    fit = LEAN_SMEM_MAX // face_smem_bytes((ta, 1), nv)
    tw = max(1, min(n_across, 512 // ta, fit))
    return ta, -(-n_across // -(-n_across // tw))


def face_smem_bytes(tile, nv: int = 6) -> int:
    """Shared-memory bytes of a face-kernel block (`face_smem_bytes` of
    csrc/sweep.cuh): the staged primitives [nv][(ta + 5) tw], the face
    states and dmins [2 nv + 2][(ta + 1) tw]."""
    ta, tw = tile
    return 4 * (nv * (ta + 5) * tw + (2 * nv + 2) * (ta + 1) * tw)


def _axis_faces_cuda(lib, U5, axis: int, opts, chi, dminv, dminw, bc_axis,
                     state_is_cons: bool, first_order: bool, planes=(None, None)):
    """Launch K2's face mode along `axis` over a batch [B, 6, X, Y, Z] (B = 1
    for one state; the per-cell fields [B, X, Y, Z]): (F [B, 6, X, Y, Z],
    v [B, X, Y, Z], F_hi, v_hi), the last two the wall's extra high faces
    [B, 6, plane] / [B, plane] on a wall axis (one state only), else None;
    `planes`: the outflow sides' chi planes (one state only). The caller
    counts the launch."""
    from .._cuda import check

    if U5.dim() != 5:
        raise ValueError(f"expected [B, 6, X, Y, Z] states, got {tuple(U5.shape)}")
    _check_kernel_inputs(opts, U5[0], U5, chi, dminv, dminw)
    B, nv, X, Y, Z = U5.shape
    cell = (B, X, Y, Z)
    _check_shapes([(chi, cell, "chi_cell"), (dminv, cell, "dmin"), (dminw, cell, "dmin")])
    lo, hi = _bc_codes(bc_axis)
    wall = bc_axis is not None
    if (wall or planes != (None, None)) and B != 1:
        raise ValueError("a wall axis takes one state, not a batch")
    plane = tuple(s for a, s in enumerate((X, Y, Z)) if a != axis)
    F = torch.empty_like(U5)
    v = torch.empty(cell, dtype=U5.dtype, device=U5.device)
    Fh = torch.empty((B, nv) + plane, dtype=U5.dtype, device=U5.device) if wall else None
    vh = torch.empty((B,) + plane, dtype=U5.dtype, device=U5.device) if wall else None
    if X * Y * Z >= 2**31 or B > 65535:
        raise ValueError("the CUDA face kernel takes < 2^31 cells a block and <= 65535 blocks")
    n_faces = (X, Y, Z)[axis] + (1 if wall else 0)
    ta, tw = _face_tile(n_faces, Y if axis == 2 else Z, nv)
    err = lib.qk_axis_flux(U5.data_ptr(), _ptr(chi), *_plane_args(planes, U5, axis),
                           _ptr(dminv), _ptr(dminw),
                           F.data_ptr(), v.data_ptr(), _ptr(Fh), _ptr(vh),
                           X, Y, Z, B, axis, lo, hi, int(state_is_cons),
                           int(first_order), float(opts.K_visc), ta, tw, *_eos_args(opts),
                           *_form_args(opts, first_order), _stream(U5))
    check(err, "axis_flux")
    return F, v, Fh, vh


LEAN_SMEM_MAX = 56 * 1024  # bytes of shared memory a K2c block takes at most
LEAN_ALONG = 40  # cells of a K2c tile along the axis, at most
LEAN_FACES = 512  # faces of a K2c tile, at most (two a thread)


def lean_tile(n_cells: int, n_across: int, nv: int = 6) -> Tuple[int, int]:
    """(cells along the axis, lines across) of one tile of K2c
    (``csrc/sweep.cu`` `lean_tile_kernel`) for a state of `nv` components:
    at most LEAN_ALONG cells along, split evenly, and as many lines as keep
    the tile's ta + 1 faces at or below LEAN_FACES and its shared memory
    (`lean_smem_bytes`) at or below LEAN_SMEM_MAX, split evenly across."""
    ta = _split(n_cells, LEAN_ALONG)
    fit = LEAN_SMEM_MAX // lean_smem_bytes((ta, 1), nv)
    return ta, _split(n_across, max(1, min(n_across, LEAN_FACES // (ta + 1), fit)))


def lean_smem_bytes(tile, nv: int = 6) -> int:
    """Shared-memory bytes of a K2c block (`qk_lean_smem`) for a state of
    `nv` components: the face kernel's staged primitives [nv][(ta + 6) tw],
    face states and dmins [2 nv + 2][(ta + 2) tw], and the faces' fluxes
    and velocities [nv + 1][(ta + 1) tw]."""
    ta, tw = tile
    return 4 * (nv * (ta + 6) * tw + (2 * nv + 2) * (ta + 2) * tw + (nv + 1) * (ta + 1) * tw)


def _axis_flux_lean_cuda(lib, U, axis: int, opts, chi, dminv, dminw, first_order,
                         bc_axis, dx_axis, state_is_cons, acc, fo_mask, fo_from,
                         corr_mask=None, corr_acc=None, planes=(None, None)):
    """Launch K2c (csrc/sweep.cu `lean_tile_kernel`): a block stages and
    reconstructs a tile of `lean_tile` cells by lines, solves each face
    those cells touch once into shared memory (LLF next to a flagged cell of
    `fo_mask`), and writes only (div, dvel) a cell, or adds them onto `acc`
    in place; with `corr_mask` (K2e) also the register seed corr, or adds it
    onto `corr_acc` in place. No face array reaches device memory, and every
    offset is 64-bit, so any extent >= 4 is taken."""
    from .._cuda import check

    accs = tuple(acc) if acc is not None else ()
    _check_kernel_inputs(opts, U, chi, dminv, dminw, fo_mask, fo_from, corr_mask,
                         corr_acc, *accs)
    X, Y, Z = U.shape[1:]
    cell = (X, Y, Z)
    _check_shapes([(chi, cell, "chi_cell"), (dminv, cell, "dmin"), (dminw, cell, "dmin"),
                   (fo_mask, cell, "fo_mask"), (fo_from, U.shape, "fo_from"),
                   (corr_mask, cell, "corr_mask"), (corr_acc, U.shape, "corr_acc")]
                  + list(zip(accs, (U.shape, cell), ("acc div", "acc dvel"))))
    lo, hi = _bc_codes(bc_axis)
    if acc is None:
        div = torch.empty_like(U)
        dvel = torch.empty(cell, dtype=U.dtype, device=U.device)
    else:
        div, dvel = acc
    corr = None
    if corr_mask is not None:
        corr = torch.empty_like(U) if corr_acc is None else corr_acc
    err = lib.qk_axis_lean(U.data_ptr(), _ptr(chi), *_plane_args(planes, U, axis),
                           _ptr(dminv), _ptr(dminw),
                           _ptr(fo_mask), _ptr(fo_from), div.data_ptr(), dvel.data_ptr(),
                           _ptr(corr_mask), _ptr(corr), X, Y, Z, axis, lo, hi,
                           int(state_is_cons), int(first_order),
                           float(opts.K_visc), float(dx_axis), int(acc is not None),
                           int(corr_acc is not None),
                           *lean_tile((X, Y, Z)[axis], Y if axis == 2 else Z, U.shape[0]),
                           *_eos_args(opts), *_form_args(opts, first_order), _stream(U))
    check(err, "axis_flux_lean")
    if corr is None:
        launch_counts["axis_flux_lean"] += 1
        return div, dvel
    launch_counts["axis_flux_corr"] += 1
    return div, dvel, corr


SWEEP_ALONG = 29  # cells of an x or y sweep's tile along the axis, at most
SWEEP_LINES = 16  # lines of an x or y sweep's tile across it, at most


def sweep_tile(n_cells: int, n_across: int, axis: int, nv: int = 6) -> Tuple[int, int]:
    """(cells along the axis, lines across) of one tile of K2's sweeps with
    a divergence (``csrc/sweep.cu`` `sweep_tile_kernel`: stage 1, stage 2,
    K2d) for a state of `nv` components, which share K2c's shared-memory
    layout (`lean_smem_bytes`). The z sweep's faces run along z, the
    contiguous axis, and it takes K2c's tile (`lean_tile`). The x and y
    sweeps store and read their faces in rows of the tile's lines along z:
    they take up to SWEEP_LINES lines (rows of 64 B) and up to SWEEP_ALONG
    cells along, the most that keeps four blocks a multiprocessor at nv =
    6; with scalars fewer cells along, as many as keep SWEEP_LINES lines
    within LEAN_SMEM_MAX; each split evenly."""
    if axis == 2:
        return lean_tile(n_cells, n_across, nv)
    along = SWEEP_ALONG
    while along > 1 and lean_smem_bytes((along, SWEEP_LINES), nv) > LEAN_SMEM_MAX:
        along -= 1
    return _split(n_cells, along), _split(n_across, SWEEP_LINES)


def _axis_sweep_cuda(lib, U, axis: int, opts, chi, dminv, dminw, first_order, bc_axis,
                     dx_axis, avg_with, state_is_cons, emit_avg_flux, planes=(None, None)):
    """Launch K2's sweep with a divergence (csrc/sweep.cu
    `sweep_tile_kernel`): a block stages and reconstructs a tile of
    `sweep_tile` cells by lines and solves each face those cells touch once
    into shared memory. Stage 1 (no `avg_with`) writes the faces (F, v[,
    F_hi, v_hi]) beside (div, dvel); stage 2 reads stage 1's faces, averages
    in shared memory and writes only (div, dvel), and with `emit_avg_flux`
    (K2d, no stage-1 velocity read) also the averaged flux. Every offset is
    64-bit."""
    from .._cuda import check

    avg = tuple(avg_with) if avg_with is not None else ()
    _check_kernel_inputs(opts, U, chi, dminv, dminw, *avg)
    wall = bc_axis is not None
    X, Y, Z = U.shape[1:]
    cell = (X, Y, Z)
    plane = tuple(s for a, s in enumerate(cell) if a != axis)
    nv = U.shape[0]
    _check_shapes([(chi, cell, "chi_cell"), (dminv, cell, "dmin"), (dminw, cell, "dmin")]
                  + list(zip(avg, (U.shape, cell, (nv,) + plane, plane),
                             ("avg flux", "avg facevel", "avg flux_hi", "avg vel_hi"))))
    if avg_with is not None and len(avg) != (4 if wall else 2):
        raise ValueError("avg_with holds (F, v) on a periodic axis, "
                         "(F, v, F_hi, v_hi) on a wall axis")
    lo, hi = _bc_codes(bc_axis)
    div = torch.empty_like(U)
    dvel = torch.empty(cell, dtype=U.dtype, device=U.device)
    faces = (None,) * 4
    if avg_with is None:
        faces = (torch.empty_like(U), torch.empty(cell, dtype=U.dtype, device=U.device),
                 torch.empty((nv,) + plane, dtype=U.dtype, device=U.device) if wall else None,
                 torch.empty(plane, dtype=U.dtype, device=U.device) if wall else None)
    F1, v1, F1h, v1h = (avg + (None,) * 4)[:4]
    if emit_avg_flux:
        v1 = None  # K2d: dvel stays the raw stage-2 velocity divergence
    favg = torch.empty_like(U) if emit_avg_flux else None
    err = lib.qk_axis_sweep(U.data_ptr(), _ptr(chi), *_plane_args(planes, U, axis),
                            _ptr(dminv), _ptr(dminw),
                            div.data_ptr(), dvel.data_ptr(), *map(_ptr, faces),
                            _ptr(F1), _ptr(v1), _ptr(F1h), _ptr(v1h), _ptr(favg), X, Y, Z,
                            axis, lo, hi, int(state_is_cons), int(first_order),
                            float(opts.K_visc), float(dx_axis),
                            *sweep_tile(cell[axis], Y if axis == 2 else Z, axis, nv),
                            *_eos_args(opts), *_form_args(opts, first_order), _stream(U))
    check(err, "axis_sweep")
    launch_counts["axis_flux_avg" if emit_avg_flux else "axis_flux"] += 1
    if emit_avg_flux:
        return div, dvel, favg
    if avg_with is not None:
        return div, dvel
    return faces[:4 if wall else 2] + (div, dvel)


def apply_update(U, Ug0, divs: dict, dvels: dict, dt, opts, ng=(0, 0, 0)):
    """K3 (`pallas_sweep.apply_update_pallas`): returns (U_finalized,
    n_invalid) with n_invalid a 0-d integer tensor counting the cells whose
    raw update was invalid before the floors. `dt` may be a float or a
    one-element tensor on the state's device. With `ng` the stage input Ug0
    and the divergences are ghost-padded by `ng` (the hybrid ghost-free
    step, a hook-filled axis padded) and U is the interior: the kernel reads
    an x-padded block where it lies, and a block padded along y or z from
    a contiguous copy of its interior."""
    if not _on_cuda(U):
        return apply_update_plain(U, Ug0, divs, dvels, dt, opts, ng)
    from .._cuda import check, library

    lib = library()
    axes = sorted(divs)
    if axes != [0, 1, 2] or sorted(dvels) != axes:
        raise NotImplementedError("the CUDA apply kernel takes three axes")
    ins = [Ug0] + [divs[d] for d in axes] + [dvels[d] for d in axes]
    if any(ng[1:]):
        ins = [interior(t, ng).contiguous() for t in ins]
        ng = (0, 0, 0)
    Ug0, dlist, vlist = ins[0], ins[1:4], ins[4:]
    _check_kernel_inputs(opts, U, *ins)
    nv, X, Y, Z = U.shape
    padded = (X + 2 * ng[0], Y, Z)
    _check_shapes([(Ug0, (nv,) + padded, "Ug0")]
                  + [(t, (nv,) + padded, "div") for t in dlist]
                  + [(t, padded, "dvel") for t in vlist])
    dt_t = torch.as_tensor(dt, dtype=U.dtype, device=U.device).reshape(1)
    out = torch.empty_like(U)
    n_bad = torch.zeros(1, dtype=torch.int32, device=U.device)
    ncell = U[0].numel()
    err = lib.qk_apply(U.data_ptr(), Ug0.data_ptr(), *(t.data_ptr() for t in dlist),
                       *(t.data_ptr() for t in vlist),
                       dt_t.data_ptr(), out.data_ptr(), n_bad.data_ptr(),
                       ncell, Ug0[0].numel(), ng[0] * Y * Z, float(opts.density_floor),
                       float(opts.temperature_floor), float(opts.eos.c_v)
                       if opts.temperature_floor > 0.0 else 0.0,
                       opts.eos.gamma - 1.0,
                       int(opts.use_dual_energy), opts.n_scalars, _stream(U))
    check(err, "apply_update")
    launch_counts["apply_update"] += 1
    return out, n_bad.reshape(())


# ------------------------------------------------------ all-axis sweeps
def compute_fluxes_pallas_div(Ug, opts, bc_kinds: dict | None = None,
                              avg_with: dict | None = None, *, accumulate=False,
                              div_only=False, fo_mask=None, fo_from=None,
                              acc_init=None, corr_masks=None,
                              corr_init=None) -> dict:
    """Sweep all axes once from the CONSERVED state, emitting fluxes and
    their divergences (`pallas_sweep.compute_fluxes_pallas_div`). Returns
    a dict with ``fluxes``, ``facevels``, ``flux_hi``, ``vel_hi``, ``divs``,
    ``dvels``; with ``avg_with`` (stage 2, the stage-1 dict) the divs hold
    the divergence of the time-averaged flux and the face dicts are empty.
    The padded AMR levels sweep through `hydro.advance._padded_sweeps`
    instead, which also drives K2d.

    ``div_only`` (the lean step, K2c): no face array at all; with
    ``accumulate`` the per-axis contributions are chained through the
    kernels' accumulators in axis order, starting from ``acc_init`` (whose
    tensors are updated in place) when given, and the dict carries the
    totals ``div`` and ``dvel`` instead of ``divs``/``dvels``. ``fo_mask``
    and ``fo_from`` reach every axis's sweep (the in-kernel FOFC blend).
    ``corr_masks`` ({axis: boundary-face mask}, K2e, with `accumulate`)
    chains the register seed over the axes from ``corr_init`` (updated in
    place when given) into ``corr``."""
    if corr_masks is not None and not (div_only and accumulate):
        raise ValueError("corr_masks requires div_only + accumulate")
    if corr_init is not None and corr_masks is None:
        raise ValueError("corr_init requires corr_masks")
    lean_args = (accumulate, acc_init is not None, fo_mask is not None, fo_from is not None)
    if any(lean_args) and not div_only:
        raise NotImplementedError("accumulate, acc_init, fo_mask and fo_from are ported "
                                  "for the div_only sweep (K2c) only")
    if acc_init is not None and not accumulate:
        raise ValueError("acc_init requires accumulate")
    if div_only and avg_with is not None:
        raise ValueError("div_only excludes avg_with")
    dmins, chi_cell, chi_ghost = precompute_transverse(Ug, opts, bc_kinds,
                                                       state_is_cons=True)
    out = {"fluxes": {}, "facevels": {}, "flux_hi": {}, "vel_hi": {},
           "divs": {}, "dvels": {}}
    if div_only:
        acc, corr = acc_init, corr_init
        for d in opts.active_axes:
            bc_axis = None if bc_kinds is None else bc_kinds.get(d)
            res = compute_axis_flux(Ug, d, opts, chi_cell, dmins, bc_axis=bc_axis,
                                    chi_ghost_axis=chi_ghost.get(d),
                                    dx_axis=opts.dx[d], state_is_cons=True,
                                    acc=acc if accumulate else None, div_only=True,
                                    fo_mask=fo_mask, fo_from=fo_from,
                                    corr_mask=None if corr_masks is None else corr_masks[d],
                                    corr_acc=corr)
            if corr_masks is not None:
                acc, corr = res[:2], res[2]
            elif accumulate:
                acc = res
            else:
                out["divs"][d], out["dvels"][d] = res
        if accumulate:
            out["div"], out["dvel"] = acc
        if corr_masks is not None:
            out["corr"] = corr
        return out
    for d in opts.active_axes:
        bc_axis = None if bc_kinds is None else bc_kinds.get(d)
        avg_axis = None
        if avg_with is not None:
            avg_axis = (avg_with["fluxes"][d], avg_with["facevels"][d])
            if bc_axis is not None:
                avg_axis += (avg_with["flux_hi"][d], avg_with["vel_hi"][d])
        res = compute_axis_flux(Ug, d, opts, chi_cell, dmins, False,
                                bc_axis=bc_axis, chi_ghost_axis=chi_ghost.get(d),
                                dx_axis=opts.dx[d], avg_with=avg_axis,
                                state_is_cons=True)
        if avg_axis is not None:
            out["divs"][d], out["dvels"][d] = res
            continue
        if bc_axis is None:
            F, v, dv, dl = res
        else:
            F, v, Fh, vh, dv, dl = res
            out["flux_hi"][d] = Fh
            out["vel_hi"][d] = vh
        out["fluxes"][d] = F
        out["facevels"][d] = v
        out["divs"][d] = dv
        out["dvels"][d] = dl
    return out


def compute_fluxes_pallas(Ug, opts, first_order: bool = False,
                          bc_kinds: dict | None = None, *, plain: bool = False):
    """All-axis face fluxes of the conserved state with cons->prim outside
    the kernels (`pallas_sweep.compute_fluxes_pallas`). With `bc_kinds`
    returns (fluxes, facevels, flux_hi, vel_hi), else (fluxes, facevels).
    `plain`: the plain versions on the state's own device (the JAX
    package's XLA fluxes of a non-f32 state)."""
    prim = euler.cons_to_prim(Ug, opts.eos, opts.reconstruct_eint)
    transverse = precompute_transverse_plain if plain else precompute_transverse
    axis_flux = axis_flux_plain if plain else compute_axis_flux
    if first_order:
        dmins, chi_cell, chi_ghost = {}, None, {}
    else:
        dmins, chi_cell, chi_ghost = transverse(prim, opts, bc_kinds)
    fluxes, facevels, flux_hi, vel_hi = {}, {}, {}, {}
    for d in opts.active_axes:
        bc_axis = None if bc_kinds is None else bc_kinds.get(d)
        res = axis_flux(prim, d, opts, chi_cell, dmins, first_order,
                        bc_axis=bc_axis, chi_ghost_axis=chi_ghost.get(d))
        fluxes[d], facevels[d] = res[0], res[1]
        if bc_axis is not None:
            flux_hi[d], vel_hi[d] = res[2], res[3]
    if bc_kinds is None:
        return fluxes, facevels
    return fluxes, facevels, flux_hi, vel_hi


def compute_fluxes_batched(Ug5, opts, first_order: bool = False):
    """All-axis face fluxes of a chunk of ghost-padded conserved blocks
    [B, 6, X, Y, Z] (roll semantics per block): ({axis: F [B, 6, X, Y, Z]},
    {axis: v [B, X, Y, Z]}), what `compute_fluxes_pallas` gives block by
    block (the JAX packed engine vmaps `compute_fluxes` over the chunk).

    On a CUDA f32 tensor K1 and K2's face mode run over the whole chunk,
    one launch an axis, with the conserved-to-primitive step in registers
    (`state_is_cons`); on the CPU, or for another dtype (the JAX package's
    XLA fluxes), the plain versions run block by block."""
    if not _on_cuda(Ug5) or Ug5.dtype != torch.float32:
        fl, fv = {}, {}
        for blk in Ug5:
            f1, v1 = compute_fluxes_pallas(blk, opts, first_order, plain=True)
            for d in f1:
                fl.setdefault(d, []).append(f1[d])
                fv.setdefault(d, []).append(v1[d])
        return ({d: torch.stack(x) for d, x in fl.items()},
                {d: torch.stack(x) for d, x in fv.items()})
    from .._cuda import library

    lib = library()
    dmins, chi_cell = ({}, None) if first_order else _transverse_cuda(Ug5, opts, None,
                                                                        True)[:2]
    fl, fv = {}, {}
    for d in opts.active_axes:
        vax, wax = _transverse_axes(d, max(opts.ndim, 1))
        fl[d], fv[d], _, _ = _axis_faces_cuda(lib, Ug5, d, opts, chi_cell, dmins.get(vax),
                                              dmins.get(wax), None, True, first_order)
        launch_counts["axis_flux"] += 1
    return fl, fv
