"""Hierarchy integration of the packed tile-pool engine.

Counterpart of `quokka_tpu.amr.packed_driver` (``:36-694``): `AMRSimulation`
dispatches here for pool levels (`amr.sparse_min_level`, `amr.pool_packed
= 1`). A packed level stores its state split, the hydro rows `Uh` and the
radiation rows `Ur`, so the hydro advance never touches the radiation
rows and the other way round; every cross-tile access is a K9 row gather.

Topology (as the JAX package's): `amr.sparse_min_level = 1` with up to two
packed levels, level 1's parent the dense root, level 2's the packed
level 1 (the reference benchmark). Packed substeps do not stash a pre-step
copy, so a failed coarse step aborts instead of retrying.

Every pass over a level runs chunk by chunk (`sim.packed_chunk` tiles):
the regrid build, the octant tags, the average-downs, the sums and the
signal speed.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..hydro import euler
from . import operators as ops
from . import packed as pk
from . import tilepool as tp
from .pool_advance import reflux_pool_parent
from .sparse import PoolState, stream_pool_build


def _live_chunks(meta, chunk):
    return range(0, -(-meta.n_active // chunk) * chunk, chunk)


def _split_parts(sim):
    nh = sim.layout.nvar_hydro
    return nh, sim.layout.nvar - nh


# --------------------------------------------------------------- regrid build
def build_packed_level(sim, l: int, meta: tp.TileMeta, old_st) -> PoolState:
    """Build (or regrid) packed level l+1 from its parent level l: the
    limited-linear prolongation of the parent, chunk by chunk, the tiles
    that persist keeping their old data. The hydro and radiation parts are
    built one after the other (`quokka_tpu/amr/packed_driver.py:62-200`)."""
    ts = sim.tile_shape
    g = sim._g
    active = sim.grid.active_axes
    nh, nr = _split_parts(sim)
    chunk = min(sim.packed_chunk, meta.capacity)
    cap = meta.capacity
    dev, dtype = sim.device, sim.dtype

    remap = None
    if old_st is not None and old_st.meta.n_active:
        rm = np.full(cap, -1, np.int32)
        for t, s in meta.slot_of.items():
            rm[s] = old_st.meta.slot_of.get(t, -1)
        remap = torch.as_tensor(rm, device=dev)

    if sim._is_pool(l):
        stp = sim.level_pool[l]
        if sim._is_pool(l - 1):
            raise NotImplementedError("packed prolongation needs a dense grandparent")
        gp_pad = sim._fill_level0(sim.level_U[l - 1])
        ps, po = tp.parent_linkage(meta, stp.meta, dev)
        gp2 = pk.donor_pad_width(g)  # the parent tiles' pad, the donors' width

        def make_produce(Up, nv_part, gp):
            def produce(ps_c, po_c):
                rows = torch.clamp(ps_c, min=0)
                out = pk.pool_parent_blocks(Up, gp, rows, stp.meta.nbr_dev,
                                            stp.meta.origin_dev, g, ts, active, gp_width=g)
                loc = torch.arange(ps_c.shape[0], dtype=torch.int32, device=dev)
                return tp.make_backdrop_from_pool(out, loc, po_c, ts, 0, gp2, active)
            return produce

        per_chunk = (ps, po)
        parts = []
        for Up, nv_part, c0 in ((stp.Uh, nh, 0), (stp.Ur, nr, nh)):
            if Up is None:
                parts.append(None)
                continue
            old = None if remap is None else (old_st.Uh if c0 == 0 else old_st.Ur)
            parts.append(stream_pool_build(
                make_produce(Up, nv_part, gp_pad[c0:c0 + nv_part].contiguous()), per_chunk,
                cap, chunk, meta.n_active, (nv_part,) + tuple(ts), dtype, dev, old, remap))
    else:
        pp = sim._fill_level0(sim.level_U[l])
        ps = po = None
        hc = 1
        sizes = tuple(t // 2 + 2 * hc for t in ts)

        def make_produce(nv_part, c0):
            src = pp[c0:c0 + nv_part].contiguous()[None]

            def produce(o_c):
                o = o_c.to(torch.int64)
                starts = torch.cat([torch.zeros_like(o[:, :1]), o // 2 - hc + g], dim=1)
                fine = ops.prolong(tp._donor_blocks(src, starts, sizes), active)
                return fine[(slice(None), slice(None)) + (slice(2, -2),) * 3]
            return produce

        parts = []
        for nv_part, c0 in ((nh, 0), (nr, nh)):
            if nv_part == 0:
                parts.append(None)
                continue
            old = None if remap is None else (old_st.Uh if c0 == 0 else old_st.Ur)
            parts.append(stream_pool_build(
                make_produce(nv_part, c0), (meta.origin_dev,), cap, chunk, meta.n_active,
                (nv_part,) + tuple(ts), dtype, dev, old, remap))
    return PoolState(meta=meta, Uh=parts[0], Ur=parts[1], parent_slot=ps, parent_off=po)


# ------------------------------------------------------------- octant tags
def octant_tags_packed(sim, l: int) -> np.ndarray:
    """[n_active, 2, 2, 2] tagged octants of packed level l (dense parent):
    per chunk the full-state g-padded blocks, the problem's local error
    estimator, the n_error_buf dilation (exact across tiles: the flags live
    on the padded blocks), reduced to octants."""
    st = sim.level_pool[l]
    g = sim._g
    ts = sim.tile_shape
    if sim._is_pool(l - 1):
        raise NotImplementedError("packed tags with a pool parent")
    nh, nr = _split_parts(sim)
    chunk = sim.packed_chunk
    active = sim.grid.active_axes
    pp = sim._fill_level0(sim.level_U[l - 1])
    pp_h, pp_r = pp[:nh].contiguous(), pp[nh:].contiguous()
    del pp
    meta = st.meta
    outs = []
    for i0 in _live_chunks(meta, chunk):
        sl = slice(i0, i0 + chunk)
        nbr_c, org_c = meta.nbr_dev[sl], meta.origin_dev[sl]
        blk = pk.assemble_chunk(st.Uh, i0, chunk, nbr_c, tp.make_backdrop_from_dense(
            pp_h, org_c, ts, g, g, active).contiguous(), g, ts)
        if st.Ur is not None:
            blk_r = pk.assemble_chunk(st.Ur, i0, chunk, nbr_c, tp.make_backdrop_from_dense(
                pp_r, org_c, ts, g, g, active).contiguous(), g, ts)
            blk = torch.cat([blk, blk_r], dim=1)
        tags = sim.problem.error_est_local(blk, sim.level_grids[l], l, org_c)
        tags = ops.dilate(tags, sim.n_error_buf, (0, 1, 2), (False,) * 3)
        tags = tags[:, g:-g, g:-g, g:-g]
        c = tags.shape[0]
        outs.append(tags.reshape(c, 2, ts[0] // 2, 2, ts[1] // 2, 2, ts[2] // 2)
                    .any(dim=6).any(dim=4).any(dim=2).cpu().numpy())
    octs = np.concatenate(outs, axis=0) if outs else np.zeros((0, 2, 2, 2), bool)
    return octs[: meta.n_active]


# -------------------------------------------------------------- avg down
def _octant_assemble(own, restr, cs_c, half):
    """Parent tiles with each refined octant replaced by the restricted
    child data (`tilepool.average_down_into_pool`'s assembly)."""
    out = own.clone()
    c = own.shape[0]
    for a in range(2):
        for b in range(2):
            for cc in range(2):
                reg = (slice(None), slice(None), slice(a * half[0], (a + 1) * half[0]),
                       slice(b * half[1], (b + 1) * half[1]),
                       slice(cc * half[2], (cc + 1) * half[2]))
                ok = (cs_c[:, a, b, cc] >= 0).reshape(c, 1, 1, 1, 1)
                out[reg] = torch.where(ok, restr[:, a, b, cc], out[reg])
    return out


def avgdown_packed(sim, l: int):
    """Average packed child l+1 into packed parent l, over parent chunks
    (reference `AverageDownTo`): pointwise in the parent row, so the new
    rows go back in place."""
    st, child = sim.level_pool[l], sim.level_pool[l + 1]
    ts = sim.tile_shape
    nh, nr = _split_parts(sim)
    chunk = sim.packed_chunk
    active = sim.grid.active_axes
    opts = sim.level_opts[l]
    half = tuple(t // 2 for t in ts)
    nv = nh + nr
    for i0 in _live_chunks(st.meta, chunk):
        sl = slice(i0, i0 + chunk)
        cs_c = st.child_slots[sl]
        rows = torch.clamp(cs_c.reshape(-1), min=0)
        parts = [ops.restrict(pk.row_gather(child.Uh, rows), active)]
        own = [st.Uh[sl]]
        if child.Ur is not None:
            parts.append(ops.restrict(pk.row_gather(child.Ur, rows), active))
            own.append(st.Ur[sl])
        restr = torch.cat(parts, dim=1).reshape(chunk, 2, 2, 2, nv, *half)
        out = _octant_assemble(torch.cat(own, dim=1), restr, cs_c, half)
        out = euler.enforce_limits(out.transpose(0, 1), opts.eos, opts.density_floor,
                                   opts.temperature_floor, opts.n_scalars).transpose(0, 1)
        st.Uh[sl] = out[:, :nh]
        if st.Ur is not None:
            st.Ur[sl] = out[:, nh:]
    pk.check_gathers(st.Uh.device)


def avgdown_packed_into_dense(sim, l: int):
    """Average packed child l+1 into the dense parent l: the restricted
    active tiles written at origin / 2, then the floors over the whole
    level (`quokka_tpu/amr/packed_driver.py:639-694`)."""
    child = sim.level_pool[l + 1]
    ts = sim.tile_shape
    chunk = sim.packed_chunk
    active = sim.grid.active_axes
    opts = sim.level_opts[l]
    half = tuple(t // 2 for t in ts)
    U = sim.level_U[l].clone()
    meta = child.meta
    for i0 in _live_chunks(meta, chunk):
        sl = slice(i0, i0 + chunk)
        own = child.Uh[sl] if child.Ur is None else torch.cat([child.Uh[sl], child.Ur[sl]], 1)
        n_act = min(chunk, meta.n_active - i0)  # the active rows lead
        restr = ops.restrict(own[:n_act], active)
        o = meta.origin_dev[i0:i0 + n_act].to(torch.int64) // 2
        starts = torch.cat([torch.zeros_like(o[:, :1]), o], dim=1)
        lin = tp.block_index(starts, half, (1,) + tuple(U.shape))
        U.view(-1).index_copy_(0, lin.reshape(-1), restr.reshape(-1))
    sim.level_U[l] = euler.enforce_limits(U, opts.eos, opts.density_floor,
                                          opts.temperature_floor, opts.n_scalars)


# ------------------------------------------------------------------ reflux
def reflux_packed(sim, l: int, own_bufs: Dict, Ffine_sum: Dict, dt_c: float):
    """The coarse-fine flux correction of packed parent l: the
    child-scattered parent-indexed registers completed across parent-tile
    faces, then the pool reflux on a transient full-layout copy of the
    parent (a parent is an eighth of its child's bytes)."""
    st = sim.level_pool[l]
    nh, _ = _split_parts(sim)
    U5 = st.Uh if st.Ur is None else torch.cat([st.Uh, st.Ur], dim=1)
    Ff = pk.complete_face_registers(Ffine_sum, st.meta.nbr_dev)
    U5 = reflux_pool_parent(U5, own_bufs, Ff, st.child_slots, st.meta.nbr_dev, dt_c,
                            sim.level_opts[l].dx, sim.tile_shape)
    U5 = sim._rad_fixup_pool(U5)
    st.Uh = U5[:, :nh].contiguous()
    if st.Ur is not None:
        st.Ur = U5[:, nh:].contiguous()


# ---------------------------------------------------------- sums / signals
def packed_level_sums(sim, l: int) -> torch.Tensor:
    """Conservation sums of packed level l over its uncovered active cells
    (float64 [nvar] on the device), chunk by chunk."""
    st = sim.level_pool[l]
    ts = sim.tile_shape
    chunk = sim.packed_chunk
    cs = st.child_slots if st.child_slots is not None else st.no_children()
    total = torch.zeros(sim.layout.nvar, dtype=torch.float64, device=sim.device)
    for i0 in _live_chunks(st.meta, chunk):
        sl = slice(i0, i0 + chunk)
        own = st.Uh[sl] if st.Ur is None else torch.cat([st.Uh[sl], st.Ur[sl]], dim=1)
        act = torch.arange(i0, i0 + chunk, device=sim.device) < st.meta.n_active
        w = act[:, None, None, None] & ~tp.coverage_cells(cs[sl], ts)
        total += torch.where(w[:, None], own, 0.0).sum(dim=(0, 2, 3, 4), dtype=torch.float64)
    return total * sim.level_grids[l].cell_volume()


def packed_max_signal(sim, l: int) -> torch.Tensor:
    """Max hydro signal speed over packed level l's active tiles (a 0-d
    device tensor)."""
    st = sim.level_pool[l]
    chunk = sim.packed_chunk
    eos = sim.level_opts[l].eos
    smax = torch.zeros((), dtype=sim.dtype, device=sim.device)
    for i0 in _live_chunks(st.meta, chunk):
        sl = slice(i0, i0 + chunk)
        sig = euler.max_signal_speed(st.Uh[sl].transpose(0, 1), eos).amax(dim=(1, 2, 3))
        act = torch.arange(i0, i0 + chunk, device=sim.device) < st.meta.n_active
        smax = torch.maximum(smax, torch.where(act, sig, 0.0).max())
    return smax


# --------------------------------------------------------------- timestep
def timestep_pool_packed(sim, l: int, t_level: float, dt_l: float):
    """One substep of packed level l: the streamed hydro advance, the
    streamed radiation subcycle, the packed child's two substeps, the
    reflux and the average-down (`quokka_tpu/amr/packed_driver.py:472-635`)."""
    from ..utils.profiler import prof

    if (l < sim.max_level and sim.level_steps[l] > 0
            and sim.level_steps[l] % sim.regrid_interval == 0):
        with prof.region(f"regrid_L{l}"):
            sim._regrid_level(l)
            prof.sync(sim.level_pool[l].Uh)
    st = sim.level_pool[l]
    meta = st.meta
    dev, dtype = sim.device, sim.dtype
    ts = sim.tile_shape
    nh, nr = _split_parts(sim)
    active = sim.grid.active_axes
    chunk = sim.packed_chunk
    theta1 = (t_level - sim._parent_t) / sim._parent_dt
    theta2 = theta1 + dt_l / sim._parent_dt
    npdt = np.float32 if dtype == torch.float32 else np.float64

    def scalar(x):
        return torch.tensor(float(npdt(x)), dtype=dtype, device=dev)

    zero = torch.zeros(meta.capacity, dtype=torch.int32, device=dev)
    zero3 = torch.zeros((meta.capacity, 3), dtype=torch.int32, device=dev)
    ps = st.parent_slot if st.parent_slot is not None else zero
    po = st.parent_off if st.parent_off is not None else zero3
    is_leaf = l >= sim.finest_level
    opts = sim.level_opts[l]

    kind, ctx = sim._parent_ctx
    if kind == "dense":
        ph_o, ph_n, pr_o, pr_n = ctx
        parent_h = pk.ParentContext("dense", (ph_o, ph_n))
        parent_r = pk.ParentContext("dense", (pr_o, pr_n)) if nr else None
        restr_mode, parent_cap = "child", 0
    else:
        Uh_o, Uh_n, Ur_o, Ur_n, gp4, nbr_p, org_p, tha, thb = ctx
        ph_o, ph_n, pr_o, pr_n = gp4
        parent_h = pk.ParentContext("pool", (Uh_o, Uh_n, pk._lerp(ph_o, ph_n, tha),
                                             pk._lerp(ph_o, ph_n, thb), nbr_p, org_p))
        parent_r = None
        if nr:
            parent_r = pk.ParentContext("pool", (Ur_o, Ur_n, pk._lerp(pr_o, pr_n, tha),
                                                 pk._lerp(pr_o, pr_n, thb), nbr_p, org_p))
        restr_mode, parent_cap = "parent", Uh_o.shape[0]

    Uh_old, Ur_old = st.Uh, st.Ur
    with prof.region(f"hydro_L{l}"):
        Uh_new, own_h, Ffine_h, stats = pk.fused_hydro_advance_packed(
            Uh_old, scalar(dt_l), opts, meta, ps, po, parent_h, scalar(theta1),
            scalar(theta2), chunk, active, ts, own_out=not is_leaf,
            parent_cap=parent_cap, restr_mode=restr_mode)
        prof.sync(Uh_new)
    if getattr(sim, "_substep_valid_flags", None) is not None:
        sim._substep_valid_flags.append(stats["valid"])
    sim._count_fofc(stats["n_fofc"], stats["fofc_fallbacks"])

    own_all, Ffine = own_h, Ffine_h
    Ur_new = Ur_old
    if sim.layout.radiation_enabled and sim._radiation is not None and nr:
        ropts = sim._get_pool_rad(l).opts
        dt_rad = ropts.cfl * sim.level_grids[l].dx_min / ropts.chat
        nsub = max(1, int(math.ceil(dt_l / dt_rad)))
        if nsub > ropts.max_substeps + 1:
            raise RuntimeError(f"radiation substeps {nsub} > max {ropts.max_substeps}")
        with prof.region(f"rad_L{l}"):
            Uh_new, Ur_new, own_r, Ffine_r, rad_ok = pk.fused_rad_subcycle_packed(
                Uh_new, Ur_old, t_level, dt_l, nsub, ropts, opts, sim, sim.level_grids[l],
                meta, ps, po, parent_r, theta1, theta2, chunk, active, ts,
                own_out=not is_leaf, parent_cap=parent_cap, restr_mode=restr_mode)
            prof.sync(Ur_new)
        if getattr(sim, "_substep_valid_flags", None) is not None:
            sim._substep_valid_flags.append(rad_ok)
        Ffine = {d: torch.cat([Ffine_h[d], Ffine_r[d]], dim=1) for d in Ffine_h}
        own_all = (None if is_leaf else
                   {d: torch.cat([own_h[d], own_r[d]], dim=1) for d in own_h})
        del Ffine_h, Ffine_r, own_h, own_r
    pk.check_gathers(dev)

    st.Uh, st.Ur = Uh_new, Ur_new
    sim.level_steps[l] += 1
    sim.cell_updates += meta.active_cells
    sim.cell_updates_raw += meta.active_cells

    if not is_leaf:
        if kind != "dense":
            raise NotImplementedError("packed hierarchies deeper than two pool levels "
                                      "(the child backdrop needs a dense grandparent)")
        saved = (sim._parent_ctx, sim._parent_t, sim._parent_dt)
        sim._parent_ctx = ("ppool", (Uh_old, st.Uh, Ur_old, st.Ur, ctx, meta.nbr_dev,
                                     meta.origin_dev, scalar(theta1), scalar(theta2)))
        sim._parent_t, sim._parent_dt = t_level, dt_l
        del Uh_old, Ur_old, Uh_new, Ur_new
        fine_sum = None
        for i in range(2):
            timestep_pool_packed(sim, l + 1, t_level + i * dt_l * 0.5, dt_l * 0.5)
            ff = sim._last_packed_Ffine
            sim._last_packed_Ffine = None
            if fine_sum is None:
                fine_sum = {d: 0.5 * F for d, F in ff.items()}
            else:
                fine_sum = {d: fine_sum[d] + 0.5 * ff[d] for d in ff}
            del ff
        sim._parent_ctx, sim._parent_t, sim._parent_dt = saved
        if sim.do_reflux:
            with prof.region(f"reflux_L{l}"):
                reflux_packed(sim, l, own_all, fine_sum, dt_l)
                prof.sync(sim.level_pool[l].Uh)
        del own_all, fine_sum
        with prof.region(f"avgdown_L{l}"):
            avgdown_packed(sim, l)
            prof.sync(sim.level_pool[l].Uh)

    if restr_mode == "child":
        sim._last_restricted_fluxes = Ffine
    else:
        sim._last_packed_Ffine = Ffine
