"""Block-structured AMR on dense levels: subcycling, refluxing,
regridding and average-down.

Counterpart of `quokka_tpu.amr.hierarchy.AMRSimulation` for dense levels
(reference `AMRSimulation::timeStepWithSubcycling` / `regrid` /
`AverageDownTo` / `YAFluxRegister::Reflux`, ``src/simulation.hpp:1220-1345,
1421-1508, 1939-1964``). Each level is a full-domain tensor at its
resolution plus a boolean mask of its refined region. Where the mask is
clear the level carries prolonged parent data, refreshed after every hydro
and radiation advance, which doubles as the coarse-fine ghost fill: the
reference's FillPatcher becomes `where(mask, U_fine, prolong(lerp(Uc_old,
Uc_new, theta)))`. Regridding rewrites masks only, so shapes never change.

Per level step: the padded hydro advance (K1, K2, K2d) returns the
time-averaged face fluxes; the radiation subcycle (`LevelRadiation`: K7,
K5) adds its own. A level with children turns its fluxes into a
cell-centred flux-register correction at once (the coarse side, with the
root's radiation fluxes streamed in stage by stage), runs two subcycled
child steps, adds the children's restricted fluxes (the fine side), applies
the correction to the uncovered coarse cells, and averages down.

Host syncs: one a coarse substep (the stacked finiteness flags of every
level step, which drive the retry ladder), one per regrid (the new level's
active-cell count), one per timestep (dt), and the hydro advance's FOFC
check, one per stage and level step.

The figure of merit counts active cells (`cell_updates`, the reference's
`cellUpdatesEachLevel_`); `cell_updates_raw` counts every cell the dense
levels advance. The JAX package's `evolve` adds the root's cells a second
time each coarse step (its base loop and the level step both count them);
the port counts each level step once.

Levels from `amr.sparse_min_level` up are packed tile pools
(`amr.pool_packed = 1`, `packed_driver`): fixed-shape tiles in row pools,
advanced chunk by chunk with the fused single-pass RK2 and the streamed
radiation subcycle, their ghosts gathered by K9. With a packed child the
root takes the lean hydro step seeded in the kernels (K2e): its sweeps emit
the flux-register correction of the coarse-fine boundary faces beside the
update, so no root face array exists (`_root_seed_masks`; fine coverage
that touches the domain edge falls back to the padded root step).

Not ported (NotImplementedError naming the key): unpacked tile pools
(`amr.sparse_min_level` with `amr.pool_packed = 0`), `do_subcycle = 0`,
gravity, particles, Strang-split sources (cooling, chemistry), domain
decomposition, restart, plotfiles and checkpoints; periodic boundaries
only. `amr.sync_dispatch`, the JAX package's dispatch throttle, is read
and has no effect.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..boundaries import fill_ghosts
from ..config import ParmParse
from ..hydro import euler
from ..hydro.advance import advance_hydro_rk2
from ..simulation import Simulation
from ..stencil import interior, sh
from . import operators as ops

def _np_dtype(dtype: torch.dtype):
    return np.float32 if dtype == torch.float32 else np.float64


class AMRSimulation(Simulation):
    """Multi-level simulation with subcycling AMR (refinement ratio 2) on
    dense levels."""

    _ported_keys = frozenset({"amr.max_level"})

    def __init__(self, problem, pp: Optional[ParmParse] = None, *, device="cuda",
                 precision: str | None = None, decomp=None):
        if decomp is not None:
            raise NotImplementedError("AMRSimulation(decomp=...): sharded AMR is "
                                      "not ported yet")
        super().__init__(problem, pp, device=device, precision=precision)
        pp = self.pp
        self.max_level = pp.get_int("amr.max_level", 0)
        self.n_error_buf = pp.get_int("amr.n_error_buf", 3)
        self.regrid_interval = pp.get_int("regrid_interval", 2)
        self.do_reflux = bool(pp.get_int("do_reflux", 1))
        self.do_subcycle = bool(pp.get_int("do_subcycle", 1))
        self.sparse_min_level = pp.get_int("amr.sparse_min_level", 10**9)
        self.tile_shape = tuple(int(x) for x in pp.get_list("amr.tile_size", [32, 32, 32]))
        self.pool_chunk = pp.get_int("amr.pool_chunk", 0)
        self.pool_packed = bool(pp.get_int("amr.pool_packed", 0))
        self.sync_dispatch = bool(pp.get_int("amr.sync_dispatch", int(self.pool_packed)))
        self.packed_chunk = pp.get_int("amr.packed_chunk", max(self.pool_chunk, 32))
        self.pool_headroom = pp.get_float("amr.pool_headroom", 1.5)
        if not self.do_subcycle and self.max_level > 0:
            raise NotImplementedError("deck key 'do_subcycle' = 0: global stepping "
                                      "of the levels is not ported yet")
        if not all(self.periodic):
            raise NotImplementedError("AMRSimulation: only periodic boundaries are "
                                      "ported (the padded level fills)")
        if self.grid.active_axes != (0, 1, 2):
            raise NotImplementedError("AMRSimulation: 3D levels only")
        if problem.external_acceleration(self.grid, device="cpu") is not None:
            raise NotImplementedError("AMRSimulation: the external acceleration kick "
                                      "(Problem.external_acceleration) on AMR levels")
        self.level_grids = [self.grid]
        self.level_opts = [self.hydro_opts]
        for _ in range(self.max_level):
            g = self.level_grids[-1].refine(2)
            self.level_grids.append(g)
            self.level_opts.append(dataclasses.replace(self.hydro_opts, dx=g.dx))
        if self.sparse_min_level <= self.max_level:
            self._check_pool_config()
        self.level_U: List[Optional[torch.Tensor]] = [None] * (self.max_level + 1)
        self.level_mask: List[Optional[torch.Tensor]] = [None] * (self.max_level + 1)
        self.level_steps = [0] * (self.max_level + 1)
        self.level_pool = [None] * (self.max_level + 1)
        self.finest_level = 0
        self._level_rad = {}
        self._pool_rad = {}
        self._active_cell_cache = {}
        self._fofc_cells_dev = None
        self._root_bmasks = None

    def _check_pool_config(self):
        """The pool keys' rules (`quokka_tpu/amr/hierarchy.py:111-149`)."""
        smin = self.sparse_min_level
        if smin < 1:
            raise ValueError("amr.sparse_min_level must be >= 1 (level 0 is always dense)")
        if not self.pool_packed:
            raise NotImplementedError(
                f"deck key 'amr.sparse_min_level' = {smin} with 'amr.pool_packed' = 0: "
                "unpacked tile pools are not ported (set amr.pool_packed = 1)")
        for d in range(3):
            ns = self.level_grids[smin].n_cell[d]
            if self.tile_shape[d] % 2 or ns % self.tile_shape[d]:
                raise ValueError(f"amr.tile_size {self.tile_shape} must be even and divide "
                                 f"the level-{smin} extent {self.level_grids[smin].n_cell}")
        if min(self.tile_shape) < 2 * self.ng[0] + 2:
            raise ValueError(f"amr.pool_packed needs tile_size >= 2*nghost+2 = "
                             f"{2 * self.ng[0] + 2} (fused stage-1 halos)")
        if smin != 1 or self.max_level - smin > 1:
            raise NotImplementedError("amr.pool_packed supports amr.sparse_min_level = 1 "
                                      "and at most two packed levels (dense grandparent)")

    # ------------------------------------------------------------------ setup
    def set_initial_conditions(self):
        super().set_initial_conditions()
        self.level_U[0] = self.U
        self.level_mask[0] = torch.ones(self.grid.n_cell, dtype=torch.bool,
                                        device=self.device)
        for l in range(self.max_level):
            if not self._regrid_level(l):
                break
        self.init_sums = self._composite_sums()

    def _fill_level0(self, U):
        return fill_ghosts(U, self.ng, self.problem.bcs)

    def _fill_fine(self, U, mask, Uc_interp, l: int):
        base = torch.where(mask[None], U, ops.prolong(Uc_interp, self.grid.active_axes))
        return fill_ghosts(base, self.ng, self.problem.bcs)

    def _lerp(self, Uc_old, Uc_new, theta, comps=None):
        """(1 - theta) Uc_old + theta Uc_new over the leading `comps`
        components; `theta` is a 0-d tensor of the state's dtype (the JAX
        level step takes it as a traced scalar of that dtype)."""
        a = Uc_old if comps is None else Uc_old[:comps]
        b = Uc_new if comps is None else Uc_new[:comps]
        return (1.0 - theta) * a + theta * b

    def _count_fofc(self, n_dev, fallbacks: int):
        """Add a level step's FOFC cells (a device count, read once at the
        end of evolve) and fallbacks."""
        self.fofc_fallbacks += fallbacks
        self._fofc_cells_dev = (n_dev if self._fofc_cells_dev is None
                                else self._fofc_cells_dev + n_dev)

    # ------------------------------------------------------- pool levels
    def _is_pool(self, l: int) -> bool:
        return 0 < self.sparse_min_level <= l

    @property
    def _g(self) -> int:
        return self.ng[0]

    def _dense_pad_part(self, part: str, width: int):
        """The ghost fill of one component part of a dense level, "h" the
        hydro block or "r" the radiation block: the packed engine reads the
        parent pads split (`quokka_tpu/amr/hierarchy.py:1413-1458`)."""
        nh = self.layout.nvar_hydro
        sl = slice(0, nh) if part == "h" else slice(nh, self.layout.nvar)
        return lambda U: fill_ghosts(U[sl], (width,) * 3, self.problem.bcs)

    def _get_pool_rad(self, l: int):
        if l not in self._pool_rad:
            from ..radiation.pool import PoolLevelRadiation

            self._pool_rad[l] = PoolLevelRadiation(self, l, self.level_grids[l])
        return self._pool_rad[l]

    def _rad_fixup_pool(self, U):
        """`_rad_fixup` on a pool [T, nvar, ...]."""
        if not self.layout.radiation_enabled or self._radiation is None:
            return U
        rs, G = self.layout.rad_start, self.layout.n_groups
        floor = self._radiation.opts.erad_floor
        out = U.clone()
        for g in range(G):
            out[:, rs + 4 * g] = torch.clamp(U[:, rs + 4 * g], min=floor)
        return out

    def _pool_child_reflux_dense(self, l: int, corr_crse, F_fine_pool_sum: dict,
                                 dt_c: float):
        """Dense level l refluxed against its packed child: the child's
        restricted tile faces assembled into dense face arrays, turned into
        the fine side of the correction and applied against the seeded
        coarse side."""
        from .sparse import fine_faces_to_dense

        st = self.level_pool[l + 1]
        F_dense = fine_faces_to_dense(F_fine_pool_sum, st.meta, tuple(self.ng))
        mask_fine = st.coverage_dense()
        corr_f = self._reflux_corr(l, F_dense, mask_fine, dt_c)
        del F_dense
        self._reflux_apply(l, corr_crse, corr_f, mask_fine)

    # ------------------------------------------- seeded root step (packed)
    def _root_seeded_eligible(self) -> bool:
        """The root takes the lean step with in-kernel register seeding
        (K2e) when its child is packed: f32, refluxed, all periodic
        (`quokka_tpu/amr/hierarchy.py:366-380`)."""
        return (self.pool_packed and self.do_reflux and self.dtype == torch.float32
                and all(self.periodic))

    def _root_seed_masks(self):
        """Per-axis coarse-fine boundary-face masks of level 1's coverage on
        the root (slot f the lo face of cell f), rebuilt once per regrid
        epoch; None when the coverage touches the domain edge (the padded
        root step runs there). One host read a rebuild."""
        st = self.level_pool[1] if self._is_pool(1) else None
        epoch = st.meta.epoch if st is not None else int(self.level_steps[0])
        if self._root_bmasks is not None and self._root_bmasks[0] == epoch:
            return self._root_bmasks[1]
        mask_fine = st.coverage_dense() if st is not None else self.level_mask[1]
        cmask = ops.restrict_mask_any(mask_fine, self.grid.active_axes)
        bms = {d: (cmask != sh(cmask, -1, d)).to(self.dtype).contiguous() for d in range(3)}
        edge = torch.stack([cmask.select(d, 0).any() | cmask.select(d, cmask.shape[d] - 1).any()
                            for d in range(3)]).any()
        masks = None if bool(edge) else bms
        self._root_bmasks = (epoch, masks)
        return masks

    def _hydro_step_seeded(self, U, dt: float, bms: dict):
        """The root's hydro substep in the lean formulation with the flux
        register seeded in the kernels (`_get_root_seeded_step`). Returns
        (U_new, the coarse-side register correction dt * reflux_corr)."""
        nh = self.layout.nvar_hydro
        Uh_new, stats = advance_hydro_rk2(U[:nh], dt, self.level_opts[0], None, (0, 0, 0),
                                          (True,) * 3, bc_kinds={0: None, 1: None, 2: None},
                                          reflux_corr_masks=bms)
        U_new = torch.cat([Uh_new, U[nh:]]) if nh < U.shape[0] else Uh_new
        self._count_fofc(stats["n_fofc"], stats["fofc_fallbacks"])
        return U_new, dt * stats["reflux_corr"]

    def _hydro_step(self, l: int, U, dt: float, theta=None):
        """One hydro substep of level l (the JAX `_get_level_step`): the
        padded RK2 advance of the gas block returning its time-averaged face
        fluxes; a fine level re-imposes the prolonged parent data on its
        inactive cells at the substep's end. Returns (U_new, fluxes)."""
        opts = self.level_opts[l]
        nh = self.layout.nvar_hydro
        if l == 0:
            fill1 = fill2 = self._fill_level0
        else:
            mask = self.level_mask[l]
            Uc_old, Uc_new = self._parent_U_old, self._parent_U_new
            th1, th2 = (torch.tensor(t, dtype=U.dtype, device=U.device) for t in theta)

            def fill1(Uf):
                return self._fill_fine(Uf, mask, self._lerp(Uc_old, Uc_new, th1, nh), l)

            def fill2(Uf):
                return self._fill_fine(Uf, mask, self._lerp(Uc_old, Uc_new, th2, nh), l)

        Uh_new, stats = advance_hydro_rk2(U[:nh], dt, opts, fill1, self.ng,
                                          self.periodic, fill_fn2=fill2,
                                          return_fluxes=True)
        U_new = torch.cat([Uh_new, U[nh:]]) if nh < U.shape[0] else Uh_new
        del Uh_new
        self._count_fofc(stats["n_fofc"], stats["fofc_fallbacks"])
        if l > 0:
            U_new = torch.where(mask[None], U_new, ops.prolong(
                self._lerp(Uc_old, Uc_new, th2), self.grid.active_axes))
        return U_new, stats["fluxes"]

    def _get_level_rad(self, l: int):
        if l not in self._level_rad:
            from ..radiation.advance import LevelRadiation

            self._level_rad[l] = LevelRadiation(self, l, self.level_grids[l])
        return self._level_rad[l]

    # ---------------------------------------------------------------- reflux
    # The flux-register correction is applied in two parts (reference
    # `YAFluxRegister` CrseInit/FineAdd/Reflux): the coarse side becomes a
    # cell-centred correction as soon as the level's fluxes exist, so the
    # full-size face dicts never stay alive through the radiation subcycle
    # and the children's steps; the fine side is added when the children
    # finish.
    def _reflux_corr(self, l: int, F: dict, mask_fine, dt_c: float, acc=None):
        """Cell-centred reflux correction of the face-flux dict `F` (padded
        face coordinates) on the coarse-fine boundary faces of `mask_fine`,
        added to `acc`. Consumes `F` axis by axis."""
        opts = self.level_opts[l]
        ng = self.ng
        cmask = ops.restrict_mask_any(mask_fine, self.grid.active_axes)
        m_p = ops.pad_mask_zero(cmask, ng)
        npdt = _np_dtype(self.dtype)
        corr = acc
        for d in sorted(F):
            Fd = F.pop(d)
            # boundary faces: covered / uncovered status differs across them
            boundary = m_p != sh(m_p, -1, d)
            dF = torch.where(boundary[None], Fd, 0.0)
            del Fd
            factor = float(npdt(dt_c) / npdt(opts.dx[d]))
            contrib = interior((dF - sh(dF, 1, d + 1)) * factor, ng)
            del dF
            corr = contrib if corr is None else corr + contrib
        return corr

    def _reflux_apply(self, l: int, corr_crse, corr_fine, mask_fine):
        """U[l] += (corr_fine - corr_crse) on the uncovered coarse cells."""
        U = self.level_U[l]
        cmask = ops.restrict_mask_any(mask_fine, self.grid.active_axes)
        corr = corr_fine - corr_crse
        if corr.shape[0] < U.shape[0]:
            corr = torch.cat([corr, corr.new_zeros((U.shape[0] - corr.shape[0],
                                                    *corr.shape[1:]))])
        self.level_U[l] = self._rad_fixup(U + torch.where(cmask[None], 0.0, corr))

    def _publish(self, l: int, F: dict, seed_mask, dt_l: float):
        """Neutralize the inactive region's faces of level l's fluxes `F`
        (consumed), restrict them for the parent's register and, when level l
        has children (`seed_mask`), seed its own register with the masked
        fluxes. Returns (restricted, seed correction or None)."""
        masked, restricted = {}, {}
        for d in list(F):
            Fm = ops.mask_face_flux(F.pop(d), self.level_mask[l], d, self.ng)
            restricted[d] = ops.restrict_face_flux(Fm, d, self.grid.active_axes,
                                                   self.ng, self.ng)
            if seed_mask is not None:
                masked[d] = Fm
            del Fm
        seed = None if seed_mask is None else self._reflux_corr(l, masked, seed_mask, dt_l)
        return restricted, seed

    def _rad_fixup(self, U):
        """Floor Erad after the reflux correction: it can push an uncovered
        coarse cell's Erad negative, and prolongation would then seed the
        fine level's transport with it, whose donor-cell admissibility
        fallback divides by the cell's Erad."""
        if not self.layout.radiation_enabled or self._radiation is None:
            return U
        rs, G = self.layout.rad_start, self.layout.n_groups
        floor = self._radiation.opts.erad_floor
        out = U.clone()
        for g in range(G):
            out[rs + 4 * g] = torch.clamp(U[rs + 4 * g], min=floor)
        return out

    def _average_down(self, l: int):
        """U_l := restriction of U_{l+1} where covered, then the floors."""
        opts = self.level_opts[l]
        active = self.grid.active_axes
        cmask = ops.restrict_mask_any(self.level_mask[l + 1], active)
        U = torch.where(cmask[None], ops.restrict(self.level_U[l + 1], active),
                        self.level_U[l])
        self.level_U[l] = euler.enforce_limits(
            U, opts.eos, opts.density_floor, opts.temperature_floor, opts.n_scalars)

    # ---------------------------------------------------------------- regrid
    def _regrid_pool_level(self, l: int) -> bool:
        """(Re)build packed level l+1 from the tags of level l (dense or
        packed), keeping the nesting of an existing grandchild
        (`quokka_tpu/amr/hierarchy.py:780-870`). Host reads: the tags."""
        from . import packed_driver as pd
        from . import tilepool as tp

        ts = self.tile_shape
        active = self.grid.active_axes
        child_shape = self.level_grids[l + 1].n_cell
        if self._is_pool(l):
            octs = pd.octant_tags_packed(self, l)
            meta_l = self.level_pool[l].meta
            tiles = [(2 * int(meta_l.ijk[s, 0]) + a, 2 * int(meta_l.ijk[s, 1]) + b,
                      2 * int(meta_l.ijk[s, 2]) + c)
                     for s in range(meta_l.n_active)
                     for a in range(2) for b in range(2) for c in range(2) if octs[s, a, b, c]]
        else:
            tags = self.problem.error_est(self, l)
            if tags is None:
                return self.finest_level > l
            tags = ops.dilate(torch.as_tensor(tags, dtype=torch.bool, device=self.device),
                              self.n_error_buf, active, self.periodic)
            TX, TY, TZ = (child_shape[d] // ts[d] for d in range(3))
            blocks = tags.reshape(TX, ts[0] // 2, TY, ts[1] // 2, TZ, ts[2] // 2)
            blocks = blocks.any(dim=5).any(dim=3).any(dim=1)
            tiles = [tuple(int(v) for v in t) for t in np.argwhere(blocks.cpu().numpy())]
        # the nesting: existing grandchild tiles pin their parent tiles until
        # the grandchild's own regrid
        if l + 2 <= self.max_level and self.level_pool[l + 2] is not None:
            gc_meta = self.level_pool[l + 2].meta
            pins = {tuple(int(v) // 2 for v in gc_meta.ijk[s]) for s in range(gc_meta.n_active)}
            tiles = sorted(set(tiles) | pins)
        self._active_cell_cache.pop(l + 1, None)
        if not tiles:
            self.finest_level = min(self.finest_level, l)
            self.level_pool[l + 1] = None
            if self._is_pool(l):
                self.level_pool[l].child_slots = None
            return False
        old = self.level_pool[l + 1]
        hr = self.pool_headroom
        cap = (old.meta.grow_capacity(len(tiles), headroom=hr) if old is not None
               else max(8, int(np.ceil(len(tiles) * hr))))
        c = max(self.pool_chunk, self.packed_chunk)
        cap = ((cap + c - 1) // c) * c
        meta = tp.TileMeta.build(child_shape, ts, tiles, self.periodic, capacity=cap,
                                 device=self.device)
        self.level_pool[l + 1] = pd.build_packed_level(self, l, meta, old)
        del old
        if l + 2 <= self.max_level and self.level_pool[l + 2] is not None:
            gc = self.level_pool[l + 2]
            gc.parent_slot, gc.parent_off = tp.parent_linkage(gc.meta, meta, self.device)
            self.level_pool[l + 1].child_slots = tp.child_linkage(meta, gc.meta, self.device)
        if self._is_pool(l):
            self.level_pool[l].child_slots = tp.child_linkage(self.level_pool[l].meta, meta,
                                                              self.device)
        self.finest_level = max(self.finest_level, l + 1)
        return True

    def _regrid_level(self, l: int) -> bool:
        """(Re)build level l+1 from the error tags of level l. Returns True if
        level l+1 exists afterwards. One host sync: the new level's active
        cell count."""
        if self._is_pool(l + 1):
            return self._regrid_pool_level(l)
        tags = self.problem.error_est(self, l)
        if tags is None:
            return self.finest_level > l
        active = self.grid.active_axes
        tags = ops.dilate(torch.as_tensor(tags, dtype=torch.bool, device=self.device),
                          self.n_error_buf, active, self.periodic)
        if l > 0:
            # proper nesting: stay inside the current level-l refined region
            tags = tags & torch.logical_not(ops.dilate(
                torch.logical_not(self.level_mask[l]), 1, active, self.periodic))
        new_mask = ops.prolong_mask(tags, active)
        count = int(new_mask.sum())  # host sync
        self._active_cell_cache[l + 1] = count
        if count == 0:
            self.finest_level = min(self.finest_level, l)
            self.level_U[l + 1] = None
            self.level_mask[l + 1] = None
            return False
        prolonged = ops.prolong(self.level_U[l], active)
        old_U, old_mask = self.level_U[l + 1], self.level_mask[l + 1]
        if old_U is None:
            U_new = prolonged
        else:
            U_new = torch.where((old_mask & new_mask)[None], old_U, prolonged)
        del prolonged
        self.level_U[l + 1] = U_new
        self.level_mask[l + 1] = new_mask
        self.finest_level = max(self.finest_level, l + 1)
        return True

    # ---------------------------------------------------------------- advance
    def compute_timestep(self) -> float:
        """dt_0 = min over levels of 2^l cfl dx_l / smax_l (fine levels over
        their active cells), capped so every level's radiation subcycle stays
        within max_substeps. One host sync."""
        if self.constant_dt > 0.0:
            return min(self.constant_dt, self.stop_time - self.t)
        dt0 = np.inf
        nh = self.layout.nvar_hydro
        parts = []
        for l in range(self.finest_level + 1):
            fac = 2**l
            dx_min = self.level_grids[l].dx_min
            if self.layout.radiation_enabled and self._radiation is not None:
                ropts = self._radiation.opts
                dt0 = min(dt0, fac * (ropts.max_substeps * ropts.cfl * dx_min / ropts.chat))
            if self._is_pool(l):
                from .packed_driver import packed_max_signal

                smax = packed_max_signal(self, l)
            else:
                sig = euler.max_signal_speed(self.level_U[l][:nh], self.level_opts[l].eos)
                if l > 0:
                    sig = torch.where(self.level_mask[l], sig, 0.0)
                smax = sig.max()
                del sig
            num = torch.tensor(fac * self.cfl * dx_min, dtype=smax.dtype,
                               device=smax.device)
            parts.append(torch.where(smax > 0, num / smax, torch.inf))
        dt0 = min(dt0, float(torch.stack(parts).min()))  # host sync
        dt0 = min(dt0, 1.1 * self.dt_prev, self.max_dt)
        if self.t == 0.0:
            dt0 = min(dt0, self.init_dt)
        eps = 1.0e-3 * dt0
        if self.t + dt0 > self.stop_time - eps:
            dt0 = self.stop_time - self.t
        return dt0

    def _step_cell_updates(self) -> int:
        return 0  # every level step counts its own active cells

    def advance_single_step(self, dt: float) -> bool:
        """Coarse step with a retry ladder: if any level's state is not
        finite, restore the pre-step hierarchy and redo the coarse step as
        2^k substeps of dt / 2^k. The stash holds references only: no level
        tensor is ever written in place."""
        # packed levels keep no pre-step copy (the JAX package's packed mode
        # aborts instead of retrying, `hierarchy.py:1049-1055`)
        max_retries = 0 if self.pool_packed else 6
        saved = (list(self.level_U), list(self.level_mask), list(self.level_steps),
                 self.finest_level, dict(self._active_cell_cache))
        for retry in range(max_retries + 1):
            nsub = 2**retry
            ok = True
            for i in range(nsub):
                self._substep_valid_flags = []
                self._timestep_with_subcycling(0, self.t + i * dt / nsub, dt / nsub)
                flags = self._substep_valid_flags
                self._substep_valid_flags = None
                if flags and not bool(torch.stack(flags).all()):  # host sync
                    ok = False
                    break
            if ok:
                self.U = self.level_U[0]
                return True
            (U, m, s, f, c) = saved
            self.level_U, self.level_mask, self.level_steps = list(U), list(m), list(s)
            self.finest_level, self._active_cell_cache = f, dict(c)
            if self.verbose:
                print(f"\t>> Re-trying AMR coarse step (nsubsteps={2 * nsub})")
        return False

    def _timestep_with_subcycling(self, l: int, t_level: float, dt_l: float):
        from ..utils.profiler import prof

        if (l < self.max_level and self.level_steps[l] > 0
                and self.level_steps[l] % self.regrid_interval == 0):
            with prof.region(f"regrid_L{l}"):
                self._regrid_level(l)
                prof.sync(self.level_U[0])

        U_old = self.level_U[l]
        theta = None
        if l > 0:
            theta1 = (t_level - self._parent_t) / self._parent_dt
            theta = (theta1, theta1 + dt_l / self._parent_dt)
        # with a packed child the root steps lean and its kernels seed the
        # flux register (K2e): no face array at all
        bms = None
        if l == 0 and l < self.finest_level and self._root_seeded_eligible():
            bms = self._root_seed_masks()
        seeded = None
        with prof.region(f"hydro_L{l}"):
            if bms is not None:
                U_new, seeded = self._hydro_step_seeded(U_old, dt_l, bms)
                fluxes = None
            else:
                U_new, fluxes = self._hydro_step(l, U_old, dt_l, theta)
            prof.sync(U_new)

        # the coarse side of the flux register, at once (the root's
        # radiation part is streamed in below); a fine level publishes its
        # hydro fluxes before the radiation subcycle and its radiation
        # fluxes after it: masking, restriction and seeding act on each
        # component alone, so the parts joined give what the whole would
        want_seed = l < self.finest_level and self.do_reflux
        child_pool = l < self.finest_level and self._is_pool(l + 1)
        seed_corr = seed_mask = restricted_for_parent = None
        if want_seed:
            seed_mask = (self.level_pool[l + 1].coverage_dense() if child_pool
                         else self.level_mask[l + 1])
        if want_seed and l == 0:
            seed_corr = (seeded if seeded is not None
                         else self._reflux_corr(l, fluxes, seed_mask, dt_l))
        elif l > 0:
            restricted_for_parent, seed_corr = self._publish(l, fluxes, seed_mask, dt_l)
        del fluxes

        if self.layout.radiation_enabled and self._radiation is not None:
            radL = self._get_level_rad(l)
            if l == 0:
                rad_seed = {"corr": None}

                def consume(F, w):
                    if want_seed:
                        rad_seed["corr"] = self._reflux_corr(
                            l, {d: w * Fd for d, Fd in F.items()}, seed_mask, dt_l,
                            acc=rad_seed["corr"])

                # the root's fluxes go to the register as they are made (and
                # nowhere when it has no children)
                with prof.region(f"rad_L{l}"):
                    U_new, _ = radL.subcycle(U_new, t_level, dt_l, flux_reduce=consume)
                    prof.sync(U_new)
                if want_seed:
                    seed_corr = torch.cat([seed_corr, rad_seed["corr"]])
            else:
                with prof.region(f"rad_L{l}"):
                    U_new, rad_flux = radL.subcycle(
                        U_new, t_level, dt_l, mask=self.level_mask[l],
                        Uc_old=self._parent_U_old, Uc_new=self._parent_U_new,
                        theta_bounds=theta)
                    # inactive cells carry prolonged parent data: re-impose it
                    # (theta as a Python scalar here, as the JAX hierarchy has it)
                    th2 = theta[1]
                    Uc_end = ((1.0 - th2) * self._parent_U_old
                              + th2 * self._parent_U_new)
                    U_new = torch.where(self.level_mask[l][None], U_new,
                                        ops.prolong(Uc_end, self.grid.active_axes))
                    del Uc_end
                    prof.sync(U_new)
                restricted_r, seed_r = self._publish(l, rad_flux, seed_mask, dt_l)
                del rad_flux
                for d in restricted_for_parent:
                    restricted_for_parent[d] = torch.cat([restricted_for_parent[d],
                                                          restricted_r.pop(d)])
                if want_seed:
                    seed_corr = torch.cat([seed_corr, seed_r])

        self.level_U[l] = U_new
        self.level_steps[l] += 1
        self.cell_updates += self._active_cells(l)
        self.cell_updates_raw += self.level_grids[l].num_cells
        if getattr(self, "_substep_valid_flags", None) is not None:
            self._substep_valid_flags.append(torch.isfinite(U_new).all())

        if l < self.finest_level:
            saved = tuple(getattr(self, a, None) for a in (
                "_parent_U_old", "_parent_U_new", "_parent_t", "_parent_dt",
                "_parent_ctx"))
            self._parent_U_old, self._parent_U_new = U_old, U_new
            self._parent_t, self._parent_dt = t_level, dt_l
            if child_pool:
                # the packed child reads the parent's hydro and radiation
                # pads split, at the (2g+2)-deep backdrops' donor width
                from .packed import donor_pad_width

                w = donor_pad_width(self._g)
                ph = self._dense_pad_part("h", w)
                pr = self._dense_pad_part("r", w) if self.layout.radiation_enabled else None
                self._parent_ctx = ("dense", (ph(U_old), ph(U_new),
                                              pr(U_old) if pr else None,
                                              pr(U_new) if pr else None))
            del U_old, U_new
            w = 0.5
            fine_flux_sum = None
            for i in range(2):
                if child_pool:
                    from .packed_driver import timestep_pool_packed

                    timestep_pool_packed(self, l + 1, t_level + i * dt_l * w, dt_l * w)
                else:
                    self._timestep_with_subcycling(l + 1, t_level + i * dt_l * w, dt_l * w)
                ff = self._last_restricted_fluxes
                self._last_restricted_fluxes = None
                if fine_flux_sum is None:
                    fine_flux_sum = {d: w * F for d, F in ff.items()}
                else:
                    fine_flux_sum = {d: fine_flux_sum[d] + w * ff[d] for d in ff}
                del ff
            (self._parent_U_old, self._parent_U_new,
             self._parent_t, self._parent_dt, self._parent_ctx) = saved
            if self.do_reflux:
                with prof.region(f"reflux_L{l}"):
                    if child_pool:
                        self._pool_child_reflux_dense(l, seed_corr, fine_flux_sum, dt_l)
                    else:
                        corr_f = self._reflux_corr(l, fine_flux_sum, seed_mask, dt_l)
                        self._reflux_apply(l, seed_corr, corr_f, seed_mask)
                        del corr_f
                    del seed_corr
                    prof.sync(self.level_U[l])
            with prof.region(f"avgdown_L{l}"):
                if child_pool:
                    from .packed_driver import avgdown_packed_into_dense

                    avgdown_packed_into_dense(self, l)
                else:
                    self._average_down(l)
                prof.sync(self.level_U[l])
        if l > 0:
            self._last_restricted_fluxes = restricted_for_parent

    # ------------------------------------------------------------ diagnostics
    def _active_cells(self, l: int) -> int:
        """Active (mask = True) cells of level l, counted once per regrid."""
        if l == 0:
            return self.level_grids[0].num_cells
        if self._is_pool(l):
            return self.level_pool[l].meta.active_cells
        c = self._active_cell_cache.get(l)
        if c is None:
            c = int(self.level_mask[l].sum())
            self._active_cell_cache[l] = c
        return c

    def _composite_sums(self) -> np.ndarray:
        """Conservation sums over the composite grid, finest data winning:
        each level's uncovered active cells, summed in float64."""
        total = None
        active = self.grid.active_axes
        for l in range(self.finest_level + 1):
            if self._is_pool(l):
                from .packed_driver import packed_level_sums

                part = packed_level_sums(self, l)
            else:
                w = self.level_mask[l]
                if l < self.finest_level:
                    covered = (self.level_pool[l + 1].coverage_dense() if self._is_pool(l + 1)
                               else self.level_mask[l + 1])
                    w = w & torch.logical_not(ops.restrict_mask_any(covered, active))
                part = (torch.where(w[None], self.level_U[l], 0.0)
                        .sum(dim=(1, 2, 3), dtype=torch.float64)
                        * self.level_grids[l].cell_volume())
            total = part if total is None else total + part
        return total.cpu().numpy()

    def _sums(self, U):
        if self.level_U[0] is None:
            return super()._sums(U)
        return self._composite_sums()

    def evolve(self):
        self._fofc_cells_dev = None
        super().evolve()
        if self.elapsed_walltime > 0 and self.cell_updates_raw > 0:
            self.zone_updates_per_second_raw = self.cell_updates_raw / self.elapsed_walltime
            if self.verbose:
                print(f"AMR: finest level {self.finest_level}, active cells per level "
                      f"{[self._active_cells(l) for l in range(self.finest_level + 1)]}; "
                      f"raw figure {self.zone_updates_per_second_raw / 1e6:.3f} "
                      "Mupdates/s (every cell the dense levels advance)")
        else:
            self.zone_updates_per_second_raw = 0.0

    def _after_steps(self):
        if self._fofc_cells_dev is not None:
            self.fofc_cells += int(self._fofc_cells_dev)
            self._fofc_cells_dev = None
