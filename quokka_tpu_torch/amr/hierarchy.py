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

Not ported (NotImplementedError naming the key): tile-pool levels
(`amr.sparse_min_level`), `amr.pool_packed`, `do_subcycle = 0`, gravity,
particles, Strang-split sources (cooling, chemistry), domain decomposition,
restart, plotfiles and checkpoints; periodic boundaries only.
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
        sparse_min = pp.get_int("amr.sparse_min_level", 10**9)
        if sparse_min <= self.max_level:
            raise NotImplementedError(
                f"deck key 'amr.sparse_min_level' = {sparse_min}: tile-pool levels "
                "are not ported yet (dense levels only)")
        if pp.get_int("amr.pool_packed", 0):
            raise NotImplementedError("deck key 'amr.pool_packed' = 1: the packed pool "
                                      "engine is not ported yet")
        if not self.do_subcycle and self.max_level > 0:
            raise NotImplementedError("deck key 'do_subcycle' = 0: global stepping "
                                      "of the levels is not ported yet")
        if not all(self.periodic):
            raise NotImplementedError("AMRSimulation: only periodic boundaries are "
                                      "ported (the padded level fills)")
        if self.grid.active_axes != (0, 1, 2):
            raise NotImplementedError("AMRSimulation: 3D levels only")
        self.level_grids = [self.grid]
        self.level_opts = [self.hydro_opts]
        for _ in range(self.max_level):
            g = self.level_grids[-1].refine(2)
            self.level_grids.append(g)
            self.level_opts.append(dataclasses.replace(self.hydro_opts, dx=g.dx))
        self.level_U: List[Optional[torch.Tensor]] = [None] * (self.max_level + 1)
        self.level_mask: List[Optional[torch.Tensor]] = [None] * (self.max_level + 1)
        self.level_steps = [0] * (self.max_level + 1)
        self.finest_level = 0
        self._level_rad = {}
        self._active_cell_cache = {}
        self._fofc_cells_dev = None

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
        self.fofc_fallbacks += stats["fofc_fallbacks"]
        n = stats["n_fofc"]
        self._fofc_cells_dev = n if self._fofc_cells_dev is None else self._fofc_cells_dev + n
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
    def _regrid_level(self, l: int) -> bool:
        """(Re)build level l+1 from the error tags of level l. Returns True if
        level l+1 exists afterwards. One host sync: the new level's active
        cell count."""
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
        max_retries = 6
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
        with prof.region(f"hydro_L{l}"):
            U_new, fluxes = self._hydro_step(l, U_old, dt_l, theta)
            prof.sync(U_new)

        # the coarse side of the flux register, at once (the root's
        # radiation part is streamed in below); a fine level publishes its
        # hydro fluxes before the radiation subcycle and its radiation
        # fluxes after it: masking, restriction and seeding act on each
        # component alone, so the parts joined give what the whole would
        want_seed = l < self.finest_level and self.do_reflux
        seed_corr = seed_mask = restricted_for_parent = None
        if want_seed:
            seed_mask = self.level_mask[l + 1]
        if want_seed and l == 0:
            seed_corr = self._reflux_corr(l, fluxes, seed_mask, dt_l)
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
                "_parent_U_old", "_parent_U_new", "_parent_t", "_parent_dt"))
            self._parent_U_old, self._parent_U_new = U_old, U_new
            self._parent_t, self._parent_dt = t_level, dt_l
            del U_old, U_new
            w = 0.5
            fine_flux_sum = None
            for i in range(2):
                self._timestep_with_subcycling(l + 1, t_level + i * dt_l * w, dt_l * w)
                ff = self._last_restricted_fluxes
                self._last_restricted_fluxes = None
                if fine_flux_sum is None:
                    fine_flux_sum = {d: w * F for d, F in ff.items()}
                else:
                    fine_flux_sum = {d: fine_flux_sum[d] + w * ff[d] for d in ff}
                del ff
            (self._parent_U_old, self._parent_U_new,
             self._parent_t, self._parent_dt) = saved
            if self.do_reflux:
                with prof.region(f"reflux_L{l}"):
                    corr_f = self._reflux_corr(l, fine_flux_sum, seed_mask, dt_l)
                    self._reflux_apply(l, seed_corr, corr_f, seed_mask)
                    del corr_f, seed_corr
                    prof.sync(self.level_U[l])
            with prof.region(f"avgdown_L{l}"):
                self._average_down(l)
                prof.sync(self.level_U[l])
        if l > 0:
            self._last_restricted_fluxes = restricted_for_parent

    # ------------------------------------------------------------ diagnostics
    def _active_cells(self, l: int) -> int:
        """Active (mask = True) cells of level l, counted once per regrid."""
        if l == 0:
            return self.level_grids[0].num_cells
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
            w = self.level_mask[l]
            if l < self.finest_level:
                w = w & torch.logical_not(ops.restrict_mask_any(self.level_mask[l + 1],
                                                                active))
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
