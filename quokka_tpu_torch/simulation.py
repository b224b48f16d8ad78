"""The unigrid Simulation: state ownership, evolve loop, timestep control.

Counterpart of `quokka_tpu.simulation.Simulation` (reference
``src/simulation.hpp:141`` and ``src/QuokkaSimulation.hpp:64``) for the
hydro and radhydro slices (one or G photon groups): the deck knobs, CFL
timestep with the dt change limiter and the radhydro substep cap, the
hydro retry ladder with the radiation subcycle after each accepted hydro
sub-step, the conservation audit and the performance figure-of-merit
(hydro zone-updates, as the reference counts them). The state lives on the
`device` the caller names, a CUDA device unless the caller asks for the
CPU; there every hydro stage runs through K1-K3 (K1 and K2c, the lean
step, above 272 cells an axis) and every radiation substep through K4 (or
K5 and K6 stage by stage; G groups: K6 over every group and the plain
multigroup coupling).

Deck keys of subsystems the port does not have yet (gravity, cooling,
chemistry, AMR, output, the unported radiation features) raise
NotImplementedError naming the key.
"""

from __future__ import annotations

import time as _time
from typing import Optional

import numpy as np
import torch

from .boundaries import fill_ghosts
from .config import ParmParse
from .grid import Grid
from .hydro import euler
from .hydro.advance import HydroOptions, advance_hydro_rk2
from .indices import EGAS, EINT, MX1, RHO
from .registry import BC_OUTFLOW, BC_PERIODIC, BC_REFLECT, Problem
from .stencil import ghost_widths

NGHOST = 4  # ghost cells of a padded level: PPM + flattening (reference nghost_cc)

# deck key -> predicate on its value that means "this subsystem is on"
_UNPORTED_KEYS = {
    "amr.max_level": lambda v: int(v) > 0,
    "cooling.enabled": lambda v: bool(int(v)),
    "chemistry.enabled": lambda v: bool(int(v)),
    "plotfile_interval": lambda v: int(v) > 0,
    "checkpoint_interval": lambda v: int(v) > 0,
    "projection_interval": lambda v: int(v) > 0,
    "statistics_interval": lambda v: int(v) > 0,
    "ascent_interval": lambda v: int(v) > 0,
    "restartfile": lambda v: bool(str(v)),
    "quokka.diagnostics": lambda v: True,
    "max_walltime": lambda v: bool(str(v)),
    "radiation.wavespeed_correction": lambda v: bool(int(v)),
    "radiation.mixed_precision_coupling": lambda v: bool(int(v)),
    "radiation.dust_gas_interaction_coeff": lambda v: True,
}
_UNPORTED_PREFIXES = ("radiation.", "gravity.", "particles.")
# radiation deck keys the port reads; `use_pallas` is the TPU's kernel
# switch, accepted and without effect (the port always runs its kernels)
_RADIATION_KEYS = {
    "radiation.cfl", "radiation.max_substeps", "radiation.reconstruction_order",
    "radiation.include_work_term", "radiation.fused_substep", "radiation.use_pallas",
    "radiation.opacity_model",
}


class Simulation:
    """Single-level (unigrid) hydro or radhydro simulation on one device."""

    # deck keys of `_UNPORTED_KEYS` that a subclass ports (AMRSimulation)
    _ported_keys: frozenset = frozenset()

    def __init__(self, problem: Problem, pp: Optional[ParmParse] = None, *,
                 device="cuda", precision: str | None = None):
        self.problem = problem
        self.pp = pp or ParmParse()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        self._check_unported_keys()
        phys = problem.physics
        if phys.gravity_enabled or phys.mhd_enabled:
            raise NotImplementedError(
                f"problem {problem.name!r}: gravity and MHD are not ported yet")

        n_cell = self.pp.get_list("amr.n_cell", [64, 1, 1])
        while len(n_cell) < 3:
            n_cell.append(1)
        prob_lo = self.pp.get_list("geometry.prob_lo", [0.0, 0.0, 0.0])
        prob_hi = self.pp.get_list("geometry.prob_hi", [1.0, 1.0, 1.0])
        while len(prob_lo) < 3:
            prob_lo.append(0.0)
        while len(prob_hi) < 3:
            prob_hi.append(1.0)
        self.grid = Grid(tuple(n_cell), tuple(prob_lo), tuple(prob_hi))
        # ghost widths of a padded level (the unigrid path steps ghost-free)
        self.ng = ghost_widths(self.grid, NGHOST)

        prec = precision or self.pp.get_str("precision", "double")
        self.dtype = torch.float64 if prec == "double" else torch.float32

        # runtime knobs (defaults mirror the reference's readParameters,
        # src/simulation.hpp:541-636, and QuokkaSimulation.hpp:340-396)
        self.cfl = self.pp.get_float("cfl", 0.3)
        self.stop_time = self.pp.get_float("stop_time", 1.0)
        self.max_timesteps = self.pp.get_int("max_timesteps", 10000)
        self.init_dt = self.pp.get_float("init_dt", 1.0e30)
        self.max_dt = self.pp.get_float("max_dt", 1.0e30)
        self.constant_dt = self.pp.get_float("constant_dt", -1.0)
        self.verbose = self.pp.get_int("verbose", 1)
        # debug.check_states: validate the state after every step and fail
        # with the first invalid cell (`quokka_tpu/simulation.py:89-93`)
        self.check_states = bool(self.pp.get_int("debug.check_states", 0))

        hpp = self.pp
        self.layout = phys.layout()
        self.eos = problem.make_eos()
        self.periodic = tuple(problem.bcs.is_periodic(d) for d in range(3))
        self.hydro_opts = HydroOptions(
            eos=self.eos,
            active_axes=self.grid.active_axes,
            dx=self.grid.dx,
            reconstruction_order=hpp.get_int("hydro.reconstruction_order", 3),
            use_flattening=bool(hpp.get_int("hydro.use_flattening", 1)),
            reconstruct_eint=problem.hydro.reconstruct_eint,
            riemann="hllc",
            K_visc=hpp.get_float("hydro.artificial_viscosity_coefficient", 0.0),
            n_scalars=phys.n_scalars,
            n_mscalars=phys.n_mscalars,
            density_floor=hpp.get_float("density_floor", 0.0),
            temperature_floor=hpp.get_float("temperature_floor", 0.0),
            use_dual_energy=bool(hpp.get_int("hydro.use_dual_energy", 1)),
            rk_order=hpp.get_int("hydro.rk_integrator_order", 2),
            fuse_update=bool(hpp.get_int("hydro.fuse_update", 1)),
        )
        self._gf = self._ghost_free_config()

        self.U: Optional[torch.Tensor] = None
        self.t = 0.0
        self.dt_prev = float("inf")
        self.istep = 0
        self.cell_updates = 0
        self.cell_updates_raw = 0  # every cell advanced (AMR: inactive ones too)
        self.fofc_cells = 0  # invalid cells that triggered FOFC, summed
        self.fofc_fallbacks = 0  # stages that took the FOFC fallback
        self.error_norm = float("nan")  # against compute_reference_solution
        self.init_sums: Optional[np.ndarray] = None
        self._radiation = None  # attached with the initial conditions
        self._g_ext: Optional[torch.Tensor] = None  # external_acceleration, likewise

    def _check_unported_keys(self):
        for key, vals in self.pp.table.items():
            pred = _UNPORTED_KEYS.get(key)
            if key in self._ported_keys:
                on = False
            elif pred is not None:
                on = pred(vals[0])
            else:
                on = key.startswith(_UNPORTED_PREFIXES) and key not in _RADIATION_KEYS
            if on:
                raise NotImplementedError(
                    f"deck key {key!r} = {vals} selects a subsystem that "
                    "quokka_tpu_torch does not port yet")

    def _ghost_free_config(self):
        """Stepping mode for the hydro advance, as the JAX package's
        `_ghost_free_config` and step builder choose it (`quokka_tpu/
        simulation.py:222-294`, `:444-476`). A float32 state with three
        active axes up to the kernels' extent (1088 cells an axis when the
        lean step may run, else 272) steps ghost-free: {"ng", "bc_kinds",
        "fill"}, bc_kinds[axis] = (lo, hi) for a periodic, reflect or
        outflow wall axis the kernels assemble (None if periodic), and a
        BC_USER (or NSCBC) axis padded by its `ng` through "fill", its
        bc_kinds entry None (the hybrid mode; "fill" None when no axis is
        padded). The port has no sharding: the JAX package's tiles are (1,
        1, 1). Any other state, `hydro.ghost_free = 0`, or a z wall the
        kernels cannot assemble, steps padded (the classic formulation,
        and the plain sweep with fewer than three axes): "fill" pads every
        active axis (nothing on a periodic domain, whose rolls wrap) and
        "bc_kinds" is None."""
        import os

        from .hydro.advance import LEAN_MAX_EXTENT, LEAN_MIN_EXTENT

        opts = self.hydro_opts
        bcs = self.problem.bcs
        lean_ok = (opts.fuse_update and opts.rk_order == 2
                   and os.environ.get("QUOKKA_PALLAS_LEAN", "auto") != "0")
        max_ext = LEAN_MAX_EXTENT if lean_ok else LEAN_MIN_EXTENT
        allowed = (BC_PERIODIC, BC_REFLECT, BC_OUTFLOW)
        if (self.dtype != torch.float32 or len(opts.active_axes) != 3
                or self.pp.get_int("hydro.ghost_free", 1) == 0
                or max(self.grid.n_cell) > max_ext
                or any(k not in allowed for k in bcs.axis(2))):
            if all(self.periodic):
                return {"ng": (0, 0, 0), "bc_kinds": None, "fill": lambda X: X}
            return {"ng": self.ng, "bc_kinds": None, "fill": self._fill}
        ng, kinds = [0, 0, 0], {}
        for d in opts.active_axes:
            lo, hi = bcs.axis(d)
            if lo not in allowed or hi not in allowed:
                ng[d] = self.ng[d]  # a hook-filled axis: conventional padding
                kinds[d] = None
            else:
                kinds[d] = None if self.periodic[d] else (lo, hi)
        ng = tuple(ng)
        fill = None
        if any(ng):
            fill = lambda X: fill_ghosts(X, ng, bcs, self.problem, self.grid)  # noqa: E731
        return {"ng": ng, "bc_kinds": kinds, "fill": fill}

    def _fill(self, U, time: float = 0.0):
        """U padded by `self.ng` with the problem's boundary conditions
        (`quokka_tpu/simulation.py:296-300`); the JAX step calls it at its
        default time 0."""
        return fill_ghosts(U, self.ng, self.problem.bcs, self.problem, self.grid, time)

    # ------------------------------------------------------------------ step
    def _step(self, U, dt):
        """One hydro step of the gas block; stats carry max_signal and valid
        as device tensors. Radiation components belong to the radiation
        subsystem (reference: hydro fluxes cover ncompHydro_ components)."""
        nh = self.layout.nvar_hydro
        gf = self._gf
        Uh_new, stats = advance_hydro_rk2(
            U[:nh], dt, self.hydro_opts, gf["fill"], gf["ng"], self.periodic,
            bc_kinds=gf["bc_kinds"])
        U_new = torch.cat([Uh_new, U[nh:]]) if nh < U.shape[0] else Uh_new
        smax = euler.max_signal_speed(U_new, self.eos).max()
        valid = euler.is_state_valid(U_new, self.eos).all()
        return U_new, {"max_signal": smax, "valid": valid, **stats}

    def _sums(self, U):
        return (U.sum(dim=(1, 2, 3), dtype=torch.float64)
                * self.grid.cell_volume()).cpu().numpy()

    # ------------------------------------------------------------------ setup
    def set_initial_conditions(self):
        U = self.problem.set_initial_conditions(self.grid, dtype=self.dtype,
                                                device=self.device)
        expected = (self.layout.nvar, *self.grid.n_cell)
        if tuple(U.shape) != expected:
            raise ValueError(f"IC shape {tuple(U.shape)} != expected {expected}")
        self.U = U.to(dtype=self.dtype, device=self.device).contiguous()
        self.init_sums = self._sums(self.U)
        g = self.problem.external_acceleration(self.grid, dtype=self.dtype,
                                               device=self.device)
        self._g_ext = None if g is None else torch.as_tensor(
            g, dtype=self.dtype, device=self.device).contiguous()
        if self.layout.radiation_enabled:
            from .radiation.advance import RadiationAdvance

            self._radiation = RadiationAdvance(self)

    # --------------------------------------------------------------- timestep
    def compute_timestep(self) -> float:
        if self.constant_dt > 0.0:
            dt = self.constant_dt
        else:
            if not self.layout.hydro_enabled and self._radiation is not None:
                # radiation-only: the signal speed is the reduced speed of
                # light, and the global `cfl` limits the coarse step
                smax = self.problem.rad.c_hat
            else:
                smax = float(euler.max_signal_speed(self.U, self.eos).max())
            dt = self.cfl * self.grid.dx_min / smax
            if self._radiation is not None:
                # radhydro: cap dt so the subcycle count stays within
                # max_substeps, at the radiation cfl (reference :424-434)
                ropts = self._radiation.opts
                dt = min(dt, ropts.max_substeps * ropts.cfl
                         * self.grid.dx_min / ropts.chat)
            dt = min(dt, 1.1 * self.dt_prev)  # change_max limiter
            dt = min(dt, self.max_dt)
            if self.t == 0.0:
                dt = min(dt, self.init_dt)
        # avoid overshooting stop_time (reference src/simulation.hpp:805-809)
        eps = 1.0e-3 * dt
        if self.t + dt > self.stop_time - eps:
            dt = self.stop_time - self.t
        return dt

    # ----------------------------------------------------------------- evolve
    def advance_single_step(self, dt: float) -> bool:
        """One hydro(+radiation) step with the retry ladder (reference
        `advanceHydroAtLevelWithRetries`, ``src/QuokkaSimulation.hpp:886-990``);
        the radiation subcycles after each accepted hydro sub-step. Returns
        True on success (self.U updated)."""
        rad = self._radiation
        if not self.layout.hydro_enabled and rad is not None:
            self.U = rad.subcycle(self.U, self.t, dt)
            return True
        max_retries = 6
        U_start = self.U
        for retry in range(max_retries + 1):
            nsub = 2**retry
            dt_sub = dt / nsub
            U = U_start
            ok = True
            cells, fallbacks = 0, 0
            for _ in range(nsub):
                U, stats = self._step(U, dt_sub)
                valid, smax, n_fofc = torch.stack([
                    stats["valid"].double(), stats["max_signal"].double(),
                    stats["n_fofc"].double()]).tolist()
                cells += int(n_fofc)
                fallbacks += stats["fofc_fallbacks"]
                dt_cfl = self.cfl * self.grid.dx_min / smax
                if not (valid and not dt_sub > 1.1 * dt_cfl):
                    ok = False
                    break
                if rad is not None:
                    U = rad.subcycle(U, self.t, dt_sub)
            if ok:
                self.U = U
                self.fofc_cells += cells
                self.fofc_fallbacks += fallbacks
                return True
            if self.verbose:
                print(f"\t>> Re-trying hydro advance with reduced timestep "
                      f"(nsubsteps={2*nsub}, dt={dt/(2*nsub):.3e})")
        return False

    def evolve(self):
        from .utils.profiler import prof

        if self.U is None:
            self.set_initial_conditions()
        prof.reset(enabled=bool(self.pp.get_int("profile.enabled", 0)))
        self._sync()
        start_walltime = _time.perf_counter()
        ncells = self.grid.num_cells

        while self.t < self.stop_time * (1.0 - 1e-14) and self.istep < self.max_timesteps:
            self.problem.compute_before_timestep(self)
            with prof.region("computeTimestep"):
                dt = self.compute_timestep()
            if dt <= 0.0:
                break
            if self.verbose:
                print(f"Coarse STEP {self.istep + 1} starts t = {self.t:.6e} dt = {dt:.6e}")
            with prof.region("HydroSolver"):
                ok = self.advance_single_step(dt)
                prof.sync(self.U)
            if not ok:
                raise RuntimeError(
                    f"Hydro update exceeded max_retries at step {self.istep}; cannot continue.")
            if self._g_ext is not None:
                self.U = self._external_kick(self.U, dt)
            if self.check_states:
                self._check_states_valid()
            self.t += dt
            self.dt_prev = dt
            self.istep += 1
            n_upd = self._step_cell_updates()
            self.cell_updates += n_upd
            self.cell_updates_raw += n_upd

        self._sync()
        self._after_steps()
        prof.report()
        elapsed = _time.perf_counter() - start_walltime
        self.elapsed_walltime = elapsed
        # performance FOM (reference src/simulation.hpp:972-980)
        if elapsed > 0 and self.cell_updates > 0:
            mzones = self.cell_updates / elapsed / 1.0e6
            self.zone_updates_per_second = mzones * 1.0e6
            if self.verbose:
                print(f"Performance figure-of-merit: {elapsed/self.cell_updates*1e6:.6f} "
                      f"μs/zone-update [={mzones:.3f} Mupdates/s] on {self.device_name()}")
        else:
            self.zone_updates_per_second = 0.0
        if self.verbose:
            print(f"FOFC: {self.fofc_fallbacks} stage fallbacks, "
                  f"{self.fofc_cells} invalid cells")
        self._conservation_audit()
        self._compute_error_norm()
        self.problem.compute_after_evolve(self)

    def _external_kick(self, U, dt):
        """The operator-split kick of the static external acceleration g
        after the hydro step (`quokka_tpu/simulation.py:628-644`, applied at
        `:1025-1026`): momentum += dt rho g, and the gas energy gains the
        work 0.5 dt g . (mom_old + mom_new); plain torch on the state's
        device."""
        g = self._g_ext
        mom_old = U[MX1:MX1 + 3]
        mom_new = mom_old + dt * U[RHO][None] * g
        work = g * (mom_old + mom_new)
        U = U.clone()
        U[MX1:MX1 + 3] = mom_new
        U[EGAS] = U[EGAS] + 0.5 * dt * ((work[0] + work[1]) + work[2])
        return U

    def _compute_error_norm(self):
        """Relative rms-of-L1 error norm against the problem's reference
        solution (`quokka_tpu/simulation.py:1113-1126`; reference
        `computeAfterEvolve`, ``src/QuokkaSimulation.hpp:620-645``), summed
        in the state's dtype on its device."""
        ref = self.problem.compute_reference_solution(self)
        if ref is None:
            return
        ref = torch.as_tensor(ref, dtype=self.dtype).to(self.U.device)
        resid = ref - self.U
        sol_norm = torch.sqrt(torch.sum(torch.sum(torch.abs(ref), dim=(1, 2, 3)) ** 2))
        err_norm = torch.sqrt(torch.sum(torch.sum(torch.abs(resid), dim=(1, 2, 3)) ** 2))
        self.error_norm = float(err_norm / sol_norm)
        if self.verbose:
            print(f"Relative rms L1 error norm = {self.error_norm:.6e}")

    def _check_states_valid(self):
        """Fail with the first invalid cell: NaN or Inf anywhere, or a
        non-positive density or internal energy in the hydro block
        (`quokka_tpu/simulation.py:869-887`). One host read of the state."""
        U = self.U.cpu().numpy()
        bad = ~np.isfinite(U)
        if self.layout.hydro_enabled:
            bad[RHO] |= U[RHO] <= 0.0
            bad[EINT] |= U[EINT] <= 0.0
        if bad.any():
            comp, i, j, k = (int(ix[0]) for ix in np.where(bad))
            x = self.grid.prob_lo[0] + (i + 0.5) * self.grid.dx[0]
            raise FloatingPointError(
                f"invalid state at step {self.istep}: component {comp} at "
                f"cell ({i},{j},{k}) (x = {x:.6g}) has value "
                f"{U[comp, i, j, k]!r} (debug.check_states = 1)")

    def _step_cell_updates(self) -> int:
        """Zone-updates a coarse step adds to the figure of merit."""
        return self.grid.num_cells

    def _after_steps(self):
        """Read back what the steps kept on the device (nothing here)."""

    def device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return str(self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- diagnostics
    def _conservation_audit(self):
        final = self._sums(self.U)
        init = self.init_sums
        self.conservation_abs_err = final - init
        with np.errstate(divide="ignore", invalid="ignore"):
            self.conservation_rel_err = np.where(init != 0, (final - init) / init, np.nan)
        if self.verbose:
            print(f"\nInitial mass = {init[RHO]:.12e}")
            print(f"Final mass   = {final[RHO]:.12e}")
            print(f"Initial gas energy = {init[EGAS]:.12e}")
            print(f"Final gas energy   = {final[EGAS]:.12e}")
            if init[EGAS] != 0:
                print(f"\trelative conservation error = "
                      f"{(final[EGAS] - init[EGAS]) / init[EGAS]:.3e}\n")
