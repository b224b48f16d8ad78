"""Radiation subcycling: IMEX PD-ARS substeps within a hydro step.

Counterpart of `quokka_tpu.radiation.advance.RadiationAdvance` (reference
`QuokkaSimulation::subcycleRadiationAtLevel`, ``src/QuokkaSimulation.hpp:
1577-1916``) for one level and one device on a periodic box of 1, 2 or 3
active axes, with G >= 1 photon groups. A substep is

  1. the forward-Euler transport predict (fluxes of the old state),
  2. the stage-1 implicit matter coupling (gas advanced by IMEX_a32 dt),
  3. the midpoint-RK2 transport combine (fluxes of the stage-1 state),
  4. the stage-2 implicit matter coupling ((1 - IMEX_a32) dt),

run either as the two fused stage kernels of K4 (`radiation.fused_substep
= 1`, the default, where the JAX package's `fused_ok` holds: one group,
three active axes, an f32 state) or stage by stage (anything else): the
transport divergence (`system.rad_transport_div`: K6 per axis over every
group for an f32 state with three axes), plain-torch predict / combine,
and after each stage the coupling: K5 for one group and an f32 state, the
plain multigroup coupling (`multigroup.add_source_terms_multi_group`, XLA
in the JAX package) for G > 1. A float64 state takes the plain versions of
K6 and K5 on its own device, as the JAX package takes XLA. The number of
substeps is ceil(dt_hydro / (CFL_rad dx / c_hat)) as in the reference
(``:397-406``).

`LevelRadiation` is the radiation of one dense AMR level: the flux-dict
formulation (K7) on the ghost-padded level, whose face fluxes feed the flux
registers.

Not ported (NotImplementedError naming the key or the feature): walls and
user boundaries for radiation, `radiation.wavespeed_correction`,
`radiation.mixed_precision_coupling`, dust, multigroup on AMR levels.
"""

from __future__ import annotations

import math
import weakref

import numpy as np
import torch

from .._numerics import div
from ..registry import BC_PERIODIC, Problem
from .multigroup import add_source_terms_multi_group, check_opacity_model
from .source import source_update, source_update_plain
from .substep import fused_substep
from .system import RadOptions, add_fluxes_rk2, predict_step, rad_transport_div


class _SimRef:
    """`self.sim` through a weak reference: the simulation holds its
    radiation subsystems, so a strong back-reference would make a cycle
    that keeps a dropped simulation's device memory until the next
    `gc.collect()`."""

    @property
    def sim(self):
        return self._sim_ref()

    @sim.setter
    def sim(self, sim):
        self._sim_ref = weakref.ref(sim)


class RadiationAdvance(_SimRef):
    """Per-simulation radiation subsystem (built when the problem has
    `PhysicsTraits.radiation_enabled`)."""

    def __init__(self, sim):
        self.sim = sim
        problem = sim.problem
        rt = problem.rad
        pp = sim.pp
        self.opts = RadOptions(
            c=rt.c_light,
            chat=rt.c_hat,
            arad=rt.radiation_constant,
            erad_floor=rt.Erad_floor,
            beta_order=rt.beta_order,
            reconstruction_order=pp.get_int("radiation.reconstruction_order", 3),
            cfl=pp.get_float("radiation.cfl", 0.3),
            max_substeps=pp.get_int("radiation.max_substeps", 10),
            include_work_term=bool(pp.get_int("radiation.include_work_term", 1)),
            n_groups=problem.physics.n_groups,
            opacity_model=check_opacity_model(
                pp.get_str("radiation.opacity_model", "piecewise_constant")),
        )
        # the deck keys of unported radiation features (wavespeed
        # correction, mixed precision, dust) raise in Simulation
        ism = getattr(problem, "ism", None)
        unsupported = {
            "radiation boundaries other than periodic": not all(
                bc == BC_PERIODIC for d in range(3) for bc in problem.bcs.axis(d)),
            "the dust-gas coupling (radiation/dust.py)": bool(
                getattr(ism, "enable_dust_gas_thermal_coupling_model", False)),
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"radiation: not ported yet: {bad}")
        self.rad_start = sim.layout.rad_start
        self.boundaries = tuple(rt.group_edges) if rt.group_edges else (0.0, math.inf)
        # K4 where the JAX package's `fused_ok` holds (`quokka_tpu/radiation/
        # advance.py:288-300`): one group, three active axes, periodic walls
        self.fused = (bool(pp.get_int("radiation.fused_substep", 1))
                      and self.opts.n_groups == 1 and sim.grid.active_axes == (0, 1, 2))
        # the default hook's zero source is passed as "no source"
        self._has_src = (type(problem).set_radiation_energy_source
                         is not Problem.set_radiation_energy_source)

    def _rad_src(self, time: float, U: torch.Tensor):
        """The problem's radiation energy source: [X, Y, Z] for one group,
        [G, X, Y, Z] for G (a 3D source split evenly among the groups,
        `quokka_tpu/radiation/advance.py:246-254`); None without a hook."""
        if not self._has_src:
            return None
        src = self.sim.problem.set_radiation_energy_source(
            self.sim.grid, time, dtype=U.dtype, device=U.device)
        src = torch.as_tensor(src, dtype=U.dtype, device=U.device)
        G = self.opts.n_groups
        if G > 1 and src.dim() == 3:
            src = div(src[None].expand(G, *src.shape), G)
        return src.contiguous()

    def _coupling(self, U):
        """The matter coupling of a stage, as the JAX package's
        `source_update` picks it (`quokka_tpu/radiation/advance.py:
        198-243`): the plain multigroup coupling for G > 1 (XLA there); K5
        for one group and a float32 state; its plain version for any other
        dtype, on the state's own device."""
        if self.opts.n_groups > 1:
            sim = self.sim
            kB = sim.problem.eos_traits.boltzmann_constant

            def multigroup(U, rad_src, dt, stage, opts, eos, problem, rs):
                return add_source_terms_multi_group(U, rad_src, dt, stage, opts, eos,
                                                    problem, rs, self.boundaries, kB)[0]
            return multigroup
        return source_update if U.dtype == torch.float32 else source_update_plain

    def substep_core(self, U, rad_src, dt: float):
        """One substep stage by stage (`radiation.fused_substep = 0`, G > 1,
        fewer than three axes, float64)."""
        sim, opts, rs = self.sim, self.opts, self.rad_start
        eos, problem = sim.eos, sim.problem
        dx, active = sim.grid.dx, sim.grid.active_axes
        G = opts.n_groups
        shape = U.shape[1:]
        coupling = self._coupling(U)
        R0 = U[rs:].reshape(G, 4, *shape)
        divF0 = rad_transport_div(U, rs, opts, active, dx)
        R1 = predict_step(R0, divF0, dt, opts)
        U1 = torch.cat([U[:rs], R1.reshape(4 * G, *shape)])
        U1 = coupling(U1, rad_src, dt, 1, opts, eos, problem, rs)
        divF1 = rad_transport_div(U1, rs, opts, active, dx)
        R_new = add_fluxes_rk2(R0, U1[rs:].reshape(G, 4, *shape), divF0, divF1, dt, opts)
        U2 = torch.cat([U1[:rs], R_new.reshape(4 * G, *shape)])
        return coupling(U2, rad_src, dt, 2, opts, eos, problem, rs)

    def substep(self, U, time: float, dt: float):
        """One radiation substep of length `dt` starting at `time`."""
        if U.dtype == torch.float32:
            # the JAX package turns dt into a state-dtype scalar
            dt = float(np.float32(dt))
        rad_src = self._rad_src(time, U)
        if self.fused and U.dtype == torch.float32:
            sim = self.sim
            return fused_substep(U, rad_src, dt, self.opts, sim.eos, sim.problem,
                                 sim.grid.dx)
        return self.substep_core(U, rad_src, dt)

    def n_substeps(self, dt_hydro: float) -> int:
        """ceil(dt_hydro / (CFL_rad dx_min / c_hat)), at most max_substeps+1
        (reference computeNumberOfRadiationSubsteps)."""
        sim = self.sim
        if sim.constant_dt > 0.0:
            return 1
        dt_rad = self.opts.cfl * sim.grid.dx_min / self.opts.chat
        n = max(1, int(math.ceil(dt_hydro / dt_rad)))
        if n > self.opts.max_substeps + 1:
            raise RuntimeError(
                f"radiation substeps {n} exceeds max_substeps={self.opts.max_substeps}")
        return n

    def subcycle(self, U, time: float, dt_hydro: float):
        """Advance the radiation (and its coupling to the gas) by dt_hydro."""
        nsub = self.n_substeps(dt_hydro)
        dt_rad = dt_hydro / nsub
        t = time
        for _ in range(nsub):
            U = self.substep(U, t, dt_rad)
            t = t + dt_rad
        return U


def _scalar(x: float, dtype: torch.dtype) -> float:
    """`x` rounded to the state's dtype, as `jnp.asarray(x, dtype)` rounds a
    Python float."""
    return float(np.float32(x)) if dtype == torch.float32 else float(x)


class LevelRadiation(_SimRef):
    """Radiation subcycling of one dense AMR level.

    Counterpart of `quokka_tpu.radiation.advance.LevelRadiation` (reference
    `QuokkaSimulation::subcycleRadiationAtLevel`, ``src/QuokkaSimulation.hpp:
    1577-1650``): the flux-dict transport formulation (kernel K7 per axis
    and stage, `compute_rad_fluxes`) on the ghost-padded radiation block,
    so that the time-averaged face fluxes can feed the parent's flux
    register, and K5 for the matter coupling. Fine levels fill their ghosts
    and inactive cells from the parent, interpolated in space (lincc
    prolongation) and in time: stage 1 of a substep at its start time, stage
    2 at its end.

    The root streams its fluxes into the flux register as it makes them
    (`subcycle(flux_reduce=...)`, each stage's faces with weight 0.5/nsub),
    as the JAX package's dense root does; the summed flux dict of a fine
    level is accumulated in place. Walls and user boundaries (the JAX
    package's full-state fill) and multigroup raise NotImplementedError."""

    def __init__(self, sim, level: int, grid):
        from ..registry import BC_USER

        self.sim = sim
        self.level = level
        self.grid = grid
        if getattr(sim, "_radiation", None) is None:
            raise RuntimeError("LevelRadiation requires the base RadiationAdvance")
        self.opts = sim._radiation.opts
        self.rad_start = sim.layout.rad_start
        problem = sim.problem
        if any(BC_USER in problem.bcs.axis(d) for d in range(3)):
            raise NotImplementedError("LevelRadiation: user boundaries (the "
                                      "full-state level fill) are not ported yet")
        if self.opts.n_groups != 1:
            raise NotImplementedError("LevelRadiation: multigroup is not ported yet")
        self._has_src = (type(problem).set_radiation_energy_source
                         is not Problem.set_radiation_energy_source)

    # ------------------------------------------------------------------ fills
    def _pad(self, R):
        from ..boundaries import fill_ghosts

        return fill_ghosts(R, self.sim.ng, self.sim.problem.bcs)

    def _fill0(self, U):
        return self._pad(U[self.rad_start:])

    def _fill_fine(self, U, mask, Uc_old, Uc_new, theta):
        """Radiation block of the level, with the parent's data interpolated
        at `theta` (a 0-d tensor of the state's dtype) in the inactive cells
        and the ghosts."""
        from ..amr import operators as amr_ops

        rs = self.rad_start
        Uc_r = (1.0 - theta) * Uc_old[rs:] + theta * Uc_new[rs:]
        base = torch.where(mask[None], U[rs:],
                           amr_ops.prolong(Uc_r, self.grid.active_axes))
        del Uc_r
        return self._pad(base)

    # ---------------------------------------------------------------- substep
    def _rad_src(self, time: float, U):
        if not self._has_src:
            return None
        src = self.sim.problem.set_radiation_energy_source(
            self.grid, time, dtype=U.dtype, device=U.device)
        return torch.as_tensor(src, dtype=U.dtype, device=U.device).contiguous()

    def substep_core(self, U, fills, time: float, dt: float, reduce=None):
        """One substep (`LevelRadiation.substep_core` of the JAX package):
        transport predict from the fluxes of the filled state, stage-1
        coupling, transport combine, stage-2 coupling. `fills` gives the
        stage-1 and stage-2 fills. Returns (U, eff) with eff the substep's
        effective transport flux {axis: [4G, padded X, Y, Z]}, 0.5 (F0 + F1);
        with `reduce` each stage's fluxes go to reduce(F) as soon as they
        exist, and eff is None."""
        from ..stencil import interior
        from .system import compute_rad_fluxes, rad_div_fluxes

        sim, opts, rs = self.sim, self.opts, self.rad_start
        G = opts.n_groups
        shape = U.shape[1:]
        ng, dx, active = sim.ng, self.grid.dx, self.grid.active_axes
        dt = _scalar(dt, U.dtype)
        rad_src = self._rad_src(_scalar(time, U.dtype), U)
        # K5 for a float32 state, the plain version for any other dtype
        # (`quokka_tpu/radiation/advance.py:457`)
        coupling = source_update if U.dtype == torch.float32 else source_update_plain

        def flat(F):
            return {d: Fd.reshape(4 * G, *Fd.shape[2:]) for d, Fd in F.items()}

        Ug0 = fills[0](U)
        fluxes0 = compute_rad_fluxes(Ug0, 0, opts, active, dx)
        del Ug0
        divF0 = interior(rad_div_fluxes(fluxes0, dx), ng)
        if reduce is not None:
            reduce(flat(fluxes0))
            fluxes0 = None
        R0 = U[rs:].reshape(G, 4, *shape)
        R1 = predict_step(R0, divF0, dt, opts)
        U1 = torch.cat([U[:rs], R1.reshape(4 * G, *shape)])
        del R1
        U1 = coupling(U1, rad_src, dt, 1, opts, sim.eos, sim.problem, rs)

        Ug1 = fills[1](U1)
        fluxes1 = compute_rad_fluxes(Ug1, 0, opts, active, dx)
        del Ug1
        divF1 = interior(rad_div_fluxes(fluxes1, dx), ng)
        R_new = add_fluxes_rk2(R0, U1[rs:].reshape(G, 4, *shape), divF0, divF1, dt, opts)
        del divF0, divF1
        U2 = torch.cat([U1[:rs], R_new.reshape(4 * G, *shape)])
        del U1, R_new
        U2 = coupling(U2, rad_src, dt, 2, opts, sim.eos, sim.problem, rs)
        if reduce is not None:
            reduce(flat(fluxes1))
            return U2, None
        # eff = 0.5 (F0 + F1), formed in F0's buffers
        eff = {}
        for d in list(fluxes0):
            F0 = fluxes0.pop(d)
            eff[d] = F0.add_(fluxes1.pop(d)).mul_(0.5)
        return U2, flat(eff)

    def n_substeps(self, dt_level: float) -> int:
        sim = self.sim
        if not sim.layout.hydro_enabled or sim.constant_dt > 0.0:
            return 1
        dt_rad = self.opts.cfl * self.grid.dx_min / self.opts.chat
        n = max(1, int(math.ceil(dt_level / dt_rad)))
        if n > self.opts.max_substeps + 1:
            raise RuntimeError(
                f"radiation substeps {n} exceeds max_substeps={self.opts.max_substeps}")
        return n

    def subcycle(self, U, time: float, dt_level: float, mask=None, Uc_old=None,
                 Uc_new=None, theta_bounds=None, flux_reduce=None):
        """Advance the level's radiation by dt_level. Returns (U, flux_sum):
        the time-averaged transport flux dict {axis: [4G, padded X, Y, Z]},
        or None with `flux_reduce(F, weight)`, the streaming consumer of the
        root (each stage's fluxes, weight 0.5/nsub)."""
        nsub = self.n_substeps(dt_level)
        dt_r = dt_level / nsub
        flux_sum = None
        for i in range(nsub):
            t_i = time + i * dt_r
            if self.level == 0:
                fills = (self._fill0, self._fill0)
                if flux_reduce is not None:
                    U, _ = self.substep_core(U, fills, t_i, dt_r,
                                             reduce=lambda F: flux_reduce(F, 0.5 / nsub))
                    continue
            else:
                if flux_reduce is not None:
                    raise NotImplementedError("flux_reduce streams the root's fluxes only")
                th0, th1 = theta_bounds
                th = [torch.tensor(th0 + (th1 - th0) * (k / nsub), dtype=U.dtype,
                                   device=U.device) for k in (i, i + 1)]
                fills = tuple(
                    (lambda Uf, t=t: self._fill_fine(Uf, mask, Uc_old, Uc_new, t))
                    for t in th)
            U, eff = self.substep_core(U, fills, t_i, dt_r)
            # flux_sum += eff / nsub, in place (the same rounding)
            w = torch.full((), nsub, dtype=U.dtype, device=U.device)
            if flux_sum is None:
                flux_sum = {d: F.div_(w) for d, F in eff.items()}
            else:
                for d in flux_sum:
                    flux_sum[d].add_(eff.pop(d).div_(w))
            del eff
        return U, flux_sum

