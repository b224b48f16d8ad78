"""Radiation subcycling: IMEX PD-ARS substeps within a hydro step.

Counterpart of `quokka_tpu.radiation.advance.RadiationAdvance` (reference
`QuokkaSimulation::subcycleRadiationAtLevel`, ``src/QuokkaSimulation.hpp:
1577-1916``) for one level, one device and one photon group on a periodic
box. A substep is

  1. the forward-Euler transport predict (fluxes of the old state),
  2. the stage-1 implicit matter coupling (gas advanced by IMEX_a32 dt),
  3. the midpoint-RK2 transport combine (fluxes of the stage-1 state),
  4. the stage-2 implicit matter coupling ((1 - IMEX_a32) dt),

run either as the two fused stage kernels of K4 (`radiation.fused_substep
= 1`, the default, for an f32 state) or stage by stage (`= 0`): K6 three
times per transport evaluation, plain-torch predict / combine, K5 after
each stage. The number of substeps is ceil(dt_hydro / (CFL_rad dx /
c_hat)) as in the reference (``:397-406``).

Not ported (NotImplementedError naming the key or the feature): walls and
user boundaries for radiation, `radiation.wavespeed_correction`,
`radiation.mixed_precision_coupling`, multigroup, dust, AMR levels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..registry import BC_PERIODIC, Problem
from .source import source_update
from .substep import fused_substep
from .system import RadOptions, add_fluxes_rk2, predict_step, rad_transport_div


class RadiationAdvance:
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
        )
        # the deck keys of unported radiation features (wavespeed
        # correction, mixed precision, multigroup, dust) raise in Simulation
        unsupported = {
            "radiation boundaries other than periodic": not all(
                bc == BC_PERIODIC for d in range(3) for bc in problem.bcs.axis(d)),
            "fewer than 3 active axes": sim.grid.active_axes != (0, 1, 2),
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"radiation: not ported yet: {bad}")
        self.rad_start = sim.layout.rad_start
        self.fused = bool(pp.get_int("radiation.fused_substep", 1))
        # the default hook's zero source is passed as "no source"
        self._has_src = (type(problem).set_radiation_energy_source
                         is not Problem.set_radiation_energy_source)

    def _rad_src(self, time: float, U: torch.Tensor):
        if not self._has_src:
            return None
        src = self.sim.problem.set_radiation_energy_source(
            self.sim.grid, time, dtype=U.dtype, device=U.device)
        return torch.as_tensor(src, dtype=U.dtype, device=U.device).contiguous()

    def substep_core(self, U, rad_src, dt: float):
        """One substep stage by stage (`radiation.fused_substep = 0`)."""
        sim, opts, rs = self.sim, self.opts, self.rad_start
        eos, problem = sim.eos, sim.problem
        dx, active = sim.grid.dx, sim.grid.active_axes
        shape = U.shape[1:]
        R0 = U[rs:].reshape(1, 4, *shape)
        divF0 = rad_transport_div(U, rs, opts, active, dx)
        R1 = predict_step(R0, divF0, dt, opts)
        U1 = torch.cat([U[:rs], R1.reshape(4, *shape)])
        U1 = source_update(U1, rad_src, dt, 1, opts, eos, problem, rs)
        divF1 = rad_transport_div(U1, rs, opts, active, dx)
        R_new = add_fluxes_rk2(R0, U1[rs:].reshape(1, 4, *shape), divF0, divF1, dt, opts)
        U2 = torch.cat([U1[:rs], R_new.reshape(4, *shape)])
        return source_update(U2, rad_src, dt, 2, opts, eos, problem, rs)

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
