"""Benchmark runners: an asynchronous step loop with dt computed on the device
(hydro), a fixed-dt radhydro loop, the MHD windowed loop, and the dense
AMR shell's coarse steps.

Counterpart of `quokka_tpu.benchmarks.build_step_runner` / `bench_hydro` /
`bench_radhydro` and of the JAX package's `bench.py:run_mhd` and
`bench.py:run_amr_shell`.
The reference's FOM is million zone-updates/s printed by `evolve()`
(``src/simulation.hpp:972-980``). Here the host only launches steps: the CFL
dt = cfl * dx_min / max(|v| + cs), with the 1.1x change limiter, stays a
device tensor, and K3 reads it from device memory. The FOFC check of each
RK stage still reads one flag back to the host (two syncs a step).
"""

from __future__ import annotations

import time

import torch

from .hydro import euler
from .hydro.advance import advance_hydro_rk2


def build_step_runner(sim):
    """`step(U, dt_prev) -> (U_new, dt_used)` for the Simulation's config,
    with dt a device tensor."""
    opts = sim.hydro_opts
    gf = sim._ghost_free_config()
    cfl, dx_min = sim.cfl, sim.grid.dx_min

    def step(U, dt_prev):
        smax = euler.max_signal_speed(U, opts.eos).max()
        dt = torch.minimum(cfl * dx_min / smax, 1.1 * dt_prev)
        U_new, _stats = advance_hydro_rk2(U, dt, opts, gf["fill"], gf["ng"],
                                          sim.periodic, bc_kinds=gf["bc_kinds"])
        return U_new, dt

    return step


def _sync(U):
    if U.is_cuda:
        torch.cuda.synchronize(U.device)


def bench_hydro(sim, n_warmup: int = 2, n_steps: int = 10, dt_init: float = 1e-8):
    """Time `n_steps` steps after `n_warmup`; returns (Mzones_per_sec, s)."""
    if sim.U is None:
        sim.set_initial_conditions()
    step = build_step_runner(sim)
    U = sim.U
    dt = torch.tensor(dt_init, dtype=U.dtype, device=U.device)
    for _ in range(n_warmup):
        U, dt = step(U, dt)
    _sync(U)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        U, dt = step(U, dt)
    _sync(U)
    elapsed = time.perf_counter() - t0
    return sim.grid.num_cells * n_steps / elapsed / 1e6, elapsed


def build_radhydro_step(sim, dt: float):
    """`step(U, t) -> U_new` of one radhydro step at the fixed `dt`: the
    hydro advance of the gas block, then the radiation subcycle with the
    substep count fixed with dt. Returns (step, nsub)."""
    rad = sim._radiation
    opts = sim.hydro_opts
    gf = sim._ghost_free_config()
    nh = sim.layout.nvar_hydro
    nsub = rad.n_substeps(dt)
    dt_rad = dt / nsub

    def step(U, t):
        Uh, _stats = advance_hydro_rk2(U[:nh], dt, opts, None, gf["ng"],
                                       sim.periodic, bc_kinds=gf["bc_kinds"])
        U = torch.cat([Uh, U[nh:]])
        for i in range(nsub):
            U = rad.substep(U, t + i * dt_rad, dt_rad)
        return U

    return step, nsub


def bench_radhydro(sim, n_warmup: int = 1, n_steps: int = 5):
    """Time full radhydro steps at the fixed dt of the initial state
    (`build_radhydro_step`). Returns (Mzones_per_sec, s, nsub); the FOM
    counts hydro zone-updates, as the reference does (radiation substeps
    are extra work per zone-update, reference ``src/simulation.hpp:972-980``)."""
    if sim.U is None:
        sim.set_initial_conditions()
    dt = sim.compute_timestep()
    step, nsub = build_radhydro_step(sim, dt)
    U, t = sim.U, 0.0
    for _ in range(n_warmup):
        U = step(U, t)
        t += dt
    _sync(U)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        U = step(U, t)
        t += dt
    _sync(U)
    elapsed = time.perf_counter() - t0
    return sim.grid.num_cells * n_steps / elapsed / 1e6, elapsed, nsub


def bench_mhd(sim, n_warmup: int = 2, n_steps: int = 10):
    """Time `n_steps` MHD steps of `sim.evolve()` after `n_warmup`, as the
    JAX package's bench does (`bench.py:run_mhd`): warm up, run the timed
    window lengths once, restore the state, then time them. With
    `verbose = 0` that is the windowed loop. Returns (Mzone-updates/s, s)."""
    if sim.U is None:
        sim.set_initial_conditions()
    sim.max_timesteps = sim.istep + n_warmup
    sim.evolve()
    sim.max_timesteps = sim.istep + n_steps
    save = (sim.U, sim.Bf, sim.t, sim.istep, sim.cell_updates, list(sim.dts))
    sim.evolve()
    sim.U, sim.Bf, sim.t, sim.istep, sim.cell_updates, sim.dts = save
    n0 = sim.cell_updates
    sim._sync()
    t0 = time.perf_counter()
    sim.evolve()
    elapsed = time.perf_counter() - t0
    return (sim.cell_updates - n0) / elapsed / 1e6, elapsed


def bench_amr_shell(sim=None, n_warmup: int = 1, n_steps: int = 3, *,
                    sparse: bool = False):
    """Time `n_steps` coarse steps of an `AMRSimulation` after `n_warmup`,
    counted as the JAX package's bench counts them (`bench.py:228-258`):
    `evolve()` for the warm-up steps, then `evolve()` for the timed ones,
    the figure being the active zone-updates of the timed steps over their
    wall time. Returns (active Mzone-updates/s, raw Mzone-updates/s, s):
    the raw figure counts every cell the levels advance (a dense level's
    whole extent, a pool level's tiles). Without `sim`, the radhydro shell
    of the JAX package's `run_amr_shell(sparse=...)` on the card: 256^3 + 1
    dense level (`DECK_256`), or with `sparse` 256^3 + 2 packed pool
    levels (`DECK_256_PACKED`, the reference's AMR benchmark)."""
    if sim is None:
        from .amr import AMRSimulation
        from .config import ParmParse
        from .problems import radhydro_shell

        deck = radhydro_shell.DECK_256_PACKED if sparse else radhydro_shell.DECK_256
        sim = AMRSimulation(radhydro_shell.RadhydroShellProblem(),
                            ParmParse.from_string(deck, ["verbose=0"]))
    if sim.level_U[0] is None:
        sim.set_initial_conditions()
    sim.max_timesteps = sim.istep + n_warmup
    sim.evolve()
    n0, raw0 = sim.cell_updates, sim.cell_updates_raw
    sim.max_timesteps = sim.istep + n_steps
    sim._sync()
    t0 = time.perf_counter()
    sim.evolve()
    elapsed = time.perf_counter() - t0
    return ((sim.cell_updates - n0) / elapsed / 1e6,
            (sim.cell_updates_raw - raw0) / elapsed / 1e6, elapsed)
