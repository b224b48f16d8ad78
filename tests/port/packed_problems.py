"""Problems of the packed-engine tests, on the port's side.

`PackedBump` is tests/test_packed_engine.py's hydro-only Gaussian bump (its
root tagged on the middle half, so level 1 is 2 x 2 x 2 tiles well inside
the domain and the root takes the seeded lean step); `PackedPulse` its
radiating pulse (constant opacity 10 as the power law the CUDA coupling
evaluates). `bump_deck` / `pulse_deck` give their decks at N^3 + 1 packed
level of 16^3 tiles; `tests/port/jax_packed.py` builds the same decks and
problems for the JAX package. `port_sim`, `start_from` and `compare` run
the port's side of a comparison with a JAX reference run's output.
"""

import numpy as np
import torch

from quokka_tpu_torch import ParmParse
from quokka_tpu_torch.amr import AMRSimulation
from quokka_tpu_torch.eos import IdealGasEOS
from quokka_tpu_torch.indices import EGAS, EINT, RHO
from quokka_tpu_torch.interop import amr_hierarchy_to_numpy, load_amr_hierarchy
from quokka_tpu_torch.registry import (BC_PERIODIC, BCSpec, EOSTraits, PhysicsTraits,
                                       PowerLawOpacity, Problem, RadTraits)

PERIODIC = BCSpec(x=(BC_PERIODIC, BC_PERIODIC), y=(BC_PERIODIC, BC_PERIODIC),
                  z=(BC_PERIODIC, BC_PERIODIC))


def _box(sim, level):
    g = sim.level_grids[level]
    n = g.n_cell[0]
    idx = np.arange(n)
    m = (idx >= n // 4) & (idx < 3 * n // 4)
    box = m[:, None, None] & m[None, :, None] & m[None, None, :]
    return torch.as_tensor(box if level == 0 else np.zeros(g.n_cell, bool))


class PackedBump(Problem):
    name = "packed_bump_port"
    physics = PhysicsTraits(hydro_enabled=True)
    eos_traits = EOSTraits(gamma=1.4, mean_molecular_weight=1.0)
    bcs = PERIODIC

    def make_eos(self):
        return IdealGasEOS(gamma=1.4)

    def set_initial_conditions(self, grid, dtype=torch.float32, device="cpu"):
        x, y, z = grid.cell_center_mesh(torch.float32, device)
        r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
        rho = (1.0 + 0.6 * torch.exp(-r2 / 0.01)).expand(grid.n_cell)
        eint = ((1.0 + 0.4 * torch.exp(-r2 / 0.01)) / 0.4).expand(grid.n_cell)
        U = torch.zeros((6, *grid.n_cell), dtype=dtype, device=device)
        U[RHO], U[EGAS], U[EINT] = rho, eint, eint
        return U

    def error_est(self, sim, level):
        return _box(sim, level)

    def error_est_local(self, U_padded, grid, level, origin):
        return torch.zeros((U_padded.shape[0],) + tuple(U_padded.shape[2:]), dtype=torch.bool,
                           device=U_padded.device)


class PackedPulse(Problem):
    """A radiating pulse (tests/test_packed_engine.py `_PackedRad`)."""

    name = "packed_pulse_port"
    physics = PhysicsTraits(hydro_enabled=True, radiation_enabled=True)
    eos_traits = EOSTraits(gamma=5.0 / 3.0, mean_molecular_weight=1.0,
                           boltzmann_constant=1.0)
    rad = RadTraits(c_light=1.0e3, c_hat=1.0e2, radiation_constant=1.0, Erad_floor=1e-12,
                    beta_order=1)
    bcs = PERIODIC
    planck_opacity = PowerLawOpacity(10.0)

    def set_radiation_energy_source(self, grid, time, dtype=torch.float64, device="cpu"):
        x, y, z = grid.cell_center_mesh(torch.float64, device)
        r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
        return (0.1 * torch.exp(-r2 / 0.02)).expand(grid.n_cell).to(dtype)

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cpu"):
        x, y, z = grid.cell_center_mesh(torch.float64, device)
        eos = self.make_eos()
        r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
        T = (1.0 + 0.5 * torch.exp(-r2 / 0.01)).expand(grid.n_cell)
        eint = eos.eint_from_tgas(1.0, T)
        layout = self.physics.layout()
        U = torch.zeros((layout.nvar, *grid.n_cell), dtype=torch.float64, device=device)
        U[RHO] = 1.0
        U[EGAS], U[EINT] = eint, eint
        U[layout.rad_index(0, 0)] = 1.0 * T ** 4
        return U.to(dtype)

    def error_est(self, sim, level):
        return _box(sim, level)

    def error_est_local(self, U_padded, grid, level, origin):
        """Tags the level's cells in [3n/8, 5n/8)^3 of padded tiles
        [c, nvar, X, Y, Z] by their global index (`_PackedRad`'s rule)."""
        ts = 16
        n = U_padded.shape[2]
        g = (n - ts) // 2
        lo, hi = grid.n_cell[0] * 3 // 8, grid.n_cell[0] * 5 // 8
        idx = torch.arange(-g, ts + g, device=U_padded.device)
        m = [(origin[:, d, None] + idx >= lo) & (origin[:, d, None] + idx < hi)
             for d in range(3)]
        return m[0][:, :, None, None] & m[1][:, None, :, None] & m[2][:, None, None, :]


def _deck(n, steps, chunk, max_level=1, regrid=2):
    return f"""
amr.n_cell = {n} {n} {n}
amr.max_level = {max_level}
regrid_interval = {regrid}
amr.sparse_min_level = 1
amr.tile_size = 16 16 16
amr.pool_chunk = {chunk}
amr.pool_packed = 1
amr.packed_chunk = {chunk}
amr.pool_headroom = 1.02
amr.n_error_buf = 0
do_reflux = 1
do_subcycle = 1
cfl = 0.3
max_timesteps = {steps}
stop_time = 1.0e10
verbose = 0
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 1. 1. 1.
"""


def bump_deck(n, steps, chunk):
    return _deck(n, steps, chunk)


def pulse_deck(n, steps, chunk, max_level=1, regrid=2):
    return _deck(n, steps, chunk, max_level, regrid) + """
radiation.cfl = 0.3
radiation.max_substeps = 4
"""


def port_sim(problem, deck, precision):
    """The port's AMRSimulation on the CPU, its initial hierarchy built."""
    sim = AMRSimulation(problem, ParmParse.from_string(deck), device="cpu", precision=precision)
    sim.set_initial_conditions()
    return sim


def start_from(sim, ref):
    """The port's tiles equal the JAX package's; then its hierarchy."""
    mine = amr_hierarchy_to_numpy(sim)
    for l in range(1, sim.finest_level + 1):
        np.testing.assert_array_equal(mine[f"ijk{l}"], ref[f"init_ijk{l}"])
    load_amr_hierarchy(sim, ref, prefix="init_")


def compare(sim, ref, bounds):
    """Every level of `sim` against the reference: equal tile sets; each
    component within bounds[component] (the radiation rows' components
    numbered from 6; the last bound for the rest) of its max."""
    got = amr_hierarchy_to_numpy(sim)
    assert sim.finest_level == int(ref["finest"])
    for key in ref:
        if key.startswith("ijk"):
            np.testing.assert_array_equal(got[key], ref[key])
    for key in [k for k in ref if k[:2] in ("U0", "Uh", "Ur")]:
        a, b = got[key].astype(np.float64), ref[key].astype(np.float64)
        assert a.shape == b.shape and np.all(np.isfinite(a)), key
        axis = 0 if key == "U0" else 1
        off = 6 if key.startswith("Ur") else 0
        for c in range(b.shape[axis]):
            ac, bc = np.take(a, c, axis), np.take(b, c, axis)
            scale = np.abs(bc).max()
            bound = bounds[min(off + c, len(bounds) - 1)]
            assert np.abs(ac - bc).max() <= bound * scale, (key, c, np.abs(ac - bc).max() / scale)
