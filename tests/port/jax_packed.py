"""Run the JAX package's packed tile-pool hierarchy and save its levels.

The references of tests/port/test_torch_packed_slice.py, each in a process
of its own beside the port's runs, with XLA:CPU kept from contracting
a*b + c into fused multiply-adds (XLA_FLAGS=--xla_cpu_max_isa=AVX, set by
the caller; why: tests/port/jax_amr_shell.py). Two problems:

- "pulse": the radiating pulse of tests/test_packed_engine.py at N^3 + 1
  packed level of 16^3 tiles, float64, `use_pallas = 0`;
- "bump": the hydro-only Gaussian bump of tests/test_packed_engine.py at
  N^3 + 1 packed level, float32, `hydro.use_pallas = 1` (the root takes the
  seeded lean step, its Pallas kernels interpreted).

Both tag the root's middle half (`amr.n_error_buf = 0`), as
tests/port/packed_problems.py does on the port's side.

    python tests/port/jax_packed.py OUT.npz PROBLEM STEPS N CHUNK [MAX_LEVEL [REGRID]]

(MAX_LEVEL 1 and REGRID, the regrid interval, 2 by default.)

The output holds the root, each packed level's active tiles (ijk) and rows
(Uh, Ur), at the start ("init_") and after the steps, and the FOFC count.
The initial state alone goes to OUT.init.npz (OUT ending in .npz) before
the steps, so that the caller can start its own run meanwhile.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def bump_problem():
    import jax.numpy as jnp
    import numpy as np

    from quokka_tpu.eos import IdealGasEOS
    from quokka_tpu.indices import EGAS, EINT, RHO
    from quokka_tpu.registry import BC_PERIODIC, BCSpec, EOSTraits, PhysicsTraits, Problem

    class PackedBump(Problem):
        """tests/test_packed_engine.py's `_PackedBump`, with the box tagged
        on the root's middle half."""

        name = "packed_bump_port"
        physics = PhysicsTraits(hydro_enabled=True)
        eos_traits = EOSTraits(gamma=1.4, mean_molecular_weight=1.0)
        bcs = BCSpec(x=(BC_PERIODIC, BC_PERIODIC), y=(BC_PERIODIC, BC_PERIODIC),
                     z=(BC_PERIODIC, BC_PERIODIC))

        def make_eos(self):
            return IdealGasEOS(gamma=1.4)

        def set_initial_conditions(self, grid):
            x, y, z = grid.cell_center_mesh(jnp.float32)
            r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
            rho = jnp.broadcast_to(1.0 + 0.6 * jnp.exp(-r2 / 0.01), grid.n_cell)
            eint = jnp.broadcast_to((1.0 + 0.4 * jnp.exp(-r2 / 0.01)) / 0.4, grid.n_cell)
            U = jnp.zeros((6, *grid.n_cell), jnp.float32)
            return U.at[RHO].set(rho).at[EGAS].set(eint).at[EINT].set(eint)

        def error_est(self, sim, level):
            g = sim.level_grids[level]
            n = g.n_cell[0]
            idx = np.arange(n)
            m = (idx >= n // 4) & (idx < 3 * n // 4)
            box = m[:, None, None] & m[None, :, None] & m[None, None, :]
            return jnp.asarray(box) if level == 0 else jnp.zeros(g.n_cell, bool)

        def error_est_local(self, U_padded, grid, level, origin):
            return jnp.zeros(U_padded.shape[1:], bool)

    return PackedBump()


def pulse_problem():
    import jax.numpy as jnp

    from quokka_tpu.indices import EGAS, EINT, RHO
    from quokka_tpu.registry import PhysicsTraits, RadTraits

    base = type(bump_problem())

    class PackedPulse(base):
        """tests/test_packed_engine.py's `_PackedRad`."""

        name = "packed_pulse_port"
        physics = PhysicsTraits(hydro_enabled=True, radiation_enabled=True)
        from quokka_tpu.registry import EOSTraits as _E

        eos_traits = _E(gamma=5.0 / 3.0, mean_molecular_weight=1.0, boltzmann_constant=1.0)
        rad = RadTraits(c_light=1.0e3, c_hat=1.0e2, radiation_constant=1.0,
                        Erad_floor=1e-12, beta_order=1)

        def make_eos(self):
            return self.eos_traits.make_eos()

        def compute_planck_opacity(self, rho, T):
            return jnp.full_like(rho, 10.0)

        def set_radiation_energy_source(self, grid, time):
            x, y, z = grid.cell_center_mesh()
            r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
            return jnp.broadcast_to(0.1 * jnp.exp(-r2 / 0.02), grid.n_cell)

        def set_initial_conditions(self, grid):
            x, y, z = grid.cell_center_mesh()
            shape = grid.n_cell
            layout = self.physics.layout()
            eos = self.make_eos()
            r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
            T = jnp.broadcast_to(1.0 + 0.5 * jnp.exp(-r2 / 0.01), shape)
            eint = eos.eint_from_tgas(1.0, T)
            U = jnp.zeros((layout.nvar, *shape))
            U = U.at[RHO].set(1.0).at[EGAS].set(eint).at[EINT].set(eint)
            return U.at[layout.rad_index(0, 0)].set(1.0 * T**4)

        def error_est_local(self, U_padded, grid, level, origin):
            ts = 16
            n = U_padded.shape[1]
            g = (n - ts) // 2
            lo, hi = grid.n_cell[0] * 3 // 8, grid.n_cell[0] * 5 // 8
            idx = jnp.arange(-g, ts + g)
            m = [(origin[d] + idx >= lo) & (origin[d] + idx < hi) for d in range(3)]
            return m[0][:, None, None] & m[1][None, :, None] & m[2][None, None, :]

    return PackedPulse()


def deck(problem, n, steps, chunk, max_level=1, regrid=2):
    base = f"""
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
    if problem == "pulse":
        return base + """
        radiation.cfl = 0.3
        radiation.max_substeps = 4
        """
    return base


def snapshot(sim, prefix):
    import numpy as np

    out = {f"{prefix}U0": np.asarray(sim.level_U[0])}
    for l in range(1, sim.finest_level + 1):
        st = sim.level_pool[l]
        n = st.meta.n_active
        ts = sim.tile_shape
        out[f"{prefix}ijk{l}"] = np.asarray(st.meta.ijk[:n])
        out[f"{prefix}Uh{l}"] = np.asarray(st.Uh).reshape(st.Uh.shape[0], -1, *ts)[:n]
        if st.Ur is not None:
            out[f"{prefix}Ur{l}"] = np.asarray(st.Ur).reshape(st.Ur.shape[0], -1, *ts)[:n]
    return out


def main(out, problem, steps, n, chunk, max_level=1, regrid=2):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from quokka_tpu import ParmParse
    from quokka_tpu.amr.hierarchy import AMRSimulation

    if problem == "pulse":
        prob, precision, extra = pulse_problem(), "double", """
        hydro.use_pallas = 0
        radiation.use_pallas = 0
        """
    else:
        prob, precision, extra = bump_problem(), "single", "hydro.use_pallas = 1\n"
    sim = AMRSimulation(prob, ParmParse.from_string(deck(problem, n, steps, chunk, max_level, regrid)
                                                    + extra),
                        precision=precision)
    sim.set_initial_conditions()
    init = snapshot(sim, "init_")
    # written whole, then renamed: a reader never sees a partial file
    part = f"{out}.part.npz"
    np.savez(part, **init)
    os.replace(part, out[:-len(".npz")] + ".init.npz")
    sim.fofc_counts = []
    sim.evolve()
    n_fofc = int(sum(int(c) for c in sim.fofc_counts))
    np.savez(part, finest=sim.finest_level, t=sim.t, n_fofc=n_fofc,
             rel_err=np.asarray(sim.conservation_rel_err), **init, **snapshot(sim, ""))
    os.replace(part, out)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    out, problem, steps, n, chunk = sys.argv[1:6]
    max_level = int(sys.argv[6]) if len(sys.argv) > 6 else 1
    regrid = int(sys.argv[7]) if len(sys.argv) > 7 else 2
    main(out, problem, int(steps), int(n), int(chunk), max_level, regrid)
