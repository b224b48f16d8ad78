"""Run the JAX package's dense AMR radhydro shell and save its levels.

The reference runs of tests/port/test_torch_amr_slice.py, in a process of
their own so that they can run beside the port's and so that the float64
run can keep XLA:CPU from contracting a*b + c into fused multiply-adds
(XLA_FLAGS=--xla_cpu_max_isa=AVX): on the shell's free-streaming cells the
reduced flux |f|^2 = 1 to the last bit, and the rounding of one fused
multiply-add there flips the M1 admissibility test f^2 >= 1 of the
transport (the donor-cell fallback), which moves the face fluxes by O(1).
Without fused multiply-adds each operation rounds on its own, as it does
when JAX runs the same program operation by operation.

    python tests/port/jax_amr_shell.py OUT.npz PRECISION USE_PALLAS STEPS N
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main(out, precision, use_pallas, steps, n):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from quokka_tpu import ParmParse
    from quokka_tpu.amr.hierarchy import AMRSimulation
    from quokka_tpu.problems.radhydro_shell import RadhydroShellProblem

    pp = ParmParse.from_string(shell_deck(n, steps) + f"""
        hydro.use_pallas = {use_pallas}
        radiation.use_pallas = {use_pallas}
        """)
    sim = AMRSimulation(RadhydroShellProblem(), pp, precision=precision)
    sim.set_initial_conditions()
    Us0 = [np.asarray(u) for u in sim.level_U[:sim.finest_level + 1]]
    sim.evolve()
    levels = range(sim.finest_level + 1)
    # written whole, then renamed: a reader never sees a partial file
    part = f"{out}.part.npz"
    np.savez(part, finest=sim.finest_level, t=sim.t, cell_updates=sim.cell_updates,
             rel_err=np.asarray(sim.conservation_rel_err),
             **{f"U{l}": np.asarray(sim.level_U[l]) for l in levels},
             **{f"mask{l}": np.asarray(sim.level_mask[l]) for l in levels},
             **{f"init_U{l}": u for l, u in enumerate(Us0)})
    os.replace(part, out)


def shell_deck(n, steps):
    """The JAX package's dense AMR shell deck (bench.py:192-207) at n^3."""
    return f"""
        geometry.prob_lo = 0.0 0.0 0.0
        geometry.prob_hi = 4.0 4.0 4.0
        amr.n_cell = {n} {n} {n}
        amr.max_level = 1
        amr.n_error_buf = 3
        do_reflux = 1
        do_subcycle = 1
        cfl = 0.3
        radiation.cfl = 0.3
        radiation.max_substeps = 10
        density_floor = 1.0e-8
        max_timesteps = {steps}
        stop_time = 1.0e10
        verbose = 0
        """


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    out, precision, use_pallas, steps, n = sys.argv[1:6]
    main(out, precision, int(use_pallas), int(steps), int(n))
