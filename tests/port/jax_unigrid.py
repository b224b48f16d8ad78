"""Run a unigrid deck of the JAX package and save its state.

A reference of tests/port/test_torch_plm.py, in a process of its own so
that it runs beside the port's and so that the float64 run keeps XLA:CPU
from contracting a*b + c into fused multiply-adds
(XLA_FLAGS=--xla_cpu_max_isa=AVX; why: jax_amr_shell.py).

    python tests/port/jax_unigrid.py OUT.npz PROBLEM DECK_FILE
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main(out, problem, deck_file):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from quokka_tpu import ParmParse, Simulation
    from quokka_tpu.registry import get_problem

    import quokka_tpu.problems  # noqa: F401  (registers the catalog)

    with open(deck_file) as f:
        pp = ParmParse.from_string(f.read())
    sim = Simulation(get_problem(problem)(), pp)
    sim.set_initial_conditions()
    U0 = np.asarray(sim.U)
    sim.evolve()
    # written whole, then renamed: a reader never sees a partial file
    part = f"{out}.part.npz"
    np.savez(part, U0=U0, U=np.asarray(sim.U), t=sim.t, istep=sim.istep)
    os.replace(part, out)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main(*sys.argv[1:4])
