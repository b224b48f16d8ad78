"""Sedov-Taylor point blast (reference
``src/problems/HydroBlast3D/test_hydro3d_blast.cpp``), the hydro
weak-scaling benchmark (``decks/benchmark_unigrid_256.in``).

Octant-symmetry setup (Klein & Bolstad parameters, via Kamm & Timmes
LA-UR-07-2849): domain [0, 1.2]^3, rho=1, E_blast=0.851072/8 deposited in
the corner cell, reflecting boundaries, gamma=1.4, PPM,
reconstruct_eint=false.
"""

from __future__ import annotations

import torch

from ..indices import EGAS, EINT, RHO
from ..registry import (
    BC_REFLECT,
    BCSpec,
    EOSTraits,
    HydroTraits,
    PhysicsTraits,
    Problem,
    register_problem,
)


# The JAX package's 512^3 hydro leg (bench.py:76-84, run_hydro(512, ...,
# "single")): the 256^3 deck's problem at 512^3, f32. Above 272 cells an
# axis its steps take the lean branch (hydro/advance.py:_branch).
DECK_512 = """
geometry.prob_lo = 0.0 0.0 0.0
geometry.prob_hi = 1.2 1.2 1.2
amr.n_cell = 512 512 512
cfl = 0.3
hydro.reconstruction_order = 3
precision = single
verbose = 0
"""


@register_problem
class SedovProblem(Problem):
    name = "HydroBlast3D"
    physics = PhysicsTraits(hydro_enabled=True)
    eos_traits = EOSTraits(gamma=1.4)
    hydro = HydroTraits(reconstruct_eint=False)
    bcs = BCSpec(
        x=(BC_REFLECT, BC_REFLECT),
        y=(BC_REFLECT, BC_REFLECT),
        z=(BC_REFLECT, BC_REFLECT),
    )

    rho0 = 1.0
    E_blast_total = 0.851072  # full-sphere blast energy (ergs)

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        """Built directly on `device`; each value is a double rounded once
        to `dtype`, as the JAX package's f64-then-cast IC is."""
        cell_vol = grid.cell_volume()
        E_blast = self.E_blast_total / 8.0  # octant symmetry
        U = torch.zeros((6, *grid.n_cell), dtype=dtype, device=device)
        U[RHO] = self.rho0
        U[EGAS] = 1.0e-10 * E_blast / cell_vol  # all energy internal (v = 0)
        U[EGAS, 0, 0, 0] = E_blast / cell_vol
        U[EINT] = U[EGAS]
        return U
