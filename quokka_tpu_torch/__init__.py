"""quokka_tpu_torch: the PyTorch + CUDA port of quokka_tpu.

The unigrid hydro slice: the RK2-SSP PPM + HLLC step with the first-order
flux correction, driven by `Simulation`, with the three hot kernels written
by hand in CUDA for Hopper (``csrc/``). Plain PyTorch versions of the same
kernels run for tensors on the CPU.

    from quokka_tpu_torch import ParmParse, Simulation
    from quokka_tpu_torch.problems.sedov import SedovProblem
    pp = ParmParse.from_file("decks/benchmark_unigrid_256.in")
    sim = Simulation(SedovProblem(), pp, device="cuda")
    sim.set_initial_conditions(); sim.evolve()
"""

from .config import ParmParse
from .eos import IdealGasEOS
from .grid import Grid
from .hydro.advance import HydroOptions, advance_hydro_rk2
from .hydro.euler import cons_to_prim
from .registry import BCSpec, Problem, get_problem, register_problem
from .simulation import Simulation

__all__ = [
    "BCSpec", "Grid", "HydroOptions", "IdealGasEOS", "ParmParse", "Problem",
    "Simulation", "advance_hydro_rk2", "cons_to_prim", "get_problem",
    "register_problem",
]
