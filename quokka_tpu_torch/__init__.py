"""quokka_tpu_torch: the PyTorch + CUDA port of quokka_tpu.

Three unigrid slices. `Simulation` drives the RK2-SSP PPM + HLLC hydro step
with the first-order flux correction (kernels K1-K3; K1 and K2c, the lean
step, above 272 cells an axis) and single-group M1
radiation hydrodynamics with IMEX substeps and the implicit matter coupling
(kernels K4-K6); `MHDSimulation` drives constrained-transport ideal MHD
with HLLD (kernel K8). The kernels are written by hand in CUDA for Hopper
(``csrc/``); their plain PyTorch versions run for tensors on the CPU.

    from quokka_tpu_torch import ParmParse, Simulation
    from quokka_tpu_torch.problems.sedov import SedovProblem
    pp = ParmParse.from_file("decks/benchmark_unigrid_256.in")
    sim = Simulation(SedovProblem(), pp)  # device="cuda" unless told "cpu"
    sim.set_initial_conditions(); sim.evolve()
"""

from .config import ParmParse
from .eos import IdealGasEOS
from .grid import Grid
from .hydro.advance import HydroOptions, advance_hydro_rk2
from .hydro.euler import cons_to_prim
from .mhd import MHDOptions, MHDSimulation
from .radiation.system import RadOptions
from .registry import (BCSpec, PowerLawOpacity, Problem, RadTraits, get_problem,
                       register_problem)
from .simulation import Simulation

__all__ = [
    "BCSpec", "Grid", "HydroOptions", "IdealGasEOS", "MHDOptions", "MHDSimulation",
    "ParmParse", "PowerLawOpacity", "Problem", "RadOptions", "RadTraits", "Simulation",
    "advance_hydro_rk2", "cons_to_prim", "get_problem", "register_problem",
]
