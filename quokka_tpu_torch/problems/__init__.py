"""Problem catalog of the port (registered by name, like `quokka_tpu.problems`)."""

from .mhd import BrioWuProblem, CPAlfvenWaveProblem, FieldLoopProblem, OrszagTangProblem
from .radhydro_bench import RadhydroBenchProblem
from .radhydro_shell import RadhydroShellProblem
from .sedov import SedovProblem

__all__ = ["BrioWuProblem", "CPAlfvenWaveProblem", "FieldLoopProblem",
           "OrszagTangProblem", "RadhydroBenchProblem", "RadhydroShellProblem",
           "SedovProblem"]
