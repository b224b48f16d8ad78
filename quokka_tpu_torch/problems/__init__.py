"""Problem catalog of the port (registered by name, like `quokka_tpu.problems`)."""

from .hydro_suite import (Blast2DProblem, HighMachProblem, HydroContactProblem,
                          HydroVacuumProblem, QuirkProblem, RichtmeyerMeshkovProblem,
                          ShuOsherProblem, SlowMovingShockProblem)
from .mhd import BrioWuProblem, CPAlfvenWaveProblem, FieldLoopProblem, OrszagTangProblem
from .radhydro_bench import RadhydroBenchProblem
from .radhydro_shell import RadhydroShellProblem
from .sedov import SedovProblem
from .shock_cloud import ShockCloudProblem
from .shocktube import ShocktubeProblem

__all__ = ["Blast2DProblem", "BrioWuProblem", "CPAlfvenWaveProblem", "FieldLoopProblem",
           "HighMachProblem", "HydroContactProblem", "HydroVacuumProblem",
           "OrszagTangProblem", "QuirkProblem", "RadhydroBenchProblem",
           "RadhydroShellProblem", "RichtmeyerMeshkovProblem", "SedovProblem",
           "ShockCloudProblem", "ShocktubeProblem", "ShuOsherProblem",
           "SlowMovingShockProblem"]
