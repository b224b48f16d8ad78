"""Problem catalog of the port (registered by name, like `quokka_tpu.problems`)."""

from .hydro_suite import (Blast2DProblem, HighMachProblem, HydroContactProblem,
                          HydroVacuumProblem, QuirkProblem, RichtmeyerMeshkovProblem,
                          ShuOsherProblem, SlowMovingShockProblem)
from .infrastructure import PassiveScalarProblem, ShocktubeCMAProblem
from .mhd import BrioWuProblem, CPAlfvenWaveProblem, FieldLoopProblem, OrszagTangProblem
from .radhydro_bench import RadhydroBenchProblem
from .radhydro_shell import RadhydroShellProblem
from .rayleigh_taylor import RayleighTaylor2DProblem, RayleighTaylor3DProblem
from .sedov import SedovProblem
from .shock_cloud import ShockCloudProblem
from .shocktube import ShocktubeProblem

__all__ = ["Blast2DProblem", "BrioWuProblem", "CPAlfvenWaveProblem", "FieldLoopProblem",
           "HighMachProblem", "HydroContactProblem", "HydroVacuumProblem",
           "OrszagTangProblem", "PassiveScalarProblem", "QuirkProblem",
           "RadhydroBenchProblem", "RadhydroShellProblem", "RayleighTaylor2DProblem",
           "RayleighTaylor3DProblem", "RichtmeyerMeshkovProblem", "SedovProblem",
           "ShockCloudProblem", "ShocktubeCMAProblem", "ShocktubeProblem",
           "ShuOsherProblem", "SlowMovingShockProblem"]
