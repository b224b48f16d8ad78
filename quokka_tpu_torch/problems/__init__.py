"""Problem catalog of the port (registered by name, like `quokka_tpu.problems`)."""

from .hydro_suite import (Blast2DProblem, HighMachProblem, HydroContactProblem,
                          HydroVacuumProblem, QuirkProblem, RichtmeyerMeshkovProblem,
                          ShuOsherProblem, SlowMovingShockProblem)
from .infrastructure import PassiveScalarProblem, ShocktubeCMAProblem
from .mhd import BrioWuProblem, CPAlfvenWaveProblem, FieldLoopProblem, OrszagTangProblem
from .rad_multigroup import RadMultigroupPulseProblem
from .radhydro_bb import RadhydroBBProblem
from .radhydro_bench import RadhydroBenchProblem
from .radhydro_pulse import (RadhydroPulseDynProblem, RadhydroPulseGreyProblem,
                             RadhydroPulseMGconstProblem, RadhydroPulseMGintProblem,
                             RadhydroPulseProblem)
from .radhydro_shell import RadhydroShellProblem
from .rayleigh_taylor import RayleighTaylor2DProblem, RayleighTaylor3DProblem
from .sedov import SedovProblem
from .shock_cloud import ShockCloudProblem
from .shocktube import ShocktubeProblem

__all__ = ["Blast2DProblem", "BrioWuProblem", "CPAlfvenWaveProblem", "FieldLoopProblem",
           "HighMachProblem", "HydroContactProblem", "HydroVacuumProblem",
           "OrszagTangProblem", "PassiveScalarProblem", "QuirkProblem",
           "RadMultigroupPulseProblem", "RadhydroBBProblem", "RadhydroBenchProblem",
           "RadhydroPulseDynProblem", "RadhydroPulseGreyProblem",
           "RadhydroPulseMGconstProblem", "RadhydroPulseMGintProblem",
           "RadhydroPulseProblem", "RadhydroShellProblem", "RayleighTaylor2DProblem",
           "RayleighTaylor3DProblem", "RichtmeyerMeshkovProblem", "SedovProblem",
           "ShockCloudProblem", "ShocktubeCMAProblem", "ShocktubeProblem",
           "ShuOsherProblem", "SlowMovingShockProblem"]
