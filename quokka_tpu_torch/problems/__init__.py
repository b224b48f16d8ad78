"""Problem catalog of the port (registered by name, like `quokka_tpu.problems`)."""

from .radhydro_bench import RadhydroBenchProblem
from .sedov import SedovProblem

__all__ = ["RadhydroBenchProblem", "SedovProblem"]
