"""Problem catalog of the port (registered by name, like `quokka_tpu.problems`)."""

from .sedov import SedovProblem

__all__ = ["SedovProblem"]
