"""Dense-level AMR: the inter-level operators and `AMRSimulation`."""

from .hierarchy import AMRSimulation

__all__ = ["AMRSimulation"]
