from .advance import MHDOptions, advance_mhd_rk2, b_cell_from_faces, div_b
from .simulation import MHDSimulation

__all__ = ["MHDOptions", "MHDSimulation", "advance_mhd_rk2", "b_cell_from_faces",
           "div_b"]
