"""Component layout of the cell-centered state array.

TPU-native equivalent of the reference's compile-time layout machinery
(``Physics_Traits`` / ``Physics_Indices`` / ``Physics_NumVars``, reference
``src/physics_info.hpp:8-47`` and ``src/physics_numVars.hpp:6-15``):

    hydro block (6 vars): rho, x-mom, y-mom, z-mom, E_total, rho*e_aux
    passive scalars:      n_scalars components (first n_mscalars are
                          "mass scalars", i.e. partial densities)
    radiation block:      4 vars per group: E_rad, Fx, Fy, Fz

The state array is ``U[nvar, nx, ny, nz]`` (component-major; the spatial
minor axes map onto TPU sublanes/lanes).
"""

from __future__ import annotations

from dataclasses import dataclass, field


# hydro conserved-variable indices (reference src/hydro/hydro_system.hpp:52-62)
RHO = 0
MX1 = 1
MX2 = 2
MX3 = 3
EGAS = 4  # total gas energy density
EINT = 5  # auxiliary internal energy density (rho * e), for dual energy
SCALAR0 = 6  # first passive scalar (only if n_scalars > 0)

NVAR_HYDRO = 6

# primitive-variable indices (reference src/hydro/hydro_system.hpp:64-72)
PRHO = 0
PVX1 = 1
PVX2 = 2
PVX3 = 3
PPRES = 4  # pressure, OR specific internal energy if reconstruct_eint
PEINT = 5  # aux (rho*e), OR aux specific internal energy if reconstruct_eint
PSCALAR0 = 6

# radiation per-group component offsets (reference src/radiation/radiation_system.hpp)
RAD_E = 0
RAD_FX = 1
RAD_FY = 2
RAD_FZ = 3
NVAR_RAD_PER_GROUP = 4


@dataclass(frozen=True)
class StateLayout:
    """Computed component layout for a given physics configuration."""

    hydro_enabled: bool = True
    radiation_enabled: bool = False
    n_scalars: int = 0
    n_mscalars: int = 0  # leading subset of scalars that are partial densities
    n_groups: int = 1

    @property
    def nvar_hydro(self) -> int:
        # the gas block is always present (radiation-only problems still
        # carry gas fields for the matter coupling, as in the reference's
        # Physics_Indices); `hydro_enabled` only gates the hydro *solver*
        return NVAR_HYDRO + self.n_scalars

    @property
    def nvar_rad(self) -> int:
        return NVAR_RAD_PER_GROUP * self.n_groups if self.radiation_enabled else 0

    @property
    def rad_start(self) -> int:
        return self.nvar_hydro

    @property
    def nvar(self) -> int:
        return self.nvar_hydro + self.nvar_rad

    def rad_index(self, group: int, comp: int) -> int:
        """Flat index of radiation component `comp` of `group`."""
        return self.rad_start + NVAR_RAD_PER_GROUP * group + comp

    def component_names(self) -> list[str]:
        names = [
            "gasDensity",
            "x-GasMomentum",
            "y-GasMomentum",
            "z-GasMomentum",
            "gasEnergy",
            "gasInternalEnergy",
        ]
        names += [f"scalar_{i}" for i in range(self.n_scalars)]
        if self.radiation_enabled:
            for g in range(self.n_groups):
                names += [
                    f"radEnergy-Group{g}",
                    f"x-RadFlux-Group{g}",
                    f"y-RadFlux-Group{g}",
                    f"z-RadFlux-Group{g}",
                ]
        return names
