"""Radiation-pressure-driven shell: the reference's AMR scaling benchmark.

Counterpart of `quokka_tpu.problems.radhydro_shell` (reference
``src/problems/RadhydroShell/test_radhydro_shell.cpp`` and
``tests/radhydro_shell_256.in``): a 10^6 Msun GMC with half its mass in a
Gaussian shell at r0 = 5 pc, driven by a central radiation source (L = 2e42
erg/s deposited as a Gaussian of width 0.3 r0), constant specific opacity
kappa = 20 cm^2/g and reduced speed of light chat = 860 a0, in the JAX
package's code units (length r0, velocity a0, density rho_0 = 3 M_shell /
(4 pi r0^3), temperature in K), which keep every intermediate of an f32
run inside the float32 range.

The initial Erad(r), Frad(r) come from the same semi-analytic profile as in
the JAX package (the steady gray moment equation with the M1 closure,
integrated inward from the free-streaming outer boundary), computed in
numpy. The constant opacity is stated as the power law kappa0 = 20 (code
units), exponents 0, that the CUDA coupling evaluates.

`DECK_256` is the JAX package's dense AMR benchmark deck (``bench.py:192-207``,
`run_amr_shell(n=256, max_level=1, sparse=False)`); `DECK_256_PACKED` the
reference's own AMR benchmark configuration (256^3 + 2 refinement levels,
``paper/strong_scaling.csv:2``) as the JAX package's bench runs it
(``bench.py:163-207``, `run_amr_shell(sparse=True)`): packed 16^3-tile
pools from level 1 up.
"""

from __future__ import annotations

import numpy as np
import torch

from ..eos import C_LIGHT_CGS, K_BOLTZMANN_CGS, M_U_CGS
from ..indices import EGAS, EINT, RHO
from ..registry import (BC_PERIODIC, BCSpec, EOSTraits, PhysicsTraits, PowerLawOpacity,
                        Problem, RadTraits, register_problem)
from ..stencil import sh

A_RAD_CGS = 7.565731356724124e-15  # radiation constant, erg cm^-3 K^-4
MSUN = 2.0e33
PARSEC = 3.086e18

A0_CGS = 2.0e5          # reference sound speed [cm/s]
GAMMA = 5.0 / 3.0
MU_CGS = 2.2 * M_U_CGS

SPECIFIC_LUM = 2000.0   # erg/s/g
GMC_MASS = 1.0e6 * MSUN
EPSILON = 0.5
M_SHELL = (1.0 - EPSILON) * GMC_MASS
L_STAR_CGS = EPSILON * GMC_MASS * SPECIFIC_LUM

R_0_CGS = 5.0 * PARSEC
RHO_0_CGS = M_SHELL / ((4.0 / 3.0) * np.pi * R_0_CGS**3)

# code units: length R_0, velocity A0, density RHO_0, T in Kelvin
L_UNIT = R_0_CGS
V_UNIT = A0_CGS
RHO_UNIT = RHO_0_CGS
T_UNIT_S = L_UNIT / V_UNIT
EDEN_UNIT = RHO_UNIT * V_UNIT**2

C_CODE = C_LIGHT_CGS / V_UNIT
CHAT_CODE = 860.0
A_RAD_CODE = A_RAD_CGS / EDEN_UNIT
KAPPA_CODE = 20.0 * RHO_UNIT * L_UNIT
C_V_CODE = (K_BOLTZMANN_CGS / (MU_CGS * (GAMMA - 1.0))) / V_UNIT**2
MU_CODE = 1.0 / ((GAMMA - 1.0) * C_V_CODE)

SIGMA_STAR = 0.3
H_SHELL = 0.3
R_0 = 1.0
RHO_0 = 1.0
SOURCE_NORM = ((1.0 / C_LIGHT_CGS) * L_STAR_CGS
               / (2.0 * np.pi * (SIGMA_STAR * L_UNIT) ** 2) ** 1.5
               ) * L_UNIT / EDEN_UNIT

# the JAX package's dense AMR shell deck (bench.py:192-207): 256^3 root, one
# dense level (512^3 extent), subcycled with reflux, f32, PPM for hydro and
# radiation, periodic
DECK_256 = """
geometry.prob_lo = 0.0 0.0 0.0
geometry.prob_hi = 4.0 4.0 4.0
amr.n_cell = 256 256 256
amr.max_level = 1
amr.n_error_buf = 3
do_reflux = 1
do_subcycle = 1
cfl = 0.3
radiation.cfl = 0.3
radiation.max_substeps = 10
density_floor = 1.0e-8
stop_time = 1.0e10
precision = single
"""


# the reference's AMR benchmark (bench.py:163-207, run_amr_shell(n=256,
# max_level=2, sparse=True)): levels 1-2 are packed tile pools of 16^3
# tiles, 64 tiles a chunk, capacity headroom 1.02
DECK_256_PACKED = DECK_256.replace("amr.max_level = 1", "amr.max_level = 2") + """
amr.sparse_min_level = 1
amr.tile_size = 16 16 16
amr.pool_chunk = 64
amr.pool_packed = 1
amr.packed_chunk = 64
amr.pool_headroom = 1.02
"""

# the chunk the card runs DECK_256_PACKED with (chip_smoke.py, step_profile,
# amr_memory): at the deck's 64 tiles a chunk the host's launch rate bounds
# a coarse step (251 s against 136 s at 512 on an H100 80GB HBM3, PERF.md);
# the chunk is an execution setting, the results do not depend on it
CARD_PACKED_CHUNK = 512


def _erf(x):
    # Abramowitz-Stegun 7.1.26, as the JAX package evaluates it
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    p = 0.3275911
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + p * x)
    y = 1.0 - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t * np.exp(-x * x)
    return sign * y


def _shell_density(r):
    """Shell density in code units."""
    sigma_sh = H_SHELL / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    rho_norm = (M_SHELL / (4.0 * np.pi * (r * L_UNIT) ** 2
                           * np.sqrt(2.0 * np.pi * (sigma_sh * L_UNIT) ** 2))
                ) / RHO_UNIT
    rho_shell = rho_norm * np.exp(-((r - R_0) ** 2) / (2.0 * sigma_sh**2))
    return np.maximum(rho_shell, 1.0e-8 * RHO_0)


def semi_analytic_profile(n: int = 4096):
    """Steady-state (r, Erad, Frad) table in code units."""
    c = C_CODE
    r = np.geomspace(1.0e-4, 3.6, n)
    u = r / SIGMA_STAR
    P_enc = _erf(u / np.sqrt(2.0)) - np.sqrt(2.0 / np.pi) * u * np.exp(-0.5 * u * u)
    L_code = L_STAR_CGS / (EDEN_UNIT * L_UNIT**3 / T_UNIT_S)
    F = L_code * P_enc / (4.0 * np.pi * r**2)
    rho = _shell_density(r)

    E = np.zeros(n)
    E[-1] = F[-1] / (0.98 * c)  # near-free-streaming outer boundary

    def chi_of_f(f):
        f = np.clip(f, 0.0, 0.9999)
        return (3.0 + 4.0 * f * f) / (5.0 + 2.0 * np.sqrt(4.0 - 3.0 * f * f))

    # march inward: d(chi E)/dr = -(kappa rho / c) F - (3 chi - 1) E / r
    for i in range(n - 2, -1, -1):
        dr = r[i + 1] - r[i]
        f = F[i + 1] / (c * E[i + 1])
        chi = chi_of_f(f)
        dchiE = -(KAPPA_CODE * rho[i + 1] / c) * F[i + 1] \
            - (3.0 * chi - 1.0) * E[i + 1] / r[i + 1]
        chiE = chi * E[i + 1] - dchiE * dr
        E_new = E[i + 1]
        for _ in range(4):
            f_new = np.clip(F[i] / (c * np.maximum(E_new, 1e-300)), 0.0, 0.9999)
            E_new = chiE / chi_of_f(f_new)
        E[i] = max(E_new, F[i] / c, 1e-300)  # causality: E >= F/c
    return r, E, F


def _radius(grid):
    """Cell-centre distance from the domain centre, float64 numpy."""
    xs = [grid.prob_lo[d] + (np.arange(grid.n_cell[d], dtype=np.float64) + 0.5)
          * grid.dx[d] for d in range(3)]
    c = [0.5 * (grid.prob_lo[d] + grid.prob_hi[d]) for d in range(3)]
    return np.sqrt((xs[0][:, None, None] - c[0]) ** 2
                   + (xs[1][None, :, None] - c[1]) ** 2
                   + (xs[2][None, None, :] - c[2]) ** 2)


@register_problem
class RadhydroShellProblem(Problem):
    name = "RadhydroShell"
    physics = PhysicsTraits(hydro_enabled=True, radiation_enabled=True)
    eos_traits = EOSTraits(gamma=GAMMA, mean_molecular_weight=MU_CODE,
                           boltzmann_constant=1.0)
    # Erad floor 1e-10 code units (~4e-13 of the peak): zero Erad NaNs the
    # HLL admissibility fallback in f32 (JAX package, radhydro_shell.py)
    rad = RadTraits(c_light=C_CODE, c_hat=CHAT_CODE, radiation_constant=A_RAD_CODE,
                    Erad_floor=1.0e-10, beta_order=1)
    bcs = BCSpec(x=(BC_PERIODIC, BC_PERIODIC), y=(BC_PERIODIC, BC_PERIODIC),
                 z=(BC_PERIODIC, BC_PERIODIC))
    planck_opacity = PowerLawOpacity(KAPPA_CODE)  # energy and flux means: the same

    def set_radiation_energy_source(self, grid, time, dtype=torch.float64, device="cuda"):
        """Point-like central source (reference `SetRadEnergySource`,
        ``test_radhydro_shell.cpp:98-127``), computed in float64."""
        x, y, z = grid.cell_center_mesh(torch.float64, device)
        c = [0.5 * (grid.prob_lo[d] + grid.prob_hi[d]) for d in range(3)]
        r2 = (x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2
        src = SOURCE_NORM * torch.exp(-r2 / (2.0 * SIGMA_STAR**2))
        return src.expand(grid.n_cell).to(dtype)

    def error_est(self, sim, level):
        """Density-gradient tagging above 1e-2 rho_0 (reference
        ``test_radhydro_shell.cpp:322-357``)."""
        rho = sim.level_U[level][RHO]
        tags = torch.zeros(rho.shape, dtype=torch.bool, device=rho.device)
        for d in sim.level_grids[level].active_axes:
            g = torch.maximum((sh(rho, 1, d) - rho).abs(),
                              (rho - sh(rho, -1, d)).abs()) / rho
            tags = tags | (g > 0.1)
        return tags & (rho >= 1.0e-2 * RHO_0)

    def error_est_local(self, U_padded, grid, level, origin):
        """The same tagging on ghost-padded tiles [c, nvar, X, Y, Z] of a
        pool level (`quokka_tpu/problems/radhydro_shell.py:198-210`): the
        +-1 stencil is exact wherever the driver's n_error_buf dilation
        reaches the interior. Returns [c, X, Y, Z]."""
        rho = U_padded[:, RHO]
        tags = torch.zeros(rho.shape, dtype=torch.bool, device=rho.device)
        for d in range(3):
            g = torch.maximum((sh(rho, 1, d + 1) - rho).abs(),
                              (rho - sh(rho, -1, d + 1)).abs()) / rho
            tags = tags | (g > 0.1)
        return tags & (rho >= 1.0e-2 * RHO_0)

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        """Built in float64 numpy, then cast to `dtype` on `device`."""
        layout = self.physics.layout()
        r = _radius(grid)
        rho = _shell_density(r)
        rt, Et, Ft = semi_analytic_profile()
        Erad = np.interp(r, rt, Et)
        Frad = np.interp(r, rt, Ft)
        Eint = rho * C_V_CODE * (Erad / A_RAD_CODE) ** 0.25
        fc = Frad / np.sqrt(3.0)
        U = torch.zeros((layout.nvar, *grid.n_cell), dtype=dtype, device=device)
        for comp, val in ((RHO, rho), (EGAS, Eint), (EINT, Eint),
                          (layout.rad_index(0, 0), Erad), (layout.rad_index(0, 1), fc),
                          (layout.rad_index(0, 2), fc), (layout.rad_index(0, 3), fc)):
            U[comp] = torch.from_numpy(val).to(device=device, dtype=dtype)
        return U
