"""Multigroup radiation pulse with piecewise power-law opacities (3D),
`RadMultigroupPulse`.

Counterpart of `quokka_tpu.problems.rad_multigroup` (the analog of the
reference's multigroup pulse/shock setups, ``src/problems/RadhydroPulseMG``,
``src/problems/RadhydroShockMultigroup``): a smooth central temperature /
radiation pulse in scaled units, 4 photon groups with a nu^-1 power-law
opacity spectrum, hydro on, periodic. The deck is the repo's
``decks/rad_multigroup_ppl.in`` (`DECK_FILE`: 16^3, the
`ppl_full_spectrum` model); `radiation.opacity_model = piecewise_constant
| ppl_fixed_slope | ppl_full_spectrum` selects the model.
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..indices import EGAS, EINT, RHO
from ..radiation.planck import planck_energy_fractions
from ..registry import EOSTraits, PhysicsTraits, Problem, RadTraits, register_problem

DECK_FILE = Path(__file__).resolve().parents[2] / "decks" / "rad_multigroup_ppl.in"

C_CODE = 1.0e3
CHAT = 1.0e2
KAPPA0 = 20.0  # opacity at each group's lower edge
ALPHA_K = -1.0  # kappa ~ nu^-1 within each group
A_RAD = 1.0
T0 = 1.0
RHO0 = 1.0
N_GROUPS = 4
GROUP_EDGES = (0.1, 1.0, 3.0, 10.0, 100.0)


@register_problem
class RadMultigroupPulseProblem(Problem):
    name = "RadMultigroupPulse"
    physics = PhysicsTraits(hydro_enabled=True, radiation_enabled=True,
                            n_groups=N_GROUPS)
    eos_traits = EOSTraits(gamma=5.0 / 3.0, mean_molecular_weight=1.0,
                           boltzmann_constant=1.0)
    rad = RadTraits(c_light=C_CODE, c_hat=CHAT, radiation_constant=A_RAD,
                    Erad_floor=1e-12, beta_order=1, group_edges=GROUP_EDGES)

    def compute_group_opacities(self, boundaries, rho, T):
        # the piecewise-constant comparison model: group-centre opacities of
        # the same nu^-1 spectrum
        ks = []
        for g in range(N_GROUPS):
            nu_c = (boundaries[g] * boundaries[g + 1]) ** 0.5
            ks.append(KAPPA0 * (nu_c / boundaries[g]) ** ALPHA_K * torch.ones_like(rho))
        return torch.stack(ks)

    def define_opacity_exponents_and_lower_values(self, boundaries, rho, T):
        k = KAPPA0 * torch.ones((N_GROUPS, *rho.shape), dtype=rho.dtype, device=rho.device)
        return torch.full_like(k, ALPHA_K), k

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        """Built in float64 on `device`, then cast to `dtype`, as the JAX
        package builds it in f64 and casts."""
        x, y, z = grid.cell_center_mesh(torch.float64, device)
        layout = self.physics.layout()
        eos = self.make_eos()
        r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
        T = T0 * (1.0 + 0.5 * torch.exp(-r2 / 0.02))
        T = T.expand(grid.n_cell)
        eint = eos.eint_from_tgas(RHO0, T)
        fr = planck_energy_fractions(GROUP_EDGES, T, self.eos_traits.boltzmann_constant,
                                     self.rad.energy_unit)
        U = torch.zeros((layout.nvar, *grid.n_cell), dtype=dtype, device=device)
        U[RHO] = RHO0
        U[EGAS] = eint
        U[EINT] = eint
        T4 = (T * T) * (T * T)  # T**4 as XLA's integer_pow
        for g in range(N_GROUPS):
            U[layout.rad_index(g, 0)] = fr[g] * A_RAD * T4
        return U
