"""Two-moment (M1) radiation transport: closure, HLL fluxes, IMEX stages.

Counterpart of `quokka_tpu.radiation.system` (reference
``src/radiation/radiation_system.hpp:157-1140``): the Levermore 1984 M1
closure, the frozen-Eddington-tensor HLL flux with Skinner & Ostriker 2013
eigenvalues and a reduced speed of light (c_hat < c), and the IMEX PD-ARS
transport stages (forward-Euler predict + weighted RK2 combine, IMEX_a22 =
1, IMEX_a32 = 0.5, reference ``:51-52``).

State layout per group: [E_rad, Fx, Fy, Fz]; primitives are [E_rad, fx, fy,
fz] with f = F/(cE). Grouped arrays are R[G, 4, X, Y, Z]. Every stencil is
a roll, so on the unpadded state the wrap is the periodic boundary: the
port steps radiation ghost-free and periodic only, over 1, 2 or 3 active
axes.

`rad_transport_div` is the transport divergence of the unigrid substep:
kernel K6 (`sweep.compute_rad_div`, every photon group in one launch) per
axis for a float32 state with three active axes, its plain version on the
CPU, for any other dtype and on fewer axes, as the JAX package takes XLA
there. The flux-dict formulation (`compute_rad_fluxes`, kernel K7 per
axis, + `rad_div_fluxes`) is what the dense AMR levels run
(`advance.LevelRadiation`): their flux registers consume the face fluxes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from .._numerics import sqrt
from ..stencil import sh

# IMEX PD-ARS constant (reference src/radiation/radiation_system.hpp:51-52;
# IMEX_a22 = 1 enters no expression)
IMEX_A32 = 0.5


@dataclass(frozen=True)
class RadOptions:
    """Static radiation solver configuration (RadSystem_Traits +
    radiation.* runtime knobs): `n_groups` photon groups and the multigroup
    `opacity_model` (reference OpacityModel, radiation_system.hpp:63-68:
    piecewise_constant | ppl_fixed_slope | ppl_full_spectrum). The fields
    the port does not implement yet (`use_wavespeed_correction`,
    `mixed_precision_coupling`) are kept so a JAX configuration carries
    across, and the solver refuses them."""

    c: float
    chat: float
    arad: float
    erad_floor: float = 0.0
    beta_order: int = 1
    reconstruction_order: int = 3
    use_wavespeed_correction: bool = False
    cfl: float = 0.3
    max_substeps: int = 10
    include_work_term: bool = True
    n_groups: int = 1
    mixed_precision_coupling: bool = False
    opacity_model: str = "piecewise_constant"


def eddington_factor_sq(f2: torch.Tensor) -> torch.Tensor:
    """Levermore 1984 M1 closure chi as a function of f^2, f = |F|/(cE) in
    [0, 1] (reference `ComputeEddingtonFactor`,
    ``radiation_system.hpp:773-790``)."""
    f2 = torch.clamp(f2, 0.0, 1.0)
    f_fac = sqrt(4.0 - 3.0 * f2)
    return (3.0 + 4.0 * f2) / (5.0 + 2.0 * f_fac)


def eddington_tensor(fx, fy, fz):
    """3x3 Eddington tensor from the reduced flux vector (reference
    `ComputeEddingtonTensor`, ``radiation_system.hpp:874-916``), with
    n_i n_j = f_i f_j / f^2 folded into one factor."""
    f2 = fx * fx + fy * fy + fz * fz
    chi = eddington_factor_sq(f2)
    Tdiag = 0.5 * (1.0 - chi)
    pos = f2 > 0.0
    tf_over_f2 = torch.where(pos, 0.5 * (3.0 * chi - 1.0) / torch.where(pos, f2, 1.0),
                             0.0)
    fv = (fx, fy, fz)
    return [[Tdiag * (1.0 if i == j else 0.0) + tf_over_f2 * fv[i] * fv[j]
             for j in range(3)] for i in range(3)]


def _rad_pressure_flux(erad, F3, f3, axis):
    """(F_canonical[4], S) for one side of an interface: the transport
    flux in the frozen-Eddington approximation (reference
    `ComputeRadPressure`, ``radiation_system.hpp:918-985``); S =
    max(0.1, sqrt(T_nn))."""
    T = eddington_tensor(*f3)
    row = T[axis]
    F = [F3[axis], row[0] * erad, row[1] * erad, row[2] * erad]
    S = torch.clamp(sqrt(row[axis]), min=0.1)
    return F, S


def rad_cons_to_prim(R: torch.Tensor, c: float) -> torch.Tensor:
    """R[G,4,...] -> prim [G,4,...] with reduced fluxes f = F/(cE)."""
    E = R[:, 0:1]
    return torch.cat([E, R[:, 1:4] / (c * E)], dim=1)


def amend_rad_state(R: torch.Tensor, opts: RadOptions) -> torch.Tensor:
    """Make the radiation state admissible: E >= floor, |F| <= c E
    (reference `amendRadState`, ``radiation_system.hpp:646-666``). R is
    [G, 4, ...]; the floor is per group (Erad_floor / nGroups)."""
    floor = opts.erad_floor / opts.n_groups
    E = torch.clamp(R[:, 0], min=floor)
    F = R[:, 1:4]
    Fnorm = sqrt(F[:, 0] * F[:, 0] + F[:, 1] * F[:, 1] + F[:, 2] * F[:, 2])[:, None]
    Fmax = opts.c * E[:, None]
    scale = torch.where(Fnorm > Fmax, Fmax / torch.where(Fnorm > 0, Fnorm, 1.0), 1.0)
    return torch.cat([E[:, None], F * scale], dim=1)


def _hll_group_flux(qL, qR, consL, consR, axis, opts: RadOptions):
    """HLL flux for one photon group at all faces along `axis`. qL/qR:
    [4, ...] primitive (E, fx, fy, fz); consL/consR: [4, ...] donor-cell
    conserved states, taken where the reconstructed state is inadmissible
    (E <= 0 or |f|^2 >= 1)."""
    c, chat = opts.c, opts.chat

    def unpack(q, cons):
        erad, fx, fy, fz = q[0], q[1], q[2], q[3]
        f2 = fx * fx + fy * fy + fz * fz
        bad = (erad <= 0.0) | (f2 >= 1.0)
        erad = torch.where(bad, cons[0], erad)
        Fx = torch.where(bad, cons[1], fx * c * q[0])
        Fy = torch.where(bad, cons[2], fy * c * q[0])
        Fz = torch.where(bad, cons[3], fz * c * q[0])
        inv_cE = 1.0 / (c * erad)
        return erad, (Fx, Fy, Fz), (Fx * inv_cE, Fy * inv_cE, Fz * inv_cE)

    erad_L, F3_L, f3_L = unpack(qL, consL)
    erad_R, F3_R, f3_R = unpack(qR, consR)
    FL, s_L = _rad_pressure_flux(erad_L, F3_L, f3_L, axis)
    FR, s_R = _rad_pressure_flux(erad_R, F3_R, f3_R, axis)
    # reduced-speed-of-light scaling (reference radiation_system.hpp:1092-1099)
    FL = [FL[0] * (chat / c)] + [Fi * (chat * c) for Fi in FL[1:]]
    FR = [FR[0] * (chat / c)] + [Fi * (chat * c) for Fi in FR[1:]]
    U_L = (erad_L, F3_L[0], F3_L[1], F3_L[2])
    U_R = (erad_R, F3_R[0], F3_R[1], F3_R[2])
    # (S_R F_L - S_L F_R + S_R S_L (U_R - U_L)) / (S_R - S_L) with the wave
    # speeds -s_L chat, +s_R chat and chat cancelled where it can be
    inv = 1.0 / (s_R + s_L)
    wL = s_R * inv
    wR = s_L * inv
    wD = (s_R * s_L * inv) * chat
    return torch.stack([wL * FL[k] + wR * FR[k] - wD * (U_R[k] - U_L[k])
                        for k in range(4)])


def compute_rad_fluxes(Ug: torch.Tensor, rad_start: int, opts: RadOptions,
                       active_axes: Sequence[int], dx: Sequence[float],
                       tau_fn=None) -> dict:
    """HLL radiation fluxes along every active axis (reference
    `RadSystem::ComputeFluxes`, ``radiation_system.hpp:987-1135``): PPM/PLM
    faces of the primitive (E, f), per-face donor-cell fallback. Returns
    {axis: flux [G,4,X,Y,Z]}, slot f the face between cells f-1 and f.

    A float32 state takes kernel K7 (`sweep.compute_rad_axis_flux`) per
    axis: on a CUDA tensor it launches the kernel or raises, whatever
    `radiation.use_pallas` says; on the CPU it is K7's plain version. Any
    other dtype takes the plain version on its own device, as the JAX
    package sends non-f32 states to XLA (`quokka_tpu/radiation/system.py:
    178-185`). The optical-depth wavespeed correction (`tau_fn`) is not
    ported."""
    del dx
    if tau_fn is not None:
        raise NotImplementedError("compute_rad_fluxes: the wavespeed correction "
                                  "(tau_fn) is not ported yet")
    from .sweep import compute_rad_axis_flux, rad_axis_flux_plain

    cons_flat = Ug[rad_start:]
    axis_fn = compute_rad_axis_flux if cons_flat.dtype == torch.float32 else rad_axis_flux_plain
    return {d: axis_fn(cons_flat, d, opts) for d in active_axes}


def rad_div_fluxes(fluxes: dict, dx: Sequence[float]) -> torch.Tensor:
    """sum_d (F_d(f) - F_d(f+1)) / dx_d; fluxes[d] is [G, 4, X, Y, Z]."""
    out = None
    for d, F in fluxes.items():
        # (F - sh(F)) / dx in the roll's buffer: at a fine level's 520^3
        # each temporary is 2.25 GB
        contrib = sh(F, 1, d + 2)
        torch.sub(F, contrib, out=contrib)
        contrib.div_(torch.full((), dx[d], dtype=F.dtype, device=F.device))
        if out is None:
            out = contrib
        else:
            out.add_(contrib)
        del contrib
    return out


def rad_transport_div(Ug: torch.Tensor, rad_start: int, opts: RadOptions,
                      active_axes: Sequence[int], dx: Sequence[float]) -> torch.Tensor:
    """Total transport divergence [G, 4, X, Y, Z] of the unpadded state over
    the active axes: K6 per axis for a float32 state with three active axes
    (`quokka_tpu/radiation/system.py:309-311`), its plain version on the
    state's own device for any other dtype or fewer axes, as the JAX
    package takes XLA there; the first axis into a fresh output and each
    further axis added onto it in place, which is the JAX sum ((x + y) +
    z)."""
    from .sweep import compute_rad_div, rad_div_plain

    cons_flat = Ug[rad_start:]
    kernel = cons_flat.dtype == torch.float32 and tuple(active_axes) == (0, 1, 2)
    div_fn = compute_rad_div if kernel else rad_div_plain
    out = None
    for d in active_axes:
        out = div_fn(cons_flat, d, opts, dx[d], acc=out)
    return out.reshape(opts.n_groups, 4, *Ug.shape[1:])


def predict_step(R0, divF, dt, opts: RadOptions):
    """Forward-Euler transport stage + admissibility amendment (reference
    `RadSystem::PredictStep`, ``radiation_system.hpp:668-712``)."""
    return amend_rad_state(R0 + dt * divF, opts)


def add_fluxes_rk2(R0, R1, divF0, divF1, dt, opts: RadOptions):
    """PD-ARS combine stage (reference `RadSystem::AddFluxesRK2`,
    ``radiation_system.hpp:714-772``):
    U^{n+1} = (1-a32) U0 + a32 U1 + dt(0.5-a32) divF(U0) + 0.5 dt divF(U1)."""
    a32 = IMEX_A32
    R_new = ((1.0 - a32) * R0 + a32 * R1 + dt * (0.5 - a32) * divF0
             + dt * 0.5 * divF1)
    return amend_rad_state(R_new, opts)
