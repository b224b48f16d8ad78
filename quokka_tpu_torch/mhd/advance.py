"""Ideal-MHD solver: unsplit RK2-SSP finite volume + constrained transport.

Counterpart of `quokka_tpu.mhd.advance` (the reference's MHD is a stub:
``src/hydro/mhd_system.hpp:20``):

  - cell-centred conserved state U = [rho, mom, E] with E including the
    magnetic energy B^2/2; cell B is the average of the staggered face B;
  - PLM (minmod) / PPM / donor-cell faces of [rho, v, P, B_t1, B_t2]; the
    face-normal B is the staggered field itself;
  - HLLD fluxes (`hydro.riemann.hlld`);
  - corner EMFs by the Gardiner & Stone 2005 upwind-CT reconstruction, so
    the staggered B update is the exact discrete curl of an edge EMF and
    div B is preserved to roundoff;
  - RK2-SSP (Heun), linear in the stage RHS, so div B survives the combine.

Fully periodic domains run ghost-free: every stencil is a roll whose wrap is
the periodic boundary. Bf[d][..., i, ...] = B_d at face i-1/2 (the lo face
of cell i); edge arrays are corner-registered the same way.

Each active axis's reconstruction + HLLD + divergence is one call of
`mhd.sweep.compute_mhd_axis` for a float32 state: kernel K8 on a CUDA
state, which takes three active axes and raises for anything else, and
K8's plain version on a CPU state. Any other dtype takes the plain version
(`mhd_axis_plain`) on its own device, as the JAX package takes XLA there. The
corner-EMF assembly, the curl and the RK combine stay plain PyTorch, as
they stayed XLA outside Pallas.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from .._numerics import div, sqrt
from ..stencil import sh
from .sweep import _FRAMES, compute_mhd_axis, mhd_axis_plain


@dataclass(frozen=True)
class MHDOptions:
    gamma: float
    dx: Tuple[float, float, float]
    active_axes: Tuple[int, ...] = (0, 1, 2)
    reconstruction_order: int = 2  # PLM (the standard choice for CT MHD)
    # kept for the JAX package's field set: order 2 takes minmod whatever it
    # says, as `reconstruct.reconstruct_faces` does there
    limiter: str = "mc"
    density_floor: float = 0.0
    pressure_floor: float = 0.0
    # the JAX package's kernel switch, kept for its field set: it changes
    # nothing here (a CUDA state always sweeps through K8)
    use_pallas: bool = True


# (k, i_ax, j_ax) cyclic triplets for edge EMF components
_EDGE_AXES = {2: (0, 1), 0: (1, 2), 1: (2, 0)}

RHO, MX, MY, MZ, EN = 0, 1, 2, 3, 4


def b_cell_from_faces(Bf: Sequence[torch.Tensor]) -> torch.Tensor:
    """Cell-centred B as the 2-point average of the bounding faces:
    B_d(i) = (Bf_d(i-1/2) + Bf_d(i+1/2)) / 2."""
    return torch.stack([0.5 * (Bf[d] + sh(Bf[d], 1, d)) for d in range(3)])


def div_b(Bf: Sequence[torch.Tensor], opts: MHDOptions) -> torch.Tensor:
    """Discrete cell divergence of the staggered field (identically
    preserved by the CT update)."""
    out = None
    for d in range(3):
        c = div(sh(Bf[d], 1, d) - Bf[d], opts.dx[d])
        out = c if out is None else out + c
    return out


def cons_to_prim_mhd(U: torch.Tensor, B_cc: torch.Tensor, opts: MHDOptions):
    """[rho, vx, vy, vz, P, Bx, By, Bz] with P = (gamma-1)(E - ke - pb)."""
    rho = U[RHO]
    inv_rho = 1.0 / rho
    v = U[MX:MZ + 1] * inv_rho[None]
    ke = 0.5 * rho * (v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    pb = 0.5 * (B_cc[0] * B_cc[0] + B_cc[1] * B_cc[1] + B_cc[2] * B_cc[2])
    P = (opts.gamma - 1.0) * (U[EN] - ke - pb)
    if opts.pressure_floor > 0.0:
        P = torch.clamp(P, min=opts.pressure_floor)
    return torch.cat([rho[None], v, P[None], B_cc])


def fast_speed(rho, P, bx, by, bz, gamma):
    """Fast magnetosonic speed along the bx direction."""
    gp = gamma * P
    b_sq = bx * bx + by * by + bz * bz
    byz_sq = by * by + bz * bz
    bgp_m = b_sq - gp
    return sqrt(0.5 * (b_sq + gp + sqrt(bgp_m * bgp_m + 4.0 * gp * byz_sq)) / rho)


def max_signal_mhd(U, Bf, opts: MHDOptions) -> torch.Tensor:
    """max over cells and axes of |v_d| + c_fast,d (for the CFL dt), as a
    0-d tensor on U's device."""
    B_cc = b_cell_from_faces(Bf)
    prim = cons_to_prim_mhd(U, B_cc, opts)
    rho, P = prim[0], prim[4]
    s = None
    for d in opts.active_axes:
        vax, wax = _FRAMES[d]
        cf = fast_speed(rho, P, prim[5 + d], prim[5 + vax], prim[5 + wax], opts.gamma)
        sd = torch.abs(prim[1 + d]) + cf
        s = sd if s is None else torch.maximum(s, sd)
    return torch.max(s)


def _upwind_select(flux, left, right):
    """GS05 mass-flux upwinding: >0 -> left, <0 -> right, ==0 -> average."""
    return torch.where(flux > 0.0, left,
                       torch.where(flux < 0.0, right, 0.5 * (left + right)))


def _corner_emf(Ef_i, Ef_j, Ecc, Frho_i, Frho_j, i_ax, j_ax,
                d_i: float, d_j: float):
    """Edge EMF E_k at corners (i-1/2, j-1/2) from the two face EMFs, the
    cell-centred EMF, and the mass fluxes (GS05 eqs 41+49-50; Stone+08 eqs
    77-80). `Ef_i` = E_k on i_ax-faces (j-centred), `Ef_j` = E_k on
    j_ax-faces, `Frho_i/j` = mass fluxes on those faces."""

    def SH(A, di, dj):
        out = A
        if di:
            out = sh(out, di, i_ax)
        if dj:
            out = sh(out, dj, j_ax)
        return out

    avg4 = 0.25 * (Ef_i + SH(Ef_i, 0, -1) + Ef_j + SH(Ef_j, -1, 0))

    # (dE/dj) at (i-1/2, j-3/4): columns i-1 / i selected by the mass flux
    # through the i-face at (i-1/2, j-1)
    d1 = _upwind_select(
        SH(Frho_i, 0, -1),
        div(2.0 * (SH(Ef_j, -1, 0) - SH(Ecc, -1, -1)), d_j),
        div(2.0 * (Ef_j - SH(Ecc, 0, -1)), d_j),
    )
    # (dE/dj) at (i-1/2, j-1/4): selected by the i-face flux at (i-1/2, j)
    d2 = _upwind_select(
        Frho_i,
        div(2.0 * (SH(Ecc, -1, 0) - SH(Ef_j, -1, 0)), d_j),
        div(2.0 * (Ecc - Ef_j), d_j),
    )
    # (dE/di) at (i-3/4, j-1/2): rows j-1 / j selected by the j-face flux
    # at (i-1, j-1/2)
    d3 = _upwind_select(
        SH(Frho_j, -1, 0),
        div(2.0 * (SH(Ef_i, 0, -1) - SH(Ecc, -1, -1)), d_i),
        div(2.0 * (Ef_i - SH(Ecc, -1, 0)), d_i),
    )
    # (dE/di) at (i-1/4, j-1/2): selected by the j-face flux at (i, j-1/2)
    d4 = _upwind_select(
        Frho_j,
        div(2.0 * (SH(Ecc, 0, -1) - SH(Ef_i, 0, -1)), d_i),
        div(2.0 * (Ecc - Ef_i), d_i),
    )

    return avg4 + (d_j / 8.0) * (d1 - d2) + (d_i / 8.0) * (d3 - d4)


def mhd_rhs(U: torch.Tensor, Bf: Sequence[torch.Tensor], opts: MHDOptions):
    """Single-stage RHS: (dU/dt, [dBf_d/dt]) on a fully periodic domain.

    dU/dt = -div F (HLLD fluxes); dBf/dt = -curl E with corner EMFs from the
    upwind-CT reconstruction."""
    if U.is_cuda and tuple(opts.active_axes) != (0, 1, 2):
        raise NotImplementedError(
            "MHD on a CUDA device needs three active axes (K8 sweeps every "
            f"axis), got {tuple(opts.active_axes)}; run this problem with "
            "device='cpu'")
    B_cc = b_cell_from_faces(Bf)
    prim = cons_to_prim_mhd(U, B_cc, opts)

    face_emf = {}   # face_emf[(k, face_axis)] = E_k on face_axis-faces
    face_rho = {}   # mass flux per face axis
    dU = None

    # K8 per axis: only the divergence rows and the three face rows the CT
    # corner assembly needs reach device memory. A non-f32 state takes the
    # plain form on its own device, as the JAX package's `use_kernel` test
    # sends it to XLA (`quokka_tpu/mhd/advance.py:184-188`)
    axis_fn = compute_mhd_axis if prim.dtype == torch.float32 else mhd_axis_plain
    for d in opts.active_axes:
        vax, wax = _FRAMES[d]
        out = axis_fn(prim, Bf[d], d, opts)
        dU = out[:5] if dU is None else dU + out[:5]
        face_rho[d] = out[5]
        # row 6 = flux of B_vax -> -E_wax; row 7 = flux of B_wax -> +E_vax
        face_emf[(wax, d)] = -out[6]
        face_emf[(vax, d)] = out[7]

    # corner EMFs and the discrete curl
    Ecc = {}
    for k, (i_ax, j_ax) in _EDGE_AXES.items():
        # E_k = v_j B_i - v_i B_j at cell centres ((i_ax, j_ax, k) cyclic)
        Ecc[k] = prim[1 + j_ax] * prim[5 + i_ax] - prim[1 + i_ax] * prim[5 + j_ax]

    # inactive (size-1, homogeneous) axes carry no sweep: their "face" EMF
    # is the cell value and the mass flux is indeterminate (upwind ->
    # average); with identity rolls along a size-1 axis the GS05 gradient
    # terms then reduce the corner EMF exactly to the active-face value
    zero = torch.zeros_like(U[RHO])
    for d in range(3):
        if d in opts.active_axes:
            continue
        vax, wax = _FRAMES[d]
        face_emf[(wax, d)] = Ecc[wax]
        face_emf[(vax, d)] = Ecc[vax]
        face_rho[d] = zero
    if dU is None:
        dU = torch.zeros_like(U)

    edge = {}
    for k, (i_ax, j_ax) in _EDGE_AXES.items():
        edge[k] = _corner_emf(
            face_emf[(k, i_ax)], face_emf[(k, j_ax)], Ecc[k],
            face_rho[i_ax], face_rho[j_ax], i_ax, j_ax,
            opts.dx[i_ax], opts.dx[j_ax],
        )

    dBf = []
    for d in range(3):
        d1 = (d + 1) % 3
        d2 = (d + 2) % 3
        # (curl E)_d at the d-face = dE_{d2}/dx_{d1} - dE_{d1}/dx_{d2}
        curl = div(sh(edge[d2], 1, d1) - edge[d2], opts.dx[d1]) \
            - div(sh(edge[d1], 1, d2) - edge[d1], opts.dx[d2])
        dBf.append(-curl)
    return dU, dBf


def _floor_state(U, opts: MHDOptions):
    if opts.density_floor > 0.0:
        U = torch.cat([torch.clamp(U[RHO:RHO + 1], min=opts.density_floor), U[1:]])
    return U


def advance_mhd_rk2(U, Bf, dt, opts: MHDOptions):
    """Heun / RK2-SSP step; `dt` a number or a 0-d tensor of U's dtype. Both
    sub-updates are linear in the RHS, so the staggered B stays
    divergence-free through the combine."""
    dU1, dB1 = mhd_rhs(U, Bf, opts)
    U1 = _floor_state(U + dt * dU1, opts)
    B1 = [Bf[d] + dt * dB1[d] for d in range(3)]

    dU2, dB2 = mhd_rhs(U1, B1, opts)
    U2 = _floor_state(0.5 * (U + U1 + dt * dU2), opts)
    B2 = [0.5 * (Bf[d] + B1[d] + dt * dB2[d]) for d in range(3)]
    return U2, B2
