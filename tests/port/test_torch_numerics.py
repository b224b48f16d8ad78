"""Port parity: euler, reconstruct and riemann of quokka_tpu_torch against
the quokka_tpu functions, on the same seeded f64 inputs, at rtol 1e-12
(both run the same operation sequence in f64; only libm rounding of sqrt /
division order could differ)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quokka_tpu.eos import IdealGasEOS as JEOS
from quokka_tpu.hydro import euler as jeuler
from quokka_tpu.hydro import reconstruct as jrec
from quokka_tpu.hydro import riemann as jriem
from quokka_tpu.registry import BC_PERIODIC, BC_REFLECT

from quokka_tpu_torch.eos import IdealGasEOS
from quokka_tpu_torch.hydro import euler, reconstruct, riemann

RTOL = 1e-12
N = 12


def _state(seed, n=N):
    rng = np.random.default_rng(seed)
    shape = (n, n, n)
    rho = 1.0 + 0.5 * rng.random(shape)
    v = 0.3 * rng.standard_normal((3,) + shape)
    eint = 1.0 + rng.random(shape)
    ke = 0.5 * rho * (v**2).sum(axis=0)
    return np.stack([rho, rho * v[0], rho * v[1], rho * v[2], rho * eint + ke,
                     rho * eint])


def _close(a, b):
    a = np.asarray(a)
    b = np.asarray(b.detach().numpy() if isinstance(b, torch.Tensor) else b)
    assert a.shape == b.shape
    atol = RTOL * max(np.max(np.abs(a)), 1e-300)
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=atol)


def _t(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


@pytest.mark.parametrize("reconstruct_eint", [False, True])
def test_euler(reconstruct_eint):
    U = _state(0)
    U[4, 1, 2, 3] = 0.5 * U[4, 1, 2, 3]  # a cell where dual energy syncs
    eos, jeos = IdealGasEOS(gamma=1.4), JEOS(gamma=1.4)
    Uj, Ut = jnp.asarray(U), _t(U)
    _close(jeuler.cons_to_prim(Uj, jeos, reconstruct_eint),
           euler.cons_to_prim(Ut, eos, reconstruct_eint))
    prim = np.asarray(jeuler.cons_to_prim(Uj, jeos, reconstruct_eint))
    _close(jeuler.pressure_from_prim(jnp.asarray(prim), jeos, reconstruct_eint),
           euler.pressure_from_prim(_t(prim), eos, reconstruct_eint))
    _close(jeuler.pressure(Uj, jeos), euler.pressure(Ut, eos))
    _close(jeuler.max_signal_speed(Uj, jeos), euler.max_signal_speed(Ut, eos))
    bad = U.copy()
    bad[0, 0, 0, 0] = -1.0
    bad[4, 1, 1, 1] = 0.0
    bad[2, 2, 2, 2] = np.inf
    np.testing.assert_array_equal(
        np.asarray(jeuler.is_state_valid(jnp.asarray(bad), jeos)),
        euler.is_state_valid(_t(bad), eos).numpy())
    floors = dict(density_floor=1.2, temperature_floor=1e16)
    _close(jeuler.enforce_limits(Uj, jeos, **floors),
           euler.enforce_limits(Ut, eos, **floors))
    _close(jeuler.sync_dual_energy(Uj), euler.sync_dual_energy(Ut))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_reconstruct(axis):
    eos, jeos = IdealGasEOS(gamma=1.4), JEOS(gamma=1.4)
    prim = np.asarray(jeuler.cons_to_prim(jnp.asarray(_state(1)), jeos, False))
    Pj, Pt = jnp.asarray(prim), _t(prim)
    for jf, tf in ((jrec.ppm_faces, reconstruct.ppm_faces),
                   (jrec.donor_cell_faces, reconstruct.donor_cell_faces)):
        for a, b in zip(jf(Pj, axis), tf(Pt, axis)):
            _close(a, b)
    for lim in ("minmod", "mc"):
        for a, b in zip(jrec.plm_faces(Pj, axis, lim),
                        reconstruct.plm_faces(Pt, axis, lim)):
            _close(a, b)
    for bc in (None, (BC_REFLECT, BC_REFLECT), (BC_PERIODIC, BC_REFLECT)):
        _close(jrec.flattening_chi(Pj, axis, jeos, False, bc_axis=bc),
               reconstruct.flattening_chi(Pt, axis, eos, False, bc_axis=bc))


def _face_states(seed, mod, arr):
    rng = np.random.default_rng(seed)
    n = 64
    sides = []
    for _ in range(2):
        rho = 0.5 + rng.random(n)
        u, v, w = 0.5 * rng.standard_normal((3, n))
        P = 0.2 + rng.random(n)
        eint = P / 0.4
        E = eint + 0.5 * rho * (u * u + v * v + w * w)
        cs = np.sqrt(1.4 * P / rho)
        sides.append(mod.FaceState(rho=arr(rho), u=arr(u), v=arr(v), w=arr(w),
                                   P=arr(P), cs=arr(cs), E=arr(E),
                                   Eint=arr(eint), rinv=arr(1.0 / rho)))
    du = arr(0.3 * rng.standard_normal(n))
    dw = arr(0.3 * rng.standard_normal(n))
    return sides, du, dw


@pytest.mark.parametrize("gamma", [1.4, 5.0 / 3.0])
def test_riemann(gamma):
    (jL, jR), jdu, jdw = _face_states(4, jriem, jnp.asarray)
    (tL, tR), tdu, tdw = _face_states(4, riemann, _t)
    _close(jriem.llf(jL, jR), riemann.llf(tL, tR))
    _close(jriem.hllc(jL, jR, JEOS(gamma=gamma), jdu, jdw),
           riemann.hllc(tL, tR, IdealGasEOS(gamma=gamma), tdu, tdw))


def test_hydro_sqrt_rounds_once_on_cpu():
    """The hydro plain code takes a correctly rounded float32 square root on
    the CPU (the float64 root rounded once), as XLA's sqrt and the kernels'
    sqrtf do; PyTorch's vectorized CPU sqrt is one ulp off for about 0.6% of
    inputs. Seeded f32 inputs to the sound speed and the signal speed."""
    rng = np.random.default_rng(12)
    n = 4096
    rho = torch.tensor(0.5 + rng.random(n), dtype=torch.float32)
    P = torch.tensor(0.1 + rng.random(n), dtype=torch.float32)
    eos = IdealGasEOS(gamma=1.4)
    want = torch.sqrt((1.4 * P / rho).double()).float()
    assert torch.equal(eos.sound_speed(rho, P), want)
    v = torch.tensor(0.3 * rng.standard_normal((3, n)), dtype=torch.float32)
    U = torch.stack([rho, rho * v[0], rho * v[1], rho * v[2],
                     P / 0.4 + 0.5 * rho * (v * v).sum(dim=0), P / 0.4])
    vx, vy, vz = U[1] / rho, U[2] / rho, U[3] / rho
    vmag = torch.sqrt((vx * vx + vy * vy + vz * vz).double()).float()
    cs = torch.sqrt((1.4 * euler.pressure(U, eos) / rho).double()).float()
    assert torch.equal(euler.max_signal_speed(U, eos), cs + vmag)
