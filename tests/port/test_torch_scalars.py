"""Passive and mass scalars through the port's hydro, against quokka_tpu.

- The Riemann solvers (HLLC, LLF) with one and with two scalars in float64,
  and the mass scalars' rescaling of the plain sweep (consistent
  multi-species advection) against the JAX package's formula: within 1e-12
  of each component's max.
- The plain K2 with 1 passive scalar (stage 1's faces and divergences,
  stage 2's averaged divergences, the first-order faces), and with 2
  scalars of which 2 are mass scalars (stage 1; their first-order faces:
  tests/port/test_torch_plm.py), against `compute_fluxes_pallas_div` /
  `compute_fluxes_pallas` run interpreted in float32, and the plain K3 with
  scalars (the density floor engaged, so the scalars are rescaled) against
  `apply_update_pallas`: rtol 1e-5 + 64 ulps of each component's max
  (tests/port/test_torch_sweep.py says why).
- Rayleigh-Taylor 3D (16 x 16 x 24, the JAX test's deck) and 2D (32 x 96)
  in float64 through `Simulation(device="cpu")` against `quokka_tpu.
  Simulation`, both from the JAX package's initial state and driven with
  the same dt: a few steps, the external gravity kick included, within
  1e-12 of each component's max; the initial states within 1e-14. And the
  hydrostatic check of tests/test_rayleigh_taylor.py:30-40 on the port
  (unperturbed 2D stays static), to a shorter stop time.
- PassiveScalar and HydroShocktubeCMA (1D float64) likewise, and the
  species' sum equal to the density after the CMA steps.
- The state carry-over of a 7-component state: `interop.state_from_numpy`
  and `hydro_options_from_fields` carry the scalar counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import quokka_tpu
from quokka_tpu.eos import IdealGasEOS as JEOS
from quokka_tpu.hydro import pallas_sweep as jps
from quokka_tpu.hydro import riemann as jriemann
from quokka_tpu.problems.infrastructure import PassiveScalarProblem as JPassiveScalar
from quokka_tpu.problems.infrastructure import ShocktubeCMAProblem as JShocktubeCMA
from quokka_tpu.problems.rayleigh_taylor import RayleighTaylor2DProblem as JRT2D
from quokka_tpu.problems.rayleigh_taylor import RayleighTaylor3DProblem as JRT3D

import quokka_tpu_torch
from quokka_tpu_torch.eos import IdealGasEOS
from quokka_tpu_torch.hydro import riemann, sweep
from quokka_tpu_torch.indices import RHO, SCALAR0
from quokka_tpu_torch.interop import hydro_options_from_fields, state_from_numpy
from quokka_tpu_torch.problems import (PassiveScalarProblem, RayleighTaylor2DProblem,
                                       RayleighTaylor3DProblem, ShocktubeCMAProblem)

from torch_port_common import (BC_KINDS, jax_opts, make_state, port_opts, t32, ulp_close,
                               with_scalars)

N = 8
GAMMA = 1.4
# (scalars, mass scalars): one passive scalar (Rayleigh-Taylor 3D), two mass
# scalars (HydroShocktubeCMA)
SCALAR_CASES = {"1 passive": (1, 0), "2 mass": (2, 2)}


def close_f64(a, b, what, rel=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    for c in range(b.shape[0]):
        scale = np.max(np.abs(b[c]))
        err = np.max(np.abs(a[c] - b[c]))
        assert err <= rel * scale, (what, c, err, scale)


# ------------------------------------------------------------ Riemann, f64
def face_pair(n, n_scalars, seed):
    """Seeded left/right face states (numpy float64 fields)."""
    rng = np.random.default_rng(seed)
    sides = []
    for _ in range(2):
        rho = 0.5 + rng.random(n)
        u, v, w = (0.6 * rng.standard_normal(n) for _ in range(3))
        P = 0.5 + rng.random(n)
        eint = P / (GAMMA - 1.0)
        sides.append(dict(rho=rho, u=u, v=v, w=w, P=P, cs=np.sqrt(GAMMA * P / rho),
                          E=eint + 0.5 * rho * (u * u + v * v + w * w), Eint=eint,
                          scalars=rho * rng.random((n_scalars, n))))
    du = 0.3 * rng.standard_normal(n)
    dw = 0.3 * rng.standard_normal(n)
    return sides, du, dw


@pytest.mark.parametrize("n_scalars", [1, 2])
def test_riemann_with_scalars_f64(n_scalars):
    sides, du, dw = face_pair(257, n_scalars, seed=n_scalars)
    jL, jR = (jriemann.FaceState(**{k: jnp.asarray(v) for k, v in s.items()})
              for s in sides)
    tL, tR = (riemann.FaceState(**{k: torch.tensor(v) for k, v in s.items()})
              for s in sides)
    ref = np.asarray(jriemann.hllc(jL, jR, JEOS(gamma=GAMMA), jnp.asarray(du),
                                   jnp.asarray(dw)))
    got = riemann.hllc(tL, tR, IdealGasEOS(gamma=GAMMA), torch.tensor(du),
                       torch.tensor(dw)).numpy()
    assert ref.shape == got.shape == (6 + n_scalars, 257)
    close_f64(got, ref, "hllc")
    close_f64(riemann.llf(tL, tR).numpy(), np.asarray(jriemann.llf(jL, jR)), "llf")


def test_mass_scalar_rescaling_f64():
    """`sweep._cma_fluxes` against the JAX package's rescaling
    (`pallas_sweep.py:408-416`, written out here on JAX arrays)."""
    sides, _, _ = face_pair(301, 2, seed=7)
    rng = np.random.default_rng(8)
    mrho = rng.standard_normal(301)
    sL, sR = sides[0]["scalars"], sides[1]["scalars"]
    jm, jL, jR = jnp.asarray(mrho), jnp.asarray(sL), jnp.asarray(sR)
    sum_L, sum_R = jnp.sum(jL[:2], axis=0), jnp.sum(jR[:2], axis=0)
    ref = [jnp.where(jm >= 0.0, jm * jL[k] / sum_L, jm * jR[k] / sum_R) for k in range(2)]
    tL, tR = (riemann.FaceState(**{k: torch.tensor(v) for k, v in s.items()})
              for s in sides)
    got = sweep._cma_fluxes(torch.tensor(mrho), tL, tR, 2)
    close_f64(torch.stack(got).numpy(), np.stack([np.asarray(r) for r in ref]), "cma")
    # the rescaled fluxes sum to the mass flux
    np.testing.assert_allclose(sum(g.numpy() for g in got), mrho, rtol=1e-13, atol=1e-15)


# ------------------------------------- plain K2 and K3, f32, against Pallas
@pytest.fixture(scope="module", params=sorted(SCALAR_CASES))
def sweep_case(request):
    ns, nm = SCALAR_CASES[request.param]
    bc = BC_KINDS["periodic_x"]
    jo = jax_opts(N, n_scalars=ns, n_mscalars=nm)
    U0 = with_scalars(make_state((N, N, N), seed=5, rough=True), ns, nm, 1).astype(np.float32)
    U1 = with_scalars(make_state((N, N, N), seed=6), ns, nm, 2).astype(np.float32)
    j0 = jnp.asarray(U0)
    ref = {"r1": jps.compute_fluxes_pallas_div(j0, jo, bc)}
    # stage 2 and the first-order faces treat every scalar alike: the passive
    # case holds them here (the interpreted references take most of this
    # file's time), test_torch_plm.py the mass scalars' first-order faces
    if nm == 0:
        ref["r2"] = jps.compute_fluxes_pallas_div(jnp.asarray(U1), jo, bc,
                                                  avg_with=ref["r1"])
        ref["fo"] = jps.compute_fluxes_pallas(j0, jo, first_order=True, bc_kinds=bc)
    return dict(bc=bc, opts=port_opts(jo), U0=t32(U0), U1=t32(U1), ref=ref, nv=6 + ns)


def _with_hi(F, F_hi, d, vec):
    F = np.asarray(F)
    if F_hi is None:
        return F
    return np.concatenate([F, np.expand_dims(np.asarray(F_hi), d + 1 if vec else d)],
                          axis=d + 1 if vec else d)


def test_k2_scalars_sweeps(sweep_case):
    opts, bc = sweep_case["opts"], sweep_case["bc"]
    ref = sweep_case["ref"]
    r1 = sweep.compute_fluxes_pallas_div(sweep_case["U0"], opts, bc)
    j1 = ref["r1"]
    for d in range(3):
        assert r1["fluxes"][d].shape[0] == sweep_case["nv"]
        ulp_close(_with_hi(j1["fluxes"][d], j1["flux_hi"].get(d), d, True),
                  _with_hi(r1["fluxes"][d], r1["flux_hi"].get(d), d, True),
                  what=f"stage 1 flux[{d}]")
        for key in ("divs", "dvels"):
            ulp_close(j1[key][d], r1[key][d], what=f"stage 1 {key}[{d}]")
    if "r2" in ref:
        r2 = sweep.compute_fluxes_pallas_div(sweep_case["U1"], opts, bc, avg_with=r1)
        for d in range(3):
            for key in ("divs", "dvels"):
                ulp_close(ref["r2"][key][d], r2[key][d], what=f"stage 2 {key}[{d}]")
    if "fo" in ref:
        fl, _, flh, _ = sweep.compute_fluxes_pallas(sweep_case["U0"], opts, first_order=True,
                                                    bc_kinds=bc)
        jfl, _, jflh, _ = ref["fo"]
        for d in range(3):
            ulp_close(_with_hi(jfl[d], jflh.get(d), d, True),
                      _with_hi(fl[d], flh.get(d), d, True), what=f"first order flux[{d}]")


@pytest.mark.parametrize("name", sorted(SCALAR_CASES))
def test_k3_scalars(name):
    ns, nm = SCALAR_CASES[name]
    shape = (8, 8, 128)
    jo = jax_opts(128, n_scalars=ns, n_mscalars=nm, density_floor=0.9)
    U = with_scalars(make_state(shape, seed=9), ns, nm, 3).astype(np.float32)
    Ug0 = with_scalars(make_state(shape, seed=10), ns, nm, 4).astype(np.float32)
    rng = np.random.default_rng(11)
    divs = {d: rng.standard_normal((6 + ns,) + shape).astype(np.float32) for d in range(3)}
    dvels = {d: rng.standard_normal(shape).astype(np.float32) for d in range(3)}
    dt = 0.05
    jU, _ = jps.apply_update_pallas(
        jnp.asarray(U), jnp.asarray(Ug0), {d: jnp.asarray(a) for d, a in divs.items()},
        {d: jnp.asarray(a) for d, a in dvels.items()}, dt, jo)
    tU, _ = sweep.apply_update(t32(U), t32(Ug0), {d: t32(a) for d, a in divs.items()},
                               {d: t32(a) for d, a in dvels.items()}, dt, port_opts(jo))
    # the floor engaged somewhere, and the scalars were rescaled there
    raw_rho = U[0] + dt * sum(divs[d][0] for d in range(3))
    assert (raw_rho < 0.9).any() and (raw_rho >= 0.9).any()
    ulp_close(jU, tU, what="apply")


# ------------------------------------------------ whole runs, f64, vs JAX
def run_pair(jprob, tprob, deck, nsteps):
    """(JAX state, port state, port simulation) after `nsteps` steps of the
    same dt, both from the JAX package's initial state."""
    deck += "stop_time = 10.0\nverbose = 0\nfused_windows = 0\nprecision = double\n"
    jsim = quokka_tpu.Simulation(jprob, quokka_tpu.ParmParse.from_string(deck))
    tsim = quokka_tpu_torch.Simulation(tprob, quokka_tpu_torch.ParmParse.from_string(deck),
                                       device="cpu")
    jsim.set_initial_conditions()
    tsim.set_initial_conditions()
    ref0 = np.asarray(jsim.U)
    close_f64(tsim.U.numpy(), ref0, "initial state", rel=1e-14)
    tsim.U = torch.tensor(ref0)
    tsim.init_sums = tsim._sums(tsim.U)
    for _ in range(nsteps):
        dt = jsim.compute_timestep()
        assert jsim.advance_single_step(dt) and tsim.advance_single_step(dt)
        jsim.U = jsim._g_ext(jsim.U, dt) if jsim._g_ext is not None else jsim.U
        if tsim._g_ext is not None:
            tsim.U = tsim._external_kick(tsim.U, dt)
        for s in (jsim, tsim):
            s.t += dt
            s.dt_prev = dt
            s.istep += 1
    return np.asarray(jsim.U), tsim.U.numpy(), tsim


RT3D_DECK = """
geometry.prob_lo = -0.25 -0.25 -0.375
geometry.prob_hi = 0.25 0.25 0.375
amr.n_cell = 16 16 24
cfl = 0.3
"""
RT2D_DECK = """
geometry.prob_lo = -0.25 -0.75 0.0
geometry.prob_hi = 0.25 0.75 1.0
amr.n_cell = 32 96 1
cfl = 0.4
"""
SHOCKTUBE_DECK = """
geometry.prob_hi = 5.0 1.0 1.0
amr.n_cell = 64 1 1
cfl = 0.6
"""
PASSIVE_DECK = """
geometry.prob_hi = 1.0 1.0 1.0
amr.n_cell = 64 1 1
cfl = 0.4
"""
RUNS = {
    "RayleighTaylor3D": (JRT3D, RayleighTaylor3DProblem, RT3D_DECK, 2),
    "RayleighTaylor2D": (JRT2D, RayleighTaylor2DProblem, RT2D_DECK, 4),
    "PassiveScalar": (JPassiveScalar, PassiveScalarProblem, PASSIVE_DECK, 6),
    "HydroShocktubeCMA": (JShocktubeCMA, ShocktubeCMAProblem, SHOCKTUBE_DECK, 6),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_scalar_problem_f64_matches_jax(name):
    jcls, tcls, deck, nsteps = RUNS[name]
    ref, got, tsim = run_pair(jcls(), tcls(), deck, nsteps)
    assert got.dtype == np.float64 and np.all(np.isfinite(got))
    assert got.shape[0] == tsim.layout.nvar
    close_f64(got, ref, name)
    if name == "HydroShocktubeCMA":
        # consistent multi-species advection: the species sum to the density
        s = got[SCALAR0] + got[SCALAR0 + 1]
        assert np.max(np.abs(s - got[RHO]) / got[RHO]) < 1e-10
        assert np.max(np.abs(got[SCALAR0] / got[RHO] - 0.6)) < 1e-10
    if name.startswith("RayleighTaylor"):
        assert tsim._g_ext is not None  # the kick ran


def test_rt2d_hydrostatic_balance():
    """tests/test_rayleigh_taylor.py:30-40 on the port, to t = 0.15: without
    the perturbation the stratified state stays static, the gravity kick
    balancing the pressure gradient."""
    prob = RayleighTaylor2DProblem()
    prob.perturb = False
    sim = quokka_tpu_torch.Simulation(prob, quokka_tpu_torch.ParmParse.from_string(
        RT2D_DECK + "stop_time = 0.15\nmax_timesteps = 20000\nverbose = 0\n"), device="cpu")
    sim.set_initial_conditions()
    sim.evolve()
    U = sim.U.numpy()
    assert sim.t == pytest.approx(0.15)
    assert np.abs(U[1:4] / U[0]).max() < 2e-2


# ------------------------------------------------------------- carry-over
def test_interop_carries_scalars():
    jo = jax_opts(N, n_scalars=2, n_mscalars=2)
    opts, eos = hydro_options_from_fields(dataclasses.asdict(jo))
    assert (opts.n_scalars, opts.n_mscalars) == (2, 2) and eos.gamma == GAMMA
    U = with_scalars(make_state((N, N, N), seed=12), 1, 0, 5)
    t = state_from_numpy(U, "cpu", torch.float64)
    assert t.shape == (7, N, N, N) and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), U)
