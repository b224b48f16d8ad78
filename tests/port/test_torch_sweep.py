"""Plain K1, K2 and K3 of quokka_tpu_torch.hydro.sweep against the Pallas
kernels of quokka_tpu.hydro.pallas_sweep, run in Pallas interpret mode on
the CPU as the JAX package's own tests run them.

Same seeded f32 inputs on both sides; tolerance rtol 1e-5 plus 64 ulps of
each component's max (tests/test_fused_update.py: XLA contracts a*b+c into
FMAs differently from PyTorch's separately rounded ops). Reflecting walls
on all axes, and a periodic x axis with reflecting y/z walls. The JAX
references are built once per module (interpret-mode compiles dominate).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quokka_tpu.hydro import pallas_sweep as jps

from quokka_tpu_torch.hydro import sweep

from torch_port_common import (BC_KINDS, jax_opts, make_state, port_opts, t32,
                               ulp_close)

N = 16


@pytest.fixture(scope="module", params=sorted(BC_KINDS))
def case(request):
    bc = BC_KINDS[request.param]
    jo = jax_opts(N)
    U0 = make_state((N, N, N), seed=5, rough=True).astype(np.float32)
    U1 = make_state((N, N, N), seed=6).astype(np.float32)
    j0, j1 = jnp.asarray(U0), jnp.asarray(U1)
    ref = {
        "k1": jps.precompute_transverse_pallas(j0, jo, bc, state_is_cons=True),
        "r1": jps.compute_fluxes_pallas_div(j0, jo, bc),
        "fo": jps.compute_fluxes_pallas(j0, jo, first_order=True, bc_kinds=bc),
    }
    ref["r2"] = jps.compute_fluxes_pallas_div(j1, jo, bc, avg_with=ref["r1"])
    return dict(bc=bc, opts=port_opts(jo), U0=t32(U0), U1=t32(U1), ref=ref)


def test_k1_transverse(case):
    dmins, chi_cell, _ = sweep.precompute_transverse(
        case["U0"], case["opts"], case["bc"], state_is_cons=True)
    jd, jchi, _ = case["ref"]["k1"]
    for t in range(3):
        ulp_close(jd[t], dmins[t], what=f"dmin_{t}")
    ulp_close(jchi, chi_cell, what="chi_cell")


def _faces(F, F_hi, d, vec):
    """The n+1 faces of axis d: the slot array with the hi-wall plane
    appended, so a wall plane (whose exact value is often 0) is held to
    the scale of its whole face field."""
    F = np.asarray(F)
    if F_hi is None:
        return F
    ax = d + 1 if vec else d
    return np.concatenate([F, np.expand_dims(np.asarray(F_hi), ax)], axis=ax)


def _check_faces(jfl, jfv, jflh, jfvh, fl, fv, flh, fvh, what):
    assert sorted(fl) == sorted(jfl) and sorted(flh) == sorted(jflh), what
    for d in jfl:
        ulp_close(_faces(jfl[d], jflh.get(d), d, True),
                  _faces(fl[d], flh.get(d), d, True), what=f"{what} flux[{d}]")
        ulp_close(_faces(jfv[d], jfvh.get(d), d, False),
                  _faces(fv[d], fvh.get(d), d, False), what=f"{what} vel[{d}]")


def test_k2_stage1(case):
    r1 = sweep.compute_fluxes_pallas_div(case["U0"], case["opts"], case["bc"])
    jr = case["ref"]["r1"]
    keys = ("fluxes", "facevels", "flux_hi", "vel_hi")
    _check_faces(*(jr[k] for k in keys),
                 *({d: a.numpy() for d, a in r1[k].items()} for k in keys),
                 what="stage 1")
    for key in ("divs", "dvels"):
        for d in range(3):
            ulp_close(jr[key][d], r1[key][d], what=f"{key}[{d}]")


def test_k2_stage2_avg(case):
    opts, bc = case["opts"], case["bc"]
    r1 = sweep.compute_fluxes_pallas_div(case["U0"], opts, bc)
    r2 = sweep.compute_fluxes_pallas_div(case["U1"], opts, bc, avg_with=r1)
    jr = case["ref"]["r2"]
    assert r2["fluxes"] == {} and r2["flux_hi"] == {}
    for key in ("divs", "dvels"):
        for d in range(3):
            ulp_close(jr[key][d], r2[key][d], what=f"avg {key}[{d}]")


def test_k2_first_order(case):
    got = sweep.compute_fluxes_pallas(case["U0"], case["opts"], first_order=True,
                                      bc_kinds=case["bc"])
    _check_faces(*case["ref"]["fo"],
                 *({d: a.numpy() for d, a in g.items()} for g in got),
                 what="first order")


@pytest.mark.parametrize("rough", [False, True])
def test_k3_apply(rough):
    shape = (8, 8, 128)
    jo = jax_opts(128, temperature_floor=1e-30)
    U = make_state(shape, seed=9, rough=rough).astype(np.float32)
    Ug0 = make_state(shape, seed=10).astype(np.float32)
    rng = np.random.default_rng(11)
    divs = {d: rng.standard_normal((6,) + shape).astype(np.float32) for d in range(3)}
    dvels = {d: rng.standard_normal(shape).astype(np.float32) for d in range(3)}
    dt = 0.05
    jU, jok = jps.apply_update_pallas(
        jnp.asarray(U), jnp.asarray(Ug0), {d: jnp.asarray(a) for d, a in divs.items()},
        {d: jnp.asarray(a) for d, a in dvels.items()}, dt, jo)
    tU, n_bad = sweep.apply_update(
        t32(U), t32(Ug0), {d: t32(a) for d, a in divs.items()},
        {d: t32(a) for d, a in dvels.items()}, dt, port_opts(jo))
    ulp_close(jU, tU, what="apply")
    assert bool(np.all(np.asarray(jok))) == (int(n_bad) == 0)
    assert (int(n_bad) > 0) == rough


def test_wrappers_reject_unported_options(case):
    # an outflow chi plane belongs to an outflow side of a wall axis
    plane = torch.ones(1, N, N)
    with pytest.raises(ValueError, match="chi_ghost_axis"):
        sweep.compute_axis_flux(case["U0"], 0, case["opts"], None, {},
                                chi_ghost_axis=(plane, None))
    # the register seed (K2e) is ported on ghost-free periodic axes only
    walls = {d: b for d, b in case["bc"].items()}
    walls[0] = ("reflect", "reflect")
    with pytest.raises(ValueError, match="corr_mask"):
        sweep.compute_fluxes_pallas_div(case["U0"], case["opts"], walls,
                                        div_only=True, accumulate=True,
                                        corr_masks={d: torch.zeros(N, N, N) for d in range(3)})
    with pytest.raises(NotImplementedError):
        sweep.compute_axis_flux(case["U0"], 0, case["opts"], None, {},
                                fo_mask=torch.zeros(N, N, N))
    # the NSCBC walls are not ported (hydro/nscbc.py)
    with pytest.raises(NotImplementedError, match="nscbc_outflow"):
        sweep.precompute_transverse(case["U0"], case["opts"],
                                    {0: ("nscbc_outflow", "outflow"), 1: None, 2: None})
