"""Fewer than three active axes: the port's 1D and 2D hydro against
quokka_tpu, and the shocktube anchor.

- 1D and 2D float64 runs through `Simulation(device="cpu")` against
  `quokka_tpu.Simulation` (its classic XLA formulation, the JAX package's
  route for fewer than three axes), both started from the JAX package's
  initial state and driven with the same dt: the shocktube (user walls),
  Shu-Osher (user walls, a sine wave), Richtmyer-Meshkov 2D (outflow x,
  periodic y) and Quirk 2D (user x, periodic y, the odd-even column), each
  component within 1e-12 of its max after a few steps; the initial
  conditions within 1e-14.
- The shocktube deck (`decks/shocktube.in`: 1024 cells, PPM, t = 0.4) on
  the port alone: `error_norm` < 0.002 (the reference's criterion,
  `test_hydro_shocktube.cpp:377-382`), and PLM at 256 cells < 0.01 (as
  tests/test_hydro_shocktube.py).
- On the card (marked `cuda`): a 1D float32 step runs plain torch on the
  card, launches no kernel, and equals the CPU's.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import quokka_tpu
from quokka_tpu.problems.hydro_suite import QuirkProblem as JQuirk
from quokka_tpu.problems.hydro_suite import RichtmeyerMeshkovProblem as JRM
from quokka_tpu.problems.hydro_suite import ShuOsherProblem as JShuOsher
from quokka_tpu.problems.shocktube import ShocktubeProblem as JShocktube

import quokka_tpu_torch
from quokka_tpu_torch.hydro import sweep
from quokka_tpu_torch.problems import (QuirkProblem, RichtmeyerMeshkovProblem,
                                       ShocktubeProblem, ShuOsherProblem)

DECKS = Path(__file__).resolve().parents[2] / "decks"

CASES = {
    "shocktube 1D": (JShocktube, ShocktubeProblem, """
geometry.prob_hi = 5.0 1.0 1.0
amr.n_cell = 96 1 1
cfl = 0.6
""", 4),
    "Shu-Osher 1D": (JShuOsher, ShuOsherProblem, """
geometry.prob_hi = 10.0 1.0 1.0
amr.n_cell = 80 1 1
cfl = 0.5
""", 4),
    "Richtmyer-Meshkov 2D": (JRM, RichtmeyerMeshkovProblem, """
amr.n_cell = 24 24 1
cfl = 0.4
""", 3),
    "Quirk 2D": (JQuirk, QuirkProblem, """
amr.n_cell = 24 16 1
cfl = 0.4
hydro.reconstruction_order = 2
""", 3),
}


def _run_pair(name):
    jcls, tcls, deck, nsteps = CASES[name]
    deck += "stop_time = 10.0\nverbose = 0\nfused_windows = 0\nprecision = double\n"
    jsim = quokka_tpu.Simulation(jcls(), quokka_tpu.ParmParse.from_string(deck))
    tsim = quokka_tpu_torch.Simulation(tcls(), quokka_tpu_torch.ParmParse.from_string(deck),
                                       device="cpu")
    jsim.set_initial_conditions()
    tsim.set_initial_conditions()
    ref0 = np.asarray(jsim.U)
    got0 = tsim.U.numpy()
    for c in range(ref0.shape[0]):
        scale = np.max(np.abs(ref0[c]))
        assert np.max(np.abs(got0[c] - ref0[c])) <= 1e-14 * scale, (name, "IC", c)
    tsim.U = torch.tensor(ref0)
    tsim.init_sums = tsim._sums(tsim.U)
    assert tsim._gf["bc_kinds"] is None  # the classic padded path
    for _ in range(nsteps):
        dt = jsim.compute_timestep()
        assert jsim.advance_single_step(dt) and tsim.advance_single_step(dt)
        for s in (jsim, tsim):
            s.t += dt
            s.dt_prev = dt
            s.istep += 1
    return np.asarray(jsim.U), tsim.U.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_lowdim_f64_matches_jax(name):
    ref, got = _run_pair(name)
    assert got.dtype == np.float64 and np.all(np.isfinite(got))
    for c in range(ref.shape[0]):
        scale = np.max(np.abs(ref[c]))
        diff = np.max(np.abs(got[c] - ref[c]))
        assert diff <= 1e-12 * scale, (name, c, diff, scale)


def _shocktube(*overrides):
    pp = quokka_tpu_torch.ParmParse.from_file(str(DECKS / "shocktube.in"),
                                              overrides=["verbose=0", *overrides])
    sim = quokka_tpu_torch.Simulation(ShocktubeProblem(), pp, device="cpu")
    sim.set_initial_conditions()
    sim.evolve()
    return sim


def test_shocktube_deck_error_norm():
    sim = _shocktube()
    assert sim.t == pytest.approx(0.4, rel=1e-10)
    assert sim.U.dtype == torch.float64
    assert sim.error_norm < 0.002, sim.error_norm


def test_shocktube_plm_coarse():
    sim = _shocktube("amr.n_cell=256 1 1", "hydro.reconstruction_order=2")
    assert sim.error_norm < 0.01, sim.error_norm


def test_lowdim_refuses_bc_kinds():
    """Ghost-free stepping needs the kernels' three axes (the JAX package's
    `compute_fluxes` refuses it likewise)."""
    from quokka_tpu_torch.hydro.advance import compute_fluxes

    sim = quokka_tpu_torch.Simulation(
        ShocktubeProblem(), quokka_tpu_torch.ParmParse.from_string(
            "amr.n_cell = 16 1 1\nprecision = single\n"), device="cpu")
    sim.set_initial_conditions()
    with pytest.raises(ValueError, match="three|3D"):
        compute_fluxes(sim.U, sim.hydro_opts, bc_kinds={0: ("outflow", "outflow")})


@pytest.mark.cuda
def test_lowdim_f32_on_card_launches_no_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    deck = "geometry.prob_hi = 5.0 1.0 1.0\namr.n_cell = 128 1 1\ncfl = 0.6\n" \
           "max_timesteps = 5\nprecision = single\nverbose = 0\n"
    out = {}
    for dev in ("cuda", "cpu"):
        sweep.reset_launch_counts()
        sim = quokka_tpu_torch.Simulation(ShocktubeProblem(),
                                          quokka_tpu_torch.ParmParse.from_string(deck),
                                          device=dev)
        sim.set_initial_conditions()
        sim.evolve()
        out[dev] = sim.U.cpu()
        if dev == "cuda":
            assert not any(sweep.launch_counts.values())
    assert torch.equal(out["cuda"], out["cpu"])
