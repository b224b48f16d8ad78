"""The port's constrained-transport MHD path end to end against quokka_tpu.

- Orszag-Tang 16^3, 4 steps, through `MHDSimulation(device="cpu")`: in f64
  against quokka_tpu's XLA form (`mhd.use_pallas = 0`) at rtol 1e-12 + atol
  1e-12 x the largest magnitude of each quantity (density, momentum,
  energy, face field), in both loops (the windowed one, `verbose = 0`, and
  the host loop, `verbose = 1`), which take the same dt sequence; mass and
  total energy conserved to 1e-12 and max |div B| < 1e-11. In f32 with K8's
  plain version against quokka_tpu's Pallas path (`mhd.use_pallas = 1`,
  interpreted) within rtol 3e-5 + atol 3e-5 x the same scales (the bar of
  tests/test_mhd.py, whose atol is absolute), and max |div B| < 1e-5; max
  |div B| x dx below chip_smoke.py's bar of 32 float32 ulps of max |B_face|
  in both codes.
- Brio-Wu 64 x 1 x 1 (one active axis: K8's plain version, which the CPU
  takes at any shape) against quokka_tpu in f64.
- The unported keys and a decomposition raise, a CUDA MHDSimulation needs
  a GPU, `bench_mhd` runs, and the options carry over from quokka_tpu.
"""

import dataclasses

import numpy as np
import pytest
import torch

import quokka_tpu
from quokka_tpu.mhd import MHDOptions as JMHDOptions
from quokka_tpu.mhd.simulation import MHDSimulation as JMHDSimulation
from quokka_tpu.problems.mhd import BrioWuProblem as JBrioWu
from quokka_tpu.problems.mhd import OrszagTangProblem as JOrszagTang

import quokka_tpu_torch
from quokka_tpu_torch import MHDSimulation, step_profile
from quokka_tpu_torch.benchmarks import bench_mhd
from quokka_tpu_torch.interop import mhd_options_from_fields
from quokka_tpu_torch.mhd import sweep
from quokka_tpu_torch.problems.mhd import BrioWuProblem, OrszagTangProblem

OT_DECK = """
geometry.prob_hi = 1.0 1.0 1.0
amr.n_cell = 16 16 16
cfl = 0.3
stop_time = 1.0
max_timesteps = 4
"""


def _jax_run(problem, deck, extra, precision):
    sim = JMHDSimulation(problem, quokka_tpu.ParmParse.from_string(deck, extra),
                         precision=precision)
    sim.set_initial_conditions()
    sim.evolve()
    return np.asarray(sim.U), [np.asarray(b) for b in sim.Bf], sim.t, float(sim.final_divb)


def _port_run(problem, deck, extra, precision):
    sim = MHDSimulation(problem, quokka_tpu_torch.ParmParse.from_string(deck, extra),
                        precision=precision, device="cpu")
    sim.set_initial_conditions()
    sim.evolve()
    return sim


def _close(ref_U, ref_Bf, sim, rtol, atol_frac):
    """Per component, with atol = atol_frac x the largest magnitude of its
    quantity: the density, the momentum vector, the energy, the face field
    (Orszag-Tang is z-invariant, so m_z and Bf_z are zero up to roundoff and
    their own max is no scale)."""
    pairs = ((ref_U, sim.U.numpy(), ([0], [1, 2, 3], [4])),
             (np.stack(ref_Bf), np.stack([b.numpy() for b in sim.Bf]), ([0, 1, 2],)))
    for ref, arr, groups in pairs:
        assert np.all(np.isfinite(arr))
        for group in groups:
            scale = np.max(np.abs(ref[group]))
            for c in group:
                np.testing.assert_allclose(arr[c], ref[c], rtol=rtol,
                                           atol=atol_frac * scale, err_msg=f"component {c}")


@pytest.fixture(scope="module")
def ot_f64():
    """quokka_tpu's f64 run and the port's in both loops."""
    ref = _jax_run(JOrszagTang(), OT_DECK, ["verbose = 0", "mhd.use_pallas = 0"], "double")
    port = {v: _port_run(OrszagTangProblem(), OT_DECK, [f"verbose = {v}"], "double")
            for v in (0, 1)}
    return ref, port


@pytest.mark.parametrize("verbose", [0, 1])
def test_orszag_tang_f64_matches_jax(ot_f64, verbose):
    (U, Bf, t, _), port = ot_f64
    sim = port[verbose]
    assert sim.istep == 4 and abs(sim.t - t) <= 1e-14 * t
    _close(U, Bf, sim, 1e-12, 1e-12)
    rel = sim.conservation_rel_err
    assert abs(rel[0]) < 1e-12 and abs(rel[4]) < 1e-12
    assert sim.final_divb < 1e-11


def test_orszag_tang_loops_take_the_same_dts(ot_f64):
    _, port = ot_f64
    assert len(port[0].dts) == 4 and port[0].dts == port[1].dts
    assert torch.equal(port[0].U, port[1].U)


def test_orszag_tang_f32_matches_jax_pallas():
    U, Bf, t, jax_divb = _jax_run(JOrszagTang(), OT_DECK,
                                  ["verbose = 0", "mhd.use_pallas = 1"], "single")
    sweep.reset_launch_counts()
    sim = _port_run(OrszagTangProblem(), OT_DECK, ["verbose = 0"], "single")
    assert sim.U.dtype == torch.float32 and sim.istep == 4
    assert sweep.launch_counts["mhd_axis"] == 0  # the CPU takes the plain version
    _close(U, Bf, sim, 3e-5, 3e-5)
    assert sim.final_divb < 1e-5
    # the same roundoff count in both codes, below the 256^3 run's bar
    ulps = sim.divb_ulps()
    assert 0.0 < ulps < 32 and jax_divb / sim.final_divb * ulps < 32


def test_brio_wu_f64_matches_jax():
    deck = "amr.n_cell = 64 1 1\ncfl = 0.3\nstop_time = 0.1\nmax_timesteps = 12\n"
    U, Bf, t, _ = _jax_run(JBrioWu(), deck, ["verbose = 0"], "double")
    sim = _port_run(BrioWuProblem(), deck, ["verbose = 0"], "double")
    assert sim.istep == 12 and abs(sim.t - t) <= 1e-14 * t
    _close(U, Bf, sim, 1e-12, 1e-12)
    assert sim.final_divb == 0.0


@pytest.mark.parametrize("key", ["restartfile = chk00010", "plotfile_interval = 5",
                                 "checkpoint_interval = 5", "decomp"])
def test_unported_mhd_features_raise(key):
    pp = quokka_tpu_torch.ParmParse.from_string(OT_DECK, [] if key == "decomp" else [key])
    kw = {"decomp": object()} if key == "decomp" else {}
    with pytest.raises(NotImplementedError, match=key.split(" ")[0]):
        MHDSimulation(OrszagTangProblem(), pp, device="cpu", **kw)


def test_cuda_mhd_simulation_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        MHDSimulation(OrszagTangProblem(), quokka_tpu_torch.ParmParse.from_string(OT_DECK))


def test_bench_mhd_and_profile_parts():
    """bench_mhd times the windowed loop; the profile's MHD parts are a
    window of the main path's length and one right-hand side, and K8 is
    told apart by name."""
    deck = OT_DECK.replace("16 16 16", "8 8 8")
    sim = MHDSimulation(OrszagTangProblem(),
                        quokka_tpu_torch.ParmParse.from_string(deck, ["verbose = 0"]),
                        precision="single", device="cpu")
    mzones, seconds = bench_mhd(sim, n_warmup=1, n_steps=2)
    assert mzones > 0 and seconds > 0 and sim.istep == 3
    parts = step_profile._mhd_parts(sim)
    assert list(parts) == ["step", "rhs"]
    restore = step_profile._mhd_restorer(sim)
    U3 = sim.U
    parts["step"]()
    assert sim.istep == 3 + step_profile.MHD_WINDOW and not torch.equal(sim.U, U3)
    restore()
    assert sim.istep == 3 and torch.equal(sim.U, U3)
    assert step_profile.kernel_of("void qk::mhd_tile_kernel<1>(float const*)") == "K8"


def test_mhd_options_round_trip():
    jo = JMHDOptions(gamma=2.0, dx=(0.1, 0.2, 0.3), active_axes=(0, 1),
                     reconstruction_order=3, density_floor=1e-3, use_pallas=False)
    to = mhd_options_from_fields(dataclasses.asdict(jo))
    assert dataclasses.asdict(to) == dataclasses.asdict(jo)
    with pytest.raises(ValueError, match="nghost"):
        mhd_options_from_fields({**dataclasses.asdict(jo), "nghost": 2})
