"""The port's single-group radhydro slice end to end against quokka_tpu.

- RadhydroBench 16^3 f32 through `quokka_tpu_torch.Simulation(device="cpu")`
  (the plain K1-K6) against `quokka_tpu.Simulation` with
  `radiation.use_pallas = 1` and `fused_windows = 0` (its Pallas kernels,
  interpreted on the CPU), 2 steps with the same dt, in config A
  (`radiation.fused_substep = 1`, K4) and config B (`= 0`, K5 + K6).
  Tolerance, per component: max |port - jax| <= 2e-5 x max after step 1
  and <= 5e-5 x max after step 2. The same run in f64 agrees to ~1e-14,
  so the f32 gap is roundoff (XLA's FMA contractions) that the radiation
  fluxes, near zero at the start, amplify about a hundredfold in two
  steps, in f64 as in f32.
- Config A against config B in the port: rtol 5e-6, atol 5e-6 x scale
  (the bar of tests/test_fused_substep.py).
- The radiation-only path (hydro off): one step against quokka_tpu.
- `bench_radhydro`'s step equals the Simulation's step; radiation deck
  keys of unported features raise; the entry points default to CUDA.
"""

import dataclasses

import numpy as np
import pytest
import torch

import quokka_tpu
from quokka_tpu.problems.radhydro_bench import RadhydroBenchProblem as JBench
from quokka_tpu.radiation.system import RadOptions as JRadOptions
from quokka_tpu.registry import PhysicsTraits as JPhysics

import quokka_tpu_torch
from quokka_tpu_torch import step_profile
from quokka_tpu_torch.benchmarks import bench_radhydro, build_radhydro_step
from quokka_tpu_torch.interop import rad_options_from_fields
from quokka_tpu_torch.problems.radhydro_bench import RadhydroBenchProblem
from quokka_tpu_torch.registry import PhysicsTraits

DECK = """
geometry.prob_hi = 1.0 1.0 1.0
amr.n_cell = 16 16 16
cfl = 0.3
radiation.cfl = 0.3
max_timesteps = 2
stop_time = 1.0e10
verbose = 0
fused_windows = 0
radiation.use_pallas = 1
precision = single
"""


def _pair(jprob, tprob, extra):
    jsim = quokka_tpu.Simulation(jprob, quokka_tpu.ParmParse.from_string(DECK, extra))
    tsim = quokka_tpu_torch.Simulation(
        tprob, quokka_tpu_torch.ParmParse.from_string(DECK, extra), device="cpu")
    jsim.set_initial_conditions()
    tsim.set_initial_conditions()
    np.testing.assert_array_equal(np.asarray(jsim.U), tsim.U.numpy())
    return jsim, tsim


def _step_both(jsim, tsim):
    dt = jsim.compute_timestep()
    assert tsim.compute_timestep() == dt
    assert jsim.advance_single_step(dt) and tsim.advance_single_step(dt)
    for s in (jsim, tsim):
        s.t += dt
        s.dt_prev = dt
        s.istep += 1


def _scaled_gap(ref, got):
    return max(float(np.max(np.abs(got[c] - ref[c])) / np.max(np.abs(ref[c])))
               for c in range(ref.shape[0]))


@pytest.fixture(scope="module")
def runs():
    """States after steps 1 and 2 of both packages, per configuration."""
    out = {}
    for fused in (1, 0):
        jsim, tsim = _pair(JBench(), RadhydroBenchProblem(),
                           [f"radiation.fused_substep = {fused}"])
        assert tsim._radiation.n_substeps(jsim.compute_timestep()) in (10, 11)
        out[fused] = []
        for _ in range(2):
            _step_both(jsim, tsim)
            out[fused].append((np.asarray(jsim.U), tsim.U.numpy().copy()))
    return out


@pytest.mark.parametrize("fused", [1, 0], ids=["config_A_fused", "config_B_per_stage"])
def test_radhydro_f32_two_steps(runs, fused):
    (ref1, got1), (ref2, got2) = runs[fused]
    assert np.all(np.isfinite(got2))
    assert _scaled_gap(ref1, got1) <= 2e-5
    assert _scaled_gap(ref2, got2) <= 5e-5


def test_config_a_matches_config_b(runs):
    Ua, Ub = runs[1][1][1], runs[0][1][1]
    scale = np.max(np.abs(Ub), axis=(1, 2, 3), keepdims=True)
    assert np.all(np.abs(Ua - Ub) <= 5e-6 * np.abs(Ub) + 5e-6 * scale)


def test_radiation_only_step():
    class JRadOnly(JBench):
        physics = JPhysics(hydro_enabled=False, radiation_enabled=True)

    class RadOnly(RadhydroBenchProblem):
        physics = PhysicsTraits(hydro_enabled=False, radiation_enabled=True)

    jsim, tsim = _pair(JRadOnly(), RadOnly(), ["radiation.fused_substep = 0"])
    _step_both(jsim, tsim)
    ref, got = np.asarray(jsim.U), tsim.U.numpy()
    assert _scaled_gap(ref, got) <= 2e-5


def test_bench_radhydro_matches_simulation_step():
    """The benchmark's step equals the Simulation's step at that dt, bit for
    bit; bench_radhydro runs it."""
    pp = quokka_tpu_torch.ParmParse.from_string(DECK)
    sim = quokka_tpu_torch.Simulation(RadhydroBenchProblem(), pp, device="cpu")
    sim.set_initial_conditions()
    dt = sim.compute_timestep()
    step, nsub = build_radhydro_step(sim, dt)
    U1 = step(sim.U, 0.0)
    assert nsub in (10, 11)
    assert sim.advance_single_step(dt)
    assert torch.equal(U1, sim.U)
    mzones, seconds, nsub = bench_radhydro(sim, n_warmup=0, n_steps=1)
    assert mzones > 0 and seconds > 0 and nsub in (10, 11)


def test_step_profile_parts():
    """The parts that step_profile times are the step as evolve() runs it and
    its two halves; each kernel of the port is told apart by its name."""
    pp = quokka_tpu_torch.ParmParse.from_string(DECK, ["amr.n_cell = 8 8 8",
                                                       "max_timesteps = 1"])
    sim = quokka_tpu_torch.Simulation(RadhydroBenchProblem(), pp, device="cpu")
    sim.set_initial_conditions()
    sim.evolve()
    parts = step_profile._parts(sim)
    restore = step_profile._restorer(sim)
    assert list(parts) == ["step", "hydro half", "radiation subcycle"]
    U1 = sim.U
    parts["hydro half"]()
    parts["radiation subcycle"]()
    assert sim.U is U1 and sim.istep == 1
    parts["step"]()
    U2 = sim.U
    assert sim.istep == 2 and not torch.equal(U2, U1)
    restore()
    assert sim.istep == 1 and torch.equal(sim.U, U1)
    parts["step"]()
    assert torch.equal(sim.U, U2)
    names = {"void qk::rad_div_tile_kernel<0>(float const*)": "K6",
             "void qk::sweep_tile_kernel<0, 1>(float const*)": "K2",
             "rad_stage2_kernel": "K4 stage 2", "apply_kernel": "K3",
             "Memcpy DtoH (Device -> Pinned)": "copies",
             "void at::native::vectorized_elementwise_kernel": "plain torch"}
    assert {n: step_profile.kernel_of(n) for n in names} == names


def test_rad_options_round_trip():
    jo = JRadOptions(c=1.0e3, chat=1.0e2, arad=1.0, erad_floor=1e-10, beta_order=0,
                     include_work_term=False, max_substeps=7, use_pallas=True)
    d = dataclasses.asdict(jo)
    po = rad_options_from_fields(d)
    d.pop("use_pallas")
    assert dataclasses.asdict(po) == d
    with pytest.raises(ValueError, match="not in the port"):
        rad_options_from_fields(dict(d, tau_fn=None))


@pytest.mark.parametrize("key", ["radiation.wavespeed_correction = 1",
                                 "radiation.mixed_precision_coupling = 1",
                                 "radiation.dust_gas_interaction_coeff = 1e-30",
                                 "radiation.no_such_key = 1"])
def test_unported_radiation_keys_raise(key):
    pp = quokka_tpu_torch.ParmParse.from_string(DECK, [key])
    with pytest.raises(NotImplementedError, match=key.split(" =")[0]):
        quokka_tpu_torch.Simulation(RadhydroBenchProblem(), pp, device="cpu")


def test_entry_points_default_to_cuda():
    import inspect

    for fn in (quokka_tpu_torch.Simulation.__init__,
               RadhydroBenchProblem.set_initial_conditions,
               quokka_tpu_torch.problems.SedovProblem.set_initial_conditions):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            quokka_tpu_torch.Simulation(RadhydroBenchProblem(),
                                        quokka_tpu_torch.ParmParse.from_string(DECK))
