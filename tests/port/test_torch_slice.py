"""The port's unigrid hydro slice end to end against quokka_tpu.

- Sedov 16^3 f32 through `quokka_tpu_torch.Simulation(device="cpu")` (the
  plain K1-K3 versions) against `quokka_tpu.Simulation` with
  `hydro.use_pallas = 1` (its fused Pallas path, interpreted on the CPU),
  both driven with the same dt: one step at rtol 1e-5 + 64 ulps of each
  component's max; five steps at max abs difference <= 1e-5 x the
  component's max.
- The same step in f64 against quokka_tpu's default CPU path (the classic
  ghost-padded XLA formulation) at 1e-12 relative to each component's max.
- A rough seeded state that fires the FOFC fallback in both packages.
- `import quokka_tpu_torch` keeps jax out of the process, and a CUDA
  Simulation refuses to start without a GPU.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import quokka_tpu
from quokka_tpu.hydro import advance as jadv
from quokka_tpu.problems.sedov import SedovProblem as JSedov

import quokka_tpu_torch
from quokka_tpu_torch import kernel_check
from quokka_tpu_torch.benchmarks import bench_hydro, build_step_runner
from quokka_tpu_torch.hydro.advance import advance_hydro_rk2
from quokka_tpu_torch.problems.sedov import SedovProblem

from torch_port_common import (BC_KINDS, jax_opts, make_state, port_opts, t32,
                               ulp_close)

DECK = """
geometry.prob_hi = 1.2 1.2 1.2
amr.n_cell = 16 16 16
cfl = 0.3
max_timesteps = 5
verbose = 0
fused_windows = 0
"""


def _pair(precision, use_pallas):
    extra = [f"precision = {precision}", f"hydro.use_pallas = {use_pallas}"]
    jsim = quokka_tpu.Simulation(
        JSedov(), quokka_tpu.ParmParse.from_string(DECK, extra))
    tsim = quokka_tpu_torch.Simulation(
        SedovProblem(), quokka_tpu_torch.ParmParse.from_string(DECK, extra),
        device="cpu")
    jsim.set_initial_conditions()
    tsim.set_initial_conditions()
    np.testing.assert_array_equal(np.asarray(jsim.U), tsim.U.numpy())
    return jsim, tsim


def _step_both(jsim, tsim):
    dt = jsim.compute_timestep()
    assert jsim.advance_single_step(dt) and tsim.advance_single_step(dt)
    for s in (jsim, tsim):
        s.t += dt
        s.dt_prev = dt
        s.istep += 1


@pytest.fixture(scope="module")
def f32_runs():
    """States after steps 1..5 from both packages (one JAX compile)."""
    jsim, tsim = _pair("single", 1)
    out = []
    for _ in range(5):
        _step_both(jsim, tsim)
        out.append((np.asarray(jsim.U), tsim.U.numpy().copy()))
    return out


def test_sedov_f32_one_step(f32_runs):
    ref, got = f32_runs[0]
    ulp_close(ref, got, what="Sedov 16^3 step 1")


def test_sedov_f32_five_steps(f32_runs):
    ref, got = f32_runs[4]
    assert np.all(np.isfinite(got))
    for c in range(ref.shape[0]):
        scale = np.max(np.abs(ref[c]))
        assert np.max(np.abs(got[c] - ref[c])) <= 1e-5 * scale, c


def test_sedov_f64_classic_one_step():
    jsim, tsim = _pair("double", 0)
    _step_both(jsim, tsim)
    ref, got = np.asarray(jsim.U), tsim.U.numpy()
    assert got.dtype == np.float64
    for c in range(ref.shape[0]):
        scale = np.max(np.abs(ref[c]))
        np.testing.assert_allclose(got[c], ref[c], rtol=1e-12, atol=1e-12 * scale)


def test_fofc_fallback_rough_state():
    n = 16
    bc = BC_KINDS["reflect_all"]
    U = make_state((n, n, n), seed=3, rough=True).astype(np.float32)
    jo = jax_opts(n)
    dt = 0.2 / n
    jU, jst = jadv.advance_hydro_rk2(jnp.asarray(U), dt, jo, lambda X: X,
                                     (0, 0, 0), (False,) * 3, bc_kinds=bc)
    tU, tst = advance_hydro_rk2(t32(U), dt, port_opts(jo), None, (0, 0, 0),
                                (False,) * 3, bc_kinds=bc)
    assert int(jst["n_fofc"]) > 0, "the rough state must exercise FOFC"
    assert int(tst["n_fofc"]) == int(jst["n_fofc"])
    assert tst["fofc_fallbacks"] >= 1
    ulp_close(jU, tU, what="FOFC step")


def test_step_runner_matches_simulation_step():
    """The benchmark's step (dt computed as a tensor) equals the Simulation's
    step at that dt, bit for bit; bench_hydro runs it."""
    pp = quokka_tpu_torch.ParmParse.from_string(DECK, ["precision = single"])
    sim = quokka_tpu_torch.Simulation(SedovProblem(), pp, device="cpu")
    sim.set_initial_conditions()
    U0 = sim.U
    U1, dt = build_step_runner(sim)(U0, torch.tensor(1e30, dtype=torch.float32))
    dt_host = sim.compute_timestep()
    assert abs(float(dt) - dt_host) <= 1e-6 * dt_host
    assert sim.advance_single_step(float(dt))
    assert torch.equal(U1, sim.U)
    mzones, seconds = bench_hydro(sim, n_warmup=1, n_steps=1)
    assert mzones > 0 and seconds > 0


def test_kernel_bound_reads_each_buffer_once():
    """The bound of K3 counts the state once where the main path passes it as
    both the base and the stage input: 6 components read, 18 divergence and
    3 face-velocity rows read, 6 components written, 4 B each."""
    n = 8
    U = t32(make_state((n, n, n), seed=4))
    assert kernel_check._nbytes(U, U) == kernel_check._nbytes(U) == U.numel() * 4
    assert kernel_check._nbytes(U, U.clone()) == 2 * U.numel() * 4
    cases = {c.label: c for c in kernel_check.cases(
        U, U, port_opts(jax_opts(n)), BC_KINDS["reflect_all"], 0.1 / n)}
    nbytes, _ = cases["K3"].cost()
    assert nbytes == (6 + 18 + 3 + 6) * 4 * n**3


def test_import_keeps_jax_out():
    code = ("import sys, quokka_tpu_torch, quokka_tpu_torch.simulation, "
            "quokka_tpu_torch.benchmarks, quokka_tpu_torch.interop, "
            "quokka_tpu_torch.kernel_check, quokka_tpu_torch.problems, "
            "quokka_tpu_torch.step_profile, quokka_tpu_torch.amr_memory, "
            "quokka_tpu_torch.radiation.advance, quokka_tpu_torch.radiation.source, "
            "quokka_tpu_torch.radiation.substep, quokka_tpu_torch.radiation.sweep, "
            "quokka_tpu_torch.mhd, quokka_tpu_torch.mhd.advance, quokka_tpu_torch.mhd.sweep, "
            "quokka_tpu_torch.mhd.simulation, quokka_tpu_torch.problems.mhd, "
            "quokka_tpu_torch.amr, quokka_tpu_torch.amr.hierarchy, "
            "quokka_tpu_torch.amr.operators, quokka_tpu_torch.boundaries, "
            "quokka_tpu_torch.problems.radhydro_shell, quokka_tpu_torch.amr.tilepool, "
            "quokka_tpu_torch.amr.sparse, quokka_tpu_torch.amr.pool_advance, "
            "quokka_tpu_torch.amr.packed, quokka_tpu_torch.amr.packed_driver, "
            "quokka_tpu_torch.radiation.pool; "
            "bad = [m for m in sys.modules if m in ('jax', 'quokka_tpu') or m.startswith(('jax.', 'quokka_tpu.'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cuda_simulation_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        quokka_tpu_torch.Simulation(SedovProblem(), quokka_tpu_torch.ParmParse(),
                                    device="cuda")


def test_unported_deck_keys_raise():
    pp = quokka_tpu_torch.ParmParse.from_string(DECK, ["cooling.enabled = 1"])
    with pytest.raises(NotImplementedError, match="cooling.enabled"):
        quokka_tpu_torch.Simulation(SedovProblem(), pp, device="cpu")
