"""float64 radiation takes the plain versions of the radiation kernels.

On the card each radiation kernel wrapper (K4 `fused_substep`, K5
`source_update`, K6 `compute_rad_div`, K7 `compute_rad_axis_flux` and its
batched form) launches its float32 kernel or raises, so a float64 state has
to be sent to the plain versions at the call sites, as the JAX package
sends non-f32 states to XLA (`quokka_tpu/radiation/system.py:178-185`,
`radiation/advance.py:233`, `:302`, `:457`). Here, on the CPU, the
wrappers are replaced by guards that raise when they are handed a float64
tensor (`torch_port_common.refuse_f64_rad_kernels`), and the run is held
against the JAX package's float64 run.

- RadhydroBench 16^3 float64, one step at the JAX step's dt, in config A
  (`radiation.fused_substep = 1`: JAX's K4 gate is `fused_ok and U.dtype ==
  float32`) and config B (stage by stage: K6 and K5): every component
  within 1e-12 of its max (the two agree to ~5e-15).

The dense shell 16^3 + 1 level and the packed pulse 32^3 + 2 pool levels
run their float64 comparisons with JAX under the same guards
(`test_torch_amr_slice.py::test_shell_matches_jax`,
`test_torch_packed_levels.py::test_two_packed_levels_pulse_f64_matches_jax`).
"""

import numpy as np
import pytest
import torch

import quokka_tpu
from quokka_tpu.problems.radhydro_bench import RadhydroBenchProblem as JBench

import quokka_tpu_torch
from quokka_tpu_torch.problems.radhydro_bench import RadhydroBenchProblem
from quokka_tpu_torch.radiation import sweep as rsweep
from quokka_tpu_torch.radiation.system import RadOptions

from torch_port_common import refuse_f64_rad_kernels

DECK = """
geometry.prob_hi = 1.0 1.0 1.0
amr.n_cell = 16 16 16
cfl = 0.3
radiation.cfl = 0.3
max_timesteps = 1
stop_time = 1.0e10
verbose = 0
fused_windows = 0
radiation.use_pallas = 1
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The float64 plain radiation code on 16^3 tensors runs ~100x faster in
    one thread than in PyTorch's default of a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fused", [1, 0], ids=["config_A_fused", "config_B_per_stage"])
def test_radhydro_f64_step_takes_plain_versions(fused):
    extra = [f"radiation.fused_substep = {fused}"]
    jsim = quokka_tpu.Simulation(JBench(), quokka_tpu.ParmParse.from_string(DECK, extra),
                                 precision="double")
    tsim = quokka_tpu_torch.Simulation(
        RadhydroBenchProblem(), quokka_tpu_torch.ParmParse.from_string(DECK, extra),
        device="cpu", precision="double")
    jsim.set_initial_conditions()
    tsim.set_initial_conditions()
    assert tsim.U.dtype == torch.float64
    np.testing.assert_array_equal(np.asarray(jsim.U), tsim.U.numpy())
    dt = jsim.compute_timestep()
    assert tsim.compute_timestep() == dt
    assert tsim._radiation.n_substeps(dt) in (10, 11)
    assert jsim.advance_single_step(dt)
    with refuse_f64_rad_kernels():
        assert tsim.advance_single_step(dt)
    ref, got = np.asarray(jsim.U), tsim.U.numpy()
    for c in range(ref.shape[0]):
        scale = np.max(np.abs(ref[c]))
        assert np.max(np.abs(got[c] - ref[c])) <= 1e-12 * scale, c


def test_guard_refuses_f64_and_passes_f32():
    """The guard the float64 tests run under: a float64 tensor handed to a
    wrapper raises, a float32 one reaches the wrapper (on the CPU its plain
    version), and the wrappers are restored after the block."""
    opts = RadOptions(c=10.0, chat=5.0, arad=1.0)
    R = 1.0 + torch.rand((4, 8, 8, 8), dtype=torch.float64)
    orig = rsweep.compute_rad_axis_flux
    with refuse_f64_rad_kernels():
        with pytest.raises(AssertionError, match="float64 reached"):
            rsweep.compute_rad_axis_flux(R, 0, opts)
        got = rsweep.compute_rad_axis_flux(R.float(), 0, opts)
    assert rsweep.compute_rad_axis_flux is orig
    assert torch.equal(got, rsweep.rad_axis_flux_plain(R.float(), 0, opts))
