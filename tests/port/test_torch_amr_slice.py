"""The dense-level AMR radhydro slice of quokka_tpu_torch against
quokka_tpu's `AMRSimulation`: the radiation-driven shell at 16^3 + one
level (32^3 extent, 15424 active fine cells), two subcycled coarse steps
with reflux and the level radiation, on the CPU (the kernels' plain
versions).

The two JAX references run in processes of their own (`jax_amr_shell.py`),
beside the port's runs in this one:

- float64, `use_pallas = 0`, with XLA:CPU kept from contracting fused
  multiply-adds (why: `jax_amr_shell.py`): per level, every component
  within 1e-12 of its max, the masks equal; the port's run never hands a
  float64 tensor to a radiation kernel wrapper (on the card each launches
  its float32 kernel or raises);
- float32, `hydro.use_pallas = radiation.use_pallas = 1` (the Pallas
  kernels interpreted, XLA's fused multiply-adds as in the JAX package's
  own tests): the masks equal, and per level, the gas density within 5e-6
  of its max, the other gas components within 1e-3, the radiation energy
  within 1e-2 and the radiation flux within 1e-1. These are wide because
  on the shell's free-streaming cells |f|^2 = 1 to the last bit: one ulp
  flips the transport's admissibility test there and moves that face's
  flux by O(1) (the two JAX float32 runs, with and without fused
  multiply-adds, differ by 2.7e-2 of the radiation flux's max after two
  steps; the port sits 2.5e-2 from either).
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from quokka_tpu_torch import ParmParse
from quokka_tpu_torch.amr import AMRSimulation
from quokka_tpu_torch.indices import EGAS, RHO
from quokka_tpu_torch.interop import amr_levels_to_numpy
from quokka_tpu_torch.problems.radhydro_shell import RadhydroShellProblem
from quokka_tpu_torch.registry import EOSTraits, PhysicsTraits, Problem

from jax_amr_shell import shell_deck
from torch_port_common import refuse_f64_rad_kernels

HERE = Path(__file__).resolve().parent
N, STEPS = 16, 2
# per-component bound (x the component's max) of the f32 comparison:
# gas density, the other gas components, E_rad, the radiation flux
F32_BOUNDS = [5e-6] + [1e-3] * 5 + [1e-2] + [1e-1] * 3


class _JaxRun:
    """The JAX reference, started at once in its own process; its output goes
    to a file (a pipe nobody reads would stall it)."""

    def __init__(self, out: Path, precision: str, use_pallas: int, no_fma: bool):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        if no_fma:
            env["XLA_FLAGS"] = "--xla_cpu_max_isa=AVX"
        else:
            env.pop("XLA_FLAGS", None)
        self.out = out
        self.log = out.with_suffix(".log")
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, str(HERE / "jax_amr_shell.py"), str(out), precision,
                 str(use_pallas), str(STEPS), str(N)],
                env=env, stdout=log, stderr=subprocess.STDOUT)

    def result(self):
        self.proc.wait(timeout=1200)
        assert self.proc.returncode == 0, self.log.read_text()[-3000:]
        return dict(np.load(self.out))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU runs take one thread each: beside the JAX references
    and the other test workers, PyTorch's default of a thread per core
    oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_shell(precision, steps=STEPS, extra=""):
    pp = ParmParse.from_string(shell_deck(N, steps) + extra)
    sim = AMRSimulation(RadhydroShellProblem(), pp, device="cpu", precision=precision)
    sim.set_initial_conditions()
    return sim


def run_port(precision):
    """(the evolved port run, its levels at the start). The float64 run goes
    under `refuse_f64_rad_kernels`: it must take the plain versions of K5
    and K7, as the JAX package takes XLA (the float32 run, in another
    thread meanwhile, passes the guards)."""
    sim = port_shell(precision)
    init = amr_levels_to_numpy(sim)[0]
    if precision == "double":
        with refuse_f64_rad_kernels():
            sim.evolve()
    else:
        sim.evolve()
    return sim, init


@pytest.fixture(scope="module")
def shell_runs(tmp_path_factory):
    """The two JAX references (processes of their own) and the port's two
    runs (threads of their own: PyTorch releases the GIL inside its
    operations), all started at once. The float64 test comes first in this
    file and the float32 test last, so the tests between them run while the
    slower float32 reference (Pallas interpreted) finishes."""
    out = tmp_path_factory.mktemp("amr_shell")
    jax = {"double": _JaxRun(out / "f64.npz", "double", 0, True),
           "single": _JaxRun(out / "f32.npz", "single", 1, False)}
    with ThreadPoolExecutor(2) as pool:
        port = {p: pool.submit(run_port, p) for p in jax}
        yield {p: (port[p], jax[p]) for p in jax}
    for run in jax.values():  # a failed test may leave one running
        run.proc.kill()


def check_levels(sim, ref, bounds):
    Us, masks = amr_levels_to_numpy(sim)
    assert sim.finest_level == int(ref["finest"]) == 1
    for l in range(len(Us)):
        np.testing.assert_array_equal(masks[l], ref[f"mask{l}"], err_msg=f"mask {l}")
        a, b = Us[l].astype(np.float64), ref[f"U{l}"].astype(np.float64)
        assert np.all(np.isfinite(a))
        for c in range(b.shape[0]):
            scale = np.max(np.abs(b[c]))
            err = np.max(np.abs(a[c] - b[c]))
            assert err <= bounds[c] * scale, (l, c, err / scale, bounds[c])


def test_shell_matches_jax(shell_runs):
    """float64 against the JAX package's XLA path."""
    port, jax = shell_runs["double"]
    sim, init = port.result()
    ref = jax.result()
    for l, u in enumerate(init):  # the initial conditions and the regrid
        b = ref[f"init_U{l}"]
        assert np.max(np.abs(u - b)) <= 1e-14 * np.max(np.abs(b)), l
    check_levels(sim, ref, [1e-12] * 10)
    assert sim.t == pytest.approx(float(ref["t"]), rel=1e-15)
    # the JAX package's evolve adds the root's cells a second time a step
    assert sim.cell_updates == int(ref["cell_updates"]) - STEPS * N**3
    assert sim.cell_updates_raw == STEPS * (N**3 + 2 * (2 * N) ** 3)
    assert abs(sim.conservation_rel_err[RHO]) < 1e-11


# ------------------------------------------------- conservation by reflux
class Blast3D(Problem):
    """Periodic 3D blast with pressure-gradient tagging (the 3D form of
    tests/test_amr.py's Blast2D)."""

    name = "Blast3D_AMR_port"
    physics = PhysicsTraits(hydro_enabled=True)
    eos_traits = EOSTraits(gamma=1.4)

    def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
        x, y, z = grid.cell_center_mesh(torch.float64, device)
        r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
        P = torch.where(r2 < 0.02, 10.0, 0.1).expand(grid.n_cell)
        eint = P / (self.eos_traits.gamma - 1.0)
        U = torch.zeros((6, *grid.n_cell), dtype=dtype, device=device)
        U[RHO] = 1.0
        U[EGAS] = eint
        U[5] = eint
        return U

    def error_est(self, sim, level):
        q = sim.level_U[level][EGAS]
        grad = torch.zeros_like(q)
        for d in range(3):
            grad = torch.maximum(grad, (torch.roll(q, -1, d) - torch.roll(q, 1, d)).abs()
                                 / q.abs().clamp(min=1e-10))
        return grad > 0.05


@pytest.fixture(scope="module")
def blast_run():
    """One refluxed Blast3D run shared by three tests: two coarse steps
    through `bench_amr_shell` (one warm-up, one timed: the regrid of the
    third would change the count), the step profile's restorer taken there,
    coarse steps 3 and 4, then the restore."""
    from quokka_tpu_torch.benchmarks import bench_amr_shell
    from quokka_tpu_torch.step_profile import _amr_restorer

    sim = blast_sim()
    run = {"finest_at_start": sim.finest_level,
           "bench": bench_amr_shell(sim, n_warmup=1, n_steps=1),
           "istep_bench": sim.istep, "fine_active": sim._active_cells(1)}
    before = [u.clone() for u in sim.level_U]
    restore = _amr_restorer(sim)
    sim.max_timesteps = 4
    sim.evolve()
    run["istep_end"] = sim.istep
    run["rel_err"] = np.array(sim.conservation_rel_err)
    run["moved"] = not torch.equal(sim.level_U[1], before[1])
    restore()
    run["restored"] = (sim.istep, sim.U is sim.level_U[0],
                       [torch.equal(a, b) for a, b in zip(sim.level_U, before)])
    return run


@pytest.mark.parametrize("reflux", [1, 0])
def test_reflux_required_for_conservation(reflux, request):
    """Refluxed: the composite mass and energy hold to roundoff; without
    reflux the audit must see the coarse-fine flux mismatch (the negative control of
    tests/test_amr.py::test_reflux_required_for_conservation). Four coarse
    steps each."""
    if reflux:
        run = request.getfixturevalue("blast_run")
        assert run["istep_end"] == 4
        finest, rel_err = run["finest_at_start"], run["rel_err"]
    else:
        sim = blast_sim(reflux=reflux)
        finest = sim.finest_level
        sim.evolve()
        assert sim.istep == 4
        rel_err = sim.conservation_rel_err
    assert finest == 1
    err = np.abs(rel_err[[RHO, EGAS]])
    if reflux:  # roundoff (0 and 1.9e-16 measured)
        assert np.all(err < 1e-13), err
    else:  # the coarse-fine flux mismatch (1.3e-9 and 7.4e-10 measured)
        assert np.all(err > 1e-10), err


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("line,key", [
    ("amr.sparse_min_level = 1", "amr.sparse_min_level"),
    pytest.param("amr.sparse_min_level = 1\namr.pool_packed = 0", "amr.pool_packed",
                 id="unpacked pools-amr.pool_packed"),
    ("do_subcycle = 0", "do_subcycle"),
    ("cooling.enabled = 1", "cooling.enabled"),
    ("particles.enabled = 1", "particles.enabled"),
    ("gravity.enabled = 1", "gravity.enabled"),
    ("restartfile = chk00010", "restartfile"),
    ("plotfile_interval = 10", "plotfile_interval"),
    ("checkpoint_interval = 10", "checkpoint_interval"),
])
def test_unported_keys_raise(line, key):
    pp = ParmParse.from_string(shell_deck(N, 1) + line)
    with pytest.raises(NotImplementedError, match=key):
        AMRSimulation(RadhydroShellProblem(), pp, device="cpu")


def test_decomp_raises():
    with pytest.raises(NotImplementedError, match="decomp"):
        AMRSimulation(RadhydroShellProblem(), ParmParse.from_string(shell_deck(N, 1)),
                      device="cpu", decomp=object())


def test_cuda_amr_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        AMRSimulation(RadhydroShellProblem(), ParmParse.from_string(shell_deck(N, 1)))


def blast_sim(steps=4, reflux=1):
    pp = ParmParse.from_string(f"""
        geometry.prob_hi = 1.0 1.0 1.0
        amr.n_cell = 16 16 16
        amr.max_level = 1
        cfl = 0.3
        stop_time = 0.02
        max_timesteps = {steps}
        do_reflux = {reflux}
        verbose = 0
        """)
    sim = AMRSimulation(Blast3D(), pp, device="cpu")
    sim.set_initial_conditions()
    return sim


def test_bench_amr_shell_counts(blast_run):
    """`bench_amr_shell` counts the timed steps' active cells (the root
    once a coarse step, the fine level's refined cells twice) and raw
    cells (every cell of both levels)."""
    active, raw, secs = blast_run["bench"]
    assert blast_run["istep_bench"] == 2 and secs > 0
    fine = blast_run["fine_active"]
    assert raw / active == pytest.approx((16**3 + 2 * 32**3) / (16**3 + 2 * fine))


def test_step_profile_amr_restorer(blast_run):
    """The AMR step profile times every repetition from the same state:
    after two more coarse steps, the restore brings back step 2's levels
    bitwise."""
    assert blast_run["moved"]
    istep, root_is_level0, equal = blast_run["restored"]
    assert istep == 2 and root_is_level0 and all(equal)


def test_padded_hydro_refuses_mask_fill_fn():
    """The padded hydro step pads its FOFC masks itself; a caller's mask
    fill (the JAX signature's `mask_fill_fn`) is not taken."""
    from quokka_tpu_torch.hydro.advance import advance_hydro_rk2

    sim = blast_sim(steps=0)
    with pytest.raises(NotImplementedError, match="mask_fill_fn"):
        advance_hydro_rk2(sim.level_U[0], 1e-4, sim.level_opts[0],
                          fill_fn=lambda U: U, ng=sim.ng, mask_fill_fn=lambda m: m)


def test_amr_entry_points_default_to_cuda():
    import inspect

    for fn in (AMRSimulation.__init__, RadhydroShellProblem.set_initial_conditions,
               RadhydroShellProblem.set_radiation_energy_source):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_shell_f32_matches_pallas(shell_runs):
    """float32 against the JAX package with both Pallas kernels
    interpreted (this file's last test: see `shell_runs`)."""
    port, jax = shell_runs["single"]
    sim32, _ = port.result()
    check_levels(sim32, jax.result(), F32_BOUNDS)
    # the port sums in float64: the composite mass holds to f32 roundoff
    assert abs(sim32.conservation_rel_err[RHO]) < 1e-6
