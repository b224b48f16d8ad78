"""The classic hydro formulation of quokka_tpu_torch (`rk2_stage`,
`_advance_hydro_rk2_classic`) against the JAX package's, on the CPU, and
the repairs that come with it.

Where the JAX dispatch takes its XLA formulation the port now runs the
classic one: any float64 state (padded: reflecting walls filled by
`boundaries.fill_ghosts`, a periodic domain unpadded), f32 above 272 cells
an axis with ``QUOKKA_PALLAS_LEAN=0``, `rk_order` 1 above 272; MHD in
float64 takes K8's plain form. Tolerances, against the JAX result per
component: float64, 1e-12 of the component's largest magnitude (the
formulations agree to roundoff); float32, rtol 1e-5 plus 64 ulps of the
component's max (`ulp_close`, the bound of tests/test_fused_update.py).

The dense AMR level's fused step (K1 + K2 + K2d on the padded level, what
the card runs at every extent) against the JAX package's classic level
step, which it takes above 176 padded cells (`fits_vmem`): the shell at
16^3 + 1 level in float64, the JAX reference forced classic with
QUOKKA_FUSED_REFLUX_MAX_DIM=0 in a process of its own without fused
multiply-adds (why: tests/port/jax_amr_shell.py), every level within 1e-12
of each component's max, the masks equal (the association of the time
average and the divergence is all that differs).

Also: `debug.check_states` fails a step with the JAX package's message,
and a dropped radhydro simulation is freed without the garbage collector.
"""

import dataclasses
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quokka_tpu
from quokka_tpu.eos import IdealGasEOS as JEOS
from quokka_tpu.hydro import advance as jadv
from quokka_tpu.mhd import advance as jmadv
from quokka_tpu.mhd.simulation import MHDSimulation as JMHDSimulation
from quokka_tpu.problems.sedov import SedovProblem as JSedov

import quokka_tpu_torch
from quokka_tpu_torch import ParmParse
from quokka_tpu_torch.amr import AMRSimulation
from quokka_tpu_torch.hydro import advance
from quokka_tpu_torch.interop import (amr_levels_to_numpy, hydro_options_from_fields,
                                      mhd_options_from_fields, mhd_state_from_numpy)
from quokka_tpu_torch.mhd import advance as madv
from quokka_tpu_torch.problems.radhydro_bench import DECK_256, RadhydroBenchProblem
from quokka_tpu_torch.problems.radhydro_shell import RadhydroShellProblem
from quokka_tpu_torch.problems.sedov import SedovProblem

from jax_amr_shell import shell_deck
from jax_ref import SharedJaxRun, run_root
from torch_port_common import ulp_close

N = 16
SEDOV_DECK = f"""
geometry.prob_hi = 1.2 1.2 1.2
amr.n_cell = {N} {N} {N}
cfl = 0.3
max_timesteps = 2
verbose = 0
"""


def close_f64(ref, got, rel=1e-12, what=""):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape and np.all(np.isfinite(got)), what
    for c in range(ref.shape[0]):
        scale = np.max(np.abs(ref[c]))
        err = np.max(np.abs(got[c] - ref[c]))
        assert err <= rel * scale, (what, c, err / scale)


def well_state(shape, seed):
    """Seeded conserved float64 state with three density/pressure wells
    between colliding streams: on a periodic box its update goes invalid
    in both RK stages (the FOFC fallback fires) and stays finite."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.5 * rng.random(shape)
    v = 0.3 * rng.standard_normal((3,) + shape)
    eint = 1.0 + rng.random(shape)
    for i, j, k in ((2, 2, 2), (9, shape[1] - 4, 5), (shape[0] - 2, 3, shape[2] - 5)):
        rho[i, j, k], eint[i, j, k] = 1e-3, 1e-6
        v[0, i + 1, j, k], v[0, i - 1, j, k] = 6.0, -6.0
    ke = 0.5 * rho * (v * v).sum(axis=0)
    return np.stack([rho, rho * v[0], rho * v[1], rho * v[2], rho * eint + ke, rho * eint])


def opts_pair(n, dtype_rk=2, shape=None):
    shape = shape or (n, n, n)
    jo = jadv.HydroOptions(dx=tuple(1.0 / s for s in shape), eos=JEOS(gamma=1.4),
                           active_axes=(0, 1, 2), reconstruction_order=3, use_pallas=True,
                           reconstruct_eint=False, rk_order=dtype_rk)
    return jo, hydro_options_from_fields(dataclasses.asdict(jo))[0]


@pytest.fixture(scope="module", autouse=True)
def amr_ref(tmp_path_factory):
    """The JAX dense shell (16^3 + 1, float64, 2 coarse steps), its level
    steps forced onto the classic flux formulation, started when the
    module's first test runs (shared by xdist workers)."""
    return SharedJaxRun(run_root(tmp_path_factory), "jax_classic_amr", "jax_amr_shell.py",
                        ["double", 0, 2, N], env={"QUOKKA_FUSED_REFLUX_MAX_DIM": "0"})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- unigrid
def test_sedov_f64_walls_takes_padded_classic():
    """Sedov 16^3 float64 with reflecting walls, 2 steps through
    `Simulation`: the port pads the walls and runs the classic form, as the
    JAX package does."""
    jsim = quokka_tpu.Simulation(JSedov(), quokka_tpu.ParmParse.from_string(SEDOV_DECK),
                                 precision="double")
    tsim = quokka_tpu_torch.Simulation(SedovProblem(), ParmParse.from_string(SEDOV_DECK),
                                       device="cpu", precision="double")
    gf = tsim._ghost_free_config()
    assert gf["bc_kinds"] is None and gf["ng"] == (4, 4, 4)
    for sim in (jsim, tsim):
        sim.set_initial_conditions()
        sim.evolve()
    assert tsim.istep == jsim.istep == 2
    close_f64(np.asarray(jsim.U), tsim.U.numpy(), what="Sedov f64")


@pytest.mark.parametrize("rk_order", [2, 1])
def test_periodic_rough_f64_classic(rk_order):
    """A rough periodic 16^3 float64 state (the FOFC fallback fires), one
    step of each RK order: the classic branch, unpadded, against JAX."""
    U = well_state((N, N, N), seed=4)
    jo, to = opts_pair(N, rk_order)
    assert advance._branch(torch.zeros(1, 1, 1, 1, dtype=torch.float64), to, True, False,
                           (0, 0, 0)) == "classic"
    dt = 0.2 / N
    jU, jst = jadv.advance_hydro_rk2(jnp.asarray(U), dt, jo, lambda X: X, (0, 0, 0),
                                     (True,) * 3)
    tU, tst = advance.advance_hydro_rk2(torch.tensor(U), dt, to, lambda X: X, (0, 0, 0),
                                        (True,) * 3)
    assert int(jst["n_fofc"]) > 0 and int(tst["n_fofc"]) == int(jst["n_fofc"])
    assert tst["fofc_fallbacks"] == rk_order  # every stage fell back
    close_f64(np.asarray(jU), tU.numpy(), what=f"rk{rk_order}")


def test_f32_above_272_lean_off_is_classic(monkeypatch):
    """QUOKKA_PALLAS_LEAN=0 on a rough periodic 280 x 8 x 8 f32 box: the
    JAX package runs its classic XLA path, the port its classic form with
    K1/K2's face sweeps (the plain versions here)."""
    monkeypatch.setenv("QUOKKA_PALLAS_LEAN", "0")
    shape = (280, 8, 8)
    U = well_state(shape, seed=9).astype(np.float32)
    jo, to = opts_pair(None, 2, shape)
    assert advance._branch(torch.tensor(U), to, True, False, (0, 0, 0)) == "classic"
    dt = 0.2 / shape[0]
    jU, jst = jadv.advance_hydro_rk2(jnp.asarray(U), dt, jo, lambda X: X, (0, 0, 0),
                                     (True,) * 3)
    tU, tst = advance.advance_hydro_rk2(torch.tensor(U), dt, to, lambda X: X, (0, 0, 0),
                                        (True,) * 3)
    assert int(tst["n_fofc"]) == int(jst["n_fofc"]) > 0
    ulp_close(np.asarray(jU), tU, what="LEAN=0 280x8x8")


def test_ghost_free_f64_refused():
    """Ghost-free stepping needs the kernel sweep: a float64 state with
    `bc_kinds` is refused, as the JAX package's `compute_fluxes` refuses
    it."""
    _, to = opts_pair(8)
    with pytest.raises(ValueError, match="ghost-free"):
        advance.compute_fluxes(torch.zeros((6, 8, 8, 8), dtype=torch.float64), to,
                               bc_kinds={0: None, 1: None, 2: None})


def test_mhd_f64_takes_the_plain_form(monkeypatch):
    """Orszag-Tang 16^3 float64: `mhd_rhs` takes K8's plain form without
    the kernel wrapper (the JAX package's `use_kernel` test sends f64 to
    XLA) and equals the JAX right-hand side."""
    from quokka_tpu.problems.mhd import OrszagTangProblem as JOT

    deck = "amr.n_cell = 16 16 16\nmax_timesteps = 1\nverbose = 0\n"
    jsim = JMHDSimulation(JOT(), quokka_tpu.ParmParse.from_string(deck), precision="double")
    jsim.set_initial_conditions()
    jopts = dataclasses.replace(jsim.opts, use_pallas=True)
    topts = mhd_options_from_fields(dataclasses.asdict(jopts))
    U, Bf = mhd_state_from_numpy(np.asarray(jsim.U), [np.asarray(b) for b in jsim.Bf],
                                 "cpu", torch.float64)

    def refuse(*a, **k):
        raise AssertionError("float64 reached the kernel wrapper")

    monkeypatch.setattr(madv, "compute_mhd_axis", refuse)
    dU, dB = madv.mhd_rhs(U, Bf, topts)
    jdU, jdB = jmadv.mhd_rhs(jsim.U, jsim.Bf, jopts)
    close_f64(np.asarray(jdU), dU.numpy(), what="dU")
    close_f64(np.stack([np.asarray(b) for b in jdB]), torch.stack(dB).numpy(), what="dB")


# --------------------------------------------------------- dense AMR level
def test_dense_level_fused_matches_jax_classic(amr_ref, monkeypatch):
    """The port's padded levels forced onto the fused level step in float64
    (what the card runs in f32) against the JAX package's classic level
    step: 16^3 + 1 level, 2 coarse steps, every level to 1e-12 of each
    component's max, the masks equal."""
    branches = []
    orig = advance._branch

    def fused_levels(U, opts, padded, return_fluxes, ng, corr=False):
        if padded and return_fluxes:
            branches.append("fused")
            return "fused"
        return orig(U, opts, padded, return_fluxes, ng, corr)

    monkeypatch.setattr(advance, "_branch", fused_levels)
    sim = AMRSimulation(RadhydroShellProblem(), ParmParse.from_string(shell_deck(N, 2)),
                        device="cpu", precision="double")
    sim.set_initial_conditions()
    sim.evolve()
    assert branches.count("fused") >= 6  # the root's 2 and level 1's 4 level steps
    ref = amr_ref.result()
    Us, masks = amr_levels_to_numpy(sim)
    assert sim.finest_level == int(ref["finest"]) == 1
    for l in range(2):
        np.testing.assert_array_equal(masks[l], ref[f"mask{l}"])
        close_f64(ref[f"U{l}"], Us[l], what=f"level {l}")


# ------------------------------------------------------------- satellites
def test_check_states_fails_the_step_as_jax(monkeypatch):
    """`debug.check_states = 1`: after each accepted step the state is
    checked, and a step that leaves a non-positive internal energy (here
    planted by the step itself, past the validity test that drives the
    retry ladder) ends in FloatingPointError naming the first invalid cell,
    with the JAX package's message; off, the run goes on."""
    deck = SEDOV_DECK.replace("max_timesteps = 2", "max_timesteps = 1") + \
        "debug.check_states = 1\nfused_windows = 0\n"

    def planting(cls, setter):
        orig = cls.advance_single_step

        def step(self, dt):
            ok = orig(self, dt)
            self.U = setter(self.U)
            return ok
        monkeypatch.setattr(cls, "advance_single_step", step)

    def plant_t(U):
        U = U.clone()
        U[5, 2, 3, 4] = -1.0
        return U

    planting(quokka_tpu.Simulation, lambda U: U.at[5, 2, 3, 4].set(-1.0))
    planting(quokka_tpu_torch.Simulation, plant_t)
    msgs = []
    for sim in (quokka_tpu.Simulation(JSedov(), quokka_tpu.ParmParse.from_string(deck),
                                      precision="double"),
                quokka_tpu_torch.Simulation(SedovProblem(), ParmParse.from_string(deck),
                                            device="cpu", precision="double")):
        sim.set_initial_conditions()
        with pytest.raises(FloatingPointError) as e:
            sim.evolve()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "component 5 at cell (2,3,4)" in msgs[1]
    off = quokka_tpu_torch.Simulation(SedovProblem(), ParmParse.from_string(
        deck.replace("debug.check_states = 1", "debug.check_states = 0")),
        device="cpu", precision="double")
    off.evolve()
    assert off.istep == 1


def test_dropped_radhydro_simulation_is_freed():
    """The radiation subsystems hold their simulation weakly: a dropped
    radhydro simulation (unigrid, and a dense AMR hierarchy with its level
    radiation) is freed at once, without the garbage collector."""
    gc.disable()
    try:
        sim = quokka_tpu_torch.Simulation(RadhydroBenchProblem(), ParmParse.from_string(
            DECK_256, ["amr.n_cell = 8 8 8", "max_timesteps = 1", "verbose = 0"]),
            device="cpu", precision="single")
        sim.set_initial_conditions()
        sim.evolve()
        amr = AMRSimulation(RadhydroShellProblem(), ParmParse.from_string(shell_deck(N, 1)),
                            device="cpu", precision="single")
        amr.set_initial_conditions()
        amr._get_level_rad(1)
        refs = [weakref.ref(sim), weakref.ref(sim._radiation), weakref.ref(amr)]
        del sim, amr
        assert [r() for r in refs] == [None, None, None]
    finally:
        gc.enable()
