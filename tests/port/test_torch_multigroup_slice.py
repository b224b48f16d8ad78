"""The port's multigroup slice end to end against quokka_tpu, on the CPU.

- RadMultigroupPulse (decks/rad_multigroup_ppl.in: 16^3, 4 groups, hydro
  on, periodic) through `quokka_tpu_torch.Simulation(device="cpu")` in each
  opacity model, 2 steps; its initial state (to 1e-14) and dts equal the
  JAX run's:
  - float64 against `quokka_tpu.Simulation` run without fused multiply-adds
    (tests/port/jax_multigroup.py): within 1e-12 of each component's max
    after each step;
  - float32 (the plain K1-K3 and K6 over the 4 groups, the plain coupling)
    against the JAX package with `radiation.use_pallas = 1` (its K6 at G = 4
    and its hydro kernels interpreted), likewise without FMAs. Bars per
    component, of its max: piecewise_constant 2e-5 after step 1 and 5e-5
    after step 2, the bars of tests/port/test_torch_rad_slice.py; the PPL
    models 5e-5 and 1.5e-4. Measured (CPU, this file's inputs): 1.9e-5 /
    2.1e-5, fixed slope 3.9e-5 / 3.8e-5, full spectrum 3.4e-5 / 9.1e-5, all
    on the groups' radiation fluxes, which start at zero. The cause is where
    the float32 Newton solve stops: handed the same input, the port's and
    the JAX package's couplings agree within 2.1e-6 of each component's max
    in every cell that takes as many Newton iterations on both sides, and
    differ by up to 3.0e-5 only in cells whose iteration counts differ (by
    one in the worst cells; tests/port/mg_f32_gap.py, over the first 20
    couplings of each model; rounding the port's pow, log, exp and expm1
    in float32 instead of through float64 leaves every gap as it is).
    JAX's own float32 run is 1.9e-4 to 7.1e-4 from its float64 run on the
    same components, and the port's float32 run must stay within a quarter
    of that distance of JAX's.
- The 2-group RadhydroBench of tests/test_radhydro.py
  (`test_multigroup_radhydro_smoke`), 16^3, 4 steps, float64, within 1e-12.
- Marked `slow`, as the JAX package marks its own: the full-length anchors
  of tests/test_radhydro_pulse.py (MGconst against the grey pulse, rel L1 <
  0.008; MGint frame invariance, rel < 0.02) and tests/test_radhydro_bb.py
  (thermalization, rtol 0.02), on their decks, through the port alone.
"""

import numpy as np
import pytest
import torch

from jax_ref import SharedJaxRun, run_root
from torch_port_common import port_sim_like, scaled_gaps, step_like

MODELS = ("piecewise_constant", "ppl_fixed_slope", "ppl_full_spectrum")
REFS = tuple(f"mg_{m}_{p}" for m in MODELS for p in ("f64", "f32")) + ("bench_mg",)
# float32 bars after steps 1 and 2, per component, of its max (module doc)
F32_BARS = {"piecewise_constant": (2e-5, 5e-5), "ppl_fixed_slope": (5e-5, 1.5e-4),
            "ppl_full_spectrum": (5e-5, 1.5e-4)}


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    root = run_root(tmp_path_factory)
    return {case: SharedJaxRun(root, f"jax_multigroup_{case}", "jax_multigroup.py", [case])
            for case in REFS}


@pytest.fixture(scope="module")
def ref(jax_refs):
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = jax_refs[case].result()
        return cache[case]

    return get


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side takes one thread: beside the JAX processes and the
    other test workers a thread per core oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_runs(jax_refs):
    """{case: (sim, initial state, dts, [state after each step])}: the
    port's run of every case from its own initial state and timesteps, all
    made while the JAX references run (they started with the module)."""
    out = {}
    for case in REFS:
        sim = port_sim_like(case)
        U0 = sim.U.numpy().copy()
        states, dts = [], []
        while sim.istep < sim.max_timesteps:
            dts.append(sim.compute_timestep())
            step_like(sim, dts[-1])
            states.append(sim.U.numpy().copy())
        out[case] = (sim, U0, dts, states)
    return out


def _run(case, port_runs, ref, groups=4):
    """(sim, [state after each step], reference) of `case`; the port's
    initial state and dts equal the reference's."""
    sim, U0, dts, states = port_runs[case]
    assert sim.layout.n_groups == groups and sim.grid.active_axes == (0, 1, 2)
    assert not sim._radiation.fused
    r = ref(case)
    np.testing.assert_allclose(U0, r["U0"], rtol=1e-14, atol=0)
    np.testing.assert_array_equal(np.asarray(dts), r["dts"])
    return sim, states, r


@pytest.mark.parametrize("model", MODELS)
def test_mg_pulse_f64(model, port_runs, ref):
    sim, states, r = _run(f"mg_{model}_f64", port_runs, ref)
    assert sim.U.dtype == torch.float64 and len(states) == 2
    assert sim._radiation.opts.opacity_model == model
    for i, U in enumerate(states):
        gaps = scaled_gaps(U, r[f"U{i + 1}"])
        assert np.all(gaps <= 1e-12), (model, i + 1, gaps)


@pytest.mark.parametrize("model", MODELS)
def test_mg_pulse_f32(model, port_runs, ref):
    sim, states, r = _run(f"mg_{model}_f32", port_runs, ref)
    r64 = ref(f"mg_{model}_f64")
    assert sim.U.dtype == torch.float32
    for i, (U, bar) in enumerate(zip(states, F32_BARS[model])):
        assert np.all(np.isfinite(U))
        gaps = scaled_gaps(U, r[f"U{i + 1}"])
        assert np.all(gaps <= bar), (model, i + 1, gaps)
        # closer to JAX's float32 run than that run is to its float64 one
        own = scaled_gaps(r[f"U{i + 1}"], r64[f"U{i + 1}"])
        assert np.max(gaps) <= 0.25 * np.max(own), (model, i + 1, gaps.max(), own.max())


def test_bench_mg_f64(port_runs, ref):
    sim, states, r = _run("bench_mg", port_runs, ref, groups=2)
    assert len(states) == 4
    for i, U in enumerate(states):
        gaps = scaled_gaps(U, r[f"U{i + 1}"])
        assert np.all(gaps <= 1e-12), (i + 1, gaps)
    for g in range(2):
        assert bool((sim.U[sim.layout.rad_index(g, 0)] > 0).all())


# ------------------------------------------- the full-length anchors (slow)
PULSE_CFG = """
geometry.prob_lo = -512.0 0.0 0.0
geometry.prob_hi = 512.0 1.0 1.0
amr.n_cell = 64 1 1
cfl = 0.8
radiation.cfl = 0.8
radiation.opacity_model = {model}
stop_time = {stop}
max_timesteps = 100000
verbose = 0
"""
PULSE_T_END = 6.0e-6


def _pulse(problem, model, v0=0.0, stop=PULSE_T_END):
    """(sim, Trad from the groups' summed E, Tgas) of a 1D pulse run to
    `stop` through the port (tests/test_radhydro_pulse.py's `_run`)."""
    import quokka_tpu_torch
    from quokka_tpu_torch.problems.radhydro_pulse import A_RAD

    problem.v0 = v0
    sim = quokka_tpu_torch.Simulation(problem, quokka_tpu_torch.ParmParse.from_string(
        PULSE_CFG.format(model=model, stop=stop)), device="cpu")
    sim.set_initial_conditions()
    sim.evolve()
    U = sim.U
    layout = sim.layout
    E = sum(U[layout.rad_index(g, 0)][:, 0, 0] for g in range(layout.n_groups))
    Trad = ((E / A_RAD) ** 0.25).numpy()
    Tgas = sim.eos.tgas_from_eint(U[0][:, 0, 0], U[5][:, 0, 0]).numpy()
    return sim, Trad, Tgas


def _shift_back(sim, v0, f):
    """f advected at v0, shifted back by v0 t (periodic, linear)."""
    x = sim.grid.cell_centers(0, device="cpu").numpy()
    n = len(x)
    idx = (np.arange(n) + v0 * sim.t / (x[1] - x[0])) % n
    lo = np.floor(idx).astype(int) % n
    w = idx - np.floor(idx)
    return (1 - w) * f[lo] + w * f[(lo + 1) % n]


@pytest.mark.slow
def test_pulse_mg_const_matches_grey():
    """4 groups with one constant opacity reproduce the grey pulse
    (tests/test_radhydro_pulse.py::test_pulse_mg_const_matches_grey, the
    reference's RadhydroPulseMGconst): rel L1 < 0.008."""
    from quokka_tpu_torch.problems import RadhydroPulseMGconstProblem, RadhydroPulseProblem

    _g, Trad_g, _ = _pulse(RadhydroPulseProblem(), "piecewise_constant")
    _m, Trad_mg, _ = _pulse(RadhydroPulseMGconstProblem(), "piecewise_constant")
    rel = np.abs(Trad_mg - Trad_g).sum() / np.abs(Trad_g).sum()
    print(f"MGconst vs grey: rel L1 {rel:.6e} (limit 0.008)")
    assert rel < 0.008, rel


@pytest.mark.slow
def test_pulse_mg_int_frame_invariance():
    """nu- and T-dependent opacity, PPL fixed slope (tests/
    test_radhydro_pulse.py::test_pulse_mg_int_frame_invariance, the
    reference's RadhydroPulseMGint): the advected pulse shifted back matches
    the comoving one, rel L1 < 0.02."""
    from quokka_tpu_torch.problems import RadhydroPulseMGintProblem
    from quokka_tpu_torch.problems.radhydro_pulse import V0_ADV

    _s, _Trad_s, Tgas_s = _pulse(RadhydroPulseMGintProblem(), "ppl_fixed_slope")
    sim_a, Trad_a, Tgas_a = _pulse(RadhydroPulseMGintProblem(), "ppl_fixed_slope", V0_ADV)
    rel = np.abs(_shift_back(sim_a, V0_ADV, Tgas_a) - Tgas_s).sum() / np.abs(Tgas_s).sum()
    print(f"MGint frame invariance: rel L1 {rel:.6e} (limit 0.02)")
    assert rel < 0.02, rel
    assert np.all(np.isfinite(Trad_a)) and np.all(Trad_a > 0)


@pytest.mark.slow
def test_bb_thermalization():
    """tests/test_radhydro_bb.py::test_bb_thermalization (the reference's
    RadhydroBB): the gas thermalizes to T_eq (rtol 0.02), the group spectrum
    is Planck's at T_eq (rel L1 < 0.1), the gas keeps its velocity."""
    import quokka_tpu_torch
    from quokka_tpu_torch.indices import EGAS, MX1, RHO
    from quokka_tpu_torch.problems import RadhydroBBProblem
    from quokka_tpu_torch.problems.radhydro_bb import (A_RAD, C_CODE, GROUP_EDGES, N_GROUPS,
                                                       T_EQUILIBRIUM, V0)
    from quokka_tpu_torch.radiation.planck import planck_energy_fractions

    cfg = f"""
geometry.prob_lo = 0.0 0.0 0.0
geometry.prob_hi = 64.0 1.0 1.0
amr.n_cell = 32 1 1
cfl = 0.8
radiation.cfl = 8.0
radiation.opacity_model = piecewise_constant
radiation.reconstruction_order = 3
max_dt = 1.0
stop_time = {10.0 / (1e-2 * C_CODE)}
max_timesteps = 100000
verbose = 0
"""
    sim = quokka_tpu_torch.Simulation(RadhydroBBProblem(),
                                      quokka_tpu_torch.ParmParse.from_string(cfg),
                                      device="cpu")
    sim.set_initial_conditions()
    sim.evolve()
    U = sim.U.numpy()
    assert np.all(np.isfinite(U))
    ke = 0.5 * U[MX1] ** 2 / U[RHO]
    Tgas = sim.eos.tgas_from_eint(torch.tensor(U[RHO]), torch.tensor(U[EGAS] - ke)).numpy()
    print(f"RadhydroBB: max |Tgas / T_eq - 1| {np.max(np.abs(Tgas / T_EQUILIBRIUM - 1)):.6e} "
          f"(limit 0.02) after {sim.istep} steps")
    np.testing.assert_allclose(Tgas, T_EQUILIBRIUM, rtol=0.02)
    Eg = np.asarray([U[sim.layout.rad_index(g, 0)].mean() for g in range(N_GROUPS)])
    fr = planck_energy_fractions(GROUP_EDGES, torch.tensor(T_EQUILIBRIUM,
                                                           dtype=torch.float64)).numpy()
    Eg_exact = fr * A_RAD * T_EQUILIBRIUM**4
    rel_l1 = np.abs(Eg - Eg_exact).sum() / Eg_exact.sum()
    print(f"RadhydroBB: spectrum rel L1 {rel_l1:.6e} (limit 0.1)")
    assert rel_l1 < 0.1
    np.testing.assert_allclose(U[MX1] / U[RHO], V0, rtol=0.05)
