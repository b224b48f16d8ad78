"""The port's multigroup building blocks against quokka_tpu, on the CPU.

- `radiation.planck`: the table is the JAX package's, bit for bit; the
  integral y(x) over x in [0, 120] within 1e-15 in float64 and 2 ulps in
  float32 (the same interpolation, associated as `jnp.interp` associates
  it); the group fractions likewise, at the pulse problems' edges.
- `radiation.opacity`: every function against its JAX counterpart, within
  1e-12 of each output's largest magnitude in float64 and, in float32,
  within 4 ulps of it (the transcendental functions, `expm1`, `log` and
  `pow`, are within an ulp or two of XLA's, and the outputs take a few
  more operations).
- `multigroup.add_source_terms_multi_group` for the three opacity models on
  `tests/test_radiation_ppl.py`'s `_coupling_setup` state (4^3, 4 groups),
  in equilibrium and knocked out of it (gas 30% hotter, moving gas and
  radiation flux), with the work term on and off: within 1e-12 of each
  component's max in float64; in float32 within 2e-5 of it, the bar of
  the single-group coupling (K5): a Newton iteration count that differs by
  one at roundoff moves a cell by its last correction, up to the
  convergence tolerance 50 float32 eps of the total energy. Testing
  convergence every k iterations equals testing it every iteration, bit
  for bit.
- K6's plain version over 4 groups against the JAX package's
  `compute_rad_div_pallas` at G = 4 interpreted, per axis and accumulated
  as `rad_transport_div` launches it: rtol 1e-5 + 64 ulps of each
  component's max.
- The dispatch: K6 only for float32 with three active axes, K4 only for one
  group on three axes; K4, K5 and K7 refuse G > 1 naming it; radiation
  walls, dust and `mixed_precision_coupling` raise NotImplementedError; an
  unknown opacity model raises ValueError; the 4-group PPL options carry
  across; K6's cost at G groups; the new modules import no jax.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quokka_tpu.radiation import opacity as jop
from quokka_tpu.radiation import planck as jpl
from quokka_tpu.radiation.system import RadOptions as JRadOptions

import quokka_tpu_torch
from quokka_tpu_torch import kernel_check
from quokka_tpu_torch.eos import IdealGasEOS
from quokka_tpu_torch.interop import rad_options_from_fields
from quokka_tpu_torch.problems.rad_multigroup import GROUP_EDGES
from quokka_tpu_torch.problems.radhydro_pulse import H_PLANCK, K_B, PULSE_MG_EDGES
from quokka_tpu_torch.radiation import multigroup, opacity, planck, source, substep
from quokka_tpu_torch.radiation import sweep as rsweep
from quokka_tpu_torch.radiation import system
from quokka_tpu_torch.radiation.system import RadOptions
from quokka_tpu_torch.registry import BC_REFLECT, BCSpec, PhysicsTraits, Problem, RadTraits

from jax_multigroup import COUPLING_DT
from jax_ref import SharedJaxRun, run_root
from torch_port_common import port_sim_like, scaled_gaps, step_like, ulp_close

MODELS = ("piecewise_constant", "ppl_fixed_slope", "ppl_full_spectrum")
G = 4
# the JAX references, each a process of its own (tests/port/jax_multigroup.py)
REFS = tuple(f"coupling_{m}" for m in MODELS) + ("pulse_mgint", "pulse_mgconst", "bb",
                                                 "pulse_grey")


@pytest.fixture(scope="module", autouse=True)
def jax_refs(tmp_path_factory):
    """{case: SharedJaxRun}, started at once when the module's first test
    runs (the longest first)."""
    root = run_root(tmp_path_factory)
    return {case: SharedJaxRun(root, f"jax_multigroup_{case}", "jax_multigroup.py", [case])
            for case in REFS}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side takes one thread: beside the JAX processes and the
    other test workers a thread per core oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(jax_refs):
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = jax_refs[case].result()
        return cache[case]

    return get


def _close(got, ref, rel, what=""):
    """|got - ref| <= rel x max |ref|, per leading index (component)."""
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref), err_msg=what)
    got, ref = got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1)
    for c in range(ref.shape[0]):
        scale = np.max(np.abs(ref[c]))
        gap = np.max(np.abs(got[c] - ref[c]))
        assert gap <= rel * scale, f"{what} component {c}: {gap:.3e} > {rel:g} x {scale:.3e}"


def _ulps_of_max(got, ref, n, what=""):
    got = np.asarray(got, np.float32).reshape(-1)
    ref = np.asarray(ref, np.float32).reshape(-1)
    gap = np.max(np.abs(got.astype(np.float64) - ref))
    assert gap <= n * np.spacing(np.max(np.abs(ref))), f"{what}: {gap:.3e}"


# ------------------------------------------------------------------ planck
def test_planck_table_and_integral():
    np.testing.assert_array_equal(planck._X_TAB, jpl._X_TAB)
    np.testing.assert_array_equal(planck._Y_TAB, jpl._Y_TAB)
    x = np.concatenate([np.linspace(0.0, 120.0, 4001), jpl._X_TAB, [1e-4, 99.999, 100.0]])
    ref = np.asarray(jpl.integrate_planck_from_0_to_x(jnp.asarray(x)))
    got = planck.integrate_planck_from_0_to_x(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)
    x32 = x.astype(np.float32)
    ref32 = np.asarray(jpl.integrate_planck_from_0_to_x(jnp.asarray(x32)))
    got32 = planck.integrate_planck_from_0_to_x(torch.tensor(x32)).numpy()
    assert got32.dtype == np.float32 and ref32.dtype == np.float32
    assert np.all(np.abs(got32.astype(np.float64) - ref32) <= 2 * np.spacing(np.abs(ref32)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_planck_energy_fractions(dtype):
    rng = np.random.default_rng(1)
    for edges, T, kB, unit in ((GROUP_EDGES, 0.2 + 3.0 * rng.random((5, 6, 7)), 1.0, 1.0),
                               (PULSE_MG_EDGES, 1e7 * (1.0 + rng.random((64, 1, 1))), K_B,
                                H_PLANCK)):
        T = T.astype(dtype)
        ref = np.asarray(jpl.planck_energy_fractions(edges, jnp.asarray(T), kB, unit))
        got = planck.planck_energy_fractions(edges, torch.tensor(T), kB, unit).numpy()
        assert got.dtype == dtype
        if dtype == np.float64:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)
        else:
            assert np.all(np.abs(got.astype(np.float64) - ref) <= 4 * np.spacing(np.float32(1)))
        np.testing.assert_allclose(got.sum(axis=0), 1.0, rtol=1e-6 if dtype == np.float32
                                   else 1e-14)


# ----------------------------------------------------------------- opacity
def _opacity_pairs(dtype):
    """(name, port result, JAX result) of every function of opacity.py on
    seeded fields of 4 groups."""
    rng = np.random.default_rng(2)
    shape = (G, 5, 4, 3)
    T = (0.3 + 2.0 * rng.random(shape[1:])).astype(dtype)
    quant = (rng.random(shape) * np.array([1.0, 0.5, 2.0, 0.01])[:, None, None, None]
             ).astype(dtype)
    quant[1, 0, 0, 0] = 0.0  # a zero mean: the sign-change slope
    quant[2, 0, 0, 0] = 0.0
    alpha_k = (rng.standard_normal(shape) * 2.0).astype(dtype)
    alpha_k[0, 0, 0, 0] = -1.0 - 1e-9  # part(a) near a -> 0
    k_low = (1.0 + 10.0 * rng.random(shape)).astype(dtype)
    alpha_q = (rng.standard_normal(shape) * 3.0).astype(dtype)
    alpha_q[1, 0, 0, 0] = 150.0  # the saturation guards
    alpha_q[2, 0, 0, 0] = -150.0
    ratios = np.asarray(jop.boundary_ratios(GROUP_EDGES), dtype).reshape(G, 1, 1, 1)
    B = (0.1 + rng.random(shape)).astype(dtype)
    kP, kE = (1.0 + rng.random(shape)).astype(dtype), (1.0 + rng.random(shape)).astype(dtype)
    d_nkB = (0.1 * rng.standard_normal(shape)).astype(dtype)
    d_nB = (0.1 * rng.standard_normal(shape)).astype(dtype)
    t, j = (lambda a: torch.tensor(a)), jnp.asarray
    yield ("planck_function", opacity.planck_function(3.0, t(T), 1.0, 2.0, 1.5),
           jop.planck_function(3.0, j(T), 1.0, 2.0, 1.5))
    yield ("planck_function small x", opacity.planck_function(1e-12, t(T), 1.0, 1.0),
           jop.planck_function(1e-12, j(T), 1.0, 1.0))
    yield ("minmod", opacity._minmod(t(alpha_k), t(alpha_q)),
           jop._minmod(j(alpha_k), j(alpha_q)))
    for special in (False, True):
        yield (f"rad_quantity_exponents special {special}",
               opacity.rad_quantity_exponents(t(quant), GROUP_EDGES, special),
               jop.rad_quantity_exponents(j(quant), GROUP_EDGES, special))
    yield ("group_mean_opacity", opacity.group_mean_opacity(t(alpha_k), t(k_low), t(ratios),
                                                            t(alpha_q)),
           jop.group_mean_opacity(j(alpha_k), j(k_low), j(ratios), j(alpha_q)))
    yield ("diffusion_flux_mean_opacity",
           opacity.diffusion_flux_mean_opacity(t(kP), t(kE), t(B), t(d_nkB), t(d_nB),
                                               t(alpha_k)),
           jop.diffusion_flux_mean_opacity(j(kP), j(kE), j(B), j(d_nkB), j(d_nB), j(alpha_k)))
    for edges in (GROUP_EDGES, GROUP_EDGES[:-1] + (float("inf"),)):
        got = opacity.edge_delta_terms(edges, t(T), t(alpha_k), t(k_low), 1.0, 2.0)
        ref = jop.edge_delta_terms(edges, j(T), j(alpha_k), j(k_low), 1.0, 2.0)
        yield (f"edge_delta_terms {edges[-1]}", torch.stack(got), jnp.stack(ref))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_opacity_functions(dtype):
    for name, got, ref in _opacity_pairs(dtype):
        ref = np.asarray(ref)
        assert got.dtype == torch.float64 if dtype == np.float64 else torch.float32, name
        if dtype == np.float64:
            _close(got, ref, 1e-12, name)
        else:
            np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(ref),
                                          err_msg=name)
            fin = np.isfinite(ref)
            _ulps_of_max(got.numpy()[fin], ref[fin], 4, name)
    assert opacity.boundary_ratios(GROUP_EDGES) == jop.boundary_ratios(GROUP_EDGES)
    inf_edges = (1.0, 2.0, float("inf"))
    assert opacity.boundary_ratios(inf_edges) == jop.boundary_ratios(inf_edges)


# ---------------------------------------------------------------- coupling
class _PortNu1Problem(Problem):
    """The port's twin of `_coupling_setup`'s problem with the nu^-1 opacity
    spectrum of tests/port/jax_multigroup.py's `couplings` (kappa = 20 at
    each group's lower edge) for the PPL models, and kappa = 10 in every
    group for piecewise_constant."""

    physics = PhysicsTraits(hydro_enabled=True, radiation_enabled=True, n_groups=G)
    rad = RadTraits(c_light=1e3, c_hat=1e2, radiation_constant=1.0, Erad_floor=1e-14,
                    beta_order=1, group_edges=(0.1, 1.0, 3.0, 10.0, 100.0))

    def compute_group_opacities(self, boundaries, rho, T):
        return 10.0 * torch.ones((G, *rho.shape), dtype=rho.dtype)

    def define_opacity_exponents_and_lower_values(self, boundaries, rho, T):
        k = 20.0 * torch.ones((G, *rho.shape), dtype=rho.dtype)
        return torch.full_like(k, -1.0), k


def _port_eos():
    return IdealGasEOS(gamma=5.0 / 3.0, mean_molecular_weight=1.0, boltzmann_constant=1.0)


def _port_opts(model, work=True):
    """`_coupling_setup`'s options (`tests/test_radiation_ppl.py:97-98`)."""
    return RadOptions(c=1e3, chat=1e2, arad=1.0, erad_floor=1e-14, beta_order=1, n_groups=G,
                      opacity_model=model, include_work_term=work)


def _port_coupling(U, model, work, stage, dtype):
    U = torch.tensor(U, dtype=dtype)
    dt = COUPLING_DT if dtype == torch.float64 else float(np.float32(COUPLING_DT))
    out, stats = multigroup.add_source_terms_multi_group(
        U, None, dt, stage, _port_opts(model, work), _port_eos(), _PortNu1Problem(), 7,
        GROUP_EDGES, 1.0)
    assert stats == {"newton_iters_max": 0}
    return out


@pytest.mark.parametrize("work", [1, 0], ids=["work", "no_work"])
@pytest.mark.parametrize("model", MODELS)
def test_coupling_f64_vs_jax(model, work, ref):
    """Equilibrium (x < 4) and knocked out of it (x >= 4) in one state,
    stage 1."""
    r = ref(f"coupling_{model}")
    U = r["U_both"]
    got = _port_coupling(U, model, bool(work), 1, torch.float64)
    _close(got, r[f"f64_work{work}"], 1e-12, f"{model} work={work}")
    # the equilibrium half stays put (tests/test_radiation_ppl.py)
    _close(got[:, :4], U[:, :4], 1e-6, "equilibrium")
    assert not np.allclose(got[:, 4:].numpy(), U[:, 4:], rtol=1e-3)


@pytest.mark.parametrize("model", MODELS)
def test_coupling_f32_vs_jax(model, ref):
    """The knocked state in float32, stage 2, with the work term."""
    r = ref(f"coupling_{model}")
    got = _port_coupling(r["U_knocked"].astype(np.float32), model, True, 2, torch.float32)
    assert got.dtype == torch.float32
    _close(got, r["f32"], 2e-5, f"{model} f32")


@pytest.mark.parametrize("model", MODELS)
def test_newton_check_interval_is_bitwise(model, ref, monkeypatch):
    """Testing `done.all()` every k Newton iterations gives the bits of
    testing it every iteration."""
    U = ref(f"coupling_{model}")["U_knocked"]
    outs = {}
    for k in (1, 2, multigroup.DONE_CHECK_EVERY, 7):
        monkeypatch.setattr(multigroup, "DONE_CHECK_EVERY", k)
        multigroup.reset_sync_counts()
        outs[k] = _port_coupling(U, model, True, 1, torch.float64)
        outs[k, "syncs"] = multigroup.sync_counts["newton"]
    for k in (2, multigroup.DONE_CHECK_EVERY, 7):
        assert torch.equal(outs[k], outs[1]), k
    assert outs[7, "syncs"] < outs[1, "syncs"]


# ------------------------------------------------- 1D periodic problems
@pytest.mark.parametrize("case", ["pulse_grey", "pulse_mgconst", "pulse_mgint", "bb"])
def test_1d_problems_vs_jax(case, ref):
    """RadhydroPulse (grey), RadhydroPulseMGconst, RadhydroPulseMGint
    (advected at v0 = 1e6) on 64 x 1 x 1 and RadhydroBB on 32 x 1 x 1, the
    JAX tests' decks, float64, 3 steps at the JAX run's dts: radiation on
    one periodic axis (plain transport, no K6), within 1e-12 of each
    component's max after every step; the initial states equal JAX's."""
    r = ref(case)
    sim = port_sim_like(case, r["U0"])
    fresh = port_sim_like(case, r["U0"])
    fresh.set_initial_conditions()
    np.testing.assert_allclose(fresh.U.numpy(), r["U0"], rtol=1e-14, atol=0)
    assert sim.grid.active_axes == (0,) and not sim._radiation.fused
    for i, dt in enumerate(r["dts"]):
        assert sim.compute_timestep() == pytest.approx(dt, rel=1e-12)
        step_like(sim, float(dt))
        gaps = scaled_gaps(sim.U.numpy(), r[f"U{i + 1}"])
        assert np.all(gaps <= 1e-12), (case, i + 1, gaps)


# --------------------------------------------------------------------- K6
def test_k6_groups_vs_jax_interpreted():
    """K6's plain version over 4 groups against `compute_rad_div_pallas` at
    G = 4 (interpret mode), per axis and as rad_transport_div sums them."""
    from quokka_tpu.radiation import pallas_sweep as jpsw

    shape = (8, 6, 5)
    R = kernel_check.rough_rad_groups(shape, G, 7, "cpu")
    jo = JRadOptions(c=1.0e3, chat=1.0e2, arad=1.0, erad_floor=1e-10, n_groups=G,
                     use_pallas=True)
    po = rad_options_from_fields(dataclasses.asdict(jo))
    dx = (1.0 / 8, 0.5 / 6, 2.0 / 5)
    cons = jnp.asarray(R.numpy())
    parts = [np.asarray(jpsw.compute_rad_div_pallas(cons, d, jo, G, dx[d])) for d in range(3)]
    for d in range(3):
        got = rsweep.rad_div_plain(R, d, po, dx[d])
        assert got.shape == (G, 4) + shape
        ulp_close(parts[d].reshape(4 * G, *shape), got.reshape(4 * G, *shape),
                  what=f"K6 G=4 axis {d}")
    got = system.rad_transport_div(R, 0, po, (0, 1, 2), dx)
    ref = (parts[0] + parts[1]) + parts[2]
    ulp_close(ref.reshape(4 * G, *shape), got.reshape(4 * G, *shape), what="K6 G=4 3 axes")


def test_k6_cost_at_groups():
    R = kernel_check.rough_rad_groups((4, 5, 6), G, 1, "cpu")
    o = RadOptions(c=1e3, chat=1e2, arad=1.0, n_groups=G)
    nbytes, ops = kernel_check.k6_cost(R, o)
    assert nbytes == 2 * 16 * G * 120
    assert ops == kernel_check.OPS_K6_AXIS * G * 120
    assert kernel_check.k6_cost(R, o, axes=3)[1] == 3 * ops
    labels = [c.label for c in kernel_check.k6_group_edge_cases(
        RadOptions(c=1e3, chat=1e2, arad=1.0), "cpu", groups=(2,))]
    assert any("order 1" in lb for lb in labels) and any("(4, 4, 4)" in lb for lb in labels)


# ---------------------------------------------------------------- dispatch
def test_k6_only_on_three_axes_f32(monkeypatch):
    """rad_transport_div hands a float32 state with three active axes to
    the K6 wrapper (which launches K6 or raises on the card), and any other
    state to K6's plain version."""
    calls = []

    def spy(*args, **kwargs):
        calls.append("kernel")
        return rsweep.rad_div_plain(*args, **kwargs)

    monkeypatch.setattr(rsweep, "compute_rad_div", spy)
    o = RadOptions(c=1e3, chat=1e2, arad=1.0, n_groups=G)
    R = kernel_check.rough_rad_groups((4, 4, 4), G, 2, "cpu")
    dx = (0.25,) * 3
    system.rad_transport_div(R, 0, o, (0, 1, 2), dx)
    assert calls == ["kernel"] * 3
    calls.clear()
    system.rad_transport_div(R.double(), 0, o, (0, 1, 2), dx)
    system.rad_transport_div(R[:, :, :1, :1].contiguous(), 0, o, (0,), dx)
    system.rad_transport_div(R[:, :, :, :1].contiguous(), 0, o, (0, 1), dx)
    assert calls == []


def test_kernels_refuse_groups_naming_them():
    o = RadOptions(c=1e3, chat=1e2, arad=1.0, n_groups=G)
    U = torch.zeros(6 + 4 * G, 4, 4, 4)
    for kernel in ("K4", "K5", "K7"):
        with pytest.raises(NotImplementedError, match=f"{kernel} takes one photon group"):
            rsweep.check_kernel_inputs(o, 10, U, kernel=kernel)
    rsweep.check_kernel_inputs(o, 4 * G, U[6:].contiguous(), kernel="K6", groups=True)
    # K5 is pointwise: a 1D state passes its check; K6 needs extents of 4
    o1 = RadOptions(c=1e3, chat=1e2, arad=1.0)
    rsweep.check_kernel_inputs(o1, 10, torch.zeros(10, 64, 1, 1), kernel="K5", min_extent=1)
    with pytest.raises(ValueError, match=">= 4"):
        rsweep.check_kernel_inputs(o1, 4, torch.zeros(4, 64, 1, 1), kernel="K6")
    with pytest.raises(ValueError, match="one photon group"):
        from quokka_tpu_torch.radiation.source_terms import add_source_terms_single_group

        add_source_terms_single_group(U, None, 1e-3, 1, o, _port_eos(), None, None, None, 6)


def _mg_deck(extra=()):
    from quokka_tpu_torch.problems.rad_multigroup import DECK_FILE

    return quokka_tpu_torch.ParmParse.from_string(DECK_FILE.read_text(),
                                                  ["amr.n_cell = 8 8 8", *extra])


def test_multigroup_simulation_dispatch():
    """G > 1 steps stage by stage (no K4) with the multigroup coupling, the
    per-group floor Erad_floor / G, and the JAX package's opacity-model
    check."""
    from quokka_tpu_torch.problems import RadMultigroupPulseProblem, RadhydroBenchProblem

    sim = quokka_tpu_torch.Simulation(RadMultigroupPulseProblem(), _mg_deck(), device="cpu",
                                      precision="single")
    sim.set_initial_conditions()
    rad = sim._radiation
    assert rad.opts.n_groups == G and rad.opts.opacity_model == "ppl_full_spectrum"
    assert not rad.fused and rad.boundaries == GROUP_EDGES
    R = torch.zeros(G, 4, 2, 2, 2)
    R[:, 1] = 5.0
    amended = system.amend_rad_state(R, rad.opts)
    assert torch.all(amended[:, 0] == np.float32(rad.opts.erad_floor / G))
    assert rsweep.rad_params(rad.opts, (1, 1, 1)).erad_floor == np.float32(
        rad.opts.erad_floor / G)
    one = quokka_tpu_torch.Simulation(RadhydroBenchProblem(), quokka_tpu_torch.ParmParse.
                                      from_string("amr.n_cell = 8 8 8"), device="cpu",
                                      precision="single")
    one.set_initial_conditions()
    assert one._radiation.fused
    for model in MODELS + ("grey_body",):
        other = quokka_tpu_torch.Simulation(RadMultigroupPulseProblem(),
                                            _mg_deck([f"radiation.opacity_model = {model}"]),
                                            device="cpu")
        if model in MODELS:
            other.set_initial_conditions()
            assert other._radiation.opts.opacity_model == model
            continue
        with pytest.raises(ValueError, match="opacity_model"):
            other.set_initial_conditions()


def test_radiation_refusals():
    from quokka_tpu_torch.problems import RadMultigroupPulseProblem

    class Walled(RadMultigroupPulseProblem):
        bcs = BCSpec(x=(BC_REFLECT, BC_REFLECT))

    class Dusty(RadMultigroupPulseProblem):
        @dataclasses.dataclass(frozen=True)
        class _ISM:
            enable_dust_gas_thermal_coupling_model: bool = True

        ism = _ISM()

    for prob, what in ((Walled(), "boundaries other than periodic"),
                       (Dusty(), "dust")):
        sim = quokka_tpu_torch.Simulation(prob, _mg_deck(), device="cpu")
        with pytest.raises(NotImplementedError, match=what):
            sim.set_initial_conditions()
    with pytest.raises(NotImplementedError, match="mixed_precision_coupling"):
        quokka_tpu_torch.Simulation(RadMultigroupPulseProblem(),
                                    _mg_deck(["radiation.mixed_precision_coupling = 1"]),
                                    device="cpu")
    o = RadOptions(c=1e3, chat=1e2, arad=1.0, n_groups=G, mixed_precision_coupling=True)
    with pytest.raises(NotImplementedError, match="mixed_precision_coupling"):
        multigroup.add_source_terms_multi_group(torch.zeros(6 + 4 * G, 2, 2, 2), None, 1e-3,
                                                1, o, _port_eos(), None, 6, GROUP_EDGES, 1.0)


def test_rad_options_round_trip_multigroup_ppl():
    jo = JRadOptions(c=1.0e3, chat=1.0e2, arad=1.0, erad_floor=1e-12, n_groups=G,
                     opacity_model="ppl_full_spectrum", use_pallas=True)
    d = dataclasses.asdict(jo)
    po = rad_options_from_fields(d)
    d.pop("use_pallas")
    assert dataclasses.asdict(po) == d
    assert po.n_groups == G and po.opacity_model == "ppl_full_spectrum"


def test_new_modules_import_no_jax():
    code = ("import sys, quokka_tpu_torch.radiation.multigroup, "
            "quokka_tpu_torch.radiation.opacity, quokka_tpu_torch.radiation.planck, "
            "quokka_tpu_torch.problems.rad_multigroup, quokka_tpu_torch.problems.radhydro_pulse, "
            "quokka_tpu_torch.problems.radhydro_bb; "
            "bad = [m for m in sys.modules if m in ('jax', 'quokka_tpu') or "
            "m.startswith(('jax.', 'quokka_tpu.'))]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr


# -------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k6_groups_on_card(cuda_device):
    """K6 over 2 and 4 groups within rtol 1e-5 + 64 ulps of each component's
    max of its plain version at K4's edge shapes, per axis and accumulated;
    K4, K5 and K7 refuse a 4-group state."""
    for case in kernel_check.k6_group_edge_cases(RadOptions(c=1e3, chat=1e2, arad=1.0),
                                                 cuda_device):
        ok, max_abs, _, _, _ = case.check()
        assert ok, (case.label, max_abs)
    o = RadOptions(c=1e3, chat=1e2, arad=1.0, n_groups=G)
    U = torch.zeros(6 + 4 * G, 8, 8, 8, device=cuda_device)
    with pytest.raises(NotImplementedError, match="K5"):
        source.source_update(U, None, 1e-3, 1, o, _port_eos(), None, 6)
    with pytest.raises(NotImplementedError, match="K4"):
        substep.fused_stage1(U, None, 1e-3, o, _port_eos(), None, (1, 1, 1))
    with pytest.raises(NotImplementedError, match="K7"):
        rsweep.compute_rad_axis_flux(U[6:].contiguous(), 0, o)
