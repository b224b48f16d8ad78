"""The port's lean hydro step (`_advance_hydro_rk2_lean`, kernel K2c) against
the JAX package's, on the CPU.

The JAX references (interpreted Pallas with ``QUOKKA_PALLAS_LEAN``, as
tests/test_lean_update.py runs them) run in processes of their own
(tests/port/jax_lean.py) with ``XLA_FLAGS=--xla_cpu_max_isa=AVX``, so that
XLA:CPU contracts no a*b + c into a fused multiply-add and each operation
rounds on its own, as each PyTorch operation of the port does. All four
start when the first test of this module runs and work beside the port's
side; under pytest-xdist the workers share one set (a file lock).

Tolerances (per component, against the JAX result): rtol 1e-5 plus 64 ulps
of the component's largest magnitude (`torch_port_common.ulp_close`, the
bound of tests/test_fused_update.py), non-finite patterns equal. The port's
lean step against its own fused step differs by the divergence/average
association and is held to the flip-bounded agreement of
tests/test_lean_update.py::_close_outliers (rtol 3e-5 + 256 ulps, a
bounded set of threshold flips).

- (a) K2c's plain version against `compute_axis_flux_pallas` for each lean
  variant (div_only; + acc; fo_mask; fo_mask + acc + fo_from) on every
  axis of a box periodic along x and walled along y and z;
- (b) one lean step against JAX's: Sedov 16^3 through `Simulation`, and a
  rough 16^3 state whose two RK stages both fall back;
- (c) the > 272 rule on a rough 280 x 8 x 8 box: stage 2's first-order
  fluxes come from U1 (with them from U0 instead the result moves by O(1));
- (d) the port's lean step against its fused step;
- (e) the dispatch: which branch runs where, and the NotImplementedError
  where the JAX package would run its classic path;
- (f) the state, the function's only input, carried across from numpy.
"""

import numpy as np
import pytest
import torch

from quokka_tpu_torch import ParmParse, Simulation, kernel_check
from quokka_tpu_torch.eos import IdealGasEOS
from quokka_tpu_torch.hydro import advance, sweep
from quokka_tpu_torch.indices import EINT
from quokka_tpu_torch.interop import state_from_numpy
from quokka_tpu_torch.problems.sedov import DECK_512, SedovProblem

from jax_ref import SharedJaxRun, run_root
from jax_lean import (BOX_BC, BOX_SHAPE, KERNEL_BC, N, SEDOV_DECK, VARIANTS, kernel_inputs,
                      rough_state, smooth_state)
from torch_port_common import BC_KINDS, ulp_close

CASES = ("box", "rough", "kernels", "sedov")  # the longest first


@pytest.fixture(scope="module", autouse=True)
def jax_refs(tmp_path_factory):
    """{case: SharedJaxRun}, started at once when the module's first test
    runs."""
    root = run_root(tmp_path_factory)
    return {case: SharedJaxRun(root, f"jax_lean_{case}", "jax_lean.py", [case])
            for case in CASES}


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


def opts(shape):
    return advance.HydroOptions(eos=IdealGasEOS(gamma=1.4), active_axes=(0, 1, 2),
                                dx=tuple(1.0 / n for n in shape), reconstruction_order=3,
                                reconstruct_eint=False)


def periodic(bc):
    return tuple(bc[d] is None for d in range(3))


def step(U, dt, shape, bc):
    return advance.advance_hydro_rk2(torch.tensor(U), dt, opts(shape), None, (0, 0, 0),
                                     periodic(bc), bc_kinds=bc)


def close_outliers(b, a, rtol=3e-5, ulp_of_max=256, frac=0.005, big_frac=0.02):
    """tests/test_lean_update.py::_close_outliers: `ulp_close` allowing a
    rare, bounded set of discrete-branch flips (dual-energy sync, floors,
    FOFC validity are step functions of states that the two formulations
    round differently): at most `frac` of the cells a component (10x for
    the auxiliary internal energy), each within `big_frac` (3x) of the
    component's magnitude."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin)
    np.testing.assert_array_equal(a[~fin], b[~fin])
    for c in range(a.shape[0]):
        m = fin[c]
        scale = np.max(np.abs(b[c][m]), initial=0.0)
        bad = ~np.isclose(a[c][m], b[c][m], rtol=rtol, atol=ulp_of_max * np.spacing(scale))
        f = frac * (10 if c == EINT else 1)
        assert bad.sum() <= max(1, int(f * m.sum())), f"component {c}: {bad.sum()} outliers"
        diff = np.abs(a[c][m] - b[c][m])[bad]
        assert np.all(diff <= big_frac * (3 if c == EINT else 1) * max(scale, 1.0)), c


# ------------------------------------------------------------- (e) dispatch
@pytest.mark.parametrize("pref,n,want", [
    ("auto", 256, "fused"), ("auto", 273, "lean"), ("auto", 512, "lean"),
    ("auto", 1088, "lean"), ("auto", 1089, "classic"), ("1", 16, "lean"),
    ("1", 256, "lean"), ("0", 256, "fused"), ("0", 512, "classic")])
def test_dispatch_branch(pref, n, want, monkeypatch):
    """The JAX package's rule (`quokka_tpu/hydro/advance.py:1139-1181`) on
    a ghost-free f32 state of extent n; "classic" is its unfused flux
    formulation (`_advance_hydro_rk2_classic`)."""
    monkeypatch.setenv("QUOKKA_PALLAS_LEAN", pref)
    U = torch.empty((6, n, 8, 8), device="meta")
    assert advance._branch(U, opts((n, 8, 8)), False, False, (0, 0, 0)) == want


def test_dispatch_other_forms(monkeypatch):
    """float64 and rk_order 1 above 272 take the classic form; the padded
    AMR level with flux outputs keeps the fused kernels at 520; the padded
    lean form raises; the register seed forces lean at any extent."""
    monkeypatch.setenv("QUOKKA_PALLAS_LEAN", "auto")
    o = opts((512, 8, 8))
    big = torch.empty((6, 512, 8, 8), device="meta")
    assert advance._branch(big.double(), o, False, False, (0, 0, 0)) == "classic"
    assert advance._branch(big, o, True, True, (4, 4, 4)) == "fused"
    with pytest.raises(NotImplementedError, match="padded"):
        advance._branch(big, o, True, False, (4, 4, 4))
    import dataclasses

    assert advance._branch(big, dataclasses.replace(o, rk_order=1), False, False,
                           (0, 0, 0)) == "classic"
    small = torch.empty((6, 16, 8, 8), device="meta")
    assert advance._branch(small, opts((16, 8, 8)), False, False, (0, 0, 0),
                           corr=True) == "lean"
    with pytest.raises(NotImplementedError, match="reflux_corr_masks"):
        advance._branch(small.double(), opts((16, 8, 8)), False, False, (0, 0, 0),
                        corr=True)
    monkeypatch.setenv("QUOKKA_PALLAS_LEAN", "1")
    with pytest.raises(NotImplementedError, match="padded"):
        advance.advance_hydro_rk2(torch.zeros((6, 8, 8, 8)), 0.1, opts((8, 8, 8)),
                                  fill_fn=lambda U: U, ng=(4, 4, 4))


def test_sedov_512_goes_lean_256_stays_fused(monkeypatch):
    """Through `Simulation`'s own stepping configuration: the 512^3 deck
    (bench.py:76-84) takes the lean branch, the 256^3 one the fused."""
    monkeypatch.delenv("QUOKKA_PALLAS_LEAN", raising=False)
    for deck, want in ((DECK_512, "lean"),
                       (DECK_512.replace("512 512 512", "256 256 256"), "fused")):
        sim = Simulation(SedovProblem(), ParmParse.from_string(deck), device="cpu")
        assert sim.dtype == torch.float32
        U = torch.empty((6,) + sim.grid.n_cell, device="meta")
        gf = sim._ghost_free_config()
        assert advance._branch(U, sim.hydro_opts, False, False, gf["ng"]) == want


def test_advance_runs_the_branch(monkeypatch):
    """`advance_hydro_rk2` calls the branch `_branch` names, the classic
    form where JAX runs its XLA path."""
    calls = []
    for name, tag in (("_advance_hydro_rk2_lean", "lean"), ("_advance_hydro_rk2_fused", "fused"),
                      ("_advance_hydro_rk2_classic", "classic")):
        monkeypatch.setattr(advance, name,
                            lambda *a, tag=tag, **k: calls.append(tag) or (a[0], {}))
    bc = BC_KINDS["reflect_all"]
    for pref, n, want in (("auto", 280, "lean"), ("auto", 16, "fused"), ("1", 16, "lean"),
                          ("0", 16, "fused"), ("0", 280, "classic")):
        monkeypatch.setenv("QUOKKA_PALLAS_LEAN", pref)
        advance.advance_hydro_rk2(torch.zeros((6, n, 4, 4)), 0.1, opts((n, 4, 4)), None,
                                  (0, 0, 0), periodic(bc), bc_kinds=bc)
        assert calls.pop() == want, (pref, n)
    assert not calls


def test_lean_options_contract():
    """K2c's argument rules: the accumulators and the blend belong to the
    div-only sweep, fo_from needs fo_mask, the register seed (`corr_*`,
    K2e) needs the accumulated div-only sweep and its mask."""
    U = torch.tensor(smooth_state((8, 8, 8), 1))
    o = opts((8, 8, 8))
    m = torch.zeros((8, 8, 8))
    with pytest.raises(NotImplementedError):
        sweep.compute_axis_flux(U, 0, o, None, {}, dx_axis=0.1, fo_mask=m)
    with pytest.raises(NotImplementedError):
        sweep.compute_fluxes_pallas_div(U, o, None, accumulate=True)
    with pytest.raises(ValueError):
        sweep.compute_axis_flux(U, 0, o, None, {}, dx_axis=0.1, div_only=True, fo_from=U)
    with pytest.raises(ValueError):
        sweep.compute_fluxes_pallas_div(U, o, None, avg_with={}, div_only=True)
    with pytest.raises(ValueError, match="corr_masks"):
        sweep.compute_fluxes_pallas_div(U, o, None, div_only=True,
                                        corr_masks={0: m, 1: m, 2: m})
    with pytest.raises(ValueError, match="corr_init"):
        sweep.compute_fluxes_pallas_div(U, o, None, div_only=True, accumulate=True,
                                        corr_init=U.clone())


# ------------------------------------------------------- (d) lean vs fused
@pytest.mark.parametrize("bc_name,rough,rk", [
    ("reflect_all", False, 2), ("reflect_all", True, 2), ("periodic_x", True, 2),
    ("periodic_x", True, 1)])
def test_lean_matches_fused(bc_name, rough, rk, monkeypatch):
    """The port's lean step against its fused step on the same state, FOFC
    counts equal (tests/test_lean_update.py::test_lean_matches_classic)."""
    import dataclasses

    bc = BC_KINDS[bc_name]
    shape = (N, N, N)
    U = (rough_state if rough else smooth_state)(shape, 3)
    o = dataclasses.replace(opts(shape), rk_order=rk)
    out = {}
    for pref in ("1", "0"):
        monkeypatch.setenv("QUOKKA_PALLAS_LEAN", pref)
        out[pref] = advance.advance_hydro_rk2(torch.tensor(U), 0.2 / N, o, None, (0, 0, 0),
                                              periodic(bc), bc_kinds=bc)
    (U_l, st_l), (U_f, st_f) = out["1"], out["0"]
    assert int(st_l["n_fofc"]) == int(st_f["n_fofc"])
    assert st_l["fofc_fallbacks"] == st_f["fofc_fallbacks"]
    if rough:
        assert int(st_l["n_fofc"]) > 0 and st_l["fofc_fallbacks"] == rk
        close_outliers(U_f.numpy(), U_l.numpy())
    else:
        ulp_close(U_f.numpy(), U_l, rtol=3e-5, ulp_of_max=256, what="lean vs fused")


# ------------------------------------------------------ (f) state across
def test_state_carried_across(ref):
    """A numpy state reaches both packages bitwise: the kernel inputs as the
    JAX side saved them, and Sedov's initial state as JAX built it."""
    k = ref("kernels")
    for key, a in kernel_inputs().items():
        assert torch.equal(state_from_numpy(a, "cpu"), torch.from_numpy(k[key])), key
    s = ref("sedov")
    sim = Simulation(SedovProblem(), ParmParse.from_string(SEDOV_DECK), device="cpu")
    sim.set_initial_conditions()
    assert torch.equal(sim.U, torch.from_numpy(s["sedov_U0"]))


# ------------------------------------------------------------ (a) kernels
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("variant", [v[0] for v in VARIANTS])
def test_k2c_plain_vs_pallas(variant, axis, ref):
    """K2c's plain version against the interpreted Pallas kernel on the same
    inputs (the JAX side's K1 fields): x is periodic, y and z walls."""
    k = ref("kernels")
    _, masked, acc, stage2 = next(v for v in VARIANTS if v[0] == variant)
    t = "1" if stage2 else "0"
    chi = torch.from_numpy(k[f"chi{t}"])
    dmins = {a: torch.from_numpy(k[f"dmin{t}_{a}"]) for a in range(3)}
    o = opts((N, N, N))
    accs = (torch.tensor(k["acc_div"]), torch.tensor(k["acc_dvel"])) if acc else None
    div, dvel = sweep.compute_axis_flux(
        torch.from_numpy(k["U1" if stage2 else "U0"]), axis, o, chi, dmins,
        bc_axis=KERNEL_BC[axis], dx_axis=o.dx[axis], state_is_cons=True, div_only=True,
        acc=accs, fo_mask=torch.from_numpy(k["mask"]) if masked else None,
        fo_from=torch.from_numpy(k["U0"]) if stage2 else None)
    if acc:  # the accumulators are updated in place and returned
        assert div is accs[0] and dvel is accs[1]
    ulp_close(k[f"{variant}/{axis}/div"], div, what=f"{variant} div")
    ulp_close(k[f"{variant}/{axis}/dvel"], dvel, what=f"{variant} dvel")


def test_k2c_blend_takes_effect(ref):
    """The mask moves the divergences (the blend is not a no-op here), and
    fo_from moves them again."""
    k = ref("kernels")
    for d in range(3):
        clean, masked = k[f"clean/{d}/div"], k[f"fo_mask/{d}/div"]
        assert np.max(np.abs(clean - masked)) > 1e-3 * np.max(np.abs(clean))


# --------------------------------------------------------- (b) lean steps
def test_sedov_lean_step_matches_jax(ref, monkeypatch):
    """One step of Sedov 16^3 f32 through `Simulation`, both packages
    forced onto the lean path, the JAX dt."""
    s = ref("sedov")
    monkeypatch.setenv("QUOKKA_PALLAS_LEAN", "1")
    sim = Simulation(SedovProblem(), ParmParse.from_string(SEDOV_DECK), device="cpu")
    sim.set_initial_conditions()
    assert sim.advance_single_step(float(s["sedov_dt"]))
    ulp_close(s["sedov_U1"], sim.U, what="Sedov 16^3 lean step")


def test_rough_lean_step_matches_jax(ref, monkeypatch):
    """A rough 16^3 state (periodic x, walls y/z) whose two RK stages both
    fall back: the same invalid-cell count, the same state."""
    r = ref("rough")
    monkeypatch.setenv("QUOKKA_PALLAS_LEAN", "1")
    U, st = step(r["rough_U0"], 0.2 / N, (N, N, N), KERNEL_BC)
    assert st["fofc_fallbacks"] == 2
    assert int(st["n_fofc"]) == int(r["rough_n_fofc"]) > 0
    ulp_close(r["rough_U1"], U, what="rough 16^3 lean step")


def test_box_above_272_takes_u1_first_order(ref, monkeypatch):
    """280 x 8 x 8, rough: the default dispatch takes the lean branch, both
    stages fall back, and stage 2's first-order fluxes come from U1 as in
    JAX (`quokka_tpu/hydro/advance.py:1041-1057`); with U0's instead (the
    rule at or below 272) the state would move by O(1)."""
    b = ref("box")
    bc = BOX_BC
    monkeypatch.delenv("QUOKKA_PALLAS_LEAN", raising=False)
    dt = 0.2 / BOX_SHAPE[0]
    U, st = step(b["box_U0"], dt, BOX_SHAPE, bc)
    assert st["fofc_fallbacks"] == 2
    assert int(st["n_fofc"]) == int(b["box_n_fofc"]) > 0
    ulp_close(b["box_U1"], U, what="280 x 8 x 8 lean step")
    monkeypatch.setattr(advance, "LEAN_MIN_EXTENT", 10**9)
    monkeypatch.setenv("QUOKKA_PALLAS_LEAN", "1")
    U0rule, _ = step(b["box_U0"], dt, BOX_SHAPE, bc)
    fin = np.isfinite(b["box_U1"])
    gap = np.abs(U0rule.numpy() - b["box_U1"])[fin].max()
    assert gap > 1e-2 * np.abs(b["box_U1"][fin]).max()


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
def test_k2c_kernel_matches_plain_on_card():
    """K2c's variants against the plain versions on the card (skips without
    a GPU; chip_smoke.py runs them at 512^3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    inp = kernel_inputs()
    U0 = torch.tensor(inp["U0"], device="cuda")
    U1 = torch.tensor(inp["U1"], device="cuda")
    sweep.reset_launch_counts()
    for case in kernel_check.lean_cases(U0, U1, opts((N, N, N)), KERNEL_BC, seed=3):
        ok, max_abs, _, _, _ = case.check()
        assert ok, (case.label, max_abs)
    assert sweep.launch_counts["axis_flux_lean"] > 0


def test_lean_cases_slabs_match_whole_arrays():
    """The chip check's K2c cases on the CPU: the wrapper (here the plain
    version) and the slabbed plain side agree bitwise, walls and periodic
    axes alike, and each accumulating call starts from the same totals."""
    bc = BC_KINDS["periodic_x"]
    U0 = torch.tensor(rough_state((N, N, N), 5))
    U1 = torch.tensor(smooth_state((N, N, N), 6))
    cases = list(kernel_check.lean_cases(U0, U1, opts((N, N, N)), bc, seed=4, nslab=4))
    assert len(cases) == 12
    for case in cases:
        a, b = case.run_kernel(), case.run_plain()
        assert all(torch.equal(x, y) for x, y in zip(a, b)), case.label
        assert case.cost()[0] > 0
    dmins, chi = kernel_check.plain_transverse(U0, opts((N, N, N)), bc, nslab=4)
    ref_dmins, ref_chi, _ = sweep.precompute_transverse_plain(U0, opts((N, N, N)), bc, True)
    assert torch.equal(chi, ref_chi)
    assert all(torch.equal(dmins[t], ref_dmins[t]) for t in range(3))


def test_lean_step_profiler_regions(monkeypatch):
    """step_profile.py splits the lean step's device time by RK stage
    through the step's two profiler regions, and names K2c's CUDA kernel."""
    from quokka_tpu_torch import step_profile
    from quokka_tpu_torch.utils.profiler import prof

    monkeypatch.setenv("QUOKKA_PALLAS_LEAN", "1")
    bc = BC_KINDS["reflect_all"]
    prof.reset(enabled=True)
    try:
        step(smooth_state((8, 8, 8), 2), 0.01, (8, 8, 8), bc)
        assert set(advance.LEAN_STAGES) <= set(prof._acc)
    finally:
        prof.reset(enabled=False)
    assert step_profile.kernel_of("void qk::lean_tile_kernel<2>(float const*)") == "K2c"


def test_compare_holds_nonfinite_values_exactly():
    """kernel_check.compare (the chip check's bar) takes a NaN or an
    infinity as agreement only where the reference has the same one."""
    nan, inf = float("nan"), float("inf")
    ref = torch.tensor([1.0, nan, inf, -inf])
    assert kernel_check.compare(ref.clone(), ref)[0]
    for got in ([1.0, inf, inf, -inf], [1.0, nan, -inf, -inf], [1.0, 0.0, inf, -inf]):
        assert not kernel_check.compare(torch.tensor(got), ref)[0]
