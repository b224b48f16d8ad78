"""The port's ghost-free hydro on outflow, mixed and user walls against
quokka_tpu, end to end.

The JAX references run in processes of their own (`jax_walls.py`, one a
case, all started with the module) with XLA kept from FMA contraction and
the Pallas kernels interpreted (`hydro.use_pallas = 1`), beside the port's
plain versions on the CPU. Tolerance: rtol 1e-5 + 64 ulps of each
component's max (tests/test_fused_update.py), with equal FOFC cell counts.

- one f32 RK2 step of a rough 8^3 state on the `outflow_all` and `mixed`
  walls (tests/test_ghostfree.py:75-95), fused and lean
  (QUOKKA_PALLAS_LEAN=1): FOFC fires next to the walls in both;
- the hybrid mode: a user x-lo wall padded by (4, 0, 0), y periodic, z
  reflecting walls in the kernels (tests/test_ghostfree.py
  `test_hybrid_user_bc_axis_matches_padded`), fused and lean;
- ShockCloud (user inflow x-lo, outflow x-hi, the hybrid mode) and
  Richtmyer-Meshkov (outflow x walls in the kernels) at 16^3 through
  `Simulation`, from the JAX package's initial state with its dts: step 1
  at the tolerance, step 3 within 1e-5 x each component's max (the bar of
  tests/port/test_torch_slice.py).
- On the card (marked `cuda`): the same steps launch K1-K3 and equal the
  CPU's plain run at the tolerance.
"""

import numpy as np
import pytest
import torch

import quokka_tpu_torch
from quokka_tpu_torch.boundaries import fill_ghosts
from quokka_tpu_torch.hydro import sweep
from quokka_tpu_torch.hydro.advance import advance_hydro_rk2
from quokka_tpu_torch.indices import EGAS, EINT, MX1, RHO
from quokka_tpu_torch.registry import BCSpec

from jax_ref import SharedJaxRun, run_root
from torch_port_common import jax_opts, port_opts, t32, ulp_close

N = 8  # jax_walls.N
STEP_CASES = ("fused_outflow_all", "fused_mixed", "lean_outflow_all", "lean_mixed")
# the longest first
CASES = ("lean_mixed", "lean_outflow_all", "fused_mixed", "fused_outflow_all",
         "lean_hybrid", "hybrid", "rm3d", "cloud")
HYBRID_CASES = ("hybrid", "lean_hybrid")
OUT = ("outflow", "outflow")
WALLS = {  # jax_walls.WALLS
    "outflow_all": {0: OUT, 1: OUT, 2: OUT},
    "mixed": {0: None, 1: ("reflect", "outflow"), 2: ("outflow", "reflect")},
}
HYBRID_BCS = dict(x=("user", "outflow"), y=("periodic", "periodic"), z=("reflect", "reflect"))
HYBRID_KINDS = {0: None, 1: None, 2: ("reflect", "reflect")}
SIM_DECK = """
geometry.prob_hi = 1.0 1.0 1.0
amr.n_cell = 16 16 16
cfl = 0.3
stop_time = 10.0
precision = single
verbose = 0
"""


@pytest.fixture(scope="module", autouse=True)
def jax_refs(tmp_path_factory):
    """{case: SharedJaxRun}, started at once when the module's first test
    runs."""
    root = run_root(tmp_path_factory)
    return {c: SharedJaxRun(root, f"jax_walls_{c}", "jax_walls.py", [c]) for c in CASES}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side takes one thread: beside the JAX processes and the
    other test workers a thread per core oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Inflow:
    """jax_walls.hybrid's user wall: a constant state on x-lo."""

    def fill_user_boundary(self, Ug, grid, ng, time, axis, side):
        rho, vx, e = 1.3, 1.7, 2.0
        sl = slice(0, ng[0])
        Ug[RHO, sl] = rho
        Ug[MX1, sl] = rho * vx
        Ug[MX1 + 1, sl] = 0.0
        Ug[MX1 + 2, sl] = 0.0
        Ug[EGAS, sl] = rho * e + 0.5 * rho * vx * vx
        Ug[EINT, sl] = rho * e
        return Ug


def _step(case, U0, device="cpu"):
    opts = port_opts(jax_opts(N))
    U = t32(U0).to(device)
    if case in HYBRID_CASES:
        bcs = BCSpec(**HYBRID_BCS)
        fill = lambda X: fill_ghosts(X, (4, 0, 0), bcs, _Inflow(), None)  # noqa: E731
        return advance_hydro_rk2(U, 0.2 / N, opts, fill, (4, 0, 0), (False, True, False),
                                 bc_kinds=HYBRID_KINDS)
    bc = WALLS[case.partition("_")[2]]
    periodic = tuple(bc[d] is None for d in range(3))
    return advance_hydro_rk2(U, 0.2 / N, opts, None, (0, 0, 0), periodic, bc_kinds=bc)


@pytest.mark.parametrize("case", STEP_CASES + HYBRID_CASES)
def test_wall_step_matches_jax(case, jax_refs, monkeypatch):
    ref = jax_refs[case].result()
    if case.startswith("lean"):
        monkeypatch.setenv("QUOKKA_PALLAS_LEAN", "1")
    else:
        monkeypatch.delenv("QUOKKA_PALLAS_LEAN", raising=False)
    U, st = _step(case, ref["U0"])
    if case not in HYBRID_CASES:
        assert int(ref["n_fofc"]) > 0, "the rough state must fire FOFC"
    assert int(st["n_fofc"]) == int(ref["n_fofc"])
    ulp_close(ref["U"], U, what=case)


def _sim(name, device="cpu"):
    from quokka_tpu_torch.problems import RichtmeyerMeshkovProblem, ShockCloudProblem

    prob = ShockCloudProblem() if name == "cloud" else RichtmeyerMeshkovProblem()
    sim = quokka_tpu_torch.Simulation(prob, quokka_tpu_torch.ParmParse.from_string(SIM_DECK),
                                      device=device)
    sim.set_initial_conditions()
    return sim


@pytest.mark.parametrize("name", ["cloud", "rm3d"])
def test_simulation_matches_jax(name, jax_refs, monkeypatch):
    monkeypatch.delenv("QUOKKA_PALLAS_LEAN", raising=False)
    ref = jax_refs[name].result()
    sim = _sim(name)
    want = {"cloud": (4, 0, 0), "rm3d": (0, 0, 0)}[name]
    assert sim._gf["ng"] == want and sim._gf["bc_kinds"] is not None
    ulp_close(ref["U0"], sim.U, what=f"{name} initial state")
    sim.U = t32(ref["U0"])
    for k in (1, 2, 3):
        dt = float(ref[f"dt{k}"])
        assert sim.advance_single_step(dt)
        sim.t += dt
        sim.istep += 1
        if k == 1:
            ulp_close(ref["U1"], sim.U, what=f"{name} step 1")
    got = sim.U.numpy()
    assert np.all(np.isfinite(got)) and got[RHO].min() > 0
    for c in range(got.shape[0]):
        scale = np.max(np.abs(ref["U3"][c]))
        assert np.max(np.abs(got[c] - ref["U3"][c])) <= 1e-5 * scale, (name, c)


@pytest.mark.cuda
@pytest.mark.parametrize("case", STEP_CASES + HYBRID_CASES)
def test_wall_step_on_card(case, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    from jax_walls import rough_state

    if case.startswith("lean"):
        monkeypatch.setenv("QUOKKA_PALLAS_LEAN", "1")
    U0 = rough_state(N, seed=5 if case in HYBRID_CASES else 3)
    sweep.reset_launch_counts()
    Ug, sg = _step(case, U0, "cuda")
    launched = dict(sweep.launch_counts)
    Uc, sc = _step(case, U0, "cpu")
    assert launched["transverse"] > 0
    assert launched["axis_flux_lean" if case.startswith("lean") else "apply_update"] > 0
    assert int(sg["n_fofc"]) == int(sc["n_fofc"])
    ulp_close(Uc.numpy(), Ug.cpu(), what=case)
