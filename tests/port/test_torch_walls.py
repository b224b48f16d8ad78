"""Outflow and user walls of quokka_tpu_torch against quokka_tpu.

- `boundaries.fill_ghosts` with outflow, user (a Dirichlet hook) and mixed
  sides against the JAX package's `fill_ghosts`, bit for bit in f64, the
  edge and corner ghosts included.
- The exact outflow chi ghost planes of `precompute_transverse_plain`
  against the JAX package's `precompute_transverse_fields` on its
  `outflow_all` and `mixed` walls (tests/test_ghostfree.py:75-95), rough and
  smooth, bit for bit in f64; the planes differ from the edge cells' chi, so
  they carry weight.
- K2's plain version with the planes (`chi_ghost_axis`) against
  `compute_axis_flux_pallas` run interpreted, f32, rtol 1e-5 + 64 ulps of
  each component's max; and the ghost-free plain fluxes against the padded
  plain fluxes, bit for bit in f64 (the padded fill is what the wall
  assembly reproduces).
- `Simulation`'s stepping mode per problem (the JAX package's
  `_ghost_free_config`), the NSCBC refusal, the registry's hooks, and that
  no module of the port imports jax or quokka_tpu.
- Twins on the card (marked `cuda`): K1's outflow outputs bit for bit and
  every K2 variant within the tolerance at the outflow edge shapes, and K3
  on x-padded stage inputs.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quokka_tpu import boundaries as jbnd
from quokka_tpu.hydro import euler as jeuler
from quokka_tpu.hydro import pallas_sweep as jps
from quokka_tpu.indices import StateLayout as JLayout
from quokka_tpu.registry import BCSpec as JBCSpec

import quokka_tpu_torch
from quokka_tpu_torch import boundaries, kernel_check
from quokka_tpu_torch.hydro import sweep
from quokka_tpu_torch.registry import (BC_NSCBC_OUTFLOW, BC_OUTFLOW, BC_PERIODIC,
                                       BC_REFLECT, BC_USER, BCSpec, Problem)

from torch_port_common import jax_opts, make_state, port_opts, t32, ulp_close

N = 8
HYDRO = JLayout(hydro_enabled=True, radiation_enabled=False)
OUT, REF = (BC_OUTFLOW, BC_OUTFLOW), (BC_REFLECT, BC_REFLECT)
# the JAX package's ghost-free wall sets (tests/test_ghostfree.py:75-95)
WALLS = {
    "outflow_all": {0: OUT, 1: OUT, 2: OUT},
    "mixed": {0: None, 1: (BC_REFLECT, BC_OUTFLOW), 2: (BC_OUTFLOW, BC_REFLECT)},
}


def _spec(kinds: dict):
    return {("x", "y", "z")[d]: (k if k is not None else (BC_PERIODIC,) * 2)
            for d, k in kinds.items()}


class _Dirichlet:
    """A user wall on x: a constant inflow state on the lo side and a
    different one on the hi side, written over the whole ghost slab."""

    VALS = ((1.3, 1.7, 0.1, -0.2, 2.0), (0.7, -0.4, 0.0, 0.3, 1.5))

    @staticmethod
    def _cons(rho, vx, vy, vz, e):
        ke = 0.5 * rho * (vx * vx + vy * vy + vz * vz)
        return [rho, rho * vx, rho * vy, rho * vz, rho * e + ke, rho * e]

    def fill_user_boundary(self, Ug, grid, ng, time, axis, side):
        assert axis == 0
        g = ng[0]
        vals = self._cons(*self.VALS[side])
        sl = slice(0, g) if side == 0 else slice(Ug.shape[1] - g, Ug.shape[1])
        if isinstance(Ug, torch.Tensor):
            for c, v in enumerate(vals):
                Ug[c, sl] = v
            return Ug
        return Ug.at[:, sl].set(jnp.asarray(vals, Ug.dtype)[:, None, None, None])


FILLS = {
    "outflow": dict(x=OUT, y=OUT, z=OUT),
    "user x, outflow y, reflect z": dict(x=(BC_USER, BC_USER), y=OUT, z=REF),
    "mixed sides": dict(x=(BC_USER, BC_OUTFLOW), y=(BC_REFLECT, BC_OUTFLOW),
                        z=(BC_OUTFLOW, BC_PERIODIC)),
}


@pytest.mark.parametrize("name", sorted(FILLS))
def test_fill_ghosts_matches_jax(name):
    U = make_state((7, 6, 5), seed=21)
    ng = (4, 3, 4)
    hook = _Dirichlet()
    ref = jbnd.fill_ghosts(jnp.asarray(U), ng, JBCSpec(**FILLS[name]), HYDRO,
                           problem=hook, grid=None)
    got = boundaries.fill_ghosts(torch.tensor(U), ng, BCSpec(**FILLS[name]), hook, None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fill_ghosts_refuses_nscbc_and_a_missing_hook():
    U = torch.tensor(make_state((6, 6, 6), seed=2))
    with pytest.raises(NotImplementedError, match=BC_NSCBC_OUTFLOW):
        boundaries.fill_ghosts(U, (4, 4, 4), BCSpec(y=(BC_OUTFLOW, BC_NSCBC_OUTFLOW)))
    with pytest.raises(ValueError, match="problem"):
        boundaries.fill_ghosts(U, (4, 0, 0), BCSpec(x=(BC_USER, BC_OUTFLOW)))
    with pytest.raises(NotImplementedError, match="fill_user_boundary"):
        boundaries.fill_ghosts(U, (4, 0, 0), BCSpec(x=(BC_USER, BC_OUTFLOW)), Problem())


@pytest.mark.parametrize("walls", sorted(WALLS))
@pytest.mark.parametrize("rough", [False, True])
def test_outflow_chi_planes_match_jax(walls, rough):
    n = 16
    bc = WALLS[walls]
    jo = dataclasses.replace(jax_opts(n), use_pallas=False)
    U = make_state((n, n, n), seed=3, rough=rough)
    jprim = jeuler.cons_to_prim(jnp.asarray(U), jo.eos, jo.reconstruct_eint)
    jd, jchi, jghost = jps.precompute_transverse_fields(jprim, jo, bc)
    prim = torch.tensor(np.asarray(jprim))  # the same primitives on both sides
    dmins, chi, ghost = sweep.precompute_transverse_plain(prim, port_opts(jo), bc)
    np.testing.assert_array_equal(chi.numpy(), np.asarray(jchi))
    for t in range(3):
        np.testing.assert_array_equal(dmins[t].numpy(), np.asarray(jd[t]))
    assert sorted(ghost) == sorted(jghost)
    for d, (lo, hi) in jghost.items():
        for got, ref in zip(ghost[d], (lo, hi)):
            assert (got is None) == (ref is None)
            if ref is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if rough and walls == "outflow_all":
        # the planes are not the edge cells' chi_cell
        assert float((ghost[0][0] - chi[:1]).abs().max()) > 0.1


def test_ghost_free_walls_match_the_padded_fill():
    """The plain sweep's assembled outflow and mixed walls (f64) give the
    fluxes of the same sweep on the fill_ghosts-padded state, bit for bit:
    the wall-adjacent chi ghost from its plane, the other ghosts copies."""
    n, g = 12, 4
    opts = port_opts(jax_opts(n))
    for walls in ("outflow_all", "mixed"):
        bc = WALLS[walls]
        U = torch.tensor(make_state((n, n, n), seed=9, rough=True))
        fl, fv, flh, fvh = sweep.compute_fluxes_pallas(U, opts, bc_kinds=bc, plain=True)
        Ug = boundaries.fill_ghosts(U, (g, g, g), BCSpec(**_spec(bc)))
        flp, fvp = sweep.compute_fluxes_pallas(Ug, opts, plain=True)
        inner = (slice(g, n + g),) * 3
        for d in range(3):
            sl = list(inner)
            got = torch.cat([fl[d], (flh[d].unsqueeze(1 + d) if d in flh
                                     else fl[d].narrow(1 + d, 0, 1))], dim=1 + d)
            sl[d] = slice(g, n + g + 1)
            np.testing.assert_array_equal(got.numpy(), flp[d][(slice(None),) + tuple(sl)].numpy(),
                                          err_msg=f"{walls} axis {d}")
            gv = torch.cat([fv[d], (fvh[d].unsqueeze(d) if d in fvh
                                    else fv[d].narrow(d, 0, 1))], dim=d)
            np.testing.assert_array_equal(gv.numpy(), fvp[d][tuple(sl)].numpy())


@pytest.fixture(scope="module", params=sorted(WALLS))
def pallas_case(request):
    bc = WALLS[request.param]
    jo = jax_opts(N)
    U = make_state((N, N, N), seed=5, rough=True).astype(np.float32)
    j = jnp.asarray(U)
    jd, jchi, jghost = jps.precompute_transverse_pallas(j, jo, bc, state_is_cons=True)
    refs = {d: jps.compute_axis_flux_pallas(j, d, jo, jchi, jd, bc_axis=bc[d],
                                            chi_ghost_axis=jghost.get(d), dx_axis=jo.dx[d],
                                            state_is_cons=True) for d in range(3)}
    return dict(bc=bc, opts=port_opts(jo), U=t32(U), k1=(jd, jchi, jghost), refs=refs)


def test_k1_planes_vs_pallas(pallas_case):
    jd, jchi, jghost = pallas_case["k1"]
    dmins, chi, ghost = sweep.precompute_transverse(pallas_case["U"], pallas_case["opts"],
                                                    pallas_case["bc"], True)
    ulp_close(jchi, chi, what="chi_cell")
    assert sorted(ghost) == sorted(jghost)
    for d in ghost:
        for got, ref in zip(ghost[d], jghost[d]):
            assert (got is None) == (ref is None)
            if ref is not None:
                ulp_close(ref, got, what=f"plane {d}")


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_axis_flux_with_planes_vs_pallas(pallas_case, axis):
    jd, jchi, jghost = pallas_case["k1"]
    opts, bc = pallas_case["opts"], pallas_case["bc"]
    dmins = {t: torch.from_numpy(np.asarray(jd[t])) for t in range(3)}
    chi = torch.from_numpy(np.asarray(jchi))
    planes = jghost.get(axis)
    if planes is not None:
        planes = tuple(None if p is None else torch.from_numpy(np.asarray(p)) for p in planes)
    got = sweep.compute_axis_flux(pallas_case["U"], axis, opts, chi, dmins, bc_axis=bc[axis],
                                  chi_ghost_axis=planes, dx_axis=opts.dx[axis],
                                  state_is_cons=True)
    ref = [np.asarray(r) for r in pallas_case["refs"][axis]]
    got = [g.numpy() for g in got]
    assert len(got) == len(ref)  # (F, v[, F_hi, v_hi], div, dvel)
    if bc[axis] is not None:
        # the n + 1 faces: a wall plane (often 0 up to roundoff) is held to
        # the scale of its whole face field (as test_torch_sweep.py holds it)
        for out in (got, ref):
            out[:4] = [np.concatenate([out[0], np.expand_dims(out[2], 1 + axis)], 1 + axis),
                       np.concatenate([out[1], np.expand_dims(out[3], axis)], axis)]
    for i, (a, b) in enumerate(zip(got, ref)):
        ulp_close(b, torch.from_numpy(a), what=f"axis {axis} output {i}")


def test_ghost_free_config_per_problem(monkeypatch):
    from quokka_tpu_torch.problems import (RichtmeyerMeshkovProblem, SedovProblem,
                                           ShockCloudProblem, ShocktubeProblem)

    monkeypatch.delenv("QUOKKA_PALLAS_LEAN", raising=False)
    P = quokka_tpu_torch.ParmParse

    def cfg(prob, deck):
        return quokka_tpu_torch.Simulation(prob, P.from_string(deck), device="cpu")._gf

    box = "amr.n_cell = 16 16 16\nprecision = single\n"
    sc = cfg(ShockCloudProblem(), box)
    assert sc["ng"] == (4, 0, 0) and sc["bc_kinds"] == {0: None, 1: None, 2: None}
    assert tuple(sc["fill"](torch.zeros(6, 16, 16, 16)).shape) == (6, 24, 16, 16)
    rm = cfg(RichtmeyerMeshkovProblem(), box)
    assert rm["ng"] == (0, 0, 0) and rm["fill"] is None
    assert rm["bc_kinds"] == {0: OUT, 1: None, 2: None}
    assert cfg(SedovProblem(), box)["bc_kinds"] == {0: REF, 1: REF, 2: REF}
    for deck in ("amr.n_cell = 16 16 16\nprecision = double\n",
                 box + "hydro.ghost_free = 0\n",
                 "amr.n_cell = 64 1 1\nprecision = single\n"):
        c = cfg(RichtmeyerMeshkovProblem(), deck)
        assert c["bc_kinds"] is None and max(c["ng"]) == 4, deck
    st = cfg(ShocktubeProblem(), "amr.n_cell = 64 1 1\n")
    assert st["ng"] == (4, 0, 0) and st["bc_kinds"] is None

    class NSCBCx(Problem):
        bcs = BCSpec(x=(BC_NSCBC_OUTFLOW, BC_OUTFLOW))

    nc = cfg(NSCBCx(), box)
    assert nc["ng"] == (4, 0, 0)
    with pytest.raises(NotImplementedError, match=BC_NSCBC_OUTFLOW):
        nc["fill"](torch.zeros(6, 16, 16, 16))


def test_f64_sqrt_rounds_correctly():
    """The plain versions' square root rounds correctly in float64 on the CPU
    too (PyTorch's own is one ulp off for ~0.8% of inputs there; NumPy's and
    XLA's, which the JAX package takes, round correctly)."""
    from quokka_tpu_torch._numerics import sqrt

    v = np.random.default_rng(0).random(20000) * 10.0
    np.testing.assert_array_equal(sqrt(torch.tensor(v)).numpy(), np.sqrt(v))
    np.testing.assert_array_equal(sqrt(torch.tensor(v)).numpy(),
                                  np.asarray(jnp.sqrt(jnp.asarray(v))))


def test_registry_hooks_default():
    p = Problem()
    assert p.compute_reference_solution(None) is None
    with pytest.raises(NotImplementedError, match="fill_user_boundary"):
        p.fill_user_boundary(None, None, (4, 0, 0), 0.0, 0, 0)


def test_no_port_module_imports_jax():
    """Every module of quokka_tpu_torch imports without jax or quokka_tpu."""
    code = ("import pkgutil, importlib, sys, quokka_tpu_torch as q\n"
            "mods = [m.name for m in pkgutil.walk_packages(q.__path__, 'quokka_tpu_torch.')]\n"
            "for m in mods: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'quokka_tpu') or "
            "m.startswith(('jax.', 'quokka_tpu.'))]\n"
            "print(len(mods), bad); sys.exit(1 if bad or len(mods) < 40 else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    return torch.device("cuda")


def _opts():
    return port_opts(jax_opts(16))


@pytest.mark.cuda
def test_k1_outflow_edge_cases_bitwise_on_card(cuda_device):
    for case in kernel_check.k1_wall_edge_cases(_opts(), cuda_device):
        _, _, _, got, ref = case.check()
        assert kernel_check.same_bits(got, ref), case.label


@pytest.mark.cuda
@pytest.mark.parametrize("gen", ["face_wall_edge_cases", "lean_edge_cases",
                                 "sweep_edge_cases"])
def test_k2_outflow_edge_cases_on_card(cuda_device, gen):
    kw = {} if gen == "face_wall_edge_cases" else {"shapes": kernel_check.OUTFLOW_EDGE_SHAPES}
    for case in getattr(kernel_check, gen)(_opts(), cuda_device, **kw):
        ok, max_abs, _, _, _ = case.check()
        assert ok, (case.label, max_abs)


@pytest.mark.cuda
def test_k3_padded_inputs_on_card(cuda_device):
    U = kernel_check.hydro_blocks(1, (20, 12, 9), 3, cuda_device)[0]
    for ng in ((4, 0, 0), (0, 4, 0)):
        shape = (20 + 2 * ng[0], 12 + 2 * ng[1], 9)
        Ug = kernel_check.hydro_blocks(1, shape, 4, cuda_device)[0]
        divs = {d: 0.01 * kernel_check.hydro_blocks(1, shape, 5 + d, cuda_device)[0]
                for d in range(3)}
        dvels = {d: 0.01 * torch.rand(shape, device=cuda_device) for d in range(3)}
        got = sweep.apply_update(U, Ug, divs, dvels, 0.01, _opts(), ng)
        ref = sweep.apply_update_plain(U, Ug, divs, dvels, 0.01, _opts(), ng)
        ok, _, _ = kernel_check.compare(got[0], ref[0])
        assert ok and int(got[1]) == int(ref[1]), ng


def test_step_profile_counts_k1_plane_pass_as_k1():
    """K1's second pass (the outflow chi planes) is profiled as K1."""
    from quokka_tpu_torch import step_profile

    names = {"qk::outflow_planes_kernel(qk::K1Args, qk::K1Planes)": "K1",
             "qk::transverse_kernel_march(qk::K1Args)": "K1"}
    assert {n: step_profile.kernel_of(n) for n in names} == names
