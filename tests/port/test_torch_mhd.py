"""The port's MHD numerics against quokka_tpu on the same seeded inputs.

- `hlld` in f64 against the JAX `hlld` at 1e-12 x each component's max, on
  the faces of a rough seeded state that takes all six HLLD regions, the
  degenerate star denominator, bx = 0 and |bx| tiny (the port counts them).
- K8's plain version `mhd_axis_plain` against `compute_mhd_axis_pallas`
  (Pallas interpreted on the CPU, as tests/test_mhd.py runs it), f32, per
  axis, PLM without floors and PPM with density and pressure floors: rtol
  3e-5 + 3e-5 x each row's max, the JAX package's own bar between its
  Pallas and XLA forms (XLA contracts products into FMAs where PyTorch
  rounds each).
- `mhd_rhs` (K8's plain version per axis on the CPU) against the JAX XLA
  form in f64 at 1e-12 x each component's max.
- `faces_from_vector_potential` and the Orszag-Tang and field-loop initial
  conditions against JAX in f64 at 1e-14, with max |div B| < 1e-12.
- K8 against its plain version on the card at 32^3, and `mhd_rhs` on the
  card launching K8 or raising (marked `cuda`; skip without a GPU).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quokka_tpu.grid import Grid as JGrid
from quokka_tpu.hydro import riemann as jriem
from quokka_tpu.mhd import advance as jmhd
from quokka_tpu.mhd.pallas_sweep import compute_mhd_axis_pallas
from quokka_tpu.mhd.simulation import faces_from_vector_potential as jfaces
from quokka_tpu.problems import mhd as jprob

from quokka_tpu_torch import kernel_check
from quokka_tpu_torch.grid import Grid
from quokka_tpu_torch.hydro import reconstruct, riemann
from quokka_tpu_torch.interop import mhd_options_from_fields, mhd_state_from_numpy
from quokka_tpu_torch.mhd import advance, sweep
from quokka_tpu_torch.mhd.simulation import faces_from_vector_potential
from quokka_tpu_torch.problems import mhd as tprob

N = 16
GAMMA = 5.0 / 3.0


def _rough(dtype=np.float64):
    prim, bxf = kernel_check.rough_mhd_state(N)
    return prim.astype(dtype), [b.astype(dtype) for b in bxf]


def _jopts(order=2, floors=(0.0, 0.0), use_pallas=True):
    return jmhd.MHDOptions(gamma=GAMMA, dx=(1.0 / N,) * 3, reconstruction_order=order,
                           density_floor=floors[0], pressure_floor=floors[1],
                           use_pallas=use_pallas)


def _topts(jo):
    return mhd_options_from_fields(dataclasses.asdict(jo))


def _close_rows(ref, got, rtol, atol_frac):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape and np.all(np.isfinite(got))
    for c in range(ref.shape[0]):
        scale = np.max(np.abs(ref[c]))
        np.testing.assert_allclose(got[c], ref[c], rtol=rtol, atol=atol_frac * scale,
                                   err_msg=f"component {c}")


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_hlld_f64_all_regions(axis):
    prim, bxf = _rough()
    qL, qR = (q.numpy() for q in reconstruct.reconstruct_faces(torch.tensor(prim), axis, 2))
    vax, wax = sweep._FRAMES[axis]

    def sides(mod, arr):
        out = []
        for q in (qL, qR):
            z = arr(np.zeros_like(q[0]))
            out.append(mod.FaceState(rho=arr(q[0]), u=arr(q[1 + axis]), v=arr(q[1 + vax]),
                                     w=arr(q[1 + wax]), P=arr(q[4]), cs=z, E=z, Eint=z,
                                     by=arr(q[5 + vax]), bz=arr(q[5 + wax])))
        return out

    counts = dict.fromkeys(riemann.HLLD_REGIONS, 0)
    ref = jriem.hlld(*sides(jriem, jnp.asarray), GAMMA, jnp.asarray(bxf[axis]))
    got = riemann.hlld(*sides(riemann, torch.tensor), GAMMA, torch.tensor(bxf[axis]), counts)
    assert all(v > 0 for v in counts.values()), counts
    _close_rows(ref, got, 1e-12, 1e-12)


@pytest.mark.parametrize("order,floors", [(2, (0.0, 0.0)), (3, (0.6, 0.1))])
def test_k8_plain_matches_pallas(order, floors):
    prim, bxf = _rough(np.float32)
    jo = _jopts(order, floors)
    for axis in range(3):
        ref = compute_mhd_axis_pallas(jnp.asarray(prim), jnp.asarray(bxf[axis]), axis, jo)
        got = sweep.compute_mhd_axis(torch.tensor(prim), torch.tensor(bxf[axis]), axis,
                                     _topts(jo))
        assert got.dtype == torch.float32
        _close_rows(ref, got, 3e-5, 3e-5)


def _conserved(prim, bxf):
    """U [5, ...] from primitives, with the cell field averaged from the faces."""
    B = [0.5 * (b + np.roll(b, -1, axis=d)) for d, b in enumerate(bxf)]
    rho, v, P = prim[0], prim[1:4], prim[4]
    E = (P / (GAMMA - 1.0) + 0.5 * rho * (v * v).sum(axis=0)
         + 0.5 * (B[0] ** 2 + B[1] ** 2 + B[2] ** 2))
    return np.stack([rho, rho * v[0], rho * v[1], rho * v[2], E])


@pytest.mark.parametrize("order", [2, 3])
def test_mhd_rhs_f64_matches_xla_form(order):
    prim, bxf = _rough()
    U = _conserved(prim, bxf)
    jo = _jopts(order, use_pallas=False)
    jdU, jdB = jmhd.mhd_rhs(jnp.asarray(U), [jnp.asarray(b) for b in bxf], jo)
    tU, tBf = mhd_state_from_numpy(U, bxf, "cpu", torch.float64)
    tdU, tdB = advance.mhd_rhs(tU, tBf, _topts(jo))
    _close_rows(jdU, tdU, 1e-12, 1e-12)
    _close_rows(np.stack(jdB), torch.stack(tdB), 1e-12, 1e-12)


def test_vector_potential_faces():
    lo, hi = (0.0, 0.0, 0.0), (1.0, 1.5, 0.5)
    A = (lambda x, y, z, m: m.sin(2 * np.pi * y / 1.5) * m.cos(4 * np.pi * z / 0.5),
         lambda x, y, z, m: m.cos(2 * np.pi * x) * m.sin(4 * np.pi * z / 0.5),
         lambda x, y, z, m: m.sin(2 * np.pi * x) * m.sin(2 * np.pi * y / 1.5))
    ref = jfaces(JGrid((16, 24, 8), lo, hi),
                 tuple(lambda x, y, z, f=f: f(x, y, z, jnp) for f in A))
    grid = Grid((16, 24, 8), lo, hi)
    got = faces_from_vector_potential(grid, tuple(lambda x, y, z, f=f: f(x, y, z, np)
                                                  for f in A))
    _close_rows(np.stack(ref), torch.stack(got), 1e-14, 1e-14)
    opts = advance.MHDOptions(gamma=GAMMA, dx=grid.dx)
    assert float(advance.div_b(got, opts).abs().max()) < 1e-12


@pytest.mark.parametrize("name", ["OrszagTang", "FieldLoop"])
def test_initial_conditions(name):
    jcls = {"OrszagTang": jprob.OrszagTangProblem, "FieldLoop": jprob.FieldLoopProblem}[name]
    tcls = {"OrszagTang": tprob.OrszagTangProblem, "FieldLoop": tprob.FieldLoopProblem}[name]
    shape = (16, 12, 4)
    jU, jBf = jcls().set_initial_conditions_mhd(JGrid(shape))
    tU, tBf = tcls().set_initial_conditions_mhd(Grid(shape))
    _close_rows(jU, torch.tensor(tU), 1e-14, 1e-14)
    _close_rows(np.stack(jBf), torch.tensor(np.stack(tBf)), 1e-14, 1e-14)
    opts = advance.MHDOptions(gamma=GAMMA, dx=Grid(shape).dx)
    assert float(advance.div_b([torch.tensor(b) for b in tBf], opts).abs().max()) < 1e-12


@pytest.mark.cuda
def test_k8_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    n = 32
    prim, bxf = kernel_check.rough_mhd_state(n)
    P = torch.tensor(prim, dtype=torch.float32, device="cuda")
    B = [torch.tensor(b, dtype=torch.float32, device="cuda") for b in bxf]
    sweep.reset_launch_counts()
    for order in (2, 3):
        opts = advance.MHDOptions(gamma=GAMMA, dx=(1.0 / n,) * 3, reconstruction_order=order)
        for case in kernel_check.mhd_cases(P, B, opts):
            ok, max_abs, _, _, _ = case.check()
            assert ok, (case.label, order, max_abs)
    assert sweep.launch_counts["mhd_axis"] == 6


@pytest.mark.cuda
def test_mhd_rhs_on_card_launches_k8_or_raises():
    """`use_pallas` changes nothing; float64 takes the plain form (the JAX
    package's XLA path) with no launch; fewer than three active axes
    raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    prim, bxf = _rough()
    U = _conserved(prim, bxf)
    for dtype, axes, want in ((torch.float32, (0, 1, 2), None),
                              (torch.float64, (0, 1, 2), "plain"),
                              (torch.float32, (0, 1), NotImplementedError)):
        tU, tBf = mhd_state_from_numpy(U, bxf, "cuda", dtype)
        opts = dataclasses.replace(_topts(_jopts(use_pallas=False)), active_axes=axes)
        sweep.reset_launch_counts()
        if want is None or want == "plain":
            advance.mhd_rhs(tU, tBf, opts)
            assert sweep.launch_counts["mhd_axis"] == (3 if want is None else 0)
        else:
            with pytest.raises(want):
                advance.mhd_rhs(tU, tBf, opts)
            assert sweep.launch_counts["mhd_axis"] == 0
