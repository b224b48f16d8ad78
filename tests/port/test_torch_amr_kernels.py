"""The dense-AMR kernels and operators of quokka_tpu_torch against
quokka_tpu: K7 (the M1 radiation face flux), K2d (the stage-2 hydro sweep
that also emits the time-averaged face flux for the flux registers), the
seven inter-level operators, and periodic ghost filling.

Inputs are made with numpy from a seed, on ghost-padded 16^3 arrays (an
8^3 interior and 4 periodic ghosts, as an AMR level pads them). The JAX
kernels run in Pallas interpret mode on the CPU, as the JAX package's own
tests run them.

Tolerances:
- K7 and K2d in f32 against the interpreted Pallas kernels: rtol 1e-5 + 64
  ulps of each component's max (XLA contracts a*b+c into FMAs where
  PyTorch rounds each op);
- f64 against the JAX package's XLA formulation: 1e-12 of each component's
  max;
- the operators and the ghost fill in f64: bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quokka_tpu import boundaries as jbnd
from quokka_tpu.amr import operators as jops
from quokka_tpu.hydro import advance as jadv
from quokka_tpu.hydro import pallas_sweep as jpsw
from quokka_tpu.radiation import pallas_sweep as jrpsw
from quokka_tpu.radiation import system as jsys
from quokka_tpu.indices import StateLayout as JLayout
from quokka_tpu.registry import BCSpec as JBCSpec

from quokka_tpu_torch import boundaries
from quokka_tpu_torch.amr import operators as ops
from quokka_tpu_torch.hydro import sweep
from quokka_tpu_torch.interop import rad_options_from_fields
from quokka_tpu_torch.radiation import sweep as rsweep
from quokka_tpu_torch.radiation import system
from quokka_tpu_torch.registry import BCSpec

from torch_port_common import jax_opts, make_state, port_opts, ulp_close

NI = 8  # interior cells per axis
NG = (4, 4, 4)
N = NI + 8  # padded extent
ACTIVE = (0, 1, 2)


def pad_np(U):
    """Periodic ghost padding in numpy (np.pad wrap)."""
    return np.pad(U, [(0, 0)] + [(g, g) for g in NG], mode="wrap")


def rad_block(seed, rough):
    """[4, NI, NI, NI] float64 radiation block: E ~ 1 with |f| < 0.5, and in
    the rough state |f| -> 1 and E near the floor in 10% of the cells, so
    reconstructed faces go inadmissible and the donor-cell fallback fires."""
    rng = np.random.default_rng(seed)
    shape = (NI,) * 3
    E = 0.5 + rng.random(shape)
    n = rng.standard_normal((3,) + shape)
    n /= np.sqrt((n * n).sum(axis=0))
    fmag = 0.5 * rng.random(shape)
    if rough:
        fmag[rng.random(shape) < 0.1] = 0.9999
        E[rng.random(shape) < 0.1] = 2e-10
    F = n * fmag * 1.0e3 * E
    return np.concatenate([E[None], F])


def jrad_opts(use_pallas, order=3):
    return jsys.RadOptions(c=1.0e3, chat=1.0e2, arad=1.0, erad_floor=1e-10,
                           reconstruction_order=order, use_pallas=use_pallas)


def prad_opts(jo):
    return rad_options_from_fields(dataclasses.asdict(jo))


# ---------------------------------------------------------------- K7
@pytest.mark.parametrize("rough,order", [(False, 3), (True, 3), (True, 2)])
def test_k7_plain_vs_pallas(rough, order):
    cons = pad_np(rad_block(21, rough)).astype(np.float32)
    jo = jrad_opts(True, order)
    prim = np.asarray(jsys.rad_cons_to_prim(jnp.asarray(cons)[None], jo.c))[0]
    for d in range(3):
        ref = jrpsw.compute_rad_axis_flux_pallas(jnp.asarray(prim), jnp.asarray(cons), d,
                                                 jo, 1)
        got = rsweep.compute_rad_axis_flux(torch.tensor(cons), d, prad_opts(jo))
        assert got.shape == (1, 4, N, N, N)
        ulp_close(np.asarray(ref)[0], got[0], what=f"K7 rough={rough} order={order} axis {d}")


def test_k7_fallback_fires():
    """The rough block has inadmissible reconstructed faces on every axis."""
    from quokka_tpu_torch.hydro import reconstruct

    R = torch.tensor(pad_np(rad_block(21, True)))
    prim = rsweep._prim_flat(R, prad_opts(jrad_opts(False)))
    for d in range(3):
        qL, qR = reconstruct.ppm_faces(prim, d)
        bad = [(q[0] <= 0) | (q[1] ** 2 + q[2] ** 2 + q[3] ** 2 >= 1) for q in (qL, qR)]
        assert int((bad[0] | bad[1]).sum()) > 0, d


@pytest.mark.parametrize("rough", [False, True])
def test_k7_f64_vs_xla(rough):
    """`compute_rad_fluxes` (K7's plain version per axis) against the JAX
    package's XLA flux dict (`radiation.use_pallas = 0`), float64."""
    U = np.concatenate([np.ones((6, N, N, N)), pad_np(rad_block(22, rough))])
    jo = jrad_opts(False)
    dx = (0.1,) * 3
    ref = jsys.compute_rad_fluxes(jnp.asarray(U), 6, jo, ACTIVE, dx)
    got = system.compute_rad_fluxes(torch.tensor(U), 6, prad_opts(jo), ACTIVE, dx)
    for d in ACTIVE:
        assert got[d].dtype == torch.float64
        a, b = got[d].numpy()[0], np.asarray(ref[d])[0]
        for c in range(4):
            assert np.max(np.abs(a[c] - b[c])) <= 1e-12 * np.max(np.abs(b[c])), (d, c)
    divs = system.rad_div_fluxes(got, dx)
    jdivs = jsys.rad_div_fluxes(ref, dx)
    np.testing.assert_allclose(divs.numpy(), np.asarray(jdivs), rtol=0,
                               atol=1e-12 * float(np.max(np.abs(np.asarray(jdivs)))))


def test_k7_refuses_what_the_kernel_does_not_take():
    """On the CPU the plain version takes any dtype; the wavespeed
    correction (tau_fn) is not ported."""
    U = torch.tensor(np.concatenate([np.ones((6, N, N, N)), pad_np(rad_block(23, False))]))
    po = prad_opts(jrad_opts(False))
    with pytest.raises(NotImplementedError):
        system.compute_rad_fluxes(U, 6, po, ACTIVE, (0.1,) * 3, tau_fn=lambda U, d: U[0])


# ---------------------------------------------------------------- K2d
def hydro_pair(seed):
    """(Ug0, Ug1) padded f64 states: a smooth seeded state and its neighbour
    (the stage-2 input), both periodic-padded."""
    U0 = make_state((NI,) * 3, seed=seed)
    U1 = make_state((NI,) * 3, seed=seed + 1)
    return pad_np(U0), pad_np(U1)


def test_k2d_plain_vs_pallas():
    """Both stages of the padded hydro step's sweeps (`_padded_sweeps`, the
    driver of K1, K2 and K2d on an AMR level) against the interpreted
    Pallas sweeps: stage 1's faces and summed divergence, then stage 2's
    time-averaged face fluxes, summed divergence and raw dvels."""
    Ug0, Ug1 = (a.astype(np.float32) for a in hydro_pair(31))
    jo = jax_opts(N)
    jo = dataclasses.replace(jo, dx=(1.0 / NI,) * 3)
    po = port_opts(jo)
    r1 = jpsw.compute_fluxes_pallas_div(jnp.asarray(Ug0), jo, None)
    ref = jpsw.compute_fluxes_pallas_div(jnp.asarray(Ug1), jo, None, avg_with=r1,
                                         emit_avg_flux=True)
    p1 = padded_sweeps(torch.tensor(Ug0), po)
    for d in ACTIVE:
        ulp_close(np.asarray(r1["fluxes"][d]), p1["fluxes"][d], what=f"K2 F axis {d}")
        ulp_close(np.asarray(r1["facevels"][d]), p1["facevels"][d], what=f"K2 v axis {d}")
        ulp_close(np.asarray(r1["dvels"][d]), p1["dvels"][d], what=f"K2 dvel axis {d}")
    ulp_close(axis_sum(r1["divs"]), p1["div"], what="K2 div sum")
    got = padded_sweeps(torch.tensor(Ug1), po, r1=p1, emit_avg_flux=True)
    for d in ACTIVE:
        ulp_close(np.asarray(ref["fluxes"][d]), got["fluxes"][d], what=f"K2d F_avg axis {d}")
        ulp_close(np.asarray(ref["dvels"][d]), got["dvels"][d], what=f"K2d dvel axis {d}")
    ulp_close(axis_sum(ref["divs"]), got["div"], what="K2d div sum")
    assert got["facevels"] == {} and p1["fluxes"] == {}  # stage 1's faces were consumed


def test_k2d_f64_vs_xla():
    """The padded sweeps' K2d stage in float64 against the JAX package's
    classic XLA fluxes: F_avg = 0.5 (F1 + F2), the summed divergence of
    F_avg, RAW stage-2 dvel."""
    Ug0, Ug1 = hydro_pair(32)
    jo = dataclasses.replace(jax_opts(N), use_pallas=False,
                             dx=(1.0 / NI,) * 3)
    po = port_opts(jo)
    F1, v1 = jadv.compute_fluxes(jnp.asarray(Ug0), jo)
    F2, v2 = jadv.compute_fluxes(jnp.asarray(Ug1), jo)
    p1 = padded_sweeps(torch.tensor(Ug0), po)
    got = padded_sweeps(torch.tensor(Ug1), po, r1=p1, emit_avg_flux=True)
    div = 0.0
    for d in ACTIVE:
        favg = 0.5 * (np.asarray(F1[d]) + np.asarray(F2[d]))
        div = div + (favg - np.roll(favg, -1, axis=1 + d)) / jo.dx[d]
        v = np.asarray(v2[d])
        dvel = (np.roll(v, -1, axis=d) - v) / jo.dx[d]
        close_f64(favg, got["fluxes"][d], ("F_avg", d))
        close_f64(dvel, got["dvels"][d], ("dvel", d))
    close_f64(div, got["div"], "div sum")


def padded_sweeps(Ug, po, **kw):
    from quokka_tpu_torch.hydro.advance import _padded_sweeps

    return _padded_sweeps(Ug, po, **kw)


def axis_sum(divs):
    """The per-axis divergences summed in axis order, as the port sums them."""
    total = np.asarray(divs[ACTIVE[0]])
    for d in ACTIVE[1:]:
        total = total + np.asarray(divs[d])
    return total


def close_f64(ref, got, what):
    r = ref.reshape(-1, *ref.shape[-3:])
    a = got.numpy().reshape(r.shape)
    for c in range(r.shape[0]):
        assert np.max(np.abs(a[c] - r[c])) <= 1e-12 * np.max(np.abs(r[c])), (what, c)


def test_k2d_arguments():
    Ug0, Ug1 = (torch.tensor(a) for a in hydro_pair(33))
    po = port_opts(dataclasses.replace(jax_opts(N), dx=(1.0 / NI,) * 3))
    dmins, chi, _ = sweep.precompute_transverse(Ug1, po, None, True)
    with pytest.raises(ValueError):  # K2d averages: it needs stage 1's faces
        sweep.compute_axis_flux(Ug1, 0, po, chi, dmins, dx_axis=po.dx[0],
                                state_is_cons=True, emit_avg_flux=True)


# ------------------------------------------------------ operators and fill
def seeded(shape, seed):
    rng = np.random.default_rng(seed)
    a = 1.0 + rng.random(shape)
    a[..., ::3, :, :] *= 5.0  # steps that the MC limiter and the corner scaling see
    return a


def test_restrict_prolong_bitwise():
    U = seeded((10, NI, NI, NI), 41)
    for fn in (ops.restrict, ops.prolong):
        jfn = getattr(jops, fn.__name__)
        got = fn(torch.tensor(U), ACTIVE).numpy()
        ref = np.asarray(jfn(jnp.asarray(U), ACTIVE))
        np.testing.assert_array_equal(got, ref, err_msg=fn.__name__)
    # conservative: children average to the parent
    fine = ops.prolong(torch.tensor(U), ACTIVE)
    np.testing.assert_allclose(ops.restrict(fine, ACTIVE).numpy(), U, rtol=1e-14)


def test_mask_operators_bitwise():
    rng = np.random.default_rng(42)
    m = rng.random((NI,) * 3) < 0.1
    tm = torch.tensor(m)
    np.testing.assert_array_equal(ops.prolong_mask(tm, ACTIVE).numpy(),
                                  np.asarray(jops.prolong_mask(jnp.asarray(m), ACTIVE)))
    fine = rng.random((2 * NI,) * 3) < 0.05
    np.testing.assert_array_equal(
        ops.restrict_mask_any(torch.tensor(fine), ACTIVE).numpy(),
        np.asarray(jops.restrict_mask_any(jnp.asarray(fine), ACTIVE)))
    for periodic in ((True, True, True), (False, True, False)):
        np.testing.assert_array_equal(
            ops.dilate(tm, 2, ACTIVE, periodic).numpy(),
            np.asarray(jops.dilate(jnp.asarray(m), 2, ACTIVE, periodic)))


def test_face_flux_operators_bitwise():
    """mask_face_flux and restrict_face_flux keep the padded face-slot
    convention: checked bitwise against JAX on a coarse-aligned mask."""
    rng = np.random.default_rng(43)
    coarse = rng.random((NI // 2,) * 3) < 0.3
    mask = np.repeat(np.repeat(np.repeat(coarse, 2, 0), 2, 1), 2, 2)
    F = rng.standard_normal((10, N, N, N))
    for d in ACTIVE:
        got = ops.mask_face_flux(torch.tensor(F), torch.tensor(mask), d, NG)
        ref = jops.mask_face_flux(jnp.asarray(F), jnp.asarray(mask), d, NG)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        got_r = ops.restrict_face_flux(got, d, ACTIVE, NG, NG)
        ref_r = jops.restrict_face_flux(ref, d, ACTIVE, NG, NG)
        assert got_r.shape == (10, NI // 2 + 8, NI // 2 + 8, NI // 2 + 8)
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(ref_r))


def test_fill_ghosts_periodic_bitwise():
    U = seeded((10, NI, NI + 2, NI - 2), 44)
    layout = JLayout(hydro_enabled=True, radiation_enabled=True)
    ref = jbnd.fill_ghosts(jnp.asarray(U), NG, JBCSpec(), layout)
    got = boundaries.fill_ghosts(torch.tensor(U), NG, BCSpec())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # reflecting walls on a hydro block (the classic float64 step's fill)
    walls = dict(x=("reflect", "reflect"), z=("reflect", "reflect"))
    hydro = JLayout(hydro_enabled=True, radiation_enabled=False)
    ref = jbnd.fill_ghosts(jnp.asarray(U[:6]), NG, JBCSpec(**walls), hydro)
    got = boundaries.fill_ghosts(torch.tensor(U[:6]), NG, BCSpec(**walls))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # outflow walls copy the edge cell, as the JAX fill does
    walls = dict(x=("outflow", "reflect"), y=("outflow", "outflow"))
    ref = jbnd.fill_ghosts(jnp.asarray(U[:6]), NG, JBCSpec(**walls), hydro)
    got = boundaries.fill_ghosts(torch.tensor(U[:6]), NG, BCSpec(**walls))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the NSCBC walls are not ported (hydro/nscbc.py)
    with pytest.raises(NotImplementedError, match="nscbc_inflow"):
        boundaries.fill_ghosts(torch.tensor(U), NG, BCSpec(x=("nscbc_inflow", "outflow")))


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rough", [False, True])
def test_k7_kernel_matches_plain(cuda_device, rough):
    from quokka_tpu_torch import kernel_check

    cons = torch.tensor(pad_np(rad_block(24, rough)), dtype=torch.float32,
                        device=cuda_device)
    po = prad_opts(jrad_opts(False))
    for d in ACTIVE:
        ok, max_abs, _ = kernel_check.compare(rsweep.compute_rad_axis_flux(cons, d, po),
                                              rsweep.rad_axis_flux_plain(cons, d, po))
        assert ok, (d, max_abs)
    with pytest.raises(TypeError):
        rsweep.compute_rad_axis_flux(cons.double(), 0, po)


@pytest.mark.cuda
def test_k2d_kernel_matches_plain(cuda_device):
    from quokka_tpu_torch import kernel_check

    Ug0, Ug1 = (torch.tensor(a, dtype=torch.float32, device=cuda_device)
                for a in hydro_pair(34))
    po = port_opts(dataclasses.replace(jax_opts(N), dx=(1.0 / NI,) * 3))
    r1 = sweep.compute_fluxes_pallas_div(Ug0, po, None)
    dmins, chi, _ = sweep.precompute_transverse_plain(Ug1, po, None, True)
    for d in ACTIVE:
        kw = dict(dx_axis=po.dx[d], avg_with=(r1["fluxes"][d], r1["facevels"][d]),
                  state_is_cons=True, emit_avg_flux=True)
        ok, max_abs, _ = kernel_check.compare(
            sweep.compute_axis_flux(Ug1, d, po, chi, dmins, **kw),
            sweep.axis_flux_plain(Ug1, d, po, chi, dmins, **kw))
        assert ok, (d, max_abs)


# ------------------------------------------------ the card's check, on the CPU
def test_amr_cases_slabs_match_whole_arrays():
    """chip_smoke.py holds the dense-AMR kernels (K1, K2 stage 1, K2d, K7,
    K5) at the fine level's shapes against their plain versions run in
    slabs (`kernel_check.amr_cases`). On the CPU each wrapper is its plain
    version on the whole array, so every case's two sides must agree
    bitwise: the slabs, with K1's periodic halo, change nothing."""
    from quokka_tpu_torch import ParmParse, kernel_check
    from quokka_tpu_torch.amr import AMRSimulation
    from quokka_tpu_torch.problems.radhydro_shell import RadhydroShellProblem

    from jax_amr_shell import shell_deck

    sim = AMRSimulation(RadhydroShellProblem(), ParmParse.from_string(shell_deck(16, 1)),
                        device="cpu", precision="single")
    sim.set_initial_conditions()
    U = sim.level_U[1]

    def fill(A):
        return boundaries.fill_ghosts(A, sim.ng, sim.problem.bcs)

    rough = torch.tensor(make_state(U.shape[1:], seed=35), dtype=U.dtype)
    src = sim._get_level_rad(1)._rad_src(sim.t, U)
    cases = list(kernel_check.amr_cases(
        fill(U[:6]), fill(rough), fill(U[6:]), sim.level_opts[1], sim._radiation.opts,
        nslab=3, coupling=(U, src, 1e-3, sim.eos, sim.problem)))
    assert [c.kernel for c in cases] == (["transverse"] * 2
                                         + ["axis_flux", "axis_flux_avg"] * 3
                                         + ["rad_axis_flux"] * 3 + ["rad_source"] * 2)
    for case in cases:
        got = kernel_check._flat(case.run_kernel())
        ref = kernel_check._flat(case.run_plain())
        assert len(got) == len(ref) > 0, case.label
        for a, b in zip(got, ref):
            assert torch.equal(a, b), case.label
