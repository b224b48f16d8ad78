"""Plain K4, K5 and K6 of quokka_tpu_torch.radiation against the Pallas
kernels of quokka_tpu.radiation (interpret mode on the CPU, as the JAX
package's own tests run them), and the radiation numerics in float64
against the JAX package's XLA formulation.

Inputs: seeded 16^3 numpy states with moving gas (the work term is
non-zero) and, in the "rough" state, faces whose reconstructed state is
inadmissible (|f| -> 1, E near the floor), so the donor-cell fallback fires.
Opacities: RadhydroBench's constant kappa = 10, and a T-dependent power law
(a = -1, b != 0) given to both packages as the same law.

Tolerances:
- K6 (f32): rtol 1e-5 + 64 ulps of each component's max (XLA contracts
  a*b+c into FMAs where PyTorch rounds each op);
- anything through the Newton coupling (K4, K5; f32): max |port - jax| <=
  2e-5 x the component's max (an iteration count that differs at roundoff
  moves a cell by its last Newton correction);
- f64: the transport (the flux-dict formulation and `rad_transport_div`)
  at 1e-12, the coupling at 1e-10, relative to each component's max.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quokka_tpu.eos import IdealGasEOS as JEOS
from quokka_tpu.radiation import pallas_source as jpsrc
from quokka_tpu.radiation import pallas_substep as jpsub
from quokka_tpu.radiation import pallas_sweep as jpsw
from quokka_tpu.radiation import source_terms as jst
from quokka_tpu.radiation import system as jsys

from quokka_tpu_torch.eos import IdealGasEOS
from quokka_tpu_torch.interop import rad_options_from_fields
from quokka_tpu_torch.problems.radhydro_bench import RadhydroBenchProblem
from quokka_tpu_torch.radiation import source, source_terms, substep, sweep, system
from quokka_tpu_torch.registry import PowerLawOpacity

from torch_port_common import ulp_close

N = 16
DX = 1.0 / N
DT = 0.3 * DX / 1.0e2  # one RadhydroBench substep: cfl_rad dx / c_hat
RS = 6
LAWS = {  # (Planck, energy-mean, flux-mean): (kappa0, rho exponent, T exponent)
    "bench": ((10.0, 0.0, 0.0),) * 3,
    "tdep": ((10.0, -1.0, -1.5), (8.0, -1.0, -1.0), (12.0, -1.0, 0.5)),
}


def jax_opts(beta_order=1, include_work_term=True, dtype_pallas=True):
    return jsys.RadOptions(c=1.0e3, chat=1.0e2, arad=1.0, erad_floor=1e-10,
                           beta_order=beta_order, include_work_term=include_work_term,
                           use_pallas=dtype_pallas)


def port_opts(jo):
    return rad_options_from_fields(dataclasses.asdict(jo))


JEOS_BENCH = JEOS(gamma=5.0 / 3.0, mean_molecular_weight=1.0, boltzmann_constant=1.0)
EOS = IdealGasEOS(gamma=5.0 / 3.0, mean_molecular_weight=1.0, boltzmann_constant=1.0)


def jax_hooks(name):
    def law(k0, a, b):
        def kappa(rho, T):
            k = jnp.full_like(rho, k0)
            if a != 0.0:
                k = k * jnp.power(rho, a)
            if b != 0.0:
                k = k * jnp.power(T, b)
            return k
        return kappa
    return tuple(law(*x) for x in LAWS[name])


def port_problem(name):
    laws = [PowerLawOpacity(*x) for x in LAWS[name]]

    class P(RadhydroBenchProblem):
        planck_opacity, energy_mean_opacity, flux_mean_opacity = laws

    return P()


def make_rad_state(seed=0, rough=False):
    """[10, N, N, N] float64: moving gas near radiative equilibrium; `rough`
    plants |f| ~ 1 and E near the floor beside E ~ 1."""
    rng = np.random.default_rng(seed)
    shape = (N, N, N)
    rho = 0.5 + rng.random(shape)
    v = 0.3 * rng.standard_normal((3,) + shape)
    T = 0.5 + rng.random(shape)
    Eint = rho * 1.5 * T
    E = T**4 * (0.5 + rng.random(shape))
    n = rng.standard_normal((3,) + shape)
    n /= np.sqrt((n * n).sum(axis=0))
    fmag = 0.5 * rng.random(shape)
    if rough:
        fmag[rng.random(shape) < 0.1] = 0.9999
        E[rng.random(shape) < 0.1] = 2e-10
        E[::3, 1::4] *= 30.0
    F = n * fmag * 1.0e3 * E
    ke = 0.5 * rho * (v * v).sum(axis=0)
    return np.stack([rho, rho * v[0], rho * v[1], rho * v[2], Eint + ke, Eint,
                     E, F[0], F[1], F[2]])


def scaled_close(ref, got, rel, what=""):
    """max |got - ref| <= rel x the component's max, per component."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(ref)), what
    got = got.reshape(-1, *got.shape[-3:])
    ref = ref.reshape(-1, *ref.shape[-3:])
    for c in range(ref.shape[0]):
        scale = np.max(np.abs(ref[c]))
        assert np.max(np.abs(got[c] - ref[c])) <= rel * scale, (what, c)


@pytest.fixture(scope="module")
def rough32():
    return make_rad_state(seed=11, rough=True).astype(np.float32)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_k6_rad_div(rough32, axis):
    jo = jax_opts()
    cons = rough32[RS:]
    ref = jpsw.compute_rad_div_pallas(jnp.asarray(cons), axis, jo, 1, DX)
    got = sweep.compute_rad_div(torch.tensor(cons), axis, port_opts(jo), DX)
    ulp_close(np.asarray(ref)[0], got[0], what=f"K6 axis {axis}")


def test_k6_fallback_fires(rough32):
    """The rough input has inadmissible reconstructed faces on every axis."""
    R = torch.tensor(rough32[RS:]).reshape(1, 4, N, N, N)
    prim = system.rad_cons_to_prim(R, 1.0e3).reshape(4, N, N, N)
    from quokka_tpu_torch.hydro import reconstruct

    for d in range(3):
        qL, qR = reconstruct.ppm_faces(prim, d)
        bad = [(q[0] <= 0) | (q[1] ** 2 + q[2] ** 2 + q[3] ** 2 >= 1) for q in (qL, qR)]
        assert int((bad[0] | bad[1]).sum()) > 0, d


def test_transport_f64_flux_dict():
    U = make_rad_state(seed=12, rough=True)
    jo = jax_opts(dtype_pallas=False)
    dx = (DX,) * 3
    ref = jsys.rad_div_fluxes(jsys.compute_rad_fluxes(jnp.asarray(U), RS, jo, (0, 1, 2), dx), dx)
    got = system.rad_div_fluxes(system.compute_rad_fluxes(torch.tensor(U), RS, port_opts(jo),
                                                          (0, 1, 2), dx), dx)
    assert got.dtype == torch.float64
    scaled_close(ref, got, 1e-12, "transport f64")
    got_div = system.rad_transport_div(torch.tensor(U), RS, port_opts(jo), (0, 1, 2), dx)
    assert got_div.dtype == torch.float64
    scaled_close(ref, got_div, 1e-12, "rad_transport_div f64")


@pytest.mark.parametrize("opacity,beta_order,stage,rough", [
    ("bench", 1, 1, False), ("bench", 1, 2, True), ("tdep", 1, 1, True),
    ("tdep", 0, 2, False)])
def test_k5_source_update(opacity, beta_order, stage, rough):
    U = make_rad_state(seed=13, rough=rough).astype(np.float32)
    jo = jax_opts(beta_order)
    ref, _ = jpsrc.source_update_pallas(jnp.asarray(U), jnp.zeros(U.shape[1:], jnp.float32),
                                        DT, stage, jo, JEOS_BENCH, *jax_hooks(opacity), RS)
    counts = {}
    got = source.source_update_plain(torch.tensor(U), None, float(np.float32(DT)), stage,
                                     port_opts(jo), EOS, port_problem(opacity), RS, counts)
    scaled_close(ref, got, 2e-5, f"K5 {opacity} beta {beta_order} stage {stage}")
    assert counts["newton_iters"] > 0
    if beta_order == 1:
        assert counts["outer_iters"] > 0, "the work term must be exercised"


@pytest.mark.parametrize("beta_order", [0, 1])
def test_coupling_f64(beta_order):
    U = make_rad_state(seed=14, rough=True)
    src = 0.1 * np.random.default_rng(15).random(U.shape[1:])
    jo = jax_opts(beta_order, dtype_pallas=False)
    po = port_opts(jo)
    prob = port_problem("tdep")
    for stage in (1, 2):
        ref, _ = jst.add_source_terms_single_group(
            jnp.asarray(U), jnp.asarray(src), DT, stage, jo, JEOS_BENCH,
            *jax_hooks("tdep"), RS)
        got = source_terms.add_source_terms_single_group(
            torch.tensor(U), torch.tensor(src), DT, stage, po, EOS,
            prob.compute_planck_opacity, prob.compute_energy_mean_opacity,
            prob.compute_flux_mean_opacity, RS)
        scaled_close(ref, got, 1e-10, f"coupling f64 beta {beta_order} stage {stage}")


@pytest.mark.parametrize("opacity,rough", [("bench", False), ("tdep", True)])
def test_k4_fused_substep(opacity, rough):
    U = make_rad_state(seed=16, rough=rough).astype(np.float32)
    jo = jax_opts()
    ref, _ = jpsub.fused_substep_pallas(jnp.asarray(U), jnp.zeros(U.shape[1:], jnp.float32),
                                        DT, jo, JEOS_BENCH, *jax_hooks(opacity), RS, (DX,) * 3)
    got = substep.fused_substep(torch.tensor(U), None, float(np.float32(DT)), port_opts(jo),
                                EOS, port_problem(opacity), (DX,) * 3)
    scaled_close(ref, got, 2e-5, f"K4 {opacity}")


def test_opacity_laws():
    """Laws reach the kernels; a problem computing opacity in a hook does
    not, and the kernels' path names it."""
    P, E, F = port_problem("tdep").opacity_laws()
    assert (P.kappa0, E.kappa0, F.kappa0) == (10.0, 8.0, 12.0)
    assert RadhydroBenchProblem().opacity_laws() == (PowerLawOpacity(10.0),) * 3

    class Hooked(RadhydroBenchProblem):
        name = "Hooked"

        def compute_planck_opacity(self, rho, T):
            return torch.where(rho < 1.0, 1.0, 100.0)

    with pytest.raises(NotImplementedError, match="Hooked"):
        Hooked().opacity_laws()
