"""Shared inputs and tolerances of the port parity tests (tests/port)."""

import contextlib
import dataclasses
import importlib

import numpy as np
import torch

from quokka_tpu.eos import IdealGasEOS as JEOS
from quokka_tpu.hydro import advance as jadv
from quokka_tpu.registry import BC_REFLECT

from quokka_tpu_torch.interop import hydro_options_from_fields, state_from_numpy

# the radiation kernel wrappers K4-K7, by the module attributes their callers
# read: K4 `fused_substep`, K5 `source_update` (imported by the unigrid and
# dense-level subcycles) and `source_update_batched` (looked up by the
# packed engine), K6, K7 and K7 batched
RAD_KERNEL_WRAPPERS = (
    ("quokka_tpu_torch.radiation.advance", "fused_substep"),
    ("quokka_tpu_torch.radiation.advance", "source_update"),
    ("quokka_tpu_torch.radiation.source", "source_update"),
    ("quokka_tpu_torch.radiation.source", "source_update_batched"),
    ("quokka_tpu_torch.radiation.sweep", "compute_rad_div"),
    ("quokka_tpu_torch.radiation.sweep", "compute_rad_axis_flux"),
    ("quokka_tpu_torch.radiation.sweep", "compute_rad_axis_flux_batched"),
)

REFLECT = (BC_REFLECT, BC_REFLECT)
BC_KINDS = {
    "reflect_all": {0: REFLECT, 1: REFLECT, 2: REFLECT},
    "periodic_x": {0: None, 1: REFLECT, 2: REFLECT},
}


def make_state(shape, seed=0, rough=False):
    """Seeded conserved state (float64 numpy); `rough` plants a density /
    pressure well and wall shocks that drive the update invalid and fire
    the FOFC fallback (same recipe as tests/test_ghostfree.py)."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.5 * rng.random(shape)
    vx = 0.3 * rng.standard_normal(shape)
    vy = 0.3 * rng.standard_normal(shape)
    vz = 0.3 * rng.standard_normal(shape)
    eint = 1.0 + rng.random(shape)
    if rough:
        rho[2, 2, 2] = 1e-4
        eint[2, 2, 2] = 1e-6
        vx[3, 2, 2] = 8.0
        vx[1, 2, 2] = -8.0
        n = shape[0]
        eint[0, :, :] *= 30.0
        eint[1, :, :] *= 4.0
        vx[0, :, :] = 2.0
        vx[1, :, :] = -1.5
        eint[:, :, n - 1] *= 25.0
        eint[:, :, n - 2] *= 3.0
        vz[:, :, n - 1] = -2.0
        vz[:, :, n - 2] = 1.2
    ke = 0.5 * rho * (vx**2 + vy**2 + vz**2)
    return np.stack([rho, rho * vx, rho * vy, rho * vz, rho * eint + ke,
                     rho * eint])


def with_scalars(U, n_scalars, n_mscalars, seed):
    """U [6, ...] with `n_scalars` seeded scalar densities appended: mass
    scalars as fractions of rho that sum to less than 1, passive ones as
    rho times a value in [0, 1)."""
    rng = np.random.default_rng(seed)
    frac = rng.random((n_scalars,) + U.shape[1:])
    if n_mscalars:
        frac = 0.2 + 0.3 * frac
    return np.concatenate([U, frac * U[0]])


def jax_opts(n, **kw):
    return jadv.HydroOptions(
        dx=(1.0 / n, 1.0 / n, 1.0 / n), eos=JEOS(gamma=1.4),
        active_axes=(0, 1, 2), reconstruction_order=3, use_pallas=True,
        reconstruct_eint=False, **kw)


def port_opts(jopts):
    return hydro_options_from_fields(dataclasses.asdict(jopts))[0]


def t32(a):
    return state_from_numpy(a, "cpu", torch.float32)


def ulp_close(b, a, rtol=1e-5, ulp_of_max=64, what=""):
    """Per-component agreement of port result `a` with reference `b` at f32
    roundoff: rtol 1e-5 plus `ulp_of_max` ulps of the component's largest
    magnitude (the bound of tests/test_fused_update.py). Non-finite
    patterns must agree exactly."""
    a = np.asarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a,
                   np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=what)
    np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=what)
    if a.ndim <= 2:
        a, b, fin = a[None], b[None], fin[None]
    if a.ndim == 3:
        a, b, fin = a[None], b[None], fin[None]
    for c in range(a.shape[0]):
        m = fin[c]
        atol = ulp_of_max * np.spacing(np.max(np.abs(b[c][m]), initial=0.0))
        np.testing.assert_allclose(a[c][m], b[c][m], rtol=rtol, atol=atol,
                                   err_msg=f"{what} component {c}")


@contextlib.contextmanager
def refuse_f64_rad_kernels():
    """Within the block a radiation kernel wrapper (K4-K7) that is handed a
    float64 tensor raises AssertionError: on the card it would launch its
    float32 kernel or raise, so a float64 run must take the plain versions
    at the call sites. float32 calls pass through, so a float32 run may
    share the block (another thread's)."""
    saved = []

    def guard(fn, name):
        def refuse(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.dtype == torch.float64
                   for a in (*args, *kwargs.values())):
                raise AssertionError(f"float64 reached the kernel wrapper {name}")
            return fn(*args, **kwargs)
        return refuse

    try:
        for mod_name, attr in RAD_KERNEL_WRAPPERS:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, guard(fn, f"{mod_name}.{attr}"))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def port_sim_like(case, U0=None, device="cpu"):
    """The port's Simulation of a deck of tests/port/jax_multigroup.py's
    CASES with its initial conditions set, or started from the reference's
    initial state U0."""
    from jax_multigroup import CASES

    import quokka_tpu_torch
    import quokka_tpu_torch.problems  # noqa: F401  (registers the catalog)
    from quokka_tpu_torch.registry import get_problem

    problem, deck, overrides, v0 = CASES[case]
    if deck.endswith(".in"):
        with open(deck) as f:
            deck = f.read()
    pp = quokka_tpu_torch.ParmParse.from_string(deck, overrides)
    if problem == "RadhydroBenchMG":
        prob = port_bench_mg()
    else:
        prob = get_problem(problem)()
    if v0 is not None:
        prob.v0 = v0
    sim = quokka_tpu_torch.Simulation(prob, pp, device=device)
    sim.set_initial_conditions()
    if U0 is not None:
        sim.U = torch.as_tensor(U0, dtype=sim.dtype, device=device).contiguous()
    return sim


def step_like(sim, dt):
    """One step of `sim` at the reference's dt, as evolve() takes it."""
    assert sim.advance_single_step(dt)
    sim.t += dt
    sim.dt_prev = dt
    sim.istep += 1


def scaled_gaps(got, ref):
    """max |got - ref| / max |ref| per component."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)
    gap = np.abs(got - ref).reshape(ref.shape[0], -1).max(axis=1)
    return gap / np.where(scale > 0, scale, 1.0)


def port_bench_mg():
    """The port's twin of the 2-group RadhydroBench of tests/test_radhydro.py
    (`jax_multigroup.bench_mg_problem`): the single-group initial state
    split into 2 groups by the Planck fractions."""
    from quokka_tpu_torch.indices import EGAS, RHO
    from quokka_tpu_torch.problems.radhydro_bench import RadhydroBenchProblem
    from quokka_tpu_torch.radiation.planck import planck_energy_fractions
    from quokka_tpu_torch.registry import PhysicsTraits, RadTraits

    class MG(RadhydroBenchProblem):
        name = "RadhydroBenchMG"
        physics = PhysicsTraits(hydro_enabled=True, radiation_enabled=True, n_groups=2)
        rad = RadTraits(c_light=1.0e3, c_hat=1.0e2, radiation_constant=1.0,
                        Erad_floor=1e-10, beta_order=1, group_edges=(1e-3, 1.0, 1e3))

        def set_initial_conditions(self, grid, dtype=torch.float64, device="cuda"):
            U = super().set_initial_conditions(grid, torch.float64, device)
            layout = self.physics.layout()
            E_tot = U[layout.rad_index(0, 0)].clone()
            T = self.make_eos().tgas_from_eint(U[RHO], U[EGAS])
            fr = planck_energy_fractions(self.rad.group_edges, T, 1.0)
            U[layout.rad_index(0, 0)] = E_tot * fr[0]
            U[layout.rad_index(1, 0)] = E_tot * fr[1]
            return U.to(dtype)

    return MG()
