"""Run the JAX package's multigroup problems for a few steps and save every
step's state and dt.

A reference of tests/port/test_torch_multigroup.py and
test_torch_multigroup_slice.py, in a process of its own so that it runs
beside the port's side; float64 cases run without fused multiply-adds
(XLA_FLAGS=--xla_cpu_max_isa=AVX, set by `jax_ref.SharedJaxRun`; why:
jax_amr_shell.py).

    python tests/port/jax_multigroup.py OUT.npz CASE

CASE names a deck (`CASES`), or `coupling_<model>` the coupling alone on
tests/test_radiation_ppl.py's state (`couplings`): the RadMultigroupPulse deck
(decks/rad_multigroup_ppl.in) at 16^3 in each opacity model, in float64
and in float32 with the Pallas kernels interpreted (`radiation.use_pallas
= 1`: K6 over the 4 groups); the 2-group RadhydroBench of
tests/test_radhydro.py; the 1D pulses and RadhydroBB on the JAX tests'
decks. OUT.npz holds U0 (the initial state), U1, U2, ... and dts.

The JAX package's float32 PPL coupling promotes its state to float64 under
jax_enable_x64 (`multigroup.make_opacity_model_fns` turns the group-edge
ratios into a float64 array), which its `lax.while_loop` refuses; the
float32 PPL cases hand it the ratios as a float32 array, the values a
float32 run without x64 would use (`f32_ratios`).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

MG_DECK = "decks/rad_multigroup_ppl.in"
PULSE_DECK = """
geometry.prob_lo = -512.0 0.0 0.0
geometry.prob_hi = 512.0 1.0 1.0
amr.n_cell = 64 1 1
cfl = 0.8
radiation.cfl = 0.8
radiation.opacity_model = {model}
stop_time = 1.0
max_timesteps = {steps}
verbose = 0
"""
BB_DECK = """
geometry.prob_lo = 0.0 0.0 0.0
geometry.prob_hi = 64.0 1.0 1.0
amr.n_cell = 32 1 1
cfl = 0.8
radiation.cfl = 8.0
radiation.opacity_model = piecewise_constant
radiation.reconstruction_order = 3
max_dt = 1.0
stop_time = 1.0e-5
max_timesteps = {steps}
verbose = 0
"""
BENCH_MG_DECK = """
geometry.prob_hi = 1. 1. 1.
amr.n_cell = 16 16 16
cfl = 0.3
radiation.cfl = 0.3
stop_time = 1.0
max_timesteps = 4
verbose = 0
"""
F32 = ["precision = single", "radiation.use_pallas = 1", "fused_windows = 0"]
MODELS = ("piecewise_constant", "ppl_fixed_slope", "ppl_full_spectrum")
PULSE_STEPS = 3

# case -> (problem name, deck text or file, overrides, v0 or None)
CASES = {}
for _m in MODELS:
    CASES[f"mg_{_m}_f64"] = ("RadMultigroupPulse", MG_DECK,
                             [f"radiation.opacity_model = {_m}", "verbose = 0"], None)
    CASES[f"mg_{_m}_f32"] = ("RadMultigroupPulse", MG_DECK,
                             [f"radiation.opacity_model = {_m}", "verbose = 0"] + F32, None)
CASES["pulse_grey"] = ("RadhydroPulse", PULSE_DECK.format(model="piecewise_constant",
                                                          steps=PULSE_STEPS), [], 1.0e6)
CASES["pulse_mgconst"] = ("RadhydroPulseMGconst", PULSE_DECK.format(
    model="piecewise_constant", steps=PULSE_STEPS), [], 1.0e6)
CASES["pulse_mgint"] = ("RadhydroPulseMGint", PULSE_DECK.format(
    model="ppl_fixed_slope", steps=PULSE_STEPS), [], 1.0e6)
CASES["bb"] = ("RadhydroBB", BB_DECK.format(steps=PULSE_STEPS), [], None)
CASES["bench_mg"] = ("RadhydroBenchMG", BENCH_MG_DECK, [], None)
# the coupling alone, `coupling_<model>`: see `couplings`
COUPLING_DT = 1.0e-3


def bench_mg_problem():
    """The 2-group RadhydroBench of tests/test_radhydro.py::
    test_multigroup_radhydro_smoke."""
    import jax.numpy as jnp

    from quokka_tpu.indices import EGAS, RHO
    from quokka_tpu.problems.radhydro_bench import RadhydroBenchProblem
    from quokka_tpu.radiation.planck import planck_energy_fractions
    from quokka_tpu.registry import PhysicsTraits, RadTraits

    class MG(RadhydroBenchProblem):
        name = "RadhydroBenchMG"
        physics = PhysicsTraits(hydro_enabled=True, radiation_enabled=True, n_groups=2)
        rad = RadTraits(c_light=1.0e3, c_hat=1.0e2, radiation_constant=1.0,
                        Erad_floor=1e-10, beta_order=1, group_edges=(1e-3, 1.0, 1e3))

        def set_initial_conditions(self, grid):
            U = super().set_initial_conditions(grid)
            layout = self.physics.layout()
            E_tot = U[layout.rad_index(0, 0)]
            T = self.make_eos().tgas_from_eint(U[RHO], U[EGAS])
            fr = planck_energy_fractions(self.rad.group_edges, T, 1.0)
            U = U.at[layout.rad_index(0, 0)].set(E_tot * fr[0])
            return U.at[layout.rad_index(1, 0)].set(E_tot * fr[1])

    return MG()


def knocked_state(U):
    """`tests/test_radiation_ppl.py`'s `_coupling_setup` state U [7 + 4G, 4,
    4, 4] (rad_start 7) knocked out of equilibrium: the gas 30% hotter and
    moving, each group's E off by up to 20% with a flux of up to 0.3 c E."""
    import numpy as np

    rng = np.random.default_rng(3)
    U = np.array(U)
    U[4] *= 1.3
    U[5] *= 1.3
    U[1:4] = 0.1 * rng.standard_normal(U[1:4].shape)
    U[4] += 0.5 * (U[1:4] ** 2).sum(axis=0) / U[0]
    for i in range(7, U.shape[0], 4):
        U[i] *= 1.0 + 0.2 * rng.random(U[i].shape)
        U[i + 1:i + 4] = 0.1 * 1e3 * U[i] * rng.standard_normal(U[i + 1:i + 4].shape)
    return U


def couplings(out, model):
    """The JAX package's multigroup coupling on `_coupling_setup`'s state of
    `model` with a nu^-1 opacity spectrum for the PPL models (kappa = 20 at
    each group's lower edge): "U_both", the equilibrium state beside its
    knocked twin along x, through stage 1 in float64 with the work term on
    ("f64_work1") and off ("f64_work0"); "U_knocked" through stage 2 in
    float32 with the work term ("f32")."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    from test_radiation_ppl import _coupling_setup

    from quokka_tpu.radiation.multigroup import add_source_terms_multi_group

    jprob, eos, opts, U, edges = _coupling_setup(model)

    class Nu1(type(jprob)):
        def define_opacity_exponents_and_lower_values(self, boundaries, rho, T):
            k = 20.0 * jnp.ones((len(boundaries) - 1, *rho.shape), rho.dtype)
            return jnp.full_like(k, -1.0), k

    prob = Nu1()
    U = np.asarray(U)
    knocked = knocked_state(U)
    both = np.concatenate([U, knocked], axis=1)
    res = {"U_both": both, "U_knocked": knocked}
    G = opts.n_groups
    def coupled(U, dt, stage, o):
        # one jitted program: eager dispatch of the loops' set-up compiles
        # each operation on its own, several times slower
        return jax.jit(lambda U, src, dt: add_source_terms_multi_group(
            U, src, dt, stage, o, eos, prob, 7, edges, 1.0)[0])(
                jnp.asarray(U), jnp.zeros((G, *U.shape[1:]), U.dtype), dt)

    for work in (1, 0):
        o = dataclasses.replace(opts, include_work_term=bool(work))
        res[f"f64_work{work}"] = np.asarray(coupled(both, COUPLING_DT, 1, o))
    f32_ratios()
    res["f32"] = np.asarray(coupled(knocked.astype(np.float32), np.float32(COUPLING_DT), 2,
                                    opts))
    part = f"{out}.part.npz"
    np.savez(part, **res)
    os.replace(part, out)


def f32_ratios():
    import numpy as np

    from quokka_tpu.radiation import opacity

    ratios = opacity.boundary_ratios
    opacity.boundary_ratios = lambda b: np.asarray(ratios(b), np.float32)


def main(out, case):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import quokka_tpu.problems  # noqa: F401  (registers the catalog)
    from quokka_tpu import ParmParse, Simulation
    from quokka_tpu.registry import get_problem

    if case.startswith("coupling_"):
        return couplings(out, case[len("coupling_"):])
    problem, deck, overrides, v0 = CASES[case]
    if case.endswith("_f32"):
        f32_ratios()
    if deck.endswith(".in"):
        with open(deck) as f:
            deck = f.read()
    pp = ParmParse.from_string(deck, overrides)
    prob = bench_mg_problem() if problem == "RadhydroBenchMG" else get_problem(problem)()
    if v0 is not None:
        prob.v0 = v0
    sim = Simulation(prob, pp)
    sim.set_initial_conditions()
    states = {"U0": np.asarray(sim.U)}
    dts = []
    while sim.istep < sim.max_timesteps:
        dt = sim.compute_timestep()
        assert sim.advance_single_step(dt)
        sim.t += dt
        sim.dt_prev = dt
        sim.istep += 1
        dts.append(dt)
        states[f"U{sim.istep}"] = np.asarray(sim.U)
    # written whole, then renamed: a reader never sees a partial file
    part = f"{out}.part.npz"
    np.savez(part, dts=np.asarray(dts), **states)
    os.replace(part, out)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main(*sys.argv[1:3])
