"""Run the JAX package's ghost-free hydro on outflow, mixed and user walls
and save what tests/port/test_torch_wall_slice.py compares with the port.

The references run in processes of their own, beside the port's runs, with
XLA:CPU kept from contracting a*b + c into fused multiply-adds
(XLA_FLAGS=--xla_cpu_max_isa=AVX, set by the test), the Pallas kernels
interpreted as the JAX package's own tests run them on the CPU.

    python tests/port/jax_walls.py OUT.npz CASE

CASE is one of
  fused_WALLS  one f32 RK2 step of a rough N^3 state on the WALLS walls
               (`outflow_all` or `mixed`, tests/test_ghostfree.py:75-95)
               through `advance_hydro_rk2` with `bc_kinds` (the fused path);
  lean_WALLS   the same with QUOKKA_PALLAS_LEAN=1 (the lean path);
  hybrid  one step with a user (Dirichlet) x-lo wall padded by (4, 0, 0),
          y periodic and z reflecting walls assembled in the kernels
          (tests/test_ghostfree.py `test_hybrid_user_bc_axis_matches_padded`);
  lean_hybrid  the same with QUOKKA_PALLAS_LEAN=1;
  cloud   ShockCloud 16^3 f32 through `Simulation` with hydro.use_pallas =
          1: the initial state, then the state and dt of each of STEPS steps;
  rm3d    Richtmyer-Meshkov on a 16^3 grid, likewise.
"""

import os
import sys

import numpy as np

N = 8
STEPS = 3
WALLS = {
    "outflow_all": {0: ("outflow", "outflow"), 1: ("outflow", "outflow"),
                    2: ("outflow", "outflow")},
    "mixed": {0: None, 1: ("reflect", "outflow"), 2: ("outflow", "reflect")},
}
SIM_DECK = """
geometry.prob_hi = 1.0 1.0 1.0
amr.n_cell = 16 16 16
cfl = 0.3
stop_time = 10.0
precision = single
verbose = 0
fused_windows = 0
hydro.use_pallas = 1
"""
HYBRID_BCS = dict(x=("user", "outflow"), y=("periodic", "periodic"), z=("reflect", "reflect"))
# the user wall's constant state: rho, vx, specific internal energy
HYBRID_INFLOW = (1.3, 1.7, 2.0)


def rough_state(n, seed=3):
    """The rough conserved f32 state of tests/port/torch_port_common.py's
    `make_state(rough=True)`: a density/pressure well and shocks at the x
    walls and the hi z wall, so that FOFC fires next to the walls."""
    rng = np.random.default_rng(seed)
    shape = (n, n, n)
    rho = 1.0 + 0.5 * rng.random(shape)
    vx = 0.3 * rng.standard_normal(shape)
    vy = 0.3 * rng.standard_normal(shape)
    vz = 0.3 * rng.standard_normal(shape)
    eint = 1.0 + rng.random(shape)
    rho[2, 2, 2] = 1e-4
    eint[2, 2, 2] = 1e-6
    vx[3, 2, 2] = 8.0
    vx[1, 2, 2] = -8.0
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
                     rho * eint]).astype(np.float32)


def _opts(n):
    from quokka_tpu.eos import IdealGasEOS
    from quokka_tpu.hydro import advance as jadv

    return jadv.HydroOptions(
        dx=(1.0 / n,) * 3, eos=IdealGasEOS(gamma=1.4), active_axes=(0, 1, 2),
        reconstruction_order=3, use_pallas=True, reconstruct_eint=False)


def step(lean: bool, walls: str) -> dict:
    import jax.numpy as jnp

    from quokka_tpu.hydro import advance as jadv

    if lean:
        os.environ["QUOKKA_PALLAS_LEAN"] = "1"
    U = rough_state(N)
    bc = WALLS[walls]
    periodic = tuple(bc[d] is None for d in range(3))
    U1, st = jadv.advance_hydro_rk2(jnp.asarray(U), 0.2 / N, _opts(N), lambda X: X,
                                    (0, 0, 0), periodic, bc_kinds=bc)
    return {"U0": U, "U": np.asarray(U1), "n_fofc": np.asarray(int(st["n_fofc"]))}


def hybrid(lean: bool) -> dict:
    import jax.numpy as jnp

    from quokka_tpu.boundaries import fill_ghosts
    from quokka_tpu.hydro import advance as jadv
    from quokka_tpu.indices import StateLayout
    from quokka_tpu.registry import BCSpec

    class Hook:
        def fill_user_boundary(self, Ug, grid, ng, time, d, side):
            rho, vx, e = HYBRID_INFLOW
            vals = jnp.asarray([rho, rho * vx, 0.0, 0.0, rho * e + 0.5 * rho * vx * vx,
                                rho * e], Ug.dtype)
            return Ug.at[:, :ng[0]].set(vals[:, None, None, None])

    if lean:
        os.environ["QUOKKA_PALLAS_LEAN"] = "1"
    layout = StateLayout(hydro_enabled=True, radiation_enabled=False)
    bcs = BCSpec(**HYBRID_BCS)
    U = rough_state(N, seed=5)
    fill_x = lambda X: fill_ghosts(X, (4, 0, 0), bcs, layout, problem=Hook(), grid=None)  # noqa
    U1, st = jadv.advance_hydro_rk2(jnp.asarray(U), 0.2 / N, _opts(N), fill_x, (4, 0, 0),
                                    (False, True, False),
                                    bc_kinds={0: None, 1: None, 2: ("reflect", "reflect")})
    return {"U0": U, "U": np.asarray(U1), "n_fofc": np.asarray(int(st["n_fofc"]))}


def sim_run(problem) -> dict:
    import quokka_tpu

    sim = quokka_tpu.Simulation(problem, quokka_tpu.ParmParse.from_string(SIM_DECK))
    sim.set_initial_conditions()
    out = {"U0": np.asarray(sim.U)}
    for k in range(STEPS):
        dt = sim.compute_timestep()
        assert sim.advance_single_step(dt)
        sim.t += dt
        sim.dt_prev = dt
        sim.istep += 1
        out[f"U{k + 1}"] = np.asarray(sim.U)
        out[f"dt{k + 1}"] = np.asarray(dt)
    return out


def main():
    out_path, case = sys.argv[1], sys.argv[2]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    form, _, walls = case.partition("_")
    if form in ("fused", "lean") and walls in WALLS:
        out = step(form == "lean", walls)
    elif case in ("hybrid", "lean_hybrid"):
        out = hybrid(case == "lean_hybrid")
    elif case == "cloud":
        from quokka_tpu.problems.shock_cloud import ShockCloudProblem

        out = sim_run(ShockCloudProblem())
    elif case == "rm3d":
        from quokka_tpu.problems.hydro_suite import RichtmeyerMeshkovProblem

        out = sim_run(RichtmeyerMeshkovProblem())
    else:
        raise SystemExit(f"unknown case {case!r}")
    tmp = out_path + ".tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, out_path)


if __name__ == "__main__":
    main()
