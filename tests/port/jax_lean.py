"""Run the JAX package's lean hydro path and save what tests/port/test_torch_lean.py
compares with the port.

The references run in processes of their own, beside the port's runs, with
XLA:CPU kept from contracting a*b + c into fused multiply-adds
(XLA_FLAGS=--xla_cpu_max_isa=AVX, set by the test): each operation then
rounds on its own, as each PyTorch operation of the port's plain versions
does, and the comparisons can hold the two to float32 roundoff.

    python tests/port/jax_lean.py OUT.npz CASE

CASE is one of
  kernels  K2c (`compute_axis_flux_pallas` with div_only, acc, fo_mask and
           fo_from) on every axis of a 16^3 box, periodic along x and walled
           along y and z, with its inputs;
  sedov    one lean step of Sedov 16^3 through `Simulation`;
  rough    one lean step of a rough 16^3 state whose two RK stages both
           fall back;
  corr     K2e: `compute_fluxes_pallas_div` with `corr_masks` (the AMR
           root's flux-register seed) on a periodic CORR_N^3 box, stage 1
           (fresh and with a FOFC mask) and stage 2 (onto stage 1's totals
           and seed, with a FOFC mask, with and without fo_from), with
           its inputs;
  box      one step of the rough BOX_SHAPE state, one axis above 272, which
           the JAX dispatch sends to the lean path by itself. Its sweeps run
           whole-axis (QUOKKA_PALLAS_SWEEP_CHUNK): the chunked ones give the
           same values bitwise (tests/test_lean_update.py::
           test_lean_sweep_chunked_bitwise) and take minutes to trace in
           interpret mode.
"""

import os
import sys

import numpy as np

N = 16
BOX_SHAPE = (280, 8, 8)
SEDOV_DECK = f"""
geometry.prob_hi = 1.2 1.2 1.2
amr.n_cell = {N} {N} {N}
cfl = 0.3
max_timesteps = 1
verbose = 0
precision = single
hydro.use_pallas = 1
fused_windows = 0
"""
# the K2c kernel inputs: x periodic, y and z reflecting walls
KERNEL_BC = {0: None, 1: ("reflect", "reflect"), 2: ("reflect", "reflect")}
# (name, fo_mask, acc, sweep U1 with fo_from = U0)
VARIANTS = (("clean", False, False, False), ("acc", False, True, False),
            ("fo_mask", True, False, False), ("fo_mask+acc+fo_from", True, True, True))


def rough_state(shape, seed):
    """Seeded conserved float32 state with a density/pressure well and
    strong shocks at the x walls and the hi z wall: its updates go invalid
    in both RK stages (the recipe of tests/test_ghostfree.py, on any box)."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.5 * rng.random(shape)
    vx = 0.3 * rng.standard_normal(shape)
    vy = 0.3 * rng.standard_normal(shape)
    vz = 0.3 * rng.standard_normal(shape)
    eint = 1.0 + rng.random(shape)
    nz = shape[2]
    rho[2, 2, 2] = 1e-4
    eint[2, 2, 2] = 1e-6
    vx[3, 2, 2] = 8.0
    vx[1, 2, 2] = -8.0
    eint[0, :, :] *= 30.0
    eint[1, :, :] *= 4.0
    vx[0, :, :] = 2.0
    vx[1, :, :] = -1.5
    eint[:, :, nz - 1] *= 25.0
    eint[:, :, nz - 2] *= 3.0
    vz[:, :, nz - 1] = -2.0
    vz[:, :, nz - 2] = 1.2
    ke = 0.5 * rho * (vx**2 + vy**2 + vz**2)
    return np.stack([rho, rho * vx, rho * vy, rho * vz, rho * eint + ke,
                     rho * eint]).astype(np.float32)


def smooth_state(shape, seed):
    """Seeded conserved float32 state without the well and the shocks."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.5 * rng.random(shape)
    v = 0.3 * rng.standard_normal((3,) + shape)
    eint = 1.0 + rng.random(shape)
    ke = 0.5 * rho * (v * v).sum(axis=0)
    return np.stack([rho, rho * v[0], rho * v[1], rho * v[2], rho * eint + ke,
                     rho * eint]).astype(np.float32)


def kernel_inputs():
    """The seeded K2c inputs: the stage-1 state U0, a stage-2 state U1, a
    0/1 mask flagging ~5% of the cells and every cell of three wall lines,
    and the running totals the `acc` variants add onto."""
    rng = np.random.default_rng(17)
    shape = (N, N, N)
    mask = (rng.random(shape) < 0.05).astype(np.float32)
    mask[:, 0, 5] = 1.0   # lo y wall
    mask[7, N - 1, :] = 1.0  # hi y wall
    mask[3, :, N - 1] = 1.0  # hi z wall
    return {"U0": rough_state(shape, 5), "U1": smooth_state(shape, 6), "mask": mask,
            "acc_div": rng.standard_normal((6,) + shape).astype(np.float32),
            "acc_dvel": rng.standard_normal(shape).astype(np.float32)}


CORR_N = 32
# (name, stage, fo_mask, fo_from = U0); stage 2 chains onto stage 1's
# ("s1") totals and seed
CORR_VARIANTS = (("s1", 1, False, False), ("s1_fo", 1, True, False),
                 ("s2", 2, False, False), ("s2_fo", 2, True, False),
                 ("s2_fo_from", 2, True, True))


def corr_inputs():
    """The seeded K2e inputs on a periodic CORR_N^3 box: U0 (rough), U1
    (smooth), a FOFC mask flagging ~3% of the cells, and the per-axis
    boundary-face masks of a covered block [n/4, 3n/4)^3 with a notch (a
    level's coverage on its parent, slot f the lo face of cell f)."""
    rng = np.random.default_rng(23)
    n = CORR_N
    shape = (n, n, n)
    cov = np.zeros(shape, bool)
    cov[n // 4:3 * n // 4, n // 4:3 * n // 4, n // 4:3 * n // 4] = True
    cov[n // 4:n // 2, n // 4:n // 2, n // 2:3 * n // 4] = False
    out = {"U0": rough_state(shape, 7), "U1": smooth_state(shape, 8),
           "mask": (rng.random(shape) < 0.03).astype(np.float32)}
    for d in range(3):
        out[f"bm{d}"] = (cov != np.roll(cov, 1, axis=d)).astype(np.float32)
    return out


def run_corr():
    import jax.numpy as jnp

    from quokka_tpu.hydro import pallas_sweep as jps

    inp = corr_inputs()
    shape = (CORR_N,) * 3
    jo = jax_opts(shape)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    bc = {0: None, 1: None, 2: None}
    bms = {d: j[f"bm{d}"] for d in range(3)}
    out = dict(inp)
    s1 = None
    for name, stage, masked, fo in CORR_VARIANTS:
        kw = {}
        if stage == 2:
            kw = dict(acc_init=(jnp.asarray(s1["div"]), jnp.asarray(s1["dvel"])),
                      corr_init=jnp.asarray(s1["corr"]))
        r = jps.compute_fluxes_pallas_div(
            j["U1" if stage == 2 else "U0"], jo, bc, accumulate=True, div_only=True,
            fo_mask=j["mask"] if masked else None, fo_from=j["U0"] if fo else None,
            corr_masks=bms, **kw)
        res = {k: np.asarray(r[k]) for k in ("div", "dvel", "corr")}
        if name == "s1":
            s1 = res
        for k, v in res.items():
            out[f"{name}/{k}"] = v
    return out


# the box: x (above 272) and z reflecting walls, y periodic
BOX_BC = {0: ("reflect", "reflect"), 1: None, 2: ("reflect", "reflect")}


def jax_opts(shape):
    from quokka_tpu.eos import IdealGasEOS
    from quokka_tpu.hydro import advance as jadv

    return jadv.HydroOptions(
        dx=tuple(1.0 / n for n in shape), eos=IdealGasEOS(gamma=1.4),
        active_axes=(0, 1, 2), reconstruction_order=3, use_pallas=True,
        reconstruct_eint=False)


def run_kernels():
    import jax.numpy as jnp

    from quokka_tpu.hydro import pallas_sweep as jps

    inp = kernel_inputs()
    jo = jax_opts((N, N, N))
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    out = dict(inp)
    k1 = {}
    for tag, U in (("0", j["U0"]), ("1", j["U1"])):
        dmins, chi, _ = jps.precompute_transverse_pallas(U, jo, KERNEL_BC, state_is_cons=True)
        k1[tag] = (dmins, chi)
        out[f"chi{tag}"] = np.asarray(chi)
        for t in range(3):
            out[f"dmin{tag}_{t}"] = np.asarray(dmins[t])
    for d in range(3):
        for name, masked, acc, stage2 in VARIANTS:
            dmins, chi = k1["1" if stage2 else "0"]
            res = jps.compute_axis_flux_pallas(
                j["U1" if stage2 else "U0"], d, jo, chi, dmins, bc_axis=KERNEL_BC[d],
                dx_axis=jo.dx[d], state_is_cons=True, div_only=True,
                acc=(j["acc_div"], j["acc_dvel"]) if acc else None,
                fo_mask=j["mask"] if masked else None,
                fo_from=j["U0"] if stage2 else None)
            out[f"{name}/{d}/div"], out[f"{name}/{d}/dvel"] = (np.asarray(r) for r in res)
    return out


def run_sedov():
    import quokka_tpu
    from quokka_tpu.problems.sedov import SedovProblem

    sim = quokka_tpu.Simulation(SedovProblem(), quokka_tpu.ParmParse.from_string(SEDOV_DECK))
    sim.set_initial_conditions()
    out = {"sedov_U0": np.asarray(sim.U)}
    dt = sim.compute_timestep()
    assert sim.advance_single_step(dt)
    out.update(sedov_dt=dt, sedov_U1=np.asarray(sim.U))
    return out


def run_rough():
    import jax.numpy as jnp

    from quokka_tpu.hydro import advance as jadv

    shape = (N, N, N)
    U = rough_state(shape, 3)
    bc = KERNEL_BC
    Un, st = jadv.advance_hydro_rk2(jnp.asarray(U), 0.2 / N, jax_opts(shape), lambda X: X,
                                    (0, 0, 0), tuple(bc[d] is None for d in range(3)),
                                    bc_kinds=bc)
    return {"rough_U0": U, "rough_U1": np.asarray(Un), "rough_n_fofc": int(st["n_fofc"])}


def run_box():
    import jax.numpy as jnp

    from quokka_tpu.hydro import advance as jadv

    U = rough_state(BOX_SHAPE, 3)
    bc = BOX_BC
    Un, st = jadv.advance_hydro_rk2(jnp.asarray(U), 0.2 / BOX_SHAPE[0], jax_opts(BOX_SHAPE),
                                    lambda X: X, (0, 0, 0),
                                    tuple(bc[d] is None for d in range(3)), bc_kinds=bc)
    return {"box_U0": U, "box_U1": np.asarray(Un), "box_n_fofc": int(st["n_fofc"])}


def main(out, case):
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.environ["QUOKKA_PALLAS_LEAN"] = "1" if case != "box" else "auto"
    res = {"kernels": run_kernels, "sedov": run_sedov, "rough": run_rough,
           "box": run_box, "corr": run_corr}[case]()
    # written whole, then renamed: a reader never sees a partial file
    part = f"{out}.part.npz"
    np.savez(part, **res)
    os.replace(part, out)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("QUOKKA_PALLAS_SWEEP_CHUNK", "4096")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main(*sys.argv[1:3])
