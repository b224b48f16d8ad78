"""Where the port's float32 multigroup run parts from the JAX package's:
matter couplings on the same float32 input, with the Newton iteration count
of every cell on each side.

    python tests/port/mg_f32_gap.py [--calls N] [MODEL ...]

For each opacity model (default: all three) it builds RadMultigroupPulse
16^3 (decks/rad_multigroup_ppl.in) in float32 as
tests/port/test_torch_multigroup_slice.py does, runs the port's first step,
and hands the input (state, dt, stage) of each of its first N matter
couplings (default 20, the step's) to the port's
`add_source_terms_multi_group` and to the JAX package's (run without fused
multiply-adds, as the test's reference is).

A cell's Newton iteration count is the least cap k (0 to 8) on the loop,
`MAX_NEWTON_ITER`, under which the cell's output equals the uncapped one: a
converged cell is frozen, so under cap k a cell that converges after c
iterations takes min(c, k) of them. Each side's cap is its module's
constant, set here for the run and put back.

Prints for each coupling the cells whose counts differ and the largest
gap, as a fraction of its component's max, over the cells whose counts
agree and over those whose counts differ. For the coupling with the largest
gap, per component: the port against JAX over every cell, over the cells
whose counts agree and over those whose counts differ; the worst cells of
its component with both counts; the port against JAX with pow, log, exp and
expm1 rounded in float32 (`_numerics._via_f64` bypassed); and each side
against the port's float64 coupling on the same input. About two minutes a
model on one core.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = "--xla_cpu_max_isa=AVX"
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT, HERE]
os.chdir(ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax_multigroup as jm  # noqa: E402
from torch_port_common import port_sim_like, scaled_gaps  # noqa: E402

CAPS = range(9)


def couplings(case, n):
    """(port sim, [args of each of its first n multigroup couplings])."""
    import quokka_tpu_torch.radiation.advance as padv

    seen = []
    orig = padv.add_source_terms_multi_group

    class Seen(Exception):
        pass

    def grab(*args):
        seen.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        if len(seen) == n:
            raise Seen
        return orig(*args)

    sim = port_sim_like(case)
    padv.add_source_terms_multi_group = grab
    try:
        while sim.istep < sim.max_timesteps:
            sim.advance_single_step(sim.compute_timestep())
            sim.istep += 1
    except Seen:
        pass
    finally:
        padv.add_source_terms_multi_group = orig
    return sim, seen


def jax_side(case):
    """coupling(U, dt, stage, rad_start) -> output, of the JAX package for
    `case`; one program for each (cap, stage, rad_start)."""
    jm.f32_ratios()
    import quokka_tpu.problems  # noqa: F401  (registers the catalog)
    from quokka_tpu import ParmParse, Simulation
    from quokka_tpu.radiation import multigroup
    from quokka_tpu.radiation.advance import RadiationAdvance
    from quokka_tpu.registry import get_problem

    problem, deck, overrides, _ = jm.CASES[case]
    with open(deck) as f:
        pp = ParmParse.from_string(f.read(), overrides)
    sim = Simulation(get_problem(problem)(), pp)
    rad = RadiationAdvance(sim)
    kB = sim.problem.eos_traits.boltzmann_constant
    programs = {}

    def coupling(U, dt, stage, rad_start):
        key = (multigroup.MAX_NEWTON_ITER, stage, rad_start)
        if key not in programs:
            programs[key] = jax.jit(lambda U, s, dt: multigroup.add_source_terms_multi_group(
                U, s, dt, stage, rad.opts, sim.eos, sim.problem, rad_start, rad.boundaries,
                kB)[0])
        src = jnp.zeros((rad.opts.n_groups, *U.shape[1:]), jnp.float32)
        return np.asarray(programs[key](jnp.asarray(U), src, jnp.float32(dt)))

    return coupling


def capped(module, fn):
    """[output under each cap of CAPS, uncapped output]."""
    full = module.MAX_NEWTON_ITER
    outs = []
    try:
        for k in CAPS:
            module.MAX_NEWTON_ITER = k
            outs.append(fn())
    finally:
        module.MAX_NEWTON_ITER = full
    return outs + [fn()]


def counts_of(outs):
    """Per cell, the least cap whose output equals the uncapped one."""
    full = outs[-1]
    count = np.full(full.shape[1:], -1)
    for k, o in zip(CAPS, outs[:-1]):
        same = np.all(o == full, axis=0) & (count < 0)
        count[same] = k
    return count


def line(name, gaps):
    print(f"  {name:34s}" + " ".join(f"{g:.1e}" for g in gaps))


def compare(jcoup, args):
    """(port output, JAX output, port counts, JAX counts, gaps [nvar, X, Y,
    Z]) of one coupling."""
    from quokka_tpu.radiation import multigroup as jmg_mod

    from quokka_tpu_torch.radiation import multigroup as pmg_mod

    U, src, dt, stage, *rest = args
    rad_start = rest[3]  # (opts, eos, problem, rad_start, boundaries, kB)
    p_outs = capped(pmg_mod, lambda: port(args))
    j_outs = capped(jmg_mod, lambda: jcoup(U.numpy(), dt, stage, rad_start))
    P, J = p_outs[-1], j_outs[-1]
    scale = np.abs(J).reshape(len(J), -1).max(axis=1)
    scale = np.where(scale > 0, scale, 1.0)
    gaps = np.abs(P.astype(np.float64) - J) / scale[:, None, None, None]
    return P, J, counts_of(p_outs), counts_of(j_outs), gaps


def port(args, dtype=None):
    from quokka_tpu_torch.radiation import multigroup as pmg_mod

    U, src, dt, stage, *rest = args
    if dtype is not None:
        U = U.to(dtype)
        src = None if src is None else src.to(dtype)
    return pmg_mod.add_source_terms_multi_group(U, src, dt, stage, *rest)[0].numpy()


def worst(gaps, where):
    return float(np.where(where, gaps, 0.0).max())


def main(models, n):
    from quokka_tpu_torch import _numerics

    torch.set_num_threads(1)
    for model in models:
        case = f"mg_{model}_f32"
        _, calls = couplings(case, n)
        jcoup = jax_side(case)
        print(f"{model}: the first {len(calls)} couplings")
        results = []
        for i, args in enumerate(calls):
            P, J, cp, cj, gaps = compare(jcoup, args)
            differ = (cp != cj)[None]
            results.append((gaps.max(), i, P, J, cp, cj, gaps))
            print(f"  coupling {i:2d} (stage {args[3]}): counts differ in "
                  f"{int(differ.sum()):3d} of {differ.size} cells; largest gap where "
                  f"they agree {worst(gaps, ~differ):.1e}, where they differ "
                  f"{worst(gaps, differ):.1e}")
        _, i, P, J, cp, cj, gaps = max(results, key=lambda r: r[0])
        differ = cp != cj
        args = calls[i]
        print(f"  coupling {i}, per component (max over cells, of the component's max):")
        line("port vs JAX", gaps.reshape(len(gaps), -1).max(axis=1))
        line("  cells whose counts agree", np.where(
            ~differ, gaps, 0.0).reshape(len(gaps), -1).max(axis=1))
        line("  cells whose counts differ", np.where(
            differ, gaps, 0.0).reshape(len(gaps), -1).max(axis=1))
        comp = int(np.argmax(gaps.reshape(len(gaps), -1).max(axis=1)))
        for k in np.argsort(gaps[comp].ravel())[::-1][:5]:
            c = np.unravel_index(k, cp.shape)
            print(f"  component {comp}, cell {tuple(int(j) for j in c)}: "
                  f"{gaps[comp][c]:.2e} of max, Newton iterations port {cp[c]}, "
                  f"JAX {cj[c]}")
        keep = _numerics._via_f64
        _numerics._via_f64 = lambda fn, *a: fn(*a)
        try:
            line("port (float32 pow/log/exp) vs JAX", scaled_gaps(port(args), J))
        finally:
            _numerics._via_f64 = keep
        P64 = port(args, torch.float64)
        line("port vs port float64", scaled_gaps(P, P64))
        line("JAX vs port float64", scaled_gaps(J, P64))


if __name__ == "__main__":
    argv = sys.argv[1:]
    calls = 20
    if argv[:1] == ["--calls"]:
        calls, argv = int(argv[1]), argv[2:]
    main(argv or jm.MODELS, calls)
