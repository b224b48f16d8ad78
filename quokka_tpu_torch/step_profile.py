"""Where the time of a 256^3 step goes on the card, kernel by kernel.

For the Sedov deck (``decks/benchmark_unigrid_256.in``) and for
RadhydroBench (``problems/radhydro_bench.py:DECK_256``) in both radiation
configurations (A: ``radiation.fused_substep = 1``, B: ``= 0``), after one
warm-up step, three parts of a step are each run ``--steps`` times:

- the whole step as ``Simulation.evolve()`` runs it (``compute_timestep`` +
  ``advance_single_step``);
- its hydro half (``Simulation._step`` and the read-back of the validity
  flags that ``advance_single_step`` makes);
- its radiation subcycle (``RadiationAdvance.subcycle``).

For Orszag-Tang MHD (``problems/mhd.py:DECK_256``, f32) the parts are a
step of the windowed loop that ``MHDSimulation.evolve()`` runs with
``verbose = 0``, timed as one window of ``MHD_WINDOW`` (16) steps, the
length of the main path's first window, and reported per step (the CFL dt
on the device, the RK2 step, the masks; the window's dts read back once),
and one right-hand side (three K8 launches and the constrained-transport
glue: primitives, cell field, corner EMFs, curl).

Each part is timed twice from the same state, so both timings do the same
work: on the host clock between two device
synchronizations, and under ``torch.profiler``, whose device events give
the time of every kernel, summed here by kernel of the port (K1-K6, K8),
"plain torch" for PyTorch's own kernels and "copies" for memcpy/memset. The
device's idle share of a part is 1 - (device time) / (unprofiled wall
time); kernels run on one stream, so their times do not overlap.

Run from the repository root on a CUDA machine:

    python3 -m quokka_tpu_torch.step_profile [--steps 3]

The last line of the output is one JSON object with every number printed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
SEDOV_DECK = ROOT / "decks" / "benchmark_unigrid_256.in"

# substring of a CUDA kernel's name -> the port's kernel (radiation names
# first: "rad_div_kernel" also contains "div_kernel")
KERNEL_OF = (
    ("mhd_axis_kernel", "K8"),
    ("rad_stage1_kernel", "K4 stage 1"), ("rad_stage2_kernel", "K4 stage 2"),
    ("rad_source_kernel", "K5"), ("rad_div_kernel", "K6"),
    ("transverse_kernel", "K1"), ("face_kernel", "K2 faces"),
    ("div_kernel", "K2 divergence"), ("apply_kernel", "K3"),
)
PLAIN = "plain torch"
MHD_WINDOW = 16  # steps of a window of MHDSimulation's main path
COPIES = "copies"


def kernel_of(name: str) -> str:
    for key, kernel in KERNEL_OF:
        if key in name:
            return kernel
    if name.startswith(("Memcpy", "Memset")):
        return COPIES
    return PLAIN


def _sync():
    torch.cuda.synchronize()


def wall_ms(fn, reps: int) -> float:
    """Mean host-clock milliseconds of `fn`, synchronized before and after."""
    _sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync()
    return (time.perf_counter() - t0) / reps * 1e3


def device_ms(fn, reps: int):
    """({kernel: mean device ms per call}, [(name, ms) of the five longest
    plain-torch kernels]) of `fn` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        _sync()
    by_kernel, plain = defaultdict(float), defaultdict(float)
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.time_range.elapsed_us() / 1e3 / reps
        kernel = kernel_of(evt.name)
        by_kernel[kernel] += ms
        if kernel == PLAIN:
            plain[evt.name] += ms
    top = sorted(plain.items(), key=lambda kv: -kv[1])[:5]
    return dict(by_kernel), top


def _parts(sim):
    """{part name: callable} of one step of `sim` (see the module doc)."""

    def step():
        dt = sim.compute_timestep()
        if not sim.advance_single_step(dt):
            raise RuntimeError("the step failed its retries")
        sim.t += dt
        sim.dt_prev = dt
        sim.istep += 1

    def hydro():
        _, stats = sim._step(sim.U, sim.dt_prev)
        torch.stack([stats["valid"].double(), stats["max_signal"].double(),
                     stats["n_fofc"].double()]).tolist()

    parts = {"step": step, "hydro half": hydro}
    if sim._radiation is not None:
        parts["radiation subcycle"] = lambda: sim._radiation.subcycle(
            sim.U, sim.t, sim.dt_prev)
    return parts


_STEP_FIELDS = ("t", "dt_prev", "istep", "cell_updates", "fofc_cells", "fofc_fallbacks")


def _restorer(sim):
    """A callable that puts `sim` back to its present state, so that every
    timing of a part does the same work on the same data."""
    U0 = sim.U.clone()
    fields = {f: getattr(sim, f) for f in _STEP_FIELDS}

    def restore():
        sim.U = U0.clone()
        for f, v in fields.items():
            setattr(sim, f, v)

    return restore


def _mhd_parts(sim):
    """{part name: callable} of one MHD step (see the module doc)."""
    from .mhd.advance import mhd_rhs

    return {"step": lambda: sim._window(MHD_WINDOW),
            "rhs": lambda: mhd_rhs(sim.U, sim.Bf, sim.opts)}


# steps a call of each MHD part runs (its times are reported per step)
_MHD_STEPS = {"step": MHD_WINDOW}


def _mhd_restorer(sim):
    """`_restorer` for an MHDSimulation."""
    U0, B0, dts = sim.U.clone(), [b.clone() for b in sim.Bf], list(sim.dts)
    fields = {f: getattr(sim, f) for f in ("t", "istep", "cell_updates")}

    def restore():
        sim.U, sim.Bf, sim.dts = U0.clone(), [b.clone() for b in B0], list(dts)
        for f, v in fields.items():
            setattr(sim, f, v)

    return restore


def profile_case(title: str, make_sim, reps: int, parts_of=_parts,
                 restorer_of=_restorer, steps_of=None) -> dict:
    sim = make_sim()
    sim.set_initial_conditions()
    sim.evolve()  # one warm-up step (max_timesteps = 1)
    print(f"\n== {title}", flush=True)
    if getattr(sim, "_radiation", None) is not None:
        print(f"radiation substeps a step: {sim._radiation.n_substeps(sim.dt_prev)}")
    restore = restorer_of(sim)
    out = {}
    for part, fn in parts_of(sim).items():
        per = (steps_of or {}).get(part, 1)
        restore()
        wall = wall_ms(fn, reps) / per
        restore()
        by_kernel, top = device_ms(fn, reps)
        by_kernel = {k: v / per for k, v in by_kernel.items()}
        top = [(name, ms / per) for name, ms in top]
        busy = sum(by_kernel.values())
        out[part] = {"wall_ms": wall, "device_ms": busy, "idle_share": 1.0 - busy / wall,
                     "by_kernel": by_kernel, "top_plain": top}
        kernels = ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_kernel.items()))
        print(f"{part}: wall {wall:.3f} ms, device {busy:.3f} ms, idle share "
              f"{1.0 - busy / wall:.3f}; by kernel (ms): {kernels}")
        print("  longest plain-torch kernels (ms): "
              + "; ".join(f"{name[:70]} {ms:.3f}" for name, ms in top), flush=True)
    del sim
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3, help="repetitions of each part")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_profile needs a CUDA device")

    from . import MHDSimulation, ParmParse, Simulation, _cuda
    from .problems import mhd
    from .problems.radhydro_bench import DECK_256, RadhydroBenchProblem
    from .problems.sedov import SedovProblem

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}")
    _cuda.library()

    def sedov():
        pp = ParmParse.from_file(str(SEDOV_DECK), overrides=["max_timesteps=1", "verbose=0"])
        return Simulation(SedovProblem(), pp, device="cuda")

    def radhydro(fused):
        return lambda: Simulation(
            RadhydroBenchProblem(),
            ParmParse.from_string(DECK_256, ["max_timesteps=1", "verbose=0",
                                             f"radiation.fused_substep={fused}"]),
            device="cuda", precision="single")

    result = {"card": smi, "steps": args.steps}
    for title, make in (("Sedov 256^3 f32", sedov),
                        ("RadhydroBench 256^3 f32, config A (fused substep, K4)", radhydro(1)),
                        ("RadhydroBench 256^3 f32, config B (per stage, K5 + K6)",
                         radhydro(0))):
        result[title] = profile_case(title, make, args.steps)
    title = "Orszag-Tang MHD 256^3 f32 (K8)"
    result[title] = profile_case(
        title, lambda: MHDSimulation(mhd.OrszagTangProblem(), ParmParse.from_string(
            mhd.DECK_256, ["max_timesteps=1"]), precision="single"),
        args.steps, _mhd_parts, _mhd_restorer, _MHD_STEPS)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
