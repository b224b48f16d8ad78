"""Where the time of a step goes on the card, kernel by kernel.

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

For Sedov 512^3 (``problems/sedov.py:DECK_512``, f32), whose steps take the
lean branch (K1 + K2c), the same two parts, the hydro half's device time
by RK stage (the lean step's profiler regions), and the wall time, device
time and peak memory of one lean step and of one step of the fused form
called directly on the same state (`profile_lean`).

For the dense AMR radhydro shell (``problems/radhydro_shell.py:DECK_256``,
256^3 + one level, f32), after two warm-up coarse steps, one coarse step
(it opens with the regrid of level 1) is timed, with its device time by
kernel and by the profiler regions `AMRSimulation` names as the JAX package
names them (``regrid_L0``, ``hydro_L0``, ``rad_L0``, ``hydro_L1``,
``rad_L1``, ``reflux_L0``, ``avgdown_L0``), and its idle share.

For the packed shell (``DECK_256_PACKED``, 256^3 + 2 packed pool levels,
f32, chunks of ``CARD_PACKED_CHUNK`` tiles; ``--packed``), after one
warm-up coarse step, one coarse step (it
opens with the regrid of level 1) runs once under the profiler: its wall
time by region (a device sync at each region's exit) and its device time
by kernel and by region, the regions of the dense shell and ``hydro_L2``,
``rad_L2``, ``regrid_L1``, ``reflux_L1``, ``avgdown_L1``. A coarse step of
this path runs about a million kernels, so it is profiled once, not
repeated.

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
import gc
import json
import os
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
SEDOV_DECK = ROOT / "decks" / "benchmark_unigrid_256.in"

# substring of a CUDA kernel's name -> the port's kernel (K2e is the lean
# kernel with the register seed, counted under K2c; K2's sweeps with a
# divergence, stage 1, stage 2 and K2d, are `sweep_tile_kernel`; K1's
# second pass, with an outflow side, is `outflow_planes_kernel`; K2's PLM
# and scalar forms and K3's scalar forms are template instantiations of the
# same kernels, `lean_tile_kernel<axis, order, scalars>`, `apply_kernel<
# scalars>`, counted under the same names)
KERNEL_OF = (
    ("mhd_tile_kernel", "K8"), ("rad_axis_flux_kernel", "K7"),
    ("rad_transport_axis_kernel", "K4 transport"),
    ("rad_stage1_kernel", "K4 stage 1"), ("rad_stage2_kernel", "K4 stage 2"),
    ("rad_source_kernel", "K5"), ("rad_div_tile_kernel", "K6"),
    ("transverse_kernel", "K1"), ("outflow_planes_kernel", "K1"),
    ("lean_tile_kernel", "K2c"), ("sweep_tile_kernel", "K2"),
    ("face_tile_kernel", "K2 faces"), ("fo_face_kernel", "K2 faces"), ("apply_kernel", "K3"),
    ("row_gather_kernel", "K9"),
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


def _release():
    """Free what a profiled case left: reference cycles first (an AMR
    hierarchy holds some), then the allocator's cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


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
        if getattr(sim, "_g_ext", None) is not None:  # the external gravity kick
            sim.U = sim._external_kick(sim.U, dt)
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
    _release()
    return out


def by_region_kernel(events, regions, reps: int) -> dict:
    """{region: {kernel: mean device ms per repetition}} of a profiler
    trace. A kernel belongs to the region during whose host time range it
    started on the device: each region ends with a device sync, so what it
    launched has run by then (the kernels launched through ctypes have no
    ATen parent op to carry their time up to the region's event)."""
    from torch.autograd import DeviceType

    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == DeviceType.CPU and e.name in regions]
    out = defaultdict(lambda: defaultdict(float))
    for e in events:
        # the regions' own device-side annotations are spans, not kernels
        if e.device_type != DeviceType.CUDA or e.name in regions:
            continue
        for lo, hi, name in spans:
            if lo <= e.time_range.start < hi:
                out[name][kernel_of(e.name)] += e.time_range.elapsed_us() / 1e3 / reps
                break
    return {name: dict(kernels) for name, kernels in out.items()}


AMR_REGIONS = ("regrid_L0", "hydro_L0", "rad_L0", "hydro_L1", "rad_L1", "reflux_L0",
               "avgdown_L0")
PACKED_REGIONS = AMR_REGIONS + ("regrid_L1", "hydro_L2", "rad_L2", "reflux_L1",
                                "avgdown_L1")


def _amr_restorer(sim):
    """`_restorer` for an AMRSimulation: its levels, masks and counters.
    The saved levels wait in host memory: a second copy on the card (6 GB
    at 256^3 + 1 level) would crowd the step's own 62 GB peak and make the
    allocator free and re-map memory inside the timed steps."""
    fields = {f: getattr(sim, f) for f in _STEP_FIELDS + ("cell_updates_raw",
                                                          "finest_level")}
    levels = ([u.cpu() if u is not None else None for u in sim.level_U],
              list(sim.level_mask), list(sim.level_steps), dict(sim._active_cell_cache))
    device = sim.device

    def restore():
        sim.level_U = None
        sim.level_U = [u.to(device) if u is not None else None for u in levels[0]]
        sim.level_mask, sim.level_steps = list(levels[1]), list(levels[2])
        sim._active_cell_cache = dict(levels[3])
        sim.U = sim.level_U[0]
        for f, v in fields.items():
            setattr(sim, f, v)

    return restore


def profile_amr(make_sim, reps: int) -> dict:
    """One coarse step of the dense AMR shell after two warm-up steps (so
    that it starts with a regrid of level 1): its wall time, its device time
    by kernel and by the profiler regions `AMRSimulation` names (`AMR_REGIONS`,
    as the JAX package names them), and its idle share."""
    from torch.profiler import ProfilerActivity, profile

    from .utils.profiler import prof

    sim = make_sim()
    sim.set_initial_conditions()
    sim.evolve()  # two warm-up steps (max_timesteps = 2)
    print(f"\n== dense AMR shell: finest level {sim.finest_level}, active cells "
          f"{[sim._active_cells(l) for l in range(sim.finest_level + 1)]}", flush=True)
    restore = _amr_restorer(sim)

    def step():
        dt = sim.compute_timestep()
        if not sim.advance_single_step(dt):
            raise RuntimeError("the coarse step failed its retries")
        sim.t += dt
        sim.dt_prev = dt
        sim.istep += 1

    restore()
    wall = wall_ms(step, reps)
    restore()
    by_kernel, top = device_ms(step, reps)
    busy = sum(by_kernel.values())
    # by region: the named ranges of the hierarchy's profiler regions; the
    # region wall times are the host clock with a device sync at each exit
    restore()
    prof.reset(enabled=True)
    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        for _ in range(reps):
            step()
        _sync()
    by_region = {name: sum(kernels.values())
                 for name, kernels in by_region_kernel(tp.events(), AMR_REGIONS, reps).items()}
    region_wall = {name.split("/")[-1]: t * 1e3 / reps for name, t in prof._acc.items()}
    prof.reset(enabled=False)
    out = {"wall_ms": wall, "device_ms": busy, "idle_share": 1.0 - busy / wall,
           "by_kernel": by_kernel, "top_plain": top,
           "device_ms_by_region": dict(by_region), "wall_ms_by_region": region_wall}
    kernels = ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_kernel.items()))
    print(f"coarse step: wall {wall:.3f} ms, device {busy:.3f} ms, idle share "
          f"{1.0 - busy / wall:.3f}; by kernel (ms): {kernels}")
    print("  by region, device ms: " + ", ".join(
        f"{k} {by_region.get(k, 0.0):.3f}" for k in AMR_REGIONS))
    print("  by region, synchronized wall ms: " + ", ".join(
        f"{k} {region_wall.get(k, 0.0):.3f}" for k in AMR_REGIONS))
    print("  longest plain-torch kernels (ms): "
          + "; ".join(f"{name[:70]} {ms:.3f}" for name, ms in top), flush=True)
    del sim
    _release()
    return out


def profile_packed() -> dict:
    """One coarse step of the packed shell (256^3 + 2 packed pool levels)
    after one warm-up step, run once under the profiler: its wall time, its
    device time by kernel and by region (`PACKED_REGIONS`), the regions'
    synchronized wall times, and its idle share."""
    from torch.profiler import ProfilerActivity, profile

    from . import ParmParse
    from .amr import AMRSimulation
    from .problems import radhydro_shell
    from .utils.profiler import prof

    sim = AMRSimulation(radhydro_shell.RadhydroShellProblem(), ParmParse.from_string(
        radhydro_shell.DECK_256_PACKED, [
            "max_timesteps=1", "verbose=0",
            f"amr.packed_chunk={radhydro_shell.CARD_PACKED_CHUNK}"]))
    sim.set_initial_conditions()
    sim.evolve()  # one warm-up step
    print(f"\n== packed AMR shell: finest level {sim.finest_level}, active cells "
          f"{[sim._active_cells(l) for l in range(sim.finest_level + 1)]}", flush=True)
    prof.reset(enabled=True)
    _sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        dt = sim.compute_timestep()
        if not sim.advance_single_step(dt):
            raise RuntimeError("the coarse step failed")
        _sync()
    wall = (time.perf_counter() - t0) * 1e3
    region_wall = {name.split("/")[-1]: t * 1e3 for name, t in prof._acc.items()}
    prof.reset(enabled=False)
    events = tp.events()
    by_kernel = defaultdict(float)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in PACKED_REGIONS:
            by_kernel[kernel_of(e.name)] += e.time_range.elapsed_us() / 1e3
    by_kernel = dict(by_kernel)
    busy = sum(by_kernel.values())
    by_region = {name: sum(kernels.values())
                 for name, kernels in by_region_kernel(events, PACKED_REGIONS, 1).items()}
    out = {"wall_ms": wall, "device_ms": busy, "idle_share": 1.0 - busy / wall,
           "by_kernel": by_kernel, "device_ms_by_region": by_region,
           "wall_ms_by_region": region_wall}
    print(f"coarse step (profiled): wall {wall:.3f} ms, device {busy:.3f} ms, idle share "
          f"{1.0 - busy / wall:.3f}; by kernel (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_kernel.items())))
    print("  by region, device ms: " + ", ".join(
        f"{k} {by_region.get(k, 0.0):.3f}" for k in PACKED_REGIONS))
    print("  by region, synchronized wall ms: " + ", ".join(
        f"{k} {region_wall.get(k, 0.0):.3f}" for k in PACKED_REGIONS), flush=True)
    del sim
    _release()
    return out


def _timed_step(fn, reps: int) -> dict:
    """Wall and device time, idle share and peak memory of `fn` (one hydro
    step whose result is dropped): the peak is `max_memory_allocated`
    over one call, the state it starts from included."""
    _release()
    _sync()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    _sync()
    peak = torch.cuda.max_memory_allocated()
    wall = wall_ms(fn, reps)
    by_kernel, top = device_ms(fn, reps)
    busy = sum(by_kernel.values())
    return {"wall_ms": wall, "device_ms": busy, "idle_share": 1.0 - busy / wall,
            "by_kernel": by_kernel, "top_plain": top, "peak_gib": peak / 2**30,
            "held_gib": held / 2**30}


def profile_lean(reps: int) -> dict:
    """Sedov 512^3 f32 (`problems/sedov.py:DECK_512`, the JAX package's
    bench.py:76-84) after one warm-up step, on the lean branch the dispatch
    takes there: the step and its hydro half as `profile_case` times them,
    the hydro half's device time by RK stage (the regions
    `advance.LEAN_STAGES`) and kernel, and the peak memory of one
    `advance_hydro_rk2` call. Then one step of `_advance_hydro_rk2_fused`
    called directly on the same state, with its time and peak memory: a
    measurement of what the lean form buys on this card, not a dispatch
    option (above 272 the JAX package never runs the fused form)."""
    from torch.profiler import ProfilerActivity, profile

    from . import ParmParse, Simulation
    from .hydro import advance
    from .problems.sedov import DECK_512, SedovProblem
    from .utils.profiler import prof

    title = "Sedov 512^3 f32, lean step (K1 + K2c)"
    out = profile_case(title, lambda: Simulation(
        SedovProblem(), ParmParse.from_string(DECK_512, ["max_timesteps=1"]), device="cuda"),
        reps)
    sim = Simulation(SedovProblem(), ParmParse.from_string(DECK_512, ["max_timesteps=1"]),
                     device="cuda")
    sim.set_initial_conditions()
    sim.evolve()  # the warm-up step
    parts = _parts(sim)
    prof.reset(enabled=True)
    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        for _ in range(reps):
            parts["hydro half"]()
        _sync()
    prof.reset(enabled=False)
    out["hydro half by stage"] = by_region_kernel(tp.events(), advance.LEAN_STAGES, reps)
    for stage, kernels in out["hydro half by stage"].items():
        print(f"  {stage}: device {sum(kernels.values()):.3f} ms; " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(kernels.items())))
    gf = sim._ghost_free_config()
    opts, U = sim.hydro_opts, sim.U
    dt = torch.tensor(sim.dt_prev, dtype=U.dtype, device=U.device)
    steps = {
        "lean step": lambda: advance.advance_hydro_rk2(U, dt, opts, None, gf["ng"], sim.periodic,
                                                       bc_kinds=gf["bc_kinds"]),
        "fused step (called directly)": lambda: advance._advance_hydro_rk2_fused(
            U, dt, opts, gf["ng"], sim.periodic, gf["bc_kinds"]),
    }
    for name, fn in steps.items():
        out[name] = r = _timed_step(fn, reps)
        kernels = ", ".join(f"{k} {v:.3f}" for k, v in sorted(r["by_kernel"].items()))
        print(f"{name}: wall {r['wall_ms']:.3f} ms, device {r['device_ms']:.3f} ms, idle "
              f"share {r['idle_share']:.3f}, peak {r['peak_gib']:.2f} GiB (state held "
              f"{r['held_gib']:.2f}); by kernel (ms): {kernels}", flush=True)
    del sim, U, steps
    _release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3, help="repetitions of each part")
    ap.add_argument("--packed", action="store_true",
                    help="profile only the packed AMR shell (256^3 + 2 pool levels)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_profile needs a CUDA device")
    # as chip_smoke.py: the AMR path's GB-sized transients of many sizes
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

    from . import MHDSimulation, ParmParse, Simulation, _cuda
    from .problems import mhd
    from .problems.radhydro_bench import DECK_256, RadhydroBenchProblem
    from .problems.sedov import SedovProblem

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}")
    _cuda.library()
    if args.packed:
        print(json.dumps({"card": smi, "packed AMR radhydro shell 256^3 + 2 pool levels f32":
                          profile_packed()}))
        return 0

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
    result["Sedov 512^3 f32 lean"] = profile_lean(args.steps)
    from .amr import AMRSimulation
    from .problems import radhydro_shell

    title = "dense AMR radhydro shell 256^3 + 1 level f32 (K1, K2, K2d, K5, K7)"
    result[title] = profile_amr(
        lambda: AMRSimulation(radhydro_shell.RadhydroShellProblem(), ParmParse.from_string(
            radhydro_shell.DECK_256, ["max_timesteps=2", "verbose=0"])), args.steps)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
