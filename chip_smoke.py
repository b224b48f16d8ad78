#!/usr/bin/env python3
"""Smoke test of quokka_tpu_torch on one CUDA GPU: build the hand-written
kernels, hold each against its plain PyTorch version at the main path's
shapes, then run the main path -- 20 steps of the Sedov 256^3 f32 blast
from decks/benchmark_unigrid_256.in through `Simulation(device="cuda")`.

Run from the repository root:  python3 chip_smoke.py
Phases print as they go; any failure exits non-zero. The last two lines are
the card's name and power limit and {"ok": true, "device": {...}}; the line
before them is the kernels' JSON summary. The full nvcc/ptxas log is kept
beside the built library in quokka_tpu_torch/_build/.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DECK = ROOT / "decks" / "benchmark_unigrid_256.in"

KERNELS = {  # launch-count key -> (name, source, TPU kernel it replaces)
    "transverse": ("K1 precompute_transverse", "quokka_tpu_torch/csrc/transverse.cu",
                   "quokka_tpu/hydro/pallas_sweep.py:187"),
    "axis_flux": ("K2 compute_axis_flux", "quokka_tpu_torch/csrc/sweep.cu",
                  "quokka_tpu/hydro/pallas_sweep.py:1148"),
    "apply_update": ("K3 apply_update", "quokka_tpu_torch/csrc/apply.cu",
                     "quokka_tpu/hydro/pallas_sweep.py:1409"),
}


def phase(name):
    print(f"\n=== {name}", flush=True)


def rough_state(n, seed=7):
    """Seeded conserved state with a density/pressure well and strong wall
    shocks: its update goes invalid and fires the FOFC fallback."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (n, n, n)
    rho = 1.0 + 0.5 * rng.random(shape, dtype=np.float32)
    v = 0.3 * rng.standard_normal((3,) + shape, dtype=np.float32)
    eint = 1.0 + rng.random(shape, dtype=np.float32)
    rho[2, 2, 2], eint[2, 2, 2] = 1e-4, 1e-6
    v[0, 3, 2, 2], v[0, 1, 2, 2] = 8.0, -8.0
    eint[0], eint[1] = eint[0] * 30.0, eint[1] * 4.0
    v[0, 0], v[0, 1] = 2.0, -1.5
    eint[:, :, n - 1] *= 25.0
    v[2, :, :, n - 1] = -2.0
    ke = 0.5 * rho * (v * v).sum(axis=0)
    return np.stack([rho, rho * v[0], rho * v[1], rho * v[2], rho * eint + ke,
                     rho * eint])


def main() -> int:
    import torch

    # ---- 1. device
    phase("1. device")
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false; nothing runs on the CPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "quokka_tpu_torch").is_dir() or not DECK.exists():
        print("error: run chip_smoke.py from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")

    from quokka_tpu_torch import ParmParse, Simulation, _cuda, kernel_check
    from quokka_tpu_torch.benchmarks import bench_hydro
    from quokka_tpu_torch.hydro import sweep
    from quokka_tpu_torch.hydro.advance import advance_hydro_rk2
    from quokka_tpu_torch.interop import state_from_numpy
    from quokka_tpu_torch.problems.sedov import SedovProblem
    from quokka_tpu_torch.registry import BC_REFLECT

    # ---- 2. build
    phase("2. build")
    t0 = time.perf_counter()
    _cuda.library()
    print(f"built {_cuda.build_info['path']} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_cuda.build_info['seconds']:.1f} s)")
    for line in _cuda.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 3. kernels against their plain versions, at the main path's shapes
    phase("3. kernels vs plain PyTorch (tolerance: rtol 1e-5 + 64 ulps of "
          "each component's max)")
    pp = ParmParse.from_file(str(DECK), overrides=["max_timesteps=3", "verbose=0"])
    warm = Simulation(SedovProblem(), pp, device="cuda")
    warm.set_initial_conditions()
    warm.evolve()
    U_sedov = warm.U
    dt = warm.dt_prev
    U_sedov2 = warm._step(U_sedov, dt)[0]
    opts = warm.hydro_opts
    reflect = (BC_REFLECT, BC_REFLECT)
    n = warm.grid.n_cell[0]
    U_rough = state_from_numpy(rough_state(n), "cuda")
    U_rough2 = state_from_numpy(rough_state(n, seed=8), "cuda")
    mixed = {0: None, 1: reflect, 2: reflect}
    # the third set turns on what Sedov leaves off: CW84 viscosity, the
    # temperature floor and reconstruction of the specific internal energy
    opts_extra = dataclasses.replace(opts, K_visc=0.1, temperature_floor=1e-30,
                                     reconstruct_eint=True)
    inputs = [
        ("Sedov 256^3 after 3 steps, reflect x/y/z", U_sedov, U_sedov2,
         {0: reflect, 1: reflect, 2: reflect}, dt, opts),
        ("rough seeded state, periodic x, reflect y/z", U_rough, U_rough2,
         mixed, 0.2 / n, opts),
        ("rough state + viscosity, T floor, reconstruct_eint", U_rough, U_rough2,
         mixed, 0.2 / n, opts_extra),
    ]
    summary = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in KERNELS}
    failed = []
    for title, U, U2, bc, dt_in, opts_in in inputs:
        print(f"-- {title}")
        timed = title.startswith("Sedov")
        for case in kernel_check.cases(U, U2, opts_in, bc, dt_in):
            got = case.run_kernel()
            ref = case.run_plain()
            torch.cuda.synchronize()
            ok, max_abs, max_rel = kernel_check.compare(got, ref)
            if case.kernel == "apply_update":
                nk, npl = int(got[1]), int(ref[1])
                ok = ok and (nk > 0) == (npl > 0)
                extra = f" invalid cells kernel {nk} plain {npl}"
            else:
                extra = ""
            line = f"{case.label:28s} max_abs {max_abs:.3e} max_rel {max_rel:.3e}"
            if timed and "first order" not in case.label and "avg" not in case.label:
                ms = kernel_check.time_ms(case.run_kernel)
                plain_ms = kernel_check.time_ms(case.run_plain)
                summary[case.kernel]["ms"] += ms
                summary[case.kernel]["plain_ms"] += plain_ms
                line += f" | kernel {ms:.3f} ms plain {plain_ms:.3f} ms"
            print(f"  {'ok  ' if ok else 'FAIL'} {line}{extra}", flush=True)
            s = summary[case.kernel]
            s["max_abs_err"] = max(s["max_abs_err"], max_abs)
            if not ok:
                failed.append(f"{title}: {case.label}")
            del got, ref
    del warm, U_sedov, U_sedov2, U_rough, U_rough2
    torch.cuda.empty_cache()
    print(f"times: CUDA events, mean of 5 after 1 warm-up, on {smi}; "
          "K2 sums the three stage-1 sweeps")
    if failed:
        raise SystemExit(f"kernel mismatch: {failed}")

    # ---- 4. a small input against the plain path on the CPU
    phase("4. Sedov 32^3 f32, 5 steps: GPU kernels vs CPU plain versions")
    finals = {}
    for dev in ("cuda", "cpu"):
        small = ParmParse.from_file(str(DECK), overrides=[
            "amr.n_cell=32 32 32", "max_timesteps=5", "verbose=0"])
        sim = Simulation(SedovProblem(), small, device=dev)
        sim.set_initial_conditions()
        sim.evolve()
        finals[dev] = sim.U.double().cpu()
    for c in range(6):
        ref = finals["cpu"][c]
        diff = float((finals["cuda"][c] - ref).abs().max())
        scale = float(ref.abs().max())
        print(f"  component {c}: max |gpu - cpu| {diff:.3e} (limit 1e-5 x {scale:.3e})")
        if not diff <= 1e-5 * scale:
            raise SystemExit(f"GPU and CPU disagree on component {c}")

    print("-- rough 32^3 state, one step through the FOFC fallback: GPU vs CPU")
    U32 = rough_state(32)
    small_opts = dataclasses.replace(opts, dx=(1.0 / 32,) * 3)
    steps = {}
    for dev in ("cuda", "cpu"):
        steps[dev] = advance_hydro_rk2(state_from_numpy(U32, dev), 0.2 / 32,
                                       small_opts, None, (0, 0, 0),
                                       (True, False, False), bc_kinds=mixed)
    (Ug, sg), (Uc, sc) = steps["cuda"], steps["cpu"]
    print(f"  FOFC: GPU {sg['fofc_fallbacks']} fallbacks / {int(sg['n_fofc'])} cells, "
          f"CPU {sc['fofc_fallbacks']} / {int(sc['n_fofc'])}")
    ok, max_abs, max_rel = kernel_check.compare(Ug.cpu(), Uc)
    print(f"  {'ok  ' if ok else 'FAIL'} state max_abs {max_abs:.3e} max_rel {max_rel:.3e}")
    if not (ok and sg["fofc_fallbacks"] >= 1
            and (sg["fofc_fallbacks"], int(sg["n_fofc"])) == (sc["fofc_fallbacks"],
                                                              int(sc["n_fofc"]))):
        raise SystemExit("the FOFC step disagrees between GPU and CPU")

    # ---- 5. the main path
    phase("5. main path: Sedov 256^3 f32, 20 steps, decks/benchmark_unigrid_256.in")
    pp = ParmParse.from_file(str(DECK), overrides=["max_timesteps=20", "verbose=1"])
    sim = Simulation(SedovProblem(), pp, device="cuda")
    sim.set_initial_conditions()
    torch.cuda.reset_peak_memory_stats()
    sweep.reset_launch_counts()
    sim.evolve()
    launches = dict(sweep.launch_counts)
    mzones = sim.zone_updates_per_second / 1e6
    print(f"FOM: {mzones:.3f} Mzone-updates/s over {sim.istep} steps "
          f"({sim.elapsed_walltime:.3f} s wall, first step included) "
          f"on {smi}")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rel = sim.conservation_rel_err
    print(f"conservation: mass rel err {rel[0]:.3e}, energy rel err {rel[4]:.3e}")
    print(f"FOFC: {sim.fofc_fallbacks} stage fallbacks, {sim.fofc_cells} invalid cells")
    print(f"launches in the main path: {launches}")
    finite = bool(torch.isfinite(sim.U).all())
    if sim.istep != 20 or not finite:
        raise SystemExit(f"main path: {sim.istep} steps, finite state {finite}")
    if not abs(rel[0]) < 1e-5:
        raise SystemExit(f"mass conservation error {rel[0]:.3e} >= 1e-5")
    missing = [k for k in KERNELS if launches[k] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the main path: {missing}")
    del sim
    bench = Simulation(SedovProblem(), pp, device="cuda")
    mz_bench, secs = bench_hydro(bench, n_warmup=2, n_steps=10)
    print(f"bench_hydro (dt on the device, 10 steps after 2): {mz_bench:.3f} "
          f"Mzone-updates/s ({secs:.3f} s) on {smi}")

    rows = []
    for key, (kname, source, replaces) in KERNELS.items():
        s = summary[key]
        rows.append({"name": kname, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[key],
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                     "plain_ms": s["plain_ms"]})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
