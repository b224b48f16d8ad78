#!/usr/bin/env python3
"""Smoke test of quokka_tpu_torch on one CUDA GPU: build the hand-written
kernels, hold each against its plain PyTorch version at the main paths'
shapes, compare small runs with the CPU, then run the main paths on the
card:

- hydro: 10 steps of the Sedov 256^3 f32 blast from
  decks/benchmark_unigrid_256.in through `Simulation` (kernels K1-K3);
- radhydro: RadhydroBench 256^3 f32 (the JAX package's bench.py:54-62
  deck), 10 steps with the fused substep (K1-K4) and 2 steps stage by
  stage (K1-K3, K5, K6);
- MHD: Orszag-Tang 256^3 f32 (the JAX package's bench.py:310-318 deck),
  20 steps of the windowed loop through `MHDSimulation` (K8);
- dense AMR: the radhydro shell at 256^3 + one level f32 (the JAX
  package's bench.py:192-207 deck, `run_amr_shell(sparse=False)`), one
  warm-up coarse step and one timed through `AMRSimulation` (K1, K2,
  K2d, K5, K7);
- lean hydro: 10 steps of Sedov 512^3 f32 (the JAX package's bench.py:76-84
  deck, `problems/sedov.py:DECK_512`) through `Simulation`, which the
  dispatch sends to the lean step (K1, K2c);
- packed AMR: the reference's AMR benchmark, the radhydro shell at 256^3 +
  2 levels of packed 16^3-tile pools f32 (`problems/radhydro_shell.py:
  DECK_256_PACKED`, the JAX package's bench.py:163-207 `run_amr_shell(
  sparse=True)`, chunks of 512 tiles), one coarse step, timed with its
  first-step costs (no warm-up step: it keeps the script within its time
  limit): the root's seeded lean step (K1, K2e), the pool levels' batched
  sweeps (K1, K2), K7, K5 and the row gathers (K9);
- ShockCloud 256^3 f32 (`problems/shock_cloud.py:DECK_256`: user inflow
  x-lo, outflow x-hi, periodic y and z), 10 steps through `Simulation` in
  the hybrid ghost-free mode (x padded by the inflow hook; K1, K2, K3 on
  the padded layout), phase 12;
- Richtmyer-Meshkov on 256 x 256 x 64 f32 (`problems/hydro_suite.py:
  DECK_RM_3D`: outflow x walls assembled in the kernels), 10 steps: K1
  writes the outflow chi planes and every K2 sweep reads them, phase 13;
- Rayleigh-Taylor 3D f32 (`problems/rayleigh_taylor.py`: one passive
  scalar, the external gravity kick, periodic x/y, reflecting z), 10
  steps at 256 x 256 x 384 on the JAX test's domain (the lean step, K1 +
  K2c with the scalar), phase 14, and at 256^3 (the fused step, K1, K2 and
  K3 with the scalar), phase 15;
- the radhydro shell's unigrid PLM deck (`decks/radhydro_shell_256.in`,
  256^3 f32), 10 steps: K1 (dmin only), K2 with PLM, K3 and K4 with PLM,
  phase 16;
- multigroup radhydro: RadMultigroupPulse (`decks/rad_multigroup_ppl.in` at
  256^3 f32: 4 photon groups, PPL full spectrum, hydro on), 2 steps: K1-K3
  on the 6 gas rows of the 22-row state, K6 over the 4 groups (one launch
  an axis), the plain multigroup coupling; its device time by part, the
  coupling's share and its Newton host syncs, phase 17.

Phase 3 also holds K6 over 4 photon groups to its plain version at 256^3
(rough seeded blocks; per axis, timed, and accumulated as
`rad_transport_div` launches it) and over 2 and 4 groups at K4's edge
shapes; phase 4 runs a step of RadMultigroupPulse at 32^3 on the card
against the CPU in f32 (K6) and f64 (no kernel), and 3 steps of the 1D
RadhydroPulseMGconst and RadhydroBB in f64 (no kernel).

Besides, phase 4 runs Sedov, Orszag-Tang and RadhydroBench (both
radiation configurations) at 32^3 and the dense AMR shell at 16^3 + 1
level in float64 on the card (the classic formulation, K8's plain form and
the plain versions of K4-K7, as the JAX package takes XLA) against the
CPU, with no kernel launched, and the packed engine at 32^3 + 1 and + 2
pool levels, the outflow and mixed walls' rough FOFC steps (fused and
lean), ShockCloud and Richtmyer-Meshkov 3D at 32^3 f32 against the CPU,
Richtmyer-Meshkov 2D at 64^2 in float64 against the CPU with no kernel
launched, and the shocktube deck (`decks/shocktube.in`, 1D float64, plain
torch on the card) with its error norm below 0.002.

Phase 3 also holds K2's PLM and scalar forms (sweep_plm0-2.cu,
sweep_ppm1-2.cu) and K3's scalar forms to their plain versions: at the
new paths' shapes (Rayleigh-Taylor 3D 256^3: K1 at 7 components, K2 stage
1, stage 2 and first order, K3; 256 x 256 x 384: K2c in every lean
variant; the shell deck's 256^3: K1, K2 with PLM, K3; timed beside the
Sedov rows) and at the edge shapes for PLM, one scalar and two mass
scalars in every K2 form and K3 with the density floor engaged, and checks
that what the kernels do not take raises NotImplementedError naming it;
phase 4 runs Rayleigh-Taylor 3D at 16 x 16 x 24 and 32^3, the shell deck
at 32^3 and a forced-lean rough step with a scalar against the CPU.

Phase 3 also holds K1's outflow chi planes bitwise and every K2 variant
on outflow and mixed walls at their edge shapes (every side kind on every
axis, rough states whose FOFC mask flags the wall cells), and times K1, K2
(stage 1, stage 2) and K3 at the two new paths' shapes.

Phase 3 also holds K2c/K2e's, K2's sweeps' (stage 1, first order, stage
2, K2d: one tile kernel, `sweep_tile_kernel`) and K8's shared-memory tiles
at their edge shapes (extents 4 and 5, ragged tiles, walls and periodic
axes, every lean variant; orders 1-3 and the floors for K8), K6 per axis
and accumulated over three axes (as `rad_transport_div` launches it: x
into a fresh output, y and z added on; timed at RadhydroBench 256^3, and
at K4's edge shapes), checks that the built library holds no
one-thread-a-cell divergence kernel (`div_kernel`, `rad_div_kernel`), and
holds K1 and K2's tiled face
kernel over the main path's
chunk of 512 level-1 hydro blocks (36^3; timed) and the face kernel at
its edge shapes to their plain versions, K1 bit for bit everywhere (at
the lean path's 512^3 timed too) and at the face kernel's edge shapes in
its input variants (conserved and primitive input, reconstruct_eint,
dmin alone), and both K4 stage kernels at small periodic extents (4^3,
5^3, ragged tiles; PPM, PLM, donor cell; both opacity kinds); phase 11 holds
the batched K5 to its plain version on main path 6's own first level-2
chunk (captured in its coarse step: stage 1 on the 2g-deep blocks with
the ring mask, stage 2 on the crop, written into pool rows), and times
it.

Run from the repository root:  python3 chip_smoke.py
Phases print as they go; any failure exits non-zero. The last three lines
are the kernels' JSON summary, the card's name and power limit, and
{"ok": true, "device": {...}}. The full nvcc/ptxas log is kept beside the
built library in quokka_tpu_torch/_build/.
"""

import dataclasses
import gc
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DECK = ROOT / "decks" / "benchmark_unigrid_256.in"
SHELL_DECK = ROOT / "decks" / "radhydro_shell_256.in"
MG_DECK = ROOT / "decks" / "rad_multigroup_ppl.in"

KERNELS = {  # launch-count key -> (name, source, TPU kernel it replaces)
    "transverse": ("K1 precompute_transverse", "quokka_tpu_torch/csrc/transverse.cu",
                   "quokka_tpu/hydro/pallas_sweep.py:187"),
    "axis_flux": ("K2 compute_axis_flux", "quokka_tpu_torch/csrc/sweep.cu",
                  "quokka_tpu/hydro/pallas_sweep.py:1148"),
    "apply_update": ("K3 apply_update", "quokka_tpu_torch/csrc/apply.cu",
                     "quokka_tpu/hydro/pallas_sweep.py:1409"),
    "rad_stage1": ("K4 fused_substep stage 1", "quokka_tpu_torch/csrc/rad_substep.cu",
                   "quokka_tpu/radiation/pallas_substep.py:183"),
    "rad_stage2": ("K4 fused_substep stage 2", "quokka_tpu_torch/csrc/rad_substep.cu",
                   "quokka_tpu/radiation/pallas_substep.py:196"),
    "rad_source": ("K5 source_update", "quokka_tpu_torch/csrc/rad_source.cu",
                   "quokka_tpu/radiation/pallas_source.py:59"),
    "rad_div": ("K6 compute_rad_div", "quokka_tpu_torch/csrc/rad_sweep.cu",
                "quokka_tpu/radiation/pallas_sweep.py:115"),
    "mhd_axis": ("K8 compute_mhd_axis", "quokka_tpu_torch/csrc/mhd_sweep.cu",
                 "quokka_tpu/mhd/pallas_sweep.py:98"),
    "axis_flux_avg": ("K2d compute_axis_flux emit_avg_flux", "quokka_tpu_torch/csrc/sweep.cu",
                      "quokka_tpu/hydro/pallas_sweep.py:1148"),
    "rad_axis_flux": ("K7 compute_rad_axis_flux", "quokka_tpu_torch/csrc/rad_axis_flux.cu",
                      "quokka_tpu/radiation/pallas_sweep.py:53"),
    "axis_flux_lean": ("K2c compute_axis_flux div_only", "quokka_tpu_torch/csrc/sweep.cu",
                       "quokka_tpu/hydro/pallas_sweep.py:1148"),
    "axis_flux_corr": ("K2e compute_axis_flux corr_mask", "quokka_tpu_torch/csrc/sweep.cu",
                       "quokka_tpu/hydro/pallas_sweep.py:1148"),
    "row_gather": ("K9 row_gather", "quokka_tpu_torch/csrc/row_gather.cu",
                   "quokka_tpu/amr/packed.py:146"),
    # the forms of the Rayleigh-Taylor and radhydro shell paths (phases 14-16):
    # each row's launch-count key is the part before the space
    "transverse nv7": ("K1 precompute_transverse, 7 components (1 scalar)",
                       "quokka_tpu_torch/csrc/transverse.cu",
                       "quokka_tpu/hydro/pallas_sweep.py:187"),
    "axis_flux scalars": ("K2 compute_axis_flux, 1 passive scalar",
                          "quokka_tpu_torch/csrc/sweep_ppm1.cu",
                          "quokka_tpu/hydro/pallas_sweep.py:1148"),
    "axis_flux_lean scalars": ("K2c compute_axis_flux div_only, 1 passive scalar",
                               "quokka_tpu_torch/csrc/sweep_ppm1.cu",
                               "quokka_tpu/hydro/pallas_sweep.py:1148"),
    "apply_update scalars": ("K3 apply_update, 1 passive scalar",
                             "quokka_tpu_torch/csrc/apply.cu",
                             "quokka_tpu/hydro/pallas_sweep.py:1409"),
    "axis_flux plm": ("K2 compute_axis_flux, PLM", "quokka_tpu_torch/csrc/sweep_plm0.cu",
                      "quokka_tpu/hydro/pallas_sweep.py:1148"),
    # K6 over the photon groups of the multigroup path (phase 17); its
    # launch-count key is "rad_div"
    "rad_div groups": ("K6 compute_rad_div, 4 photon groups",
                       "quokka_tpu_torch/csrc/rad_sweep.cu",
                       "quokka_tpu/radiation/pallas_sweep.py:115"),
}
AMR_KEYS = ("transverse", "axis_flux", "axis_flux_avg", "rad_source", "rad_axis_flux")
HYDRO_KEYS = ("transverse", "axis_flux", "apply_update")
LEAN_KEYS = ("transverse", "axis_flux_lean")
PACKED_KEYS = ("transverse", "axis_flux", "axis_flux_corr", "rad_source", "rad_axis_flux",
               "row_gather")
# the K2c launches of one clean lean stage: what its row's time sums
LEAN_STAGE = ("K2c clean axis 0", "K2c acc axis 1", "K2c acc axis 2")
# the K2c launches of one clean lean stage of Rayleigh-Taylor 3D at 256 x 256 x 384
RT_LEAN_STAGE = tuple(f"{label} RT" for label in LEAN_STAGE)
# the K2e launches of one clean seeded stage at 256^3, likewise
CORR_STAGE = ("K2e stage 1 axis 0", "K2e stage 1 acc axis 1", "K2e stage 1 acc axis 2")
# bar of the MHD main path's max |div B| x dx, in float32 ulps of max |B_face|
DIVB_ULPS = 32


_T_START = time.perf_counter()


def phase(name):
    print(f"\n=== {name} (at {time.perf_counter() - _T_START:.1f} s)", flush=True)


def section(title):
    print(f"{title} (at {time.perf_counter() - _T_START:.1f} s)", flush=True)


def rough_state(n, seed=7):
    """Seeded conserved state of n^3 cells (or of shape n) with a
    density/pressure well and strong wall shocks: its update goes invalid
    and fires the FOFC fallback."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (n, n, n) if isinstance(n, int) else tuple(n)
    nz = shape[2]
    rho = 1.0 + 0.5 * rng.random(shape, dtype=np.float32)
    v = 0.3 * rng.standard_normal((3,) + shape, dtype=np.float32)
    eint = 1.0 + rng.random(shape, dtype=np.float32)
    rho[2, 2, 2], eint[2, 2, 2] = 1e-4, 1e-6
    v[0, 3, 2, 2], v[0, 1, 2, 2] = 8.0, -8.0
    eint[0], eint[1] = eint[0] * 30.0, eint[1] * 4.0
    v[0, 0], v[0, 1] = 2.0, -1.5
    eint[:, :, nz - 1] *= 25.0
    v[2, :, :, nz - 1] = -2.0
    ke = 0.5 * rho * (v * v).sum(axis=0)
    return np.stack([rho, rho * v[0], rho * v[1], rho * v[2], rho * eint + ke,
                     rho * eint])


def rough_rad_state(n, seed=9):
    """Seeded [10, n, n, n] f32 radhydro state on the card
    (`kernel_check.rough_rad_state`): moving gas (the work term is
    non-zero), |f| -> 1 and E near the floor beside E ~ 1, so reconstructed
    faces go inadmissible and the donor-cell fallback fires."""
    from quokka_tpu_torch import kernel_check

    return kernel_check.rough_rad_state((n, n, n), seed, "cuda")


def rough_padded_hydro(n, seed, fill):
    """Seeded [6, n, n, n] f32 gas state on the card with a density and
    pressure well and strong shocks along every axis, periodic-padded by
    `fill`: the padded AMR level's K2d input where PPM flattening, the
    carbuncle fix and the HLLC branches all fire."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (n, n, n)
    rho = 1.0 + 0.5 * torch.rand(shape, generator=g, device="cuda")
    v = 0.3 * torch.randn((3,) + shape, generator=g, device="cuda")
    eint = 1.0 + torch.rand(shape, generator=g, device="cuda")
    q = n // 8
    rho[q:2 * q, q:2 * q, q:2 * q] = 1e-4
    eint[q:2 * q, q:2 * q, q:2 * q] = 1e-6
    for d in range(3):
        sl = [slice(None)] * 3
        sl[d] = slice(3 * q, 3 * q + 2)
        eint[tuple(sl)] *= 30.0
        v[d][tuple(sl)] = 4.0
        sl[d] = slice(5 * q, 5 * q + 2)
        v[d][tuple(sl)] = -4.0
    ke = 0.5 * rho * (v * v).sum(dim=0)
    U = torch.stack([rho, rho * v[0], rho * v[1], rho * v[2], rho * eint + ke, rho * eint])
    return fill(U.contiguous())


def run_cases(title, cases, timed, summary, failed, extra_of=None, plain_reps=5):
    """Check each case against its plain version; time the timed ones (the
    kernel as `run_timed` gives it, where it does; the plain version over
    `plain_reps` calls)."""
    from quokka_tpu_torch import kernel_check

    section(f"-- {title}")
    for case in cases:
        ok, max_abs, max_rel, got, ref = case.check()
        extra = extra_of(case, got, ref) if extra_of else ""
        if extra is None:
            ok, extra = False, " (extra check failed)"
        line = f"{case.label:28s} max_abs {max_abs:.3e} max_rel {max_rel:.3e}"
        del got, ref
        s = summary[case.kernel]
        if timed(case):
            ms = kernel_check.time_ms(case.run_timed or case.run_kernel)
            # the check has just run the plain version: no warm-up call
            plain_ms = kernel_check.time_ms(case.run_plain, reps=plain_reps, warmup=False)
            nbytes, ops = case.cost()
            b_ms, b_by = kernel_check.bound_ms(nbytes, ops)
            s["ms"] += ms
            s["plain_ms"] += plain_ms
            s["bound_ms"] += b_ms
            s["bytes"] += nbytes
            s["ops"] += ops
            line += (f" | kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound {b_ms:.3f} ms "
                     f"({b_by}: {nbytes / 1e9:.3f} GB, {ops / 1e9:.2f} GFLOP)")
        print(f"  {'ok  ' if ok else 'FAIL'} {line}{extra}", flush=True)
        s["max_abs_err"] = max(s["max_abs_err"], max_abs)
        if not ok:
            failed.append(f"{title}: {case.label}")


def gpu_vs_cpu(a, b, what, rtol, atol_frac, groups=None):
    """|a - b| <= rtol |b| + atol_frac x scale, per component; the scale is
    the largest magnitude of b over the component's group (default: the
    component alone)."""
    worst = 0.0
    for group in groups or [[c] for c in range(b.shape[0])]:
        scale = float(b[group].abs().max())
        for c in group:
            diff = (a[c] - b[c]).abs()
            worst = max(worst, float(diff.max()) / scale if scale > 0 else float(diff.max()))
            if not bool((diff <= rtol * b[c].abs() + atol_frac * scale).all()):
                raise SystemExit(f"{what}: component {c} off by {float(diff.max()):.3e} "
                                 f"(scale {scale:.3e})")
    print(f"  ok   {what}: max |diff| / scale {worst:.3e} "
          f"(limit rtol {rtol:g} + atol {atol_frac:g} x scale)")
    return worst


def _bump_problem():
    """The hydro-only Gaussian bump of the JAX package's tests/test_packed_
    engine.py, its root tagged on the middle half: at 32^3 + 1 packed level
    its 2 x 2 x 2 tiles sit inside the domain and the root takes the seeded
    lean step; a second packed level tags the middle quarter of the first."""
    import numpy as np
    import torch

    from quokka_tpu_torch.eos import IdealGasEOS
    from quokka_tpu_torch.registry import BCSpec, EOSTraits, PhysicsTraits, Problem

    class Bump(Problem):
        name = "packed_bump_smoke"
        physics = PhysicsTraits(hydro_enabled=True)
        eos_traits = EOSTraits(gamma=1.4, mean_molecular_weight=1.0)
        bcs = BCSpec()

        def make_eos(self):
            return IdealGasEOS(gamma=1.4)

        def set_initial_conditions(self, grid, dtype=torch.float32, device="cuda"):
            x, y, z = grid.cell_center_mesh(torch.float64, device)
            r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
            U = torch.zeros((6, *grid.n_cell), dtype=torch.float64, device=device)
            U[0] = 1.0 + 0.6 * torch.exp(-r2 / 0.01)
            U[4] = U[5] = (1.0 + 0.4 * torch.exp(-r2 / 0.01)) / 0.4
            return U.to(dtype)

        def error_est(self, sim, level):
            n = sim.level_grids[level].n_cell[0]
            m = np.zeros(n, bool)
            m[n // 4:3 * n // 4] = level == 0
            return torch.as_tensor(m[:, None, None] & m[None, :, None] & m[None, None, :])

        def error_est_local(self, U_padded, grid, level, origin):
            """A packed level's tags: its cells in [3n/8, 5n/8)^3 by global
            index, for padded tiles [c, nvar, X, Y, Z] at `origin` [c, 3]
            (at max_level 2, level 2 is 2 x 2 x 2 tiles inside level 1)."""
            ts = 16
            g = (U_padded.shape[2] - ts) // 2
            lo, hi = grid.n_cell[0] * 3 // 8, grid.n_cell[0] * 5 // 8
            idx = torch.arange(-g, ts + g, device=U_padded.device)
            m = [(origin[:, d, None] + idx >= lo) & (origin[:, d, None] + idx < hi)
                 for d in range(3)]
            return m[0][:, :, None, None] & m[1][:, None, :, None] & m[2][:, None, None, :]

    return Bump()


BUMP_DECK = """
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 1. 1. 1.
amr.n_cell = 32 32 32
amr.max_level = 1
amr.sparse_min_level = 1
amr.tile_size = 16 16 16
amr.pool_packed = 1
amr.pool_headroom = 1.02
amr.n_error_buf = 0
cfl = 0.3
stop_time = 1.0e10
"""


def main() -> int:
    # the dense AMR path's transients at the fine level's 520^3 are GB-sized
    # and of many sizes: let the allocator grow segments instead of
    # fragmenting (set before the first CUDA allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    t_start = time.perf_counter()
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

    from quokka_tpu_torch import (MHDSimulation, ParmParse, PowerLawOpacity, Simulation,
                                  _cuda, kernel_check)
    from quokka_tpu_torch.amr import AMRSimulation
    from quokka_tpu_torch.amr import packed as psweep
    from quokka_tpu_torch.benchmarks import (bench_amr_shell, bench_hydro, bench_mhd,
                                             bench_radhydro)
    from quokka_tpu_torch.boundaries import fill_ghosts
    from quokka_tpu_torch.problems import radhydro_shell
    from quokka_tpu_torch.hydro import sweep
    from quokka_tpu_torch.hydro.advance import advance_hydro_rk2
    from quokka_tpu_torch.hydro.riemann import HLLD_REGIONS
    from quokka_tpu_torch.interop import state_from_numpy
    from quokka_tpu_torch.mhd import sweep as msweep
    from quokka_tpu_torch.mhd.advance import b_cell_from_faces, cons_to_prim_mhd
    from quokka_tpu_torch.problems import mhd
    from quokka_tpu_torch.problems.radhydro_bench import DECK_256, RadhydroBenchProblem
    from quokka_tpu_torch.problems.sedov import DECK_512, SedovProblem
    from quokka_tpu_torch.radiation import source as rsource
    from quokka_tpu_torch.radiation import sweep as rsweep
    from quokka_tpu_torch.registry import BC_REFLECT
    from quokka_tpu_torch import step_profile
    from quokka_tpu_torch.problems import shock_cloud
    from quokka_tpu_torch.problems.hydro_suite import (DECK_RM_3D,
                                                       RichtmeyerMeshkovProblem)
    from quokka_tpu_torch.problems.shocktube import ShocktubeProblem
    from quokka_tpu_torch.problems import rayleigh_taylor
    from quokka_tpu_torch.problems.radhydro_shell import RadhydroShellProblem
    from quokka_tpu_torch.problems.rad_multigroup import RadMultigroupPulseProblem
    from quokka_tpu_torch.radiation import multigroup

    def release():
        """Free what the phase before left: reference cycles first (an AMR
        hierarchy holds some), then the allocator's cached blocks, so that
        each main path's peak memory is its own."""
        gc.collect()
        torch.cuda.empty_cache()

    def reset_counts():
        sweep.reset_launch_counts()
        rsweep.reset_launch_counts()
        msweep.reset_launch_counts()
        psweep.reset_launch_counts()

    def read_counts():
        return {**sweep.launch_counts, **rsweep.launch_counts, **msweep.launch_counts,
                **psweep.launch_counts}

    # ---- 2. build
    phase("2. build")
    t0 = time.perf_counter()
    _cuda.library()
    print(f"built {_cuda.build_info['path']} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc, one process per source, {_cuda.build_info['seconds']:.1f} s)")
    entries = []
    for line in _cuda.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
        if "Compiling entry" in line:
            entries.append(line)
    # K2's sweeps with a divergence and K6 run as tiles; the one-thread-a-
    # cell divergence kernels they replaced (`div_kernel`, `rad_div_kernel`)
    # are gone from the library
    stale = [e for e in entries if "div_kernel" in e]
    missing = [k for k in ("sweep_tile_kernel", "rad_div_tile_kernel", "lean_tile_kernel")
               if not any(k in e for e in entries)]
    if stale or missing:
        raise SystemExit(f"library entries: stale {stale}, missing {missing}")
    print(f"  {len(entries)} kernel entries compiled; no div_kernel or rad_div_kernel")

    def new_summary():
        return {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                    "bytes": 0, "ops": 0, "library_ms": None} for k in KERNELS}

    def bitwise(case, got, ref):
        """K1, K7 and K9 equal their plain versions bit for bit."""
        if case.kernel not in ("row_gather", "rad_axis_flux", "transverse"):
            return ""
        return " (bitwise)" if kernel_check.same_bits(got, ref) else None

    def ulps(case, got, ref):
        """K2's faces, K2c, K2e and K8 against the plain version in float32
        ulps of each component's max (the one-thread-a-face and one-thread-
        a-cell kernels, whose bits the tiles keep, read 0-3 on the faces'
        inputs); K1 beside them bit for bit."""
        if case.kernel == "transverse":
            return bitwise(case, got, ref)
        return f" ({kernel_check.ulps_of_max(got, ref):.2f} ulp of max)"

    summary = new_summary()
    faces_aside = new_summary()  # K2's faces at the packed chunk, beside its row
    failed = []

    # ---- 3. kernels against their plain versions, at the main paths' shapes
    phase("3. kernels vs plain PyTorch (tolerance: rtol 1e-5 + 64 ulps of each "
          "component's max; through the Newton coupling, max |diff| <= 2e-5 x "
          "the component's max)")
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

    def k3_counts(case, got, ref):
        if case.kernel != "apply_update":
            return ""
        nk, npl = int(got[1]), int(ref[1])
        return f" invalid cells kernel {nk} plain {npl}" if (nk > 0) == (npl > 0) else None

    def k3_counts_k1_bits(case, got, ref):
        return k3_counts(case, got, ref) if case.kernel == "apply_update" else bitwise(
            case, got, ref)

    for title, U, U2, bc, dt_in, opts_in in inputs:
        timed = title.startswith("Sedov")
        run_cases(title, kernel_check.cases(U, U2, opts_in, bc, dt_in), lambda c, t=timed: (
            t and "first order" not in c.label and "avg" not in c.label),
            summary, failed, k3_counts_k1_bits)
    # K2's sweeps with a divergence at their tile's edge shapes: extents 4
    # and 5, ragged tiles along and across, walls and periodic axes, stage 1
    # (faces and divergences), first order, stage 2 and K2d
    run_cases("K2 sweep edge shapes (extents 4 and 5, ragged tiles, walls; stage 1, "
              "first order, stage 2, K2d)", kernel_check.sweep_edge_cases(opts, "cuda"),
              lambda c: False, summary, failed, ulps)
    # K2c's stage-2 redo at or below 272 cells an axis: the sweep of U1
    # blended with U0's first-order fluxes and added onto the totals, on the
    # walls and on a periodic x axis
    walls = {0: reflect, 1: reflect, 2: reflect}
    fo_from = ("fo_mask+acc+fo_from",)
    for bc, axes, tag in ((walls, (0, 1, 2), ""), (mixed, (0,), " periodic x")):
        run_cases(f"K2c at 256^3 on the Sedov states, fo_from{tag}",
                  kernel_check.lean_cases(U_sedov, U_sedov2, opts, bc, seed=5,
                                          variants=fo_from, axes=axes, tag=tag),
                  lambda c: False, summary, failed)
    del warm, U_sedov, U_sedov2, U_rough, U_rough2, inputs
    release()

    # the outflow variant at its edge shapes: every side kind on every axis
    # (outflow, each reflect / outflow pair, periodic beside them), extents
    # 4 and 5 and ragged tiles, rough states with jets at every wall and a
    # FOFC mask that flags the wall cells; K1 and its chi planes bitwise
    outflow_shapes = kernel_check.OUTFLOW_EDGE_SHAPES
    run_cases("K1 outflow edge shapes (every side kind, rough walls), bitwise",
              kernel_check.k1_wall_edge_cases(opts, "cuda"), lambda c: False, summary,
              failed, bitwise)
    for title, gen in (
            ("K2 faces (PPM, first order)", kernel_check.face_wall_edge_cases(opts, "cuda")),
            ("K2 sweeps (stage 1, first order, stage 2, K2d)",
             kernel_check.sweep_edge_cases(opts, "cuda", shapes=outflow_shapes)),
            ("K2c / K2e (every lean variant)",
             kernel_check.lean_edge_cases(opts, "cuda", shapes=outflow_shapes))):
        run_cases(f"{title} at the outflow edge shapes", gen, lambda c: False, summary,
                  failed, ulps)
    # the two new paths' shapes, timed beside the Sedov rows: Richtmyer-
    # Meshkov 256 x 256 x 64 after 2 steps (outflow x walls: K1 writes the
    # chi planes, every K2 sweep reads them) and ShockCloud 256^3 after 2
    # steps on its hybrid layout (x padded to 264 by the inflow hook; K3
    # reads the padded stage input at the interior)
    new_paths = {}
    for title, prob, deck in (
            ("Richtmyer-Meshkov 256x256x64 after 2 steps, outflow x", RichtmeyerMeshkovProblem(),
             DECK_RM_3D),
            ("ShockCloud 256^3 after 2 steps, hybrid (x padded by 4)",
             shock_cloud.ShockCloudProblem(), shock_cloud.DECK_256)):
        wsim = Simulation(prob, ParmParse.from_string(deck, ["max_timesteps=2"]), device="cuda")
        wsim.set_initial_conditions()
        wsim.evolve()
        gf, W0 = wsim._gf, wsim.U
        W1 = wsim._step(W0, wsim.dt_prev)[0]
        if gf["fill"] is not None:
            W0, W1 = gf["fill"](W0), gf["fill"](W1)
        wcases = list(kernel_check.cases(W0, W1, wsim.hydro_opts, gf["bc_kinds"],
                                         wsim.dt_prev, gf["ng"]))
        s1, s2 = new_summary(), new_summary()
        run_cases(title, [c for c in wcases if "avg" not in c.label],
                  lambda c: "first order" not in c.label, s1, failed, k3_counts_k1_bits)
        run_cases(f"{title}: K2 stage 2", [c for c in wcases if "avg" in c.label],
                  lambda c: True, s2, failed)
        for k in KERNELS:
            summary[k]["max_abs_err"] = max(summary[k]["max_abs_err"], s1[k]["max_abs_err"],
                                            s2[k]["max_abs_err"])
        for what, a in (("K1", s1["transverse"]), ("K2 stage 1, 3 axes", s1["axis_flux"]),
                        ("K2 stage 2, 3 axes", s2["axis_flux"]), ("K3", s1["apply_update"])):
            print(f"  {what} at {tuple(W0.shape[1:])}: kernel {a['ms']:.3f} ms, plain "
                  f"{a['plain_ms']:.3f} ms, bound {a['bound_ms']:.3f} ms "
                  f"({a['bytes'] / 1e9:.3f} GB, {a['ops'] / 1e9:.2f} GFLOP), library none")
        new_paths[title] = (s1, s2)
        del wsim, W0, W1, wcases
        release()

    # the forms of the Rayleigh-Taylor 3D and radhydro shell paths (phases
    # 14-16) at their shapes: K1 at 7 components, K2 with one passive scalar
    # (stage 1, stage 2, first order) and K3 with it on Rayleigh-Taylor 3D
    # 256^3 after 2 steps; K1 (dmin only), K2 with PLM and K3 on the shell
    # deck's 256^3 after 2 steps (hydro block; stage 2 on one more hydro
    # step of it); timed beside the Sedov rows
    form_paths = {}
    for key, title, prob, pp_form in (
            ("rt", "Rayleigh-Taylor 3D 256^3 after 2 steps, 1 scalar, z walls",
             rayleigh_taylor.RayleighTaylor3DProblem(),
             ParmParse.from_string(rayleigh_taylor.DECK_3D_FUSED, ["max_timesteps=2"])),
            ("shell", "radhydro shell 256^3 after 2 steps (its unigrid PLM deck)",
             RadhydroShellProblem(),
             ParmParse.from_file(str(SHELL_DECK), overrides=["max_timesteps=2", "verbose=0"]))):
        fsim = Simulation(prob, pp_form, device="cuda")
        fsim.set_initial_conditions()
        fsim.evolve()
        nh, gf = fsim.layout.nvar_hydro, fsim._gf
        W0 = fsim.U[:nh].contiguous()
        W1 = fsim._step(fsim.U, fsim.dt_prev)[0][:nh].contiguous()
        wcases = list(kernel_check.cases(W0, W1, fsim.hydro_opts, gf["bc_kinds"],
                                         fsim.dt_prev, gf["ng"]))
        s1, s2 = new_summary(), new_summary()
        run_cases(title, [c for c in wcases if "avg" not in c.label],
                  lambda c: "first order" not in c.label, s1, failed, k3_counts_k1_bits,
                  plain_reps=2)
        run_cases(f"{title}: K2 stage 2", [c for c in wcases if "avg" in c.label],
                  lambda c: True, s2, failed, plain_reps=2)
        for what, a in (("K1", s1["transverse"]), ("K2 stage 1, 3 axes", s1["axis_flux"]),
                        ("K2 stage 2, 3 axes", s2["axis_flux"]), ("K3", s1["apply_update"])):
            print(f"  {what} at {tuple(W0.shape)}: kernel {a['ms']:.3f} ms, plain "
                  f"{a['plain_ms']:.3f} ms, bound {a['bound_ms']:.3f} ms "
                  f"({a['bytes'] / 1e9:.3f} GB, {a['ops'] / 1e9:.2f} GFLOP), library none")
        form_paths[key] = (s1, s2)
        del fsim, W0, W1, wcases
        release()
    s1_rt, s2_rt = form_paths["rt"]
    s1_shell, s2_shell = form_paths["shell"]
    summary["transverse nv7"] = s1_rt["transverse"]
    summary["axis_flux scalars"] = s1_rt["axis_flux"]
    s1_rt["axis_flux"]["max_abs_err"] = max(s1_rt["axis_flux"]["max_abs_err"],
                                            s2_rt["axis_flux"]["max_abs_err"])
    summary["apply_update scalars"] = s1_rt["apply_update"]
    summary["axis_flux plm"] = s1_shell["axis_flux"]
    s1_shell["axis_flux"]["max_abs_err"] = max(s1_shell["axis_flux"]["max_abs_err"],
                                               s2_shell["axis_flux"]["max_abs_err"])
    for k in ("transverse", "apply_update"):  # the shell's K1 (dmin only) and K3 (nv 6)
        summary[k]["max_abs_err"] = max(summary[k]["max_abs_err"],
                                        s1_shell[k]["max_abs_err"])
    # K2c with the scalar on Rayleigh-Taylor 3D's lean shape, 256 x 256 x 384
    # after 2 steps (and one more RK2 step of it), every lean variant, K1
    # beside it bitwise; the plain sides in 4 slabs; timed: one clean stage
    rsim = Simulation(rayleigh_taylor.RayleighTaylor3DProblem(), ParmParse.from_string(
        rayleigh_taylor.DECK_3D_LEAN, ["max_timesteps=2"]), device="cuda")
    rsim.set_initial_conditions()
    rsim.evolve()
    R0, ropts_rt, rbc = rsim.U, rsim.hydro_opts, rsim._gf["bc_kinds"]
    R1 = rsim._step(R0, rsim.dt_prev)[0]
    del rsim
    k1_rt = kernel_check.Case(
        "transverse", "K1 all axes RT 256x256x384",
        lambda: sweep.precompute_transverse(R0, ropts_rt, rbc, True)[:2],
        lambda: kernel_check.plain_transverse(R0, ropts_rt, rbc, nslab=4),
        lambda: kernel_check.k1_cost_of(R0, ropts_rt))
    s_rt_lean = new_summary()
    run_cases("Rayleigh-Taylor 3D 256x256x384 after 2 steps, 1 scalar, K1", [k1_rt],
              lambda c: False, s_rt_lean, failed, bitwise)
    run_cases("Rayleigh-Taylor 3D 256x256x384 after 2 steps, 1 scalar, z walls, K2c "
              "(every lean variant; timed: one clean stage)",
              kernel_check.lean_cases(R0, R1, ropts_rt, rbc, seed=13, nslab=4, tag=" RT"),
              lambda c: c.label in RT_LEAN_STAGE, s_rt_lean, failed, plain_reps=2)
    summary["axis_flux_lean scalars"] = s_rt_lean["axis_flux_lean"]
    summary["transverse nv7"]["max_abs_err"] = max(summary["transverse nv7"]["max_abs_err"],
                                                   s_rt_lean["transverse"]["max_abs_err"])
    a = s_rt_lean["axis_flux_lean"]
    print(f"  K2c one clean stage at {tuple(R0.shape)}: kernel {a['ms']:.3f} ms, plain "
          f"{a['plain_ms']:.3f} ms, bound {a['bound_ms']:.3f} ms ({a['bytes'] / 1e9:.3f} GB, "
          f"{a['ops'] / 1e9:.2f} GFLOP), library none")
    del R0, R1, k1_rt
    release()
    # the new forms at the edge shapes (extents 4 and 5, ragged tiles, walls,
    # periodic axes, outflow sides): PLM, one passive scalar, and two mass
    # scalars, in every K2 form (the face kernel batched and on walls, first
    # order, the sweeps' stage 1 and 2 and K2d, K2c and K2e in every lean
    # variant, fo_from among them), and K3 with the density floor engaged
    row_of = {"PLM": {"axis_flux": "axis_flux plm", "axis_flux_avg": "axis_flux plm",
                      "axis_flux_lean": "axis_flux plm", "axis_flux_corr": "axis_flux plm"},
              "scalars": {"axis_flux": "axis_flux scalars",
                          "axis_flux_avg": "axis_flux scalars",
                          "axis_flux_lean": "axis_flux_lean scalars",
                          "axis_flux_corr": "axis_flux_lean scalars",
                          "apply_update": "apply_update scalars"}}
    shapes = kernel_check.FORM_EDGE_SHAPES
    for changes, rows in (({"reconstruction_order": 2}, row_of["PLM"]),
                          ({"n_scalars": 1}, row_of["scalars"]),
                          ({"n_scalars": 2, "n_mscalars": 2}, row_of["scalars"])):
        fo_opts = dataclasses.replace(opts, **changes)
        tag = kernel_check.form_tag(fo_opts)
        s_form = new_summary()
        for what, gen in (
                ("K2 faces (batched, walls; PPM or PLM and first order)",
                 itertools.chain(kernel_check.face_edge_cases(fo_opts, "cuda"),
                                 kernel_check.face_wall_edge_cases(fo_opts, "cuda",
                                                                   shapes=shapes))),
                ("K2 sweeps (stage 1, first order, stage 2, K2d)",
                 kernel_check.sweep_edge_cases(fo_opts, "cuda", shapes=shapes)),
                ("K2c / K2e (every lean variant)",
                 kernel_check.lean_edge_cases(fo_opts, "cuda", shapes=shapes)),
                ("K3, density floor engaged", [kernel_check.k3_floor_case(fo_opts, "cuda")])):
            run_cases(f"{what} at the edge shapes,{tag}", gen, lambda c: False, s_form,
                      failed, ulps)
        for k, row in rows.items():
            summary[row]["max_abs_err"] = max(summary[row]["max_abs_err"],
                                              s_form[k]["max_abs_err"])
    # what the kernels do not take raises NotImplementedError naming it: K1
    # over a batch of states with scalars (the packed chunks), more than two
    # scalars, passive scalars in the radiation kernels (K4)
    from quokka_tpu_torch.radiation import substep as rsubstep
    from quokka_tpu_torch.radiation.system import RadOptions

    one, three = (dataclasses.replace(opts, n_scalars=k) for k in (1, 3))
    B5 = kernel_check.with_scalar_rows(kernel_check.hydro_blocks(2, (8, 8, 8), 5, "cuda"),
                                       one, 5)
    U3 = kernel_check.with_scalar_rows(kernel_check.hydro_blocks(1, (8, 8, 8), 6, "cuda")[0],
                                       three, 6)
    for what, call, needle in (
            ("K1, a batch with a scalar",
             lambda: sweep.precompute_transverse_batched(B5, one, None, True),
             "batch of states with passive scalars"),
            ("K1, 3 scalars", lambda: sweep.precompute_transverse(U3, three, None, True),
             "at most 2 passive scalars"),
            ("K4, a gas block with a scalar",
             lambda: rsubstep.fused_stage1(torch.ones((11, 8, 8, 8), device="cuda"), None, 1e-3,
                                           RadOptions(c=10.0, chat=5.0, arad=1.0),
                                           opts.eos, None, (0.1,) * 3), "passive scalars")):
        try:
            call()
        except NotImplementedError as e:
            if needle not in str(e):
                failed.append(f"{what}: {e}")
            print(f"  {'ok  ' if needle in str(e) else 'FAIL'} {what} raises "
                  f"NotImplementedError: {e}")
        else:
            failed.append(f"{what}: no NotImplementedError")
    del B5, U3

    # the lean path at 512^3: K1 and K2c on main path 5's own states (Sedov
    # 512^3 after 2 steps, and one more RK2 step of it), every kernel input
    # from a plain version; the plain sides run in 4 slabs
    lsim = Simulation(SedovProblem(), ParmParse.from_string(DECK_512, ["max_timesteps=2"]),
                      device="cuda")
    lsim.set_initial_conditions()
    lsim.evolve()
    L0, lopts = lsim.U, lsim.hydro_opts
    L1 = lsim._step(L0, lsim.dt_prev)[0]
    del lsim
    k1_512 = kernel_check.Case(
        "transverse", "K1 all axes 512^3",
        lambda: sweep.precompute_transverse(L0, lopts, walls, True)[:2],
        lambda: kernel_check.plain_transverse(L0, lopts, walls, nslab=4),
        lambda: kernel_check.k1_cost_of(L0, lopts))
    k1_aside = new_summary()  # the lean path's K1, beside the 256^3 row
    run_cases("Sedov 512^3 after 2 steps, K1 (timed; the plain version in 4 slabs, 2 calls)",
              [k1_512], lambda c: True, k1_aside, failed, bitwise, plain_reps=2)
    summary["transverse"]["max_abs_err"] = max(summary["transverse"]["max_abs_err"],
                                               k1_aside["transverse"]["max_abs_err"])
    lean_variants = ("clean", "acc", "fo_mask")
    run_cases("Sedov 512^3 after 2 steps, K2c, reflect x/y/z (timed: one clean stage)",
              kernel_check.lean_cases(L0, L1, lopts, walls, seed=11, variants=lean_variants,
                                      nslab=4),
              lambda c: c.label in LEAN_STAGE, summary, failed)
    run_cases("Sedov 512^3 after 2 steps, K2c, periodic x",
              kernel_check.lean_cases(L0, L1, lopts, mixed, seed=12, variants=lean_variants,
                                      axes=(0,), nslab=4, tag=" periodic x"),
              lambda c: False, summary, failed)
    del L0, L1, k1_512
    release()
    # K2c's and K2e's tile at its edge shapes: extents 4 and 5, ragged tiles
    # along and across, walls and periodic axes, every variant (clean, acc,
    # fo_mask, the fo_from redo, first order, the seed fresh and
    # accumulated), mask flags on every tile's first and last cells
    run_cases("K2c / K2e edge shapes (extents 4 and 5, ragged tiles, walls, every variant)",
              kernel_check.lean_edge_cases(lopts, "cuda"), lambda c: False, summary, failed,
              ulps)

    # radiation: RadhydroBench after 2 steps, and a rough state with
    # T-dependent opacities
    rpp = ParmParse.from_string(DECK_256, ["max_timesteps=2", "verbose=0"])
    rwarm = Simulation(RadhydroBenchProblem(), rpp, device="cuda", precision="single")
    rwarm.set_initial_conditions()
    rwarm.evolve()
    rad = rwarm._radiation
    nsub = rad.n_substeps(rwarm.dt_prev)
    dt_rad = float(torch.tensor(rwarm.dt_prev / nsub, dtype=torch.float32))

    class RoughOpacity(RadhydroBenchProblem):
        planck_opacity = PowerLawOpacity(10.0, -1.0, -1.5)
        energy_mean_opacity = PowerLawOpacity(8.0, -1.0, -1.0)
        flux_mean_opacity = PowerLawOpacity(12.0, -1.0, 0.5)

    rad_inputs = [
        (f"RadhydroBench 256^3 after 2 steps (dt_rad {dt_rad:.6e})", rwarm.U,
         RadhydroBenchProblem()),
        ("rough radhydro state, T-dependent power-law opacities", rough_rad_state(n),
         RoughOpacity()),
    ]
    k6_aside = new_summary()  # K6's three axes accumulated, beside its per-axis row
    for title, U, prob in rad_inputs:
        timed = title.startswith("RadhydroBench")
        rcases = list(kernel_check.rad_cases(U, None, dt_rad, rad.opts, rwarm.eos, prob,
                                             rwarm.grid.dx))
        run_cases(title, [c for c in rcases if "accumulated" not in c.label],
                  lambda c, t=timed: t, summary, failed)
        run_cases(f"{title}: K6 as rad_transport_div launches it (x fresh, y and z "
                  "added on)", [c for c in rcases if "accumulated" in c.label],
                  lambda c, t=timed: t, k6_aside, failed)
        del rcases
    a = k6_aside["rad_div"]
    summary["rad_div"]["max_abs_err"] = max(summary["rad_div"]["max_abs_err"],
                                            a["max_abs_err"])
    print(f"  K6 3 axes accumulated on RadhydroBench 256^3: kernel {a['ms']:.3f} ms, plain "
          f"{a['plain_ms']:.3f} ms, bound {a['bound_ms']:.3f} ms ({a['bytes'] / 1e9:.3f} GB)"
          ", library none")
    run_cases("K6 edge shapes (extents 4 and 5, ragged tiles, orders 1-3; per axis and "
              "accumulated)", kernel_check.k6_edge_cases(rad.opts, "cuda"), lambda c: False,
              summary, failed)
    # K4 at small periodic extents: 4^3 and 5^3 (the halo wraps around its
    # transport's tile) and ragged tiles, PPM (and PLM, donor cell on one shape),
    # both opacity kinds
    run_cases("K4 edge shapes (rough states)",
              kernel_check.k4_edge_cases(rad.opts, rwarm.eos,
                                         {"constant opacity": RadhydroBenchProblem(),
                                          "T-dependent opacity": RoughOpacity()},
                                         dt_rad, "cuda"),
              lambda c: False, summary, failed)
    # K6 over the 4 photon groups of the multigroup path (phase 17): rough
    # seeded blocks of 4 groups at its 256^3 (timed; per axis, and the three
    # axes as rad_transport_div launches them), and over 2 and 4 groups at
    # K4's edge shapes (extents 4 and 5, ragged tiles, orders 1-3)
    mg_opts = dataclasses.replace(rad.opts, n_groups=4,
                                  erad_floor=RadMultigroupPulseProblem.rad.Erad_floor)
    R_mg = kernel_check.rough_rad_groups((n, n, n), 4, 31, "cuda", mg_opts.c)
    mg_cases = list(kernel_check.k6_cases(R_mg, mg_opts, rwarm.grid.dx, " 4 groups"))
    mg_aside = new_summary()
    run_cases("K6 over 4 photon groups, rough seeded blocks at 256^3", [
        c for c in mg_cases if "accumulated" not in c.label], lambda c: True, summary, failed)
    run_cases("K6 over 4 photon groups at 256^3 as rad_transport_div launches it",
              [c for c in mg_cases if "accumulated" in c.label], lambda c: True, mg_aside,
              failed)
    a = mg_aside["rad_div groups"]
    summary["rad_div groups"]["max_abs_err"] = max(summary["rad_div groups"]["max_abs_err"],
                                                   a["max_abs_err"])
    print(f"  K6 over 4 groups, 3 axes accumulated at 256^3: kernel {a['ms']:.3f} ms, plain "
          f"{a['plain_ms']:.3f} ms, bound {a['bound_ms']:.3f} ms ({a['bytes'] / 1e9:.3f} GB, "
          f"{a['ops'] / 1e9:.2f} GFLOP), library none")
    run_cases("K6 over 2 and 4 photon groups at its edge shapes (extents 4 and 5, ragged "
              "tiles, orders 1-3; per axis and accumulated)",
              kernel_check.k6_group_edge_cases(rad.opts, "cuda"), lambda c: False, summary,
              failed)
    del rwarm, rad_inputs, U, R_mg, mg_cases
    release()

    # MHD: Orszag-Tang after 3 steps (timed), and a rough seeded state that
    # takes every HLLD region and branch, with PLM, PPM and the floors
    mpp = ParmParse.from_string(mhd.DECK_256, ["max_timesteps=3"])
    mwarm = MHDSimulation(mhd.OrszagTangProblem(), mpp, precision="single")
    mwarm.set_initial_conditions()
    mwarm.evolve()
    mprim = cons_to_prim_mhd(mwarm.U, b_cell_from_faces(mwarm.Bf), mwarm.opts).contiguous()
    run_cases(f"Orszag-Tang 256^3 after 3 steps (t {mwarm.t:.6e}, max |div B| "
              f"{mwarm.final_divb:.3e})",
              kernel_check.mhd_cases(mprim, mwarm.Bf, mwarm.opts), lambda c: True,
              summary, failed)
    mopts = mwarm.opts
    del mwarm, mprim
    rprim, rbxf = kernel_check.rough_mhd_state(n)
    rprim = torch.tensor(rprim, dtype=torch.float32, device="cuda")
    rbxf = [torch.tensor(b, dtype=torch.float32, device="cuda") for b in rbxf]
    for order, floors in ((2, (0.0, 0.0)), (3, (0.0, 0.0)), (2, (0.6, 0.1))):
        ropts = dataclasses.replace(mopts, reconstruction_order=order,
                                    density_floor=floors[0], pressure_floor=floors[1])
        tag = f" order {order}" + (f" floors {floors}" if floors[0] > 0 else "")
        run_cases(f"rough MHD state{tag}", kernel_check.mhd_cases(rprim, rbxf, ropts, tag),
                  lambda c: False, summary, failed)
        counts = dict.fromkeys(HLLD_REGIONS, 0)
        for d in range(3):
            msweep.mhd_axis_plain(rprim, rbxf[d], d, ropts, counts)
        print(f"  HLLD faces by region and branch (3 axes): {counts}")
        if min(counts.values()) == 0:
            failed.append(f"rough MHD state{tag}: an HLLD region or branch not taken")
    del rprim, rbxf
    # K8's tile at its edge shapes: extents 4 and 5, ragged tiles, orders
    # 1-3, the floors off and on
    run_cases("K8 edge shapes (extents 4 and 5, ragged tiles, orders 1-3, floors)",
              kernel_check.mhd_edge_cases(mopts, "cuda"), lambda c: False, summary, failed,
              ulps)
    # on the card mhd_rhs launches K8 or raises: `mhd.use_pallas = 0` still
    # launches it, fewer than three active axes raise (float64 takes the
    # plain form, as the JAX package takes XLA: phase 4 runs it)
    msweep.reset_launch_counts()
    for extra, cls, prec, want in (
            (["mhd.use_pallas=0"], mhd.OrszagTangProblem, "single", None),
            (["amr.n_cell=64 1 1"], mhd.BrioWuProblem, "single", NotImplementedError)):
        small = ParmParse.from_string(mhd.DECK_256, ["amr.n_cell=16 16 16", "max_timesteps=1"]
                                      + extra)
        sim = MHDSimulation(cls(), small, precision=prec)
        sim.set_initial_conditions()
        try:
            sim.evolve()
            got = None
        except (TypeError, NotImplementedError) as e:
            got = type(e)
            print(f"  {cls.name} {prec} {extra}: raised {got.__name__}: {e}")
        if got is not want:
            failed.append(f"MHD on the card, {cls.name} {prec} {extra}: expected "
                          f"{want}, got {got}")
    print(f"  K8 launches of the mhd.use_pallas=0 step: {msweep.launch_counts['mhd_axis']}")
    if msweep.launch_counts["mhd_axis"] != 6:
        failed.append("mhd.use_pallas=0 did not launch K8 6 times a step")
    release()

    # dense AMR: K1, K2 stage 1, K2d, K7 and K5 at the fine level's padded
    # 520^3 (K5 at its unpadded 512^3), on the shell's level 1 as regridding
    # builds it (K2d's stage-2 input is one RK stage of it) and on rough
    # seeded states where the radiation admissibility fallback fires; the
    # times are those of K2d and K7 on the shell (K1, K2 and K5 are timed at
    # the 256^3 main paths' shapes above)
    from quokka_tpu_torch.hydro.advance import _advance_hydro_rk2_padded

    asim = AMRSimulation(radhydro_shell.RadhydroShellProblem(),
                         ParmParse.from_string(radhydro_shell.DECK_256, ["verbose=0"]))
    asim.set_initial_conditions()
    fopts = asim.level_opts[1]
    ng, bcs = asim.ng, asim.problem.bcs
    amr_eos, amr_problem = asim.eos, asim.problem

    def fill(U):
        return fill_ghosts(U, ng, bcs)

    U1f = asim.level_U[1]
    dt_amr = asim.compute_timestep()
    radL = asim._get_level_rad(1)
    dt_sub = 0.5 * dt_amr / radL.n_substeps(0.5 * dt_amr)  # a level-1 substep
    src = radL._rad_src(asim.t, U1f)
    Ug0 = fill(U1f[:6])
    Ust1, _ = _advance_hydro_rk2_padded(U1f[:6], dt_amr, dataclasses.replace(fopts, rk_order=1),
                                        fill, ng, asim.periodic)
    Ug1 = fill(Ust1)
    Rf = fill(U1f[6:])
    del Ust1
    ropts = asim._radiation.opts
    amr_timed = ("axis_flux_avg", "rad_axis_flux")
    run_cases(f"AMR shell level 1 (512^3, padded {tuple(Ug1.shape[1:])}, dt {dt_amr:.6e}, "
              f"substep {dt_sub:.6e})",
              kernel_check.amr_cases(Ug0, Ug1, Rf, fopts, ropts,
                                     coupling=(U1f, src, dt_sub, amr_eos, amr_problem)),
              lambda c: c.kernel in amr_timed, summary, failed, bitwise)
    del Ug0, Ug1, Rf, asim, U1f, radL, src
    release()
    nf = 2 * n
    Ug0 = rough_padded_hydro(nf, 31, fill)
    Ug1 = rough_padded_hydro(nf, 32, fill)
    Ur = rough_rad_state(nf)
    Rf = fill(Ur[6:].contiguous())
    run_cases("rough padded 520^3 states (hydro shocks; |f| -> 1, E at the floor)",
              kernel_check.amr_cases(Ug0, Ug1, Rf, fopts, ropts, " rough",
                                     coupling=(Ur, None, dt_sub, amr_eos, amr_problem)),
              lambda c: False, summary, failed, bitwise)
    del Ug0, Ug1, Rf, Ur
    release()
    # on the card compute_rad_fluxes launches K7 or raises: radiation.use_pallas
    # = 0 still launches it (and K2d)
    for extra, prec, want in ((["radiation.use_pallas=0", "hydro.use_pallas=0"], "single",
                               None),):
        reset_counts()
        small = ParmParse.from_string(radhydro_shell.DECK_256, [
            "amr.n_cell=16 16 16", "max_timesteps=1", "verbose=0", f"precision={prec}"]
            + extra)
        sim = AMRSimulation(radhydro_shell.RadhydroShellProblem(), small)
        sim.set_initial_conditions()
        try:
            sim.evolve()
            got = None
        except TypeError as e:
            got = type(e)
            print(f"  AMR shell {prec} {extra}: raised {got.__name__}: {e}")
        counts = read_counts()
        print(f"  AMR shell 16^3 + 1 {prec} {extra}: K7 launches {counts['rad_axis_flux']}, "
              f"K2d launches {counts['axis_flux_avg']}")
        if got is not want:
            failed.append(f"AMR on the card, {prec} {extra}: expected {want}, got {got}")
        if want is None and (counts["rad_axis_flux"] <= 0 or counts["axis_flux_avg"] <= 0):
            failed.append(f"AMR shell {extra}: K7 or K2d not launched")
    del sim
    release()
    # packed AMR, on the main path's hierarchy (256^3 + 2 packed levels):
    # K2e at the root's 256^3 with the boundary masks of the shell's level-1
    # coverage (both stages, the fo_from redo); K9 on the main path's chunk,
    # 512 x 26 neighbour rows of the level-2 hydro and radiation pools (the
    # kernel's timed row), and on 64 x 26 rows of level 1 (PR 6's shape);
    # the batched K1/K2 and K7 launches over a 64-tile chunk's stage-1
    # blocks (36^3 hydro, 32^3 radiation) against the per-block plain
    # versions, K7 over the main path's chunk of 512 radiation blocks of 32^3
    # (timed), and K7 at its edge shapes (extents 4 and 5, ragged tiles, a
    # batch of 3, orders 1-3)
    psim = AMRSimulation(radhydro_shell.RadhydroShellProblem(),
                         ParmParse.from_string(radhydro_shell.DECK_256_PACKED, ["verbose=0"]))
    psim.set_initial_conditions()
    st1, st2 = psim.level_pool[1], psim.level_pool[2]
    bmasks = psim._root_seed_masks()
    if bmasks is None:
        raise SystemExit("the shell's level-1 coverage touches the domain edge at 256^3")
    P0 = psim.level_U[0][:6].contiguous()
    popts = psim.level_opts[0]
    periodic3 = {0: None, 1: None, 2: None}
    P1 = advance_hydro_rk2(P0, psim.compute_timestep(), dataclasses.replace(popts, rk_order=1),
                           None, (0, 0, 0), (True,) * 3, bc_kinds=periodic3)[0]
    run_cases(f"AMR root 256^3, the shell's level-1 boundary masks ({st1.meta.n_active} "
              "tiles), K2e (timed: one clean seeded stage)",
              kernel_check.corr_cases(P0, P1, popts, bmasks, seed=13),
              lambda c: c.label in CORR_STAGE, summary, failed)
    del P0, P1, bmasks
    chunk = radhydro_shell.CARD_PACKED_CHUNK
    rows = torch.clamp(st2.meta.nbr_dev[:chunk].reshape(-1), min=0)
    gather_cases = list(kernel_check.gather_cases({"hydro rows": st2.Uh,
                                                   "radiation rows": st2.Ur}, rows))
    run_cases(f"K9, level-2 chunk of {chunk} x 26 neighbour rows (pools of "
              f"{st2.meta.capacity} rows, {int(torch.unique(rows).numel())} distinct)",
              gather_cases, lambda c: True, summary, failed, bitwise)
    summary["row_gather"]["library_ms"] = sum(kernel_check.time_ms(c.run_library)
                                              for c in gather_cases)
    rows64 = torch.clamp(st1.meta.nbr_dev[:64].reshape(-1), min=0)
    aside = new_summary()  # PR 6's shape, printed beside the kernel's row
    gather_cases = list(kernel_check.gather_cases({"hydro rows": st1.Uh,
                                                   "radiation rows": st1.Ur}, rows64))
    run_cases(f"K9, level-1 chunk of 64 x 26 neighbour rows (pools of {st1.meta.capacity} "
              "rows)", gather_cases, lambda c: True, aside, failed, bitwise)
    aside["row_gather"]["library_ms"] = sum(kernel_check.time_ms(c.run_library)
                                            for c in gather_cases)
    w = psweep.donor_pad_width(psim._g)
    th0 = torch.zeros((), dtype=torch.float32, device="cuda")

    def chunk_blocks(count, parts):
        """The stage-1 blocks of level 1's first `count` tiles."""
        nbr_c, org_c = st1.meta.nbr_dev[:count], st1.meta.origin_dev[:count]
        po_c = torch.zeros((count, 3), dtype=torch.int32, device="cuda")
        blocks = []
        for part, gf, pool in parts:
            pad = psim._dense_pad_part(part, w)(psim.level_U[0])
            bd = psweep.ParentContext("dense", (pad, pad)).backdrop(
                None, org_c, po_c, th0, gf, psim._g, psim.tile_shape, (0, 1, 2)).contiguous()
            blocks.append(psweep.assemble_chunk(pool, 0, count, nbr_c, bd, gf,
                                                psim.tile_shape))
            del pad, bd
        return blocks

    prad = psim._radiation.opts
    blocks = chunk_blocks(64, (("h", 10, st1.Uh), ("r", 8, st1.Ur)))
    run_cases("packed level-1 chunk 0: batched K1 + K2 faces and K7 vs per-block plain",
              kernel_check.batched_cases(blocks[0], blocks[1], psim.level_opts[1], prad),
              lambda c: False, summary, failed, bitwise)
    (R_chunk,) = chunk_blocks(chunk, (("r", 8, st1.Ur),))
    run_cases(f"packed level-1 chunk of {chunk} radiation blocks "
              f"{tuple(R_chunk.shape[2:])} (the main path's): K7 batched (timed)",
              kernel_check.k7_batched_cases(R_chunk, prad, f" {chunk} blocks"),
              lambda c: True, aside, failed, bitwise, plain_reps=1)
    run_cases("K7 edge shapes, orders 1-3", kernel_check.k7_edge_cases(prad, "cuda"),
              lambda c: False, summary, failed, bitwise)
    # K1 and K2's tiled face kernel over the main path's chunk of 512
    # level-1 hydro blocks (36^3, the stage-1 depth; timed: K1, K2 PPM; the
    # block-by-block plain versions over one call, as K7's above, to keep
    # the script within its time limit), and
    # the face kernel at its edge shapes (extents 4 and 5, ragged tiles, a
    # batch of 3, walls), each with its distance in ulps of each component's
    # max
    for depth, what in ((10, "stage 1"), (6, "stage 2")):
        (H_chunk,) = chunk_blocks(chunk, (("h", depth, st1.Uh),))
        tag = f" {chunk} x {H_chunk.shape[-1]}^3"
        cases = list(kernel_check.face_cases(H_chunk, psim.level_opts[1], tag=tag,
                                             orders=(False, True) if depth == 10 else (False,)))
        if depth == 10:
            cases.insert(0, kernel_check.k1_batched_case(H_chunk, psim.level_opts[1], tag))
        run_cases(f"packed level-1 chunk of {chunk} hydro blocks {tuple(H_chunk.shape[2:])} "
                  f"({what}): K1 and K2 faces (the plain versions timed over 1 call)", cases,
                  lambda c: True, faces_aside, failed, ulps, plain_reps=1)
        del H_chunk, cases
    run_cases("K2 face kernel edge shapes, PPM and first order",
              kernel_check.face_edge_cases(psim.level_opts[1], "cuda"), lambda c: False,
              summary, failed, ulps)
    # K1 at the same edge shapes, in its input variants (conserved and
    # primitive input, reconstruct_eint, dmin alone), bitwise
    run_cases("K1 edge shapes (extents 4 and 5, ragged tiles, a batch of 3, walls), "
              "bitwise", kernel_check.k1_edge_cases(psim.level_opts[1], "cuda"),
              lambda c: False, summary, failed, bitwise)
    summary["axis_flux"]["max_abs_err"] = max(summary["axis_flux"]["max_abs_err"],
                                              faces_aside["axis_flux"]["max_abs_err"])
    print("  K1 and K2's faces at the packed chunks: the rows above (K2 faces: PPM at "
          "the stage-1 and stage-2 depths, first order at stage 1; 3 axes each)")
    for key in ("row_gather", "rad_axis_flux"):
        summary[key]["max_abs_err"] = max(summary[key]["max_abs_err"],
                                          aside[key]["max_abs_err"])
        a = aside[key]
        print(f"  {KERNELS[key][0]} at the "
              + ("64 x 26 level-1 chunk (PR 6's shape)" if key == "row_gather" else
                 f"packed chunk of {chunk} x 32^3, 3 axes")
              + f": kernel {a['ms']:.3f} ms, plain {a['plain_ms']:.3f} ms, bound "
              f"{a['bound_ms']:.3f} ms ({a['bytes'] / 1e9:.3f} GB), library "
              + (f"{a['library_ms']:.3f} ms" if a["library_ms"] is not None else "none"))
    del psim, st1, st2, blocks, R_chunk, gather_cases, rows, rows64
    release()
    print(f"times: CUDA events, mean of 5 after 1 warm-up, on {smi}; K2, K2d, K6, K7 and K8 "
          "sum the three axes, K5 its two stages, K2c the three launches of a clean lean "
          "stage at 512^3, K2e those of a clean seeded stage at 256^3, K9 its hydro and "
          "radiation gathers of the main path's chunk")
    if failed:
        raise SystemExit(f"kernel mismatch: {failed}")

    # ---- 4. small inputs against the plain path on the CPU
    phase("4. Sedov 32^3 f32, 5 steps: GPU kernels vs CPU plain versions")
    finals = {}
    for dev in ("cuda", "cpu"):
        small = ParmParse.from_file(str(DECK), overrides=[
            "amr.n_cell=32 32 32", "max_timesteps=5", "verbose=0"])
        sim = Simulation(SedovProblem(), small, device=dev)
        sim.set_initial_conditions()
        sim.evolve()
        finals[dev] = sim.U.double().cpu()
    sedov_gap = 0.0
    for c in range(6):
        ref = finals["cpu"][c]
        diff = float((finals["cuda"][c] - ref).abs().max())
        scale = float(ref.abs().max())
        sedov_gap = max(sedov_gap, diff / scale)
        print(f"  component {c}: max |gpu - cpu| {diff:.3e} (limit 1e-5 x {scale:.3e})")
        if not diff <= 1e-5 * scale:
            raise SystemExit(f"GPU and CPU disagree on component {c}")
    print(f"  Sedov 32^3 max |gpu - cpu| / component max: {sedov_gap:.3e} (2.4e-07 "
          "while the hydro plain code took PyTorch's CPU sqrt)")

    section("-- rough 32^3 state, one step through the FOFC fallback: GPU vs CPU")
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

    section("-- the lean step forced (QUOKKA_PALLAS_LEAN=1), one step of rough states with "
          "FOFC in both stages: 32^3, and 288 x 32 x 32 (above 272: stage 2's first order "
          "from U1), GPU vs CPU")
    os.environ["QUOKKA_PALLAS_LEAN"] = "1"
    for shape in ((32, 32, 32), (288, 32, 32)):
        U_box = rough_state(shape)
        box_opts = dataclasses.replace(opts, dx=tuple(1.0 / s for s in shape))
        reset_counts()
        steps = {dev: advance_hydro_rk2(state_from_numpy(U_box, dev), 0.2 / shape[0],
                                        box_opts, None, (0, 0, 0), (True, False, False),
                                        bc_kinds=mixed) for dev in ("cuda", "cpu")}
        lean_count = sweep.launch_counts["axis_flux_lean"]
        (Ug, sg), (Uc, sc) = steps["cuda"], steps["cpu"]
        ok, max_abs, max_rel = kernel_check.compare(Ug.cpu(), Uc)
        print(f"  {'ok  ' if ok else 'FAIL'} {shape}: FOFC GPU {sg['fofc_fallbacks']} "
              f"fallbacks / {int(sg['n_fofc'])} cells, CPU {sc['fofc_fallbacks']} / "
              f"{int(sc['n_fofc'])}; K2c launches {lean_count}; state max_abs {max_abs:.3e} "
              f"max_rel {max_rel:.3e}; bitwise {ok and max_abs == 0.0} (NaN where NaN)")
        if not (ok and sg["fofc_fallbacks"] == 2 and lean_count > 0
                and (sg["fofc_fallbacks"], int(sg["n_fofc"])) == (sc["fofc_fallbacks"],
                                                                  int(sc["n_fofc"]))):
            raise SystemExit(f"the forced lean step {shape} disagrees between GPU and CPU")
    del os.environ["QUOKKA_PALLAS_LEAN"], steps, Ug, Uc

    section("-- rough 32^3 states on outflow and on mixed walls (reflect / outflow pairs), one "
          "step through the FOFC fallback, fused and lean (QUOKKA_PALLAS_LEAN=1): GPU vs CPU")
    for walls in ("outflow", "mixed"):
        bc = kernel_check._bc_of(walls)
        per = tuple(bc[d] is None for d in range(3))
        U_w = kernel_check.rough_wall_state((32, 32, 32), 41, "cpu")
        for lean in ("0", "1"):
            os.environ["QUOKKA_PALLAS_LEAN"] = lean
            reset_counts()
            steps = {dev: advance_hydro_rk2(U_w.to(dev), 0.2 / 32, small_opts, None, (0, 0, 0),
                                            per, bc_kinds=bc) for dev in ("cuda", "cpu")}
            counts = read_counts()
            (Ug, sg), (Uc, sc) = steps["cuda"], steps["cpu"]
            ok, max_abs, max_rel = kernel_check.compare(Ug.cpu(), Uc)
            form = "lean" if lean == "1" else "fused"
            print(f"  {'ok  ' if ok else 'FAIL'} {walls} {form}: FOFC GPU {sg['fofc_fallbacks']} "
                  f"fallbacks / {int(sg['n_fofc'])} cells, CPU {sc['fofc_fallbacks']} / "
                  f"{int(sc['n_fofc'])}; launches K1 {counts['transverse']} K2 "
                  f"{counts['axis_flux']} K2c {counts['axis_flux_lean']} K3 "
                  f"{counts['apply_update']}; state max_abs {max_abs:.3e} max_rel {max_rel:.3e}")
            if not (ok and sg["fofc_fallbacks"] >= 1 and counts["transverse"] > 0
                    and (sg["fofc_fallbacks"], int(sg["n_fofc"])) == (sc["fofc_fallbacks"],
                                                                      int(sc["n_fofc"]))):
                raise SystemExit(f"the rough {walls} {form} step disagrees between GPU and CPU")
    del os.environ["QUOKKA_PALLAS_LEAN"], steps, Ug, Uc

    section("-- ShockCloud 32^3 (hybrid: x padded by the inflow hook) and Richtmyer-Meshkov "
          "32 x 32 x 8 (outflow x walls in the kernels) f32, 5 steps: GPU kernels vs CPU plain "
          "versions within 1e-5 x each component's max (the Sedov bar)")
    for title, prob, deck, cells in (
            ("ShockCloud", shock_cloud.ShockCloudProblem(), shock_cloud.DECK_256, "32 32 32"),
            ("Richtmyer-Meshkov 3D", RichtmeyerMeshkovProblem(), DECK_RM_3D, "32 32 8")):
        fin = {}
        for dev in ("cuda", "cpu"):
            reset_counts()
            sim = Simulation(prob, ParmParse.from_string(deck, [
                f"amr.n_cell={cells}", "max_timesteps=5"]), device=dev)
            sim.set_initial_conditions()
            sim.evolve()
            fin[dev] = sim.U.double().cpu()
            counts = read_counts()
            print(f"  {title} {dev}: ng {sim._gf['ng']}, {sim.istep} steps, t {sim.t:.9e}, FOFC "
                  f"{sim.fofc_fallbacks} fallbacks / {sim.fofc_cells} cells; launches K1 "
                  f"{counts['transverse']} K2 {counts['axis_flux']} K3 "
                  f"{counts['apply_update']}")
        if any(read_counts()[k] for k in HYDRO_KEYS):
            raise SystemExit(f"{title} on the CPU launched a kernel")
        gpu_vs_cpu(fin["cuda"], fin["cpu"], f"{title} GPU vs CPU", 0.0, 1e-5)

    section("-- Rayleigh-Taylor 3D f32 (one passive scalar, z walls, the gravity kick), 5 "
          "steps at 16 x 16 x 24 (the JAX test's deck) and at 32^3: GPU kernels vs CPU plain "
          "versions within 1e-5 x each component's max (the Sedov bar); the radhydro shell's "
          "PLM deck at 32^3, 3 steps: within 5e-6 (RadhydroBench's bar)")
    small_runs = (
        ("Rayleigh-Taylor 3D 16x16x24", rayleigh_taylor.RayleighTaylor3DProblem,
         lambda: ParmParse.from_string(rayleigh_taylor.DECK_3D_LEAN, [
             "amr.n_cell=16 16 24", "max_timesteps=5"]), HYDRO_KEYS, (0.0, 1e-5)),
        ("Rayleigh-Taylor 3D 32^3", rayleigh_taylor.RayleighTaylor3DProblem,
         lambda: ParmParse.from_string(rayleigh_taylor.DECK_3D_FUSED, [
             "amr.n_cell=32 32 32", "max_timesteps=5"]), HYDRO_KEYS, (0.0, 1e-5)),
        ("radhydro shell 32^3 PLM", RadhydroShellProblem,
         lambda: ParmParse.from_file(str(SHELL_DECK), overrides=[
             "amr.n_cell=32 32 32", "max_timesteps=3", "verbose=0"]),
         HYDRO_KEYS + ("rad_stage1", "rad_stage2"), (5e-6, 5e-6)))
    for title, prob, make_pp, need, (rtol, atol) in small_runs:
        fin = {}
        for dev in ("cuda", "cpu"):
            reset_counts()
            sim = Simulation(prob(), make_pp(), device=dev)
            sim.set_initial_conditions()
            sim.evolve()
            fin[dev] = sim.U.double().cpu()
            counts = read_counts()
            extra = ""
            if sim.layout.n_scalars:
                frac = fin[dev][6] / fin[dev][0]
                extra = f", s/rho in [{float(frac.min()):.6e}, {float(frac.max()):.6e}]"
            print(f"  {title} {dev}: {sim.istep} steps, t {sim.t:.9e}, FOFC "
                  f"{sim.fofc_fallbacks} fallbacks / {sim.fofc_cells} cells; launches "
                  + ", ".join(f"{k} {counts[k]}" for k in need) + extra)
            if dev == "cuda" and any(counts[k] <= 0 for k in need):
                raise SystemExit(f"{title}: kernels not launched on the card: {counts}")
        if any(read_counts()[k] for k in need):
            raise SystemExit(f"{title} on the CPU launched a kernel")
        gpu_vs_cpu(fin["cuda"], fin["cpu"], f"{title} GPU vs CPU", rtol, atol)
    del fin, sim

    section("-- the lean step forced (QUOKKA_PALLAS_LEAN=1) with one passive scalar, one step "
          "of a rough 32^3 state with FOFC in both stages: GPU vs CPU")
    os.environ["QUOKKA_PALLAS_LEAN"] = "1"
    sc_opts = dataclasses.replace(opts, dx=(1.0 / 32,) * 3, n_scalars=1)
    U_sc = kernel_check.with_scalar_rows(state_from_numpy(rough_state(32), "cpu"), sc_opts, 3)
    reset_counts()
    steps = {dev: advance_hydro_rk2(U_sc.to(dev), 0.2 / 32, sc_opts, None, (0, 0, 0),
                                    (True, False, False), bc_kinds=mixed)
             for dev in ("cuda", "cpu")}
    lean_count = sweep.launch_counts["axis_flux_lean"]
    (Ug, sg), (Uc, sc) = steps["cuda"], steps["cpu"]
    ok, max_abs, max_rel = kernel_check.compare(Ug.cpu(), Uc)
    print(f"  {'ok  ' if ok else 'FAIL'} rough 32^3, 1 scalar: FOFC GPU {sg['fofc_fallbacks']} "
          f"fallbacks / {int(sg['n_fofc'])} cells, CPU {sc['fofc_fallbacks']} / "
          f"{int(sc['n_fofc'])}; K2c launches {lean_count}; state max_abs {max_abs:.3e} "
          f"max_rel {max_rel:.3e}")
    if not (ok and sg["fofc_fallbacks"] == 2 and lean_count > 0 and Ug.shape[0] == 7
            and (sg["fofc_fallbacks"], int(sg["n_fofc"])) == (sc["fofc_fallbacks"],
                                                              int(sc["n_fofc"]))):
        raise SystemExit("the forced lean step with a scalar disagrees between GPU and CPU")
    del os.environ["QUOKKA_PALLAS_LEAN"], steps, Ug, Uc, U_sc

    section("-- fewer than three axes on the card (plain torch, as the JAX package takes XLA): "
          "Richtmyer-Meshkov 2D 64^2 and the shocktube deck's first 5 steps in f64, GPU vs "
          "CPU within 1e-12 x each component's max, no kernel launched; the shocktube deck "
          "(decks/shocktube.in, 1024 cells, PPM, t = 0.4) f64 on the card to its end, error "
          "norm < 0.002")
    tube_deck = str(ROOT / "decks" / "shocktube.in")
    low = {}
    for dev in ("cuda", "cpu"):
        reset_counts()
        sim = Simulation(RichtmeyerMeshkovProblem(), ParmParse.from_string(
            "amr.n_cell = 64 64 1\ncfl = 0.4\nstop_time = 10.0\nmax_timesteps = 5\n"
            "verbose = 0\nprecision = double\n"), device=dev)
        sim.set_initial_conditions()
        sim.evolve()
        tube = Simulation(ShocktubeProblem(), ParmParse.from_file(
            tube_deck, overrides=["verbose=0", "max_timesteps=5"]), device=dev)
        tube.set_initial_conditions()
        tube.evolve()
        low[dev] = (sim.U.cpu(), tube.U.cpu(), sum(read_counts().values()))
        print(f"  {dev}: RM 2D {sim.istep} steps t {sim.t:.9e}; shocktube {tube.istep} steps "
              f"t {tube.t:.9e}; kernel launches {low[dev][2]}")
    gpu_vs_cpu(low["cuda"][0], low["cpu"][0], "Richtmyer-Meshkov 2D f64 GPU vs CPU", 0.0, 1e-12)
    gpu_vs_cpu(low["cuda"][1], low["cpu"][1], "shocktube 5 steps f64 GPU vs CPU", 0.0, 1e-12)
    reset_counts()
    t0 = time.perf_counter()
    tube = Simulation(ShocktubeProblem(), ParmParse.from_file(tube_deck,
                                                              overrides=["verbose=0"]))
    tube.set_initial_conditions()
    tube.evolve()
    tube_launches = sum(read_counts().values())
    print(f"  the shocktube deck on the card: {tube.istep} steps to t {tube.t:.9e} in "
          f"{time.perf_counter() - t0:.1f} s, error norm {tube.error_norm:.6e} (limit 0.002); "
          f"kernel launches {tube_launches}")
    if low["cuda"][2] != 0 or tube_launches != 0:
        raise SystemExit("a run with fewer than three axes launched a kernel")
    if not tube.error_norm < 0.002:
        raise SystemExit(f"the shocktube's error norm {tube.error_norm:.6e} is not < 0.002")
    del low, sim, tube

    section("-- RadhydroBench 32^3 f32, 3 steps: GPU vs CPU, fused (A) and per-stage (B)")
    rad_finals = {}
    for fused in (1, 0):
        for dev in ("cuda", "cpu"):
            small = ParmParse.from_string(DECK_256, [
                "amr.n_cell=32 32 32", "max_timesteps=3", "verbose=0",
                f"radiation.fused_substep={fused}"])
            sim = Simulation(RadhydroBenchProblem(), small, device=dev, precision="single")
            sim.set_initial_conditions()
            sim.evolve()
            rad_finals[fused, dev] = sim.U.double().cpu()
    for fused, cfg in ((1, "A"), (0, "B")):
        gpu_vs_cpu(rad_finals[fused, "cuda"], rad_finals[fused, "cpu"],
                   f"config {cfg} GPU vs CPU", 5e-6, 5e-6)
    gpu_vs_cpu(rad_finals[1, "cuda"], rad_finals[0, "cuda"], "GPU config A vs B", 5e-6, 5e-6)

    section("-- RadMultigroupPulse 32^3 (decks/rad_multigroup_ppl.in: 4 photon groups, PPL "
            "full spectrum), 1 step: f32 GPU (K6 over the groups) vs CPU within rtol 5e-6 + "
            "5e-6 x scale; f64 GPU vs CPU within 1e-12 x scale, no kernel launched; "
            "RadhydroPulseMGconst (64 x 1 x 1, advected) and RadhydroBB (32 x 1 x 1) f64, 3 "
            "steps, likewise")
    from quokka_tpu_torch.problems import RadhydroBBProblem, RadhydroPulseMGconstProblem

    mg_small = {}
    pulse_1d = ("geometry.prob_lo = -512.0 0.0 0.0\ngeometry.prob_hi = 512.0 1.0 1.0\n"
                "amr.n_cell = 64 1 1\ncfl = 0.8\nradiation.cfl = 0.8\nmax_timesteps = 3\n"
                "verbose = 0\n")
    bb_1d = ("geometry.prob_hi = 64.0 1.0 1.0\namr.n_cell = 32 1 1\ncfl = 0.8\n"
             "radiation.cfl = 8.0\nmax_dt = 1.0\nmax_timesteps = 3\nverbose = 0\n")
    for dev in ("cuda", "cpu"):
        for prec in ("single", "double"):
            reset_counts()
            t0 = time.perf_counter()
            sim = Simulation(RadMultigroupPulseProblem(), ParmParse.from_file(
                str(MG_DECK), overrides=["amr.n_cell = 32 32 32", "max_timesteps = 1",
                                         "verbose = 0", f"precision = {prec}"]), device=dev)
            sim.set_initial_conditions()
            sim.evolve()
            mg_small[dev, prec] = (sim.U.double().cpu(), read_counts())
            print(f"  {dev} {prec}: {sim.istep} steps t {sim.t:.9e} in "
                  f"{time.perf_counter() - t0:.1f} s; K6 launches {read_counts()['rad_div']}")
        reset_counts()
        pulse = RadhydroPulseMGconstProblem()
        pulse.v0 = 1.0e6
        for key, prob, deck in (("mgconst", pulse, pulse_1d), ("bb", RadhydroBBProblem(), bb_1d)):
            sim = Simulation(prob, ParmParse.from_string(deck), device=dev)
            sim.set_initial_conditions()
            sim.evolve()
            mg_small[dev, key] = (sim.U.cpu(), None)
        mg_small[dev, "1d launches"] = sum(read_counts().values())
    if not mg_small["cuda", "single"][1]["rad_div"] > 0:
        raise SystemExit("RadMultigroupPulse 32^3 f32 on the card launched no K6")
    gpu_vs_cpu(mg_small["cuda", "single"][0], mg_small["cpu", "single"][0],
               "RadMultigroupPulse 32^3 f32 GPU vs CPU", 5e-6, 5e-6)
    gpu_vs_cpu(mg_small["cuda", "double"][0], mg_small["cpu", "double"][0],
               "RadMultigroupPulse 32^3 f64 GPU vs CPU", 0.0, 1e-12)
    gpu_vs_cpu(mg_small["cuda", "mgconst"][0], mg_small["cpu", "mgconst"][0],
               "RadhydroPulseMGconst 64 x 1 x 1 f64 GPU vs CPU", 0.0, 1e-12)
    gpu_vs_cpu(mg_small["cuda", "bb"][0], mg_small["cpu", "bb"][0],
               "RadhydroBB 32 x 1 x 1 f64 GPU vs CPU", 0.0, 1e-12)
    launched = {k: v for k, v in mg_small["cuda", "double"][1].items() if v}
    if launched or mg_small["cuda", "1d launches"]:
        raise SystemExit(f"a float64 multigroup run on the card launched a kernel: {launched}, "
                         f"{mg_small['cuda', '1d launches']} in the 1D runs")
    del mg_small, sim

    section("-- Orszag-Tang 32^3 f32, 5 steps: GPU (K8) vs CPU, windowed and host loops")
    mhd_finals = {}
    for verbose in (0, 1):
        for dev in ("cuda", "cpu"):
            small = ParmParse.from_string(mhd.DECK_256, [
                "amr.n_cell=32 32 32", "max_timesteps=5", f"verbose={verbose}"])
            sim = MHDSimulation(mhd.OrszagTangProblem(), small, precision="single", device=dev)
            sim.set_initial_conditions()
            sim.evolve()
            mhd_finals[verbose, dev] = torch.cat([sim.U, torch.stack(sim.Bf)]).double().cpu()
            print(f"  verbose={verbose} {dev}: {sim.istep} steps, t {sim.t:.9e}, "
                  f"max |div B| {sim.final_divb:.3e}")
    for verbose, loop in ((0, "windowed"), (1, "host")):
        gpu_vs_cpu(mhd_finals[verbose, "cuda"], mhd_finals[verbose, "cpu"],
                   f"{loop} loop GPU vs CPU", 3e-5, 3e-5,
                   groups=[[0], [1, 2, 3], [4], [5, 6, 7]])

    section("-- AMR radhydro shell 32^3 + 1 level f32, 2 coarse steps (regrid_interval 1: a "
          "regrid of level 1 opens the second): GPU vs CPU, per level")
    amr_finals = {}
    for dev in ("cuda", "cpu"):
        small = ParmParse.from_string(radhydro_shell.DECK_256, [
            "amr.n_cell=32 32 32", "max_timesteps=2", "regrid_interval=1", "verbose=0"])
        sim = AMRSimulation(radhydro_shell.RadhydroShellProblem(), small, device=dev)
        sim.set_initial_conditions()
        sim.evolve()
        amr_finals[dev] = ([u.double().cpu() for u in sim.level_U[:sim.finest_level + 1]],
                           [m.cpu() for m in sim.level_mask[:sim.finest_level + 1]])
        print(f"  {dev}: finest level {sim.finest_level}, active cells "
              f"{[sim._active_cells(l) for l in range(sim.finest_level + 1)]}, t {sim.t:.9e}, "
              f"mass rel err {sim.conservation_rel_err[0]:.3e}")
    (Ug_l, mg_l), (Uc_l, mc_l) = amr_finals["cuda"], amr_finals["cpu"]
    if len(Ug_l) != len(Uc_l) or not all(torch.equal(a, b) for a, b in zip(mg_l, mc_l)):
        raise SystemExit("AMR 32^3: the GPU and CPU level masks differ")
    for lev, (a, b) in enumerate(zip(Ug_l, Uc_l)):
        gpu_vs_cpu(a, b, f"AMR level {lev} GPU vs CPU", 5e-6, 5e-6)
    del amr_finals, Ug_l, Uc_l

    section("-- float64 on the card (the JAX package's XLA formulations): Sedov 32^3, 5 "
          "steps, padded classic with reflecting walls; Orszag-Tang 32^3, 5 steps, K8's "
          "plain form; GPU vs CPU within 1e-12 x each component's max")
    f64 = {}
    for dev in ("cuda", "cpu"):
        reset_counts()
        small = ParmParse.from_file(str(DECK), overrides=[
            "amr.n_cell=32 32 32", "max_timesteps=5", "verbose=0"])
        sim = Simulation(SedovProblem(), small, device=dev, precision="double")
        sim.set_initial_conditions()
        sim.evolve()
        mpp32 = ParmParse.from_string(mhd.DECK_256, ["amr.n_cell=32 32 32",
                                                     "max_timesteps=5", "verbose=0"])
        msim = MHDSimulation(mhd.OrszagTangProblem(), mpp32, precision="double", device=dev)
        msim.set_initial_conditions()
        msim.evolve()
        f64[dev] = (sim.U.cpu(), torch.cat([msim.U, torch.stack(msim.Bf)]).cpu(),
                    sum(read_counts().values()))
        print(f"  {dev}: Sedov {sim.istep} steps t {sim.t:.9e}; Orszag-Tang {msim.istep} "
              f"steps t {msim.t:.9e}; kernel launches {f64[dev][2]}")
    gpu_vs_cpu(f64["cuda"][0], f64["cpu"][0], "Sedov f64 GPU vs CPU", 0.0, 1e-12)
    gpu_vs_cpu(f64["cuda"][1], f64["cpu"][1], "Orszag-Tang f64 GPU vs CPU", 0.0, 1e-12,
               groups=[[0], [1, 2, 3], [4], [5, 6, 7]])
    if f64["cuda"][2] != 0:
        raise SystemExit("a float64 run on the card launched a float32 kernel")
    del f64, sim, msim

    section("-- float64 radiation on the card (the plain versions of K4-K7, as the JAX "
          "package takes XLA): RadhydroBench 32^3, 2 steps, configs A and B; the dense "
          "AMR shell 16^3 + 1 level, 1 coarse step; GPU vs CPU within 1e-12 x each "
          "component's max, no kernel launched on the card")
    rad64 = {}
    for dev in ("cuda", "cpu"):
        for fused in (1, 0):
            reset_counts()
            small = ParmParse.from_string(DECK_256, [
                "amr.n_cell=32 32 32", "max_timesteps=2", "verbose=0",
                f"radiation.fused_substep={fused}"])
            sim = Simulation(RadhydroBenchProblem(), small, device=dev, precision="double")
            sim.set_initial_conditions()
            sim.evolve()
            rad64[fused, dev] = (sim.U.cpu(), read_counts())
            print(f"  RadhydroBench {dev} fused_substep={fused}: {sim.istep} steps, "
                  f"t {sim.t:.9e}, dtype {sim.U.dtype}")
        reset_counts()
        small = ParmParse.from_string(radhydro_shell.DECK_256, [
            "amr.n_cell=16 16 16", "max_timesteps=1", "verbose=0", "precision=double"])
        sim = AMRSimulation(radhydro_shell.RadhydroShellProblem(), small, device=dev)
        sim.set_initial_conditions()
        sim.evolve()
        rad64["shell", dev] = ([u.cpu() for u in sim.level_U[:sim.finest_level + 1]],
                               [m.cpu() for m in sim.level_mask[:sim.finest_level + 1]],
                               read_counts())
        print(f"  AMR shell {dev}: finest level {sim.finest_level}, t {sim.t:.9e}, "
              f"dtype {sim.level_U[0].dtype}")
    launched = {what: {k: v for k, v in rad64[what, "cuda"][-1].items() if v}
                for what in (1, 0, "shell")}
    print(f"  kernel launches on the card: {launched}")
    for fused, cfg in ((1, "A"), (0, "B")):
        gpu_vs_cpu(rad64[fused, "cuda"][0], rad64[fused, "cpu"][0],
                   f"RadhydroBench f64 config {cfg} GPU vs CPU", 0.0, 1e-12)
    (Ug_l, mg_l, _), (Uc_l, mc_l, _) = rad64["shell", "cuda"], rad64["shell", "cpu"]
    if len(Ug_l) != len(Uc_l) or not all(torch.equal(a, b) for a, b in zip(mg_l, mc_l)):
        raise SystemExit("AMR shell f64: the GPU and CPU level masks differ")
    for lev, (a, b) in enumerate(zip(Ug_l, Uc_l)):
        gpu_vs_cpu(a, b, f"AMR shell f64 level {lev} GPU vs CPU", 0.0, 1e-12)
    if any(launched.values()):
        raise SystemExit(f"a float64 radiation run on the card launched a kernel: {launched}")
    del rad64, sim, Ug_l, Uc_l

    section("-- packed AMR, GPU vs CPU per level, equal tile sets and FOFC counts: the "
          "hydro bump 32^3 + 1 packed level f32, 2 coarse steps (the seeded root, K2e); "
          "the bump 32^3 + 2 packed levels f32, 2 coarse steps with regrid_interval 1 "
          "(average-down and reflux into a packed parent, pool backdrops, the packed "
          "regrid of level 2, the root's regrid with the grandchild pins); the radhydro "
          "shell 32^3 + 1 packed level f32, 1 coarse step")
    shell32 = radhydro_shell.DECK_256_PACKED.replace("256 256 256", "32 32 32").replace(
        "amr.max_level = 2", "amr.max_level = 1")
    bump2 = BUMP_DECK.replace("amr.max_level = 1", "amr.max_level = 2") + "regrid_interval = 1\n"
    for title, prob, deck, nsteps in (
            ("bump", _bump_problem(), BUMP_DECK, 2),
            ("bump 2 levels", _bump_problem(), bump2, 2),
            ("shell", radhydro_shell.RadhydroShellProblem(), shell32, 1)):
        runs = {}
        for dev in ("cuda", "cpu"):
            reset_counts()
            sim = AMRSimulation(prob, ParmParse.from_string(deck, [
                f"max_timesteps={nsteps}", "verbose=0", "amr.packed_chunk=8",
                "amr.pool_chunk=8"]), device=dev, precision="single")
            sim.set_initial_conditions()
            sim.evolve()
            rows, tiles = [], []
            for st in sim.level_pool[1:sim.finest_level + 1]:
                n = st.meta.n_active
                rows.append(torch.cat([st.Uh[:n], st.Ur[:n]], 1).double().cpu()
                            if st.Ur is not None else st.Uh[:n].double().cpu())
                tiles.append(st.meta.ijk[:n].copy())
            runs[dev] = (sim.level_U[0].double().cpu(), rows, tiles, sim.fofc_cells,
                         sim.fofc_fallbacks)
            counts = read_counts()
            print(f"  {title} {dev}: tiles {[len(t) for t in tiles]}, t {sim.t:.9e}, FOFC "
                  f"{sim.fofc_fallbacks} fallbacks / {sim.fofc_cells} cells, launches K2e "
                  f"{counts['axis_flux_corr']} K9 {counts['row_gather']} K2 "
                  f"{counts['axis_flux']} K7 {counts['rad_axis_flux']}")
        (Ug, Pg, ig, fg, bg), (Uc, Pc, ic, fc, bc_) = runs["cuda"], runs["cpu"]
        if not (len(ig) == len(ic) and all(a.shape == b.shape and (a == b).all()
                                           for a, b in zip(ig, ic))
                and (fg, bg) == (fc, bc_)):
            raise SystemExit(f"packed {title}: GPU and CPU tile sets or FOFC counts differ")
        if title == "bump 2 levels" and len(ig) != 2:
            raise SystemExit(f"packed {title}: {len(ig)} pool levels, expected 2")
        gpu_vs_cpu(Ug, Uc, f"packed {title} root GPU vs CPU", 5e-6, 5e-6)
        for lev, (a, b) in enumerate(zip(Pg, Pc), start=1):
            gpu_vs_cpu(a.transpose(0, 1), b.transpose(0, 1),
                       f"packed {title} level {lev} GPU vs CPU", 5e-6, 5e-6)
        del runs, sim, st
    release()

    # ---- 5. the hydro main path
    phase("5. main path 1: Sedov 256^3 f32, 10 steps, decks/benchmark_unigrid_256.in")
    pp = ParmParse.from_file(str(DECK), overrides=["max_timesteps=10", "verbose=1"])
    sim = Simulation(SedovProblem(), pp, device="cuda")
    sim.set_initial_conditions()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sim.evolve()
    sedov_launches = read_counts()
    print(f"FOM: {sim.zone_updates_per_second / 1e6:.3f} Mzone-updates/s over "
          f"{sim.istep} steps ({sim.elapsed_walltime:.3f} s wall, first step included) "
          f"on {smi}")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rel = sim.conservation_rel_err
    print(f"conservation: mass rel err {rel[0]:.3e}, energy rel err {rel[4]:.3e}")
    print(f"FOFC: {sim.fofc_fallbacks} stage fallbacks, {sim.fofc_cells} invalid cells")
    print(f"launches in the main path: {sedov_launches}")
    finite = bool(torch.isfinite(sim.U).all())
    if sim.istep != 10 or not finite:
        raise SystemExit(f"main path: {sim.istep} steps, finite state {finite}")
    if not abs(rel[0]) < 1e-5:
        raise SystemExit(f"mass conservation error {rel[0]:.3e} >= 1e-5")
    missing = [k for k in HYDRO_KEYS if sedov_launches[k] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the Sedov path: {missing}")
    del sim
    bench = Simulation(SedovProblem(), pp, device="cuda")
    mz_bench, secs = bench_hydro(bench, n_warmup=2, n_steps=10)
    print(f"bench_hydro (dt on the device, 10 steps after 2): {mz_bench:.3f} "
          f"Mzone-updates/s ({secs:.3f} s) on {smi}")
    del bench
    release()

    # ---- 6. the radhydro main path
    rad_launches = {}
    for fused, cfg, nsteps, need in ((1, "A (fused substep, K4)", 10,
                                      HYDRO_KEYS + ("rad_stage1", "rad_stage2")),
                                     (0, "B (per stage, K5 + K6)", 2,
                                      HYDRO_KEYS + ("rad_source", "rad_div"))):
        phase(f"6. main path 2: RadhydroBench 256^3 f32, config {cfg}, {nsteps} steps")
        rpp = ParmParse.from_string(DECK_256, [f"max_timesteps={nsteps}", "verbose=1",
                                               f"radiation.fused_substep={fused}"])
        sim = Simulation(RadhydroBenchProblem(), rpp, device="cuda", precision="single")
        sim.set_initial_conditions()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        sim.evolve()
        launches = read_counts()
        nsub = sim._radiation.n_substeps(sim.dt_prev)
        rel = sim.conservation_rel_err
        finite = bool(torch.isfinite(sim.U).all())
        print(f"FOM: {sim.zone_updates_per_second / 1e6:.3f} hydro Mzone-updates/s over "
              f"{sim.istep} steps ({sim.elapsed_walltime:.3f} s wall, first step "
              f"included), {nsub} radiation substeps a step, on {smi}")
        print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print(f"conservation: mass rel err {rel[0]:.3e}; finite state {finite}")
        print(f"launches in this path: {launches}")
        if sim.istep != nsteps or not finite:
            raise SystemExit(f"radhydro config {cfg}: {sim.istep} steps, finite {finite}")
        if not abs(rel[0]) < 1e-5:
            raise SystemExit(f"mass conservation error {rel[0]:.3e} >= 1e-5")
        missing = [k for k in need if launches[k] <= 0]
        if missing:
            raise SystemExit(f"kernels not launched on radhydro config {cfg}: {missing}")
        rad_launches.update({k: launches[k] for k in need if k not in HYDRO_KEYS})
        del sim
        release()
    bench = Simulation(RadhydroBenchProblem(), ParmParse.from_string(DECK_256, ["verbose=0"]),
                       device="cuda", precision="single")
    mz_rad, secs, nsub = bench_radhydro(bench, n_warmup=1, n_steps=3)
    print(f"bench_radhydro (fixed dt, {nsub} substeps a step, 3 steps after 1): "
          f"{mz_rad:.3f} hydro Mzone-updates/s ({secs:.3f} s) on {smi}")
    del bench
    release()

    # ---- 7. the MHD main path
    phase("7. main path 3: Orszag-Tang MHD 256^3 f32, 20 steps, windowed loop "
          "(bench.py:310-318 deck)")
    mpp = ParmParse.from_string(mhd.DECK_256, ["max_timesteps=20", "verbose=0"])
    sim = MHDSimulation(mhd.OrszagTangProblem(), mpp, precision="single")
    sim.set_initial_conditions()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sim.evolve()
    mhd_launches = read_counts()
    rel = sim.conservation_rel_err
    finite = bool(torch.isfinite(sim.U).all()) and all(bool(torch.isfinite(b).all())
                                                       for b in sim.Bf)
    print(f"FOM: {sim.zone_updates_per_second / 1e6:.3f} Mzone-updates/s over "
          f"{sim.istep} steps ({sim.elapsed_walltime:.3f} s wall, first step included, "
          f"t = {sim.t:.6e}) on {smi}")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"conservation: mass rel err {rel[0]:.3e}, energy rel err {rel[4]:.3e}; "
          f"max |div B| {sim.final_divb:.3e} (initial {sim.init_divb:.3e}); finite {finite}")
    print(f"launches in this path: {mhd_launches}")
    if sim.istep != 20 or not finite:
        raise SystemExit(f"MHD main path: {sim.istep} steps, finite state {finite}")
    if not (abs(rel[0]) < 1e-5 and abs(rel[4]) < 1e-5):
        raise SystemExit(f"MHD conservation error: mass {rel[0]:.3e}, energy {rel[4]:.3e}")
    # CT leaves div B at the roundoff of the f32 face values: max |div B| x dx
    # read 12-13 float32 ulps of max |B_face| after 20 steps at 32^3-128^3
    # in the port and 9.5-19 in the JAX package's XLA form at 32^3-64^3
    # (tests/port/divb_witness.py), so max |div B| itself grows as 1/dx.
    # The JAX package's literal 1e-4 was set on a 32^2 grid for one step.
    divb_ulps = sim.divb_ulps()
    print(f"max |div B| {sim.final_divb:.4e} = {divb_ulps:.2f} float32 ulps of max |B_face| "
          f"over dx (limit {DIVB_ULPS} ulps)")
    if not divb_ulps < DIVB_ULPS:
        raise SystemExit(f"MHD max |div B| {sim.final_divb:.3e} is {divb_ulps:.2f} ulps "
                         f"over dx, not < {DIVB_ULPS}")
    if mhd_launches["mhd_axis"] != 6 * 20:
        raise SystemExit(f"K8 launched {mhd_launches['mhd_axis']} times, not 6 a step")
    del sim
    release()
    bench = MHDSimulation(mhd.OrszagTangProblem(), ParmParse.from_string(mhd.DECK_256),
                          precision="single")
    mz_mhd, secs = bench_mhd(bench, n_warmup=2, n_steps=10)
    print(f"bench_mhd (windowed loop, 10 steps after 2): {mz_mhd:.3f} Mzone-updates/s "
          f"({secs:.3f} s) on {smi}")

    del bench
    release()

    # ---- 8. the dense AMR main path
    phase("8. main path 4: dense AMR radhydro shell 256^3 + 1 level f32, 1 warm-up and "
          "1 timed coarse step (bench.py:192-207 deck)")
    sim = AMRSimulation(radhydro_shell.RadhydroShellProblem(),
                        ParmParse.from_string(radhydro_shell.DECK_256, ["verbose=1"]))
    print(f"held before the path: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sim.set_initial_conditions()
    mz_active, mz_raw, secs = bench_amr_shell(sim, n_warmup=1, n_steps=1)
    amr_launches = read_counts()
    rel = sim.conservation_rel_err
    finite = all(bool(torch.isfinite(sim.level_U[lev]).all())
                 for lev in range(sim.finest_level + 1))
    active = [sim._active_cells(lev) for lev in range(sim.finest_level + 1)]
    print(f"FOM: {mz_active:.3f} active Mzone-updates/s, raw {mz_raw:.3f} Mzone-updates/s "
          f"(every cell of the dense levels), 1 coarse step in {secs:.3f} s after 1, "
          f"t = {sim.t:.6e}, on {smi}")
    print(f"finest level {sim.finest_level}; active cells per level {active} of "
          f"{[g.num_cells for g in sim.level_grids[:sim.finest_level + 1]]}; "
          f"FOFC stage fallbacks {sim.fofc_fallbacks}")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"allocated, {torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved "
          f"(PYTORCH_CUDA_ALLOC_CONF={os.environ.get('PYTORCH_CUDA_ALLOC_CONF')})")
    print(f"composite conservation: mass rel err {rel[0]:.3e}, gas energy rel err "
          f"{rel[4]:.3e}; finite states {finite}")
    print(f"launches in this path: " + ", ".join(f"{k} {amr_launches[k]}" for k in AMR_KEYS))
    if sim.istep != 2 or sim.finest_level != 1 or not finite:
        raise SystemExit(f"AMR main path: {sim.istep} coarse steps, finest level "
                         f"{sim.finest_level}, finite states {finite}")
    if not abs(rel[0]) < 1e-5:
        raise SystemExit(f"AMR composite mass conservation error {rel[0]:.3e} >= 1e-5")
    missing = [k for k in AMR_KEYS if amr_launches[k] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the AMR path: {missing}")
    del sim
    release()

    # ---- 9. the lean hydro main path
    phase("9. main path 5: Sedov 512^3 f32, 10 steps, lean branch (bench.py:76-84 deck)")
    sim = Simulation(SedovProblem(), ParmParse.from_string(DECK_512, [
        "max_timesteps=10", "verbose=1"]), device="cuda")
    print(f"held before the path: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    sim.set_initial_conditions()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sim.evolve()
    lean_launches = read_counts()
    rel = sim.conservation_rel_err
    finite = bool(torch.isfinite(sim.U).all())
    print(f"FOM: {sim.zone_updates_per_second / 1e6:.3f} Mzone-updates/s over {sim.istep} "
          f"steps ({sim.elapsed_walltime:.3f} s wall, {sim.elapsed_walltime / sim.istep * 1e3:.3f} "
          f"ms a step, first step included) on {smi}")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"conservation: mass rel err {rel[0]:.3e}, energy rel err {rel[4]:.3e}; "
          f"finite state {finite}")
    print(f"FOFC: {sim.fofc_fallbacks} stage fallbacks, {sim.fofc_cells} invalid cells")
    print(f"launches in this path: {lean_launches}")
    if sim.istep != 10 or not finite:
        raise SystemExit(f"lean main path: {sim.istep} steps, finite state {finite}")
    if not (abs(rel[0]) < 1e-5 and abs(rel[4]) < 1e-5):
        raise SystemExit(f"lean path conservation error: mass {rel[0]:.3e}, "
                         f"energy {rel[4]:.3e}")
    missing = [k for k in LEAN_KEYS if lean_launches[k] <= 0]
    stray = [k for k in ("axis_flux", "axis_flux_avg", "apply_update") if lean_launches[k]]
    if missing or stray:
        raise SystemExit(f"lean path: kernels not launched {missing}, other K2/K3 "
                         f"variants launched {stray}")
    del sim
    release()
    bench = Simulation(SedovProblem(), ParmParse.from_string(DECK_512), device="cuda")
    mz_lean, secs = bench_hydro(bench, n_warmup=2, n_steps=10)
    print(f"bench_hydro at 512^3 (dt on the device, 10 steps after 2): {mz_lean:.3f} "
          f"Mzone-updates/s ({secs:.3f} s) on {smi}")
    del bench
    release()

    # ---- 10. the packed AMR main path
    # chunks of CARD_PACKED_CHUNK (512) tiles where the deck, the JAX bench's,
    # has 64: at 64 the host's launch rate bounds a coarse step, which this
    # script's time cannot afford (radhydro_shell.CARD_PACKED_CHUNK)
    phase("10. main path 6: the reference's AMR benchmark, radhydro shell 256^3 + 2 packed "
          "16^3-tile pool levels f32, 1 coarse step, timed with its first-step costs "
          "(bench.py:163-207 "
          "deck, DECK_256_PACKED, with amr.packed_chunk = 512)")
    sim = AMRSimulation(radhydro_shell.RadhydroShellProblem(),
                        ParmParse.from_string(radhydro_shell.DECK_256_PACKED, [
                            "verbose=1",
                            f"amr.packed_chunk={radhydro_shell.CARD_PACKED_CHUNK}"]))
    print(f"held before the path: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.set_initial_conditions()
    torch.cuda.synchronize()
    print(f"initial conditions and the two pool levels built in "
          f"{time.perf_counter() - t0:.3f} s")
    # the K5 inputs of the coarse step's first level-2 chunk (both stages),
    # cloned as the chunk runs: phase 11 holds K5 to its plain version on
    # them, the shell's own mix of Newton iterations
    shell_k5 = {}
    level_subcycle, coupling = psweep.fused_rad_subcycle_packed, rsource.source_update_batched

    def subcycle_capture(*args, **kw):
        shell_k5["on"] = args[9] is sim.level_pool[2].meta and "stage2" not in shell_k5
        return level_subcycle(*args, **kw)

    def coupling_capture(gas, rad, src, dt, stage, *args, keep=None, out=None):
        got = coupling(gas, rad, src, dt, stage, *args, keep=keep, out=out)
        if shell_k5.get("on") and f"stage{stage}" not in shell_k5 and (
                stage == 1 or "stage1" in shell_k5):
            shell_k5[f"stage{stage}"] = dict(
                gas=gas.clone() if stage == 1 else None, rad=rad.clone(),
                src=None if src is None else src.clone(), keep=keep, dt=dt,
                gas1=got[0].clone() if stage == 1 else None, args=args)
        return got

    psweep.fused_rad_subcycle_packed = subcycle_capture
    rsource.source_update_batched = coupling_capture
    try:
        reset_counts()
        mz_packed, mz_packed_raw, secs = bench_amr_shell(sim, n_warmup=0, n_steps=1)
        packed_launches = read_counts()
    finally:
        psweep.fused_rad_subcycle_packed = level_subcycle
        rsource.source_update_batched = coupling
    rel = sim.conservation_rel_err
    finite = bool(torch.isfinite(sim.level_U[0]).all()) and all(
        bool(torch.isfinite(st.Uh[:st.meta.n_active]).all())
        and bool(torch.isfinite(st.Ur[:st.meta.n_active]).all())
        for st in sim.level_pool[1:sim.finest_level + 1])
    print(f"FOM: {mz_packed:.3f} active Mzone-updates/s, raw {mz_packed_raw:.3f} "
          f"Mzone-updates/s (the root's cells and the pools' tiles), 1 coarse step in "
          f"{secs:.3f} s, the first, t = {sim.t:.6e}, on {smi} (the reference's 4 x V100 "
          "figure: 4.95 Mzones/GPU/s)")
    for lev in range(1, sim.finest_level + 1):
        st = sim.level_pool[lev]
        print(f"pool level {lev}: {st.meta.n_active} active tiles of capacity "
              f"{st.meta.capacity}, {st.meta.active_cells} active cells, "
              f"{st.nbytes() / 2**30:.2f} GiB of rows")
    print(f"finest level {sim.finest_level}; FOFC stage fallbacks {sim.fofc_fallbacks}, "
          f"invalid cells {sim.fofc_cells}")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"allocated, {torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved")
    print(f"composite conservation: mass rel err {rel[0]:.3e}, gas energy rel err "
          f"{rel[4]:.3e}; finite states {finite}")
    print("launches in this path: " + ", ".join(f"{k} {packed_launches[k]}"
                                                 for k in PACKED_KEYS))
    if sim.istep != 1 or sim.finest_level != 2 or not finite:
        raise SystemExit(f"packed AMR main path: {sim.istep} coarse steps, finest level "
                         f"{sim.finest_level}, finite states {finite}")
    if not abs(rel[0]) < 1e-5:
        raise SystemExit(f"packed AMR composite mass conservation error {rel[0]:.3e} >= 1e-5")
    missing = [k for k in PACKED_KEYS if packed_launches[k] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the packed AMR path: {missing}")
    del sim
    release()

    # ---- 11. K5 on the packed shell's own chunk
    phase("11. K5 on main path 6's first level-2 chunk (captured in its coarse step): "
          "stage 1 on the 2g-deep blocks with the ring mask, stage 2 on the crop, "
          "written into pool rows")
    if "stage2" not in shell_k5:
        raise SystemExit("main path 6 ran no level-2 chunk's coupling")
    s1, s2 = shell_k5["stage1"], shell_k5["stage2"]
    g = (s1["gas"].shape[-1] - s2["rad"].shape[-1]) // 2
    pools = (torch.empty((s1["gas"].shape[0] + 1, 6) + tuple(s2["rad"].shape[2:]),
                         device="cuda"),
             torch.empty((s1["gas"].shape[0] + 1, 4) + tuple(s2["rad"].shape[2:]),
                         device="cuda"))
    rows = slice(1, None)
    k5_aside = new_summary()
    k5_cases = list(kernel_check.k5_batched_cases(
        s1["gas"], s1["rad"], s1["src"], s1["keep"], s1["dt"], 1, *s1["args"][:3],
        tag=f" shell chunk {tuple(s1['rad'].shape[:1] + s1['rad'].shape[2:])}"))
    k5_cases += list(kernel_check.k5_batched_cases(
        psweep._crop(s1["gas1"], g), s2["rad"], s2["src"], None, s2["dt"], 2, *s2["args"][:3],
        tag=f" shell chunk {tuple(s2['rad'].shape[:1] + s2['rad'].shape[2:])}",
        out=(pools[0][rows], pools[1][rows])))
    run_cases(f"K5 batched on the shell's level-2 chunk ({int(s1['keep'].sum())} real "
              f"cells of {s1['keep'].numel()} at stage 1)", k5_cases, lambda c: True,
              k5_aside, failed)
    a = k5_aside["rad_source"]
    summary["rad_source"]["max_abs_err"] = max(summary["rad_source"]["max_abs_err"],
                                               a["max_abs_err"])
    print(f"  K5 at the shell's level-2 chunk, both stages: kernel {a['ms']:.3f} ms, plain "
          f"{a['plain_ms']:.3f} ms, bound {a['bound_ms']:.3f} ms ({a['bytes'] / 1e9:.3f} GB, "
          f"{a['ops'] / 1e9:.2f} GFLOP), library none")
    del shell_k5, s1, s2, pools, k5_cases
    release()

    # ---- 12, 13. the outflow and user walls' main paths
    for num, title, prob, deck in (
            (12, "main path 7: ShockCloud 256^3 f32, 10 steps, hybrid ghost-free (x padded by "
             "the inflow hook: user x-lo, outflow x-hi; y, z periodic)",
             shock_cloud.ShockCloudProblem(), shock_cloud.DECK_256),
            (13, "main path 8: Richtmyer-Meshkov 256 x 256 x 64 f32, 10 steps, outflow x walls "
             "assembled in the kernels (K1's chi planes read by every K2 sweep)",
             RichtmeyerMeshkovProblem(), DECK_RM_3D)):
        phase(f"{num}. {title}")
        sim = Simulation(prob, ParmParse.from_string(deck, ["max_timesteps=10", "verbose=1"]),
                         device="cuda")
        held = torch.cuda.memory_allocated() / 2**30
        print(f"held before the path: {held:.2f} GiB; stepping: ng {sim._gf['ng']}, walls "
              f"{sim._gf['bc_kinds']}")
        sim.set_initial_conditions()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        sim.evolve()
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        nsteps, wall, fofc = sim.istep, sim.elapsed_walltime, (sim.fofc_fallbacks,
                                                                sim.fofc_cells)
        finite = bool(torch.isfinite(sim.U).all())
        rho_min = float(sim.U[0].min())
        if nsteps != 10 or not finite or not rho_min > 0.0:
            raise SystemExit(f"main path {num}: {nsteps} steps, finite state {finite}, "
                             f"min density {rho_min:.3e}")
        # one more step under the profiler: its device time by kernel
        by_kernel, _ = step_profile.device_ms(step_profile._parts(sim)["step"], 1)
        dev_ms = sum(by_kernel.values())
        print(f"wall time: {wall / nsteps * 1e3:.3f} ms a step over {nsteps} steps "
              f"({wall:.3f} s, first step included), FOM "
              f"{sim.zone_updates_per_second / 1e6:.3f} Mzone-updates/s, on {smi}")
        print(f"device time of one more step (torch.profiler; FOFC fallbacks "
              f"{sim.fofc_fallbacks - fofc[0]} in it): {dev_ms:.3f} ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_kernel.items(),
                                                             key=lambda kv: -kv[1])))
        print(f"peak device memory: {peak:.2f} GiB ({peak - held:.2f} GiB above what the "
              "phases before held)")
        print(f"FOFC: {fofc[0]} stage fallbacks, {fofc[1]} invalid cells in {nsteps} steps; "
              f"min density {rho_min:.6e}; finite state {finite}")
        print(f"launches in this path: {launches}")
        missing = [k for k in HYDRO_KEYS if launches[k] <= 0]
        unprofiled = [k for k in ("K1", "K2", "K3") if by_kernel.get(k, 0.0) <= 0.0]
        if missing or unprofiled:
            raise SystemExit(f"main path {num}: kernels not launched {missing}, not in the "
                             f"profiled step {unprofiled}")
        del sim
        release()

    # ---- 14, 15, 16. the scalar and PLM main paths
    form_launches = {}
    for num, key, title, prob, pp_path, need in (
            (14, "rt lean", "main path 9: Rayleigh-Taylor 3D 256 x 256 x 384 f32, 10 steps, one "
             "passive scalar, external gravity, periodic x/y, reflecting z (the JAX test's "
             "domain; the lean step: K1 + K2c)", rayleigh_taylor.RayleighTaylor3DProblem(),
             ParmParse.from_string(rayleigh_taylor.DECK_3D_LEAN, ["verbose=1"]), LEAN_KEYS),
            (15, "rt fused", "main path 10: Rayleigh-Taylor 3D 256^3 f32 on [-0.375, 0.375]^3, "
             "10 steps (the fused step: K1, K2, K3)", rayleigh_taylor.RayleighTaylor3DProblem(),
             ParmParse.from_string(rayleigh_taylor.DECK_3D_FUSED, ["verbose=1"]), HYDRO_KEYS),
            (16, "shell", "main path 11: the radhydro shell's unigrid PLM deck "
             "(decks/radhydro_shell_256.in) 256^3 f32, 10 steps (K1 dmin only, K2 PLM, K3, K4 "
             "PLM)", RadhydroShellProblem(),
             ParmParse.from_file(str(SHELL_DECK), overrides=["max_timesteps=10", "verbose=1"]),
             HYDRO_KEYS + ("rad_stage1", "rad_stage2"))):
        phase(f"{num}. {title}")
        sim = Simulation(prob, pp_path, device="cuda")
        held = torch.cuda.memory_allocated() / 2**30
        o = sim.hydro_opts
        print(f"held before the path: {held:.2f} GiB; stepping: ng {sim._gf['ng']}, walls "
              f"{sim._gf['bc_kinds']}; reconstruction_order {o.reconstruction_order}, "
              f"scalars {o.n_scalars}")
        sim.set_initial_conditions()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        sim.evolve()
        launches = read_counts()
        form_launches[key] = launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        nsteps, wall, fofc = sim.istep, sim.elapsed_walltime, (sim.fofc_fallbacks,
                                                                sim.fofc_cells)
        finite = bool(torch.isfinite(sim.U).all())
        rho_min = float(sim.U[0].min())
        if nsteps != 10 or not finite or not rho_min > 0.0:
            raise SystemExit(f"main path {num}: {nsteps} steps, finite state {finite}, "
                             f"min density {rho_min:.3e}")
        scalar_line = ""
        if o.n_scalars:
            frac = sim.U[6] / sim.U[0]
            lo, hi = float(frac.min()), float(frac.max())
            scalar_line = f"; the scalar's s/rho in [{lo:.9e}, {hi:.9e}]"
            # reconstruction may overshoot the fraction by O(1e-4) at the
            # interface (tests/test_rayleigh_taylor.py:84-86)
            if not (lo > -1e-4 and hi < 1.0 + 1e-4):
                raise SystemExit(f"main path {num}: s/rho in [{lo:.3e}, {hi:.3e}]")
        # one more step under the profiler: its device time by kernel
        by_kernel, _ = step_profile.device_ms(step_profile._parts(sim)["step"], 1)
        dev_ms = sum(by_kernel.values())
        print(f"wall time: {wall / nsteps * 1e3:.3f} ms a step over {nsteps} steps "
              f"({wall:.3f} s, first step included), FOM (hydro zone-updates) "
              f"{sim.zone_updates_per_second / 1e6:.3f} Mzone-updates/s, on {smi}")
        print(f"device time of one more step (torch.profiler; FOFC fallbacks "
              f"{sim.fofc_fallbacks - fofc[0]} in it): {dev_ms:.3f} ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_kernel.items(),
                                                             key=lambda kv: -kv[1])))
        print(f"peak device memory: {peak:.2f} GiB ({peak - held:.2f} GiB above what the "
              "phases before held)")
        print(f"FOFC: {fofc[0]} stage fallbacks, {fofc[1]} invalid cells in {nsteps} steps; "
              f"min density {rho_min:.6e}; finite state {finite}{scalar_line}")
        print(f"launches in this path: {launches}")
        missing = [k for k in need if launches[k] <= 0]
        profiled = ("K1", "K2c") if need is LEAN_KEYS else ("K1", "K2", "K3")
        unprofiled = [k for k in profiled if by_kernel.get(k, 0.0) <= 0.0]
        if missing or unprofiled:
            raise SystemExit(f"main path {num}: kernels not launched {missing}, not in the "
                             f"profiled step {unprofiled}")
        del sim
        release()

    # ---- 17. the multigroup main path
    phase("17. main path 12: RadMultigroupPulse 256^3 f32 (decks/rad_multigroup_ppl.in at "
          "256^3: 4 photon groups, PPL full spectrum, hydro on, periodic), 2 steps (K1-K3 on "
          "the gas rows, K6 over the 4 groups, the plain multigroup coupling)")
    sim = Simulation(RadMultigroupPulseProblem(), ParmParse.from_file(
        str(MG_DECK), overrides=["amr.n_cell = 256 256 256", "precision = single",
                                 "max_timesteps = 2", "verbose = 1"]), device="cuda")
    held = torch.cuda.memory_allocated() / 2**30
    sim.set_initial_conditions()
    lay = sim.layout
    n_rad = lay.nvar - lay.nvar_hydro
    print(f"held before the path: {held:.2f} GiB; state {tuple(sim.U.shape)}: the hydro "
          f"kernels take its first {lay.nvar_hydro} rows (the gas), the {n_rad} radiation "
          f"rows behind them go to K6 and the coupling; opacity model "
          f"{sim._radiation.opts.opacity_model}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    multigroup.reset_sync_counts()
    sim.evolve()
    launches = read_counts()
    syncs = dict(multigroup.sync_counts)
    mg_launches = {"rad_div groups": launches["rad_div"]}
    peak = torch.cuda.max_memory_allocated() / 2**30
    nsub = sim._radiation.n_substeps(sim.dt_prev)
    E_ok = [bool(torch.isfinite(sim.U[lay.rad_index(g, 0)]).all()
                 and (sim.U[lay.rad_index(g, 0)] > 0).all()) for g in range(lay.n_groups)]
    finite = bool(torch.isfinite(sim.U).all())
    if sim.istep != 2 or not finite or not all(E_ok):
        raise SystemExit(f"main path 12: {sim.istep} steps, finite state {finite}, each "
                         f"group's E finite and positive {E_ok}")
    wall, nsteps = sim.elapsed_walltime, sim.istep
    # the device time of a step from its parts under the profiler, on the
    # final state: the hydro half, and one radiation substep times the
    # subcycle's nsub (each substep the same work at one dt); the coupling
    # alone, one call of each stage
    dt_rad = float(torch.tensor(sim.dt_prev / nsub, dtype=torch.float32))
    hydro_k, _ = step_profile.device_ms(step_profile._parts(sim)["hydro half"], 1)
    sub_k, _ = step_profile.device_ms(
        lambda: sim._radiation.substep(sim.U, sim.t, dt_rad), 1)
    by_kernel = {k: hydro_k.get(k, 0.0) + nsub * sub_k.get(k, 0.0)
                 for k in set(hydro_k) | set(sub_k)}
    dev_ms = sum(by_kernel.values())
    coupling = sim._radiation._coupling(sim.U)
    c_ms = sum(step_profile.device_ms(
        lambda st=st: coupling(sim.U, None, dt_rad, st, sim._radiation.opts, sim.eos,
                               sim.problem, lay.rad_start), 1)[0].get("plain torch", 0.0)
        for st in (1, 2))
    k6_ms = by_kernel.get("K6", 0.0)
    print(f"wall time: {wall / nsteps * 1e3:.3f} ms a step over {nsteps} steps "
          f"({wall:.3f} s, first step included), {nsub} radiation substeps a step, on {smi}")
    print(f"device time of a step (torch.profiler: the hydro half + {nsub} x one radiation "
          f"substep): {dev_ms:.3f} ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_kernel.items(),
                                                         key=lambda kv: -kv[1])))
    print(f"  the plain multigroup coupling: {c_ms:.3f} ms for its two stages on the final "
          f"state, x {nsub} substeps = {c_ms * nsub:.3f} ms, {100 * c_ms * nsub / dev_ms:.1f}% "
          f"of the step; K6 {k6_ms:.3f} ms, {100 * k6_ms / dev_ms:.1f}%")
    print(f"  Newton host syncs: {syncs['newton']} and outer-loop syncs {syncs['outer']} in "
          f"{syncs['calls']} coupling calls ({syncs['newton'] / max(syncs['calls'], 1):.2f} "
          f"and {syncs['outer'] / max(syncs['calls'], 1):.2f} a call; a Newton test every "
          f"{multigroup.DONE_CHECK_EVERY} iterations)")
    print(f"peak device memory: {peak:.2f} GiB ({peak - held:.2f} GiB above what the phases "
          "before held)")
    print(f"each group's E finite and positive: {E_ok}; mass rel err "
          f"{sim.conservation_rel_err[0]:.3e}")
    print(f"launches in this path: {launches}")
    missing = [k for k in HYDRO_KEYS + ("rad_div",) if launches[k] <= 0]
    stray = [k for k in ("rad_source", "rad_stage1", "rad_stage2") if launches[k]]
    if missing or stray or k6_ms <= 0.0:
        raise SystemExit(f"main path 12: kernels not launched {missing}, single-group "
                         f"kernels launched {stray}, K6 in the profiled step {k6_ms:.3f} ms")
    if not abs(sim.conservation_rel_err[0]) < 1e-5:
        raise SystemExit(f"mass conservation error {sim.conservation_rel_err[0]:.3e} >= 1e-5")
    del sim, coupling
    release()

    if failed:
        raise SystemExit(f"kernel mismatch: {failed}")

    rows = []
    # the new forms' rows: the launches of their main paths
    form_rows = {"transverse nv7": form_launches["rt fused"]["transverse"],
                 "axis_flux scalars": form_launches["rt fused"]["axis_flux"],
                 "apply_update scalars": form_launches["rt fused"]["apply_update"],
                 "axis_flux_lean scalars": form_launches["rt lean"]["axis_flux_lean"],
                 "axis_flux plm": form_launches["shell"]["axis_flux"]}
    for key, (kname, source, replaces) in KERNELS.items():
        s = summary[key]
        _, bound_by = kernel_check.bound_ms(s["bytes"], s["ops"])
        rows.append({"name": kname, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": (form_rows[key] if key in form_rows else
                                  mg_launches[key] if key in mg_launches else
                                  packed_launches[key] if key in ("axis_flux_corr",
                                                                  "row_gather") else
                                  lean_launches[key] if key == "axis_flux_lean" else
                                  amr_launches[key] if key in ("axis_flux_avg",
                                                               "rad_axis_flux") else
                                  sedov_launches[key] if key in HYDRO_KEYS else
                                  mhd_launches[key] if key in msweep.launch_counts else
                                  rad_launches[key]),
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                     "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                     "bound_by": bound_by, "library_ms": s["library_ms"]})
    print(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s (limit 1200 s)")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
