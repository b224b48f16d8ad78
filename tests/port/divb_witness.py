#!/usr/bin/env python3
"""max |div B| of the float32 constrained-transport MHD step against the
grid size, in the port and in the JAX package.

Orszag-Tang (`quokka_tpu_torch/problems/mhd.py:DECK_256` at n^3) runs
`--steps` steps of the windowed loop (`verbose = 0`) in float32:

- through `quokka_tpu_torch.MHDSimulation` on `--device` for each n of
  `--sizes` (K8 on a CUDA device, its plain version on the CPU);
- through `quokka_tpu`'s MHDSimulation in its XLA form
  (`mhd.use_pallas = 0`, on the CPU) for each n of `--jax-sizes`.

CT keeps div B at roundoff: each step rounds every face value to float32,
and the cell divergence sums six such face values over dx. So max |div B|
x dx, counted in float32 ulps of the largest |B| on a face, should hardly
move with n at a fixed number of steps, while max |div B| grows as 1/dx.
Each run prints one line and one JSON object with n, steps, t, max |div B|,
max |div B| x dx and that product in ulps.

    python tests/port/divb_witness.py --sizes 32 64 128 --jax-sizes 32
    python tests/port/divb_witness.py --device cuda --sizes 32 64 128 256 --jax-sizes

The JAX package is imported only when `--jax-sizes` is not empty.
"""

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def _deck(n, steps):
    from quokka_tpu_torch.problems.mhd import DECK_256

    return DECK_256, [f"amr.n_cell = {n} {n} {n}", f"max_timesteps = {steps}", "verbose = 0"]


def _report(code, n, steps, t, divb, bf_max, seconds):
    """`ulps` as `quokka_tpu_torch.MHDSimulation.divb_ulps` counts them."""
    dx = 1.0 / n
    ulp = 2.0 ** (math.floor(math.log2(bf_max)) - 23)
    row = {"code": code, "n": n, "steps": steps, "t": t, "max_divb": divb,
           "max_divb_dx": divb * dx, "ulps": divb * dx / ulp, "max_abs_bface": bf_max,
           "seconds": seconds}
    print(f"{code:22s} n {n:4d}  steps {steps}  t {t:.6e}  max|div B| {divb:.4e}  "
          f"x dx {divb * dx:.4e}  = {row['ulps']:.2f} ulps of max|B_face| {bf_max:.4f}  "
          f"({seconds:.1f} s)", flush=True)
    print(json.dumps(row), flush=True)
    return row


def port_run(n, steps, device):
    import torch

    from quokka_tpu_torch import MHDSimulation, ParmParse
    from quokka_tpu_torch.problems.mhd import OrszagTangProblem

    deck, extra = _deck(n, steps)
    t0 = time.perf_counter()
    sim = MHDSimulation(OrszagTangProblem(), ParmParse.from_string(deck, extra),
                        precision="single", device=device)
    sim.set_initial_conditions()
    sim.evolve()
    bf_max = max(float(torch.max(torch.abs(b))) for b in sim.Bf)
    return _report(f"quokka_tpu_torch {device}", n, sim.istep, sim.t, sim.final_divb,
                   bf_max, time.perf_counter() - t0)


def jax_run(n, steps):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import quokka_tpu
    from quokka_tpu.mhd.simulation import MHDSimulation
    from quokka_tpu.problems.mhd import OrszagTangProblem

    deck, extra = _deck(n, steps)
    t0 = time.perf_counter()
    sim = MHDSimulation(OrszagTangProblem(),
                        quokka_tpu.ParmParse.from_string(deck, extra + ["mhd.use_pallas = 0"]),
                        precision="single")
    sim.set_initial_conditions()
    sim.evolve()
    bf_max = max(float(np.max(np.abs(np.asarray(b)))) for b in sim.Bf)
    return _report("quokka_tpu XLA cpu", n, sim.istep, float(sim.t), float(sim.final_divb),
                   bf_max, time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="*", default=[32, 64, 128])
    ap.add_argument("--jax-sizes", type=int, nargs="*", default=[32])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    rows = [port_run(n, args.steps, args.device) for n in args.sizes]
    rows += [jax_run(n, args.steps) for n in args.jax_sizes]
    print(json.dumps({"divb_witness": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
