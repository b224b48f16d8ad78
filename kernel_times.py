#!/usr/bin/env python3
"""Time kernels K7 and K9 of one tree of quokka_tpu_torch on the card, at
the AMR shells' shapes, so that two trees (a parent and a change) can be
compared in one call on one card, in turns (parent, change, change,
parent), each turn a process of its own:

    python3 kernel_times.py [--tree DIR] [--check]

DIR is a checkout of the repository (default: the one that holds this
script); its quokka_tpu_torch is imported and its kernels are built in it.
With --check every timed launch is also held against its plain version
(bitwise). Prints the card's name and power limit, then one JSON line
{"tree": DIR, "device": ..., "times": {...}, "checks": {...}}; times are
milliseconds a call (CUDA events, mean of 5 calls after a warm-up).

Inputs, made on the card from fixed seeds:
- K7 (`compute_rad_axis_flux_batched`), each axis: one radiation block at
  the dense shell's padded fine level, [1, 4, 520, 520, 520], and the
  packed engine's chunk of 512 blocks of 32^3; E ~ 1 with 10% of the cells
  at 2e-10, |f| up to 0.5 with 10% of the cells at 0.9999 (so the
  donor-cell fallback fires), c = 10, PPM;
- K9 (`amr.packed.row_gather`): the 26 neighbour rows of 64 and of 512
  consecutive tiles of a raster lattice of 32 x 32 x 28 tiles (the packed
  shell's level 2 holds 28464), a missing neighbour clamped to row 0, from
  a hydro pool (rows of 6 x 16^3 f32) and a radiation pool (4 x 16^3);
  beside each, one `torch.index_select` with its int64 index built
  beforehand.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np


def lattice_rows(shape, first, count):
    """The 26 neighbour rows of tiles first .. first + count - 1 of a
    raster-ordered lattice of tiles, a neighbour outside the lattice
    clamped to row 0: int32 [count * 26]."""
    nx, ny, nz = shape
    t = np.arange(first, first + count)
    ijk = np.stack([t // (ny * nz), (t // nz) % ny, t % nz], axis=1)
    offs = np.array([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)
                     if (a, b, c) != (0, 0, 0)])
    nb = ijk[:, None, :] + offs[None]
    inside = np.all((nb >= 0) & (nb < np.array(shape)), axis=2)
    idx = (nb[..., 0] * ny + nb[..., 1]) * nz + nb[..., 2]
    return np.where(inside, idx, 0).reshape(-1).astype(np.int32)


def rad_blocks(torch, nbatch, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = torch.empty((nbatch, 4, n, n, n), dtype=torch.float32, device="cuda")
    for b in range(nbatch):  # block by block: the f64 temporaries stay small
        def rand(*s):
            return torch.rand(s, generator=g, device="cuda", dtype=torch.float64)

        E = 0.5 + rand(n, n, n)
        E[rand(n, n, n) < 0.1] = 2e-10
        nvec = torch.randn((3, n, n, n), generator=g, device="cuda", dtype=torch.float64)
        nvec /= nvec.norm(dim=0)
        fmag = 0.5 * rand(n, n, n)
        fmag[rand(n, n, n) < 0.1] = 0.9999
        out[b, 0] = E
        out[b, 1:] = nvec * fmag * 10.0 * E
        del E, nvec, fmag
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the kernels run only on the card", file=sys.stderr)
        return 2
    if not (tree / "quokka_tpu_torch").is_dir():
        print(f"error: {tree} holds no quokka_tpu_torch", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree))
    from quokka_tpu_torch import _cuda, kernel_check
    from quokka_tpu_torch.amr import packed
    from quokka_tpu_torch.radiation import sweep as rsweep
    from quokka_tpu_torch.radiation.system import RadOptions

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _cuda.library()
    for line in _cuda.build_info["log"].splitlines():
        if any(k in line for k in ("rad_axis_flux", "row_gather")) or "registers" in line:
            print("  ptxas:", line.strip())
    times, checks = {}, {}
    ropts = RadOptions(c=10.0, chat=5.0, arad=1.0)

    for label, nbatch, n, nslab in (("K7 520^3", 1, 520, 8), ("K7 512 x 32^3", 512, 32, 1)):
        R5 = rad_blocks(torch, nbatch, n, 5)
        for d in range(3):
            key = f"{label} axis {d}"
            times[key] = kernel_check.time_ms(
                lambda: rsweep.compute_rad_axis_flux_batched(R5, d, ropts))
            if args.check:
                got = rsweep.compute_rad_axis_flux_batched(R5, d, ropts)
                if nbatch == 1:
                    ref = kernel_check._slabbed(
                        lambda Rs: rsweep.rad_axis_flux_plain(Rs, d, ropts), (R5[0],),
                        (d + 1) % 3, nslab)[None]
                else:
                    ref = torch.stack([rsweep.rad_axis_flux_plain(r, d, ropts) for r in R5])
                checks[key] = bool(torch.equal(got, ref))
                del got, ref
            print(f"  {key}: {times[key]:.3f} ms" + (f", bitwise {checks[key]}"
                                                     if args.check else ""), flush=True)
        del R5
        torch.cuda.empty_cache()

    cap, lattice = 28672, (32, 32, 28)
    g = torch.Generator(device="cuda").manual_seed(7)
    pools = {"hydro": torch.randn((cap, 6, 16, 16, 16), generator=g, device="cuda"),
             "radiation": torch.randn((cap, 4, 16, 16, 16), generator=g, device="cuda")}
    for count in (64, 512):
        rows = torch.tensor(lattice_rows(lattice, 8192, count), device="cuda")
        rows64 = rows.long()
        for part, pool in pools.items():
            key = f"K9 {count} x 26 {part}"
            times[key] = kernel_check.time_ms(lambda: packed.row_gather(pool, rows))
            times[key + " index_select"] = kernel_check.time_ms(
                lambda: torch.index_select(pool, 0, rows64))
            if args.check:
                got = packed.row_gather(pool, rows)
                packed.check_gathers(pool.device)
                checks[key] = bool(torch.equal(got, torch.index_select(pool, 0, rows64)))
                del got
            print(f"  {key}: {times[key]:.3f} ms, index_select "
                  f"{times[key + ' index_select']:.3f} ms"
                  + (f", bitwise {checks[key]}" if args.check else ""), flush=True)
        times[f"K9 {count} x 26 distinct rows"] = int(torch.unique(rows).numel())
    print(json.dumps({"tree": str(tree), "device": smi, "times": times, "checks": checks}))
    if args.check and not all(checks.values()):
        print("error: a kernel disagrees with its plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
