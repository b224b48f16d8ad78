"""Peak device memory of an AMR main path, with the caching allocator's
default segments and with expandable segments.

The main paths are `chip_smoke.py`'s: the dense one, the radhydro shell
(``problems/radhydro_shell.py:DECK_256``, 256^3 + one dense level, f32)
through `AMRSimulation` and `benchmarks.bench_amr_shell` (one warm-up and
three timed coarse steps); and, with ``--packed``, the reference's AMR
benchmark (``DECK_256_PACKED``, 256^3 + 2 packed pool levels, chunks of
``CARD_PACKED_CHUNK`` tiles, one warm-up and one timed coarse step).

PyTorch reads ``PYTORCH_CUDA_ALLOC_CONF`` when
CUDA starts, so each setting runs in a process of its own: first with the
variable unset (the allocator's default), then with
``expandable_segments:True``. Each run reports its peak allocated and peak
reserved bytes (``torch.cuda.max_memory_allocated`` /
``max_memory_reserved``), or the out-of-memory error that ended it.

Run from the repository root on a CUDA machine:

    python3 -m quokka_tpu_torch.amr_memory [--packed]

The last line of the output is one JSON object with both runs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SETTINGS = (None, "expandable_segments:True")
GIB = 2**30


def run_one(packed: bool = False) -> dict:
    """The main path in this process, under whatever allocator setting it
    started with."""
    import torch

    from . import ParmParse
    from .amr import AMRSimulation
    from .benchmarks import bench_amr_shell
    from .problems import radhydro_shell

    out = {"alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
           "path": "packed" if packed else "dense"}
    torch.cuda.reset_peak_memory_stats()
    deck, extra = radhydro_shell.DECK_256, ["verbose=0"]
    if packed:
        deck = radhydro_shell.DECK_256_PACKED
        extra.append(f"amr.packed_chunk={radhydro_shell.CARD_PACKED_CHUNK}")
    try:
        sim = AMRSimulation(radhydro_shell.RadhydroShellProblem(),
                            ParmParse.from_string(deck, extra))
        sim.set_initial_conditions()
        active, raw, secs = bench_amr_shell(sim, n_warmup=1, n_steps=1 if packed else 3)
        out.update(ok=True, coarse_steps=sim.istep, finest_level=sim.finest_level,
                   mzones_active=active, mzones_raw=raw, seconds=secs)
    except torch.cuda.OutOfMemoryError as e:
        out.update(ok=False, error=str(e).splitlines()[0])
    out["peak_allocated_gib"] = torch.cuda.max_memory_allocated() / GIB
    out["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / GIB
    out["device_total_gib"] = torch.cuda.get_device_properties(0).total_memory / GIB
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    packed = "--packed" in argv
    if "--one" in argv:
        print(json.dumps(run_one(packed)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("amr_memory needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    runs = []
    for conf in SETTINGS:
        env = dict(os.environ)
        env.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        if conf is not None:
            env["PYTORCH_CUDA_ALLOC_CONF"] = conf
        proc = subprocess.run([sys.executable, "-m", "quokka_tpu_torch.amr_memory", "--one"]
                              + (["--packed"] if packed else []),
                              env=env, capture_output=True, text=True, timeout=1800)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            raise SystemExit(f"the run with PYTORCH_CUDA_ALLOC_CONF={conf} failed "
                             f"(rc {proc.returncode}): {proc.stderr[-2000:]}")
        run = json.loads(lines[-1])
        runs.append(run)
        state = ("ran" if run["ok"] else f"ran out of memory: {run['error']}")
        print(f"PYTORCH_CUDA_ALLOC_CONF={conf}: {state}; peak allocated "
              f"{run['peak_allocated_gib']:.2f} GiB, peak reserved "
              f"{run['peak_reserved_gib']:.2f} GiB of {run['device_total_gib']:.2f}",
              flush=True)
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
