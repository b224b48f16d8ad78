"""Per-phase walltime profiler (the reference's TinyProfiler analog).

Counterpart of `quokka_tpu.utils.profiler`. Profiling is a runtime switch
(`profile.enabled = 1` in the deck): phases of the evolve loop are timed on
the host, and `sync` waits for the device at region exit so the
asynchronous launch stream is attributed to the region that launched it.

Usage:
    from quokka_tpu_torch.utils.profiler import prof
    with prof.region("HydroSolver"):
        U = step(U, dt)
        prof.sync(U)
    ...
    prof.report()
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List


class TinyProfiler:
    def __init__(self):
        self.enabled = False
        self._acc: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._stack: List[str] = []

    def reset(self, enabled: bool = False):
        self.enabled = enabled
        self._acc.clear()
        self._counts.clear()
        self._stack.clear()

    def sync(self, value):
        """Wait for the device work behind `value` inside an open region."""
        if self.enabled and self._stack and getattr(value, "is_cuda", False):
            import torch

            torch.cuda.synchronize(value.device)
        return value

    @contextmanager
    def region(self, name: str):
        if not self.enabled:
            yield
            return
        from torch.profiler import record_function

        path = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            # a named range for torch.profiler, which attributes the device
            # time of the kernels launched inside it (step_profile.py)
            with record_function(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            self._acc[path] = self._acc.get(path, 0.0) + dt
            self._counts[path] = self._counts.get(path, 0) + 1

    def report(self, out=print):
        """Print the TinyProfiler-style table (name, ncalls, incl. time, %)."""
        if not self.enabled or not self._acc:
            return
        total = sum(t for p, t in self._acc.items() if "/" not in p)
        out("\nTinyProfiler-style per-phase timing report:")
        out(f"{'region':<40s} {'calls':>8s} {'incl. s':>10s} {'%':>6s}")
        for path, t in sorted(self._acc.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total > 0 else 0.0
            out(f"{path:<40s} {self._counts[path]:>8d} {t:>10.3f} {pct:>5.1f}%")
        out(f"{'TOTAL (top-level)':<40s} {'':>8s} {total:>10.3f}\n")


prof = TinyProfiler()
