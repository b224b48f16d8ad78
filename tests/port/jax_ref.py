"""A JAX reference run in a process of its own, shared by the xdist
workers of a test run.

The worker that creates the lock file starts the process; every worker
that asks waits for its output file (written whole, then renamed, by the
reference scripts, or read once the process it started has ended). The
references run with ``JAX_PLATFORMS=cpu`` and, unless told otherwise,
``XLA_FLAGS=--xla_cpu_max_isa=AVX``: XLA:CPU then contracts no a*b + c
into a fused multiply-add, and each operation rounds on its own, as each
PyTorch operation of the port's plain versions does.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent


def run_root(tmp_path_factory) -> Path:
    """One directory for the whole test run (all xdist workers)."""
    root = tmp_path_factory.getbasetemp()
    return root.parent if os.environ.get("PYTEST_XDIST_WORKER") else root


class SharedJaxRun:
    """`python tests/port/<script> OUT.npz <args>` started once per test run
    (`tag` names its files under `root`); `result()` waits for it."""

    def __init__(self, root: Path, tag: str, script: str, args, env=None, no_fma=True):
        self.out = root / f"{tag}.npz"
        self.log = root / f"{tag}.log"
        self.failed = root / f"{tag}.failed"
        self.proc = None
        try:
            os.close(os.open(root / f"{tag}.lock", os.O_CREAT | os.O_EXCL))
        except FileExistsError:
            return
        full_env = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
        full_env.pop("QUOKKA_PALLAS_LEAN", None)
        if no_fma:
            full_env["XLA_FLAGS"] = "--xla_cpu_max_isa=AVX"
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, str(HERE / script), str(self.out), *map(str, args)],
                env=full_env, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)

    def result(self) -> dict:
        if self.proc is not None:
            self.proc.wait(timeout=1200)
            if self.proc.returncode != 0:
                self.failed.write_text(self.log.read_text()[-3000:])
                raise AssertionError(self.failed.read_text())
        return self._wait(self.out)

    def init_result(self) -> dict:
        """The file OUT.init.npz that a reference script writes before its
        run (its initial state), as soon as it exists."""
        return self._wait(self.out.with_name(self.out.stem + ".init.npz"))

    def _wait(self, path: Path) -> dict:
        deadline = time.monotonic() + 1200
        while not path.exists():
            if self.proc is not None and self.proc.poll() not in (None, 0):
                self.failed.write_text(self.log.read_text()[-3000:])
            assert not self.failed.exists(), self.failed.read_text()
            assert time.monotonic() < deadline, f"no {path.name}"
            time.sleep(0.2)
        return dict(np.load(path))

    def kill(self):
        if self.proc is not None:
            self.proc.kill()
