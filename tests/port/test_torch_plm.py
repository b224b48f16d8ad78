"""PLM (`hydro.reconstruction_order = 2`) through the port's hydro sweep,
against quokka_tpu.

- The plain K2 reconstructing with the minmod-limited PLM slope, without
  scalars (stage 1's faces and divergences, stage 2's averaged divergences,
  the first-order faces) and with 2 mass scalars (stage 1, and the
  first-order faces, where the mass scalars' fluxes are rescaled too),
  against `compute_fluxes_pallas_div` / `compute_fluxes_pallas` run
  interpreted in float32: rtol 1e-5 + 64 ulps of each component's max
  (tests/port/test_torch_sweep.py says why). K1 under PLM writes the dmin
  fields and no chi (the flattening is PPM's).
- The radhydro shell's PLM deck at 32^3 (tests/test_radhydro_shell.py's
  CFG, the repo's decks/radhydro_shell_256.in cut to 32^3; float64, one
  step) through `Simulation(device="cpu")` against `quokka_tpu.
  Simulation`, run in a process of its own without fused multiply-adds
  (tests/port/jax_unigrid.py): every component within 1e-12 of its max.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quokka_tpu.hydro import pallas_sweep as jps

import quokka_tpu_torch
from quokka_tpu_torch.hydro import sweep
from quokka_tpu_torch.problems import RadhydroShellProblem

from torch_port_common import (BC_KINDS, jax_opts, make_state, port_opts,
                               refuse_f64_rad_kernels, t32, ulp_close, with_scalars)

HERE = Path(__file__).resolve().parent
N = 8
# (scalars, mass scalars): the shell deck's form, and PLM with mass scalars
PLM_CASES = {"no scalars": (0, 0), "2 mass": (2, 2)}
SHELL_DECK = """
geometry.prob_lo = 0.0 0.0 0.0
geometry.prob_hi = 4.0 4.0 4.0
amr.n_cell = 32 32 32
do_reflux = 0
cfl = 0.3
hydro.reconstruction_order = 2
radiation.reconstruction_order = 2
radiation.cfl = 0.3
density_floor = 1.0e-8
max_timesteps = 1
stop_time = 0.125
verbose = 0
"""


@pytest.fixture(scope="module")
def shell_ref(tmp_path_factory):
    """The JAX package's shell step, started with the module in a process of
    its own (float64, without fused multiply-adds)."""
    out = tmp_path_factory.mktemp("plm_shell")
    deck = out / "shell.in"
    deck.write_text(SHELL_DECK)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    log = out / "jax.log"
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, str(HERE / "jax_unigrid.py"),
                                 str(out / "shell.npz"), "RadhydroShell", str(deck)],
                                env=env, stdout=f, stderr=subprocess.STDOUT)
    yield proc, out / "shell.npz", log
    proc.kill()


@pytest.fixture(scope="module", params=sorted(PLM_CASES))
def plm_case(request, shell_ref):
    ns, nm = PLM_CASES[request.param]
    bc = BC_KINDS["periodic_x"]
    jo = dataclasses.replace(jax_opts(N, n_scalars=ns, n_mscalars=nm), reconstruction_order=2)
    U0 = with_scalars(make_state((N, N, N), seed=5, rough=True), ns, nm, 1).astype(np.float32)
    U1 = with_scalars(make_state((N, N, N), seed=6), ns, nm, 2).astype(np.float32)
    j0 = jnp.asarray(U0)
    ref = {"k1": jps.precompute_transverse_pallas(j0, jo, bc, state_is_cons=True),
           "r1": jps.compute_fluxes_pallas_div(j0, jo, bc),
           "fo": jps.compute_fluxes_pallas(j0, jo, first_order=True, bc_kinds=bc)}
    # stage 2 averages every component alike: the form without scalars holds
    # it (the interpreted references take most of this file's time)
    if ns == 0:
        ref["r2"] = jps.compute_fluxes_pallas_div(jnp.asarray(U1), jo, bc,
                                                  avg_with=ref["r1"])
    return dict(bc=bc, opts=port_opts(jo), U0=t32(U0), U1=t32(U1), ref=ref)


def _with_hi(F, F_hi, d):
    F = np.asarray(F)
    if F_hi is None:
        return F
    return np.concatenate([F, np.expand_dims(np.asarray(F_hi), d + 1)], axis=d + 1)


def test_k1_under_plm_writes_dmin_only(plm_case):
    dmins, chi, planes = sweep.precompute_transverse(plm_case["U0"], plm_case["opts"],
                                                     plm_case["bc"], state_is_cons=True)
    jd, jchi, _ = plm_case["ref"]["k1"]
    assert chi is None and jchi is None and planes == {}
    for t in range(3):
        ulp_close(jd[t], dmins[t], what=f"dmin_{t}")


def test_k2_plm_sweeps(plm_case):
    opts, bc, ref = plm_case["opts"], plm_case["bc"], plm_case["ref"]
    r1 = sweep.compute_fluxes_pallas_div(plm_case["U0"], opts, bc)
    j1 = ref["r1"]
    for d in range(3):
        ulp_close(_with_hi(j1["fluxes"][d], j1["flux_hi"].get(d), d),
                  _with_hi(r1["fluxes"][d], r1["flux_hi"].get(d), d),
                  what=f"stage 1 flux[{d}]")
        for key in ("divs", "dvels"):
            ulp_close(j1[key][d], r1[key][d], what=f"stage 1 {key}[{d}]")
    if "r2" in ref:
        r2 = sweep.compute_fluxes_pallas_div(plm_case["U1"], opts, bc, avg_with=r1)
        for d in range(3):
            for key in ("divs", "dvels"):
                ulp_close(ref["r2"][key][d], r2[key][d], what=f"stage 2 {key}[{d}]")
    fl, _, flh, _ = sweep.compute_fluxes_pallas(plm_case["U0"], opts, first_order=True,
                                                bc_kinds=bc)
    jfl, _, jflh, _ = ref["fo"]
    for d in range(3):
        ulp_close(_with_hi(jfl[d], jflh.get(d), d), _with_hi(fl[d], flh.get(d), d),
                  what=f"first order flux[{d}]")


def test_shell_plm_step_f64_matches_jax(shell_ref):
    proc, out, log = shell_ref
    sim = quokka_tpu_torch.Simulation(
        RadhydroShellProblem(), quokka_tpu_torch.ParmParse.from_string(SHELL_DECK),
        device="cpu")
    assert sim.hydro_opts.reconstruction_order == 2 and sim.dtype == torch.float64
    sim.set_initial_conditions()
    U0 = sim.U.numpy().copy()
    with refuse_f64_rad_kernels():
        sim.evolve()
    proc.wait(timeout=600)
    assert proc.returncode == 0, log.read_text()[-3000:]
    ref = np.load(out)
    assert int(ref["istep"]) == sim.istep == 1
    for what, a, b in (("initial state", U0, ref["U0"]), ("after one step", sim.U.numpy(),
                                                          ref["U"])):
        assert a.shape == b.shape and np.all(np.isfinite(a))
        for c in range(b.shape[0]):
            scale = np.max(np.abs(b[c]))
            err = np.max(np.abs(a[c] - b[c]))
            assert err <= 1e-12 * scale, (what, c, err, scale)
