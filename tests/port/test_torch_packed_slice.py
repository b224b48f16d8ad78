"""The packed tile-pool slice of quokka_tpu_torch (`amr.pool_packed = 1`:
`amr/packed.py`, `amr/packed_driver.py`, the seeded root) against the JAX
package's `AMRSimulation`, on the CPU. Both runs start from the JAX
package's initial hierarchy, carried across with
`interop.load_amr_hierarchy`, after the tile sets are checked equal. The
JAX references run in processes of their own beside the port's runs
(tests/port/jax_packed.py), without fused multiply-adds:

- the hydro-only bump of tests/test_packed_engine.py at 32^3 + 1 packed
  level of 16^3 tiles (2 x 2 x 2 tiles in the middle of the domain),
  float32, JAX with `hydro.use_pallas = 1` (interpreted): the root takes
  the seeded lean step (K2e's plain version; the register seeded in the
  sweeps), two coarse steps. Tolerance per component, of its max: 1e-5 for
  the density and the energies; 3e-5 for the momenta, which the bump
  builds from rest out of O(1) flux differences, so float32 roundoff of
  those (6e-8) is 1e-5 of their max after two steps;
- the radiating pulse of tests/test_packed_engine.py at 32^3 + 1 packed
  level, float64, `use_pallas = 0`, two coarse steps (4 radiation
  substeps a level step): every level within 1e-12 of each component's
  max; the tile sets, `n_active` and the FOFC counts equal.

The shell of the reference benchmark is the main path on the card
(`chip_smoke.py`); on the CPU its 32^3 + 1 packed run alone takes the JAX
package a minute, past this file's budget. Two packed levels:
tests/port/test_torch_packed_levels.py.
"""

import numpy as np
import pytest
import torch

from quokka_tpu_torch import ParmParse
from quokka_tpu_torch.amr import AMRSimulation
from quokka_tpu_torch.benchmarks import bench_amr_shell
from quokka_tpu_torch.interop import amr_hierarchy_to_numpy, load_amr_hierarchy

import packed_problems as pp_
from jax_ref import SharedJaxRun, run_root
from packed_problems import compare, port_sim, start_from

N, STEPS, CHUNK = 32, 2, 4
BUMP_BOUNDS = [1e-5, 3e-5, 3e-5, 3e-5, 1e-5, 1e-5]


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The two JAX references, started at once (shared by xdist workers)."""
    root = run_root(tmp_path_factory)
    return {p: SharedJaxRun(root, f"jax_packed_{p}", "jax_packed.py", [p, STEPS, N, CHUNK])
            for p in ("bump", "pulse")}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_seeded_root_bump_f32_matches_jax(refs, monkeypatch):
    """The root takes the seeded lean step every coarse step (its register
    from the sweeps) and the packed level the fused chunked step; root and
    pool rows against JAX's interpreted-Pallas root and XLA pool."""
    sim = port_sim(pp_.PackedBump(), pp_.bump_deck(N, STEPS, CHUNK), "single")
    seeded = []
    orig = AMRSimulation._hydro_step_seeded
    monkeypatch.setattr(AMRSimulation, "_hydro_step_seeded",
                        lambda self, *a: seeded.append(1) or orig(self, *a))
    ref = refs["bump"].result()
    start_from(sim, ref)
    assert sim._root_seed_masks() is not None
    sim.evolve()
    assert len(seeded) == STEPS and sim.istep == STEPS
    assert sim.fofc_cells == int(ref["n_fofc"])
    compare(sim, ref, BUMP_BOUNDS)
    assert abs(sim.conservation_rel_err[0]) < 1e-6


def test_packed_pulse_f64_matches_jax(refs):
    """Hydro and radiation on the packed level (the fused RK2, the streamed
    subcycle with its 2g-deep stage-1 blocks), the root's register from the
    pool faces, the average-down: every level to 1e-12."""
    sim = port_sim(pp_.PackedPulse(), pp_.pulse_deck(N, STEPS, CHUNK), "double")
    ref = refs["pulse"].result()
    start_from(sim, ref)
    st = sim.level_pool[1]
    assert st.meta.n_active == ref["ijk1"].shape[0] == 8 and st.meta.capacity % CHUNK == 0
    sim.evolve()
    assert sim.fofc_cells == int(ref["n_fofc"])
    compare(sim, ref, [1e-12])
    assert abs(sim.conservation_rel_err[0]) < 1e-12


def test_hierarchy_round_trip_and_counts():
    """`amr_hierarchy_to_numpy` and `load_amr_hierarchy` carry a packed
    hierarchy across unchanged; a coarse step counts each level step's
    active cells (the root's and level 1's tiles, twice)."""
    sim = port_sim(pp_.PackedBump(), pp_.bump_deck(N, 1, CHUNK), "single")
    before = amr_hierarchy_to_numpy(sim)
    load_amr_hierarchy(sim, before)
    after = amr_hierarchy_to_numpy(sim)
    assert before.keys() == after.keys()
    assert all(np.array_equal(before[k], after[k]) for k in before)
    sim.pp.table["verbose"] = ["0"]
    active, raw, secs = bench_amr_shell(sim, n_warmup=0, n_steps=1)
    tiles = sim.level_pool[1].meta.n_active
    assert sim.cell_updates == N**3 + 2 * tiles * 16**3
    assert active > 0 and raw >= active and secs > 0


@pytest.mark.parametrize("extra,err,match", [
    ("amr.tile_size = 8 8 8", ValueError, "2\\*nghost\\+2"),
    ("amr.tile_size = 24 24 24", ValueError, "divide"),
    ("amr.max_level = 3", NotImplementedError, "at most two packed"),
])
def test_pool_config_rules(extra, err, match):
    deck = pp_.bump_deck(N, 1, CHUNK) + extra + "\n"
    with pytest.raises(err, match=match):
        AMRSimulation(pp_.PackedBump(), ParmParse.from_string(deck), device="cpu",
                      precision="single")
