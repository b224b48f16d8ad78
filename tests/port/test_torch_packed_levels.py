"""Two packed tile-pool levels (`amr.max_level = 2`, both pools packed, as
on the reference benchmark's shell) of quokka_tpu_torch against the JAX
package's `AMRSimulation`, on the CPU. What a second pool level adds to one:

- the average-down and the reflux of a packed level into a packed parent
  (`packed_driver.avgdown_packed`, `reflux_packed`);
- the "ppool" parent context: a pool level's backdrops prolonged from its
  pool parent's padded tiles;
- the register scatter of a pool child into its pool parent (every chunk
  here is full: the deviation of a partial chunk is held in
  tests/port/test_torch_packed_kernels.py);
- the packed regrid of level 2 from level 1's octant tags and, when the
  root regrids, the grandchild pins (level-2 tiles keep their level-1
  parents).

The radiating pulse of tests/test_packed_engine.py at 32^3 + 2 packed
levels of 16^3 tiles (8 tiles each), float64, `use_pallas = 0`, one coarse
step with `regrid_interval = 1` (level 1's second substep regrids level 2),
starts from the JAX package's initial hierarchy and is held to 1e-12 of
each component's max on every level, with equal tile sets, `n_active` and
FOFC counts. The JAX reference runs in a process of its own
(tests/port/jax_packed.py) without fused multiply-adds; the port's run
starts once the reference has written its initial state. The pins need a
regrid of the root, a second coarse step the JAX reference would double:
they are held on the port's side alone, on a root whose tags vanish.
"""

import numpy as np
import pytest
import torch

import packed_problems as pp_
from jax_ref import SharedJaxRun, run_root
from packed_problems import compare, port_sim, start_from
from torch_port_common import refuse_f64_rad_kernels

N, STEPS, CHUNK, MAX_LEVEL, REGRID = 32, 1, 4, 2, 1


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX reference, started at once (shared by xdist workers)."""
    return SharedJaxRun(run_root(tmp_path_factory), "jax_packed_pulse_levels2",
                        "jax_packed.py", ["pulse", STEPS, N, CHUNK, MAX_LEVEL, REGRID])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pulse_sim():
    return port_sim(pp_.PackedPulse(), pp_.pulse_deck(N, STEPS, CHUNK, MAX_LEVEL, REGRID),
                    "double")


def test_two_packed_levels_pulse_f64_matches_jax(ref):
    sim = pulse_sim()
    start_from(sim, ref.init_result())
    assert sim.finest_level == 2
    assert [sim.level_pool[l].meta.n_active for l in (1, 2)] == [8, 8]
    rebuilt = []
    orig = sim._regrid_pool_level
    sim._regrid_pool_level = lambda l: rebuilt.append(l) or orig(l)
    with refuse_f64_rad_kernels():  # K5 and K7 take their plain versions in f64
        sim.evolve()
    assert rebuilt == [1]
    want = ref.result()
    assert sim.fofc_cells == int(want["n_fofc"])
    compare(sim, want, [1e-12])
    assert abs(sim.conservation_rel_err[0]) < 1e-12


def test_root_regrid_pins_grandchild_parents():
    """The root's tags vanish: level 1 keeps exactly the parents of level 2's
    tiles, with their rows, and level 2 links to them."""
    sim = pulse_sim()
    st1, st2 = sim.level_pool[1], sim.level_pool[2]
    n2 = st2.meta.n_active
    ijk2 = st2.meta.ijk[:n2].copy()
    rows2 = st2.Uh[:n2].clone()
    old1 = {tuple(int(v) for v in st1.meta.ijk[s]): (st1.Uh[s].clone(), st1.Ur[s].clone())
            for s in range(st1.meta.n_active)}
    sim.problem.error_est = lambda s, l: torch.zeros(s.level_grids[l].n_cell, dtype=torch.bool)
    assert sim._regrid_level(0)
    new1, new2 = sim.level_pool[1], sim.level_pool[2]
    assert sim.finest_level == 2 and new2 is st2
    parents = sorted({tuple(int(v) // 2 for v in t) for t in ijk2})
    n1 = new1.meta.n_active
    assert sorted(tuple(int(v) for v in t) for t in new1.meta.ijk[:n1]) == parents
    for s in range(n1):
        h, r = old1[tuple(int(v) for v in new1.meta.ijk[s])]
        assert torch.equal(new1.Uh[s], h) and torch.equal(new1.Ur[s], r)
    assert torch.equal(new2.Uh[:n2], rows2)
    slots = new2.parent_slot[:n2].numpy()
    for s in range(n2):
        assert tuple(int(v) for v in new1.meta.ijk[slots[s]]) == tuple(int(v) // 2
                                                                        for v in ijk2[s])
    cs = new1.child_slots[:n1].numpy()
    assert sorted(int(v) for v in cs.reshape(-1) if v >= 0) == list(range(n2))
    assert np.all(np.isfinite(new1.Uh[:n1].numpy()))
