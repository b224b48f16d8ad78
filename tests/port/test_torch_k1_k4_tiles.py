"""K1's and K4's shared-memory tiles and their edge cases.

K1 (`csrc/transverse.cu`) runs every active axis in one launch, a march
along x of a y-z column tile; K4's transport (`csrc/rad_substep.cu`, one
pass an axis) stages a tile of 32 cells by 16 lines of the radiation block
and solves each face once. On the CPU (the wrappers take the plain
versions):

- each tile `hydro.sweep.k1_tile` chooses, at the main paths' shapes and
  at the edge shapes, fits the kernel: at most K1_THREADS columns and two
  halo cells a thread, covers the extents with as few tiles as the tile's
  largest extent allows, and asks for at most K1_SMEM_MAX bytes of shared
  memory; K4's block for at most K4_SMEM_MAX;
- `kernel_check.k1_edge_cases` covers extents 4 and 5, extents that are
  not multiples of the chosen tile, a batch of 3, reflecting walls on every
  axis, conserved and primitive input, and dmin alone (PLM; no flattening);
  `k4_edge_cases` covers 4^3, 5^3 and ragged tiles along and across,
  three reconstruction orders and both opacity kinds.

`cuda`-marked (skip without a GPU): K1 bitwise equal to its plain version
on its edge cases, both K4 stages within 2e-5 of each
component's max on theirs, and the shared-memory sizes above equal to the
compiled kernels' own.
"""

import pytest
import torch

from quokka_tpu_torch import kernel_check
from quokka_tpu_torch.eos import IdealGasEOS
from quokka_tpu_torch.hydro import sweep
from quokka_tpu_torch.hydro.advance import HydroOptions
from quokka_tpu_torch.problems.radhydro_bench import RadhydroBenchProblem
from quokka_tpu_torch.radiation import substep
from quokka_tpu_torch.radiation.system import RadOptions
from quokka_tpu_torch.registry import PowerLawOpacity

# the main paths' K1 shapes (Sedov 256^3 and 512^3, the dense shell's padded
# 520^3 level, the packed chunks' 36^3 and 28^3 blocks) and the edge shapes
MAIN_SHAPES = ((256, 256, 256), (512, 512, 512), (520, 520, 520), (36, 36, 36),
               (28, 28, 28), (264, 264, 264))
# extents a tile must also cover: a thin z and a long y (TY at its cap)
ODD_SHAPES = ((8, 512, 4), (300, 5, 70))


def hydro_opts():
    return HydroOptions(eos=IdealGasEOS(gamma=1.4), active_axes=(0, 1, 2), dx=(0.1,) * 3,
                        reconstruct_eint=False)


def rad_setup():
    ropts = RadOptions(c=1.0e3, chat=1.0e2, arad=1.0, erad_floor=1e-10, beta_order=1,
                       include_work_term=True)
    eos = IdealGasEOS(gamma=5.0 / 3.0, mean_molecular_weight=1.0, boltzmann_constant=1.0)

    class TDependent(RadhydroBenchProblem):
        planck_opacity = PowerLawOpacity(10.0, -1.0, -1.5)
        energy_mean_opacity = PowerLawOpacity(8.0, -1.0, -1.0)
        flux_mean_opacity = PowerLawOpacity(12.0, -1.0, 0.5)

    return ropts, eos, {"constant": RadhydroBenchProblem(), "T-dependent": TDependent()}


def test_k1_tiles_fit_the_kernel():
    edge = [shape for _, shape, _ in kernel_check.FACE_EDGE_SHAPES]
    for shape in MAIN_SHAPES + ODD_SHAPES + tuple(edge):
        tile = sweep.k1_tile(*shape)
        assert all(1 <= t <= n for t, n in zip(tile, shape)), (shape, tile)
        assert tile[1] * tile[2] <= sweep.K1_THREADS
        assert 6 * (tile[1] + tile[2]) <= 2 * sweep.K1_THREADS  # two halo cells a thread
        assert sweep.k1_smem_bytes(tile) <= sweep.K1_SMEM_MAX, (shape, tile)
        # as few tiles as the largest tile extent allows: z in tiles of at
        # most 32 cells, each extent covered with less than one tile to spare
        assert -(-shape[2] // tile[2]) == -(-shape[2] // 32)
        assert -(-shape[0] // tile[0]) == -(-shape[0] // sweep.K1_MARCH_PLANES)
        for t, n in zip(tile, shape):
            assert -(-n // t) * t - n < t


def test_k4_tile_fits_the_kernel():
    assert substep.k4_smem_bytes() <= substep.K4_SMEM_MAX
    # every phase's items (staged cells, cells, faces) in at most 3 rounds
    ta, tw = substep.K4_TILE_ALONG, substep.K4_TILE_ACROSS
    assert (ta + 6) * tw <= 3 * substep.K4_THREADS


def test_k1_edge_cases_cover_the_edges():
    opts = hydro_opts()
    cases = list(kernel_check.k1_edge_cases(opts, "cpu"))
    n_var = len(kernel_check.K1_EDGE_VARIANTS)
    assert len(cases) == len(kernel_check.FACE_EDGE_SHAPES) * n_var
    shapes = kernel_check.FACE_EDGE_SHAPES
    exts = {e for _, shape, _ in shapes for e in shape}
    assert {4, 5} <= exts
    assert 3 in {b for b, _, _ in shapes}
    walled = [shape for _, shape, walls in shapes if walls]
    assert walled and any(max(s) > 5 for s in walled)
    # a ragged tile along some axis of some shape
    assert any(n % t for _, shape, _ in shapes for t, n in zip(sweep.k1_tile(*shape), shape))
    conserved = {c for _, _, c in kernel_check.K1_EDGE_VARIANTS}
    assert conserved == {True, False}
    no_chi = [v for v in kernel_check.K1_EDGE_VARIANTS
              if v[1].get("reconstruction_order", 3) != 3 or v[1].get("use_flattening") is False]
    assert no_chi
    # dmin for every axis; chi_cell only with PPM flattening
    for case in cases[:n_var]:
        got, ref = case.run_kernel(), case.run_plain()
        assert kernel_check.same_bits(got, ref), case.label
        assert sorted(got[0]) == [0, 1, 2]
        assert (got[1] is None) == ("dmin only" in case.label)
        nbytes, _ = case.cost()
        U5_cells = got[0][0].numel()
        assert nbytes == U5_cells * 4 * (6 + 3 + (got[1] is not None))


def test_k4_edge_cases_cover_the_edges():
    ropts, eos, problems = rad_setup()
    cases = list(kernel_check.k4_edge_cases(ropts, eos, problems, 3e-5, "cpu"))
    shapes = kernel_check.K4_EDGE_SHAPES
    assert len(cases) == 2 * len(problems) * (len(shapes) + 2)
    exts = {e for shape in shapes for e in shape}
    assert {4, 5} <= exts
    for tile in (substep.K4_TILE_ALONG, substep.K4_TILE_ACROSS):
        assert any(e % tile and e > tile for e in exts)
    assert {c.kernel for c in cases} == {"rad_stage1", "rad_stage2"}
    for order in (1, 2, 3):
        assert any(f"order {order} " in c.label for c in cases)
    for name in problems:
        assert any(c.label.endswith(name) for c in cases)
    U = kernel_check.rough_rad_state((4, 4, 4), 5, "cpu")
    f2 = (U[7:] ** 2).sum(0) / (ropts.c * U[6]) ** 2
    assert bool((f2 > 0.99).any()) and bool((U[6] < 1e-9).any())
    for case in cases[:2]:
        ok, max_abs, _, got, ref = _check_cpu(case)
        assert ok and max_abs == 0.0, case.label


def _check_cpu(case):
    got, ref = case.run_kernel(), case.run_plain()
    return (*kernel_check.compare_scaled(got, ref), got, ref)


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1_edge_cases_bitwise_on_card(cuda_device):
    for case in kernel_check.k1_edge_cases(hydro_opts(), cuda_device):
        _, _, _, got, ref = case.check()
        assert kernel_check.same_bits(got, ref), case.label


@pytest.mark.cuda
def test_k4_edge_cases_on_card(cuda_device):
    ropts, eos, problems = rad_setup()
    for case in kernel_check.k4_edge_cases(ropts, eos, problems, 3e-5, cuda_device):
        ok, max_abs, _, _, _ = case.check()
        assert ok, (case.label, max_abs)


@pytest.mark.cuda
def test_shared_memory_mirrors_match_the_kernels(cuda_device):
    from quokka_tpu_torch import _cuda

    lib = _cuda.library()
    for shape in MAIN_SHAPES + ODD_SHAPES:
        tile = sweep.k1_tile(*shape)
        assert lib.qk_transverse_smem(*tile[1:]) == sweep.k1_smem_bytes(tile)
    assert lib.qk_rad_stage_smem() == substep.k4_smem_bytes()
