"""K2c's (and K2e's) and K8's shared-memory tiles and their edge cases.

K2c (`csrc/sweep.cu` `lean_tile_kernel`) stages and reconstructs a tile of
`hydro.sweep.lean_tile` cells by lines as K2's face kernel does, solves
each face those cells touch once into shared memory, and writes only the
divergences; K8 (`csrc/mhd_sweep.cu` `mhd_tile_kernel`) does the same
with HLLD on a tile of `mhd.sweep.k8_tile`. On the CPU (the wrappers take
the plain versions):

- each tile the tile functions choose, at the main paths' shapes and at
  the edge shapes, fits its kernel: at most two faces a thread of the 256,
  as few tiles as the tile's largest extent allows, and shared memory
  within the kernel's cap (four K2c blocks a multiprocessor);
- `kernel_check.lean_edge_cases` covers extents 4 and 5, extents that are
  not multiples of the chosen tile along and across, reflecting walls and
  periodic axes, every variant (clean, acc, fo_mask, the stage-2 redo with
  fo_from, first order, K2e's seed fresh and accumulated) with mask flags
  on the first and last cell of every tile and next to the walls;
  `mhd_edge_cases` orders 1-3, floors on and off, on the same extents.

`cuda`-marked (skip without a GPU): K2c and K2e within rtol 1e-5 + 64
ulps of each component's max of their plain versions on their edge cases,
K8 bit for bit (as its one-thread-a-cell form was), and the shared-memory
sizes above equal to the compiled kernels' own.
"""

import pytest
import torch

from quokka_tpu_torch import kernel_check
from quokka_tpu_torch.eos import IdealGasEOS
from quokka_tpu_torch.hydro import sweep
from quokka_tpu_torch.hydro.advance import HydroOptions
from quokka_tpu_torch.mhd import sweep as msweep
from quokka_tpu_torch.mhd.advance import MHDOptions

# the lean path's shapes (Sedov 512^3, the largest "auto" extent 1088, the
# forced-lean 288 x 32 x 32 and 32^3 steps, the packed shell's 256^3 root)
LEAN_SHAPES = ((512, 512, 512), (1088, 1088, 1088), (288, 32, 32), (32, 32, 32),
               (256, 256, 256))
# K8's: Orszag-Tang 256^3 and the 32^3 GPU-vs-CPU run
MHD_SHAPES = ((256, 256, 256), (32, 32, 32), (16, 16, 16))
EDGE_SHAPES = tuple(shape for shape, _ in kernel_check.LEAN_EDGE_SHAPES)
SM_SMEM = 233472  # bytes of shared memory a multiprocessor holds (228 KB)


def hydro_opts():
    return HydroOptions(eos=IdealGasEOS(gamma=1.4), active_axes=(0, 1, 2), dx=(0.1,) * 3,
                        reconstruct_eint=False)


def mhd_opts():
    return MHDOptions(gamma=5.0 / 3.0, dx=(0.1,) * 3)


def _axis_tiles(shapes, tile_fn):
    for shape in shapes:
        for d in range(3):
            n, across = shape[d], shape[1] if d == 2 else shape[2]
            yield n, across, tile_fn(n, across)


def _covers(n, t, most):
    """`t` covers n in as few tiles of at most `most` as possible, with less
    than one tile to spare."""
    return -(-n // t) == -(-n // most) and -(-n // t) * t - n < t


def test_lean_tiles_fit_the_kernel():
    for n, across, (ta, tw) in _axis_tiles(LEAN_SHAPES + EDGE_SHAPES, sweep.lean_tile):
        assert 1 <= ta <= min(n, 40) and 1 <= tw <= across, (n, across, ta, tw)
        assert (ta + 1) * tw <= 2 * 256  # at most two faces a thread
        assert _covers(n, ta, 40)
        nbytes = sweep.lean_smem_bytes((ta, tw))
        assert nbytes <= sweep.LEAN_SMEM_MAX
        assert 4 * (nbytes + 1024) <= SM_SMEM  # four blocks a multiprocessor
    # the 512^3 tile: 40 cells by 12 lines, 492 faces
    assert sweep.lean_tile(512, 512) == (40, 12)


def test_k8_tiles_fit_the_kernel():
    for n, across, (ta, tw) in _axis_tiles(MHD_SHAPES + EDGE_SHAPES, msweep.k8_tile):
        assert 1 <= ta <= n and 1 <= tw <= min(across, msweep.K8_LINES)
        assert (ta + 1) * tw <= msweep.K8_FACES  # at most two faces a thread
        assert _covers(across, tw, msweep.K8_LINES)
        assert _covers(n, ta, msweep.K8_FACES // tw - 1)
        for order in (1, 2, 3):
            assert msweep.k8_smem_bytes((ta, tw), order) <= msweep.K8_SMEM_MAX
    # Orszag-Tang 256^3: rows of 16 lines (64 B), 29 cells along
    assert msweep.k8_tile(256, 256) == (29, 16)


def test_lean_edge_cases_cover_the_edges():
    cases = list(kernel_check.lean_edge_cases(hydro_opts(), "cpu"))
    exts = {e for e in sum(EDGE_SHAPES, ())}
    assert {4, 5} <= exts
    ragged_along = ragged_across = False
    for n, across, (ta, tw) in _axis_tiles(EDGE_SHAPES, sweep.lean_tile):
        ragged_along |= n % ta != 0 and n > ta
        ragged_across |= across % tw != 0 and across > tw
    assert ragged_along and ragged_across
    kinds = {kind for _, kind in kernel_check.LEAN_EDGE_SHAPES}
    assert {"walls", "periodic", "periodic x"} <= kinds
    for v in kernel_check.LEAN_EDGE_VARIANTS:
        assert any(f" {v} axis" in c.label for c in cases), v
    # K2e's seed on periodic axes only, fresh and onto a running seed
    corr = [c for c in cases if c.kernel == "axis_flux_corr"]
    assert corr and all("walls" not in c.label for c in corr)
    assert not any("walls" in c.label and "periodic" not in c.label
                   and "corr" in c.label for c in cases)
    assert any("visc eint" in c.label for c in cases)
    # mask flags on the first and last cell of every tile, and next to the
    # walls (the axis's first and last cells)
    m = kernel_check.tile_edge_mask((83, 6, 47), 0, 28, 1, "cpu")
    for c in (0, 27, 28, 55, 56, 82):
        assert bool((m[c, 0] > 0).all()), c
    # every case runs on the CPU (both sides the plain version)
    for case in cases[::9]:
        ok, max_abs, _ = kernel_check.compare(case.run_kernel(), case.run_plain())
        assert ok and max_abs == 0.0, case.label


def test_mhd_edge_cases_cover_the_edges():
    cases = list(kernel_check.mhd_edge_cases(mhd_opts(), "cpu"))
    assert len(cases) == len(EDGE_SHAPES) * 3 * len(kernel_check.MHD_EDGE_FLOORS) * 3
    for order in (1, 2, 3):
        assert any(f"order {order} " in c.label for c in cases)
    assert any("floors" in c.label for c in cases)
    ragged = any(n % ta for n, _, (ta, _) in _axis_tiles(EDGE_SHAPES, msweep.k8_tile))
    assert ragged
    for case in cases[::11]:
        ok, max_abs, _ = kernel_check.compare(case.run_kernel(), case.run_plain())
        assert ok and max_abs == 0.0, case.label


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_lean_edge_cases_on_card(cuda_device):
    for case in kernel_check.lean_edge_cases(hydro_opts(), cuda_device):
        ok, max_abs, _, _, _ = case.check()
        assert ok, (case.label, max_abs)


@pytest.mark.cuda
def test_mhd_edge_cases_on_card(cuda_device):
    for case in kernel_check.mhd_edge_cases(mhd_opts(), cuda_device):
        ok, max_abs, _, got, ref = case.check()
        assert ok and kernel_check.same_bits(got, ref), (case.label, max_abs)


@pytest.mark.cuda
def test_shared_memory_mirrors_match_the_kernels(cuda_device):
    from quokka_tpu_torch import _cuda

    lib = _cuda.library()
    for _, _, tile in _axis_tiles(LEAN_SHAPES + EDGE_SHAPES, sweep.lean_tile):
        assert lib.qk_lean_smem(*tile, 0) == sweep.lean_smem_bytes(tile)
    for _, _, tile in _axis_tiles(MHD_SHAPES + EDGE_SHAPES, msweep.k8_tile):
        for order in (1, 2, 3):
            assert lib.qk_mhd_smem(*tile, order) == msweep.k8_smem_bytes(tile, order)
