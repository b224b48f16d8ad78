"""The bounds of K1 (at Sedov 256^3 and the packed chunk), K3 (unpadded and
on x-padded stage inputs), K4 (its bytes at 256^3), K7 and K9 at the packed main path's chunk shapes, and K7 and K9 at
their edges on the card.

`kernel_check.k7_cost` and `k9_cost` give the bytes and operations from
which `chip_smoke.py` reckons each kernel's least time. Held here on the
CPU, from shapes alone (meta tensors: nothing is allocated):

- K7 batched over a packed chunk [512, 4, 32, 32, 32] f32: the input read
  once and the flux, as many values, written once; OPS_K7_AXIS a cell;
- K9 gathering a chunk's 512 x 26 neighbour rows: each distinct row read
  once (the lists repeat rows: neighbouring tiles share neighbours, a
  missing one is clamped to row 0) and each gathered row written once.

`cuda`-marked (skip without a GPU): K7 bitwise equal to its plain version
at the edge shapes (extents 4 and 5, extents that are not multiples of
the kernel's tile, a batch of 3; every axis and reconstruction order), and
K9 with an index out of range (its row zero-filled, the others bitwise,
the flag raised, so the next `check_gathers` raises and the one after it
does not).
"""

import numpy as np
import pytest
import torch

from quokka_tpu_torch import kernel_check
from quokka_tpu_torch.amr import packed as tpk
from quokka_tpu_torch.radiation.system import RadOptions

from kernel_times import lattice_rows


def lattice_neighbours(shape, first: int, count: int) -> torch.Tensor:
    """`kernel_times.lattice_rows` (the 26 neighbour rows of `count`
    raster-ordered tiles from `first`, a missing one clamped to row 0) as
    an int32 tensor."""
    return torch.tensor(lattice_rows(shape, first, count))


@pytest.mark.parametrize("ng", [(0, 0, 0), (4, 0, 0)])
def test_k3_cost_counts_what_it_reads(ng):
    """K3 reads the stage's state (6 components), the stage input (5: the
    PdV pressure; the state's own buffer unpadded), three divergences (6
    each) and three dvels, and writes the state: 132 B a cell unpadded, 152
    B with x-padded stage inputs (the hybrid mode), of which it reads the
    interior only."""
    from quokka_tpu_torch.eos import IdealGasEOS
    from quokka_tpu_torch.hydro.advance import HydroOptions

    n = 16
    shape = tuple(n + 2 * g for g in ng)
    U = kernel_check.hydro_blocks(1, shape, 3, "cpu")[0]
    opts = HydroOptions(eos=IdealGasEOS(gamma=1.4), active_axes=(0, 1, 2), dx=(1.0 / n,) * 3)
    case = list(kernel_check.cases(U, U.clone(), opts, {0: None, 1: None, 2: None}, 1e-3,
                                   ng))[-1]
    nbytes, ops = case.cost()
    assert case.kernel == "apply_update"
    assert nbytes == (152 if any(ng) else 132) * n**3
    assert ops == kernel_check.OPS_K3 * n**3


def test_k7_cost_of_a_packed_chunk():
    R5 = torch.empty((512, 4, 32, 32, 32), dtype=torch.float32, device="meta")
    nbytes, ops = kernel_check.k7_cost(R5)
    cells = 512 * 32**3
    assert nbytes == 2 * 4 * cells * 4
    assert ops == kernel_check.OPS_K7_AXIS * cells
    ms, by = kernel_check.bound_ms(nbytes, ops)
    assert by == "bytes" and ms == pytest.approx(2 * 4 * cells * 4 / 3.35e12 * 1e3)


@pytest.mark.parametrize("shape, bound", [((6, 256, 256, 256), 0.200),
                                          ((512, 6, 36, 36, 36), 0.285)])
def test_k1_cost_counts_what_it_returns(shape, bound):
    """K1 at Sedov 256^3 and at the packed chunk of 512 x 36^3: the state
    read once (24 B a cell) and dmin of each of the three axes and chi_cell
    written once (16 B): 40 B a cell; dmin alone without flattening."""
    from quokka_tpu_torch.eos import IdealGasEOS
    from quokka_tpu_torch.hydro.advance import HydroOptions

    U = torch.empty(shape, dtype=torch.float32, device="meta")
    opts = HydroOptions(eos=IdealGasEOS(gamma=1.4), active_axes=(0, 1, 2), dx=(1.0,) * 3)
    cells = U.numel() // 6
    nbytes, ops = kernel_check.k1_cost_of(U, opts)
    assert (nbytes, ops) == (40 * cells, 3 * kernel_check.OPS_K1_AXIS * cells)
    ms, by = kernel_check.bound_ms(nbytes, ops)
    assert by == "bytes" and round(ms, 3) == bound
    if len(shape) == 5:
        assert kernel_check.k1_batched_case(U, opts).cost() == (nbytes, ops)
    plm = HydroOptions(eos=IdealGasEOS(gamma=1.4), active_axes=(0, 1, 2), dx=(1.0,) * 3,
                       reconstruction_order=2)
    assert kernel_check.k1_cost_of(U, plm)[0] == 36 * cells


def test_k4_bytes_at_256():
    """K4's stages at RadhydroBench 256^3: stage 1 reads U and writes U1
    and divF0 (96 B a cell, 1.61 GB), stage 2 reads U1, R0 and divF0 and
    writes U2 (112 B a cell, 1.88 GB)."""
    n = 256
    U = torch.empty((10, n, n, n), dtype=torch.float32, device="meta")
    div = torch.empty((1, 4, n, n, n), dtype=torch.float32, device="meta")
    one = kernel_check._bytes_of
    assert round(one(U, U, div) / 1e9, 2) == 1.61
    assert round(one(U, U[6:], div, U) / 1e9, 2) == 1.88


def test_k9_cost_counts_distinct_rows_once():
    rows = lattice_neighbours((32, 32, 28), 8192, 512)
    assert rows.numel() == 512 * 26
    distinct = int(np.unique(rows.numpy()).size)
    assert distinct < rows.numel() // 4  # neighbours shared by neighbouring tiles
    for nv in (6, 4):  # the hydro and radiation pools' rows
        pool = torch.empty((28672, nv, 16, 16, 16), dtype=torch.float32, device="meta")
        nbytes, ops = kernel_check.k9_cost(pool, rows)
        assert (nbytes, ops) == ((distinct + 512 * 26) * nv * 16**3 * 4, 0)
    # a missing neighbour is row 0: counted once however often it repeats
    edge = lattice_neighbours((32, 32, 28), 0, 64)
    pool = torch.empty((28672, 4, 16, 16, 16), dtype=torch.float32, device="meta")
    assert kernel_check.k9_cost(pool, edge)[0] == (
        np.unique(edge.numpy()).size + edge.numel()) * 4 * 16**3 * 4


def test_k7_edge_cases_cover_the_edges():
    """The edge shapes, on the CPU (the wrapper takes the plain version):
    every axis and order, a batch of 3, extents of 4 and 5 and ragged
    tiles; the seeded blocks take the donor-cell fallback."""
    ropts = RadOptions(c=10.0, chat=5.0, arad=1.0)
    cases = list(kernel_check.k7_edge_cases(ropts, "cpu"))
    assert len(cases) == 3 * 3 * len(kernel_check.K7_EDGE_SHAPES)
    exts = {e for _, shape in kernel_check.K7_EDGE_SHAPES for e in shape}
    assert {4, 5} <= exts and any(e % 16 and e > 16 for e in exts)
    assert 3 in {b for b, _ in kernel_check.K7_EDGE_SHAPES}
    R = kernel_check.rough_rad_blocks(3, (5, 5, 5), 3, "cpu")
    f2 = (R[:, 1:] ** 2).sum(1) / (10.0 * R[:, 0]) ** 2
    assert bool((f2 > 0.99).any()) and bool((R[:, 0] < 1e-9).any())
    got, ref = cases[0].run_kernel(), cases[0].run_plain()
    assert got.shape == (1, 1, 4, 4, 4, 4) and torch.equal(got, ref)


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k7_edge_shapes_bitwise_on_card(cuda_device):
    ropts = RadOptions(c=10.0, chat=5.0, arad=1.0)
    for case in kernel_check.k7_edge_cases(ropts, cuda_device):
        _, _, _, got, ref = case.check()
        assert torch.equal(got, ref), case.label


@pytest.mark.cuda
def test_k9_out_of_range_row_on_card(cuda_device):
    pool = torch.randn((40, 4, 16, 16, 16), device=cuda_device)
    rows = torch.tensor([3, 39, 40, 0, -1, 7], dtype=torch.int32, device=cuda_device)
    tpk.check_gathers(cuda_device)  # a clean flag to start from
    got = tpk.row_gather(pool, rows)
    torch.cuda.synchronize()
    assert torch.equal(got[[0, 1, 3, 5]], pool[[3, 39, 0, 7]])
    assert not bool(got[[2, 4]].any())
    with pytest.raises(IndexError):
        tpk.check_gathers(cuda_device)
    tpk.check_gathers(cuda_device)  # the flag was cleared
