"""The bounds of K1 (at Sedov 256^3 and the packed chunk), K3 (unpadded and
on x-padded stage inputs), K4 (its bytes at 256^3), K7 and K9 at the packed main path's chunk shapes, and K7 and K9 at
their edges on the card; with passive scalars the bytes of K1 (its gas
rows only), K2 and K3 (nv components), K2's operations by form (PPM, PLM,
scalars, mass scalars), and the tile choosers' shared memory within
LEAN_SMEM_MAX for 6, 7 and 8 components.

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


def _scalar_opts(n_scalars, n_mscalars=0, order=3):
    from quokka_tpu_torch.eos import IdealGasEOS
    from quokka_tpu_torch.hydro.advance import HydroOptions

    return HydroOptions(eos=IdealGasEOS(gamma=1.4), active_axes=(0, 1, 2), dx=(1.0 / 16,) * 3,
                        reconstruction_order=order, n_scalars=n_scalars,
                        n_mscalars=n_mscalars)


@pytest.mark.parametrize("ng", [(0, 0, 0), (4, 0, 0)])
def test_k3_cost_counts_the_scalars(ng):
    """K3 with one scalar (Rayleigh-Taylor 3D): the state's 7 components
    read and written, three divergences of 7 and three dvels, and the stage
    input's 5 (x-padded: its interior): 152 B a cell unpadded, 172 padded;
    the scalar's rhs, update, finiteness and floor rescale on top of
    OPS_K3."""
    n = 16
    opts = _scalar_opts(1)
    shape = tuple(n + 2 * g for g in ng)
    U = kernel_check.with_scalar_rows(kernel_check.hydro_blocks(1, shape, 3, "cpu")[0], opts, 3)
    case = list(kernel_check.cases(U, U.clone(), opts, {0: None, 1: None, 2: None}, 1e-3,
                                   ng))[-1]
    nbytes, ops = case.cost()
    assert case.kernel == "apply_update" and U.shape[0] == 7
    assert nbytes == (172 if any(ng) else 152) * n**3
    assert ops == (kernel_check.OPS_K3 + kernel_check.OPS_K3_SCALAR) * n**3


@pytest.mark.parametrize("n_scalars", [1, 2])
def test_k1_cost_reads_the_gas_rows_only(n_scalars):
    """K1 reads the 6 gas components of a state with scalars (40 B a cell
    with flattening, as without), and no scalar."""
    U = torch.empty((6 + n_scalars, 64, 64, 64), dtype=torch.float32, device="meta")
    nbytes, ops = kernel_check.k1_cost_of(U, _scalar_opts(n_scalars))
    assert (nbytes, ops) == (40 * 64**3, 3 * kernel_check.OPS_K1_AXIS * 64**3)


@pytest.mark.parametrize("form", [(0, 0, 3), (1, 0, 3), (2, 2, 3), (0, 0, 2), (1, 0, 2)])
def test_k2_stage1_cost_reads_nv(form):
    """K2's stage-1 sweep with `nv` = 6 + scalars components: the state (nv
    rows), chi (PPM only) and two dmin fields read, the faces and the
    divergences (nv + 1 rows each) written: 92 B a cell at nv = 6 with
    PPM, 104 with one scalar (7/6 of the state's rows and of the written
    ones); the operations of the form (`kernel_check.k2_ops`)."""
    ns, nm, order = form
    opts = _scalar_opts(ns, nm, order)
    n = 16
    U = kernel_check.with_scalar_rows(kernel_check.hydro_blocks(1, (n, n, n), 4, "cpu")[0],
                                      opts, 4)
    case = next(c for c in kernel_check.cases(U, U.clone(), opts, {0: None, 1: None, 2: None},
                                              1e-3) if c.label == "K2 stage 1 axis 0")
    nbytes, ops = case.cost()
    nv = 6 + ns
    chi = 4 if order == 3 else 0
    assert nbytes == (4 * nv + chi + 8 + 8 * (nv + 1)) * n**3
    assert ops == kernel_check.k2_ops(opts) * n**3
    if form == (0, 0, 3):
        assert nbytes == 92 * n**3 and ops == kernel_check.OPS_K2_SWEEP * n**3
    if form == (1, 0, 3):
        assert nbytes == 104 * n**3
    assert kernel_check.k2_ops(opts) > kernel_check.k2_ops(opts, first_order=True)


# the shapes the tile choosers meet: the main paths' (Sedov 256^3 and 512^3,
# Rayleigh-Taylor's 256 x 256 x 384, the dense level's 520^3, the packed
# blocks' 36^3 and 28^3, ShockCloud's padded 264) and the edge shapes
TILE_SHAPES = ((256, 256, 256), (512, 512, 512), (256, 256, 384), (520, 520, 520),
               (36, 36, 36), (28, 28, 28), (264, 256, 256), (4, 4, 4), (5, 5, 5),
               (37, 18, 33), (4, 35, 17), (83, 6, 47), (16, 16, 24))


@pytest.mark.parametrize("nv", [6, 7, 8])
def test_tiles_with_scalars_fit_the_kernels(nv):
    """Every tile the choosers pick for a state of nv components keeps its
    block's shared memory within LEAN_SMEM_MAX and at most two faces a
    thread, and covers the axis in as few tiles as its extent along
    allows; at nv = 6 the main paths' tiles are those of the form without
    scalars."""
    from quokka_tpu_torch.hydro import sweep

    for shape in TILE_SHAPES:
        for d in range(3):
            n, across = shape[d], shape[1] if d == 2 else shape[2]
            # (tile, its shared memory, slots along: cells, or the n + 1
            # faces of a wall axis; faces a tile line: ta + 1, or ta)
            for name, (ta, tw), smem, slots, faces in (
                    ("lean", sweep.lean_tile(n, across, nv), sweep.lean_smem_bytes, n, 1),
                    ("sweep", sweep.sweep_tile(n, across, d, nv), sweep.lean_smem_bytes, n, 1),
                    ("face", sweep._face_tile(n + 1, across, nv), sweep.face_smem_bytes,
                     n + 1, 0)):
                assert 1 <= ta <= slots and 1 <= tw <= across, (name, shape, d, ta, tw)
                assert smem((ta, tw), nv) <= sweep.LEAN_SMEM_MAX, (name, shape, d, ta, tw)
                assert (ta + faces) * tw <= 512, (name, shape, d, ta, tw)
                assert -(-slots // ta) * ta - slots < ta
    if nv == 6:
        # the choosers' rules before the scalars (no shared-memory cap), at
        # the main paths' shapes
        split = sweep._split
        for shape in TILE_SHAPES[:7]:
            for d in range(3):
                n, across = shape[d], shape[1] if d == 2 else shape[2]
                ta = split(n, sweep.LEAN_ALONG)
                lean = (ta, split(across, max(1, min(across, sweep.LEAN_FACES // (ta + 1)))))
                assert sweep.lean_tile(n, across) == lean
                assert sweep.sweep_tile(n, across, d) == (
                    lean if d == 2 else (split(n, sweep.SWEEP_ALONG),
                                         split(across, sweep.SWEEP_LINES)))
                fa = -(-(n + 1) // -(-(n + 1) // 40))
                tw = max(1, min(across, 512 // fa))
                assert sweep._face_tile(n + 1, across) == (fa, -(-across // -(-across // tw)))
    else:
        # fewer lines (z sweeps) or fewer cells along (x, y) than at nv = 6
        assert sweep.lean_tile(256, 256, nv)[1] < sweep.lean_tile(256, 256)[1]
        assert sweep.sweep_tile(256, 256, 0, nv)[0] < sweep.sweep_tile(256, 256, 0)[0]


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


# K2's PLM and scalar forms and K3's scalar forms (csrc/sweep.cuh, apply.cu)
FORMS = {"PLM": {"reconstruction_order": 2}, "1 scalar": {"n_scalars": 1},
         "2 mass scalars": {"n_scalars": 2, "n_mscalars": 2}}


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
def test_form_edge_cases_on_card(cuda_device, form):
    """Each new form within rtol 1e-5 + 64 ulps of each component's max of
    its plain version at the edge shapes, in every K2 form (faces batched
    and on walls, first order, the sweeps' stage 1 and 2 and K2d, K2c and
    K2e in every lean variant) and K3 with the density floor engaged."""
    import dataclasses

    opts = dataclasses.replace(_scalar_opts(0), **FORMS[form])
    shapes = kernel_check.FORM_EDGE_SHAPES
    gens = (kernel_check.face_edge_cases(opts, cuda_device),
            kernel_check.face_wall_edge_cases(opts, cuda_device, shapes=shapes),
            kernel_check.sweep_edge_cases(opts, cuda_device, shapes=shapes),
            kernel_check.lean_edge_cases(opts, cuda_device, shapes=shapes),
            [kernel_check.k3_floor_case(opts, cuda_device)])
    for gen in gens:
        for case in gen:
            ok, max_abs, _, _, _ = case.check()
            assert ok, (case.label, max_abs)


@pytest.mark.cuda
def test_unported_scalar_forms_raise_on_card(cuda_device):
    """What the kernels do not take raises NotImplementedError naming it:
    K1 over a batch of states with scalars (the packed chunks), more than
    two scalars, and passive scalars in the radiation kernels (K4)."""
    from quokka_tpu_torch.hydro import sweep
    from quokka_tpu_torch.radiation import substep

    one = _scalar_opts(1)
    U5 = kernel_check.with_scalar_rows(kernel_check.hydro_blocks(2, (8, 8, 8), 5, cuda_device),
                                       one, 5)
    with pytest.raises(NotImplementedError, match="batch of states with passive scalars"):
        sweep.precompute_transverse_batched(U5, one, None, True)
    three = _scalar_opts(3)
    U = kernel_check.with_scalar_rows(kernel_check.hydro_blocks(1, (8, 8, 8), 6, cuda_device)[0],
                                      three, 6)
    with pytest.raises(NotImplementedError, match="at most 2 passive scalars"):
        sweep.precompute_transverse(U, three, None, True)
    ropts = RadOptions(c=10.0, chat=5.0, arad=1.0)
    R = torch.ones((11, 8, 8, 8), device=cuda_device)
    with pytest.raises(NotImplementedError, match="passive scalars"):
        substep.fused_stage1(R, None, 1e-3, ropts, one.eos, None, (0.1,) * 3)
