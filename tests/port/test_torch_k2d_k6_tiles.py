"""K2's sweeps with a divergence and K6 on their shared-memory tiles.

K2's stage-1 and stage-2 sweeps and K2d (`csrc/sweep.cu`
`sweep_tile_kernel`) take K2c's tile (`hydro.sweep.sweep_tile`): each face
the tile's cells touch is solved once into shared memory, stage 1 writes
its faces beside the divergences, stage 2 and K2d average with stage 1's
faces there and write no face of their own. K6 (`csrc/rad_sweep.cu`
`rad_div_tile_kernel`) takes K4's transport pass and adds onto an
accumulator in place (`radiation.system.rad_transport_div`: x into a fresh
output, y and z onto it). On the CPU (the wrappers take the plain
versions):

- each tile `sweep_tile` chooses, at the main paths' shapes and at the edge
  shapes, fits the kernel: at most two faces a thread of the 256, as few
  tiles as the tile's largest extent allows, shared memory within the
  kernel's cap (four blocks a multiprocessor), fewer than 2^31 blocks;
- `kernel_check.sweep_edge_cases` covers extents 4 and 5, extents that are
  not multiples of the chosen tile along and across, reflecting walls and
  periodic axes, and stage 1, first order, stage 2 and K2d (periodic axes
  only); `k6_edge_cases` extents 4 and 5, ragged transport tiles, orders
  1-3, per axis and accumulated;
- `rad_transport_div` on the plain path (the accumulator added onto in
  place) equals ((x + y) + z) of the JAX package's `compute_rad_div_pallas`
  per axis (interpret mode) within rtol 1e-5 + 64 ulps of each component's
  max, the tolerance of `test_torch_rad_kernels.py::test_k6_rad_div`.

`cuda`-marked (skip without a GPU): K2's sweeps and K6 within rtol 1e-5 +
64 ulps of each component's max of their plain versions on their edge
cases, and the tile's shared memory equal to the compiled kernel's own.
"""

import dataclasses

import numpy as np
import pytest
import torch

from quokka_tpu_torch import kernel_check
from quokka_tpu_torch.eos import IdealGasEOS
from quokka_tpu_torch.hydro import sweep
from quokka_tpu_torch.hydro.advance import HydroOptions
from quokka_tpu_torch.interop import rad_options_from_fields
from quokka_tpu_torch.radiation import substep, system

from torch_port_common import ulp_close

# the sweeps' shapes: Sedov and RadhydroBench 256^3, the dense shell's
# padded 520^3 fine level and 264^3 root, the GPU-vs-CPU 32^3 runs and the
# dense shell's 16^3 + 1 (24^3 and 40^3 padded)
SWEEP_SHAPES = ((256, 256, 256), (520, 520, 520), (264, 264, 264), (32, 32, 32),
                (24, 24, 24), (40, 40, 40))
EDGE_SHAPES = tuple(shape for shape, _ in kernel_check.LEAN_EDGE_SHAPES)
SM_SMEM = 233472  # bytes of shared memory a multiprocessor holds (228 KB)


def hydro_opts():
    return HydroOptions(eos=IdealGasEOS(gamma=1.4), active_axes=(0, 1, 2), dx=(0.1,) * 3,
                        reconstruct_eint=False)


def rad_opts():
    return system.RadOptions(c=1.0e3, chat=1.0e2, arad=1.0, erad_floor=1e-10)


def _axis_tiles(shapes):
    for shape in shapes:
        for d in range(3):
            n, across = shape[d], shape[1] if d == 2 else shape[2]
            yield shape, d, n, across, sweep.sweep_tile(n, across, d)


def test_sweep_tiles_fit_the_kernel():
    for shape, d, n, across, (ta, tw) in _axis_tiles(SWEEP_SHAPES + EDGE_SHAPES):
        along = sweep.LEAN_ALONG if d == 2 else sweep.SWEEP_ALONG
        assert 1 <= ta <= min(n, along) and 1 <= tw <= across, (shape, d, ta, tw)
        assert (ta + 1) * tw <= 2 * 256  # at most two faces a thread
        assert -(-n // ta) == -(-n // along)  # as few tiles as the bound allows
        if d < 2:  # rows of at most 16 lines, as few as that allows
            assert tw <= sweep.SWEEP_LINES
            assert -(-across // tw) == -(-across // sweep.SWEEP_LINES)
        nbytes = sweep.lean_smem_bytes((ta, tw))
        assert nbytes <= sweep.LEAN_SMEM_MAX
        assert 4 * (nbytes + 1024) <= SM_SMEM  # four blocks a multiprocessor
        fixed = shape[1] if d == 0 else shape[0]
        assert -(-n // ta) * -(-across // tw) * fixed < 2**31
    # the x and y sweeps: 29 cells by 16 lines at 256^3 and 520^3; the z
    # sweep K2c's 37 by 13 and 40 by 12
    assert [sweep.sweep_tile(256, 256, d) for d in range(3)] == [(29, 16), (29, 16), (37, 13)]
    assert [sweep.sweep_tile(520, 520, d) for d in range(3)] == [(29, 16), (29, 16), (40, 12)]


def test_sweep_edge_cases_cover_the_edges():
    cases = list(kernel_check.sweep_edge_cases(hydro_opts(), "cpu"))
    exts = {e for e in sum(EDGE_SHAPES, ())}
    assert {4, 5} <= exts
    ragged_along = ragged_across = False
    for _, _, n, across, (ta, tw) in _axis_tiles(EDGE_SHAPES):
        ragged_along |= n % ta != 0 and n > ta
        ragged_across |= across % tw != 0 and across > tw
    assert ragged_along and ragged_across
    kinds = {kind for _, kind in kernel_check.LEAN_EDGE_SHAPES}
    assert {"walls", "periodic", "periodic x"} <= kinds
    for v in kernel_check.SWEEP_EDGE_VARIANTS:
        assert any(f" {v} axis" in c.label for c in cases), v
    # stage 2 on a wall axis (the hi planes averaged); K2d on periodic axes
    # only, under its own launch count
    assert any("walls stage 2 axis" in c.label for c in cases)
    k2d = [c for c in cases if " K2d " in c.label]
    assert k2d and all(c.kernel == "axis_flux_avg" and "walls" not in c.label for c in k2d)
    assert not any("periodic x" in c.label and "K2d axis 1" in c.label for c in cases)
    assert any("visc eint" in c.label for c in cases)
    # every case runs on the CPU (both sides the plain version)
    for case in cases[::7]:
        ok, max_abs, _ = kernel_check.compare(case.run_kernel(), case.run_plain())
        assert ok and max_abs == 0.0, case.label


def test_k6_edge_cases_cover_the_edges():
    cases = list(kernel_check.k6_edge_cases(rad_opts(), "cpu"))
    shapes = kernel_check.K4_EDGE_SHAPES
    assert {4, 5} <= {e for e in sum(shapes, ())}
    ta, tw = substep.K4_TILE_ALONG, substep.K4_TILE_ACROSS
    assert any(s[0] > ta and s[0] % ta for s in shapes)  # ragged along x
    assert any(s[2] > tw and s[2] % tw for s in shapes)  # ragged across (x, y sweeps)
    for order in (1, 2, 3):
        assert any(f" order {order}" in c.label for c in cases)
    assert sum("accumulated" in c.label for c in cases) == len(cases) // 4
    for case in cases[::5]:
        ok, max_abs, _ = kernel_check.compare(case.run_kernel(), case.run_plain())
        assert ok and max_abs == 0.0, case.label


def test_rad_transport_div_accumulates_as_jax_sums():
    """The plain path's x, then y and z added onto it in place, against
    ((x + y) + z) of the JAX package's K6 per axis."""
    import jax.numpy as jnp

    from quokka_tpu.radiation import pallas_sweep as jpsw
    from quokka_tpu.radiation import system as jsys

    n, rs = 16, 6
    U = kernel_check.rough_rad_state((n, n, n), 21, "cpu").numpy()
    jo = jsys.RadOptions(c=1.0e3, chat=1.0e2, arad=1.0, erad_floor=1e-10, beta_order=1,
                         include_work_term=True, use_pallas=True)
    dx = (1.0 / n, 0.5 / n, 2.0 / n)
    cons = jnp.asarray(U[rs:])
    parts = [jpsw.compute_rad_div_pallas(cons, d, jo, 1, dx[d]) for d in range(3)]
    ref = np.asarray((parts[0] + parts[1]) + parts[2])
    po = rad_options_from_fields(dataclasses.asdict(jo))
    got = system.rad_transport_div(torch.tensor(U), rs, po, (0, 1, 2), dx)
    assert got.shape == ref.shape
    ulp_close(ref[0], got[0], what="K6 accumulated over three axes")


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sweep_edge_cases_on_card(cuda_device):
    for case in kernel_check.sweep_edge_cases(hydro_opts(), cuda_device):
        ok, max_abs, _, _, _ = case.check()
        assert ok, (case.label, max_abs)


@pytest.mark.cuda
def test_k6_edge_cases_on_card(cuda_device):
    for case in kernel_check.k6_edge_cases(rad_opts(), cuda_device):
        ok, max_abs, _, _, _ = case.check()
        assert ok, (case.label, max_abs)


@pytest.mark.cuda
def test_sweep_shared_memory_matches_the_kernel(cuda_device):
    from quokka_tpu_torch import _cuda

    lib = _cuda.library()
    for _, _, _, _, tile in _axis_tiles(SWEEP_SHAPES + EDGE_SHAPES):
        assert lib.qk_lean_smem(*tile, 0) == sweep.lean_smem_bytes(tile)
