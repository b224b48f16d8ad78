"""The batched matter coupling K5 (`radiation.source.source_update_batched`)
and the tiled face kernel of K2, as the packed AMR engine runs them.

On the CPU the wrappers take their plain versions:

- the batched K5 on strided views (gas and radiation as component slices of
  wider blocks, the stage-2 gas a crop of the stage-1 result, a source
  crop, a keep mask, output views into larger pools) equals, bit for bit,
  the path the packed engine ran before K5 read its chunk in place: the
  blocks concatenated, folded into one [10, B X, Y, Z] state for
  `source_update_plain`, unfolded, `torch.where` on the mask, copied into
  the pools;
- each block of it agrees with the JAX package's Pallas kernel
  (`quokka_tpu.radiation.pallas_source.source_update_pallas`, interpreted
  on the CPU as `test_torch_rad_kernels.py` runs it) within 2e-5 of each
  component's max (the Newton tolerance), with the cells outside the mask
  left as they were;
- the cost functions `kernel_check.k5_batched_cost` and `k2_face_cost`
  give, from meta tensors at the packed chunk's shapes, each input read
  once and each output written once;
- the face kernel's edge shapes and tiles: the cases cover extents 4 and
  5, ragged tiles, a batch of 3, walls and periodic axes; every tile fits
  the kernel's shared memory; the plain faces of a batch equal the blocks'
  own.

`cuda`-marked (skip without a GPU): the tiled face kernel against its
plain version on the edge shapes (PPM and first order, every axis) within
rtol 1e-5 + 64 ulps of each component's max and within the 3 ulps of it
that the one-thread-a-face kernel, whose bits the tile keeps, read on
these inputs; the batched K5 against its plain version within 2e-5 of
each component's max.

Blocks: 3 of 16^3 (stage 1, a tile of 8^3 with a ring of 4) and their 8^3
crops (stage 2), seeded.
"""

import numpy as np
import pytest
import torch

from quokka_tpu_torch import kernel_check
from quokka_tpu_torch.amr.packed import _crop
from quokka_tpu_torch.hydro import sweep
from quokka_tpu_torch.hydro.advance import HydroOptions
from quokka_tpu_torch.eos import IdealGasEOS
from quokka_tpu_torch.radiation import source

from test_torch_rad_kernels import (DT, EOS, JEOS_BENCH, RS, jax_hooks, jax_opts,
                                    make_rad_state, port_opts, port_problem, scaled_close)

B, G = 3, 4


def blocks():
    """[B, 10, 16^3] float32 states (rough: |f| -> 1, E at the floor)."""
    return torch.tensor(np.stack([make_rad_state(seed=40 + b, rough=b == 1)
                                  for b in range(B)]), dtype=torch.float32)


def keep_mask(shape, seed=5):
    rng = np.random.default_rng(seed)
    m = rng.random(shape) < 0.8
    m[:, G:-G, G:-G, G:-G] = True  # the tile itself is always real
    return torch.tensor(m)


def src_field(shape, seed=6):
    return torch.tensor(0.1 * np.random.default_rng(seed).random(shape), dtype=torch.float32)


def fold_call(Ub, src, stage, opts, prob):
    """The former packed path: fold the blocks into x, one plain call,
    unfold."""
    c, nv = Ub.shape[:2]
    sp = Ub.shape[2:]
    Uf = Ub.transpose(0, 1).reshape(nv, c * sp[0], *sp[1:]).contiguous()
    rf = None if src is None else src.reshape(c * sp[0], *sp[1:]).contiguous()
    U2f = source.source_update_plain(Uf, rf, float(np.float32(DT)), stage, opts, EOS, prob, RS)
    return U2f.reshape(nv, c, *sp).transpose(0, 1)


@pytest.mark.parametrize("opacity", ["bench", "tdep"])
def test_batched_plain_equals_the_former_packed_path(opacity):
    opts, prob = port_opts(jax_opts()), port_problem(opacity)
    U = blocks()
    n = U.shape[-1]
    dt = float(np.float32(DT))
    # strided operands: gas and radiation are component slices of wider blocks
    wide = torch.zeros((B, 12, n, n, n))
    wide[:, 1:7] = U[:, :6]
    wide[:, 8:12] = U[:, 6:]
    gas, rad = wide[:, 1:7], wide[:, 8:12]
    keep = keep_mask((B, n, n, n))
    src_b = src_field((B, n, n, n))
    # stage 1, as the engine ran it: cat, fold, coupling, unfold, where
    Ub = torch.cat([gas, rad], dim=1)
    U1b = torch.where(keep[:, None], fold_call(Ub, src_b, 1, opts, prob), Ub)
    gas1, rad1 = source.source_update_batched(gas, rad, src_b, dt, 1, opts, EOS, prob, RS,
                                              keep=keep)
    assert torch.equal(gas1, U1b[:, :6]) and torch.equal(rad1, U1b[:, 6:])
    assert torch.equal(gas1[~keep.unsqueeze(1).expand_as(gas1)],
                       gas[~keep.unsqueeze(1).expand_as(gas)])
    # stage 2: the gas a crop of the stage-1 blocks, the source a crop, the
    # result written into rows 1..3 of larger pools
    R_new = (1.01 * _crop(rad1, G)).contiguous()
    U2t = torch.cat([_crop(U1b[:, :6], G), R_new], dim=1)
    ref = fold_call(U2t, _crop(src_b, G), 2, opts, prob)
    Uph_new = torch.full((B + 2, 6) + (n - 2 * G,) * 3, -7.0)
    Upr_new = torch.full((B + 2, 4) + (n - 2 * G,) * 3, -7.0)
    sl = slice(1, 1 + B)
    res = source.source_update_batched(_crop(gas1, G), R_new, _crop(src_b, G), dt, 2, opts,
                                       EOS, prob, RS, out=(Uph_new[sl], Upr_new[sl]))
    assert res[0].data_ptr() == Uph_new[sl].data_ptr()
    assert torch.equal(Uph_new[sl], ref[:, :6]) and torch.equal(Upr_new[sl], ref[:, 6:])
    assert bool((Uph_new[0] == -7.0).all()) and bool((Upr_new[-1] == -7.0).all())


@pytest.mark.parametrize("stage", [1, 2])
def test_batched_blocks_match_pallas(stage):
    import jax.numpy as jnp
    from quokka_tpu.radiation import pallas_source as jpsrc

    jo = jax_opts()
    U = blocks()
    keep = keep_mask(tuple(U[:, 0].shape)) if stage == 1 else None
    gas1, rad1 = source.source_update_batched(U[:, :6], U[:, 6:], None, float(np.float32(DT)),
                                              stage, port_opts(jo), EOS,
                                              port_problem("bench"), RS, keep=keep)
    got = torch.cat([gas1, rad1], dim=1)
    for b in range(B):
        ref, _ = jpsrc.source_update_pallas(jnp.asarray(U[b].numpy()),
                                            jnp.zeros(U.shape[2:], jnp.float32), DT, stage,
                                            jo, JEOS_BENCH, *jax_hooks("bench"), RS)
        ref = np.asarray(ref)
        if keep is not None:
            ref = np.where(keep[b].numpy()[None], ref, U[b].numpy())
        scaled_close(ref, got[b], 2e-5, f"K5 batched block {b} stage {stage}")


def test_k5_batched_cost_of_a_packed_chunk():
    """Stage 1 at 512 x 24^3 (contiguous blocks, a source and the mask) and
    stage 2 at 512 x 16^3 (the gas a crop of the stage-1 gas, written into
    pool rows): each value read once and written once."""
    c, n1, n2 = 512, 24, 16
    gas = torch.empty((c, 6, n1, n1, n1), device="meta")
    rad = torch.empty((c, 4, n1, n1, n1), device="meta")
    src = torch.empty((c, n1, n1, n1), device="meta")
    keep = torch.empty((c, n1, n1, n1), dtype=torch.bool, device="meta")
    cells1 = c * n1**3
    nbytes, ops = kernel_check.k5_batched_cost(gas, rad, src, keep)
    assert nbytes == 2 * 10 * 4 * cells1 + 4 * cells1 + cells1
    assert ops == kernel_check.OPS_COUPLING_CELL * cells1
    counts = {"newton_resid": 7, "newton_iters": 5, "outer_iters": 3}
    _, ops = kernel_check.k5_batched_cost(gas, rad, src, keep, n_kept=100, counts=counts)
    assert ops == kernel_check.coupling_ops(100, counts)
    gas2 = _crop(gas, 4)
    rad2 = torch.empty((c, 4, n2, n2, n2), device="meta")
    nbytes, _ = kernel_check.k5_batched_cost(gas2, rad2, _crop(src, 4))
    assert nbytes == (2 * 10 + 1) * 4 * c * n2**3
    ms, by = kernel_check.bound_ms(nbytes, ops)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


@pytest.mark.parametrize("n,first_order", [(36, False), (28, False), (36, True)])
def test_k2_face_cost_of_a_packed_chunk(n, first_order):
    """K2's faces over the packed chunk (512 blocks of 36^3 at stage 1, 28^3
    at stage 2, first order at 36^3): the state, chi and two dmin fields
    read once, 6 flux and 1 velocity values a face written once."""
    c = 512
    U5 = torch.empty((c, 6, n, n, n), device="meta")
    field = torch.empty((c, n, n, n), device="meta")
    dmins = {t: field for t in range(3)}
    cells = c * n**3
    for d in range(3):
        nbytes, ops = kernel_check.k2_face_cost(U5, d, field, dmins, first_order)
        assert nbytes == 4 * cells * (6 + (0 if first_order else 3) + 7)
        per_face = kernel_check.OPS_FO_FACE if first_order else kernel_check.OPS_K2_FACE
        assert ops == per_face * cells
    # a wall axis adds the hi-wall plane of faces
    nbytes, ops = kernel_check.k2_face_cost(U5[:1], 0, field[:1], dmins, wall=True)
    assert ops == kernel_check.OPS_K2_FACE * (n**3 + n**2)


def test_face_edge_shapes_and_tiles():
    """The edge cases cover extents 4 and 5, ragged tiles, a batch of 3 and
    both kinds of axis; every tile the wrapper picks, at the main paths'
    shapes and the edges, fits the kernel's 48 KB of static-size shared
    memory and holds at most 512 faces."""
    shapes = kernel_check.FACE_EDGE_SHAPES
    exts = {e for _, shape, _ in shapes for e in shape}
    assert {4, 5} <= exts and any(e > 40 or e % 2 for e in exts)
    assert any(nb == 3 for nb, _, _ in shapes)
    assert any(w for _, _, w in shapes) and any(not w for _, _, w in shapes)
    lines = [(n + w, a) for n, a, w in ((256, 256, 1), (520, 520, 0), (36, 36, 0),
                                        (28, 28, 0))]
    lines += [(e + w, a) for _, shape, w in shapes for e in shape for a in shape]
    for nf, na in lines:
        ta, tw = sweep._face_tile(nf, na)
        assert 1 <= ta <= min(nf, 40) and 1 <= tw <= na and ta * tw <= 512
        smem = 4 * ((ta + 5) * tw * 6 + (ta + 1) * tw * 14)
        assert smem <= 48 * 1024, (nf, na, ta, tw)
    assert sweep._face_tile(36, 36)[0] == 36 and sweep._face_tile(28, 28)[0] == 28


def test_face_plain_of_a_batch_equals_the_blocks():
    """`kernel_check.face_plain` over a batch of 3 (what the cases hold the
    kernel to) equals the plain sweep of each block, PPM and first order."""
    opts = HydroOptions(eos=IdealGasEOS(gamma=1.4), active_axes=(0, 1, 2), dx=(0.1,) * 3,
                        reconstruct_eint=False)
    U5 = kernel_check.hydro_blocks(3, (5, 6, 7), 9, "cpu")
    fields = [sweep.precompute_transverse_plain(u, opts, None, True)[:2] for u in U5]
    dmins = {t: torch.stack([f[0][t] for f in fields]) for t in range(3)}
    chi = torch.stack([f[1] for f in fields])
    for d in range(3):
        for fo in (False, True):
            got = kernel_check.face_plain(U5, d, opts, None if fo else chi,
                                          {} if fo else dmins, None, fo, nslab=1)
            for b in range(3):
                ref = sweep.axis_flux_plain(U5[b], d, opts, None if fo else fields[b][1],
                                            {} if fo else fields[b][0], fo,
                                            state_is_cons=True)
                assert torch.equal(got[0][b], ref[0]) and torch.equal(got[1][b], ref[1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_face_kernel_edges_on_card(cuda_device):
    opts = HydroOptions(eos=IdealGasEOS(gamma=1.4), active_axes=(0, 1, 2), dx=(0.1,) * 3,
                        reconstruct_eint=False)
    for case in kernel_check.face_edge_cases(opts, cuda_device):
        ok, max_abs, _, got, ref = case.check()
        assert ok, (case.label, max_abs)
        assert kernel_check.ulps_of_max(got, ref) <= 3.0, case.label


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [1, 2])
def test_k5_batched_on_card(cuda_device, stage):
    opts, prob = port_opts(jax_opts()), port_problem("tdep")
    U = blocks().to(cuda_device)
    n = U.shape[-1]
    keep = keep_mask((B, n, n, n)).to(cuda_device) if stage == 1 else None
    gas, rad = U[:, :6], U[:, 6:]
    if stage == 2:
        gas, rad = _crop(gas, G), _crop(rad, G).contiguous()
    src = _crop(src_field((B, n, n, n)).to(cuda_device), G if stage == 2 else 0)
    for case in kernel_check.k5_batched_cases(gas, rad, src, keep, float(np.float32(DT)),
                                              stage, opts, EOS, prob):
        ok, max_abs, _, _, _ = case.check()
        assert ok, (case.label, max_abs)
