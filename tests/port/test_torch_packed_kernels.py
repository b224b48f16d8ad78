"""The packed slice's kernels' plain versions against the JAX package, on
the CPU:

- K2e, the lean sweep that seeds the AMR root's flux register
  (`compute_fluxes_pallas_div(corr_masks=...)`, Pallas interpreted, in a
  process of its own without fused multiply-adds: tests/port/jax_lean.py
  "corr"), on a periodic 32^3 box for stage 1 (fresh, and with a FOFC
  mask) and stage 2 (onto stage 1's totals and seed, with a FOFC mask, with
  and without fo_from): div, dvel and the seed corr within rtol 1e-5 + 64
  ulps of each component's max (`ulp_close`);
- K9, the row gather: bitwise `jnp.take`, and an index outside the pool
  raises;
- the register scatter of a pool child into its pool parent on a partial
  chunk: the port's active rows only against JAX's program, which also
  adds a spare row into the parent's last slot (the documented deviation);
- `fused_block_rk2` (the packed engine's single-pass RK2 of a chunk) on a
  rough float64 chunk whose FOFC fires in both stages next to the tile
  edges, against the JAX package's: the new tiles and the register faces
  within 1e-12 of each component's max, the FOFC counts equal.

The kernels themselves run on the card (`cuda`-marked test here,
chip_smoke.py phase 3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quokka_tpu.amr import packed as jpk
from quokka_tpu.eos import IdealGasEOS as JEOS
from quokka_tpu.hydro import advance as jadv

from quokka_tpu_torch import kernel_check
from quokka_tpu_torch.amr import packed as tpk
from quokka_tpu_torch.hydro import sweep
from quokka_tpu_torch.interop import hydro_options_from_fields

from jax_lean import CORR_N, CORR_VARIANTS, jax_opts
from jax_ref import SharedJaxRun, run_root
from torch_port_common import ulp_close

TS = (16, 16, 16)


@pytest.fixture(scope="module", autouse=True)
def corr_ref(tmp_path_factory):
    """K2e's JAX reference, started when the module's first test runs
    (shared by xdist workers)."""
    return SharedJaxRun(run_root(tmp_path_factory), "jax_lean_corr", "jax_lean.py", ["corr"])


@pytest.fixture(scope="module")
def corr_data(corr_ref):
    return corr_ref.result()


@pytest.mark.parametrize("variant", [v[0] for v in CORR_VARIANTS])
def test_k2e_plain_matches_pallas(corr_data, variant):
    ref = corr_data
    name, stage, masked, fo = next(v for v in CORR_VARIANTS if v[0] == variant)
    opts = hydro_options_from_fields(dataclasses.asdict(jax_opts((CORR_N,) * 3)))[0]
    t = {k: torch.tensor(ref[k]) for k in ("U0", "U1", "mask", "bm0", "bm1", "bm2")}
    kw = {}
    if stage == 2:
        kw = dict(acc_init=(torch.tensor(ref["s1/div"]), torch.tensor(ref["s1/dvel"])),
                  corr_init=torch.tensor(ref["s1/corr"]))
    got = sweep.compute_fluxes_pallas_div(
        t["U1" if stage == 2 else "U0"], opts, {0: None, 1: None, 2: None}, accumulate=True,
        div_only=True, fo_mask=t["mask"] if masked else None, fo_from=t["U0"] if fo else None,
        corr_masks={d: t[f"bm{d}"] for d in range(3)}, **kw)
    for k in ("div", "dvel", "corr"):
        ulp_close(ref[f"{name}/{k}"], got[k], what=f"{name} {k}")
    # the seed is nonzero exactly on the faces' cells of the coverage boundary
    assert float(got["corr"].abs().max()) > 0.0


def test_k9_plain_is_take_bitwise():
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((40, 6, 4, 4, 4)).astype(np.float32)
    rows = rng.integers(0, 40, size=26 * 8).astype(np.int32)
    got = tpk.row_gather(torch.tensor(pool), torch.tensor(rows))
    ref = np.asarray(jnp.take(jnp.asarray(pool), jnp.asarray(rows), axis=0))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), ref)
    for bad in (-1, 40):
        with pytest.raises(IndexError):
            tpk.row_gather(torch.tensor(pool), torch.tensor(np.array([0, bad], np.int32)))


@pytest.mark.parametrize("d", [0, 1, 2])
def test_register_scatter_active_rows_vs_jax(d):
    """The register scatter of a pool child into its pool parent on a
    partial chunk (3 active rows, then a spare row of parent slot -1):
    the port adds the active rows only, exactly as a plain loop does; the
    JAX program adds the spare row too, into the parent's last slot (its
    `dynamic_slice` wraps the index -1, `allow_negative_indices`), and
    equals the port on the active rows alone."""
    rng = np.random.default_rng(11 + d)
    half = (2, 2, 2)
    faces = tuple(2 * h + (e == d) for e, h in enumerate(half))
    cfaces = tuple(h + (e == d) for e, h in enumerate(half))
    F = rng.standard_normal((3, 2) + faces)
    restr = rng.standard_normal((4, 2) + cfaces)
    ps = np.array([1, 0, 1, -1], np.int32)
    po = np.array([[0, 0, 0], [2, 0, 2], [0, 2, 2], [2, 2, 0]], np.int32)
    want = F.copy()
    for r in range(3):
        o = po[r]
        want[ps[r], :, o[0]:o[0] + cfaces[0], o[1]:o[1] + cfaces[1],
             o[2]:o[2] + cfaces[2]] += restr[r]
    got = tpk.scatter_restr(torch.tensor(F), torch.tensor(restr), torch.tensor(ps),
                            torch.tensor(po), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    prog = jpk.scatter_restr_faces_prog(half, d)
    jax_active = np.asarray(prog(jnp.asarray(F), jnp.asarray(restr[:3]), jnp.asarray(ps[:3]),
                                 jnp.asarray(po[:3])))
    np.testing.assert_allclose(got, jax_active, rtol=0, atol=1e-15)
    jax_all = np.asarray(prog(jnp.asarray(F), jnp.asarray(restr), jnp.asarray(ps),
                              jnp.asarray(po)))
    o = po[3]
    want[-1, :, o[0]:o[0] + cfaces[0], o[1]:o[1] + cfaces[1], o[2]:o[2] + cfaces[2]] += restr[3]
    np.testing.assert_allclose(jax_all, want, rtol=0, atol=1e-15)


def _rough_chunk():
    """Two tiles' stage-1 fills [2, 6, 36^3] (P = 10) with density wells
    between colliding streams just outside, on and just inside the tile
    edges, a stage-2 backdrop, and neighbour rows for part of the ring."""
    P, GOV, C = 10, 6, 2
    rng = np.random.default_rng(3)
    shape = (C,) + tuple(t + 2 * P for t in TS)
    rho = 1.0 + 0.5 * rng.random(shape)
    v = 0.3 * rng.standard_normal((3,) + shape)
    eint = 1.0 + rng.random(shape)
    for c, i, j, k in ((0, P - 2, P + 3, P + 8), (0, P + 15, P + 15, P + 1),
                       (1, P + 4, P + 7, P + 17), (1, P + 1, P + 16, P + 5)):
        rho[c, i, j, k], eint[c, i, j, k] = 1e-4, 1e-6
        v[0, c, i + 1, j, k], v[0, c, i - 1, j, k] = 8.0, -8.0
    ke = 0.5 * rho * (v * v).sum(axis=0)
    ug0 = np.stack([rho, rho * v[0], rho * v[1], rho * v[2], rho * eint + ke, rho * eint],
                   axis=1)
    inner = tuple(slice(P - GOV, P + t + GOV) for t in TS)
    bd2 = 1.01 * ug0[(slice(None), slice(None)) + inner]
    nbr = np.full((C, 26), -1, np.int32)
    nbr[0, [3, 4, 12, 13, 21, 22]] = 1
    nbr[1, [1, 4, 10, 15, 20, 25]] = 0
    return ug0, bd2, nbr


def test_fused_block_rk2_rough_chunk_matches_jax():
    ug0, bd2, nbr = _rough_chunk()
    jo = jadv.HydroOptions(dx=(1 / 64,) * 3, eos=JEOS(gamma=1.4), active_axes=(0, 1, 2),
                           reconstruction_order=3, use_pallas=False, fuse_update=False,
                           reconstruct_eint=False)
    to = hydro_options_from_fields(dataclasses.asdict(jo))[0]
    dt = 0.2 / 64
    P = 10
    jU2, jown, jrestr, jn = jpk.fused_block_rk2(
        jnp.asarray(ug0[:, :, P:-P, P:-P, P:-P]), jnp.asarray(ug0), jnp.asarray(bd2),
        jnp.asarray(nbr), dt, jo, True, (0, 1, 2))
    U2, own, restr, n, fallbacks = tpk.fused_block_rk2(
        torch.tensor(ug0), torch.tensor(bd2), torch.tensor(nbr),
        torch.tensor(dt, dtype=torch.float64), to, True, (0, 1, 2), TS)
    assert fallbacks == 2 and int(n) == int(jn) > 0  # both stages fell back
    jU2 = np.asarray(jU2)
    for c in range(6):
        scale = np.abs(jU2[:, c]).max()
        assert np.abs(U2.numpy()[:, c] - jU2[:, c]).max() <= 1e-12 * scale, c
    for d in range(3):
        for a, b in ((own[d], jown[d]), (restr[d], jrestr[d])):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max(), d


@pytest.mark.cuda
def test_packed_kernels_match_plain_on_card():
    """K2e, K9 and the batched K1/K2/K7 launches against their plain
    versions on the card, on small inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    n = 32
    opts = hydro_options_from_fields(dataclasses.asdict(jax_opts((n,) * 3)))[0]
    from jax_lean import corr_inputs

    inp = {k: torch.tensor(v, device="cuda") for k, v in corr_inputs().items()}
    masks = {d: inp[f"bm{d}"] for d in range(3)}
    cases = list(kernel_check.corr_cases(inp["U0"], inp["U1"], opts, masks))
    pool = torch.randn((64, 6, 16, 16, 16), device="cuda")
    rows = torch.randint(0, 64, (26 * 8,), dtype=torch.int32, device="cuda")
    cases += list(kernel_check.gather_cases({"hydro rows": pool}, rows))
    ug5 = torch.tensor(np.stack([_rough_chunk()[0][i] for i in (0, 1)]),
                       dtype=torch.float32, device="cuda")
    R5 = 1.0 + torch.rand((2, 4, 32, 32, 32), device="cuda")
    R5[:, 1:] *= 0.1
    from quokka_tpu_torch.radiation.system import RadOptions

    ropts = RadOptions(c=10.0, chat=5.0, arad=1.0)
    cases += list(kernel_check.batched_cases(ug5, R5, opts, ropts))
    for case in cases:
        ok, max_abs, _, _, _ = case.check()
        assert ok, (case.label, max_abs)
        if case.kernel == "row_gather":
            assert max_abs == 0.0
    bad = torch.tensor([0, 64], dtype=torch.int32, device="cuda")
    tpk.row_gather(pool, bad)
    with pytest.raises(IndexError):
        tpk.check_gathers(pool.device)
    tpk.check_gathers(pool.device)  # the flag was cleared
