"""The packed tile-pool engine: row gathers and the streamed fused level
advance of pool levels.

Counterpart of `quokka_tpu.amr.packed` (``:1-1033``), the JAX package's
engine for pool levels at the reference benchmark's scale (the radhydro
shell 256^3 + 2 levels). A packed level keeps its state as two row pools,
hydro `Uh` [cap, 6, tx, ty, tz] and radiation `Ur` [cap, 4, tx, ty, tz]
(the same bytes as the TPU's lane-packed [cap, row / 128, 128] rows; no
lane packing is needed on the card), and advances them chunk by chunk:

- `row_gather` (kernel K9, ``csrc/row_gather.cu``): the neighbour and
  parent rows a chunk needs, reading only those rows;
- `assemble_chunk`: a chunk's ghost-padded blocks (own rows, the 26
  neighbour regions where the neighbour exists, else the prolonged parent
  backdrop);
- `fused_block_rk2`: one single-pass RK2 step of a chunk, stage 1
  recomputed on a (2g+2)-deep ghost block so no stage-1 pool exists. The
  FOFC flag-halo algebra keeps it equal to the two-pass path: stage-1
  flags are computed through depth g+2 (every face a cell of the stage-2
  stencil reads) on real cells only, stage-2 flags through the +-1 ring;
- `fused_hydro_advance_packed` / `fused_rad_subcycle_packed`: the level's
  hydro substep and radiation subcycle streamed over its chunks, with the
  chunk's flux-register contributions.

The chunk's face fluxes are the batched kernels: K1 and K2's face mode
over [c, 6, X, Y, Z] blocks (`hydro.sweep.compute_fluxes_batched`) and K7
over [c, 4, X, Y, Z] (`radiation.sweep.compute_rad_axis_flux_batched`),
one launch an axis, where the JAX package vmaps its flux functions.

What is not ported, being TPU machinery: the DMA semaphore ring of the
gather, the dispatch throttle (`_throttle`, `QUOKKA_PACKED_SYNC_CHUNKS`)
and `WindowedWriter`'s delayed donated writes: a chunk's new rows go into a
preallocated result pool by plain indexed writes, so every chunk reads the
old pool (two pools live during a level substep, not one plus a window).
A chunk's FOFC checks are Python `if`s on one host read each, where the
JAX package has a `lax.cond`. The register scatter of a pool child into
its pool parent takes the active child rows only (the JAX program's
`dynamic_slice` wraps a spare row's parent slot -1 to the parent pool's
last row, `allow_negative_indices`, and adds the spare row there).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .._numerics import div as true_div
from ..hydro import euler
from ..hydro.sweep import _on_cuda, _stream, compute_fluxes_batched
from ..indices import EGAS, EINT, MX1, RHO
from ..stencil import sh
from . import tilepool as tp
from .pool_advance import restrict_tile_faces, slice_tile_faces

launch_counts = {"row_gather": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ------------------------------------------------------------- row gather
def row_gather_plain(pool: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: `torch.index_select` of rows; an index outside
    [0, cap) raises IndexError."""
    return torch.index_select(pool, 0, rows.to(torch.int64))


_err_flags: Dict[torch.device, torch.Tensor] = {}


def check_gathers(device) -> None:
    """Raise IndexError if a K9 launch on `device` met an index outside its
    pool since the last check; one host read (none on the CPU, where the
    plain version raises at once)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:  # the flags are kept by index
        device = torch.device("cuda", torch.cuda.current_device())
    flag = _err_flags.get(device)
    if flag is not None and int(flag.item()) != 0:
        flag.zero_()
        raise IndexError("a K9 row gather met a row index outside its pool")


def row_gather(pool: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """K9 (`quokka_tpu/amr/packed.py::row_gather`): pool[rows] for a pool
    [cap, ...] of contiguous rows and an int32 index [n], into a fresh
    [n, ...] tensor. On a CUDA tensor it launches the kernel (a persistent
    grid of bulk copies through shared memory, taking row segments in
    output order from a counter zeroed here), which zero-fills a row
    whose index lies outside [0, cap) and raises the device's error flag,
    read by `check_gathers` (no host sync here). On the CPU:
    `row_gather_plain`."""
    if not _on_cuda(pool):
        return row_gather_plain(pool, rows)
    from .._cuda import check, library

    lib = library()
    if not pool.is_contiguous():
        raise ValueError("K9 takes a contiguous pool")
    if rows.dtype != torch.int32 or rows.device != pool.device or rows.dim() != 1:
        raise ValueError("K9 takes an int32 [n] index on the pool's device")
    rows = rows.contiguous()
    row_bytes = pool[0].numel() * pool.element_size()
    if row_bytes % 16 or pool.data_ptr() % 16 or row_bytes >= 2**31:
        raise ValueError(f"K9 takes 16-byte aligned rows of a multiple of 16 bytes "
                         f"(below 2 GiB), got {row_bytes} at {pool.data_ptr():#x}")
    if pool.shape[0] >= 2**31:
        raise ValueError(f"K9 takes pools of fewer than 2^31 rows, got {pool.shape[0]}")
    out = torch.empty((rows.shape[0],) + tuple(pool.shape[1:]), dtype=pool.dtype,
                      device=pool.device)
    err = _err_flags.setdefault(pool.device, torch.zeros(1, dtype=torch.int32,
                                                         device=pool.device))
    # the kernel's work counter: the blocks take the next row segment from it
    counter = torch.zeros(1, dtype=torch.int64, device=pool.device)
    code = lib.qk_row_gather(pool.data_ptr(), rows.data_ptr(), out.data_ptr(),
                             rows.shape[0], row_bytes, pool.shape[0], err.data_ptr(),
                             counter.data_ptr(), _stream(pool))
    check(code, "row_gather")
    launch_counts["row_gather"] += 1
    return out


# ------------------------------------------------------------ ghost blocks
def _lead(x):
    return (slice(None),) * (x.dim() - 3)


def _crop(x: torch.Tensor, k: int) -> torch.Tensor:
    """Crop k cells from each side of the trailing three axes."""
    if k == 0:
        return x
    return x[_lead(x) + (slice(k, -k),) * 3]


def _crop_tree(tree: dict, k: int) -> dict:
    return {d: _crop(v, k) for d, v in tree.items()}


def _embed_mask(m: torch.Tensor, k: int) -> torch.Tensor:
    """Pad a [c, X, Y, Z] bool mask with k False cells a side."""
    return torch.nn.functional.pad(m, (k,) * 6)


_REGION_MAPS: Dict[tuple, tuple] = {}


def _region_map(ts, gf: int, device):
    """For a block padded by gf around a tile of shape ts: (src [X, Y, Z]
    int64, the source of each padded cell: 0..25 the neighbour direction
    `tp.DIRS` index, 26 the tile itself; local [X, Y, Z] int64, the cell's
    flat offset inside its source tile). Cached by shape and device."""
    key = (tuple(ts), gf, str(device))
    if key not in _REGION_MAPS:
        axes = []
        for t in ts:
            p = np.arange(t + 2 * gf)
            a = np.where(p < gf, -1, np.where(p >= gf + t, 1, 0))
            axes.append((a, (p - gf) % t))
        (ax, lx), (ay, ly), (az, lz) = axes
        dirs = {d: q for q, d in enumerate(tp.DIRS)}
        dirs[(0, 0, 0)] = len(tp.DIRS)
        code = np.vectorize(lambda a, b, c: dirs[(a, b, c)])(
            ax[:, None, None], ay[None, :, None], az[None, None, :])
        local = (lx[:, None, None] * ts[1] + ly[None, :, None]) * ts[2] + lz[None, None, :]
        _REGION_MAPS[key] = (torch.as_tensor(code, dtype=torch.int64, device=device),
                             torch.as_tensor(local, dtype=torch.int64, device=device))
    return _REGION_MAPS[key]


def assemble_chunk(Up: torch.Tensor, i0: int, chunk: int, nbr_c: torch.Tensor,
                   backdrop: torch.Tensor, gf: int, ts) -> torch.Tensor:
    """Ghost-padded blocks [chunk, nv, ts + 2 gf] of pool rows i0..i0+chunk
    (`quokka_tpu/amr/packed.py:180-204`): the own rows in the centre, each
    of the 26 ghost regions from the neighbour row's edge where the
    neighbour exists (one K9 gather for all chunk x 26 rows), else the
    `backdrop`. The regions are placed by one gather from the gathered rows
    through a cached map of the padded block (`_region_map`)."""
    return assemble_blocks(Up, Up[i0:i0 + chunk], nbr_c, backdrop, gf, ts)


def assemble_blocks(Up: torch.Tensor, own: torch.Tensor, nbr_c: torch.Tensor,
                    backdrop: torch.Tensor, gf: int, ts) -> torch.Tensor:
    """`assemble_chunk` for tiles `own` [c, nv, *ts] of pool `Up` whose
    neighbour rows are `nbr_c` [c, 26]."""
    chunk, nv = own.shape[:2]
    T = int(np.prod(ts))
    nb = row_gather(Up, torch.clamp(nbr_c.reshape(-1), min=0))
    rows = torch.cat([nb.reshape(chunk, len(tp.DIRS), nv, T),
                      own.reshape(chunk, 1, nv, T)], dim=1)
    del nb
    code, local = _region_map(ts, gf, Up.device)
    lin = ((torch.arange(chunk, device=Up.device)[:, None, None, None, None] * 27
            + code) * nv + torch.arange(nv, device=Up.device)[:, None, None, None]) * T + local
    out = torch.take(rows, lin)
    return torch.where(ring_real_mask(nbr_c, ts, gf)[:, None], out, backdrop)


def ring_real_mask(nbr_c: torch.Tensor, ts, gf: int) -> torch.Tensor:
    """[chunk, ts + 2 gf] bool: True on the interior and on the ghost
    regions whose neighbour tile exists (real tile data after assembly)."""
    code, _ = _region_map(ts, gf, nbr_c.device)
    exists = torch.cat([nbr_c >= 0, torch.ones_like(nbr_c[:, :1], dtype=torch.bool)], dim=1)
    return exists[:, code]


def overlay_backdrop(U1: torch.Tensor, nbr_c: torch.Tensor, bd: torch.Tensor, gf: int,
                     ts) -> torch.Tensor:
    """U1 with its neighbour-less ghost regions replaced by the backdrop
    `bd` (the two-pass path's stage-2 fill: neighbour U1 where a neighbour
    exists, else parent data at the stage-2 time)."""
    return torch.where(ring_real_mask(nbr_c, ts, gf)[:, None], U1, bd)


# --------------------------------------------------- per-block hydro algebra
# The chunk axis leads; the JAX package vmaps the per-block functions. A
# state block's component-major view `U.transpose(0, 1)` ([nv, c, X, Y, Z])
# feeds the pointwise `euler` functions; stencils roll the spatial axes.
def _cm(U):
    return U.transpose(0, 1)


def _rhs(fl: dict, opts) -> torch.Tensor:
    """sum_d (F_d(i) - F_d(i+1)) / dx_d of [c, nv, ...] face fluxes."""
    rhs = None
    for d, F in fl.items():
        contrib = true_div(F - sh(F, 1, d + 2), opts.dx[d])
        rhs = contrib if rhs is None else rhs + contrib
    return rhs


def _add_pdv(rhs, Ug, fv: dict, opts, redo_mask=None):
    """-P div(v) source of the blocks (`add_internal_energy_pdv`): face
    velocities, or central differences of cell velocities on redo cells."""
    P = euler.pressure(_cm(Ug), opts.eos)
    div_v = None
    for d, v in fv.items():
        c = true_div(sh(v, 1, d + 1) - v, opts.dx[d])
        div_v = c if div_v is None else div_v + c
    if redo_mask is not None:
        div_cc = None
        for d in opts.active_axes:
            vel = Ug[:, MX1 + d] / Ug[:, RHO]
            c = true_div(0.5 * (sh(vel, 1, d + 1) - sh(vel, -1, d + 1)), opts.dx[d])
            div_cc = c if div_cc is None else div_cc + c
        div_v = torch.where(redo_mask, div_cc, div_v)
    rhs = rhs.clone()
    rhs[:, EINT] = rhs[:, EINT] + (-P * div_v)
    return rhs


def _blend(fl, fv, fo_fl, fo_fv, mask):
    """First-order fluxes and face velocities on every face next to a
    flagged cell of the blocks (reference `replaceFluxes`)."""
    nf, nv = {}, {}
    for d in fl:
        flag = sh(mask, -1, d + 1) | mask
        nf[d] = torch.where(flag[:, None], fo_fl[d], fl[d])
        nv[d] = torch.where(flag, fo_fv[d], fv[d])
    return nf, nv


def _invalid(U, eos):
    return torch.logical_not(euler.is_state_valid(_cm(U), eos))


def _finalize(U, opts):
    eos = opts.eos
    Ux = euler.enforce_limits(_cm(U), eos, opts.density_floor, opts.temperature_floor,
                              opts.n_scalars)
    if opts.use_dual_energy and not eos.is_isothermal:
        Ux = euler.sync_dual_energy(Ux)
    return Ux.transpose(0, 1).contiguous()


def fused_block_rk2(ug0: torch.Tensor, bd2: torch.Tensor, nbr_c: torch.Tensor, dt,
                    opts, with_own: bool, active_axes, ts):
    """Single-pass RK2-SSP on a chunk of ghost-padded blocks
    (`quokka_tpu/amr/packed.py:261-371`).

    ug0 [c, nv, ts + 2P]: the stage-1 fill, P = 2g + 2; bd2 [c, nv,
    ts + 2gov]: the stage-2 parent backdrop, gov = g + 2. Stage 1 runs on
    the whole P block, its FOFC flags on real cells through depth gov;
    stage 2 on the gov block, its flags through the +-1 ring. Returns
    (U2 [c, nv, *ts], own faces or None, restricted faces, n_fofc, fallbacks)."""
    g = 4
    P = 2 * g + 2
    gov = g + 2
    eos = opts.eos
    ng3 = (slice(g, -g),) * 3

    def fx(ug, fo=False):
        return compute_fluxes_batched(ug.contiguous(), opts, fo)

    def upd(ug, fl, fv, m):
        rhs = _add_pdv(_rhs(fl, opts), ug, fv, opts, m)
        return _crop(ug, g) + dt * rhs[(slice(None), slice(None)) + ng3]

    real_ov = ring_real_mask(nbr_c, ts, gov)
    real_1 = ring_real_mask(nbr_c, ts, 1)

    # ---- stage 1 on the whole P-padded block
    fl1, fv1 = fx(ug0)
    U1 = upd(ug0, fl1, fv1, None)  # [c, nv, ts + 2gov]
    redo1 = _invalid(U1, eos) & real_ov
    n1 = redo1.sum()
    fallbacks = 0
    if bool(n1 > 0):  # host sync
        fallbacks += 1
        fo_fl, fo_fv = fx(ug0, True)
        mP = _embed_mask(redo1, P - gov)
        fl1, fv1 = _blend(fl1, fv1, fo_fl, fo_fv, mP)
        del fo_fl, fo_fv
        U1 = upd(ug0, fl1, fv1, mP)
    fl1c, fv1c = _crop_tree(fl1, g), _crop_tree(fv1, g)
    del fl1, fv1
    U1 = overlay_backdrop(_finalize(U1, opts), nbr_c, bd2, gov, ts)

    # ---- stage 2: the time-averaged flux applied to U0
    ug0c = _crop(ug0, g)  # [c, nv, ts + 2gov]
    fl2, fv2 = fx(U1)
    flA = {d: 0.5 * (fl1c[d] + fl2[d]) for d in fl2}
    fvA = {d: 0.5 * (fv1c[d] + fv2[d]) for d in fv2}
    del fl1c, fv1c, fl2, fv2
    U2w = upd(ug0c, flA, fvA, None)  # [c, nv, ts + 4], valid ring 1
    redo2 = _invalid(_crop(U2w, 1), eos) & real_1
    n2 = redo2.sum()
    if bool(n2 > 0):  # host sync
        fallbacks += 1
        fo_fl, fo_fv = fx(ug0c, True)
        m2 = _embed_mask(redo2, gov - 1)
        flA, fvA = _blend(flA, fvA, fo_fl, fo_fv, m2)
        U2w = upd(ug0c, flA, fvA, m2)
    U2 = _finalize(_crop(U2w, 2), opts)

    # faces for the registers: the final time-averaged fluxes on the tile's
    # own faces [0..t] (gov coordinates)
    own = slice_tile_faces(flA, gov, ts)
    restr = restrict_tile_faces(own, active_axes)
    return U2, (own if with_own else None), restr, n1 + n2, fallbacks


# -------------------------------------------------- parent backdrop providers
def donor_pad_width(g: int) -> int:
    """Parent ghost width a (2g+2)-deep fine backdrop prolongs from:
    donor_halo(2g + 2) = g + 2."""
    return tp.donor_halo(2 * g + 2)


def _lerp(a, b, tau):
    return (1.0 - tau) * a + tau * b


def dense_backdrop(ppad_old, ppad_new, org_c, tau, gf, ts, g, active):
    """Backdrop of a packed level whose parent is dense: the parent pads
    (width g + 2) interpolated to `tau` and prolonged
    (`make_dense_backdrop_fn`). The interpolation is taken on the gathered
    donor blocks, which gives the values of interpolating the whole pad
    first (it is pointwise) without a pass over the whole parent a chunk."""
    gp2 = donor_pad_width(g)
    hc = tp.donor_halo(gf)
    sizes = tuple(t // 2 + 2 * hc for t in ts)
    o = org_c.to(torch.int64)
    starts = torch.cat([torch.zeros_like(o[:, :1]), o // 2 - hc + gp2], dim=1)
    a = tp._donor_blocks(ppad_old[None], starts, sizes)
    b = tp._donor_blocks(ppad_new[None], starts, sizes)
    fine = tp.ops.prolong(_lerp(a, b, tau), active)
    crop = 2 * hc - gf
    sl = tuple(slice(crop, fine.shape[2 + d] - crop) for d in range(3))
    return fine[(slice(None), slice(None)) + sl]


def pool_parent_blocks(Up, gp_dense, rows, nbr_p, org_p, g, ts, active,
                       gp_width: int | None = None):
    """Padded parent tiles [n, nv, ts + 2 gp2] of a packed pool parent at
    one window endpoint (`make_pool_backdrop_fn.one_endpoint`): the parent
    rows, their 26 neighbour regions, the rest prolonged from the dense
    grandparent's pad `gp_dense` (of width `gp_width`, gp2 = g + 2 unless
    given)."""
    gp2 = donor_pad_width(g)
    r64 = rows.to(torch.int64)
    nbr_c = nbr_p.index_select(0, r64)
    bd0 = tp.make_backdrop_from_dense(gp_dense, org_p.index_select(0, r64), ts, gp2,
                                      gp2 if gp_width is None else gp_width, active)
    return assemble_blocks(Up, row_gather(Up, rows), nbr_c, bd0, gp2, ts)


def pool_backdrop(prepped, po_c, tau, gf, g, ts, active):
    """Backdrop of a packed level whose parent is a packed pool: the padded
    parent pair `prepped` interpolated to `tau` and prolonged."""
    p_old, p_new = prepped
    loc = torch.arange(p_old.shape[0], dtype=torch.int32, device=p_old.device)
    return tp.make_backdrop_from_pool(_lerp(p_old, p_new, tau).contiguous(), loc, po_c,
                                      ts, gf, donor_pad_width(g), active)


class ParentContext:
    """A packed level's parent for its backdrops: a dense parent's split
    pads (`mode` "dense": args = (pad_old, pad_new)) or a packed parent
    (`mode` "pool": args = (Up_old, Up_new, gp_a, gp_b, nbr_p, org_p): the
    parent's row pools at the window's ends, the dense grandparent's pads
    interpolated to those ends, the parent's tables)."""

    def __init__(self, mode: str, args):
        self.mode = mode
        self.args = args

    def prep(self, ps_c, g, ts, active):
        if self.mode != "pool":
            return None
        Uo, Un, gpa, gpb, nbr_p, org_p = self.args
        rows = torch.clamp(ps_c, min=0)
        return (pool_parent_blocks(Uo, gpa, rows, nbr_p, org_p, g, ts, active),
                pool_parent_blocks(Un, gpb, rows, nbr_p, org_p, g, ts, active))

    def backdrop(self, prepped, org_c, po_c, tau, gf, g, ts, active):
        if self.mode == "dense":
            return dense_backdrop(self.args[0], self.args[1], org_c, tau, gf, ts, g, active)
        return pool_backdrop(prepped, po_c, tau, gf, g, ts, active)


# ------------------------------------------------------ register scatters
def _face_shape(half, d):
    return tuple(2 * half[e] + (1 if e == d else 0) for e in range(3))


def scatter_restr(Facc: torch.Tensor, restr: torch.Tensor, ps_c: torch.Tensor,
                  po_c: torch.Tensor, n_act: int) -> torch.Tensor:
    """Add restricted child faces [c, nc, fx, fy, fz] into the parent-indexed
    register [Tp, nc, *faces] at each child's parent slot and coarse
    offset (`scatter_restr_faces_prog`: octant midplane faces add), for the
    first `n_act` rows (the active ones). In place; returns Facc."""
    if n_act <= 0:
        return Facc
    val = restr[:n_act]
    ps = ps_c[:n_act].to(torch.int64)
    po = po_c[:n_act].to(torch.int64)
    starts = torch.cat([ps[:, None], po], dim=1)
    lin = tp.block_index(starts, val.shape[2:], Facc.shape)
    Facc.view(-1).index_add_(0, lin.reshape(-1), val.reshape(-1))
    return Facc


def complete_face_registers(Ffine: Dict[int, torch.Tensor],
                            parent_nbr: torch.Tensor) -> Dict[int, torch.Tensor]:
    """Boundary-face completion across parent tiles: each parent's lo / hi
    face along d gains the face-neighbour parent's accumulated children
    (`quokka_tpu/amr/packed.py:499-529`)."""
    out = {}
    for d, F in Ffine.items():
        n = F.shape[2 + d]
        qlo = tp.DIRS.index(tuple(-1 if e == d else 0 for e in range(3)))
        qhi = tp.DIRS.index(tuple(1 if e == d else 0 for e in range(3)))
        nlo = parent_nbr[:, qlo].to(torch.int64)
        nhi = parent_nbr[:, qhi].to(torch.int64)
        lo_face = F.narrow(2 + d, 0, 1)
        hi_face = F.narrow(2 + d, n - 1, 1)
        from_lo = torch.where((nlo >= 0).reshape(-1, 1, 1, 1, 1),
                              hi_face.index_select(0, torch.clamp(nlo, min=0)), 0.0)
        from_hi = torch.where((nhi >= 0).reshape(-1, 1, 1, 1, 1),
                              lo_face.index_select(0, torch.clamp(nhi, min=0)), 0.0)
        F = F.clone()
        F.narrow(2 + d, 0, 1).add_(from_lo)
        F.narrow(2 + d, n - 1, 1).add_(from_hi)
        out[d] = F
    return out


# ---------------------------------------------------------- streamed hydro
def fused_hydro_advance_packed(Uph, dt, opts, meta, ps, po, parent: ParentContext,
                               th1, th2, chunk: int, active_axes, ts, own_out=False,
                               parent_cap: int = 0, restr_mode: str = "parent"):
    """One fused RK2 hydro substep of a packed level, chunk by chunk
    (`quokka_tpu/amr/packed.py:533-701`). `Uph` [cap, nh, *ts] holds the
    hydro rows; the result is a new pool (rows past the live chunks keep
    their data). Returns (Uph_new, own faces {d: [cap, nh, ...]} or None,
    the register contribution, stats): restr_mode "parent" gives the
    parent-indexed register [parent_cap, nh, faces] (pool parents),
    "child" the child-row-indexed restricted faces [cap, nh, ...] (a dense
    parent). stats: max_signal, valid (device tensors), n_fofc (device),
    fofc_fallbacks (int)."""
    g = 4
    P = 2 * g + 2
    gov = g + 2
    cap, nh = Uph.shape[:2]
    dev, dtp = Uph.device, Uph.dtype
    half = tuple(t // 2 for t in ts)
    nbr, org = meta.nbr_dev, meta.origin_dev
    n_live = -(-meta.n_active // chunk)
    out = torch.empty_like(Uph)
    out[n_live * chunk:] = Uph[n_live * chunk:]
    own_bufs = None
    Ffine = None
    if restr_mode == "parent":
        Ffine = {d: torch.zeros((parent_cap, nh) + _face_shape(half, d), dtype=dtp,
                                device=dev) for d in active_axes}
    n_fofc = torch.zeros((), dtype=torch.int64, device=dev)
    smax_all = torch.zeros((), dtype=dtp, device=dev)
    ok_all = torch.ones((), dtype=torch.bool, device=dev)
    fallbacks = 0
    for ci in range(n_live):
        i0 = ci * chunk
        sl = slice(i0, i0 + chunk)
        nbr_c, org_c, ps_c, po_c = nbr[sl], org[sl], ps[sl], po[sl]
        prepped = parent.prep(ps_c, g, ts, active_axes)
        bd1 = parent.backdrop(prepped, org_c, po_c, th1, P, g, ts, active_axes)
        bd2 = parent.backdrop(prepped, org_c, po_c, th2, gov, g, ts, active_axes)
        del prepped
        ug0 = assemble_chunk(Uph, i0, chunk, nbr_c, bd1, P, ts)
        U2, own, restr, nf, fb = fused_block_rk2(ug0, bd2, nbr_c, dt, opts, own_out,
                                                 active_axes, ts)
        del ug0, bd1, bd2
        fallbacks += fb
        out[sl] = U2
        act = torch.arange(i0, i0 + chunk, device=dev) < meta.n_active
        if own_out:
            if own_bufs is None:
                own_bufs = {d: torch.zeros((cap,) + tuple(o.shape[1:]), dtype=dtp, device=dev)
                            for d, o in own.items()}
            for d in own:
                own_bufs[d][sl] = own[d]
        if restr_mode == "parent":
            for d in restr:
                scatter_restr(Ffine[d], restr[d], ps_c, po_c, meta.n_active - i0)
        else:
            if Ffine is None:
                Ffine = {d: torch.zeros((cap,) + tuple(r.shape[1:]), dtype=dtp, device=dev)
                         for d, r in restr.items()}
            for d in restr:
                Ffine[d][sl] = restr[d]
        sig = euler.max_signal_speed(_cm(U2), opts.eos).amax(dim=(1, 2, 3))
        fin = torch.isfinite(U2).reshape(chunk, -1).all(dim=1)
        n_fofc = n_fofc + nf
        smax_all = torch.maximum(smax_all, torch.where(act, sig, 0.0).max())
        ok_all = ok_all & torch.where(act, fin, True).all()
    stats = {"max_signal": smax_all, "valid": ok_all, "n_fofc": n_fofc,
             "fofc_fallbacks": fallbacks}
    return out, own_bufs, Ffine, stats


# ------------------------------------------------------ streamed radiation
def _rad_div(fl: dict, dx) -> torch.Tensor:
    """sum_d (F_d(f) - F_d(f+1)) / dx_d of batched fluxes [c, G, 4, ...]."""
    out = None
    for d, F in fl.items():
        contrib = true_div(F - sh(F, 1, d + 3), dx[d])
        out = contrib if out is None else out + contrib
    return out


def fused_rad_subcycle_packed(Uph, Upr, time: float, dt_level: float, nsub: int, ropts,
                              hopts, sim, grid, meta, ps, po, parent: ParentContext,
                              th0, th1, chunk: int, active_axes, ts, own_out=False,
                              parent_cap: int = 0, restr_mode: str = "parent"):
    """The IMEX PD-ARS radiation subcycle of a packed level, chunk by chunk
    (`quokka_tpu/amr/packed.py:717-1031`): the stage-1 transport runs on a
    2g-deep radiation block, so the post-coupling ring the stage-2
    transport reads is recomputed in the block (the coupling is pointwise;
    ring cells take the gathered neighbour gas, so they equal the owner's
    values). The gas coupling updates the hydro rows. K7 (batched) makes
    the transport faces, K5 the coupling (batched: it reads the chunk's
    blocks and crops where they lie and writes stage 2 into the new pools'
    rows). Returns (Uph, Upr, own faces or None, register contribution,
    valid)."""
    from ..radiation import source
    from ..radiation.pool import TileGridView
    from ..radiation.sweep import compute_rad_axis_flux_batched, rad_axis_flux_plain
    from ..radiation.system import add_fluxes_rk2, predict_step

    g = 4
    g2 = 2 * g
    cap = Uph.shape[0]
    nh, nr = Uph.shape[1], Upr.shape[1]
    G = nr // 4
    dev, dtp = Uph.device, Uph.dtype
    dx = grid.dx
    half = tuple(t // 2 for t in ts)
    eos, problem = sim.eos, sim.problem
    rs = sim.layout.rad_start
    nbr, org = meta.nbr_dev, meta.origin_dev
    n_live = -(-meta.n_active // chunk)
    tsg = tuple(t + 2 * g for t in ts)
    has_src = sim._radiation._has_src
    npdt = np.float32 if dtp == torch.float32 else np.float64

    def scalar(x):
        return torch.tensor(float(npdt(x)), dtype=dtp, device=dev)

    # K7 and K5 for a float32 chunk, as the JAX package's `compute_rad_fluxes`
    # dispatches (`quokka_tpu/amr/packed.py:857`); any other dtype takes
    # their plain versions on its own device (JAX's XLA)
    f32 = dtp == torch.float32
    coupling = source.source_update_batched if f32 else source.source_update_batched_plain

    def fluxes(R):
        if f32:
            return {d: compute_rad_axis_flux_batched(R, d, ropts) for d in active_axes}
        return {d: torch.stack([rad_axis_flux_plain(r, d, ropts) for r in R])
                for d in active_axes}

    def grouped(R):  # [c, 4G, ...] -> [c * G, 4, ...]
        return R.reshape(R.shape[0] * G, 4, *R.shape[2:])

    def faces_flat(fl, gw):
        return slice_tile_faces({d: F.reshape(F.shape[0], nr, *F.shape[3:])
                                 for d, F in fl.items()}, gw, ts)

    dt_r = dt_level / nsub
    dt_f = float(npdt(dt_r))
    ben = torch.zeros((1, nh) + tsg, dtype=dtp, device=dev)
    ben[:, RHO] = 1.0
    ben[:, EGAS] = 1.0
    ben[:, EINT] = 1.0
    own_bufs = None
    Ffine = None
    ok_all = torch.ones((), dtype=torch.bool, device=dev)
    nsub_t = float(nsub)
    for i in range(nsub):
        th_a = scalar(th0 + (th1 - th0) * (i / nsub))
        th_b = scalar(th0 + (th1 - th0) * ((i + 1) / nsub))
        t_sub = float(npdt(time + i * dt_r))
        Uph_new = torch.empty_like(Uph)
        Upr_new = torch.empty_like(Upr)
        Uph_new[n_live * chunk:] = Uph[n_live * chunk:]
        Upr_new[n_live * chunk:] = Upr[n_live * chunk:]
        for ci in range(n_live):
            i0 = ci * chunk
            sl = slice(i0, i0 + chunk)
            nbr_c, org_c, ps_c, po_c = nbr[sl], org[sl], ps[sl], po[sl]
            src_b = rad_src = None
            if has_src:
                gv = TileGridView(grid, org_c - g, tsg)
                src_b = torch.as_tensor(problem.set_radiation_energy_source(
                    gv, t_sub, dtype=dtp, device=dev), dtype=dtp, device=dev)
                rad_src = _crop(src_b, g)
            prepped = parent.prep(ps_c, g, ts, active_axes)
            bd_a = parent.backdrop(prepped, org_c, po_c, th_a, g2, g, ts, active_axes)
            bd_b = parent.backdrop(prepped, org_c, po_c, th_b, g, g, ts, active_axes)
            del prepped
            R0g = assemble_chunk(Upr, i0, chunk, nbr_c, bd_a, g2, ts)
            # gas block at depth g: neighbour rows where they exist, a benign
            # constant elsewhere (overlaid with parent data before any read)
            gasg = assemble_chunk(Uph, i0, chunk, nbr_c, ben, g, ts)

            fl0 = fluxes(R0g)
            divF0 = _crop(_rad_div(fl0, dx), g)      # [c, G, 4, ts + 2g]
            R0b = _crop(R0g, g).reshape(chunk, G, 4, *tsg)
            R1b = predict_step(grouped(R0b.reshape(chunk, nr, *tsg)),
                               grouped(divF0.reshape(chunk, nr, *tsg)), dt_f, ropts)
            # stage-1 coupling of the 2g-deep block; the ring cells without a
            # neighbour tile keep their values (the backdrop overlays them)
            gas1, rad1 = coupling(gasg, R1b.reshape(chunk, nr, *tsg), src_b, dt_f, 1,
                                  ropts, eos, problem, rs, keep=ring_real_mask(nbr_c, ts, g))
            del gasg, R1b
            R1blk = overlay_backdrop(rad1, nbr_c, bd_b, g, ts)
            fl1 = fluxes(R1blk)
            divF1 = _crop(_rad_div(fl1, dx), g)
            R1n = _crop(R1blk, g)
            R_new = add_fluxes_rk2(grouped(_crop(R0b.reshape(chunk, nr, *tsg), g)),
                                   grouped(R1n),
                                   grouped(_crop(divF0.reshape(chunk, nr, *tsg), g)),
                                   grouped(divF1.reshape(chunk, nr, *ts)), dt_f, ropts)
            coupling(_crop(gas1, g), R_new.reshape(chunk, nr, *ts), rad_src, dt_f, 2, ropts,
                     eos, problem, rs, out=(Uph_new[sl], Upr_new[sl]))
            del gas1, rad1, R1blk, R_new, divF0, divF1, R0g
            own0 = faces_flat(fl0, g2)
            own1 = faces_flat(fl1, g)
            del fl0, fl1
            fin = (torch.isfinite(Uph_new[sl]).reshape(chunk, -1).all(dim=1)
                   & torch.isfinite(Upr_new[sl]).reshape(chunk, -1).all(dim=1))
            act = torch.arange(i0, i0 + chunk, device=dev) < meta.n_active
            if own_out:
                # non-leaf: the full-resolution faces summed over the
                # subcycle, restricted once after it
                own = {d: 0.5 * (own0[d] + own1[d]) for d in own0}
                if own_bufs is None:
                    own_bufs = {d: torch.zeros((cap,) + tuple(o.shape[1:]), dtype=dtp,
                                               device=dev) for d, o in own.items()}
                for d in own:
                    own_bufs[d][sl] += true_div(own[d], nsub_t)
            else:
                # restricted per transport stage before the 0.5 average
                # (the two-pass path's association)
                r0 = restrict_tile_faces(own0, active_axes)
                r1 = restrict_tile_faces(own1, active_axes)
                restr = {d: 0.5 * (r0[d] + r1[d]) for d in r0}
                if Ffine is None:
                    if restr_mode == "parent":
                        Ffine = {d: torch.zeros((parent_cap, nr) + _face_shape(half, d),
                                                dtype=dtp, device=dev) for d in active_axes}
                    else:
                        Ffine = {d: torch.zeros((cap,) + tuple(r.shape[1:]), dtype=dtp,
                                                device=dev) for d, r in restr.items()}
                for d in restr:
                    contrib = true_div(restr[d], nsub_t)
                    if restr_mode == "parent":
                        scatter_restr(Ffine[d], contrib, ps_c, po_c, meta.n_active - i0)
                    else:
                        Ffine[d][sl] += contrib
            ok_all = ok_all & torch.where(act, fin, True).all()
        Uph, Upr = Uph_new, Upr_new
    if own_out:
        restrF = restrict_tile_faces(own_bufs, active_axes)
        if restr_mode == "parent":
            Ffine = {d: torch.zeros((parent_cap, nr) + _face_shape(half, d), dtype=dtp,
                                    device=dev) for d in active_axes}
            for d in restrF:
                scatter_restr(Ffine[d], restrF[d], ps, po, meta.n_active)
        else:
            Ffine = restrF
    return Uph, Upr, own_bufs, Ffine, ok_all
