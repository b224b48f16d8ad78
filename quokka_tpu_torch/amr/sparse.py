"""Pool-level state and its streamed construction.

Counterpart of what the packed engine uses of `quokka_tpu.amr.sparse`:
`PoolState` (one pool level's device state, tables and linkage),
`stream_pool_build` (a pool built chunk by chunk into a preallocated
buffer, with the persistent tiles' old data carried through a regrid) and
`fine_faces_to_dense` (a pool child's restricted tile faces assembled into
the dense parent's face arrays for its flux register). The unpacked pool
paths (`prolong_*`, `pool_advance.advance_pool_*`) are not ported: a pool
level of the port is always packed (`amr.pool_packed = 1`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F_nn

from . import tilepool as tp


@dataclass
class PoolState:
    """One packed pool level: the hydro rows `Uh` [cap, nh, tx, ty, tz] and
    the radiation rows `Ur` [cap, 4G, tx, ty, tz] (None without radiation),
    the tables, and the linkage to a pool parent (`parent_slot`,
    `parent_off`) and to the children (`child_slots`, rebuilt when the
    child regrids)."""

    meta: tp.TileMeta
    Uh: torch.Tensor
    Ur: Optional[torch.Tensor] = None
    parent_slot: Optional[torch.Tensor] = None
    parent_off: Optional[torch.Tensor] = None
    child_slots: Optional[torch.Tensor] = None
    cov_dense: Optional[torch.Tensor] = None

    def coverage_dense(self) -> torch.Tensor:
        if self.cov_dense is None:
            self.cov_dense = tp.coverage_mask_dense(self.meta, self.Uh.device)
        return self.cov_dense

    def no_children(self) -> torch.Tensor:
        return torch.full((self.meta.capacity, 2, 2, 2), -1, dtype=torch.int32,
                          device=self.Uh.device)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.Uh, self.Ur)
                   if t is not None)


def stream_pool_build(produce, per_chunk_args, cap: int, chunk: int, n_active: int,
                      out_tail, dtype, device, old_U=None, remap=None) -> torch.Tensor:
    """A [cap, *out_tail] pool built chunk by chunk into one preallocated
    buffer (`quokka_tpu/amr/sparse.py:79-171`): `produce(*chunk_args)`
    gives a chunk's rows, `per_chunk_args` are [cap, ...] tensors sliced
    per chunk. Rows >= `n_active` hold row 0's data (benign spare slots, so
    every pass over the pool stays finite); with `old_U`/`remap` the rows
    whose remap is >= 0 carry the old pool's row (a tile that persists
    through the regrid keeps its data)."""
    out = torch.empty((cap, *out_tail), dtype=dtype, device=device)
    row0 = None
    for i0 in range(0, cap, chunk):
        r = min(chunk, cap - i0)
        if i0 >= n_active and row0 is not None:
            out[i0:i0 + r] = row0
            continue
        data = produce(*(a[i0:i0 + r] for a in per_chunk_args))
        if row0 is None:
            row0 = data[0].clone()
        valid = (torch.arange(i0, i0 + r, device=device) < n_active).reshape(
            (r,) + (1,) * len(out_tail))
        data = torch.where(valid, data, row0)
        if old_U is not None:
            rows = remap[i0:i0 + r]
            keep = (rows >= 0).reshape((r,) + (1,) * len(out_tail)) & valid
            carried = old_U.index_select(0, torch.clamp(rows, min=0).to(torch.int64))
            data = torch.where(keep, carried, data)
        out[i0:i0 + r] = data
    return out


def _unblock(flat: torch.Tensor, grid, tile) -> torch.Tensor:
    """[G0*G1*G2, nc, *tile] blocks -> dense [nc, G0*t0, G1*t1, G2*t2]."""
    nc = flat.shape[1]
    b = flat.reshape(*grid, nc, *tile)
    b = b.permute(3, 0, 4, 1, 5, 2, 6)
    return b.reshape(nc, grid[0] * tile[0], grid[1] * tile[1], grid[2] * tile[2])


def fine_faces_to_dense(F_restr: Dict[int, torch.Tensor], meta: tp.TileMeta,
                        ng: Tuple[int, int, int]) -> Dict[int, torch.Tensor]:
    """The dense coarse-level face-flux dict (padded face coordinates, the
    `ops.restrict_face_flux` layout) of per-tile restricted child fluxes
    with faces [0..t/2] inclusive (`quokka_tpu/amr/sparse.py:320-396`). A
    face shared by two adjacent child tiles is computed alike by both, so
    the hi planes fill only the faces the lo-side pass left unwritten."""
    tsc = tuple(t // 2 for t in meta.tile_shape)
    TX, TY, TZ = meta.tiles_shape
    Xc = (TX * tsc[0], TY * tsc[1], TZ * tsc[2])
    ijk = meta.ijk[: meta.n_active].astype("int64")
    some = next(iter(F_restr.values()))
    dev = some.device
    lin = torch.as_tensor((ijk[:, 0] * TY + ijk[:, 1]) * TZ + ijk[:, 2], device=dev)
    out = {}
    for d, F in F_restr.items():
        nc = F.shape[1]
        Fa = F[: meta.n_active]
        lo_sl = [slice(None)] * 3
        lo_sl[d] = slice(0, tsc[d])
        flat = torch.zeros((TX * TY * TZ, nc, *tsc), dtype=F.dtype, device=dev)
        flat[lin] = Fa[(slice(None), slice(None)) + tuple(lo_sl)]
        dense_lo = _unblock(flat, (TX, TY, TZ), tsc)
        face_shape = list(Xc)
        face_shape[d] += 1
        full = torch.zeros((nc, *face_shape), dtype=F.dtype, device=dev)
        inner = [slice(None)] * 3
        inner[d] = slice(0, Xc[d])
        full[(slice(None),) + tuple(inner)] = dense_lo
        grid1 = [TX, TY, TZ]
        grid1[d] += 1
        plane = list(tsc)
        plane[d] = 1
        hi_sl = [slice(None)] * 3
        hi_sl[d] = slice(tsc[d], tsc[d] + 1)
        planes = torch.zeros((grid1[0] * grid1[1] * grid1[2], nc, *plane), dtype=F.dtype,
                             device=dev)
        ijk1 = ijk.copy()
        ijk1[:, d] += 1
        lin1 = torch.as_tensor((ijk1[:, 0] * grid1[1] + ijk1[:, 1]) * grid1[2] + ijk1[:, 2],
                               device=dev)
        planes[lin1] = Fa[(slice(None), slice(None)) + tuple(hi_sl)]
        pdense = _unblock(planes, tuple(grid1), tuple(plane))
        stride = [slice(None)] * 3
        stride[d] = slice(0, Xc[d] + 1, tsc[d])
        cur = full[(slice(None),) + tuple(stride)]
        wrote = torch.zeros(TX * TY * TZ, dtype=torch.bool, device=dev)
        wrote[lin] = True
        wrote = wrote.reshape(TX, TY, TZ)
        for e in range(3):
            if e != d:
                wrote = torch.repeat_interleave(wrote, tsc[e], dim=e)
        epad = [0, 0, 0, 0, 0, 0]
        epad[2 * (2 - d) + 1] = 1  # face Xc (block TX) is never written by the lo pass
        wrote = F_nn.pad(wrote, epad)
        full[(slice(None),) + tuple(stride)] = torch.where(wrote[None], cur, pdense)
        pad = []
        for e in reversed(range(3)):
            ge = ng[e]
            pad += [ge, max(ge - 1, 0)] if e == d else [ge, ge]
        out[d] = F_nn.pad(full, pad)
    return out
