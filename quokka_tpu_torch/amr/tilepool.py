"""Tile-pool AMR levels: host tile bookkeeping and the per-tile operators
the packed engine needs.

Counterpart of what `quokka_tpu.amr.packed` uses of `quokka_tpu.amr.
tilepool` (``:78-590``): a pool level is a fixed-capacity set of
fixed-shape tiles (the reference's box-granular patches, AMReX
BoxArray + DistributionMapping, ``src/simulation.hpp:1421-1508``) with
host-side integer tables built once per regrid:

- `TileMeta`: tile coordinates, the 26-direction neighbour table (periodic
  wrap through the table), tile origins, the slot of each tile, the regrid
  epoch, and the capacity bucket (`grow_capacity`);
- `parent_linkage` / `child_linkage`: each tile's parent slot and octant
  offset, each tile's child slot per octant;
- the ghost-region algebra (`DIRS`, `_region`), the parent backdrops (the
  limited-linear prolongation of parent donor blocks, bitwise the dense
  composite fill's values) and the coverage masks.

Every operator takes a chunk of tiles at once: [c, nv, tx, ty, tz]
tensors, the chunk axis leading (the JAX package's `vmap`). Tables live on
the host as numpy arrays and on the device as int32/int64 tensors.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import operators as ops

# 26 non-zero direction vectors, sorted (the JAX package's build order)
DIRS = [d for d in itertools.product((-1, 0, 1), repeat=3) if d != (0, 0, 0)]

_EPOCH_COUNTER = 0


@dataclass
class TileMeta:
    """Host-side tile bookkeeping of one pool level for one regrid epoch.
    `ijk[t]` is tile t's coordinate in tile units; slots >= n_active hold
    (-1, -1, -1) and no neighbours. `nbr_dev` [capacity, 26] and
    `origin_dev` [capacity, 3] (fine cells) are the device copies."""

    level_shape: Tuple[int, int, int]
    tile_shape: Tuple[int, int, int]
    periodic: Tuple[bool, bool, bool]
    capacity: int
    n_active: int
    ijk: np.ndarray
    slot_of: Dict[Tuple[int, int, int], int] = field(default_factory=dict)
    nbr_dev: Optional[torch.Tensor] = None
    origin_dev: Optional[torch.Tensor] = None
    # monotonic regrid-epoch id (caches keyed on it, not on id(meta))
    epoch: int = -1

    @property
    def tiles_shape(self) -> Tuple[int, int, int]:
        return tuple(self.level_shape[d] // self.tile_shape[d] for d in range(3))

    @property
    def cells_per_tile(self) -> int:
        return int(np.prod(self.tile_shape))

    @property
    def active_cells(self) -> int:
        return self.n_active * self.cells_per_tile

    @staticmethod
    def build(level_shape, tile_shape, tiles: Sequence[Tuple[int, int, int]], periodic,
              capacity: Optional[int] = None, headroom: float = 1.5,
              device="cpu") -> "TileMeta":
        level_shape = tuple(int(n) for n in level_shape)
        tile_shape = tuple(int(n) for n in tile_shape)
        for d in range(3):
            if level_shape[d] % tile_shape[d] != 0:
                raise ValueError(f"tile_shape {tile_shape} does not divide level {level_shape}")
        tiles = sorted(set(tuple(int(i) for i in t) for t in tiles))
        n = len(tiles)
        if capacity is None:
            capacity = max(8, int(np.ceil(n * headroom)))
        if capacity < n:
            raise ValueError(f"capacity {capacity} < {n} active tiles")
        ijk = np.full((capacity, 3), -1, dtype=np.int32)
        if n:
            ijk[:n] = np.asarray(tiles, dtype=np.int32)
        global _EPOCH_COUNTER
        _EPOCH_COUNTER += 1
        meta = TileMeta(level_shape=level_shape, tile_shape=tile_shape,
                        periodic=tuple(bool(p) for p in periodic), capacity=capacity,
                        n_active=n, ijk=ijk, slot_of={t: s for s, t in enumerate(tiles)},
                        epoch=_EPOCH_COUNTER)
        meta._build_tables(device)
        return meta

    def _build_tables(self, device):
        TX, TY, TZ = self.tiles_shape
        nbr = np.full((self.capacity, len(DIRS)), -1, dtype=np.int32)
        for s in range(self.n_active):
            i, j, k = (int(v) for v in self.ijk[s])
            for q, (a, b, c) in enumerate(DIRS):
                ii, jj, kk = i + a, j + b, k + c
                if self.periodic[0]:
                    ii %= TX
                if self.periodic[1]:
                    jj %= TY
                if self.periodic[2]:
                    kk %= TZ
                if 0 <= ii < TX and 0 <= jj < TY and 0 <= kk < TZ:
                    nbr[s, q] = self.slot_of.get((ii, jj, kk), -1)
        origin = np.maximum(self.ijk * np.asarray(self.tile_shape, np.int32), 0)
        self.nbr_dev = torch.as_tensor(nbr, device=device)
        self.origin_dev = torch.as_tensor(origin.astype(np.int32), device=device)

    def grow_capacity(self, n_needed: int, headroom: float = 1.5) -> int:
        """Capacity bucket for n_needed tiles, grown by `headroom`."""
        if n_needed <= self.capacity:
            return self.capacity
        return max(int(np.ceil(n_needed * headroom)), self.capacity + 1)


def _region(tile_shape, g: int, d3):
    """(src, dst) slices for direction d3: src cuts the NEIGHBOUR tile's
    interior, dst the padded block's ghost region."""
    src, dst = [], []
    for d, a in enumerate(d3):
        t = tile_shape[d]
        if a == 0:
            src.append(slice(0, t))
            dst.append(slice(g, g + t))
        elif a > 0:  # the +1 neighbour supplies the hi ghosts from its lo edge
            src.append(slice(0, g))
            dst.append(slice(g + t, 2 * g + t))
        else:        # the -1 neighbour supplies the lo ghosts from its hi edge
            src.append(slice(t - g, t))
            dst.append(slice(0, g))
    return tuple(src), tuple(dst)


def donor_halo(g: int) -> int:
    """Coarse halo of a prolongation donor block: g/2 coarse cells under the
    fine ghosts, +1 so every used coarse cell's slopes and limiter see its
    real neighbourhood."""
    return g // 2 + 1


_BLOCK_OFFSETS: Dict[tuple, torch.Tensor] = {}


def block_index(starts: torch.Tensor, sizes, shape) -> torch.Tensor:
    """Flat indices [c, nv, n0, n1, n2] of the blocks
    A[b_i][:, s0:s0+n0, s1:s1+n1, s2:s2+n2] of a contiguous A of `shape`
    [nb, nv, X, Y, Z], one block a row (b_i, s0, s1, s2) of the int64 [c, 4]
    tensor `starts`: each block's base offset plus the offsets inside a
    block (cached by shape)."""
    _, nv, X, Y, Z = shape
    key = (tuple(sizes), tuple(shape[1:]), str(starts.device))
    local = _BLOCK_OFFSETS.get(key)
    if local is None:
        dev = starts.device
        ix, iy, iz = (torch.arange(n, device=dev) for n in sizes)
        local = ((torch.arange(nv, device=dev)[:, None, None, None] * X
                  + ix[:, None, None]) * Y + iy[:, None]) * Z + iz
        _BLOCK_OFFSETS[key] = local
    base = ((starts[:, 0] * nv * X + starts[:, 1]) * Y + starts[:, 2]) * Z + starts[:, 3]
    return base[:, None, None, None, None] + local


def _donor_blocks(src: torch.Tensor, starts: torch.Tensor, sizes) -> torch.Tensor:
    """The blocks of `block_index` gathered from the contiguous src, reading
    only the blocks: [c, nv, n0, n1, n2]."""
    return torch.take(src, block_index(starts, sizes, src.shape))


def make_backdrop_from_dense(parent_padded: torch.Tensor, origin_c: torch.Tensor,
                             tile_shape, g: int, gp: int, active_axes) -> torch.Tensor:
    """Prolonged-parent backdrop [c, nv, t + 2g, ...] of each tile of a
    chunk from a dense parent padded by `gp` ([nv, X + 2gp, ...]);
    `origin_c` [c, 3] the tiles' origins in fine cells. Bitwise the slice of
    `ops.prolong(parent)` (the donor block carries every coarse cell the
    used slopes and limits read)."""
    hc = donor_halo(g)
    if gp < hc:
        raise ValueError(f"parent ghost width {gp} < donor halo {hc}")
    sizes = tuple(t // 2 + 2 * hc for t in tile_shape)
    o = origin_c.to(torch.int64)
    starts = torch.cat([torch.zeros_like(o[:, :1]), o // 2 - hc + gp], dim=1)
    donors = _donor_blocks(parent_padded[None], starts, sizes)
    fine = ops.prolong(donors, active_axes)
    crop = 2 * hc - g
    sl = tuple(slice(crop, fine.shape[2 + d] - crop) for d in range(3))
    return fine[(slice(None), slice(None)) + sl]


def make_backdrop_from_pool(parent_padded_pool: torch.Tensor, parent_slot: torch.Tensor,
                            parent_off: torch.Tensor, tile_shape, g: int, gp: int,
                            active_axes) -> torch.Tensor:
    """The same from a pool parent's padded tiles [Tp, nv, ptx + 2gp, ...];
    parent_off [c, 3] is each tile's coarse-image offset inside its parent
    tile (0 or t/2 per axis)."""
    hc = donor_halo(g)
    if gp < hc:
        raise ValueError(f"parent ghost width {gp} < donor halo {hc}")
    sizes = tuple(t // 2 + 2 * hc for t in tile_shape)
    slot = torch.clamp(parent_slot.to(torch.int64), min=0)
    starts = torch.cat([slot[:, None], parent_off.to(torch.int64) - hc + gp], dim=1)
    donors = _donor_blocks(parent_padded_pool, starts, sizes)
    fine = ops.prolong(donors, active_axes)
    crop = 2 * hc - g
    sl = tuple(slice(crop, fine.shape[2 + d] - crop) for d in range(3))
    return fine[(slice(None), slice(None)) + sl]


def coverage_mask_dense(meta: TileMeta, device) -> torch.Tensor:
    """Dense bool mask of the pool's covered cells (tile-granular)."""
    TX, TY, TZ = meta.tiles_shape
    cov = np.zeros((TX, TY, TZ), dtype=bool)
    ijk = meta.ijk[: meta.n_active]
    if len(ijk):
        cov[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True
    out = torch.as_tensor(cov, device=device)
    for d, t in enumerate(meta.tile_shape):
        out = torch.repeat_interleave(out, t, dim=d)
    return out


def coverage_cells(child_slots: torch.Tensor, tile_shape) -> torch.Tensor:
    """Cellwise covered mask per parent tile [Tp, tx, ty, tz] from the
    octant coverage (whole octants are refined)."""
    out = child_slots >= 0
    for d, t in enumerate(tile_shape):
        out = torch.repeat_interleave(out, t // 2, dim=1 + d)
    return out


def parent_linkage(meta: TileMeta, parent_meta: Optional[TileMeta], device):
    """(parent_slot [T], parent_off [T, 3]) of a pool level whose parent is
    a pool: each fine tile's coarse image is one octant of one parent
    tile."""
    if parent_meta is None:
        return None, None
    ps = np.full(meta.capacity, -1, dtype=np.int32)
    po = np.zeros((meta.capacity, 3), dtype=np.int32)
    for s in range(meta.n_active):
        i, j, k = (int(v) for v in meta.ijk[s])
        slot = parent_meta.slot_of.get((i // 2, j // 2, k // 2), -1)
        if slot < 0:
            raise ValueError(f"fine tile {(i, j, k)} not nested in parent coverage")
        ps[s] = slot
        po[s] = [(i % 2) * (meta.tile_shape[0] // 2), (j % 2) * (meta.tile_shape[1] // 2),
                 (k % 2) * (meta.tile_shape[2] // 2)]
    return torch.as_tensor(ps, device=device), torch.as_tensor(po, device=device)


def child_linkage(parent_meta: TileMeta, child_meta: TileMeta, device) -> torch.Tensor:
    """child_slots [Tp, 2, 2, 2]: the child slot covering each octant of
    each parent tile (-1 = unrefined)."""
    cs = np.full((parent_meta.capacity, 2, 2, 2), -1, dtype=np.int32)
    for s in range(parent_meta.n_active):
        i, j, k = (int(v) for v in parent_meta.ijk[s])
        for a, b, c in itertools.product(range(2), repeat=3):
            cs[s, a, b, c] = child_meta.slot_of.get((2 * i + a, 2 * j + b, 2 * k + c), -1)
    return torch.as_tensor(cs, device=device)
