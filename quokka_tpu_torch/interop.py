"""Carry state and solver configuration across from `quokka_tpu`.

A physics solver has no weights: what the two packages must share to
compute the same step is the state and the solver configuration. Both come
as plain numpy arrays and plain dicts, so this module never imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .eos import IdealGasEOS
from .hydro.advance import HydroOptions
from .mhd.advance import MHDOptions
from .radiation.system import RadOptions


def state_from_numpy(U, device, dtype=torch.float32) -> torch.Tensor:
    """A contiguous [nvar, X, Y, Z] tensor from any array-like."""
    return torch.tensor(np.array(U), dtype=dtype, device=device).contiguous()


def hydro_options_from_fields(d: dict):
    """(HydroOptions, IdealGasEOS) from the field dict of a
    `quokka_tpu.hydro.advance.HydroOptions` (as `dataclasses.asdict` gives
    it: the EOS is a nested dict). Fields of the TPU's kernel switch and
    ghost-padded layout (`use_pallas`, `nghost`) are dropped; an unknown
    field raises."""
    eos_f = d["eos"]
    if not isinstance(eos_f, dict):
        eos_f = dataclasses.asdict(eos_f)
    eos = IdealGasEOS(**eos_f)
    known = {f.name for f in dataclasses.fields(HydroOptions)}
    fields = {k: v for k, v in d.items()
              if k not in ("eos", "use_pallas", "nghost")}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"HydroOptions fields not in the port: {sorted(unknown)}")
    fields["active_axes"] = tuple(fields["active_axes"])
    fields["dx"] = tuple(fields["dx"])
    return HydroOptions(eos=eos, **fields), eos


def rad_options_from_fields(d: dict) -> RadOptions:
    """RadOptions from the field dict of a `quokka_tpu.radiation.system.
    RadOptions` (`dataclasses.asdict`). The TPU's kernel switch
    `use_pallas` is dropped; an unknown field raises."""
    known = {f.name for f in dataclasses.fields(RadOptions)}
    fields = {k: v for k, v in d.items() if k != "use_pallas"}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"RadOptions fields not in the port: {sorted(unknown)}")
    return RadOptions(**fields)


def mhd_options_from_fields(d: dict) -> MHDOptions:
    """MHDOptions from the field dict of a `quokka_tpu.mhd.advance.MHDOptions`
    (`dataclasses.asdict`); the two have the same fields (`use_pallas`
    selects kernel K8 here). An unknown field raises."""
    known = {f.name for f in dataclasses.fields(MHDOptions)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"MHDOptions fields not in the port: {sorted(unknown)}")
    fields = dict(d)
    fields["active_axes"] = tuple(fields["active_axes"])
    fields["dx"] = tuple(fields["dx"])
    return MHDOptions(**fields)


def mhd_state_from_numpy(U, Bf, device, dtype=torch.float32):
    """(U [5, X, Y, Z], [Bf_x, Bf_y, Bf_z]) as contiguous tensors."""
    return state_from_numpy(U, device, dtype), [state_from_numpy(b, device, dtype)
                                                for b in Bf]


def amr_levels_to_numpy(sim):
    """([U_0, U_1, ...], [mask_0, mask_1, ...]) of an `AMRSimulation`'s
    levels up to its finest, as numpy arrays."""
    levels = range(sim.finest_level + 1)
    return ([sim.level_U[l].detach().cpu().numpy() for l in levels],
            [sim.level_mask[l].detach().cpu().numpy() for l in levels])



def amr_hierarchy_to_numpy(sim, prefix: str = "") -> dict:
    """An `AMRSimulation`'s hierarchy as numpy arrays: "U{l}" for a dense
    level, and for a packed level "ijk{l}" (its active tiles in slot
    order), "Uh{l}" and "Ur{l}" (their rows) -- the layout
    tests/port/jax_packed.py saves the JAX package's hierarchy in."""
    out = {}
    for l in range(sim.finest_level + 1):
        st = sim.level_pool[l] if hasattr(sim, "level_pool") else None
        if st is None:
            out[f"{prefix}U{l}"] = sim.level_U[l].detach().cpu().numpy()
            continue
        n = st.meta.n_active
        out[f"{prefix}ijk{l}"] = st.meta.ijk[:n].copy()
        out[f"{prefix}Uh{l}"] = st.Uh[:n].detach().cpu().numpy()
        if st.Ur is not None:
            out[f"{prefix}Ur{l}"] = st.Ur[:n].detach().cpu().numpy()
    return out


def load_amr_hierarchy(sim, data: dict, prefix: str = "") -> None:
    """Carry a hierarchy across (the dict `amr_hierarchy_to_numpy` makes, or
    the JAX package's as tests/port/jax_packed.py saves it) into an
    `AMRSimulation` whose initial conditions are set: the dense levels'
    states, and each packed level's tile set (rebuilt with the
    simulation's capacity rule) and rows, the linkage and the conservation
    baseline renewed, so both packages start a comparison from one state."""
    from .amr import tilepool as tp
    from .amr.sparse import PoolState

    dev, dt = sim.device, sim.dtype
    sim.level_U[0] = torch.as_tensor(np.asarray(data[f"{prefix}U0"]), dtype=dt,
                                     device=dev).contiguous()
    sim.U = sim.level_U[0]
    l = 1
    while f"{prefix}ijk{l}" in data:
        ijk = [tuple(int(v) for v in t) for t in np.asarray(data[f"{prefix}ijk{l}"])]
        cap = max(8, int(np.ceil(len(ijk) * sim.pool_headroom)))
        c = max(sim.pool_chunk, sim.packed_chunk)
        cap = ((cap + c - 1) // c) * c
        meta = tp.TileMeta.build(sim.level_grids[l].n_cell, sim.tile_shape, ijk, sim.periodic,
                                 capacity=cap, device=dev)
        if [tuple(t) for t in meta.ijk[:meta.n_active]] != ijk:
            raise ValueError(f"level {l}: the tiles are not in slot order")

        def rows(key):
            if f"{prefix}{key}{l}" not in data:
                return None
            a = torch.as_tensor(np.asarray(data[f"{prefix}{key}{l}"]), dtype=dt, device=dev)
            out = a[:1].expand(cap, *a.shape[1:]).clone()
            out[: a.shape[0]] = a
            return out

        sim.level_pool[l] = PoolState(meta=meta, Uh=rows("Uh"), Ur=rows("Ur"))
        if l > 1:
            parent = sim.level_pool[l - 1]
            st = sim.level_pool[l]
            st.parent_slot, st.parent_off = tp.parent_linkage(meta, parent.meta, dev)
            parent.child_slots = tp.child_linkage(parent.meta, meta, dev)
        l += 1
    sim.finest_level = l - 1
    for k in range(l, sim.max_level + 1):
        sim.level_pool[k] = None
    sim._root_bmasks = None
    sim._active_cell_cache.clear()
    sim.init_sums = sim._composite_sums()
