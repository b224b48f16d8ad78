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

