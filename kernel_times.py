#!/usr/bin/env python3
"""Time kernels K1, K4, K5, K2's face kernel, K2's sweeps with a divergence,
K2c, K2e, K2d, K6, K7, K8 and K9 of one tree of quokka_tpu_torch on the card,
at the main paths' shapes, so that two trees (a parent and a change) can be
compared in one call on one card, in turns (parent, change, change, parent),
each turn a process of its own:

    python3 kernel_times.py [--tree DIR] [--check]
                            [--only k1,k4,k5,k2,k7,k9,k2c,k2e,k8,k2s,k2d,k6,k6g,
                                    k3,plm,scalars]
                            [--shell FILE] [--tiles]
    python3 kernel_times.py --capture FILE
    python3 kernel_times.py --histogram --shell FILE

DIR is a checkout of the repository (default: the one that holds this
script); its quokka_tpu_torch is imported and its kernels are built in it.
With --check every timed launch is also held against its plain version
(K7 and K9 bitwise; K2's faces within rtol 1e-5 + 64 ulps of each
component's max, K5 within 2e-5 of it, each with its largest deviation
printed). Prints the card's name and power limit, then one JSON line
{"tree": DIR, "device": ..., "times": {...}, "checks": {...}, "errors":
{...}}; times are milliseconds a call (CUDA events, mean of 5 calls after
a warm-up).

--capture FILE runs the packed shell (`DECK_256_PACKED`, chunks of 512
tiles) until the matter coupling of the first level-2 chunk has run both
stages, saves that chunk's K5 inputs to FILE (about 0.4 GB) and stops: the
stage-1 gas and radiation blocks [512, 6 | 4, 24^3], the radiation source
and the ring mask of real cells, the stage-2 gas (cropped from the stage-1
result), radiation and source at 16^3, dt and the radiation options. It
works with the trees before and after K5 took strided views.

Kernels and inputs, made on the card from fixed seeds where not captured:
- K1 (`hydro.sweep._transverse_cuda`, every axis, conserved input; `--only
  k1`): 256^3 with reflecting walls (Sedov), the packed chunk of 512
  level-1 blocks of 36^3, and 512^3 with walls (the lean path), as the
  tree's wrapper launches it; a tree with one launch an axis also its two
  `torch.minimum` folds alone; --check holds each bitwise to the plain
  version;
- K4 (`radiation.substep.fused_stage1/2`; `--only k4`): both stages on
  RadhydroBench 256^3 after 2 steps, stage 2 on stage 1's output;
- K5: RadhydroBench 256^3 after 2 steps (`DECK_256`), stage 1 and stage
  2 on that state, as `chip_smoke.py` phase 3 runs them; with --shell, the
  captured level-2 chunk: the launch alone (the tree's form: the parent
  folds the chunk into one contiguous [10, 512 * X, Y, Z] state, the
  change reads the views where they lie) and the launch with the glue
  around it on the main path (the parent's concatenations, transposes,
  `torch.where` and copies; the change allocates the stage-1 outputs and
  writes stage 2 into the pools' rows);
- K2's face kernel (`hydro.sweep._axis_faces_cuda`, one launch an axis,
  conserved input): a 256^3 state with reflecting walls on every axis (the
  Sedov shape, hi-wall planes included), the dense shell's padded fine
  level [6, 520^3] (periodic, roll semantics), and the packed chunk's
  blocks, 512 x 36^3 (stage 1) and 512 x 28^3 (stage 2) in PPM and 512 x
  36^3 in first order; K1's fields come from the tree's own K1;
- K7 (`compute_rad_axis_flux_batched`), each axis: one radiation block at
  the dense shell's padded fine level, [1, 4, 520, 520, 520], and the
  packed engine's chunk of 512 blocks of 32^3; E ~ 1 with 10% of the cells
  at 2e-10, |f| up to 0.5 with 10% of the cells at 0.9999 (so the
  donor-cell fallback fires), c = 10, PPM;
- K9 (`amr.packed.row_gather`): the 26 neighbour rows of 64 and of 512
  consecutive tiles of a raster lattice of 32 x 32 x 28 tiles (the packed
  shell's level 2 holds 28464), a missing neighbour clamped to row 0, from
  a hydro pool (rows of 6 x 16^3 f32) and a radiation pool (4 x 16^3);
  beside each, one `torch.index_select` with its int64 index built
  beforehand.

- K2c (`compute_axis_flux(div_only=True)`; `--only k2c`): seeded blocks at
  512^3 with reflecting walls and with x periodic, each axis clean, onto
  running totals (acc) and with a seeded FOFC mask (fo_mask), and a clean
  stage (x clean, y and z onto its totals) with its peak memory;
- K2e (`--only k2e`): a seeded stage at 256^3, periodic, with the
  boundary-face masks of a box (`box_masks`), stage 1 and stage 2 blended
  with stage 1's first-order fluxes (fo_from); --check holds each stage to
  the plain version;
- K8 (`compute_mhd_axis`; `--only k8`): Orszag-Tang 256^3 after 3 steps,
  each axis, PLM (its deck) and PPM; --check against the plain version.
- K2's sweeps with a divergence (`compute_axis_flux` with dx_axis; `--only
  k2s`): seeded states at 256^3 with reflecting walls, stage 1 (faces and
  divergences) and stage 2 (a second state averaged with the first's
  stage-1 faces), per axis and for 3 axes; `--only k2d`: stage 1 and K2d
  the same way at the dense shell's padded 520^3 (periodic);
- K6 (`--only k6`): RadhydroBench 256^3 after 2 steps, per axis
  (`compute_rad_div`) and the three axes as `radiation.system.
  rad_transport_div` computes them (a parent: three outputs and two
  PyTorch adds).
- K6 over 4 photon groups (`--only k6g`): rough seeded blocks of 4 groups
  at RadMultigroupPulse's 256^3, per axis (one launch over the groups) and
  as `rad_transport_div` launches them; a tree whose K6 takes one group
  says so and times nothing.
- K3 (`apply_update`; `--only k3`): a seeded stage at 256^3 and on the
  hybrid layout's x-padded stage input (264 x 256^2, ng 4), as the tree's
  wrapper launches it.
- K2's PLM and scalar forms (`--only plm`, `--only scalars`; a tree
  without them says so and times nothing): with PLM (the radhydro shell's
  deck), K1 (dmin alone) and K2 stage 1 and 2 per axis at 256^3,
  periodic, and the face kernel per axis; with one passive scalar
  (Rayleigh-Taylor 3D), K1 at nv = 7, K2 stage 1 and 2 per axis at 256^3
  with z walls, a clean K2c stage at 256 x 256 x 384 with z walls and K3
  at 256^3; with --check each against its plain version.

--dump FILE saves the face kernel's outputs (PPM and first order, every
axis, with and without viscosity and reconstruct_eint) on seeded blocks at
its edge shapes and slices of the main shapes; with `--only k1,k4` instead
K1's outputs (PPM, reconstruct_eint, PLM; walls and periodic) and both K4
stages' (orders 1-3, opacities with and without a T exponent) on seeded
states at K4's edge shapes and 64^3; with `--only k2c,k2e,k8` K2c's and
K2e's outputs in every variant at LEAN_DUMP_SHAPES (extents 4 and 5,
ragged tiles, walls, periodic and mixed axes; with and without viscosity
and reconstruct_eint), K2c at 512^3 (walls and x periodic) and at 256^3
with fo_from, K2e's two seeded stages at 256^3, and K8's (orders 1-3,
floors off and on) on rough states at the same extents and on Orszag-Tang
256^3, large outputs as SHA-256 digests of their bits; with `--only
k2s,k2d,k6` K2's sweeps (stage 1, first order, stage 2, K2d; with and
without viscosity and reconstruct_eint) at LEAN_DUMP_SHAPES, stage 1 and 2
at 256^3 and stage 1 and K2d at 520^3, and K6 per axis and through
`rad_transport_div` at K4_DUMP_SHAPES (orders 1-3) and on RadhydroBench
256^3; with `--only k3` K3's outputs (the updated state and its invalid
count) on seeded stages at K4_DUMP_SHAPES and padded along x, with the
floors and the dual-energy sync each on and off; --compare A B says
whether two trees' dumps are the same bits.

--tiles times the face kernel at the three shapes with each tile of
`TILE_VARIANTS` (faces along the axis x lines across), where the tree's
`hydro.sweep._face_tile` chooses them; with `--only k1`, K1 at its three
shapes with each of K1_MARCH_VARIANTS planes a block; with `--only
k2c,k8`, K2c's clean 512^3 stage and K8's three PLM axes with each tile
bound of LEAN_TILE_VARIANTS and K8_TILE_VARIANTS; with `--only k2s`, K2's
sweeps per axis (stage 1 and 2 at 256^3 with walls, stage 1 and K2d at
520^3) with each x and y sweep tile bound of SWEEP_TILE_VARIANTS.

--histogram counts the Newton residual evaluations of every cell with the
plain version (`counts["cell_resid"]`; the kernel runs the same
iterations: it equals the plain version bit for bit) on RadhydroBench
256^3 and, with --shell, on the captured chunk, at both stages: the mean
over cells against the mean over warps (32 consecutive cells, as the
kernel's threads take them) of what a warp runs, the sum over Newton
solves of its lanes' maximum.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

# (faces along the axis, lines across) tried by --tiles
TILE_VARIANTS = ((32, 16), (32, 8), (64, 8), (16, 16), (16, 32))


def lattice_rows(shape, first, count):
    """The 26 neighbour rows of tiles first .. first + count - 1 of a
    raster-ordered lattice of tiles, a neighbour outside the lattice
    clamped to row 0: int32 [count * 26]."""
    nx, ny, nz = shape
    t = np.arange(first, first + count)
    ijk = np.stack([t // (ny * nz), (t // nz) % ny, t % nz], axis=1)
    offs = np.array([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)
                     if (a, b, c) != (0, 0, 0)])
    nb = ijk[:, None, :] + offs[None]
    inside = np.all((nb >= 0) & (nb < np.array(shape)), axis=2)
    idx = (nb[..., 0] * ny + nb[..., 1]) * nz + nb[..., 2]
    return np.where(inside, idx, 0).reshape(-1).astype(np.int32)


def rad_blocks(torch, nbatch, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = torch.empty((nbatch, 4, n, n, n), dtype=torch.float32, device="cuda")
    for b in range(nbatch):  # block by block: the f64 temporaries stay small
        def rand(*s):
            return torch.rand(s, generator=g, device="cuda", dtype=torch.float64)

        E = 0.5 + rand(n, n, n)
        E[rand(n, n, n) < 0.1] = 2e-10
        nvec = torch.randn((3, n, n, n), generator=g, device="cuda", dtype=torch.float64)
        nvec /= nvec.norm(dim=0)
        fmag = 0.5 * rand(n, n, n)
        fmag[rand(n, n, n) < 0.1] = 0.9999
        out[b, 0] = E
        out[b, 1:] = nvec * fmag * 10.0 * E
        del E, nvec, fmag
    return out


# ------------------------------------------------------------------ capture
class _Captured(Exception):
    pass


def capture(path, overrides=(), device="cuda"):
    """Run the packed shell until the first level-2 chunk's coupling has
    run both stages; save its K5 inputs (tree-independent, unfolded).
    `overrides` and `device` shrink the run for a rehearsal on the CPU."""
    import torch

    from quokka_tpu_torch import ParmParse
    from quokka_tpu_torch.amr import AMRSimulation
    from quokka_tpu_torch.amr import packed
    from quokka_tpu_torch.problems import radhydro_shell
    from quokka_tpu_torch.radiation import source

    sim = AMRSimulation(radhydro_shell.RadhydroShellProblem(), ParmParse.from_string(
        radhydro_shell.DECK_256_PACKED, [
            "verbose=0", f"amr.packed_chunk={radhydro_shell.CARD_PACKED_CHUNK}",
            *overrides]), device=device)
    sim.set_initial_conditions()
    got, on = {}, [False]
    subcycle, mask_fn = packed.fused_rad_subcycle_packed, packed.ring_real_mask

    def level_subcycle(*args, **kw):
        on[0] = args[9] is sim.level_pool[2].meta
        return subcycle(*args, **kw)

    def keep(*args, **kw):
        m = mask_fn(*args, **kw)
        if on[0] and "stage1" in got and "keep" not in got["stage1"]:
            got["stage1"]["keep"] = m.clone()
        return m

    def record(stage, gas, rad, src, dt, opts, eos):
        entry = {"gas": gas.contiguous().clone(), "rad": rad.contiguous().clone(),
                 "src": None if src is None else src.contiguous().clone(), "dt": dt}
        got[f"stage{stage}"] = entry
        got["ropts"], got["eos"] = opts, eos
        if stage == 2:
            got["stage1"].setdefault("keep", None)
            raise _Captured()

    if hasattr(source, "source_update_batched"):
        inner = source.source_update_batched

        def coupling(gas, rad, src, dt, stage, *args, keep=None, out=None):
            res = inner(gas, rad, src, dt, stage, *args, keep=keep, out=out)
            if on[0] and f"stage{stage}" not in got:
                record(stage, gas, rad, src, dt, *args[:2])
                if keep is not None:
                    got["stage1"]["keep"] = keep.clone()
            return res

        patches = [(source, "source_update_batched", coupling)]
    else:
        inner = source.source_update

        def coupling(U, src, dt, stage, *args):
            res = inner(U, src, dt, stage, *args)
            if on[0] and f"stage{stage}" not in got:
                nv, cx, Y, Z = U.shape
                blk = U.reshape(nv, cx // Y, Y, Y, Z).transpose(0, 1)
                record(stage, blk[:, :6], blk[:, 6:],
                       None if src is None else src.reshape(cx // Y, Y, Y, Z), dt, *args[:2])
            return res

        patches = [(source, "source_update", coupling), (packed, "ring_real_mask", keep)]
    patches.append((packed, "fused_rad_subcycle_packed", level_subcycle))
    saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
    for m, a, fn in patches:
        setattr(m, a, fn)
    try:
        sim.max_timesteps = 1
        sim.evolve()
        raise SystemExit("the coarse step ended before a level-2 chunk's coupling ran")
    except _Captured:
        pass
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
    torch.save(got, path)
    s1, s2 = got["stage1"], got["stage2"]
    print(f"captured the first level-2 chunk: stage 1 gas {tuple(s1['gas'].shape)}, "
          f"keep {None if s1['keep'] is None else tuple(s1['keep'].shape)}, stage 2 rad "
          f"{tuple(s2['rad'].shape)}, dt {s1['dt']!r}, source {s1['src'] is not None}",
          flush=True)


# ---------------------------------------------------------------- the kernels
def shell_k5(torch, shell, kernel_check, source, problem, check, times, checks, errors):
    """K5 on the captured level-2 chunk, at both stages: the launch alone
    and with its glue, in the tree's own form."""
    from quokka_tpu_torch.amr.packed import _crop

    ropts, eos = shell["ropts"], shell["eos"]
    rs = source.RAD_START
    g = 4
    batched = hasattr(source, "source_update_batched")
    s1, s2 = shell["stage1"], shell["stage2"]
    c = s1["gas"].shape[0]
    # stage 2 reads the stage-1 gas through a crop of the [c, 6, 24^3] block
    gas_full = torch.zeros((c, 6) + tuple(s1["gas"].shape[2:]), device="cuda")
    _crop(gas_full, g).copy_(s2["gas"])
    gas2 = _crop(gas_full, g)
    src2 = None
    if s2["src"] is not None:
        src_full = torch.zeros((c,) + tuple(s1["gas"].shape[2:]), device="cuda")
        _crop(src_full, g).copy_(s2["src"])
        src2 = _crop(src_full, g)
    Uph_new = torch.empty_like(s2["gas"])
    Upr_new = torch.empty_like(s2["rad"])

    def fold(gas, rad, src):
        U = torch.cat([gas, rad], dim=1)
        nv, sp = U.shape[1], U.shape[2:]
        Uf = U.transpose(0, 1).reshape(nv, c * sp[0], *sp[1:]).contiguous()
        rf = None if src is None else src.reshape(c * sp[0], *sp[1:]).contiguous()
        return U, Uf, rf

    def plain(stage, gas, rad, src, keep):
        out = []
        for b in range(c):
            U = torch.cat([gas[b], rad[b]])
            r = source.source_update_plain(U, None if src is None else src[b], s1["dt"],
                                           stage, ropts, eos, problem, rs)
            if keep is not None:
                r = torch.where(keep[b][None], r, U)
            out.append(r)
        return torch.stack(out)

    for stage, gas, rad, src, keep in ((1, s1["gas"], s1["rad"], s1["src"], s1["keep"]),
                                       (2, gas2, s2["rad"], src2, None)):
        dt = s1["dt"] if stage == 1 else s2["dt"]
        key = f"K5 shell chunk stage {stage} {tuple(rad.shape[:1] + rad.shape[2:])}"
        if batched:
            outs = (None if stage == 1 else (Uph_new, Upr_new))

            def launch(gas=gas, rad=rad, src=src, keep=keep, stage=stage, dt=dt, outs=outs):
                return source.source_update_batched(gas, rad, src, dt, stage, ropts, eos,
                                                    problem, rs, keep=keep, out=outs)

            glue = launch

            def result():
                return torch.cat(launch(), dim=1)
        else:
            U, Uf, rf = fold(gas, rad, src)

            def launch(Uf=Uf, rf=rf, stage=stage, dt=dt):
                return source.source_update(Uf, rf, dt, stage, ropts, eos, problem, rs)

            def glue(gas=gas, rad=rad, src=src, keep=keep, stage=stage, dt=dt):
                Ub, Ufl, rfl = fold(gas, rad, src)
                U2 = source.source_update(Ufl, rfl, dt, stage, ropts, eos, problem, rs)
                U2 = U2.reshape(Ub.shape[1], c, *Ub.shape[2:]).transpose(0, 1)
                if keep is not None:
                    return torch.where(keep[:, None], U2, Ub)
                Uph_new.copy_(U2[:, :6])
                Upr_new.copy_(U2[:, 6:])
                return U2

            def result(launch=launch, U=U, keep=keep):
                r = launch().reshape(U.shape[1], c, *U.shape[2:]).transpose(0, 1)
                return r if keep is None else torch.where(keep[:, None], r, U)
        times[key] = kernel_check.time_ms(launch)
        times[key + " with glue"] = kernel_check.time_ms(glue)
        if check:
            ok, max_abs, _ = kernel_check.compare_scaled(result(), plain(stage, gas, rad, src,
                                                                         keep))
            checks[key], errors[key] = ok, max_abs
        print(f"  {key}: {times[key]:.3f} ms, with glue {times[key + ' with glue']:.3f} ms"
              + (f", max_abs {errors[key]:.3e} ok {checks[key]}" if check else ""),
              flush=True)


def radbench_state(torch):
    """RadhydroBench 256^3 f32 after 2 steps: (state, dt of a substep, sim)."""
    from quokka_tpu_torch import ParmParse, Simulation
    from quokka_tpu_torch.problems.radhydro_bench import DECK_256, RadhydroBenchProblem

    sim = Simulation(RadhydroBenchProblem(), ParmParse.from_string(
        DECK_256, ["max_timesteps=2", "verbose=0"]), device="cuda", precision="single")
    sim.set_initial_conditions()
    sim.evolve()
    rad = sim._radiation
    nsub = rad.n_substeps(sim.dt_prev)
    dt_rad = float(torch.tensor(sim.dt_prev / nsub, dtype=torch.float32))
    return sim.U, dt_rad, sim


def time_k5(torch, args, shell, times, checks, errors):
    from quokka_tpu_torch import kernel_check
    from quokka_tpu_torch.problems.radhydro_bench import RadhydroBenchProblem
    from quokka_tpu_torch.problems.radhydro_shell import RadhydroShellProblem
    from quokka_tpu_torch.radiation import source

    U, dt_rad, sim = radbench_state(torch)
    opts, eos, prob = sim._radiation.opts, sim.eos, RadhydroBenchProblem()
    for stage in (1, 2):
        key = f"K5 RadhydroBench 256^3 stage {stage}"
        times[key] = kernel_check.time_ms(lambda: source.source_update(
            U, None, dt_rad, stage, opts, eos, prob, source.RAD_START))
        if args.check:
            ok, max_abs, _ = kernel_check.compare_scaled(
                source.source_update(U, None, dt_rad, stage, opts, eos, prob,
                                     source.RAD_START),
                source.source_update_plain(U, None, dt_rad, stage, opts, eos, prob,
                                           source.RAD_START))
            checks[key], errors[key] = ok, max_abs
        print(f"  {key}: {times[key]:.3f} ms"
              + (f", max_abs {errors[key]:.3e} ok {checks[key]}" if args.check else ""),
              flush=True)
    del U, sim
    torch.cuda.empty_cache()
    if shell is not None:
        shell_k5(torch, shell, kernel_check, source, RadhydroShellProblem(), args.check,
                 times, checks, errors)


def hydro_opts(n):
    from quokka_tpu_torch.eos import IdealGasEOS
    from quokka_tpu_torch.hydro.advance import HydroOptions

    return HydroOptions(eos=IdealGasEOS(gamma=1.4), active_axes=(0, 1, 2),
                        dx=(1.0 / n,) * 3, reconstruct_eint=False)


def hydro_blocks(torch, nbatch, shape, seed):
    """Seeded conserved hydro blocks [nbatch, 6, X, Y, Z] f32 on the card:
    rho in [0.5, 1.5], |v| ~ 0.3 (2 in a tenth of the cells), eint in [1, 2]
    (x30 in a tenth), so that PPM's limiters and every HLLC branch run."""
    import torch as _t

    g = _t.Generator(device="cuda").manual_seed(seed)
    full = (nbatch, *shape)
    out = _t.empty((nbatch, 6, *shape), dtype=_t.float32, device="cuda")
    rho = 0.5 + _t.rand(full, generator=g, device="cuda")
    v = 0.3 * _t.randn((3, *full), generator=g, device="cuda")
    v[:, _t.rand(full, generator=g, device="cuda") < 0.1] *= 7.0
    eint = 1.0 + _t.rand(full, generator=g, device="cuda")
    eint[_t.rand(full, generator=g, device="cuda") < 0.1] *= 30.0
    out[:, 0] = rho
    for k in range(3):
        out[:, 1 + k] = rho * v[k]
    ke = 0.5 * rho * (v[0] ** 2 + v[1] ** 2 + v[2] ** 2)
    out[:, 4] = rho * eint + ke
    out[:, 5] = rho * eint
    return out


def face_shapes(torch):
    """(label, blocks [B, 6, X, Y, Z], bc_kinds or None, first order,
    plain slabs)"""
    from quokka_tpu_torch.registry import BC_REFLECT

    walls = {d: (BC_REFLECT, BC_REFLECT) for d in range(3)}
    return (
        ("K2 faces 256^3 walls", lambda: hydro_blocks(torch, 1, (256,) * 3, 21), walls,
         False),
        ("K2 faces 520^3 padded", lambda: hydro_blocks(torch, 1, (520,) * 3, 22), None,
         False),
        ("K2 faces 512 x 36^3", lambda: hydro_blocks(torch, 512, (36,) * 3, 23), None,
         False),
        ("K2 faces 512 x 28^3", lambda: hydro_blocks(torch, 512, (28,) * 3, 24), None,
         False),
        ("K2 faces 512 x 36^3 first order", lambda: hydro_blocks(torch, 512, (36,) * 3, 23),
         None, True),
    )


def face_plain(torch, kernel_check, sweep, U5, d, opts, chi, dmins, bc, fo):
    """The plain faces of axis d, block by block (the 520^3 block in slabs
    along another axis, where the sweep's stencil does not reach)."""
    out = []
    for b in range(U5.shape[0]):
        dm = {t: m[b] for t, m in dmins.items()}
        c = None if chi is None else chi[b]
        bc_axis = None if bc is None else bc[d]

        def fn(U, cc, dmn):
            return sweep.axis_flux_plain(U, d, opts, cc, dmn, fo, bc_axis=bc_axis,
                                         state_is_cons=True)

        nslab = 8 if U5.shape[-1] > 300 else 1
        res = kernel_check._slabbed(fn, (U5[b], c, dm), (d + 1) % 3, nslab)
        out.append(res)
    return tuple(torch.stack([r[i] for r in out]) for i in range(len(out[0])))


def time_faces(torch, args, times, checks, errors, variants=None):
    from quokka_tpu_torch import _cuda, kernel_check
    from quokka_tpu_torch.hydro import sweep

    lib = _cuda.library()
    for label, make, bc, fo in face_shapes(torch):
        if variants is not None and (fo or "28" in label):
            continue
        U5 = make()
        opts = hydro_opts(U5.shape[-1])
        if fo:
            dmins, chi = {}, None
        else:
            dmins, chi = sweep._transverse_cuda(U5, opts, bc, True)[:2]
        for d in range(3):
            vax, wax = sweep._transverse_axes(d, 3)
            bc_axis = None if bc is None else bc[d]

            def launch(d=d, vax=vax, wax=wax, bc_axis=bc_axis):
                return sweep._axis_faces_cuda(lib, U5, d, opts, chi, dmins.get(vax),
                                              dmins.get(wax), bc_axis, True, fo)

            if variants is not None:
                chosen = sweep._face_tile
                try:
                    for tile in (None,) + tuple(variants):
                        nf = U5.shape[2 + d] + (bc_axis is not None)
                        t = tile or chosen(nf, U5.shape[3 if d == 2 else 4])
                        key = f"{label} axis {d} tile {t[0]} x {t[1]}" + (
                            " (chosen)" if tile is None else "")
                        sweep._face_tile = lambda nf, na, nv=6, t=t: t
                        times[key] = kernel_check.time_ms(launch)
                        print(f"  {key}: {times[key]:.3f} ms", flush=True)
                finally:
                    sweep._face_tile = chosen
                continue
            key = f"{label} axis {d}"
            times[key] = kernel_check.time_ms(launch)
            if args.check:
                got = launch()
                got = got if bc_axis is not None else got[:2]
                ref = face_plain(torch, kernel_check, sweep, U5, d, opts, chi, dmins, bc, fo)
                ok, max_abs, _ = kernel_check.compare(
                    tuple(g for g in got if g is not None), ref)
                checks[key], errors[key] = ok, max_abs
                del got, ref
            print(f"  {key}: {times[key]:.3f} ms"
                  + (f", max_abs {errors[key]:.3e} ok {checks[key]}" if args.check else ""),
                  flush=True)
        del U5, dmins, chi
        torch.cuda.empty_cache()


# (batch, extents, walls) of the face outputs --dump saves: the face
# kernel's edge shapes (extents 4 and 5, ragged tiles, a batch of 3, walls)
# and a slice of each main shape
DUMP_SHAPES = ((1, (4, 4, 4), True), (1, (5, 5, 5), False), (3, (5, 5, 5), False),
               (3, (37, 18, 33), False), (1, (37, 18, 33), True), (1, (4, 35, 17), True),
               (1, (64, 64, 64), True), (64, 36, False), (64, 28, False))


def dump_faces(torch, path, only=("k2",)):
    """Save the face kernel's outputs (PPM and first order, every axis) on
    seeded blocks at DUMP_SHAPES (with "k2" in `only`), and K1's and K4's
    (`dump_k1_k4`, with "k1" or "k4"), for --compare against another
    tree's."""
    from quokka_tpu_torch import _cuda
    from quokka_tpu_torch.hydro import sweep
    from quokka_tpu_torch.registry import BC_REFLECT

    lib = _cuda.library()
    out = {}
    if "k1" in only or "k4" in only:
        dump_k1_k4(torch, out)
    if only & {"k2c", "k2e", "k8"}:
        dump_lean_mhd(torch, out, only)
    if only & {"k2s", "k2d", "k6"}:
        dump_sweeps_k6(torch, out, only)
    if "k3" in only:
        dump_k3(torch, out)
    for i, (nb, shape, walls) in enumerate(DUMP_SHAPES if "k2" in only else ()):
        shape = (shape,) * 3 if isinstance(shape, int) else shape
        U5 = hydro_blocks(torch, nb, shape, 60 + i)
        bc = {d: (BC_REFLECT, BC_REFLECT) for d in range(3)} if walls else None
        for extra in ({}, {"K_visc": 0.1, "reconstruct_eint": True}):
            opts = dataclasses.replace(hydro_opts(8), **extra)
            dmins, chi = sweep._transverse_cuda(U5, opts, bc, True)[:2]
            for fo in (False, True):
                for d in range(3):
                    vax, wax = sweep._transverse_axes(d, 3)
                    res = sweep._axis_faces_cuda(lib, U5, d, opts, None if fo else chi,
                                                 None if fo else dmins.get(vax),
                                                 None if fo else dmins.get(wax),
                                                 None if bc is None else bc[d], True, fo)
                    key = (f"B {nb} {shape}{' walls' if walls else ''} {extra or ''} "
                           f"{'first order' if fo else 'PPM'} axis {d}")
                    out[key] = [r.cpu() for r in res if r is not None]
    torch.save(out, path)
    print(f"saved {len(out)} outputs to {path}", flush=True)


def compare_dumps(torch, a, b):
    """Bitwise equality (and the largest difference) of two --dump files."""
    da, db = torch.load(a), torch.load(b)
    same = 0
    for key in da:
        pairs = list(zip(da[key], db[key]))
        eq = len(da[key]) == len(db.get(key, ())) and all(
            x == y if isinstance(x, str) else torch.equal(x, y) for x, y in pairs)
        same += eq
        if not eq:
            diff = max((float((x - y).abs().max()) for x, y in pairs
                        if not isinstance(x, str) and x.shape == y.shape),
                       default=float("nan"))
            where = [(tuple(x.shape), int((x != y).sum()),
                      [tuple(i.tolist()) for i in (x != y).nonzero()[:4]])
                     for x, y in pairs if not isinstance(x, str) and x.shape == y.shape
                     and not torch.equal(x, y)]
            print(f"  differs: {key}: max |diff| {diff:.3e} (nan: digests or shapes); "
                  f"(shape, elements that differ, the first) {where}")
    print(f"outputs bitwise equal: {same} of {len(da)}", flush=True)
    return same == len(da)


def k1_shapes(torch):
    """(label, blocks [B, 6, X, Y, Z], bc_kinds or None) of K1's main-path
    shapes: Sedov 256^3 with reflecting walls, the packed chunk of 512
    level-1 blocks of 36^3, and the lean path's 512^3 with walls."""
    from quokka_tpu_torch.registry import BC_REFLECT

    walls = {d: (BC_REFLECT, BC_REFLECT) for d in range(3)}
    return (("K1 256^3 walls", lambda: hydro_blocks(torch, 1, (256,) * 3, 41), walls),
            ("K1 512 x 36^3", lambda: hydro_blocks(torch, 512, (36,) * 3, 42), None),
            ("K1 512^3 walls", lambda: hydro_blocks(torch, 1, (512,) * 3, 43), walls))


def time_k1(torch, args, times, checks, errors):
    """K1 over every axis at its main-path shapes as the tree's wrapper
    launches it (a tree with one launch an axis: also its two
    `torch.minimum` folds alone) and, with --check, bitwise against the
    plain version."""
    from quokka_tpu_torch import kernel_check
    from quokka_tpu_torch.hydro import sweep

    for label, make, bc in k1_shapes(torch):
        U5 = make()
        opts = hydro_opts(U5.shape[-1])
        times[label] = kernel_check.time_ms(lambda: sweep._transverse_cuda(U5, opts, bc, True))
        if args.check:
            got = sweep._transverse_cuda(U5, opts, bc, True)[:2]
            if U5.shape[0] == 1:
                ref = kernel_check.plain_transverse(U5[0], opts, bc or {},
                                                    nslab=4 if U5.shape[-1] > 300 else 1)
                ref = ({t: m[None] for t, m in ref[0].items()}, ref[1][None])
            else:
                ref = sweep.precompute_transverse_batched_plain(U5, opts, None, True)
            checks[label] = kernel_check.same_bits(got, ref)
            errors[label] = max(float((g - r).abs().max()) for g, r in zip(
                kernel_check._flat(got), kernel_check._flat(ref)))
            del got, ref
        print(f"  {label}: {times[label]:.3f} ms"
              + (f", bitwise {checks[label]} (max_abs {errors[label]:.3e})"
                 if args.check else ""), flush=True)
        if not hasattr(sweep, "k1_tile"):  # one launch an axis: the two folds alone
            a, b = (torch.rand(U5[:, 0].shape, device="cuda") for _ in range(2))
            times[f"{label} folds"] = kernel_check.time_ms(
                lambda: torch.minimum(torch.minimum(a, b), a))
            print(f"  {label} folds: {times[label + ' folds']:.3f} ms", flush=True)
            del a, b
        del U5
        torch.cuda.empty_cache()


# the march's planes a block tried by --tiles (`hydro.sweep.K1_MARCH_PLANES`)
K1_MARCH_VARIANTS = (16, 32, 64, 128)


def time_k1_tiles(torch, times):
    """K1 at each of K1_MARCH_VARIANTS planes a block, at its three
    shapes."""
    from quokka_tpu_torch import kernel_check
    from quokka_tpu_torch.hydro import sweep

    chosen = sweep.K1_MARCH_PLANES
    try:
        for label, make, bc in k1_shapes(torch):
            U5 = make()
            opts = hydro_opts(U5.shape[-1])
            for planes in K1_MARCH_VARIANTS:
                sweep.K1_MARCH_PLANES = planes
                key = f"{label} march {sweep.k1_tile(*U5.shape[2:])}"
                times[key] = kernel_check.time_ms(
                    lambda: sweep._transverse_cuda(U5, opts, bc, True))
                print(f"  {key}: {times[key]:.3f} ms", flush=True)
            del U5
            torch.cuda.empty_cache()
    finally:
        sweep.K1_MARCH_PLANES = chosen


def time_k4(torch, args, times, checks, errors):
    """Both K4 stage kernels on RadhydroBench 256^3 after 2 steps (stage 2
    on stage 1's kernel output), with --check against the plain versions
    (within 2e-5 of each component's max)."""
    from quokka_tpu_torch import kernel_check
    from quokka_tpu_torch.problems.radhydro_bench import RadhydroBenchProblem
    from quokka_tpu_torch.radiation import substep

    U, dt_rad, sim = radbench_state(torch)
    args4 = (dt_rad, sim._radiation.opts, sim.eos, RadhydroBenchProblem(), sim.grid.dx)
    U1, div0 = substep.fused_stage1(U, None, *args4)
    rs = 6
    runs = {"K4 RadhydroBench 256^3 stage 1": (
                lambda: substep.fused_stage1(U, None, *args4),
                lambda: substep.stage1_plain(U, None, *args4)),
            "K4 RadhydroBench 256^3 stage 2": (
                lambda: substep.fused_stage2(U1, U[rs:], div0, None, *args4),
                lambda: substep.stage2_plain(U1, U[rs:], div0, None, *args4))}
    for key, (kernel, plain) in runs.items():
        times[key] = kernel_check.time_ms(kernel)
        if args.check:
            checks[key], errors[key], _ = kernel_check.compare_scaled(kernel(), plain())
        print(f"  {key}: {times[key]:.3f} ms"
              + (f", max_abs {errors[key]:.3e} ok {checks[key]}" if args.check else ""),
              flush=True)
    del U, U1, div0, sim
    torch.cuda.empty_cache()


# K4's dump shapes: its edge shapes (extents 4 and 5, ragged tiles) and a
# slice of the main shape
K4_DUMP_SHAPES = ((4, 4, 4), (5, 5, 5), (37, 18, 33), (4, 35, 17), (64, 64, 64))


def rough_rad(torch, shape, seed):
    """Seeded [10, X, Y, Z] f32 radhydro state on the card (c = 1e3): moving
    gas, |f| up to 0.9999 and E at 2e-10 in a tenth of the cells each, so the
    donor-cell fallback and the work term run (`kernel_check.rough_rad_state`
    of this tree; kept here, as a parent tree's kernel_check lacks it)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*s):
        return torch.rand(s, generator=g, device="cuda", dtype=torch.float64)

    rho = 0.5 + rand(*shape)
    v = 0.3 * torch.randn((3, *shape), generator=g, device="cuda", dtype=torch.float64)
    T = 0.5 + rand(*shape)
    Eint = rho * 1.5 * T
    E = T**4 * (0.5 + rand(*shape))
    nvec = torch.randn((3, *shape), generator=g, device="cuda", dtype=torch.float64)
    nvec /= nvec.norm(dim=0)
    fmag = 0.5 * rand(*shape)
    fmag[rand(*shape) < 0.1] = 0.9999
    E[rand(*shape) < 0.1] = 2e-10
    F = nvec * fmag * 1.0e3 * E
    ke = 0.5 * rho * (v * v).sum(dim=0)
    return torch.stack([rho, rho * v[0], rho * v[1], rho * v[2], Eint + ke, Eint,
                        E, F[0], F[1], F[2]]).float().contiguous()


def dump_k1_k4(torch, out):
    """Add to `out` K1's outputs (every variant of its edge cases, both
    wall kinds) and both K4 stages' outputs (PPM, PLM, donor cell; opacities
    with and without a T exponent) on seeded inputs at K4_DUMP_SHAPES."""
    from quokka_tpu_torch.eos import IdealGasEOS
    from quokka_tpu_torch.hydro import sweep
    from quokka_tpu_torch.problems.radhydro_bench import RadhydroBenchProblem
    from quokka_tpu_torch.radiation import substep
    from quokka_tpu_torch.radiation.system import RadOptions
    from quokka_tpu_torch.registry import BC_REFLECT, PowerLawOpacity

    class TDependent(RadhydroBenchProblem):
        planck_opacity = PowerLawOpacity(10.0, -1.0, -1.5)
        energy_mean_opacity = PowerLawOpacity(8.0, -1.0, -1.0)
        flux_mean_opacity = PowerLawOpacity(12.0, -1.0, 0.5)

    for i, (nb, shape, walls) in enumerate(DUMP_SHAPES[:7]):
        U5 = hydro_blocks(torch, nb, shape, 80 + i)
        bc = {d: (BC_REFLECT, BC_REFLECT) for d in range(3)} if walls else None
        for extra in ({}, {"reconstruct_eint": True}, {"reconstruction_order": 2}):
            opts = dataclasses.replace(hydro_opts(8), **extra)
            dmins, chi = sweep._transverse_cuda(U5, opts, bc, True)[:2]
            out[f"K1 B {nb} {shape}{' walls' if walls else ''} {extra or ''}"] = [
                dmins[t].cpu() for t in sorted(dmins)] + ([] if chi is None else [chi.cpu()])
    eos = IdealGasEOS(gamma=5.0 / 3.0, mean_molecular_weight=1.0, boltzmann_constant=1.0)
    for i, shape in enumerate(K4_DUMP_SHAPES):
        U = rough_rad(torch, shape, 90 + i)
        dx = tuple(1.0 / n for n in shape)
        for order in (1, 2, 3):
            opts = RadOptions(c=1.0e3, chat=1.0e2, arad=1.0, erad_floor=1e-10, beta_order=1,
                              include_work_term=True, reconstruction_order=order)
            for name, prob in (("bench", RadhydroBenchProblem()), ("T-dependent",
                                                                   TDependent())):
                a = (0.3 * dx[0] / 1.0e2, opts, eos, prob, dx)
                U1, div0 = substep.fused_stage1(U, None, *a)
                U2 = substep.fused_stage2(U1, U[6:], div0, None, *a)
                out[f"K4 {shape} order {order} {name}"] = [U1.cpu(), div0.cpu(), U2.cpu()]


def time_k7(torch, args, times, checks):
    from quokka_tpu_torch import kernel_check
    from quokka_tpu_torch.radiation import sweep as rsweep
    from quokka_tpu_torch.radiation.system import RadOptions

    ropts = RadOptions(c=10.0, chat=5.0, arad=1.0)
    for label, nbatch, n, nslab in (("K7 520^3", 1, 520, 8), ("K7 512 x 32^3", 512, 32, 1)):
        R5 = rad_blocks(torch, nbatch, n, 5)
        for d in range(3):
            key = f"{label} axis {d}"
            times[key] = kernel_check.time_ms(
                lambda: rsweep.compute_rad_axis_flux_batched(R5, d, ropts))
            if args.check:
                got = rsweep.compute_rad_axis_flux_batched(R5, d, ropts)
                if nbatch == 1:
                    ref = kernel_check._slabbed(
                        lambda Rs: rsweep.rad_axis_flux_plain(Rs, d, ropts), (R5[0],),
                        (d + 1) % 3, nslab)[None]
                else:
                    ref = torch.stack([rsweep.rad_axis_flux_plain(r, d, ropts) for r in R5])
                checks[key] = bool(torch.equal(got, ref))
                del got, ref
            print(f"  {key}: {times[key]:.3f} ms" + (f", bitwise {checks[key]}"
                                                     if args.check else ""), flush=True)
        del R5
        torch.cuda.empty_cache()


def time_k9(torch, args, times, checks):
    from quokka_tpu_torch import kernel_check
    from quokka_tpu_torch.amr import packed

    cap, lattice = 28672, (32, 32, 28)
    g = torch.Generator(device="cuda").manual_seed(7)
    pools = {"hydro": torch.randn((cap, 6, 16, 16, 16), generator=g, device="cuda"),
             "radiation": torch.randn((cap, 4, 16, 16, 16), generator=g, device="cuda")}
    for count in (64, 512):
        rows = torch.tensor(lattice_rows(lattice, 8192, count), device="cuda")
        rows64 = rows.long()
        for part, pool in pools.items():
            key = f"K9 {count} x 26 {part}"
            times[key] = kernel_check.time_ms(lambda: packed.row_gather(pool, rows))
            times[key + " index_select"] = kernel_check.time_ms(
                lambda: torch.index_select(pool, 0, rows64))
            if args.check:
                got = packed.row_gather(pool, rows)
                packed.check_gathers(pool.device)
                checks[key] = bool(torch.equal(got, torch.index_select(pool, 0, rows64)))
                del got
            print(f"  {key}: {times[key]:.3f} ms, index_select "
                  f"{times[key + ' index_select']:.3f} ms"
                  + (f", bitwise {checks[key]}" if args.check else ""), flush=True)
        times[f"K9 {count} x 26 distinct rows"] = int(torch.unique(rows).numel())


# ------------------------------------------------- K2c, K2e and K8 (lean, MHD)
# (cells along at most, faces a tile at most) tried by --tiles --only k2c
LEAN_TILE_VARIANTS = ((40, 512), (31, 512), (15, 512), (32, 256), (64, 256))
# (cells along at most, lines across at most) of the x and y sweeps' tile
# tried by --tiles --only k2s (each within four blocks a multiprocessor)
SWEEP_TILE_VARIANTS = ((30, 16), (24, 16), (20, 16), (13, 32), (40, 12), (37, 13))
# (lines across at most, faces a tile at most) tried by --tiles --only k8
K8_TILE_VARIANTS = ((16, 512), (8, 512), (32, 512), (16, 256), (16, 1024))


def time_tile_variants(torch, only, times):
    """K2c's clean stage at 512^3 with walls and K8's three PLM axes on
    Orszag-Tang 256^3 with each tile bound of LEAN_TILE_VARIANTS and
    K8_TILE_VARIANTS (`hydro.sweep.LEAN_ALONG` / `LEAN_FACES`,
    `mhd.sweep.K8_LINES` / `K8_FACES`), the tree's own first."""
    from quokka_tpu_torch import kernel_check
    from quokka_tpu_torch.hydro import sweep
    from quokka_tpu_torch.mhd import sweep as msweep
    from quokka_tpu_torch.registry import BC_REFLECT

    if "k2c" in only:
        wall = (BC_REFLECT, BC_REFLECT)
        bc = {0: wall, 1: wall, 2: wall}
        U, opts, dmins, chi = lean_setup(torch, (512,) * 3, 51, bc)

        def stage():
            a = lean_call(sweep, U, 0, opts, chi, dmins, bc)
            for d in (1, 2):
                a = lean_call(sweep, U, d, opts, chi, dmins, bc, acc=a)
            return a

        chosen = (sweep.LEAN_ALONG, sweep.LEAN_FACES)
        try:
            acc = (torch.zeros_like(U), torch.zeros_like(U[0]))
            for along, faces in (chosen,) + LEAN_TILE_VARIANTS:
                sweep.LEAN_ALONG, sweep.LEAN_FACES = along, faces
                tile = sweep.lean_tile(512, 512)
                key = f"K2c 512^3 walls clean stage tile {tile}"
                times[key] = kernel_check.time_ms(stage)
                for d in range(3):
                    times[f"K2c 512^3 walls acc axis {d} tile {tile}"] = kernel_check.time_ms(
                        lambda d=d: lean_call(sweep, U, d, opts, chi, dmins, bc, acc=acc))
                print(f"  {key}: {times[key]:.3f} ms; acc axes 0-2 " + " / ".join(
                    f"{times[f'K2c 512^3 walls acc axis {d} tile {tile}']:.3f}"
                    for d in range(3)), flush=True)
        finally:
            sweep.LEAN_ALONG, sweep.LEAN_FACES = chosen
        del U, dmins, chi
        torch.cuda.empty_cache()
    if "k8" in only:
        prim, Bf, opts = mhd_state(torch)
        chosen = (msweep.K8_LINES, msweep.K8_FACES)
        try:
            for lines, faces in (chosen,) + K8_TILE_VARIANTS:
                msweep.K8_LINES, msweep.K8_FACES = lines, faces
                key = f"K8 Orszag-Tang 256^3 PLM 3 axes tile {msweep.k8_tile(256, 256)}"
                times[key] = kernel_check.time_ms(lambda: [
                    msweep.compute_mhd_axis(prim, Bf[d], d, opts) for d in range(3)])
                print(f"  {key}: {times[key]:.3f} ms", flush=True)
        finally:
            msweep.K8_LINES, msweep.K8_FACES = chosen
    if "k2s" in only:
        # K2's sweeps with a divergence, per axis: stage 1 and 2 at 256^3 with
        # walls, K2d at the padded 520^3; the x and y sweeps' tile bound
        # (`sweep.SWEEP_ALONG`, `SWEEP_LINES`) of each of SWEEP_TILE_VARIANTS
        wall = (BC_REFLECT, BC_REFLECT)
        chosen = (sweep.SWEEP_ALONG, sweep.SWEEP_LINES)
        for tag, shape, bc in (("256^3 walls", (256,) * 3, {0: wall, 1: wall, 2: wall}),
                               ("520^3 padded", (520,) * 3, {0: None, 1: None, 2: None})):
            U, opts, dmins, chi = lean_setup(torch, shape, 61, bc)
            U1, _, dm1, chi1 = lean_setup(torch, shape, 62, bc)
            kw = [dict(bc_axis=bc[d], dx_axis=opts.dx[d], state_is_cons=True)
                  for d in range(3)]
            names = ("K2 stage 1", "K2d" if bc[0] is None else "K2 stage 2")
            try:
                for along, lines in (chosen,) + SWEEP_TILE_VARIANTS:
                    sweep.SWEEP_ALONG, sweep.SWEEP_LINES = along, lines
                    tiles = [sweep.sweep_tile(shape[d], shape[1 if d == 2 else 2], d)
                             for d in range(3)]
                    for d in range(3):
                        faces = sweep.compute_axis_flux(U, d, opts, chi, dmins, **kw[d])[:-2]
                        runs = ((names[0], lambda d=d: sweep.compute_axis_flux(
                                    U, d, opts, chi, dmins, **kw[d])),
                                (names[1], lambda d=d, f=faces: sweep.compute_axis_flux(
                                    U1, d, opts, chi1, dm1, avg_with=f,
                                    emit_avg_flux=bc[d] is None, **kw[d])))
                        for name, fn in runs:
                            times[f"{name} {tag} axis {d} tile {tiles[d]}"] = \
                                kernel_check.time_ms(fn)
                        del faces, runs
                    print(f"  {tag} tiles {tiles}: " + "; ".join(
                        f"{name} " + " / ".join(
                            f"{times[f'{name} {tag} axis {d} tile {tiles[d]}']:.3f}"
                            for d in range(3)) for name in names), flush=True)
            finally:
                sweep.SWEEP_ALONG, sweep.SWEEP_LINES = chosen
            del U, U1, dmins, dm1, chi, chi1
            torch.cuda.empty_cache()


def flag_mask(torch, shape, seed, frac=0.01):
    """A seeded 0/1 f32 FOFC mask on the card flagging `frac` of the cells,
    every axis's first and last cell on a line of each, and the cells of
    every 8th plane along each axis (the first and last cells of tiles).
    Kept here, as a parent tree's kernel_check lacks `tile_edge_mask`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    m = torch.rand(shape, generator=g, device="cuda") < frac
    X, Y, Z = shape
    m[0, Y // 3, :] = True
    m[X - 1, :, Z // 2] = True
    m[:, 0, Z // 4] = True
    m[X // 2, Y - 1, :] = True
    m[:, Y // 5, 0] = True
    m[X // 3, :, Z - 1] = True
    for d in range(3):
        sl = [slice(None)] * 3
        sl[d] = slice(7, None, 8)
        sub = [slice(None)] * 3
        sub[(d + 1) % 3] = slice(0, None, 5)
        view = m[tuple(sl)]
        view[tuple(sub)] = True
    return m.float()


def box_masks(torch, shape):
    """The per-axis coarse-fine boundary-face masks (f32, slot c = the lo
    face of cell c) of a box [n/4, 3n/4) along every axis: K2e's input
    (`kernel_check.box_face_masks`, which a parent tree lacks)."""
    lo = [n // 4 for n in shape]
    hi = [3 * n // 4 for n in shape]
    out = {}
    for d in range(3):
        m = torch.zeros(shape, device="cuda")
        for c in (lo[d], hi[d]):
            sl = [slice(lo[a], hi[a]) for a in range(3)]
            sl[d] = c
            m[tuple(sl)] = 1.0
        out[d] = m
    return out


def lean_setup(torch, shape, seed, bc):
    """(U [6, ...] seeded, opts, dmins, chi) with K1's fields from the
    tree's own K1 (conserved input)."""
    from quokka_tpu_torch.hydro import sweep

    U = hydro_blocks(torch, 1, shape, seed)[0]
    opts = dataclasses.replace(hydro_opts(shape[0]), dx=tuple(1.0 / n for n in shape))
    dmins, chi, _ = sweep.precompute_transverse(U, opts, bc, True)
    return U, opts, dmins, chi


def lean_call(sweep, U, d, opts, chi, dmins, bc, **kw):
    """One K2c / K2e launch along axis d through the public wrapper."""
    return sweep.compute_axis_flux(U, d, opts, chi, dmins, bc_axis=bc.get(d),
                                   dx_axis=opts.dx[d], state_is_cons=True, div_only=True, **kw)


def time_lean(torch, args, times, checks, errors):
    """K2c per launch (clean, acc, fo_mask) and per clean stage (axis 0
    clean, axes 1 and 2 onto its totals) at 512^3 with walls and with x
    periodic; K2e per launch and per seeded stage at 256^3 (periodic, the
    box masks of `box_masks`; stage 2 blended with the stage-1 state's
    first-order fluxes, fo_from). With --check each 256^3 launch is held to
    its plain version."""
    from quokka_tpu_torch import kernel_check
    from quokka_tpu_torch.hydro import sweep
    from quokka_tpu_torch.registry import BC_REFLECT

    wall = (BC_REFLECT, BC_REFLECT)
    kinds = (("walls", {0: wall, 1: wall, 2: wall}), ("periodic x", {0: None, 1: wall, 2: wall}))
    for tag, bc in kinds if "k2c" in args.only_set else ():
        U, opts, dmins, chi = lean_setup(torch, (512,) * 3, 51, bc)
        mask = flag_mask(torch, U.shape[1:], 52)
        acc = (torch.zeros_like(U), torch.zeros_like(U[0]))
        for d in range(3):
            for v, kw in (("clean", {}), ("acc", {"acc": acc}), ("fo_mask", {"fo_mask": mask})):
                key = f"K2c 512^3 {tag} {v} axis {d}"
                times[key] = kernel_check.time_ms(
                    lambda d=d, kw=kw: lean_call(sweep, U, d, opts, chi, dmins, bc, **kw))
                print(f"  {key}: {times[key]:.3f} ms", flush=True)

        def stage():
            a = lean_call(sweep, U, 0, opts, chi, dmins, bc)
            for d in (1, 2):
                a = lean_call(sweep, U, d, opts, chi, dmins, bc, acc=a)
            return a

        key = f"K2c 512^3 {tag} clean stage"
        times[key] = kernel_check.time_ms(stage)
        torch.cuda.synchronize()
        times[key + " peak GiB"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"  {key}: {times[key]:.3f} ms", flush=True)
        del U, dmins, chi, mask, acc
        torch.cuda.empty_cache()
    if "k2e" not in args.only_set:
        return
    per = {0: None, 1: None, 2: None}
    U0, opts, dmins0, chi0 = lean_setup(torch, (256,) * 3, 53, per)
    U1, _, dmins1, chi1 = lean_setup(torch, (256,) * 3, 54, per)
    cm = box_masks(torch, U0.shape[1:])
    mask = flag_mask(torch, U0.shape[1:], 55)
    runs = {}
    for s, (U, dm, c, kw) in {1: (U0, dmins0, chi0, {}),
                              2: (U1, dmins1, chi1, {"fo_mask": mask, "fo_from": U0})}.items():
        def stage(U=U, dm=dm, c=c, kw=kw):
            a0, a1, corr = lean_call(sweep, U, 0, opts, c, dm, per, corr_mask=cm[0], **kw)
            for d in (1, 2):
                a0, a1, corr = lean_call(sweep, U, d, opts, c, dm, per, acc=(a0, a1),
                                         corr_mask=cm[d], corr_acc=corr, **kw)
            return a0, a1, corr

        runs[f"K2e 256^3 seeded stage {s}"] = stage
    for key, fn in runs.items():
        times[key] = kernel_check.time_ms(fn)
        if args.check:
            s2 = key.endswith("2")
            U, dm, c = (U1, dmins1, chi1) if s2 else (U0, dmins0, chi0)
            kw = {"fo_mask": mask, "fo_from": U0} if s2 else {}
            ref = None
            for d in range(3):
                ref = sweep.axis_flux_plain(
                    U, d, opts, c, dm, dx_axis=opts.dx[d], state_is_cons=True, div_only=True,
                    corr_mask=cm[d], acc=None if ref is None else ref[:2],
                    corr_acc=None if ref is None else ref[2], **kw)
            checks[key], errors[key], _ = kernel_check.compare(fn(), ref)
            del ref
        print(f"  {key}: {times[key]:.3f} ms"
              + (f", max_abs {errors[key]:.3e} ok {checks[key]}" if args.check else ""),
              flush=True)
    del U0, U1, dmins0, dmins1, chi0, chi1, cm, mask
    torch.cuda.empty_cache()


def time_sweeps(torch, args, times, checks, errors):
    """K2's sweeps with a divergence (`compute_axis_flux` with dx_axis) on
    seeded states, K1's fields from the tree's own K1: with `k2s`, at 256^3
    with reflecting walls (Sedov's shape), stage 1 (faces and divergences)
    and stage 2 (a second state averaged with the first's stage-1 faces
    from the tree's own sweep); with `k2d`, at the dense shell's padded
    520^3 (periodic), stage 1 and K2d the same way. Each per axis and for
    three axes. With --check each against its plain version (520^3 in 8
    slabs along another axis)."""
    from quokka_tpu_torch import kernel_check
    from quokka_tpu_torch.hydro import sweep
    from quokka_tpu_torch.registry import BC_REFLECT

    wall = (BC_REFLECT, BC_REFLECT)
    runs = []
    if "k2s" in args.only_set:
        runs.append(("256^3 walls", (256,) * 3, {0: wall, 1: wall, 2: wall}, False))
    if "k2d" in args.only_set:
        runs.append(("520^3 padded", (520,) * 3, {0: None, 1: None, 2: None}, True))
    for tag, shape, bc, k2d in runs:
        U0, opts, dm0, chi0 = lean_setup(torch, shape, 61, bc)
        U1, _, dm1, chi1 = lean_setup(torch, shape, 62, bc)
        nslab = 8 if shape[0] > 300 else 1
        names = ("K2 stage 1", "K2d" if k2d else "K2 stage 2")
        for d in range(3):
            s1 = dict(bc_axis=bc[d], dx_axis=opts.dx[d], state_is_cons=True)
            faces = sweep.compute_axis_flux(U0, d, opts, chi0, dm0, **s1)[:-2]
            s2 = dict(s1, avg_with=faces, emit_avg_flux=k2d)
            for name, U, dm, c, kw in ((names[0], U0, dm0, chi0, s1),
                                       (names[1], U1, dm1, chi1, s2)):
                def launch(U=U, d=d, c=c, dm=dm, kw=kw):
                    return sweep.compute_axis_flux(U, d, opts, c, dm, **kw)

                key = f"{name} {tag} axis {d}"
                times[key] = kernel_check.time_ms(launch)
                if args.check:
                    def plain(Us, cs, dms, avg, d=d, kw=kw):
                        return sweep.axis_flux_plain(Us, d, opts, cs, dms,
                                                     **dict(kw, avg_with=avg))

                    ref = kernel_check._slabbed(plain, (U, c, dm, kw.get("avg_with")),
                                                (d + 1) % 3, nslab)
                    checks[key], errors[key], _ = kernel_check.compare(launch(), ref)
                    del ref
                print(f"  {key}: {times[key]:.3f} ms"
                      + (f", max_abs {errors[key]:.3e} ok {checks[key]}" if args.check
                         else ""), flush=True)
            del faces
        for name in names:
            key = f"{name} {tag} 3 axes"
            times[key] = sum(times[f"{name} {tag} axis {d}"] for d in range(3))
            print(f"  {key}: {times[key]:.3f} ms", flush=True)
        del U0, U1, dm0, dm1, chi0, chi1
        torch.cuda.empty_cache()


def time_k6(torch, args, times, checks, errors):
    """K6 on RadhydroBench 256^3 after 2 steps: per axis into a fresh
    output (`compute_rad_div`), and the three axes as
    `radiation.system.rad_transport_div` computes them (a tree with K6's
    accumulator: x into a fresh output, y and z added on in place; a parent:
    three outputs and two PyTorch adds). With --check against the plain
    versions (the sum ((x + y) + z) of the per-axis plain divergences)."""
    from quokka_tpu_torch import kernel_check
    from quokka_tpu_torch.radiation import sweep as rsweep
    from quokka_tpu_torch.radiation import system

    U, _, sim = radbench_state(torch)
    opts, dx = sim._radiation.opts, sim.grid.dx
    R0 = U[6:]
    plain = [rsweep.rad_div_plain(R0, d, opts, dx[d]) for d in range(3)]
    for d in range(3):
        key = f"K6 RadhydroBench 256^3 axis {d}"
        times[key] = kernel_check.time_ms(
            lambda d=d: rsweep.compute_rad_div(R0, d, opts, dx[d]))
        if args.check:
            checks[key], errors[key], _ = kernel_check.compare(
                rsweep.compute_rad_div(R0, d, opts, dx[d]), plain[d])
        print(f"  {key}: {times[key]:.3f} ms"
              + (f", max_abs {errors[key]:.3e} ok {checks[key]}" if args.check else ""),
              flush=True)
    key = "K6 RadhydroBench 256^3 3 axes"
    times[key] = sum(times[f"K6 RadhydroBench 256^3 axis {d}"] for d in range(3))
    print(f"  {key}: {times[key]:.3f} ms", flush=True)
    key = "K6 RadhydroBench 256^3 rad_transport_div"
    times[key] = kernel_check.time_ms(
        lambda: system.rad_transport_div(U, 6, opts, (0, 1, 2), dx))
    if args.check:
        checks[key], errors[key], _ = kernel_check.compare(
            system.rad_transport_div(U, 6, opts, (0, 1, 2), dx),
            (plain[0] + plain[1]) + plain[2])
    print(f"  {key}: {times[key]:.3f} ms"
          + (f", max_abs {errors[key]:.3e} ok {checks[key]}" if args.check else ""),
          flush=True)
    del U, R0, sim, plain
    torch.cuda.empty_cache()


def time_k6g(torch, args, times, checks, errors):
    """K6 over 4 photon groups (`--only k6g`), at RadMultigroupPulse's 256^3
    on rough seeded blocks of 4 groups (`kernel_check.rough_rad_groups`):
    per axis (`compute_rad_div`, one launch over the groups) and the three
    axes as `radiation.system.rad_transport_div` launches them; with --check
    against the plain versions. A tree whose K6 takes one group says so and
    times nothing."""
    from quokka_tpu_torch import kernel_check
    from quokka_tpu_torch.radiation import sweep as rsweep
    from quokka_tpu_torch.radiation import system
    from quokka_tpu_torch.radiation.system import RadOptions

    if not hasattr(kernel_check, "rough_rad_groups"):
        print("  this tree's K6 takes one photon group: k6g not timed", flush=True)
        return
    n = 256
    opts = RadOptions(c=1.0e3, chat=1.0e2, arad=1.0, erad_floor=1e-12, n_groups=4)
    R = kernel_check.rough_rad_groups((n, n, n), 4, 31, "cuda")
    dx = (1.0 / n,) * 3
    plain = [rsweep.rad_div_plain(R, d, opts, dx[d]) for d in range(3)]
    for d in range(3):
        key = f"K6 4 groups 256^3 axis {d}"
        times[key] = kernel_check.time_ms(lambda d=d: rsweep.compute_rad_div(R, d, opts, dx[d]))
        if args.check:
            checks[key], errors[key], _ = kernel_check.compare(
                rsweep.compute_rad_div(R, d, opts, dx[d]), plain[d])
        print(f"  {key}: {times[key]:.3f} ms"
              + (f", max_abs {errors[key]:.3e} ok {checks[key]}" if args.check else ""),
              flush=True)
    key = "K6 4 groups 256^3 rad_transport_div"
    times[key] = kernel_check.time_ms(lambda: system.rad_transport_div(R, 0, opts, (0, 1, 2),
                                                                       dx))
    if args.check:
        checks[key], errors[key], _ = kernel_check.compare(
            system.rad_transport_div(R, 0, opts, (0, 1, 2), dx),
            (plain[0] + plain[1]) + plain[2])
    print(f"  {key}: {times[key]:.3f} ms"
          + (f", max_abs {errors[key]:.3e} ok {checks[key]}" if args.check else ""),
          flush=True)
    del R, plain
    torch.cuda.empty_cache()


def dump_sweeps_k6(torch, out, only):
    """Add to `out`, with `k2s` or `k2d` in `only`, K2's sweeps with a
    divergence on seeded states at LEAN_DUMP_SHAPES (with and without
    viscosity and reconstruct_eint): stage 1, first order, stage 2 and, on
    periodic axes, K2d, stage 2's and K2d's stage-1 faces from the plain
    stage-1 sweep (the same input in every tree); with `k2s` stage 1 and 2
    at 256^3 with walls, with `k2d` stage 1 and K2d at 520^3 (stage-1 faces
    from the tree's own sweep; digests); with `k6` K6 per axis and the
    three axes of `rad_transport_div` on rough states at K4_DUMP_SHAPES
    (orders 1-3) and on RadhydroBench 256^3 after 2 steps."""
    from quokka_tpu_torch.hydro import sweep
    from quokka_tpu_torch.radiation import sweep as rsweep
    from quokka_tpu_torch.radiation import system
    from quokka_tpu_torch.radiation.system import RadOptions
    from quokka_tpu_torch.registry import BC_REFLECT

    wall = (BC_REFLECT, BC_REFLECT)
    kinds = {"walls": {0: wall, 1: wall, 2: wall}, "periodic": {0: None, 1: None, 2: None},
             "periodic x": {0: None, 1: wall, 2: wall}}
    if only & {"k2s", "k2d"}:
        for i, (shape, kind) in enumerate(LEAN_DUMP_SHAPES):
            bc = kinds[kind]
            U0, opts, dm0, chi0 = lean_setup(torch, shape, 200 + i, bc)
            U1, _, dm1, chi1 = lean_setup(torch, shape, 220 + i, bc)
            for extra in ({}, {"K_visc": 0.1, "reconstruct_eint": True}):
                o = dataclasses.replace(opts, **extra)
                for d in range(3):
                    s1 = dict(bc_axis=bc[d], dx_axis=o.dx[d], state_is_cons=True)
                    faces = sweep.axis_flux_plain(U0, d, o, chi0, dm0, **s1)[:-2]
                    variants = {"stage 1": (U0, dm0, chi0, s1),
                                "first order": (U0, {}, None, dict(s1, first_order=True)),
                                "stage 2": (U1, dm1, chi1, dict(s1, avg_with=faces))}
                    if bc[d] is None:
                        variants["K2d"] = (U1, dm1, chi1, dict(s1, avg_with=faces,
                                                               emit_avg_flux=True))
                    for v, (U, dm, c, kw) in variants.items():
                        res = sweep.compute_axis_flux(U, d, o, c, dm, **kw)
                        out[f"sweep {shape} {kind} {extra or ''} {v} axis {d}"] = [
                            _digest(r) for r in res]
            del U0, U1, dm0, dm1, chi0, chi1
        big = []
        if "k2s" in only:
            big.append(("256^3 walls", (256,) * 3, kinds["walls"], False))
        if "k2d" in only:
            big.append(("520^3 padded", (520,) * 3, kinds["periodic"], True))
        for tag, shape, bc, k2d in big:
            U0, opts, dm0, chi0 = lean_setup(torch, shape, 61, bc)
            U1, _, dm1, chi1 = lean_setup(torch, shape, 62, bc)
            for d in range(3):
                s1 = dict(bc_axis=bc[d], dx_axis=opts.dx[d], state_is_cons=True)
                res = sweep.compute_axis_flux(U0, d, opts, chi0, dm0, **s1)
                out[f"K2 stage 1 {tag} axis {d}"] = [_digest(r) for r in res]
                faces = res[:-2]
                del res
                res = sweep.compute_axis_flux(U1, d, opts, chi1, dm1, avg_with=faces,
                                              emit_avg_flux=k2d, **s1)
                out[f"{'K2d' if k2d else 'K2 stage 2'} {tag} axis {d}"] = [
                    _digest(r) for r in res]
                del res, faces
            del U0, U1, dm0, dm1, chi0, chi1
            torch.cuda.empty_cache()
    if "k6" in only:
        for i, shape in enumerate(K4_DUMP_SHAPES):
            U = rough_rad(torch, shape, 240 + i)
            dx = tuple(1.0 / n for n in shape)
            for order in (1, 2, 3):
                opts = RadOptions(c=1.0e3, chat=1.0e2, arad=1.0, erad_floor=1e-10,
                                  reconstruction_order=order)
                out[f"K6 {shape} order {order}"] = [
                    rsweep.compute_rad_div(U[6:], d, opts, dx[d]).cpu() for d in range(3)] + [
                    system.rad_transport_div(U, 6, opts, (0, 1, 2), dx).cpu()]
        U, _, sim = radbench_state(torch)
        opts, dx = sim._radiation.opts, sim.grid.dx
        out["K6 RadhydroBench 256^3"] = [
            _digest(rsweep.compute_rad_div(U[6:], d, opts, dx[d])) for d in range(3)] + [
            _digest(system.rad_transport_div(U, 6, opts, (0, 1, 2), dx))]
        del U, sim
        torch.cuda.empty_cache()


def k3_stage(torch, shape, seed, ng=(0, 0, 0), nv=6):
    """A seeded K3 input: (U [nv, interior], Ug0 and the three divergences
    [nv, shape], the three dvels [shape]), `shape` padded by `ng` along x;
    the divergences drive a few cells below a density floor of 0.9 (at dt
    0.05)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    inner = tuple(n - 2 * w for n, w in zip(shape, ng))
    U = hydro_blocks(torch, 1, inner, seed)[0]
    Ug0 = hydro_blocks(torch, 1, shape, seed + 1)[0]
    if nv > 6:
        from quokka_tpu_torch import kernel_check

        o = dataclasses.replace(hydro_opts(8), n_scalars=nv - 6)
        U = kernel_check.with_scalar_rows(U, o, seed)
        Ug0 = kernel_check.with_scalar_rows(Ug0, o, seed + 1)
    divs = {d: torch.randn((nv, *shape), generator=g, device="cuda") for d in range(3)}
    dvels = {d: torch.randn(shape, generator=g, device="cuda") for d in range(3)}
    return U, Ug0, divs, dvels


# K3's option variants in the dumps: the floors (density and temperature)
# and the dual-energy sync off
K3_DUMP_VARIANTS = (("", {}), ("floors", {"density_floor": 0.9, "temperature_floor": 0.5}),
                    ("no dual energy", {"use_dual_energy": False}))


def dump_k3(torch, out):
    """Add K3's outputs (state and invalid count) to `out`: seeded stages at
    K4_DUMP_SHAPES and at 37 x 18 x 33 padded by 4 along x, in each of
    K3_DUMP_VARIANTS."""
    from quokka_tpu_torch.hydro import sweep

    inputs = [(shape, (0, 0, 0)) for shape in K4_DUMP_SHAPES] + [((45, 18, 33), (4, 0, 0))]
    for i, (shape, ng) in enumerate(inputs):
        U, Ug0, divs, dvels = k3_stage(torch, shape, 300 + i, ng)
        for label, changes in K3_DUMP_VARIANTS:
            opts = dataclasses.replace(hydro_opts(shape[1]), **changes)
            res = sweep.apply_update(U, Ug0, divs, dvels, 0.05, opts, ng)
            out[f"K3 {shape} ng {ng} {label}"] = [r.cpu() for r in res]


def time_k3(torch, args, times, checks, errors):
    """K3 at 256^3 and on the hybrid layout's x-padded stage input (264 x
    256^2, ng 4), as the tree's wrapper launches it; with --check against
    its plain version."""
    from quokka_tpu_torch import kernel_check
    from quokka_tpu_torch.hydro import sweep

    for tag, shape, ng in (("256^3", (256,) * 3, (0, 0, 0)),
                           ("264 x 256^2 padded", (264, 256, 256), (4, 0, 0))):
        U, Ug0, divs, dvels = k3_stage(torch, shape, 71, ng)
        opts = hydro_opts(256)
        key = f"K3 {tag}"

        def launch():
            return sweep.apply_update(U, Ug0, divs, dvels, 0.05, opts, ng)

        times[key] = kernel_check.time_ms(launch)
        if args.check:
            ref = sweep.apply_update_plain(U, Ug0, divs, dvels, 0.05, opts, ng)
            checks[key], errors[key], _ = kernel_check.compare(launch(), ref)
        print(f"  {key}: {times[key]:.3f} ms"
              + (f", max_abs {errors[key]:.3e} ok {checks[key]}" if args.check else ""),
              flush=True)
        del U, Ug0, divs, dvels
        torch.cuda.empty_cache()


def _timed(torch, args, times, checks, errors, key, launch, plain):
    """Time `launch` into times[key] and, with --check, hold it to `plain`."""
    from quokka_tpu_torch import kernel_check

    times[key] = kernel_check.time_ms(launch)
    if args.check:
        checks[key], errors[key], _ = kernel_check.compare(launch(), plain())
    print(f"  {key}: {times[key]:.3f} ms"
          + (f", max_abs {errors[key]:.3e} ok {checks[key]}" if args.check else ""), flush=True)


def time_forms(torch, args, times, checks, errors):
    """K2's PLM form (`plm`) and its form with one passive scalar
    (`scalars`), with K1 and K3 beside them, at the new main paths' shapes
    (see the module's docstring)."""
    from quokka_tpu_torch import kernel_check
    from quokka_tpu_torch.hydro import sweep
    from quokka_tpu_torch.registry import BC_REFLECT

    if not hasattr(sweep, "MAX_KERNEL_SCALARS"):
        print("  this tree's K2 has no PLM or scalar form", flush=True)
        return
    wall = (BC_REFLECT, BC_REFLECT)
    periodic, zwalls = {0: None, 1: None, 2: None}, {0: None, 1: None, 2: wall}
    runs = []
    if "plm" in args.only_set:
        runs.append(("PLM 256^3", (256,) * 3, periodic, {"reconstruction_order": 2}))
    if "scalars" in args.only_set:
        runs.append(("1 scalar 256^3 z walls", (256,) * 3, zwalls, {"n_scalars": 1}))
    for tag, shape, bc, changes in runs:
        opts = dataclasses.replace(hydro_opts(shape[0]), **changes)
        U0 = kernel_check.with_scalar_rows(hydro_blocks(torch, 1, shape, 81)[0], opts, 81)
        U1 = kernel_check.with_scalar_rows(hydro_blocks(torch, 1, shape, 82)[0], opts, 82)
        _timed(torch, args, times, checks, errors, f"K1 {tag}",
               lambda: sweep.precompute_transverse(U0, opts, bc, True),
               lambda: sweep.precompute_transverse_plain(U0, opts, bc, True))
        dm0, chi0, _ = sweep.precompute_transverse_plain(U0, opts, bc, True)
        dm1, chi1, _ = sweep.precompute_transverse_plain(U1, opts, bc, True)
        for d in range(3):
            s1 = dict(bc_axis=bc[d], dx_axis=opts.dx[d], state_is_cons=True)
            faces = sweep.axis_flux_plain(U0, d, opts, chi0, dm0, **s1)[:-2]
            s2 = dict(s1, avg_with=faces)
            for name, U, dm, c, kw in (("K2 stage 1", U0, dm0, chi0, s1),
                                       ("K2 stage 2", U1, dm1, chi1, s2)):
                _timed(torch, args, times, checks, errors, f"{name} {tag} axis {d}",
                       lambda U=U, d=d, c=c, dm=dm, kw=kw:
                           sweep.compute_axis_flux(U, d, opts, c, dm, **kw),
                       lambda U=U, d=d, c=c, dm=dm, kw=kw:
                           sweep.axis_flux_plain(U, d, opts, c, dm, **kw))
            if "reconstruction_order" in changes:
                _timed(torch, args, times, checks, errors, f"K2 faces {tag} axis {d}",
                       lambda d=d: sweep.compute_axis_flux(U0, d, opts, chi0, dm0,
                                                           bc_axis=bc[d], state_is_cons=True),
                       lambda d=d: sweep.axis_flux_plain(U0, d, opts, chi0, dm0,
                                                         bc_axis=bc[d], state_is_cons=True))
            del faces
        for name in ("K2 stage 1", "K2 stage 2"):
            key = f"{name} {tag} 3 axes"
            times[key] = sum(times[f"{name} {tag} axis {d}"] for d in range(3))
            print(f"  {key}: {times[key]:.3f} ms", flush=True)
        if "n_scalars" in changes:
            Ua, Ug0, divs, dvels = k3_stage(torch, shape, 83, nv=7)
            _timed(torch, args, times, checks, errors, f"K3 {tag}",
                   lambda: sweep.apply_update(Ua, Ug0, divs, dvels, 0.05, opts),
                   lambda: sweep.apply_update_plain(Ua, Ug0, divs, dvels, 0.05, opts))
            del Ua, Ug0, divs, dvels
        del U0, U1, dm0, dm1, chi0, chi1
        torch.cuda.empty_cache()
    if "scalars" in args.only_set:
        shape, tag = (256, 256, 384), "1 scalar 256x256x384 z walls"
        opts = dataclasses.replace(hydro_opts(256), n_scalars=1,
                                   dx=tuple(1.0 / 512 for _ in shape))
        U = kernel_check.with_scalar_rows(hydro_blocks(torch, 1, shape, 84)[0], opts, 84)
        dm, chi, _ = sweep.precompute_transverse_plain(U, opts, zwalls, True)

        def stage(plain=False):
            call = sweep.axis_flux_plain if plain else sweep.compute_axis_flux
            a = None
            for d in range(3):
                a = call(U, d, opts, chi, dm, bc_axis=zwalls[d], dx_axis=opts.dx[d],
                         state_is_cons=True, div_only=True, acc=a)
            return a

        _timed(torch, args, times, checks, errors, f"K2c {tag} clean stage", stage,
               lambda: stage(True))
        del U, dm, chi
        torch.cuda.empty_cache()


def mhd_state(torch, nsteps=3):
    """Orszag-Tang 256^3 f32 after `nsteps` windowed steps: (prim [8, ...],
    Bf, opts)."""
    from quokka_tpu_torch import MHDSimulation, ParmParse
    from quokka_tpu_torch.mhd.advance import b_cell_from_faces, cons_to_prim_mhd
    from quokka_tpu_torch.problems import mhd

    sim = MHDSimulation(mhd.OrszagTangProblem(), ParmParse.from_string(
        mhd.DECK_256, [f"max_timesteps={nsteps}", "verbose=0"]), precision="single",
        device="cuda")
    sim.set_initial_conditions()
    sim.evolve()
    prim = cons_to_prim_mhd(sim.U, b_cell_from_faces(sim.Bf), sim.opts).contiguous()
    return prim, [b.contiguous() for b in sim.Bf], sim.opts


def time_k8(torch, args, times, checks, errors):
    """K8 per axis on Orszag-Tang 256^3 after 3 steps, PLM (its deck) and
    PPM; with --check against the plain version."""
    from quokka_tpu_torch import kernel_check
    from quokka_tpu_torch.mhd import sweep as msweep

    prim, Bf, opts = mhd_state(torch)
    for order in (2, 3):
        o = dataclasses.replace(opts, reconstruction_order=order)
        for d in range(3):
            key = f"K8 Orszag-Tang 256^3 order {order} axis {d}"
            times[key] = kernel_check.time_ms(lambda d=d: msweep.compute_mhd_axis(
                prim, Bf[d], d, o))
            if args.check:
                checks[key], errors[key], _ = kernel_check.compare(
                    msweep.compute_mhd_axis(prim, Bf[d], d, o),
                    msweep.mhd_axis_plain(prim, Bf[d], d, o))
            print(f"  {key}: {times[key]:.3f} ms"
                  + (f", max_abs {errors[key]:.3e} ok {checks[key]}" if args.check else ""),
                  flush=True)
        key = f"K8 Orszag-Tang 256^3 order {order} 3 axes"
        times[key] = sum(times[f"K8 Orszag-Tang 256^3 order {order} axis {d}"]
                         for d in range(3))
        print(f"  {key}: {times[key]:.3f} ms", flush=True)
    del prim, Bf
    torch.cuda.empty_cache()


# (extents, walls) of the lean sweep's dump shapes: extents 4 and 5, extents
# that are not multiples of a tile along or across, walls, periodic axes and
# both together (x periodic); the MHD dump takes the same extents, periodic
LEAN_DUMP_SHAPES = (((4, 4, 4), "walls"), ((5, 5, 5), "periodic"),
                    ((37, 18, 33), "periodic x"), ((4, 35, 17), "walls"),
                    ((83, 6, 45), "periodic"), ((64, 64, 64), "walls"))


def _digest(t):
    """An output's bits as a SHA-256 digest (kept whole if small)."""
    import hashlib

    t = t.detach().contiguous().cpu()
    if t.numel() <= 1 << 18:
        return t
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def dump_lean_mhd(torch, out, only):
    """Add to `out` K2c's and K2e's outputs (every variant: clean, acc,
    fo_mask, fo_mask + acc + fo_from, first order, the register seed fresh
    and accumulated) on seeded states at LEAN_DUMP_SHAPES, K2c at 512^3
    (walls and x periodic; digests) and at 256^3 with fo_from, K2e's seeded
    stages at 256^3, and K8's (orders 1-3, floors off and on) at the same
    small extents and on Orszag-Tang 256^3 (PLM and PPM)."""
    from quokka_tpu_torch.hydro import sweep
    from quokka_tpu_torch.mhd import sweep as msweep
    from quokka_tpu_torch.registry import BC_REFLECT

    wall = (BC_REFLECT, BC_REFLECT)
    kinds = {"walls": {0: wall, 1: wall, 2: wall}, "periodic": {0: None, 1: None, 2: None},
             "periodic x": {0: None, 1: wall, 2: wall}}
    if "k2c" in only or "k2e" in only:
        for i, (shape, kind) in enumerate(LEAN_DUMP_SHAPES):
            bc = kinds[kind]
            U0, opts, dm0, chi0 = lean_setup(torch, shape, 100 + i, bc)
            U1, _, dm1, chi1 = lean_setup(torch, shape, 120 + i, bc)
            mask = flag_mask(torch, shape, 140 + i, frac=0.1)
            cm = box_masks(torch, shape)
            g = torch.Generator(device="cuda").manual_seed(180 + i)
            for extra in ({}, {"K_visc": 0.1, "reconstruct_eint": True}):
                o = dataclasses.replace(opts, **extra)
                for d in range(3):
                    acc = (torch.rand(U0.shape, generator=g, device="cuda"),
                           torch.rand(shape, generator=g, device="cuda"))
                    variants = {
                        "clean": (U0, dm0, chi0, {}),
                        "acc": (U0, dm0, chi0, {"acc": "acc"}),
                        "fo_mask": (U0, dm0, chi0, {"fo_mask": mask}),
                        "fo_mask+acc+fo_from": (U1, dm1, chi1, {"fo_mask": mask, "fo_from": U0,
                                                                "acc": "acc"}),
                        "first order": (U0, {}, None, {"first_order": True}),
                    }
                    if bc[d] is None:
                        variants["corr"] = (U0, dm0, chi0, {"corr_mask": cm[d]})
                        variants["corr acc fo_from"] = (
                            U1, dm1, chi1, {"corr_mask": cm[d], "acc": "acc", "corr_acc": "corr",
                                            "fo_mask": mask, "fo_from": U0})
                    for v, (U, dm, c, kw) in variants.items():
                        kw = dict(kw)
                        if kw.get("acc") == "acc":
                            kw["acc"] = tuple(a.clone() for a in acc)
                        if kw.get("corr_acc") == "corr":
                            kw["corr_acc"] = acc[0].clone()
                        res = lean_call(sweep, U, d, o, c, dm, bc, **kw)
                        out[f"lean {shape} {kind} {extra or ''} {v} axis {d}"] = [
                            _digest(r) for r in res]
            del U0, U1, dm0, dm1, chi0, chi1, mask, cm
    if "k2c" in only:
        for tag, bc in (("walls", kinds["walls"]), ("periodic x", kinds["periodic x"])):
            U, opts, dmins, chi = lean_setup(torch, (512,) * 3, 51, bc)
            mask = flag_mask(torch, U.shape[1:], 52)
            for d in range(3):
                for v, kw in (("clean", {}), ("fo_mask", {"fo_mask": mask})):
                    res = lean_call(sweep, U, d, opts, chi, dmins, bc, **kw)
                    out[f"K2c 512^3 {tag} {v} axis {d}"] = [_digest(r) for r in res]
                    del res
            a = lean_call(sweep, U, 0, opts, chi, dmins, bc)
            for d in (1, 2):
                a = lean_call(sweep, U, d, opts, chi, dmins, bc, acc=a)
            out[f"K2c 512^3 {tag} clean stage"] = [_digest(r) for r in a]
            del U, dmins, chi, mask, a
            torch.cuda.empty_cache()
        bc = kinds["walls"]
        U0, opts, dm0, chi0 = lean_setup(torch, (256,) * 3, 56, bc)
        U1, _, dm1, chi1 = lean_setup(torch, (256,) * 3, 57, bc)
        mask = flag_mask(torch, U0.shape[1:], 58)
        a = lean_call(sweep, U0, 0, opts, chi0, dm0, bc)
        for d in range(3):
            acc = tuple(x.clone() for x in a)
            res = lean_call(sweep, U1, d, opts, chi1, dm1, bc, acc=acc, fo_mask=mask, fo_from=U0)
            out[f"K2c 256^3 walls fo_mask+acc+fo_from axis {d}"] = [_digest(r) for r in res]
        del U0, U1, dm0, dm1, chi0, chi1, mask, a, acc, res
        torch.cuda.empty_cache()
    if "k2e" in only:
        per = kinds["periodic"]
        U0, opts, dm0, chi0 = lean_setup(torch, (256,) * 3, 53, per)
        U1, _, dm1, chi1 = lean_setup(torch, (256,) * 3, 54, per)
        cm = box_masks(torch, U0.shape[1:])
        mask = flag_mask(torch, U0.shape[1:], 55)
        for s, (U, dm, c, kw) in {1: (U0, dm0, chi0, {}),
                                  2: (U1, dm1, chi1, {"fo_mask": mask, "fo_from": U0})}.items():
            r = lean_call(sweep, U, 0, opts, c, dm, per, corr_mask=cm[0], **kw)
            for d in (1, 2):
                r = lean_call(sweep, U, d, opts, c, dm, per, acc=r[:2], corr_mask=cm[d],
                              corr_acc=r[2], **kw)
            out[f"K2e 256^3 seeded stage {s}"] = [_digest(x) for x in r]
        del U0, U1, dm0, dm1, chi0, chi1, cm, mask, r
        torch.cuda.empty_cache()
    if "k8" in only:
        for i, (shape, _) in enumerate(LEAN_DUMP_SHAPES):
            prim, bxf = rough_mhd(torch, shape, 160 + i)
            for order in (1, 2, 3):
                for floors in ((0.0, 0.0), (0.6, 0.1)):
                    o = small_mhd_opts(order, shape, floors)
                    for d in range(3):
                        out[f"K8 {shape} order {order} floors {floors} axis {d}"] = [
                            _digest(msweep.compute_mhd_axis(prim, bxf[d], d, o))]
        prim, Bf, opts = mhd_state(torch)
        for order in (2, 3):
            o = dataclasses.replace(opts, reconstruction_order=order)
            for d in range(3):
                out[f"K8 Orszag-Tang 256^3 order {order} axis {d}"] = [
                    _digest(msweep.compute_mhd_axis(prim, Bf[d], d, o))]
        del prim, Bf
        torch.cuda.empty_cache()


def small_mhd_opts(order, shape, floors):
    from quokka_tpu_torch.mhd.advance import MHDOptions

    return MHDOptions(gamma=5.0 / 3.0, dx=tuple(1.0 / n for n in shape),
                      reconstruction_order=order, density_floor=floors[0],
                      pressure_floor=floors[1])


def rough_mhd(torch, shape, seed):
    """Seeded (prim [8, ...], [Bf_x, Bf_y, Bf_z]) f32 on the card: strong
    random fields, slabs at +-30 along each axis, faces with bx = 0 and
    |bx| = 1e-7, and a block at rest with the field along x only
    (degenerate star denominators), so every HLLD region and branch runs
    (made on the card, where `kernel_check.rough_mhd_state` is numpy)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*s):
        return torch.rand(s, generator=g, device="cuda")

    rho = 0.5 + rand(*shape)
    v = torch.randn((3, *shape), generator=g, device="cuda")
    P = 0.05 + rand(*shape)
    B = 2.0 * torch.randn((3, *shape), generator=g, device="cuda")
    for d in range(3):
        v[d][rand(*shape) < 0.1] = 30.0
        v[d][rand(*shape) < 0.1] = -30.0
    bxf = [B[d].clone() for d in range(3)]
    for d in range(3):
        bxf[d][rand(*shape) < 0.1] = 0.0
        sel = rand(*shape) < 0.1
        bxf[d][sel] = 1e-7 * torch.sign(bxf[d][sel])
    h = [n // 2 for n in shape]
    rest = (slice(h[0], None), slice(h[1], None), slice(h[2], None))
    rho[rest], P[rest] = 1.0, 0.01
    v[(slice(None),) + rest] = 0.0
    for k in range(3):
        B[k][rest] = 1.0 if k == 0 else 0.0
        bxf[k][rest] = 1.0 if k == 0 else 0.0
    prim = torch.cat([rho[None], v, P[None], B]).contiguous()
    return prim, [b.contiguous() for b in bxf]


# ------------------------------------------------------------------ histogram
def warp_stats(per_solve):
    """(mean residual evaluations a cell, mean over warps of the sum over
    Newton solves of the warp's maximum, histogram of a cell's total) from
    the per-solve counts [cells] of one coupling call."""
    import torch

    solves = torch.stack([p.reshape(-1) for p in per_solve]).long()  # [S, cells]
    total = solves.sum(0)
    pad = (-total.numel()) % 32
    warps = torch.nn.functional.pad(solves, (0, pad)).reshape(solves.shape[0], -1, 32)
    warp_cost = warps.max(dim=2).values.sum(0)
    hist = torch.bincount(total)
    return (float(total.double().mean()), float(warp_cost.double().mean()),
            {int(k): int(v) for k, v in enumerate(hist.tolist()) if v})


def histogram(torch, shell):
    from quokka_tpu_torch.problems.radhydro_bench import RadhydroBenchProblem
    from quokka_tpu_torch.problems.radhydro_shell import RadhydroShellProblem
    from quokka_tpu_torch.radiation import source

    out = {}
    U, dt_rad, sim = radbench_state(torch)
    inputs = [(f"RadhydroBench 256^3 stage {s}", s, [U], None, dt_rad, sim._radiation.opts,
               sim.eos, RadhydroBenchProblem(), None) for s in (1, 2)]
    if shell is not None:
        s1, s2 = shell["stage1"], shell["stage2"]
        for s, st in ((1, s1), (2, s2)):
            blocks = torch.cat([st["gas"], st["rad"]], dim=1)
            # the chunk folded into one state: the kernel's cell order
            nv, sp = blocks.shape[1], blocks.shape[2:]
            Uf = blocks.transpose(0, 1).reshape(nv, -1, *sp[1:])
            src = None if st["src"] is None else st["src"].reshape(-1, *sp[1:])
            keep = st.get("keep")
            inputs.append((f"packed shell level-2 chunk stage {s} {tuple(blocks.shape)}", s,
                           [Uf], src, st["dt"], shell["ropts"], shell["eos"],
                           RadhydroShellProblem(), keep))
    for title, stage, (Ux,), src, dt, opts, eos, prob, *keep in inputs:
        counts = {"cell_resid": []}
        source.source_update_plain(Ux, src, dt, stage, opts, eos, prob, source.RAD_START,
                                   counts)
        rows = [(title, counts["cell_resid"])]
        if keep and keep[0] is not None:
            # the ring cells without a neighbour tile are discarded after the
            # coupling: their work, and that of the real cells alone
            k = keep[0].reshape(-1)
            rows.append((title + ", real cells (others counted 0)",
                         [c.reshape(-1) * k for c in counts["cell_resid"]]))
            rows.append((title + ", discarded ring cells (others counted 0)",
                         [c.reshape(-1) * ~k for c in counts["cell_resid"]]))
            print(f"  {title}: {int(k.sum())} real cells of {k.numel()}")
        for label, per_solve in rows:
            cell, warp, hist = warp_stats(per_solve)
            out[label] = {"cell_mean": cell, "warp_mean": warp, "ratio": warp / cell,
                          "solves": len(per_solve), "hist": hist}
            print(f"  {label}: residual evaluations a cell {cell:.4f}, a warp {warp:.4f} "
                  f"(ratio {warp / cell:.4f}, {len(per_solve)} Newton solves); "
                  f"cells by evaluations {hist}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--only", default="k5,k2,k7,k9")
    ap.add_argument("--shell", default=None, help="a chunk saved by --capture")
    ap.add_argument("--capture", default=None)
    ap.add_argument("--histogram", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--dump", default=None, help="save the face kernel's outputs")
    ap.add_argument("--compare", nargs=2, default=None, help="two --dump files")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the kernels run only on the card", file=sys.stderr)
        return 2
    if not (tree / "quokka_tpu_torch").is_dir():
        print(f"error: {tree} holds no quokka_tpu_torch", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree))
    from quokka_tpu_torch import _cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _cuda.library()
    if args.capture:
        capture(args.capture)
        return 0
    if args.dump:
        dump_faces(torch, args.dump, set(args.only.split(",")))
        return 0
    if args.compare:
        return 0 if compare_dumps(torch, *args.compare) else 1
    shell = torch.load(args.shell, weights_only=False) if args.shell else None
    if args.histogram:
        print(json.dumps({"tree": str(tree), "device": smi, "histogram": histogram(torch,
                                                                                   shell)}))
        return 0
    names = ("rad_source", "face_tile_kernel", "face_kernel", "rad_stage", "rad_axis_flux",
             "row_gather", "transverse", "rad_transport", "lean_", "mhd_", "sweep_tile",
             "div_kernel", "rad_div")
    for line in _cuda.build_info["log"].splitlines():
        if any(k in line for k in names) or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    times, checks, errors = {}, {}, {}
    only = set(args.only.split(","))
    args.only_set = only
    if args.tiles:
        from quokka_tpu_torch.hydro import sweep

        if "k1" in only:
            time_k1_tiles(torch, times)
        elif only & {"k2c", "k8", "k2s"}:
            time_tile_variants(torch, only, times)
        elif not hasattr(sweep, "_face_tile"):
            print("error: this tree's face kernel takes no tile", file=sys.stderr)
            return 2
        else:
            time_faces(torch, args, times, checks, errors, TILE_VARIANTS)
        only = set()
    if "k1" in only:
        time_k1(torch, args, times, checks, errors)
    if "k4" in only:
        time_k4(torch, args, times, checks, errors)
    if "k5" in only:
        time_k5(torch, args, shell, times, checks, errors)
    if "k2" in only:
        time_faces(torch, args, times, checks, errors)
    if "k7" in only:
        time_k7(torch, args, times, checks)
    if "k9" in only:
        time_k9(torch, args, times, checks)
    if only & {"k2c", "k2e"}:
        time_lean(torch, args, times, checks, errors)
    if "k8" in only:
        time_k8(torch, args, times, checks, errors)
    if only & {"k2s", "k2d"}:
        time_sweeps(torch, args, times, checks, errors)
    if "k6" in only:
        time_k6(torch, args, times, checks, errors)
    if "k6g" in only:
        time_k6g(torch, args, times, checks, errors)
    if "k3" in only:
        time_k3(torch, args, times, checks, errors)
    if only & {"plm", "scalars"}:
        time_forms(torch, args, times, checks, errors)
    print(json.dumps({"tree": str(tree), "device": smi, "times": times, "checks": checks,
                      "errors": errors}))
    if args.check and not all(checks.values()):
        print("error: a kernel disagrees with its plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
