"""Hold each CUDA kernel against its plain PyTorch version on the same
device inputs, time both, and give the least time the card could take
(used by ``chip_smoke.py`` and the cuda-marked tests).

Tolerance: per output component, |kernel - plain| <= rtol * |plain| +
ulps x (one ulp of the component's largest magnitude), with rtol 1e-5 and
64 ulps -- the bound the JAX package's tests hold its two hydro
formulations to (tests/test_fused_update.py). The kernels are built with
-fmad=false and IEEE division and square root, so they round like the
plain versions' separate ops, and in practice they agree to a few ulps.
Anything through the Newton matter coupling (K4, K5) is held to max |kernel
- plain| <= 2e-5 x the component's largest magnitude instead: an iteration
count that differs by one at roundoff moves a cell by its last Newton
correction. Non-finite values must agree exactly.

Bound: the larger of the bytes the function must move (each input read
once, each output written once) at 3.35 TB/s and its FP32 operations at
67 TFLOP/s (the H100 SXM's published peaks). Operation counts per cell are
counted from the CUDA sources, each +, -, *, /, sqrt, min or max as one,
without the kernels' redundant work (a face solved by both neighbours counts
once); the Newton work is what this input needs, counted by the plain
version.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, NamedTuple

import numpy as np
import torch

from .hydro import euler, sweep
from .mhd import sweep as msweep
from .radiation import source, substep, system
from .radiation import sweep as rsweep
from .stencil import interior, sh

RTOL = 1e-5
ULPS = 64
NEWTON_REL = 2e-5  # kernels through the Newton coupling: x the component's max
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# FP32 operations per cell, counted from the CUDA sources
OPS_K1_AXIS = 50  # cons->prim, dmin, flattening chi and its 3-point min
OPS_K2_SWEEP = 620  # PPM of 6 components, HLLC at one face, divergence
OPS_K2_FACE = 606  # the face kernel alone: K2's sweep without the divergence
OPS_K3 = 80
OPS_FO_FACE = 110  # cons->prim of two cells, two face states, LLF (K2c's blend)
OPS_K6_AXIS = 280  # (E, f) prims, PPM of 4 components, HLL at one face, div
OPS_K7_AXIS = 272  # K6 without the divergence: (E, f) prims, PPM, HLL
OPS_AMEND = 12
OPS_COUPLING_CELL = 215  # set-up, Newton start, flux update, work term, finish
OPS_NEWTON_RESID = 11  # residuals and the convergence test
OPS_NEWTON_ITER = 47  # one Newton update after an unconverged test
OPS_OUTER_ITER = 185  # one work-term re-solve, besides its Newton iterations
# K8, per cell: faces of 7 primitives (per component: none, PLM-minmod, PPM),
# one HLLD face (the double-star path, the longest), floors, divergence
OPS_K8_RECON = {1: 0, 2: 14, 3: 57}
OPS_K8_HLLD = 315
OPS_K8_REST = 14
# K2's forms (csrc/sweep.cuh), per cell: a component's reconstruction, PPM
# with the chi blend or PLM's minmod slope; a scalar's share of the HLLC
# face solve (its conserved and physical flux, two star fluxes, the fan's
# select) and its divergence, and of the LLF one; a mass scalar's rescaling
# (its share of the sum, a product and a division); a scalar in K3 (its
# rhs, update, finiteness and floor rescale)
OPS_PPM_COMPONENT = 45
OPS_PLM_COMPONENT = 12
OPS_SCALAR_FACE = 16
OPS_SCALAR_LLF = 12
OPS_MASS_SCALAR = 3
OPS_K3_SCALAR = 7


def k2_ops(opts, first_order: bool = False) -> int:
    """FP32 operations a cell of one K2 sweep (OPS_K2_SWEEP's PPM form
    without scalars; OPS_FO_FACE a face in first order), in the form of
    `opts`: PLM reconstructs for fewer, each scalar adds its reconstruction
    and face share, each mass scalar its rescaling."""
    ns, nm = opts.n_scalars, opts.n_mscalars
    if first_order:
        return OPS_FO_FACE + ns * OPS_SCALAR_LLF + nm * OPS_MASS_SCALAR
    recon = OPS_PPM_COMPONENT if opts.reconstruction_order == 3 else OPS_PLM_COMPONENT
    return (OPS_K2_SWEEP - 6 * (OPS_PPM_COMPONENT - recon) + ns * (recon + OPS_SCALAR_FACE)
            + nm * OPS_MASS_SCALAR)


def k3_ops(opts) -> int:
    """FP32 operations a cell of K3 with the scalars of `opts`."""
    return OPS_K3 + opts.n_scalars * OPS_K3_SCALAR


def _flat(x) -> List[torch.Tensor]:
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    return [t for item in x for t in _flat(item)]


def compare(got, ref, rtol: float = RTOL, ulps: int = ULPS):
    """(ok, max_abs_err, max_rel_err) of `got` against `ref` (tensors, or
    tuples / dicts of tensors with the same structure)."""
    g_list, r_list = _flat(got), _flat(ref)
    if len(g_list) != len(r_list):
        return False, float("inf"), float("inf")
    ok, max_abs, max_rel = True, 0.0, 0.0
    for g, r in zip(g_list, r_list):
        if g.shape != r.shape:
            return False, float("inf"), float("inf")
        g, r = g.float(), r.float()
        fin = torch.isfinite(r)
        if not _same_nonfinite(g, r, fin):
            ok = False
            continue
        per_comp = r.dim() >= 4 or (r.dim() == 3 and r.shape[0] == 6)  # state or hi plane
        if r.dim() > 4:  # [G, 4, X, Y, Z] radiation blocks: per component too
            g, r, fin = (a.reshape(-1, *a.shape[-3:]) for a in (g, r, fin))
        if not per_comp:
            g, r, fin = g[None], r[None], fin[None]
        # components in chunks of about 2^27 values: many small components
        # (K9's gathered blocks) take a few reductions, a large one its own
        n = r.shape[0]
        step = max(1, 2**27 // max(1, r[0].numel()))
        for c0 in range(0, n, step):
            gc, rc, fc = (a[c0:c0 + step].reshape(min(step, n - c0), -1) for a in (g, r, fin))
            rabs = rc.abs().masked_fill(~fc, 0.0)
            scale = rabs.amax(dim=1, keepdim=True)  # over the finite values
            ulp = torch.nextafter(scale, torch.full_like(scale, float("inf"))) - scale
            err = (gc - rc).abs().masked_fill(~fc, 0.0)
            ok = ok and bool(((err <= rtol * rabs + ulps * ulp) | ~fc).all())
            max_abs = max(max_abs, float(err.max()))
            max_rel = max(max_rel, float((err / rabs.clamp_min(1e-30)).max()))
            del gc, rc, fc, rabs, err
    return ok, max_abs, max_rel


def _same_nonfinite(g: torch.Tensor, r: torch.Tensor, fin: torch.Tensor) -> bool:
    """`g` is non-finite where `r` is, with the same value there: NaN where
    `r` has NaN, the same infinity where `r` has one."""
    inf = torch.isinf(r)
    return (torch.equal(torch.isfinite(g), fin) and torch.equal(torch.isnan(g), torch.isnan(r))
            and torch.equal(g[inf], r[inf]))


def time_ms(fn: Callable[[], object], reps: int = 5, warmup: bool = True) -> float:
    """Mean milliseconds per call on the current CUDA stream, after one
    warm-up call unless the caller has just made one (`warmup=False`)
    (CUDA events around `reps` calls)."""
    if warmup:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_scaled(got, ref, rel: float = NEWTON_REL):
    """(ok, max_abs_err, max_rel_err) with max |got - ref| <= rel x the
    component's largest finite magnitude; non-finite values agree exactly."""
    g_list, r_list = _flat(got), _flat(ref)
    if len(g_list) != len(r_list):
        return False, float("inf"), float("inf")
    ok, max_abs, max_rel = True, 0.0, 0.0
    for g, r in zip(g_list, r_list):
        if g.shape != r.shape:
            return False, float("inf"), float("inf")
        g, r = g.float().reshape(-1, *r.shape[-3:]), r.float().reshape(-1, *r.shape[-3:])
        for gc, rc in zip(g, r):
            fin = torch.isfinite(rc)
            if not _same_nonfinite(gc, rc, fin):
                ok = False
                continue
            if not bool(fin.any()):
                continue
            err = float((gc[fin] - rc[fin]).abs().max())
            scale = float(rc[fin].abs().max())
            ok = ok and err <= rel * scale
            max_abs = max(max_abs, err)
            max_rel = max(max_rel, err / scale if scale > 0 else (0.0 if err == 0 else float("inf")))
    return ok, max_abs, max_rel


def bound_ms(nbytes: float, ops: float):
    """(least ms, "bytes" or "operations") of work moving `nbytes` and doing
    `ops` FP32 operations on the H100."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    """Bytes of the distinct tensors given: one passed twice (a kernel that
    reads the same buffer through two arguments) is counted once."""
    distinct = {(t.data_ptr(), t.numel()): t for t in _flat(list(tensors))}
    return sum(t.numel() * t.element_size() for t in distinct.values())


class Case(NamedTuple):
    kernel: str  # key of the launch counts of hydro, radiation or mhd sweep
    label: str
    run_kernel: Callable[[], object]
    run_plain: Callable[[], object]
    cost: Callable[[], tuple] = lambda: (0, 0)  # (bytes, FP32 operations)
    scaled: bool = False  # compare with compare_scaled (Newton coupling)
    # what to time, where run_kernel must copy an input it updates in place
    # or checks its result with a host read
    run_timed: Callable[[], object] | None = None
    # the one PyTorch call that computes the same function, where there is one
    run_library: Callable[[], object] | None = None

    def check(self):
        """Run both versions; (ok, max_abs_err, max_rel_err, kernel result,
        plain result)."""
        got = self.run_kernel()
        ref = self.run_plain()
        torch.cuda.synchronize()
        res = compare_scaled(got, ref) if self.scaled else compare(got, ref)
        return (*res, got, ref)


def cases(U: torch.Tensor, U2: torch.Tensor, opts, bc_kinds: dict,
          dt: float, ng=(0, 0, 0)) -> Iterator[Case]:
    """The kernels at the shapes of the main path: K1 on the conserved
    state; K2 stage 1 (walls + divergence; on an outflow wall with K1's
    chi planes), stage 2 (time average with stage 1's faces) and first
    order, per axis; K3 on stage 1's divergences. K2 and K3 take inputs from
    the plain versions, so each kernel is compared on identical inputs.
    With `ng` (the hybrid ghost-free mode) U and U2 are padded by `ng` and
    K3 updates their interior from the padded stage input and divergences,
    as the step does."""
    n = U[0].numel()
    dmins, chi, planes = sweep.precompute_transverse_plain(U, opts, bc_kinds, True)
    dmins2, chi2, planes2 = sweep.precompute_transverse_plain(U2, opts, bc_kinds, True)
    k1_cost = k1_cost_of(U, opts, planes)
    yield Case("transverse", "K1 all axes",
               lambda: sweep.precompute_transverse(U, opts, bc_kinds, True),
               lambda: sweep.precompute_transverse_plain(U, opts, bc_kinds, True),
               lambda: k1_cost)
    prim = euler.cons_to_prim(U, opts.eos, opts.reconstruct_eint)
    divs, dvels = {}, {}
    for d in opts.active_axes:
        s1 = dict(bc_axis=bc_kinds.get(d), dx_axis=opts.dx[d], state_is_cons=True,
                  chi_ghost_axis=planes.get(d))
        res = sweep.axis_flux_plain(U, d, opts, chi, dmins, **s1)
        # reads U, chi and two dmin fields; writes faces, face velocities
        # and both divergences
        cost = (_nbytes(U, chi, *dmins.values()) - _nbytes(dmins[d]) + _nbytes(res),
                k2_ops(opts) * n)
        yield Case("axis_flux", f"K2 stage 1 axis {d}",
                   lambda d=d, kw=s1: sweep.compute_axis_flux(U, d, opts, chi, dmins, **kw),
                   lambda d=d, kw=s1: sweep.axis_flux_plain(U, d, opts, chi, dmins, **kw),
                   lambda cost=cost: cost)
        divs[d], dvels[d] = res[-2], res[-1]
        s2 = dict(s1, avg_with=res[:-2], chi_ghost_axis=planes2.get(d))
        # reads U2, chi, two dmin fields and stage 1's faces (and their hi
        # planes); writes both divergences
        cost2 = (_nbytes(U2, chi2, *dmins2.values()) - _nbytes(dmins2[d]) + _nbytes(res[:-2])
                 + _nbytes(res[-2:]), k2_ops(opts) * n)
        yield Case("axis_flux", f"K2 stage 2 avg axis {d}",
                   lambda d=d, kw=s2: sweep.compute_axis_flux(U2, d, opts, chi2, dmins2, **kw),
                   lambda d=d, kw=s2: sweep.axis_flux_plain(U2, d, opts, chi2, dmins2, **kw),
                   lambda cost=cost2: cost)
        fo = dict(first_order=True, bc_axis=bc_kinds.get(d))
        yield Case("axis_flux", f"K2 first order axis {d}",
                   lambda d=d, kw=fo: sweep.compute_axis_flux(prim, d, opts, None, {}, **kw),
                   lambda d=d, kw=fo: sweep.axis_flux_plain(prim, d, opts, None, {}, **kw))
    # K3 reads U, the stage's input state, three divergences and three
    # dvels, and writes the state. Both RK stages of the main path pass the
    # step's initial state as U and as the stage input (hydro/advance.py),
    # as this call does, so U is read once. Padded (the hybrid mode), the
    # kernel reads the interior of the padded inputs only, and 5 components
    # of the stage input (the PdV pressure), beside the interior state Ui.
    if any(ng):
        Ui = interior(U, ng).contiguous()
        read = (_nbytes(Ui, interior(U, ng)[:5]) + _nbytes(*(interior(t, ng) for t in divs.values()))
                + _nbytes(*(interior(t, ng) for t in dvels.values())))
    else:
        Ui = U
        read = _nbytes(U, divs, dvels)
    k3_cost = (read + _nbytes(Ui), k3_ops(opts) * Ui[0].numel())
    yield Case("apply_update", "K3" + (f" padded {tuple(ng)}" if any(ng) else ""),
               lambda: sweep.apply_update(Ui, U, divs, dvels, dt, opts, ng),
               lambda: sweep.apply_update_plain(Ui, U, divs, dvels, dt, opts, ng),
               lambda: k3_cost)


def k1_cost_of(U: torch.Tensor, opts, planes: dict | None = None):
    """(bytes, FP32 operations) of K1 over a state [nv, X, Y, Z] or a batch
    [B, nv, X, Y, Z]: its 6 gas components read once (K1 reads no scalar),
    and what K1 returns written once:
    dmin an active axis and, with PPM flattening, chi_cell (40 B a cell with
    three axes) and the outflow chi planes `planes` (`hydro.sweep.
    outflow_chi_planes`); OPS_K1_AXIS a cell and axis."""
    cell = U.select(-4, 0)
    axes = len(opts.active_axes)
    chi = opts.use_flattening and opts.reconstruction_order == 3
    return (_bytes_of(U.narrow(-4, 0, 6)) + _bytes_of(cell) * (axes + chi) + _nbytes(planes),
            OPS_K1_AXIS * cell.numel() * axes)


def same_bits(got, ref) -> bool:
    """`got` and `ref` (tensors, or tuples / dicts of them) hold the same
    bits, a NaN matching any NaN."""
    g_list, r_list = _flat(got), _flat(ref)
    if len(g_list) != len(r_list):
        return False
    for g, r in zip(g_list, r_list):
        if g.shape != r.shape or g.dtype != r.dtype:
            return False
        nan = torch.isnan(r)
        if not torch.equal(torch.isnan(g), nan):
            return False
        if not torch.equal(g[~nan].view(torch.int32), r[~nan].view(torch.int32)):
            return False
    return True


def coupling_ops(n: int, counts: dict) -> int:
    """FP32 operations of the matter coupling of `n` cells, with the Newton
    and work-term iterations that the plain version counted."""
    return (OPS_COUPLING_CELL * n + OPS_NEWTON_RESID * counts["newton_resid"]
            + OPS_NEWTON_ITER * counts["newton_iters"]
            + OPS_OUTER_ITER * counts["outer_iters"])


def rad_cases(U: torch.Tensor, rad_src, dt: float, opts, eos, problem,
              dx) -> Iterator[Case]:
    """The radiation kernels at the shapes of the radhydro path, on the
    [10, X, Y, Z] state U: K6 per axis, K5 at stage 1 and 2, and the two
    K4 stage kernels (stage 2 on stage 1's plain output, so both versions
    see identical inputs). The operation counts of K4/K5 come from the plain
    versions' Newton counts on these inputs."""
    n = U[0].numel()
    rs = source.RAD_START
    R0 = U[rs:]
    yield from k6_cases(R0, opts, dx)
    for stage in (1, 2):
        counts = {}
        source.source_update_plain(U, rad_src, dt, stage, opts, eos, problem, rs, counts)
        cost = (2 * _nbytes(U) + _nbytes(rad_src), coupling_ops(n, counts))
        yield Case("rad_source", f"K5 stage {stage}",
                   lambda stage=stage: source.source_update(U, rad_src, dt, stage, opts,
                                                            eos, problem, rs),
                   lambda stage=stage: source.source_update_plain(U, rad_src, dt, stage,
                                                                  opts, eos, problem, rs),
                   lambda cost=cost: cost, scaled=True)
    counts1 = {}
    U1, div0 = substep.stage1_plain(U, rad_src, dt, opts, eos, problem, dx, counts1)
    cost1 = (_nbytes(U, rad_src, U1, div0),
             (3 * OPS_K6_AXIS + 8 + OPS_AMEND) * n + coupling_ops(n, counts1))
    yield Case("rad_stage1", "K4 stage 1",
               lambda: substep.fused_stage1(U, rad_src, dt, opts, eos, problem, dx),
               lambda: substep.stage1_plain(U, rad_src, dt, opts, eos, problem, dx),
               lambda: cost1, scaled=True)
    counts2 = {}
    U2 = substep.stage2_plain(U1, R0, div0, rad_src, dt, opts, eos, problem, dx, counts2)
    cost2 = (_nbytes(U1, R0, div0, rad_src, U2),
             (3 * OPS_K6_AXIS + 20 + OPS_AMEND) * n + coupling_ops(n, counts2))
    del U2
    yield Case("rad_stage2", "K4 stage 2",
               lambda: substep.fused_stage2(U1, R0, div0, rad_src, dt, opts, eos, problem, dx),
               lambda: substep.stage2_plain(U1, R0, div0, rad_src, dt, opts, eos, problem, dx),
               lambda: cost2, scaled=True)


def k6_cost(R0: torch.Tensor, opts, axes: int = 1):
    """(bytes, FP32 operations) of K6's function over `axes` axes on the
    radiation block R0 [4G, X, Y, Z] of opts.n_groups groups: per cell and
    group 16 B read and 16 B written (the three axes of `rad_transport_div`
    read R0 and write the sum once; its y and z launches also read the
    running sum, 16 B more a cell and group each, which the function does
    not need), and OPS_K6_AXIS operations an axis."""
    return 2 * _nbytes(R0), OPS_K6_AXIS * R0[0].numel() * opts.n_groups * axes


def k6_cases(R0: torch.Tensor, opts, dx, tag: str = "") -> Iterator[Case]:
    """K6 on the radiation block R0 [4G, X, Y, Z] (opts.n_groups groups):
    per axis into a fresh output (reads R0, writes the divergence), then the
    three axes as `radiation.system.rad_transport_div` launches them, x
    into a fresh output and y and z added onto it (the function reads R0 and
    writes the sum once; the y and z launches also read the running sum),
    against the plain version accumulated the same way, the JAX sum ((x +
    y) + z)."""
    key = "rad_div" if opts.n_groups == 1 else "rad_div groups"
    for d in range(3):
        cost = k6_cost(R0, opts)
        yield Case(key, f"K6 axis {d}{tag}",
                   lambda d=d: rsweep.compute_rad_div(R0, d, opts, dx[d]),
                   lambda d=d: rsweep.rad_div_plain(R0, d, opts, dx[d]),
                   lambda cost=cost: cost)
    cost = k6_cost(R0, opts, axes=3)
    yield Case(key, f"K6 3 axes accumulated{tag}",
               lambda: system.rad_transport_div(R0, 0, opts, (0, 1, 2), dx),
               lambda: rsweep.rad_div_plain(R0, 2, opts, dx[2], acc=rsweep.rad_div_plain(
                   R0, 1, opts, dx[1], acc=rsweep.rad_div_plain(R0, 0, opts, dx[0]))),
               lambda: cost)


def _slabbed(fn, arrays, axis: int, nslab: int, halo: int = 0):
    """fn(*arrays) evaluated on `nslab` slabs along spatial `axis` and put
    back together; it bounds the plain versions' temporaries at the fine
    level's 520^3. Each slab carries `halo` cells on either side, wrapped
    periodically in index space as the padded level's sweeps wrap, and its
    result is cropped to the slab. For a function whose stencil reaches at
    most `halo` cells along `axis` the result is the same bitwise. `arrays`
    are tensors whose spatial axes are the last three, dicts or tuples of
    such, or None; the results are tensors, or tuples or dicts of them."""
    if nslab <= 1:
        return fn(*arrays)
    n = next(t for t in _flat([a for a in arrays if a is not None])).shape[-3 + axis]

    def cut(a, lo, hi):
        if a is None:
            return None
        if isinstance(a, dict):
            return {k: cut(v, lo, hi) for k, v in a.items()}
        if isinstance(a, tuple):
            return tuple(cut(v, lo, hi) for v in a)
        if halo == 0:
            return a.narrow(a.dim() - 3 + axis, lo, hi - lo)
        idx = torch.arange(lo - halo, hi + halo, device=a.device) % n
        return a.index_select(a.dim() - 3 + axis, idx)

    def crop(r, m):
        if isinstance(r, dict):
            return {k: crop(v, m) for k, v in r.items()}
        if isinstance(r, (tuple, list)):
            return tuple(crop(v, m) for v in r)
        return r.narrow(r.dim() - 3 + axis, halo, m) if halo else r

    def join(parts):
        p0 = parts[0]
        if isinstance(p0, dict):
            return {k: join([p[k] for p in parts]) for k in p0}
        if isinstance(p0, tuple):
            return tuple(join([p[i] for p in parts]) for i in range(len(p0)))
        return torch.cat(parts, dim=p0.dim() - 3 + axis)

    bounds = [n * i // nslab for i in range(nslab + 1)]
    return join([crop(fn(*(cut(a, lo, hi) for a in arrays)), hi - lo)
                 for lo, hi in zip(bounds, bounds[1:])])


def amr_cases(Ug0: torch.Tensor, Ug1: torch.Tensor, R: torch.Tensor, opts, ropts,
              tag: str = "", nslab: int = 4, coupling: tuple | None = None
              ) -> Iterator[Case]:
    """The dense-AMR kernels at the padded level's shapes, the plain
    versions run in `nslab` slabs:

    - K1 on the padded hydro states `Ug0` (stage 1) and `Ug1` (stage 2);
    - per axis, K2's stage-1 sweep of `Ug0` with its divergences, and K2d,
      the stage-2 sweep of `Ug1` that averages with the stage-1 faces and
      emits the averaged face flux;
    - K7 per axis on the padded radiation block `R` [4, X, Y, Z];
    - with `coupling` = (U, rad_src, dt, eos, problem), K5 at both stages
      on the level's unpadded state U.

    The sweeps take their transverse fields and stage-1 faces from the
    kernels (each held to its plain version here), so both versions of a
    sweep see identical inputs."""
    n = Ug1[0].numel()
    dmins, chi, _ = sweep.precompute_transverse(Ug1, opts, None, True)
    dmins1, chi1, _ = sweep.precompute_transverse(Ug0, opts, None, True)
    # K1's stencil reaches 3 cells along each axis (chi's 3-point min of a
    # 5-point flattening); a halo of the ghost width covers it
    for stage, Ug in ((1, Ug0), (2, Ug1)):
        yield Case("transverse", f"K1 stage {stage}{tag}",
                   lambda Ug=Ug: sweep.precompute_transverse(Ug, opts, None, True)[:2],
                   lambda Ug=Ug: _slabbed(
                       lambda U: sweep.precompute_transverse_plain(U, opts, None, True)[:2],
                       (Ug,), 0, nslab, halo=4))
    for d in opts.active_axes:
        other = (d + 1) % 3
        s1 = dict(dx_axis=opts.dx[d], state_is_cons=True)

        def plain1(U, c, dmn, d=d):
            return sweep.axis_flux_plain(U, d, opts, c, dmn, **s1)

        yield Case("axis_flux", f"K2 stage 1 axis {d}{tag}",
                   lambda d=d, c=chi1, dm=dmins1: sweep.compute_axis_flux(Ug0, d, opts, c,
                                                                          dm, **s1),
                   lambda plain1=plain1, other=other, c=chi1, dm=dmins1: _slabbed(
                       plain1, (Ug0, c, dm), other, nslab))
        F1, v1 = sweep.compute_axis_flux(Ug0, d, opts, chi1, dmins1, state_is_cons=True)
        kw = dict(dx_axis=opts.dx[d], avg_with=(F1, v1), state_is_cons=True,
                  emit_avg_flux=True)
        # reads Ug1, chi, two dmin fields and stage 1's faces (not its face
        # velocities); writes div, dvel and the averaged flux
        dm = {t: f for t, f in dmins.items() if t != d}
        cost = (_nbytes(Ug1, chi, *dm.values(), F1) + _nbytes(Ug1) + _nbytes(Ug1[0])
                + _nbytes(Ug1), k2_ops(opts) * n)

        def plain(U, c, dmn, F1s, v1s, d=d):
            return sweep.axis_flux_plain(U, d, opts, c, dmn, dx_axis=opts.dx[d],
                                         avg_with=(F1s, v1s), state_is_cons=True,
                                         emit_avg_flux=True)

        yield Case("axis_flux_avg", f"K2d axis {d}{tag}",
                   lambda d=d, kw=kw: sweep.compute_axis_flux(Ug1, d, opts, chi, dmins, **kw),
                   lambda plain=plain, other=other, F1=F1, v1=v1: _slabbed(
                       plain, (Ug1, chi, dmins, F1, v1), other, nslab),
                   lambda cost=cost: cost)
    del dmins1, chi1
    for d in range(3):
        cost = k7_cost(R)
        yield Case("rad_axis_flux", f"K7 axis {d}{tag}",
                   lambda d=d: rsweep.compute_rad_axis_flux(R, d, ropts),
                   lambda d=d: _slabbed(lambda Rs: rsweep.rad_axis_flux_plain(Rs, d, ropts),
                                        (R,), (d + 1) % 3, nslab),
                   lambda cost=cost: cost)
    if coupling is None:
        return
    U, rad_src, dt, eos, problem = coupling
    rs = source.RAD_START
    for stage in (1, 2):
        yield Case("rad_source", f"K5 stage {stage}{tag}",
                   lambda stage=stage: source.source_update(U, rad_src, dt, stage, ropts,
                                                            eos, problem, rs),
                   lambda stage=stage: _slabbed(
                       lambda Us, srcs: source.source_update_plain(
                           Us, srcs, dt, stage, ropts, eos, problem, rs),
                       (U, rad_src), 0, nslab),
                   scaled=True)


def plain_transverse(U: torch.Tensor, opts, bc_kinds: dict, nslab: int = 1):
    """K1's plain version (`precompute_transverse_plain`, conserved input)
    with each axis's fields computed in `nslab` slabs along another axis,
    where its stencil does not reach, so the result is the same bitwise at
    any wall kind. Returns (dmins, chi_cell)."""
    dmins, chi_cell = {}, None
    for t in opts.active_axes:
        dmins[t], m3 = _slabbed(
            lambda Us, t=t: sweep._transverse_axis_plain(Us, t, opts, bc_kinds.get(t),
                                                         True)[:2],
            (U,), (t + 1) % 3, nslab)
        if m3 is not None:
            chi_cell = m3 if chi_cell is None else torch.minimum(chi_cell, m3)
    return dmins, chi_cell


def lean_mask(shape, seed: int, frac: float = 0.01, device="cpu") -> torch.Tensor:
    """A seeded 0/1 float32 FOFC mask flagging `frac` of the cells, and
    whole lines of cells on the lo x wall, the hi y wall and the hi z
    wall."""
    rng = np.random.default_rng(seed)
    m = torch.from_numpy(rng.random(shape, dtype=np.float32) < frac)
    m[0, :, shape[2] // 3] = True
    m[shape[0] // 2, shape[1] - 1, :] = True
    m[:, shape[1] // 4, shape[2] - 1] = True
    return m.to(device=device, dtype=torch.float32)


LEAN_VARIANTS = ("clean", "acc", "fo_mask", "fo_mask+acc+fo_from")


def lean_cases(U0: torch.Tensor, U1: torch.Tensor, opts, bc_kinds: dict, seed: int = 0,
               variants=LEAN_VARIANTS, axes=(0, 1, 2), nslab: int = 1,
               tag: str = "") -> Iterator[Case]:
    """K2c (the `div_only` sweep of the lean step) per axis, in `variants`:

    - ``clean``: the div-only sweep of U0 (stage 1's first axis);
    - ``acc``: the same, added onto running totals in place (the chained
      axes and stage 2);
    - ``fo_mask``: with the FOFC blend on a seeded mask (`lean_mask`);
    - ``fo_mask+acc+fo_from``: the sweep of U1 blended with U0's first-order
      fluxes and added onto the totals (stage 2's redo at or below 272).

    Every input of the kernel comes from a plain version (K1's fields by
    `plain_transverse`, the running totals from the plain clean sweep of
    axis 0), so no kernel output feeds both sides; the plain side runs in
    `nslab` slabs along another axis. The accumulators are copied for each
    compared call; `run_timed` adds onto one copy in place, as the step
    does."""
    n = U0[0].numel()
    shape = tuple(U0.shape[1:])
    k1 = {"0": plain_transverse(U0, opts, bc_kinds, nslab)}
    if any("fo_from" in v for v in variants):
        k1["1"] = plain_transverse(U1, opts, bc_kinds, nslab)
    mask = lean_mask(shape, seed, device=U0.device) if any("fo_mask" in v for v in variants) \
        else None
    dmins0, chi0 = k1["0"]
    acc = _slabbed(lambda U, c, dm: sweep.axis_flux_plain(
        U, 0, opts, c, dm, bc_axis=bc_kinds.get(0), dx_axis=opts.dx[0], state_is_cons=True,
        div_only=True), (U0, chi0, dmins0), 1, nslab)
    timed_acc = tuple(a.clone() for a in acc)
    for d in axes:
        other = (d + 1) % 3
        for v in variants:
            stage2 = "fo_from" in v
            U = U1 if stage2 else U0
            dmins, chi = k1["1" if stage2 else "0"]
            kw = dict(bc_axis=bc_kinds.get(d), dx_axis=opts.dx[d], state_is_cons=True,
                      div_only=True)
            m = mask if "fo_mask" in v else None
            fo = U0 if stage2 else None
            with_acc = "acc" in v
            dm = [f for t, f in dmins.items() if t != d]
            flagged = 0
            if m is not None:
                flagged = int(((sh(m, -1, d) > 0) | (m > 0)).sum())
            # reads the state, chi, two dmin fields [, the mask, fo_from, the
            # accumulators]; writes div and dvel (in place with acc)
            cost = (_nbytes(U, chi, *dm, m, fo, acc if with_acc else None)
                    + _nbytes(acc), k2_ops(opts) * n + k2_ops(opts, True) * flagged)

            def kernel(acc_in, d=d, U=U, chi=chi, dmins=dmins, m=m, fo=fo, kw=kw):
                return sweep.compute_axis_flux(U, d, opts, chi, dmins, acc=acc_in, fo_mask=m,
                                               fo_from=fo, **kw)

            def plain(Us, c, dmn, ms, fos, acs, d=d, kw=kw):
                return sweep.axis_flux_plain(Us, d, opts, c, dmn, acc=acs, fo_mask=ms,
                                             fo_from=fos, **kw)

            copy = (lambda: tuple(a.clone() for a in acc)) if with_acc else (lambda: None)
            yield Case("axis_flux_lean", f"K2c {v} axis {d}{tag}",
                       lambda kernel=kernel, copy=copy: kernel(copy()),
                       lambda plain=plain, U=U, chi=chi, dmins=dmins, m=m, fo=fo, copy=copy,
                       other=other: _slabbed(plain, (U, chi, dmins, m, fo, copy()), other,
                                             nslab),
                       lambda cost=cost: cost,
                       run_timed=lambda kernel=kernel, w=with_acc: kernel(
                           timed_acc if w else None))


def k8_ops_per_cell(order: int) -> int:
    return 7 * OPS_K8_RECON[order] + OPS_K8_HLLD + OPS_K8_REST


def mhd_cases(prim: torch.Tensor, bxf, opts, tag: str = "") -> Iterator[Case]:
    """K8 per axis on the primitives `prim` [8, X, Y, Z] and the staggered
    face fields `bxf` [Bf_x, Bf_y, Bf_z]: reads 7 primitives (the cell field
    along the axis is not needed: the face field takes its place) and one
    face field, writes 8 rows."""
    n = prim[0].numel()
    for d in range(3):
        cost = (7 * _nbytes(prim[0]) + _nbytes(bxf[d]) + _nbytes(prim),
                k8_ops_per_cell(opts.reconstruction_order) * n)
        yield Case("mhd_axis", f"K8 axis {d}{tag}",
                   lambda d=d: msweep.compute_mhd_axis(prim, bxf[d], d, opts),
                   lambda d=d: msweep.mhd_axis_plain(prim, bxf[d], d, opts),
                   lambda cost=cost: cost)


def rough_mhd_state(n: int, seed: int = 11):
    """Seeded (prim [8, n, n, n], [Bf_x, Bf_y, Bf_z]) float64 numpy arrays that
    take every HLLD region and branch along every axis: strong random fields
    (beta ~ 0.1), slabs moving at +-30 (supersonic both ways), slabs of
    faces with bx = 0 and with |bx| = 1e-7, and uniform blocks at rest with
    the field along one axis only and bx^2 > gamma P (degenerate star
    denominators)."""
    rng = np.random.default_rng(seed)
    shape = (n, n, n)
    rho = 0.5 + rng.random(shape)
    v = rng.standard_normal((3,) + shape)
    P = 0.05 + rng.random(shape)
    B = 2.0 * rng.standard_normal((3,) + shape)
    q = max(n // 8, 1)
    for d in range(3):
        sl = [slice(None)] * 3
        sl[(d + 1) % 3] = slice(0, q)
        v[d][tuple(sl)] = 30.0
        sl[(d + 1) % 3] = slice(q, 2 * q)
        v[d][tuple(sl)] = -30.0
    bxf = [B[d].copy() for d in range(3)]
    for d in range(3):
        sl = [slice(None)] * 3
        sl[(d + 2) % 3] = slice(2 * q, 3 * q)
        bxf[d][tuple(sl)] = 0.0
        sl[(d + 2) % 3] = slice(3 * q, 4 * q)
        bxf[d][tuple(sl)] = 1e-7 * np.sign(bxf[d][tuple(sl)])
    h = n // 2
    for d in range(3):
        sl = [slice(h, n)] * 3
        sl[d] = slice(0, n)
        sl[(d + 1) % 3] = slice(h + d * q, h + (d + 1) * q)
        sl = tuple(sl)
        rho[sl], P[sl] = 1.0, 0.01
        for k in range(3):
            v[k][sl] = 0.0
            B[k][sl] = bxf[k][sl] = 1.0 if k == d else 0.0
    return np.concatenate([rho[None], v, P[None], B]), bxf


CORR_VARIANTS = ("stage 1", "stage 1 acc", "stage 2 fo_from")


def corr_cases(U0: torch.Tensor, U1: torch.Tensor, opts, corr_masks: dict, seed: int = 0,
               variants=CORR_VARIANTS, tag: str = "") -> Iterator[Case]:
    """K2e (the lean sweep with the flux-register seed, `corr_mask`) per
    axis on a ghost-free periodic state, with the per-axis boundary-face
    masks `corr_masks` of a level's coverage:

    - ``stage 1``: the clean sweep of U0, div, dvel and corr fresh (stage
      1's first axis);
    - ``stage 1 acc``: the same added onto running totals and a running
      seed in place (the chained axes);
    - ``stage 2 fo_from``: the sweep of U1 blended on a seeded FOFC mask
      with U0's first-order fluxes (the redo at or below 272 cells an
      axis), added onto the totals and the seed.

    Every input comes from a plain version (K1's fields by
    `plain_transverse`, the totals from the plain sweep of axis 0); the
    accumulators are copied for each compared call, and `run_timed` adds
    onto one copy in place, as the step does."""
    n = U0[0].numel()
    shape = tuple(U0.shape[1:])
    periodic = {0: None, 1: None, 2: None}
    k1 = {"0": plain_transverse(U0, opts, periodic), "1": plain_transverse(U1, opts, periodic)}
    mask = lean_mask(shape, seed, device=U0.device)
    dmins0, chi0 = k1["0"]
    first = sweep.axis_flux_plain(U0, 0, opts, chi0, dmins0, dx_axis=opts.dx[0],
                                  state_is_cons=True, div_only=True, corr_mask=corr_masks[0])
    acc, corr = first[:2], first[2]
    timed = (tuple(a.clone() for a in acc), corr.clone())
    for d in range(3):
        for v in variants:
            stage2 = "stage 2" in v
            U = U1 if stage2 else U0
            dmins, chi = k1["1" if stage2 else "0"]
            m = mask if stage2 else None
            fo = U0 if stage2 else None
            with_acc = "acc" in v or stage2
            kw = dict(dx_axis=opts.dx[d], state_is_cons=True, div_only=True,
                      corr_mask=corr_masks[d], fo_mask=m, fo_from=fo)
            dm = [f for t, f in dmins.items() if t != d]
            flagged = 0 if m is None else int(((sh(m, -1, d) > 0) | (m > 0)).sum())
            # reads the state, chi, two dmin fields, the boundary mask [, the
            # FOFC mask, fo_from, the accumulators and the seed]; writes div,
            # dvel and corr (in place with the accumulators)
            cost = (_nbytes(U, chi, *dm, corr_masks[d], m, fo,
                            (acc, corr) if with_acc else None)
                    + _nbytes(acc, corr), k2_ops(opts) * n + k2_ops(opts, True) * flagged)

            def copy(w=with_acc):
                return (tuple(a.clone() for a in acc), corr.clone()) if w else (None, None)

            def kernel(accs, d=d, U=U, chi=chi, dmins=dmins, kw=kw):
                return sweep.compute_axis_flux(U, d, opts, chi, dmins, acc=accs[0],
                                               corr_acc=accs[1], **kw)

            def plain(accs, d=d, U=U, chi=chi, dmins=dmins, kw=kw):
                return sweep.axis_flux_plain(U, d, opts, chi, dmins, acc=accs[0],
                                             corr_acc=accs[1], **kw)

            yield Case("axis_flux_corr", f"K2e {v} axis {d}{tag}",
                       lambda kernel=kernel, copy=copy: kernel(copy()),
                       lambda plain=plain, copy=copy: plain(copy()),
                       lambda cost=cost: cost,
                       run_timed=lambda kernel=kernel, w=with_acc: kernel(
                           timed if w else (None, None)))


def k7_cost(R: torch.Tensor):
    """(bytes, FP32 operations) of one K7 axis over radiation blocks `R`
    [4, X, Y, Z] or [B, 4, X, Y, Z]: each input value read once, the flux
    (as many values) written once, OPS_K7_AXIS a cell."""
    nbytes = R.numel() * R.element_size()
    return 2 * nbytes, OPS_K7_AXIS * (R.numel() // 4)


def k9_cost(pool: torch.Tensor, rows: torch.Tensor):
    """(bytes, 0) of K9 gathering `rows` (int32 [n]) of `pool` [cap, ...]:
    each distinct row read once, each gathered row written once."""
    row_bytes = pool[0].numel() * pool.element_size()
    return (int(torch.unique(rows).numel()) + rows.numel()) * row_bytes, 0


def rough_rad_blocks(nbatch: int, shape, seed: int, device) -> torch.Tensor:
    """Seeded radiation blocks [nbatch, 4, X, Y, Z] f32 (c = 10, so |F| < c
    E is |f| < 1): E ~ 1 with 10% of cells at 2e-10, |f| up to 0.5 with 10%
    at 0.9999, so reconstructed faces go inadmissible and the donor-cell
    fallback fires."""
    g = torch.Generator(device=device).manual_seed(seed)
    full = (nbatch, *shape)

    def rand(*s):
        return torch.rand(s, generator=g, device=device, dtype=torch.float64)

    E = 0.5 + rand(*full)
    E[rand(*full) < 0.1] = 2e-10
    nvec = torch.randn((3, *full), generator=g, device=device, dtype=torch.float64)
    nvec /= nvec.norm(dim=0)
    fmag = 0.5 * rand(*full)
    fmag[rand(*full) < 0.1] = 0.9999
    F = nvec * fmag * 10.0 * E
    return torch.stack([E, F[0], F[1], F[2]], dim=1).float().contiguous()


# (batch, extents) of the K7 edge shapes: extents of 4 and 5 (the periodic
# halo wraps more than once around the tile), extents that are not
# multiples of the kernel's tile (32 along, 16 across), a batch of 3
K7_EDGE_SHAPES = ((1, (4, 4, 4)), (3, (5, 5, 5)), (3, (37, 18, 33)), (1, (4, 35, 17)))


def k7_edge_cases(ropts, device, seed: int = 3) -> Iterator[Case]:
    """K7 (batched form) on the edge shapes, every axis and reconstruction
    order, against its plain version block by block (bitwise)."""
    import dataclasses

    for i, (nb, shape) in enumerate(K7_EDGE_SHAPES):
        R5 = rough_rad_blocks(nb, shape, seed + i, device)
        for order in (1, 2, 3):
            o = dataclasses.replace(ropts, reconstruction_order=order)
            yield from k7_batched_cases(R5, o, f" B {nb} {shape} order {order}")


def gather_cases(pools: dict, rows: torch.Tensor) -> Iterator[Case]:
    """K9 on each pool of `pools` ({label: [cap, ...] tensor}) for the int32
    row index `rows` against its plain version. The compared call reads the
    kernel's error flag after the gather (`check_gathers`); the timed one
    launches only, as the main path does. The library call is
    `torch.index_select` with its int64 index built beforehand. Bytes: each
    distinct row read once (the index repeats rows: neighbouring tiles
    share neighbours, a missing one is clamped to row 0), each gathered row
    written once."""
    from .amr import packed

    rows64 = rows.to(torch.int64)
    for label, pool in pools.items():
        cost = k9_cost(pool, rows)

        def checked(pool=pool):
            out = packed.row_gather(pool, rows)
            packed.check_gathers(pool.device)
            return out

        yield Case("row_gather", f"K9 {label}", checked,
                   lambda pool=pool: packed.row_gather_plain(pool, rows),
                   lambda cost=cost: cost,
                   run_timed=lambda pool=pool: packed.row_gather(pool, rows),
                   run_library=lambda pool=pool: torch.index_select(pool, 0, rows64))


def batched_cases(Ug5: torch.Tensor, R5: torch.Tensor, opts, ropts,
                  tag: str = "") -> Iterator[Case]:
    """The packed engine's batched launches against the per-block plain
    versions: K1 + K2's face mode over a chunk of conserved hydro blocks
    `Ug5` [B, 6, X, Y, Z] (PPM and first order), and K7 per axis over a
    chunk of radiation blocks `R5` [B, 4, X, Y, Z]."""
    def per_block_fluxes(first_order):
        fl, fv = {}, {}
        for blk in Ug5:
            f1, v1 = sweep.compute_fluxes_pallas(blk, opts, first_order, plain=True)
            for d in f1:
                fl.setdefault(d, []).append(f1[d])
                fv.setdefault(d, []).append(v1[d])
        return ({d: torch.stack(x) for d, x in fl.items()},
                {d: torch.stack(x) for d, x in fv.items()})

    for fo, what in ((False, "PPM"), (True, "first order")):
        yield Case("axis_flux", f"K1+K2 faces batched {what}{tag}",
                   lambda fo=fo: sweep.compute_fluxes_batched(Ug5, opts, fo),
                   lambda fo=fo: per_block_fluxes(fo))
    yield from k7_batched_cases(R5, ropts, tag)


def k7_batched_cases(R5: torch.Tensor, ropts, tag: str = "") -> Iterator[Case]:
    """K7 per axis over a chunk of radiation blocks `R5` [B, 4, X, Y, Z]
    (one launch an axis) against its plain version block by block."""
    for d in range(3):
        yield Case("rad_axis_flux", f"K7 batched axis {d}{tag}",
                   lambda d=d: rsweep.compute_rad_axis_flux_batched(R5, d, ropts),
                   lambda d=d: torch.stack([rsweep.rad_axis_flux_plain(r, d, ropts)
                                            for r in R5]),
                   lambda: k7_cost(R5))


def ulps_of_max(got, ref) -> float:
    """The largest |got - ref| over the finite values of each component, in
    units of one float32 ulp of that component's largest magnitude (the
    measure "within n ulps" of the face kernels), the worst component."""
    worst = 0.0
    for g, r in zip(_flat(got), _flat(ref)):
        g, r = g.float(), r.float()
        per_comp = r.dim() >= 4 or (r.dim() == 3 and r.shape[0] == 6)
        if r.dim() > 4:
            g, r = g.reshape(-1, *g.shape[-4:]), r.reshape(-1, *r.shape[-4:])
            g, r = g.transpose(0, 1), r.transpose(0, 1)
        for gc, rc in (zip(g, r) if per_comp else [(g, r)]):
            fin = torch.isfinite(rc)
            if not bool(fin.any()):
                continue
            scale = rc[fin].abs().max()
            ulp = float(torch.nextafter(scale, torch.tensor(float("inf"),
                                                            device=scale.device)) - scale)
            worst = max(worst, float((gc[fin] - rc[fin]).abs().max()) / ulp)
    return worst


# ------------------------------------------------ K2's face kernel, batched
def hydro_blocks(nbatch: int, shape, seed: int, device) -> torch.Tensor:
    """Seeded conserved hydro blocks [nbatch, 6, X, Y, Z] f32: rho in [0.5,
    1.5], |v| ~ 0.3 (x7 in a tenth of the cells), eint in [1, 2] (x30 in a
    tenth), so that PPM's limiters and every HLLC branch run."""
    g = torch.Generator(device=device).manual_seed(seed)
    full = (nbatch, *shape)

    def rand():
        return torch.rand(full, generator=g, device=device)

    rho = 0.5 + rand()
    v = 0.3 * torch.randn((3, *full), generator=g, device=device)
    v[:, rand() < 0.1] *= 7.0
    eint = 1.0 + rand()
    eint[rand() < 0.1] *= 30.0
    ke = 0.5 * rho * (v[0] ** 2 + v[1] ** 2 + v[2] ** 2)
    return torch.stack([rho, rho * v[0], rho * v[1], rho * v[2], rho * eint + ke,
                        rho * eint], dim=1).contiguous()


def with_scalar_rows(U: torch.Tensor, opts, seed: int) -> torch.Tensor:
    """`U` [.., 6, X, Y, Z] (one state or a batch) with the passive scalars
    of `opts` appended as seeded conserved densities: rho times a value in
    [0, 1), and the mass scalars as fractions in [0.2, 0.5) of rho, so that
    they sum to less than rho. Unchanged without scalars."""
    if opts.n_scalars == 0:
        return U
    g = torch.Generator(device=U.device).manual_seed(seed)
    rho = U.select(-4, 0).unsqueeze(-4)
    shape = list(rho.shape)
    shape[-4] = opts.n_scalars
    frac = torch.rand(shape, generator=g, device=U.device, dtype=U.dtype)
    frac[..., :opts.n_mscalars, :, :, :] = 0.2 + 0.3 * frac[..., :opts.n_mscalars, :, :, :]
    return torch.cat([U, frac * rho], dim=-4).contiguous()


def form_tag(opts) -> str:
    """The label of K2's form (csrc/sweep.cuh) for `opts`: empty for PPM
    without scalars."""
    tag = " PLM" if opts.reconstruction_order == 2 else ""
    if opts.n_scalars:
        tag += f" {opts.n_scalars} scalar" + ("s" if opts.n_scalars > 1 else "")
        if opts.n_mscalars:
            tag += f" ({opts.n_mscalars} mass)"
    return tag


def k3_floor_case(opts, device, shape=(16, 24, 20), seed: int = 30) -> Case:
    """K3 with the scalars of `opts` on a seeded state whose update drives
    a fifth of the cells below the density floor (0.9), so the scalars are
    rescaled there, against its plain version."""
    import dataclasses

    o = dataclasses.replace(opts, density_floor=0.9)
    U = with_scalar_rows(hydro_blocks(1, shape, seed, device)[0], o, seed)
    Ug0 = with_scalar_rows(hydro_blocks(1, shape, seed + 1, device)[0], o, seed + 1)
    g = torch.Generator(device=device).manual_seed(seed + 2)
    divs = {d: torch.randn(U.shape, generator=g, device=device) for d in range(3)}
    dvels = {d: torch.randn(shape, generator=g, device=device) for d in range(3)}
    return Case("apply_update", f"K3 density floor{form_tag(o)}",
                lambda: sweep.apply_update(U, Ug0, divs, dvels, 0.05, o),
                lambda: sweep.apply_update_plain(U, Ug0, divs, dvels, 0.05, o))


def _bytes_of(*tensors) -> int:
    """Bytes of the tensors (views: their own elements), meta tensors too."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def k2_face_cost(U5: torch.Tensor, d: int, chi=None, dmins: dict | None = None,
                 first_order: bool = False, wall: bool = False):
    """(bytes, FP32 operations) of K2's face kernel along axis `d` over
    blocks `U5` [B, 6, X, Y, Z]: the state read once, chi and the two
    transverse dmin fields once (PPM), the faces [B, 6, ...] and face
    velocities [B, ...] written once (and the hi-wall planes on a wall
    axis); OPS_K2_FACE a face (OPS_FO_FACE in first order)."""
    B, nv, X, Y, Z = U5.shape
    dims = (X, Y, Z)
    faces = B * X * Y * Z + (B * X * Y * Z // dims[d] if wall else 0)
    fields = [] if first_order else [chi] + [m for t, m in (dmins or {}).items() if t != d]
    nbytes = _bytes_of(U5, *fields) + (nv + 1) * faces * U5.element_size()
    return nbytes, (OPS_FO_FACE if first_order else OPS_K2_FACE) * faces


def face_plain(U5: torch.Tensor, d: int, opts, chi, dmins: dict, bc_axis=None,
               first_order: bool = False, nslab: int = 1):
    """The plain faces of axis `d` (`axis_flux_plain`, conserved input),
    block by block, each in `nslab` slabs along another axis (its stencil
    does not reach across them): (F [B, 6, ...], v [B, ...][, F_hi, v_hi])."""
    out = []
    for b in range(U5.shape[0]):
        dm = {t: m[b] for t, m in dmins.items()}

        def fn(U, c, dmn):
            return sweep.axis_flux_plain(U, d, opts, c, dmn, first_order, bc_axis=bc_axis,
                                         state_is_cons=True)

        out.append(_slabbed(fn, (U5[b], None if chi is None else chi[b], dm), (d + 1) % 3,
                            nslab))
    return tuple(torch.stack([r[i] for r in out]) for i in range(len(out[0])))


def face_cases(U5: torch.Tensor, opts, bc_kinds: dict | None = None, tag: str = "",
               orders=(False, True), nslab: int = 1) -> Iterator[Case]:
    """K2's face kernel (`sweep._axis_faces_cuda`, conserved input, one
    launch an axis over the blocks `U5` [B, 6, X, Y, Z]) against the plain
    faces block by block, per axis, in PPM (K1's fields from its plain
    version) and first order (`orders`). `bc_kinds` {axis: (lo, hi)} puts
    reflecting walls on a single block (B = 1)."""
    from ._cuda import library

    dmins, chi = {}, None
    if False in orders:
        dmins, chi = sweep.precompute_transverse_batched_plain(U5, opts, bc_kinds, True)
    for fo in orders:
        for d in range(3):
            vax, wax = sweep._transverse_axes(d, 3)
            bc_axis = None if bc_kinds is None else bc_kinds.get(d)
            c = None if fo else chi
            dv = None if fo else dmins.get(vax)
            dw = None if fo else dmins.get(wax)

            def kernel(d=d, c=c, dv=dv, dw=dw, bc_axis=bc_axis, fo=fo):
                F, v, Fh, vh = sweep._axis_faces_cuda(library(), U5, d, opts, c, dv, dw,
                                                      bc_axis, True, fo)
                return (F, v) if Fh is None else (F, v, Fh, vh)

            def plain(d=d, bc_axis=bc_axis, fo=fo):
                return face_plain(U5, d, opts, None if fo else chi, {} if fo else dmins,
                                  bc_axis, fo, nslab)

            cost = k2_face_cost(U5, d, c, None if fo else dmins, fo, bc_axis is not None)
            what = "first order" if fo else ("PLM" if opts.reconstruction_order == 2 else "PPM")
            yield Case("axis_flux", f"K2 faces {what} axis {d}{tag}", kernel, plain,
                       lambda cost=cost: cost)


def k1_batched_case(U5: torch.Tensor, opts, tag: str = "") -> Case:
    """K1 over blocks `U5` [B, 6, X, Y, Z] (conserved, periodic, one launch)
    against its plain version block by block (`k1_cost_of`)."""
    cost = k1_cost_of(U5, opts)
    return Case("transverse", f"K1 batched{tag}",
                lambda: sweep.precompute_transverse_batched(U5, opts, None, True),
                lambda: sweep.precompute_transverse_batched_plain(U5, opts, None, True),
                lambda: cost)


# (batch, extents, walls) of the face kernel's edge shapes: extents of 4 and
# 5 (the halo wraps or mirrors more than once around a tile), extents that
# are not multiples of a tile, a batch of 3 (periodic: a wall axis takes one
# block), reflecting walls on every axis of single blocks
FACE_EDGE_SHAPES = ((1, (4, 4, 4), True), (1, (5, 5, 5), False), (3, (5, 5, 5), False),
                    (3, (37, 18, 33), False), (1, (37, 18, 33), True), (1, (4, 35, 17), True))


def face_edge_cases(opts, device, seed: int = 4) -> Iterator[Case]:
    """K2's face kernel on the edge shapes, every axis, PPM and first order,
    against its plain version block by block."""
    from .registry import BC_REFLECT

    for i, (nb, shape, walls) in enumerate(FACE_EDGE_SHAPES):
        U5 = with_scalar_rows(hydro_blocks(nb, shape, seed + i, device), opts, seed + i)
        bc = {d: (BC_REFLECT, BC_REFLECT) for d in range(3)} if walls else None
        yield from face_cases(U5, opts, bc, f" B {nb} {shape}" + (" walls" if walls else "")
                              + form_tag(opts))


# K1's input variants on its edge shapes: (label, options changed, conserved
# input): PPM with flattening (chi_cell), the pressure from the specific
# internal energy, primitive input, and dmin alone (PLM; no flattening)
K1_EDGE_VARIANTS = (("PPM", {}, True), ("reconstruct_eint", {"reconstruct_eint": True}, True),
                    ("primitive input", {}, False),
                    ("PLM, dmin only", {"reconstruction_order": 2}, True),
                    ("no flattening, dmin only", {"use_flattening": False}, True))


def k1_edge_cases(opts, device, seed: int = 6) -> Iterator[Case]:
    """K1 (`precompute_transverse_batched`) on the face kernel's edge shapes
    (extents 4 and 5, ragged tiles, a batch of 3, reflecting walls on every
    axis) in each of K1_EDGE_VARIANTS, against its plain version block by
    block."""
    import dataclasses

    from .registry import BC_REFLECT

    for i, (nb, shape, walls) in enumerate(FACE_EDGE_SHAPES):
        U5 = hydro_blocks(nb, shape, seed + i, device)
        bc = {d: (BC_REFLECT, BC_REFLECT) for d in range(3)} if walls else None
        for label, changes, is_cons in K1_EDGE_VARIANTS:
            o = dataclasses.replace(opts, **changes)
            W5 = U5 if is_cons else torch.stack(
                [euler.cons_to_prim(u, o.eos, o.reconstruct_eint) for u in U5]).contiguous()
            yield Case("transverse", f"K1 B {nb} {shape}{' walls' if walls else ''} {label}",
                       lambda W5=W5, o=o, c=is_cons, bc=bc:
                           sweep.precompute_transverse_batched(W5, o, bc, c),
                       lambda W5=W5, o=o, c=is_cons, bc=bc:
                           sweep.precompute_transverse_batched_plain(W5, o, bc, c),
                       lambda W5=W5, o=o: k1_cost_of(W5, o))


# (extents, walls) of K2c's and K8's edge shapes: extents of 4 and 5 (the
# halo wraps or mirrors more than once around a tile), extents that are not
# multiples of the chosen tile along or across (83 and 47 cells: tiles of
# 28 and 24 along, lines of 16 across), reflecting walls, periodic axes,
# and both in one state (x periodic)
LEAN_EDGE_SHAPES = (((4, 4, 4), "walls"), ((5, 5, 5), "periodic"),
                    ((37, 18, 33), "periodic x"), ((4, 35, 17), "walls"),
                    ((83, 6, 47), "periodic"))
# K2c's variants on them: the clean sweep, onto running totals, the FOFC
# blend, the stage-2 redo (the blend from another state's first-order
# fluxes, onto the totals), first order, and K2e's register seed fresh and
# added onto a running seed (periodic axes only)
LEAN_EDGE_VARIANTS = ("clean", "acc", "fo_mask", "fo_mask+acc+fo_from", "first order",
                      "corr", "corr acc fo_from")


def _bc_of(kind: str) -> dict:
    from .registry import BC_OUTFLOW, BC_REFLECT

    wall, out = (BC_REFLECT, BC_REFLECT), (BC_OUTFLOW, BC_OUTFLOW)
    r_o, o_r = (BC_REFLECT, BC_OUTFLOW), (BC_OUTFLOW, BC_REFLECT)
    return {"walls": {0: wall, 1: wall, 2: wall},
            "periodic": {0: None, 1: None, 2: None},
            "periodic x": {0: None, 1: wall, 2: wall},
            # the JAX package's `outflow_all` and `mixed` (tests/test_ghostfree.py:
            # 75-95), Richtmyer-Meshkov's x walls, and each mixed pair on an axis
            "outflow": {0: out, 1: out, 2: out},
            "mixed": {0: None, 1: r_o, 2: o_r},
            "outflow x": {0: out, 1: None, 2: None},
            "reflect-outflow": {0: r_o, 1: o_r, 2: out}}[kind]


# (extents, walls) of the outflow variant's edge shapes: LEAN_EDGE_SHAPES'
# extents with every side kind on every axis (outflow on both sides, each
# reflect / outflow pair, periodic beside them)
OUTFLOW_EDGE_SHAPES = (((4, 4, 4), "outflow"), ((5, 5, 5), "mixed"),
                       ((37, 18, 33), "outflow x"), ((4, 35, 17), "reflect-outflow"),
                       ((83, 6, 47), "mixed"), ((5, 5, 5), "reflect-outflow"))


# the edge shapes of K2's PLM and scalar forms: LEAN_EDGE_SHAPES (extents 4
# and 5, ragged tiles, walls, periodic axes) and two outflow sides' shapes
FORM_EDGE_SHAPES = LEAN_EDGE_SHAPES + (((5, 5, 5), "mixed"), ((4, 35, 17), "reflect-outflow"))


def rough_wall_state(shape, seed: int, device) -> torch.Tensor:
    """`hydro_blocks` with a density and pressure well and strong outward
    and inward jets in the first and last two cells of every axis, so that
    PPM's limiters, flattening and the FOFC mask act at the walls."""
    U = hydro_blocks(1, shape, seed, device)[0].clone()
    rho, eint = U[0].clone(), (U[5] / U[0]).clone()
    v = U[1:4] / U[0]
    for d in range(3):
        n = shape[d]
        for c, vel, boost in ((0, -3.0, 30.0), (1, 2.5, 4.0), (n - 2, -2.5, 4.0),
                              (n - 1, 3.0, 30.0)):
            sl = [slice(None)] * 3
            sl[d] = c
            v[d][tuple(sl)] = vel
            eint[tuple(sl)] *= boost
    rho[tuple(s // 2 for s in shape)] = 1e-4
    eint[tuple(s // 2 for s in shape)] = 1e-6
    ke = 0.5 * rho * (v * v).sum(dim=0)
    return torch.stack([rho, rho * v[0], rho * v[1], rho * v[2], rho * eint + ke,
                        rho * eint]).contiguous()


def k1_wall_edge_cases(opts, device, seed: int = 16,
                       shapes=OUTFLOW_EDGE_SHAPES) -> Iterator[Case]:
    """K1 on one state (`precompute_transverse`: dmins, chi_cell and the
    outflow chi planes) at `shapes`, in each of K1_EDGE_VARIANTS, against
    its plain version; K1 is held bit for bit."""
    import dataclasses

    for i, (shape, kind) in enumerate(shapes):
        bc = _bc_of(kind)
        U = rough_wall_state(shape, seed + i, device)
        for label, changes, is_cons in K1_EDGE_VARIANTS:
            o = dataclasses.replace(opts, **changes)
            W = U if is_cons else euler.cons_to_prim(U, o.eos, o.reconstruct_eint).contiguous()
            yield Case("transverse", f"K1 {shape} {kind} {label}",
                       lambda W=W, o=o, c=is_cons, bc=bc:
                           sweep.precompute_transverse(W, o, bc, c),
                       lambda W=W, o=o, c=is_cons, bc=bc:
                           sweep.precompute_transverse_plain(W, o, bc, c))


def face_wall_edge_cases(opts, device, seed: int = 18,
                         shapes=OUTFLOW_EDGE_SHAPES) -> Iterator[Case]:
    """K2's face kernel (`compute_axis_flux` without dx_axis: the FOFC
    fallback's faces) on one state at `shapes`, every axis, PPM (K1's fields
    and outflow planes from its plain version) and first order, against
    `axis_flux_plain`."""
    for i, (shape, kind) in enumerate(shapes):
        bc = _bc_of(kind)
        U = with_scalar_rows(rough_wall_state(shape, seed + i, device), opts, seed + i)
        dmins, chi, planes = sweep.precompute_transverse_plain(U, opts, bc, True)
        for fo in (False, True):
            for d in range(3):
                kw = dict(bc_axis=bc[d], state_is_cons=True,
                          chi_ghost_axis=None if fo else planes.get(d))
                c, dm = (None, {}) if fo else (chi, dmins)
                what = "first order" if fo else ("PLM" if opts.reconstruction_order == 2
                                                  else "PPM")
                yield Case("axis_flux", f"K2 faces {shape} {kind}{form_tag(opts)} {what} "
                           f"axis {d}",
                           lambda d=d, c=c, dm=dm, kw=kw, fo=fo:
                               sweep.compute_axis_flux(U, d, opts, c, dm, fo, **kw),
                           lambda d=d, c=c, dm=dm, kw=kw, fo=fo:
                               sweep.axis_flux_plain(U, d, opts, c, dm, fo, **kw))


def tile_edge_mask(shape, d: int, ta: int, seed: int, device) -> torch.Tensor:
    """A seeded 0/1 f32 FOFC mask flagging 5% of the cells and, along axis
    d, the first and last cell of every tile of `ta` cells (the first and
    last cells of the axis, next to its walls, among them) on every other
    line."""
    rng = np.random.default_rng(seed)
    m = rng.random(shape) < 0.05
    n = shape[d]
    idx = sorted({c for t0 in range(0, n, ta) for c in (t0, min(t0 + ta, n) - 1)})
    sl = [slice(None)] * 3
    sl[(d + 1) % 3] = slice(0, None, 2)
    sl[d] = idx
    m[tuple(sl)] = True
    return torch.from_numpy(m).to(device=device, dtype=torch.float32)


def box_face_masks(shape, device) -> dict:
    """Per-axis coarse-fine boundary-face masks (slot c = the lo face of
    cell c) of the box [n/4, 3n/4) along every axis: K2e's input."""
    lo = [n // 4 for n in shape]
    hi = [max(3 * n // 4, lo_ + 1) for n, lo_ in zip(shape, lo)]
    out = {}
    for d in range(3):
        m = np.zeros(shape, np.float32)
        for c in (lo[d], hi[d]):
            if c < shape[d]:
                sl = [slice(lo[a], hi[a]) for a in range(3)]
                sl[d] = c
                m[tuple(sl)] = 1.0
        out[d] = torch.from_numpy(m).to(device)
    return out


def lean_edge_cases(opts, device, seed: int = 8,
                    shapes=LEAN_EDGE_SHAPES) -> Iterator[Case]:
    """K2c and K2e (the div_only sweep, `compute_axis_flux`) on seeded
    conserved states at LEAN_EDGE_SHAPES, every axis, in each of
    LEAN_EDGE_VARIANTS (K2e's on periodic axes only), with K1's fields from
    its plain version and a mask from `tile_edge_mask` at the tile
    `hydro.sweep.lean_tile` chooses; the third shape also with CW84
    viscosity and reconstruct_eint. Against `axis_flux_plain`; the
    accumulators are copied for each call."""
    import dataclasses

    for i, (shape, kind) in enumerate(shapes):
        bc = _bc_of(kind)
        U0 = with_scalar_rows(hydro_blocks(1, shape, seed + i, device)[0], opts, seed + i)
        U1 = with_scalar_rows(hydro_blocks(1, shape, seed + 20 + i, device)[0], opts,
                              seed + 20 + i)
        g = torch.Generator(device=device).manual_seed(seed + 40 + i)
        acc = (torch.rand(U0.shape, generator=g, device=device),
               torch.rand(shape, generator=g, device=device))
        corr0 = torch.rand(U0.shape, generator=g, device=device)
        cmasks = box_face_masks(shape, device)
        extras = [("", opts)]
        if i == 2:
            extras.append((" visc eint", dataclasses.replace(opts, K_visc=0.1,
                                                             reconstruct_eint=True)))
        for etag, o in extras:
            k1 = {"0": sweep.precompute_transverse_plain(U0, o, bc, True),
                  "1": sweep.precompute_transverse_plain(U1, o, bc, True)}
            for d in range(3):
                ta, _ = sweep.lean_tile(shape[d], shape[1] if d == 2 else shape[2])
                mask = tile_edge_mask(shape, d, ta, seed + 60 + 3 * i + d, device)
                for v in LEAN_EDGE_VARIANTS:
                    if v.startswith("corr") and bc[d] is not None:
                        continue
                    stage2 = "fo_from" in v
                    U = U1 if stage2 else U0
                    dmins, chi, planes = k1["1" if stage2 else "0"]
                    kw = dict(bc_axis=bc[d], dx_axis=o.dx[d], state_is_cons=True,
                              div_only=True, first_order=v == "first order",
                              chi_ghost_axis=planes.get(d))
                    if "fo_mask" in v or stage2:
                        kw["fo_mask"] = mask
                    if stage2:
                        kw["fo_from"] = U0
                    if v.startswith("corr"):
                        kw["corr_mask"] = cmasks[d]
                    with_acc = "acc" in v

                    def copies(w=with_acc, c=v == "corr acc fo_from", acc=acc, corr0=corr0):
                        return (tuple(a.clone() for a in acc) if w else None,
                                corr0.clone() if c else None)

                    def kernel(U=U, d=d, dmins=dmins, chi=chi, kw=kw, o=o, copies=copies):
                        a, c = copies()
                        return sweep.compute_axis_flux(U, d, o, chi, dmins, acc=a,
                                                       corr_acc=c, **kw)

                    def plain(U=U, d=d, dmins=dmins, chi=chi, kw=kw, o=o, copies=copies):
                        a, c = copies()
                        return sweep.axis_flux_plain(U, d, o, chi, dmins, acc=a, corr_acc=c,
                                                     **kw)

                    name = "axis_flux_corr" if v.startswith("corr") else "axis_flux_lean"
                    yield Case(name, f"K2c {shape} {kind}{etag}{form_tag(o)} {v} axis {d}",
                               kernel, plain)


# K2's sweeps with a divergence on the same shapes: stage 1 (the faces and
# both divergences), first order, stage 2 (averaged with stage 1's faces, hi
# planes on a wall axis) and K2d (the averaged flux too; periodic axes only)
SWEEP_EDGE_VARIANTS = ("stage 1", "first order", "stage 2", "K2d")


def sweep_edge_cases(opts, device, seed: int = 10,
                     shapes=LEAN_EDGE_SHAPES) -> Iterator[Case]:
    """K2's sweeps with a divergence (`compute_axis_flux` with dx_axis,
    `csrc/sweep.cu` `sweep_tile_kernel`) on seeded conserved states at
    LEAN_EDGE_SHAPES, every axis, in each of SWEEP_EDGE_VARIANTS (K2d on
    periodic axes only), with K1's fields from its plain version and stage
    1's faces from the plain stage-1 sweep, so no kernel output feeds both
    sides; the third shape also with CW84 viscosity and reconstruct_eint.
    Against `axis_flux_plain`."""
    import dataclasses

    for i, (shape, kind) in enumerate(shapes):
        bc = _bc_of(kind)
        U0 = with_scalar_rows(hydro_blocks(1, shape, seed + i, device)[0], opts, seed + i)
        U1 = with_scalar_rows(hydro_blocks(1, shape, seed + 20 + i, device)[0], opts,
                              seed + 20 + i)
        extras = [("", opts)]
        if i == 2:
            extras.append((" visc eint", dataclasses.replace(opts, K_visc=0.1,
                                                             reconstruct_eint=True)))
        for etag, o in extras:
            dm0, chi0, pl0 = sweep.precompute_transverse_plain(U0, o, bc, True)
            dm1, chi1, pl1 = sweep.precompute_transverse_plain(U1, o, bc, True)
            for d in range(3):
                s1 = dict(bc_axis=bc[d], dx_axis=o.dx[d], state_is_cons=True)
                faces = sweep.axis_flux_plain(U0, d, o, chi0, dm0, chi_ghost_axis=pl0.get(d),
                                              **s1)[:-2]
                variants = {"stage 1": (U0, dm0, chi0, dict(s1, chi_ghost_axis=pl0.get(d))),
                            "first order": (U0, {}, None, dict(s1, first_order=True)),
                            "stage 2": (U1, dm1, chi1, dict(s1, avg_with=faces,
                                                            chi_ghost_axis=pl1.get(d)))}
                if bc[d] is None:
                    variants["K2d"] = (U1, dm1, chi1, dict(s1, avg_with=faces,
                                                           emit_avg_flux=True))
                for v, (U, dm, c, kw) in variants.items():
                    yield Case("axis_flux_avg" if v == "K2d" else "axis_flux",
                               f"K2 {shape} {kind}{etag}{form_tag(o)} {v} axis {d}",
                               lambda U=U, d=d, o=o, c=c, dm=dm, kw=kw:
                                   sweep.compute_axis_flux(U, d, o, c, dm, **kw),
                               lambda U=U, d=d, o=o, c=c, dm=dm, kw=kw:
                                   sweep.axis_flux_plain(U, d, o, c, dm, **kw))


def k6_edge_cases(opts, device, seed: int = 14) -> Iterator[Case]:
    """K6 (`k6_cases`: per axis and accumulated) on rough radiation blocks
    (`rough_rad_state`) at K4_EDGE_SHAPES (the transport tile's edges: the
    periodic halo wrapping around it, ragged tiles along and across), PPM
    everywhere and PLM and donor cell on the third shape."""
    import dataclasses

    for i, shape in enumerate(K4_EDGE_SHAPES):
        R0 = rough_rad_state(shape, seed + i, device, opts.c)[source.RAD_START:].contiguous()
        dx = tuple(1.0 / n for n in shape)
        for order in ((1, 2, 3) if i == 2 else (3,)):
            o = dataclasses.replace(opts, reconstruction_order=order)
            yield from k6_cases(R0, o, dx, f" {shape} order {order}")


def rough_rad_groups(shape, groups: int, seed: int, device, c: float = 1.0e3) -> torch.Tensor:
    """Seeded radiation block [4G, X, Y, Z] f32 of `groups` photon groups,
    each the radiation of `rough_rad_state` with its own seed (E near the
    floor beside E ~ 1, |f| -> 1: the donor-cell fallback fires in every
    group)."""
    return torch.cat([rough_rad_state(shape, seed + 101 * g, device, c)[source.RAD_START:]
                      for g in range(groups)]).contiguous()


def k6_group_edge_cases(opts, device, groups=(2, 4), seed: int = 40) -> Iterator[Case]:
    """K6 over G photon groups (`k6_cases`: per axis and accumulated) on
    rough blocks (`rough_rad_groups`) at K4_EDGE_SHAPES, PPM everywhere and
    PLM and donor cell on the third shape, for each G of `groups`."""
    import dataclasses

    for G in groups:
        for i, shape in enumerate(K4_EDGE_SHAPES):
            R0 = rough_rad_groups(shape, G, seed + i, device, opts.c)
            dx = tuple(1.0 / n for n in shape)
            for order in ((1, 2, 3) if i == 2 else (3,)):
                o = dataclasses.replace(opts, reconstruction_order=order, n_groups=G)
                yield from k6_cases(R0, o, dx, f" G={G} {shape} order {order}")


# K8's edge shapes: LEAN_EDGE_SHAPES' extents (every axis periodic)
MHD_EDGE_FLOORS = ((0.0, 0.0), (0.6, 0.1))


def mhd_edge_cases(opts, device, seed: int = 12) -> Iterator[Case]:
    """K8 on rough MHD states (`rough_mhd_state` of the largest extent,
    cropped) at LEAN_EDGE_SHAPES' extents, every axis, orders 1-3, with the
    floors off and on (MHD_EDGE_FLOORS), against `mhd_axis_plain`."""
    import dataclasses

    for i, (shape, _) in enumerate(LEAN_EDGE_SHAPES):
        prim, bxf = rough_mhd_state(max(shape), seed + i)
        crop = (slice(None),) + tuple(slice(0, n) for n in shape)
        prim = torch.tensor(prim[crop], dtype=torch.float32, device=device).contiguous()
        bxf = [torch.tensor(b[crop[1:]], dtype=torch.float32, device=device).contiguous()
               for b in bxf]
        for order in (1, 2, 3):
            for floors in MHD_EDGE_FLOORS:
                o = dataclasses.replace(opts, reconstruction_order=order,
                                        density_floor=floors[0], pressure_floor=floors[1])
                tag = f" {shape} order {order}" + (" floors" if floors[0] > 0 else "")
                for d in range(3):
                    yield Case("mhd_axis", f"K8{tag} axis {d}",
                               lambda d=d, o=o, p=prim, b=bxf: msweep.compute_mhd_axis(
                                   p, b[d], d, o),
                               lambda d=d, o=o, p=prim, b=bxf: msweep.mhd_axis_plain(
                                   p, b[d], d, o))


def rough_rad_state(shape, seed: int, device, c: float = 1.0e3) -> torch.Tensor:
    """Seeded [10, X, Y, Z] f32 radhydro state: moving gas (the work term is
    non-zero), |f| -> 1 and E near the floor beside E ~ 1 (|F| = f c E), so
    reconstructed faces go inadmissible and the donor-cell fallback fires."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = tuple(shape)

    def rand(*s):
        return torch.rand(s, generator=g, device=device, dtype=torch.float64)

    def randn(*s):
        return torch.randn(s, generator=g, device=device, dtype=torch.float64)

    rho = 0.5 + rand(*shape)
    v = 0.3 * randn(3, *shape)
    T = 0.5 + rand(*shape)
    Eint = rho * 1.5 * T
    E = T**4 * (0.5 + rand(*shape))
    nvec = randn(3, *shape)
    nvec /= nvec.norm(dim=0)
    fmag = 0.5 * rand(*shape)
    fmag[rand(*shape) < 0.1] = 0.9999
    E[rand(*shape) < 0.1] = 2e-10
    F = nvec * fmag * c * E
    ke = 0.5 * rho * (v * v).sum(dim=0)
    U = torch.stack([rho, rho * v[0], rho * v[1], rho * v[2], Eint + ke, Eint,
                     E, F[0], F[1], F[2]])
    return U.float().contiguous()


# K4's edge shapes: extents of 4 and 5 (the periodic halo wraps around the
# transport's tile), extents that are not multiples of it (32 along, 16
# across)
K4_EDGE_SHAPES = ((4, 4, 4), (5, 5, 5), (37, 18, 33), (4, 35, 17))


def k4_edge_cases(opts, eos, problems: dict, dt: float, device,
                  seed: int = 5) -> Iterator[Case]:
    """Both K4 stage kernels on rough states (`rough_rad_state`) at
    K4_EDGE_SHAPES, for each of `problems` {name: problem} (opacity laws
    with and without a T exponent), PPM everywhere and PLM and donor cell on
    the third shape, against their plain versions (within NEWTON_REL of
    each component's max); stage 2 on stage 1's plain output."""
    import dataclasses

    rs = source.RAD_START
    for i, shape in enumerate(K4_EDGE_SHAPES):
        U = rough_rad_state(shape, seed + i, device, opts.c)
        dx = tuple(1.0 / n for n in shape)
        for order in ((1, 2, 3) if i == 2 else (3,)):
            o = dataclasses.replace(opts, reconstruction_order=order)
            for name, prob in problems.items():
                tag = f" {shape} order {order} {name}"
                args = (dt, o, eos, prob, dx)
                U1, div0 = substep.stage1_plain(U, None, *args)
                yield Case("rad_stage1", f"K4 stage 1{tag}",
                           lambda a=args, U=U: substep.fused_stage1(U, None, *a),
                           lambda a=args, U=U: substep.stage1_plain(U, None, *a), scaled=True)
                yield Case("rad_stage2", f"K4 stage 2{tag}",
                           lambda a=args, U=U, U1=U1, d0=div0:
                               substep.fused_stage2(U1, U[rs:], d0, None, *a),
                           lambda a=args, U=U, U1=U1, d0=div0:
                               substep.stage2_plain(U1, U[rs:], d0, None, *a), scaled=True)


# ------------------------------------------------------------- K5, batched
def k5_kept_counts(gas, rad, rad_src, keep, dt: float, stage: int, opts, eos,
                   problem):
    """(kept cells, the plain version's Newton and work-term counts over
    them alone) of the batched K5's inputs: the work this data needs."""
    U = torch.cat([gas, rad], dim=1).transpose(0, 1).reshape(gas.shape[1] + rad.shape[1], -1)
    src = None if rad_src is None else rad_src.reshape(-1)
    if keep is not None:
        k = keep.reshape(-1)
        U = U[:, k]
        src = None if src is None else src[k]
    n = U.shape[1]
    counts = {"newton_resid": 0, "newton_iters": 0, "outer_iters": 0}
    if n:
        source.source_update_plain(U.reshape(U.shape[0], n, 1, 1),
                                   None if src is None else src.reshape(n, 1, 1), dt, stage,
                                   opts, eos, problem, source.RAD_START, counts)
    return n, counts


def k5_batched_cost(gas, rad, rad_src=None, keep=None, n_kept: int | None = None,
                    counts: dict | None = None):
    """(bytes, FP32 operations) of the batched K5 over views `gas` [B, 6,
    ...] and `rad` [B, 4, ...]: both read once and written once (as many
    values), the source and the keep mask read once; OPS_COUPLING_CELL for
    each of the `n_kept` cells the Newton runs on (default: every cell) and
    the iterations `counts` holds (`k5_kept_counts`; default: none)."""
    n = gas[:, 0].numel() if n_kept is None else n_kept
    ops = coupling_ops(n, counts or {"newton_resid": 0, "newton_iters": 0,
                                     "outer_iters": 0})
    return 2 * _bytes_of(gas, rad) + _bytes_of(rad_src, keep), ops


def k5_batched_cases(gas, rad, rad_src, keep, dt: float, stage: int, opts, eos, problem,
                     tag: str = "", out=None) -> Iterator[Case]:
    """The batched K5 at one stage on views `gas`, `rad` (and `rad_src`,
    `keep`), writing into `out` when given, against its plain version
    (held within NEWTON_REL of each component's max)."""
    cost = k5_batched_cost(gas, rad, rad_src, keep,
                           *k5_kept_counts(gas, rad, rad_src, keep, dt, stage, opts, eos,
                                           problem))

    def run(fn, o):
        res = fn(gas, rad, rad_src, dt, stage, opts, eos, problem, source.RAD_START,
                 keep=keep, out=o)
        return torch.cat([res[0], res[1]], dim=1)

    yield Case("rad_source", f"K5 batched stage {stage}{tag}",
               lambda: run(source.source_update_batched, out),
               lambda: run(source.source_update_batched_plain, None),
               lambda: cost, scaled=True,
               run_timed=lambda: source.source_update_batched(
                   gas, rad, rad_src, dt, stage, opts, eos, problem, source.RAD_START,
                   keep=keep, out=out))
