"""Hold each CUDA kernel against its plain PyTorch version on the same
device inputs, and time both (used by ``chip_smoke.py`` and the
cuda-marked tests).

Tolerance: per output component, |kernel - plain| <= rtol * |plain| +
ulps x (one ulp of the component's largest magnitude), with rtol 1e-5 and
64 ulps -- the bound the JAX package's tests hold its two hydro
formulations to (tests/test_fused_update.py). The kernels are built with
-fmad=false and IEEE division and square root, so they round like the
plain versions' separate ops, and in practice they agree to a few ulps.
Non-finite values must agree exactly.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, NamedTuple

import torch

from .hydro import euler, sweep

RTOL = 1e-5
ULPS = 64


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
        if not torch.equal(torch.isfinite(g), fin) or not torch.equal(g[~fin], r[~fin]):
            ok = False
            continue
        per_comp = r.dim() == 4 or (r.dim() == 3 and r.shape[0] == 6)  # state or hi plane
        comps = [(g[c], r[c], fin[c]) for c in range(r.shape[0])] if per_comp \
            else [(g, r, fin)]
        for gc, rc, fc in comps:
            gf, rf = gc[fc], rc[fc]
            if rf.numel() == 0:
                continue
            scale = rf.abs().max()
            ulp = torch.nextafter(scale, torch.tensor(float("inf"), device=scale.device)) - scale
            err = (gf - rf).abs()
            ok = ok and bool((err <= rtol * rf.abs() + ulps * ulp).all())
            max_abs = max(max_abs, float(err.max()))
            max_rel = max(max_rel, float((err / rf.abs().clamp_min(1e-30)).max()))
    return ok, max_abs, max_rel


def time_ms(fn: Callable[[], object], reps: int = 5) -> float:
    """Mean milliseconds per call on the current CUDA stream, after one
    warm-up call (CUDA events around `reps` calls)."""
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


class Case(NamedTuple):
    kernel: str  # key of sweep.launch_counts
    label: str
    run_kernel: Callable[[], object]
    run_plain: Callable[[], object]


def cases(U: torch.Tensor, U2: torch.Tensor, opts, bc_kinds: dict,
          dt: float) -> Iterator[Case]:
    """The kernels at the shapes of the main path: K1 on the conserved
    state; K2 stage 1 (walls + divergence), stage 2 (time average with
    stage 1's faces) and first order, per axis; K3 on stage 1's
    divergences. K2 and K3 take inputs from the plain versions, so each
    kernel is compared on identical inputs."""
    yield Case("transverse", "K1 all axes",
               lambda: sweep.precompute_transverse(U, opts, bc_kinds, True)[:2],
               lambda: sweep.precompute_transverse_plain(U, opts, bc_kinds, True)[:2])
    dmins, chi, _ = sweep.precompute_transverse_plain(U, opts, bc_kinds, True)
    dmins2, chi2, _ = sweep.precompute_transverse_plain(U2, opts, bc_kinds, True)
    prim = euler.cons_to_prim(U, opts.eos, opts.reconstruct_eint)
    divs, dvels = {}, {}
    for d in opts.active_axes:
        s1 = dict(bc_axis=bc_kinds.get(d), dx_axis=opts.dx[d], state_is_cons=True)
        yield Case("axis_flux", f"K2 stage 1 axis {d}",
                   lambda d=d, kw=s1: sweep.compute_axis_flux(U, d, opts, chi, dmins, **kw),
                   lambda d=d, kw=s1: sweep.axis_flux_plain(U, d, opts, chi, dmins, **kw))
        res = sweep.axis_flux_plain(U, d, opts, chi, dmins, **s1)
        divs[d], dvels[d] = res[-2], res[-1]
        s2 = dict(s1, avg_with=res[:-2])
        yield Case("axis_flux", f"K2 stage 2 avg axis {d}",
                   lambda d=d, kw=s2: sweep.compute_axis_flux(U2, d, opts, chi2, dmins2, **kw),
                   lambda d=d, kw=s2: sweep.axis_flux_plain(U2, d, opts, chi2, dmins2, **kw))
        fo = dict(first_order=True, bc_axis=bc_kinds.get(d))
        yield Case("axis_flux", f"K2 first order axis {d}",
                   lambda d=d, kw=fo: sweep.compute_axis_flux(prim, d, opts, None, {}, **kw),
                   lambda d=d, kw=fo: sweep.axis_flux_plain(prim, d, opts, None, {}, **kw))
    yield Case("apply_update", "K3",
               lambda: sweep.apply_update(U, U, divs, dvels, dt, opts),
               lambda: sweep.apply_update_plain(U, U, divs, dvels, dt, opts))
