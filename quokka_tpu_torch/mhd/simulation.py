"""The constrained-transport MHD simulation: deck, state, evolve loops.

Counterpart of `quokka_tpu.mhd.simulation`: the ParmParse deck,
`set_initial_conditions()` / `evolve()`, the CFL timestep, the conservation
audit with the magnetic energy, max |div B| and the FOM, for fully periodic
domains, where the solver runs ghost-free. The state lives on the `device`
the caller names, a CUDA device unless the caller asks for the CPU. On the
card every axis sweeps through kernel K8, which takes float32 and three
active axes: a float64 state or a problem with fewer active axes raises
there (run it with device="cpu"). `mhd.use_pallas` is read for the JAX
package's deck and changes nothing.

`evolve` has the JAX package's two loops. With `verbose = 0` it runs
windows of K steps (`mhd.fused_window`, rounded down to a power of two):
each step's CFL dt is computed on the device in float64 and a step whose dt
is not positive leaves the state as it was, so the host reads the window's
dts once instead of syncing every step. With `verbose = 1` it runs one step
at a time with the dt on the host. Both take the same dt sequence.

Unported: MHD plotfiles, checkpoints and restarts (the I/O slice), and a
domain decomposition (the multi-device slice); their deck keys or argument
raise NotImplementedError.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import ParmParse
from ..grid import Grid
from ..stencil import sh
from .advance import MHDOptions, advance_mhd_rk2, b_cell_from_faces, div_b, max_signal_mhd

# deck key -> predicate on its value that means "this unported feature is on"
_UNPORTED_KEYS = {
    "restartfile": lambda v: bool(str(v)),
    "plotfile_interval": lambda v: int(v) > 0,
    "checkpoint_interval": lambda v: int(v) > 0,
}


def faces_from_vector_potential(grid: Grid, A_fns, dtype=torch.float64) -> List[torch.Tensor]:
    """Staggered face B = discrete curl of an edge-registered vector
    potential: div B = 0 to roundoff by construction. CPU tensors.

    `A_fns` = (A_x, A_y, A_z) numpy callables of (x, y, z); entries may be
    None (zero component). A_k is evaluated at edges along k: coordinate k at
    cell centres, the other two at lo faces (index (i, j) = (i-1/2, j-1/2),
    the solver's edge registration)."""

    def coords_for_edge(k):
        out = []
        for d in range(3):
            n = grid.n_cell[d]
            lo, dx = grid.prob_lo[d], grid.dx[d]
            i = np.arange(n, dtype=np.float64)
            c = lo + (i + 0.5) * dx if d == k else lo + i * dx  # lo faces
            shape = [1, 1, 1]
            shape[d] = n
            out.append(c.reshape(shape))
        return out

    A = []
    for k in range(3):
        fn = A_fns[k]
        if fn is None:
            A.append(torch.zeros(grid.n_cell, dtype=dtype))
        else:
            vals = np.broadcast_to(np.asarray(fn(*coords_for_edge(k)), np.float64),
                                   grid.n_cell)
            A.append(torch.tensor(vals, dtype=dtype))

    dx = grid.dx
    Bf = []
    for d in range(3):
        d1 = (d + 1) % 3
        d2 = (d + 2) % 3
        Bf.append((sh(A[d2], 1, d1) - A[d2]) / dx[d1]
                  - (sh(A[d1], 1, d2) - A[d1]) / dx[d2])
    return Bf


class MHDSimulation:
    """Evolve an ideal-MHD problem on a fully periodic uniform grid."""

    def __init__(self, problem, pp: Optional[ParmParse] = None,
                 precision: str = "double", decomp=None, *, device="cuda"):
        self.problem = problem
        self.pp = pp = pp or ParmParse()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        if decomp is not None:
            raise NotImplementedError(
                "MHDSimulation(decomp=...): domain decomposition is not ported yet")
        for key, vals in pp.table.items():
            pred = _UNPORTED_KEYS.get(key)
            if pred is not None and pred(vals[0]):
                raise NotImplementedError(
                    f"deck key {key!r} = {vals}: MHD I/O is not ported to "
                    "quokka_tpu_torch yet")
        self.dtype = torch.float64 if precision == "double" else torch.float32

        n_cell = [int(v) for v in pp.get_list("amr.n_cell", [32, 1, 1])]
        while len(n_cell) < 3:
            n_cell.append(1)
        prob_lo = [float(v) for v in pp.get_list("geometry.prob_lo", [0.0, 0.0, 0.0])]
        prob_hi = [float(v) for v in pp.get_list("geometry.prob_hi", [1.0, 1.0, 1.0])]
        self.grid = Grid(tuple(n_cell), tuple(prob_lo), tuple(prob_hi))

        self.cfl = pp.get_float("cfl", 0.3)
        self.stop_time = pp.get_float("stop_time", 1.0)
        self.max_timesteps = pp.get_int("max_timesteps", 10**8)
        self.verbose = pp.get_int("verbose", 1)
        self.fused_window = pp.get_int("mhd.fused_window", 16)

        self.opts = MHDOptions(
            gamma=problem.gamma,
            dx=self.grid.dx,
            active_axes=self.grid.active_axes,
            reconstruction_order=pp.get_int("mhd.reconstruction_order", 2),
            density_floor=pp.get_float("density_floor", 0.0),
            pressure_floor=pp.get_float("pressure_floor", 0.0),
            use_pallas=bool(pp.get_int("mhd.use_pallas", 1)),
        )

        self.U: Optional[torch.Tensor] = None
        self.Bf: Optional[List[torch.Tensor]] = None
        self.t = 0.0
        self.istep = 0
        self.cell_updates = 0
        self.dts: List[float] = []  # every step's dt, in order
        self.zone_updates_per_second = 0.0
        self.elapsed_walltime = 0.0

    # ---------------------------------------------------------------- setup
    def set_initial_conditions(self):
        U, Bf = self.problem.set_initial_conditions_mhd(self.grid)
        self.U = torch.as_tensor(np.asarray(U), dtype=self.dtype).to(self.device).contiguous()
        self.Bf = [torch.as_tensor(np.asarray(b), dtype=self.dtype).to(self.device).contiguous()
                   for b in Bf]
        if tuple(self.U.shape) != (5, *self.grid.n_cell):
            raise ValueError(f"MHD IC shape {tuple(self.U.shape)} != (5, {self.grid.n_cell})")
        for d, b in enumerate(self.Bf):
            if tuple(b.shape) != self.grid.n_cell:
                raise ValueError(
                    f"face-B IC axis {d}: shape {tuple(b.shape)} != {self.grid.n_cell}")
        self.init_sums = self._sums()
        self.init_divb = self.max_divb()

    def _sums(self) -> np.ndarray:
        """[mass, 3 momenta, total energy, magnetic energy] x cell volume,
        summed in float64."""
        vol = self.grid.cell_volume()
        s = self.U.sum(dim=(1, 2, 3), dtype=torch.float64) * vol
        B_cc = b_cell_from_faces(self.Bf)
        emag = 0.5 * (B_cc * B_cc).sum(dtype=torch.float64) * vol
        return torch.cat([s, emag[None]]).cpu().numpy()

    @property
    def conservation_rel_err(self) -> np.ndarray:
        """(final - initial) / |initial| of `_sums`, per entry."""
        s0 = self.init_sums
        return (self._sums() - s0) / np.maximum(np.abs(s0), 1e-300)

    def max_divb(self) -> float:
        return float(torch.max(torch.abs(div_b(self.Bf, self.opts))))

    def divb_ulps(self) -> float:
        """max |div B| x the smallest dx, in ulps of the state's dtype at the
        largest |B| on a face. CT leaves div B at the roundoff of the face
        values, which this counts whatever the grid: every step rounds each
        face to the dtype, and a cell's divergence sums six faces over dx."""
        b_max = max(float(torch.max(torch.abs(b))) for b in self.Bf)
        if b_max == 0.0:
            return 0.0
        ulp = 2.0 ** math.floor(math.log2(b_max)) * torch.finfo(self.dtype).eps
        return self.max_divb() * self.grid.dx_min / ulp

    @property
    def B_cc(self) -> torch.Tensor:
        return b_cell_from_faces(self.Bf)

    # ---------------------------------------------------------------- evolve
    def _full(self, value, dtype):
        return torch.full((), value, dtype=dtype, device=self.device)

    def _window(self, K: int) -> int:
        """K steps with the CFL dt on the device (float64) and no host sync
        until the end, where the window's dts and t are read once. Returns
        the number of steps taken (dt > 0)."""
        opts, dt_type = self.opts, self.dtype
        cfl_dx = self._full(self.cfl * self.grid.dx_min, torch.float64)
        U, Bf = self.U, self.Bf
        t = self._full(self.t, torch.float64)
        dts = []
        for _ in range(K):
            sig = max_signal_mhd(U, Bf, opts)
            dt64 = torch.clamp(torch.minimum(cfl_dx / sig.double(), self.stop_time - t),
                               min=0.0)
            do = dt64 > 0.0
            U2, B2 = advance_mhd_rk2(U, Bf, dt64.to(dt_type), opts)
            U = torch.where(do, U2, U)
            Bf = [torch.where(do, b2, b) for b2, b in zip(B2, Bf)]
            t = t + dt64
            dts.append(dt64)
        vals = torch.stack(dts + [t]).tolist()
        steps = [dt for dt in vals[:-1] if dt > 0.0]
        if steps:
            self.U, self.Bf, self.t = U, Bf, vals[-1]
            self.istep += len(steps)
            self.cell_updates += len(steps) * self.grid.num_cells
            self.dts += steps
        return len(steps)

    def _host_step(self):
        sig = float(max_signal_mhd(self.U, self.Bf, self.opts))
        dt = self.cfl * self.grid.dx_min / sig
        dt = min(dt, self.stop_time - self.t)
        if self.verbose:
            print(f"MHD STEP {self.istep + 1} t = {self.t:.6e} dt = {dt:.6e}")
        self.U, self.Bf = advance_mhd_rk2(self.U, self.Bf, self._full(dt, self.dtype),
                                          self.opts)
        self.t += dt
        self.istep += 1
        self.cell_updates += self.grid.num_cells
        self.dts.append(dt)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def evolve(self):
        if self.U is None:
            self.set_initial_conditions()
        self._sync()
        t0 = time.perf_counter()
        updates0 = self.cell_updates
        while self.t < self.stop_time and self.istep < self.max_timesteps:
            K = min(self.fused_window, self.max_timesteps - self.istep)
            # a power of two, as the JAX package compiles one window per K
            # (the same K schedule gives the same dt sequence)
            K = 1 << (K.bit_length() - 1) if K > 0 else 0
            if K > 1 and not self.verbose:
                if self._window(K) == 0:
                    break
                continue
            self._host_step()
        self._sync()
        wall = time.perf_counter() - t0
        updates = self.cell_updates - updates0
        self.elapsed_walltime = wall
        self.zone_updates_per_second = updates / wall if wall > 0 and updates else 0.0
        if updates and self.verbose:
            us = wall / updates * 1e6
            print(f"Performance figure-of-merit: {us:.6f} μs/zone-update "
                  f"[={self.zone_updates_per_second / 1e6:.3f} Mupdates/s] "
                  f"on {self.device_name()}")
        self.final_divb = self.max_divb()
        if self.verbose:
            rel = self.conservation_rel_err
            for name, i in (("mass", 0), ("energy", 4)):
                print(f"\trelative {name} conservation error = {rel[i]:.3e}")
            print(f"\tmax |div B| = {self.final_divb:.3e} (initial {self.init_divb:.3e})")

    def device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return str(self.device)
