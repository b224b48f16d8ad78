// K2: one hydro sweep along one axis -- face fluxes, face velocities and
// their divergence.
//
// Replaces quokka_tpu/hydro/pallas_sweep.py::compute_axis_flux_pallas (the
// pallas_call at :1148, body _sweep_body :314) for the variants the unigrid
// main paths run: wall or periodic axes, the divergence outputs
// (dx_axis), the stage-2 time average (avg_with), conserved input
// (state_is_cons), the first-order FOFC fluxes (donor cell + LLF), and the
// lean div-only sweep (K2c, below).
//
// Walls (`lo`, `hi`: common.cuh BC_*): a reflecting side mirrors the cells
// and flips the normal momentum, an outflow side copies the edge cell
// (map_cell), the two kinds freely mixed on one axis (reflect lo, outflow
// hi). On an outflow side chi_cell's wall-adjacent ghost (cell -1 or n) is
// read from K1's exact plane `chi_glo` / `chi_ghi` (pallas_sweep.py:828-843,
// :963-970; common.cuh load_chi), its other ghosts copy the edge cell, as
// do the dmin ghosts (:972-974); every K2 variant stages its cells through
// `stage_prims` and `reconstruct_cells`, so each takes them at once. The hi
// wall's face (slot n) goes to flux_hi / vel_hi on either kind, and the
// FOFC mask counts every wall ghost unflagged.
//
// face kernel (`face_tile_kernel`): a thread block owns a tile of `ta`
//   faces along the axis by `tw` lines across it (the lines run along z,
//   the contiguous axis, for the x and y sweeps and along y for the z
//   sweep; the third coordinate is fixed), and stages the cells the tile
//   reads in shared memory in three phases separated by __syncthreads:
//     1. load each of the ta + 5 cells a line needs (3 below the first
//        face, 2 above the last) once, through the wall index map
//        (common.cuh: periodic wrap, or the mirrored cell with its normal
//        momentum flipped), neighbouring threads on neighbouring
//        addresses, and convert it to primitives (state_is_cons) once;
//     2. reconstruct each of the ta + 1 cells the faces touch once: PPM
//        (ppm_cell) per component gives both its face states, blended with
//        the cell's chi; the cell's two dmin values are staged beside them;
//     3. each face builds its two states, qL = plus(f-1) and qR = minus(f),
//        and solves HLLC once with the carbuncle dw (CW84 viscosity when
//        K_visc > 0); F (state component order) and the face velocity are
//        written coalesced.
//   Face slot f lies between cells f-1 and f; on a wall axis slot n (the hi
//   wall) goes to the separate flux_hi / vel_hi planes. The expressions and
//   their order of operations are those of the one-thread-a-face form the
//   tile replaced, which computed each cell's primitives six times
//   and its reconstruction twice; with -fmad=false the fluxes are the same
//   bits (kernel_times.py --compare). Phases 1 and 2 are `stage_prims` and
//   `reconstruct_cells`, which K2c's tile shares.
//   `hydro.sweep._face_tile` picks (ta, tw) for the axis's face count and
//   line count: up to 40 faces along, up to 512 faces a tile, ~40 KB of
//   shared memory. __launch_bounds__(256, 4) holds a thread to 64
//   registers without spills, so four blocks (32 warps) fit a
//   multiprocessor; uncapped, the z sweep took 72 and ran 12% slower.
// first-order face kernel (`fo_face_kernel`): one thread per face, z
//   fastest, reads cells f-1 and f and solves LLF (the FOFC fallback
//   fluxes); no stencil is shared enough for a tile to pay.
// sweep kernel (`sweep_tile_kernel`, every sweep with dx_axis that is not
//   K2c): K2c's tile below (phases 1-3: each face its cells touch solved
//   once into shared memory), whose phase 3 also
//     - stage 1 (mode 1): writes the faces the tile owns to global memory,
//       coalesced as the face kernel writes them (slots a0 .. a0+ta-1, and
//       on a wall axis the hi-wall plane from the line's last tile); the
//       caller needs them, since the FOFC fallback re-blends them;
//     - stage 2 (mode 2, avg_with): reads stage 1's face at each slot (the
//       hi-wall plane F1_hi / v1_hi for slot n on a wall axis, slot 0 for
//       slot n on a periodic one) and averages in shared memory,
//       0.5 * (F1 + F2), and 0.5 * (v1 + v2) where v1 is given; no stage-2
//       face reaches global memory;
//   and phase 4, one thread a cell, writes div = (F(i) - F(i+1)) / dx and
//   dvel = (v(i+1) - v(i)) / dx from the faces in shared memory. The
//   expressions and their operand order are those of the one-thread-a-cell
//   divergence kernel that read the faces back from global memory, so the
//   outputs keep its bits (kernel_times.py --compare). `hydro.sweep.
//   sweep_tile` picks the tile: K2c's for the z sweep, whose faces run
//   along z, the contiguous axis; for the x and y sweeps, which store or
//   read a face row per tile line along z, 29 cells by 16 lines (rows of
//   64 B; 54.7 KB, four blocks a multiprocessor). Measured on the H100
//   (kernel_times.py --tiles --only k2s): a stage-1 x sweep at 256^3 takes
//   1.19 ms on 29 x 16, 1.29 on 37 x 12, 1.54 on K2c's 37 x 13, whose
//   52 B rows straddle sectors.
//
// K2d (emit_avg_flux, the AMR flux-register variant,
// pallas_sweep.py:743-746 and :1066-1085): mode 2 on a ghost-padded
// periodic array, which also writes the time-averaged face flux
// 0.5 * (F1 + F2) of each cell's lo face (phase 4) and takes no stage-1
// face velocity: dvel stays the RAW stage-2 velocity divergence, which the
// caller averages with stage 1's (hydro/advance.py). The padded array
// wraps in index space, as the JAX in-block rolls do; the wrap reaches
// ghost faces only. Its bytes at the dense shell's 520^3: the state, chi
// and two dmin fields read (9 rows), stage 1's faces read (6 rows), div,
// dvel and favg written (13 rows), 15.7 GB an axis, 4.7 ms.
//
// K2c (div_only, the lean large-domain step, pallas_sweep.py:695-718,
// :786-810, :924-1009, the blend of _window_flux :543-561): one kernel,
// `lean_tile_kernel`, that writes no face array to global memory. It takes
// the face kernel's tile of `ta` cells by `tw` lines (`hydro.sweep.
// lean_tile`: up to 40 cells along, up to 512 faces a tile) and its phases
// 1-2, then
//   3. solves each of the ta + 1 faces its cells touch once, into shared
//      memory (7 floats a face: the flux in state order and the face
//      velocity; only the tile's hi face is solved again, by the next
//      tile). A face next to a flagged cell of the FOFC mask (cells f-1 or
//      f; wall ghosts unflagged) takes the first-order donor-cell + LLF
//      flux instead, from `fo` in global memory or, without it, from the
//      staged primitives; first_order takes LLF at every face and skips
//      phase 2;
//   4. one thread a cell writes div = (F_lo - F_hi) / dx and dvel = (v_hi -
//      v_lo) / dx, or adds them onto the accumulators in place (acc, the
//      JAX kernel's aliased outputs: each cell is read and written by the
//      one thread that owns it, nothing of them is staged).
// Every global offset is 64-bit, so every extent the one-thread-a-cell
// form took is taken. Its bound at 512^3 is bytes, at 3.35 TB/s with one
// f32 row 0.537 GB: a clean first axis reads U, chi and two dmin fields (9
// rows) and writes div and dvel (7 rows), 8.6 GB, 2.6 ms; with acc it reads
// the 7 accumulator rows too, 12.3 GB, 3.7 ms; fo_mask adds one row and
// fo_from six (kernel_check.lean_cases computes each launch's bytes from
// its inputs). The FP32 work, one HLLC a face and one PPM a cell
// (OPS_K2_SWEEP, 620 a cell), is 1.24 ms at 67 TFLOP/s. The form this
// replaces, one thread a cell solving both of its faces, did every HLLC
// twice, converted each cell to primitives 12 times and reconstructed it 4
// times an axis; the tile does each once, at the face kernel's cost
// (latency-bound IEEE divisions and square roots, PERF.md), plus a 28 B
// shared-memory round trip a face. Bits: qL = plus(f-1), qR = minus(f) and
// the same expressions in the same order, so the outputs are the
// per-cell form's bits (kernel_times.py --compare).
//
// K2e (corr_mask / corr_acc, the AMR root's in-kernel flux-register seed,
// pallas_sweep.py:811-880, corr formula :623-633 and :1085-1090, output
// alias :1146-1147): phase 4 of the lean kernel also writes
//   corr[c] (+)= (m_lo F_lo - m_hi F_hi) / dx,
// m the per-axis coarse-fine boundary-face mask (slot f = the lo face of
// cell f, as the JAX kernel's bnd_blk), from the very blended faces in
// shared memory that feed div, so the register stays consistent with the
// update in every FOFC branch; with corr_accumulate the thread adds onto its own cell of the
// accumulator in place (the aliased output). Ghost-free periodic axes only,
// as the JAX kernel refuses walls (:811-814). Its bound is bytes: one more
// [X, Y, Z] mask row read and six corr rows written (and read with the
// accumulator), on top of K2c's traffic; the arithmetic adds 12 selects
// and 6 divisions a cell.
//
// Batched face kernel: the packed AMR engine sweeps a chunk of ghost-padded
// tile blocks [B, 6, X, Y, Z] at once (the JAX package vmaps its flux
// function over them); blockIdx.y picks the block, so a chunk is one launch
// an axis, not one a tile. Periodic (padded, roll semantics) blocks only.
//
// Why K2's stage 1 writes its faces to global memory and nothing else
// does: the stage-1 caller needs them (the FOFC fallback re-blends them,
// and stage 2 averages with them); stage 2, K2d and K2c keep theirs in the
// tile's shared memory.
//
// Bound on the H100: bytes on paper. A stage-1 sweep reads its cell's 6
// values, chi and two dmin fields once and writes 7 face floats and 7
// divergence floats, 92 B a cell, against roughly 620 FP32 operations
// counted once (kernel_check.OPS_K2_SWEEP): at 256^3 1.54 GB, >= 0.46 ms
// at 3.35 TB/s. In practice instruction issue bounds it: each face solve has
// ~10 IEEE divisions and 6 square roots, which are instruction sequences,
// and -fmad=false keeps every product and sum apart. The tile does one
// HLLC a face and one PPM a cell, plus a 28 B shared-memory round trip a
// face; the two-launch form this replaces also wrote every face to global
// memory and read it back (twice: once as a cell's lo face, once as its
// neighbour's hi face), stage 2's and K2d's included.
#include "common.cuh"

namespace qk {

struct Face {
  float rho, rinv, u, v, w, P, cs, E, Eint;
};

__device__ __forceinline__ Face face_state(const float q[NV], int axis,
                                           int vax, int wax, const Eos& e) {
  Face s;
  s.rho = q[0];
  s.rinv = 1.0f / s.rho;
  s.u = q[1 + axis];
  s.v = q[1 + vax];
  s.w = q[1 + wax];
  const float ke = (0.5f * s.rho) * ((s.u * s.u + s.v * s.v) + s.w * s.w);
  if (e.reconstruct_eint) {
    s.P = e.gm1 * (q[4] * s.rho);
    s.Eint = s.rho * q[5];
  } else {
    s.P = q[4];
    s.Eint = q[5];
  }
  s.cs = sqrtf((e.gamma * s.P) * s.rinv);
  s.E = s.P / e.gm1 + ke;
  return s;
}

__device__ __forceinline__ void cons_flux(const Face& s, float U[NV],
                                          float F[NV]) {
  U[0] = s.rho;
  U[1] = s.rho * s.u;
  U[2] = s.rho * s.v;
  U[3] = s.rho * s.w;
  U[4] = s.E;
  U[5] = s.Eint;
#pragma unroll
  for (int c = 0; c < NV; ++c) F[c] = s.u * U[c];
  F[1] = F[1] + s.P;
  F[4] = F[4] + s.P * s.u;
}

__device__ __forceinline__ void llf(const Face& L, const Face& R,
                                    float out[NV]) {
  float UL[NV], FL[NV], UR[NV], FR[NV];
  cons_flux(L, UL, FL);
  cons_flux(R, UR, FR);
  const float sp = mx(fabsf(L.u) + L.cs, fabsf(R.u) + R.cs);
#pragma unroll
  for (int c = 0; c < NV; ++c)
    out[c] = 0.5f * (FL[c] + FR[c]) - (0.5f * sp) * (UR[c] - UL[c]);
}

__device__ __forceinline__ void hllc(const Face& L, const Face& R, float du,
                                     float dw, const Eos& e, float out[NV]) {
  const float wl = sqrtf(L.rho);
  const float wr = sqrtf(R.rho);
  const float norm = 1.0f / (wl + wr);
  const float u_t = (wl * L.u + wr * R.u) * norm;
  const float v_t = (wl * L.v + wr * R.v) * norm;
  const float w_t = (wl * L.w + wr * R.w) * norm;
  const float vsq_t = (u_t * u_t + v_t * v_t) + w_t * w_t;
  const float H_L = (L.E + L.P) * L.rinv;
  const float H_R = (R.E + R.P) * R.rinv;
  const float H_t = (wl * H_L + wr * H_R) * norm;
  const float dU = L.u - R.u;

  float cs_t, s_n;
  if (e.gamma != 1.0f) {
    const float dedr_L = (-L.P * e.inv_gm1) * (L.rinv * L.rinv);
    const float dedr_R = (-R.P * e.inv_gm1) * (R.rinv * R.rinv);
    const float dedp_L = e.inv_gm1 * L.rinv;
    const float dedp_R = e.inv_gm1 * R.rinv;
    const float drdp_L = L.rho / L.P;
    const float drdp_R = R.rho / R.P;
    const float e_L = L.Eint * L.rinv;
    const float e_R = R.Eint * R.rinv;
    const float C_rho =
        0.5f * (((e_L + e_R) + L.rho * dedr_L) + R.rho * dedr_R);
    const float C_P = 0.5f * (((e_L * drdp_L + e_R * drdp_R) + L.rho * dedp_L) +
                              R.rho * dedp_R);
    const float cs_exp = (H_t - 0.5f * vsq_t) - C_rho;
    const float cs_avg = 0.5f * (L.cs + R.cs);
    cs_t = cs_exp > 0.0f ? sqrtf(fabsf(cs_exp) / C_P) : cs_avg;
    s_n = e.s_n * mx(dU, 0.0f);
  } else {
    cs_t = 0.5f * (L.cs + R.cs);
    s_n = 0.5f * mx(dU, 0.0f);
  }

  // Batten et al. 1997 wavespeed bounds
  const float S_L = mn(L.u - (L.cs + s_n), u_t - (cs_t + s_n));
  const float S_R = mx(R.u + (R.cs + s_n), u_t + (cs_t + s_n));

  // carbuncle correction [Minoshima & Miyoshi 2021, eq. 10]
  const float cs_max = mx(L.cs, R.cs);
  const float tp =
      mn(1.0f, (cs_max - mn(du, 0.0f)) / (cs_max - mn(dw, 0.0f)));
  const float tp2 = tp * tp;
  const float theta = tp2 * tp2;

  const float denom = L.rho * (S_L - L.u) - R.rho * (S_R - R.u);
  const float S_star = (theta * (R.P - L.P) + ((L.rho * L.u) * (S_L - L.u) -
                                               (R.rho * R.u) * (S_R - R.u))) /
                       denom;

  // low-dissipation pressure correction phi [M&M 2021, eq. 23]
  const float vsq_L = (L.u * L.u + L.v * L.v) + L.w * L.w;
  const float vsq_R = (R.u * R.u + R.v * R.v) + R.w * R.w;
  const float chi = mn(1.0f, sqrtf(mx(vsq_L, vsq_R)) / cs_max);
  const float phi = chi * (2.0f - chi);
  const float P_LR =
      0.5f * (L.P + R.P) + (0.5f * phi) * ((L.rho * (S_L - L.u)) * (S_star - L.u) +
                                           (R.rho * (S_R - R.u)) * (S_star - R.u));

  float UL[NV], FL[NV], UR[NV], FR[NV];
  cons_flux(L, UL, FL);
  cons_flux(R, UR, FR);
  const float coef_L = 1.0f / (S_L - S_star);
  const float coef_R = 1.0f / (S_R - S_star);
  const bool in_L = S_L > 0.0f;
  const bool in_sL = S_star > 0.0f;
  const bool in_sR = S_R >= 0.0f;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    float fsl = (S_star * (S_L * UL[c] - FL[c])) * coef_L;
    float fsr = (S_star * (S_R * UR[c] - FR[c])) * coef_R;
    if (c == 1) {
      fsl = fsl + (S_L * P_LR) * coef_L;
      fsr = fsr + (S_R * P_LR) * coef_R;
    } else if (c == 4) {
      fsl = fsl + ((S_L * P_LR) * S_star) * coef_L;
      fsr = fsr + ((S_R * P_LR) * S_star) * coef_R;
    }
    out[c] = in_L ? FL[c] : (in_sL ? fsl : (in_sR ? fsr : FR[c]));
  }
}

// Canonical-frame flux `out` -> state component order, and the face
// velocity from the upwind side's 1/rho.
template <int axis>
__device__ __forceinline__ void state_order(const float out[NV], float rinv_L,
                                            float rinv_R, float Fs[NV],
                                            float& fv) {
  constexpr int vax = axis == 0 ? 1 : (axis == 1 ? 2 : 0);
  constexpr int wax = axis == 0 ? 2 : (axis == 1 ? 0 : 1);
  Fs[0] = out[0];
  Fs[1 + axis] = out[1];
  Fs[1 + vax] = out[2];
  Fs[1 + wax] = out[3];
  Fs[4] = out[4];
  Fs[5] = out[5];
  fv = Fs[0] * (Fs[0] >= 0.0f ? rinv_R : rinv_L);
}

// LLF between the donor-cell primitive states qL (cell f-1) and qR (cell
// f), in state component order.
template <int axis>
__device__ __forceinline__ void llf_states(const float qL[NV], const float qR[NV],
                                           const Eos& e, float Fs[NV], float& fv) {
  constexpr int vax = axis == 0 ? 1 : (axis == 1 ? 2 : 0);
  constexpr int wax = axis == 0 ? 2 : (axis == 1 ? 0 : 1);
  float out[NV];
  const Face L = face_state(qL, axis, vax, wax, e);
  const Face R = face_state(qR, axis, vax, wax, e);
  llf(L, R, out);
  state_order<axis>(out, L.rinv, R.rinv, Fs, fv);
}

// The first-order face f: donor-cell states of cells f-1 and f (through
// the wall map) and LLF, in state component order.
template <int axis>
__device__ __forceinline__ void llf_face(const float* __restrict__ Q,
                                         int64_t ncell, int64_t base,
                                         int64_t stride, int64_t f, int64_t n,
                                         int lo, int hi, int is_cons,
                                         const Eos& e, float Fs[NV],
                                         float& fv) {
  float qL[NV], qR[NV];
  load_prim(Q, ncell, base, stride, f - 1, n, lo, hi, axis, is_cons, e, qL);
  load_prim(Q, ncell, base, stride, f, n, lo, hi, axis, is_cons, e, qR);
  llf_states<axis>(qL, qR, e, Fs, fv);
}

// HLLC at one face from its reconstructed states qL, qR (primitives), the
// normal velocity jump du of the two cells, and their dmin values along
// the transverse axes (has_v / has_w: the field exists), with the CW84
// viscosity when K_visc > 0; in state component order.
template <int axis>
__device__ __forceinline__ void hllc_face(const float qL[NV],
                                          const float qR[NV], float du,
                                          bool has_v, float dvl, float dvr,
                                          bool has_w, float dwl, float dwr,
                                          float K_visc, const Eos& e,
                                          float Fs[NV], float& fv) {
  constexpr int vax = axis == 0 ? 1 : (axis == 1 ? 2 : 0);
  constexpr int wax = axis == 0 ? 2 : (axis == 1 ? 0 : 1);
  float out[NV];
  const Face L = face_state(qL, axis, vax, wax, e);
  const Face R = face_state(qR, axis, vax, wax, e);
  float dw = 0.0f;
  if (has_v) dw = mn(dvl, dvr);
  if (has_w) {
    const float m2 = mn(dwl, dwr);
    dw = has_v ? mn(dw, m2) : m2;
  }
  hllc(L, R, du, dw, e, out);
  if (K_visc > 0.0f) {
    float div_v = du;
    if (has_v) div_v = div_v + 0.5f * (dvl + dvr);
    if (has_w) div_v = div_v + 0.5f * (dwl + dwr);
    const float visc = K_visc * mx(-div_v, 0.0f);
    float UL[NV], FL[NV], UR[NV], FR[NV];
    cons_flux(L, UL, FL);
    cons_flux(R, UR, FR);
#pragma unroll
    for (int c = 0; c < NV; ++c) out[c] = out[c] + visc * (UL[c] - UR[c]);
  }
  state_order<axis>(out, L.rinv, R.rinv, Fs, fv);
}

// Where face slot f of the line at (fixed, across) goes: the face arrays
// [6, X, Y, Z] / [X, Y, Z] below n, the hi-wall planes [6, plane] /
// [plane] at f = n (the plane over the two other axes in order: its offset
// is fixed * n_across + across for every axis).
__device__ __forceinline__ void store_face(
    float* __restrict__ F, float* __restrict__ vel, float* __restrict__ F_hi,
    float* __restrict__ vel_hi, int64_t ncell, int64_t nplane, int64_t off,
    int64_t poff, bool on_plane, const float Fs[NV], float fv) {
  if (!on_plane) {
#pragma unroll
    for (int c = 0; c < NV; ++c) F[c * ncell + off] = Fs[c];
    vel[off] = fv;
  } else {
#pragma unroll
    for (int c = 0; c < NV; ++c) F_hi[c * nplane + poff] = Fs[c];
    vel_hi[poff] = fv;
  }
}

constexpr int FACE_THREADS = 256;

// The geometry of one tile of the face kernels and of the cell tiles (K2c
// and K2's sweeps with a divergence): the axis, the lines across it and the
// fixed third coordinate, and this block's tile of `count` slots along the
// axis (faces of the face kernel, cells of the cell tiles). Offsets are of
// type I: int for the face kernel (the wrapper holds a block below 2^31
// cells), int64_t for the cell tiles.
template <typename I>
struct Tile {
  I n, n_across, stride_a, stride_c, stride_f, fixed, base;
  int a0, c0, count, lines;
  int64_t nplane;
};

template <int axis, typename I>
__device__ __forceinline__ Tile<I> tile_of(I X, I Y, I Z, I along, int ta, int tw) {
  Tile<I> t;
  t.n = axis == 0 ? X : (axis == 1 ? Y : Z);
  t.n_across = axis == 2 ? Y : Z;
  t.stride_a = axis == 0 ? Y * Z : (axis == 1 ? Z : 1);
  t.stride_c = axis == 2 ? Z : 1;
  t.stride_f = axis == 1 ? Y * Z : (axis == 0 ? Z : Y * Z);
  t.nplane = axis == 0 ? (int64_t)Y * Z : (axis == 1 ? (int64_t)X * Z : (int64_t)X * Y);
  const I tiles_a = (along + ta - 1) / ta;
  const I tiles_c = (t.n_across + tw - 1) / tw;
  I b = blockIdx.x;
  const I tA = b % tiles_a;
  b /= tiles_a;
  const I tC = b % tiles_c;
  t.fixed = b / tiles_c;
  t.a0 = (int)(tA * ta);
  t.c0 = (int)(tC * tw);
  t.count = (int)min((I)ta, along - t.a0);
  t.lines = (int)min((I)tw, t.n_across - t.c0);
  t.base = t.fixed * t.stride_f + t.c0 * t.stride_c;
  return t;
}

// Phase 1 of a tile with `nfaces` faces a line (slots a0 .. a0+nfaces-1):
// the primitives of the nfaces + 5 cells a line they read (a0-3 ..
// a0+nfaces+1) into prim_s [NV][cap_s], each loaded once through the wall
// index map and converted once.
template <int axis, typename I>
__device__ __forceinline__ void stage_prims(const Tile<I>& t, int nfaces,
                                            const float* __restrict__ Q, int64_t ncell,
                                            int lo, int hi, int is_cons, const Eos& e,
                                            float* prim_s, int cap_s) {
  const int ns = nfaces + 5;
  for (int el = threadIdx.x; el < ns * t.lines; el += FACE_THREADS) {
    int j, i;
    tpos<axis>(el, ns, t.lines, j, i);
    float q[NV];
    load_prim(Q, ncell, t.base + i * t.stride_c, t.stride_a, t.a0 - 3 + j, t.n, lo,
              hi, axis, is_cons, e, q);
    const int s = tix<axis>(j, i, ns, t.lines);
#pragma unroll
    for (int c = 0; c < NV; ++c) prim_s[c * cap_s + s] = q[c];
  }
}

// Phase 2: the chi-blended PPM face states (minus, plus) of the nfaces + 1
// cells the faces touch (a0-1 .. a0+nfaces-1), each reconstructed once,
// into qm_s / qp_s [NV][cap_r], and their dmin values into dv_s / dw_s.
// chi_glo / chi_ghi: the outflow sides' wall-adjacent chi planes
// (common.cuh: load_chi), or nullptr.
template <int axis, typename I>
__device__ __forceinline__ void reconstruct_cells(
    const Tile<I>& t, int nfaces, const float* __restrict__ chi,
    const float* __restrict__ chi_glo, const float* __restrict__ chi_ghi,
    const float* __restrict__ dminv, const float* __restrict__ dminw, int lo, int hi,
    const float* prim_s, int cap_s, float* qm_s, float* qp_s, float* dv_s, float* dw_s,
    int cap_r) {
  const int ns = nfaces + 5, nr = nfaces + 1;
  for (int el = threadIdx.x; el < nr * t.lines; el += FACE_THREADS) {
    int r, i;
    tpos<axis>(el, nr, t.lines, r, i);
    const int64_t lbase = t.base + i * t.stride_c;
    const int64_t a = t.a0 - 1 + r;
    const int o = tix<axis>(r, i, nr, t.lines);
    const int s = tix<axis>(r + 2, i, ns, t.lines);
    const int sa = axis == 2 ? 1 : t.lines;  // staged neighbour along the axis
    float chi_c = 1.0f;
    if (chi != nullptr)
      chi_c = load_chi(chi, chi_glo, chi_ghi, lbase, t.stride_a,
                       (int64_t)t.fixed * t.n_across + t.c0 + i, a, t.n, lo, hi);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const float* w = prim_s + c * cap_s + s;
      float minus, plus;
      ppm_cell(w[-2 * sa], w[-sa], w[0], w[sa], w[2 * sa], minus, plus);
      if (chi != nullptr) {
        plus = chi_c * plus + (1.0f - chi_c) * w[0];
        minus = chi_c * minus + (1.0f - chi_c) * w[0];
      }
      qm_s[c * cap_r + o] = minus;
      qp_s[c * cap_r + o] = plus;
    }
    if (dminv != nullptr) dv_s[o] = load_field(dminv, lbase, t.stride_a, a, t.n, lo, hi);
    if (dminw != nullptr) dw_s[o] = load_field(dminw, lbase, t.stride_a, a, t.n, lo, hi);
  }
}

// Phase 3 at face fa of line i (between reconstructed cells fa and fa+1,
// staged fa+2 and fa+3): HLLC from qL = plus(f-1), qR = minus(f).
template <int axis>
__device__ __forceinline__ void tile_hllc(int fa, int i, int nfaces, int lines,
                                          const float* prim_s, int cap_s,
                                          const float* qm_s, const float* qp_s,
                                          const float* dv_s, const float* dw_s, int cap_r,
                                          bool has_v, bool has_w, float K_visc,
                                          const Eos& e, float Fs[NV], float& fv) {
  const int ns = nfaces + 5, nr = nfaces + 1;
  const int oL = tix<axis>(fa, i, nr, lines);
  const int oR = tix<axis>(fa + 1, i, nr, lines);
  const int sL = tix<axis>(fa + 2, i, ns, lines);
  const int sR = tix<axis>(fa + 3, i, ns, lines);
  float qL[NV], qR[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    qL[c] = qp_s[c * cap_r + oL];
    qR[c] = qm_s[c * cap_r + oR];
  }
  const float du = prim_s[(1 + axis) * cap_s + sR] - prim_s[(1 + axis) * cap_s + sL];
  hllc_face<axis>(qL, qR, du, has_v, has_v ? dv_s[oL] : 0.0f, has_v ? dv_s[oR] : 0.0f,
                  has_w, has_w ? dw_s[oL] : 0.0f, has_w ? dw_s[oR] : 0.0f, K_visc, e, Fs,
                  fv);
}

// The PPM face kernel, a shared-memory tile (see the header). Blocks of a
// batch [B, 6, X, Y, Z] are blockIdx.y; offsets inside one component of one
// block are 32-bit (the wrapper holds X Y Z below 2^31).
template <int axis>
__global__ void __launch_bounds__(FACE_THREADS, 4) face_tile_kernel(
    const float* __restrict__ Q, const float* __restrict__ chi,
    const float* __restrict__ chi_glo, const float* __restrict__ chi_ghi,
    const float* __restrict__ dminv, const float* __restrict__ dminw,
    float* __restrict__ F, float* __restrict__ vel, float* __restrict__ F_hi,
    float* __restrict__ vel_hi, int X, int Y, int Z, int lo, int hi,
    int is_cons, float K_visc, int ta, int tw, Eos e) {
  extern __shared__ float smem[];
  const int64_t ncell = (int64_t)X * Y * Z;
  {  // batch index: block b of a [B, 6, X, Y, Z] chunk (B = 1 unbatched)
    const int64_t b = blockIdx.y;
    Q += b * NV * ncell;
    F += b * NV * ncell;
    vel += b * ncell;
    if (chi != nullptr) chi += b * ncell;
    if (dminv != nullptr) dminv += b * ncell;
    if (dminw != nullptr) dminw += b * ncell;
  }
  const int n = axis == 0 ? X : (axis == 1 ? Y : Z);
  const Tile<int> t = tile_of<axis, int>(X, Y, Z, lo != BC_PERIODIC ? n + 1 : n, ta, tw);
  const int cap_s = (ta + 5) * tw, cap_r = (ta + 1) * tw;
  float* prim_s = smem;                  // [NV][cap_s]
  float* qm_s = prim_s + NV * cap_s;     // [NV][cap_r] blended minus states
  float* qp_s = qm_s + NV * cap_r;       // [NV][cap_r] blended plus states
  float* dv_s = qp_s + NV * cap_r;       // [cap_r]
  float* dw_s = dv_s + cap_r;            // [cap_r]

  stage_prims<axis>(t, t.count, Q, ncell, lo, hi, is_cons, e, prim_s, cap_s);
  __syncthreads();
  reconstruct_cells<axis, int>(t, t.count, chi, chi_glo, chi_ghi, dminv, dminw, lo,
                                        hi, prim_s, cap_s, qm_s, qp_s, dv_s, dw_s, cap_r);
  __syncthreads();

  // 3. HLLC at faces a0 .. a0+faces-1
  for (int el = threadIdx.x; el < t.count * t.lines; el += FACE_THREADS) {
    int fa, i;
    tpos<axis>(el, t.count, t.lines, fa, i);
    float Fs[NV], fv;
    tile_hllc<axis>(fa, i, t.count, t.lines, prim_s, cap_s, qm_s, qp_s, dv_s, dw_s, cap_r,
                    dminv != nullptr, dminw != nullptr, K_visc, e, Fs, fv);
    const int f = t.a0 + fa;
    const int across = t.c0 + i;
    store_face(F, vel, F_hi, vel_hi, ncell, t.nplane,
               t.base + (int64_t)f * t.stride_a + i * t.stride_c,
               (int64_t)t.fixed * t.n_across + across, f == t.n, Fs, fv);
  }
}

// The first-order face kernel: one thread per (face, transverse position),
// z fastest, over ext = (X, Y, Z) with the axis extent n + 1 on a wall axis.
template <int axis>
__global__ void __launch_bounds__(FACE_THREADS) fo_face_kernel(
    const float* __restrict__ Q, float* __restrict__ F, float* __restrict__ vel,
    float* __restrict__ F_hi, float* __restrict__ vel_hi, int64_t X, int64_t Y,
    int64_t Z, int lo, int hi, int is_cons, Eos e) {
  const int64_t ncell = X * Y * Z;
  {
    const int64_t b = blockIdx.y;
    Q += b * NV * ncell;
    F += b * NV * ncell;
    vel += b * ncell;
  }
  const int64_t dims[3] = {X, Y, Z};
  const int64_t n = dims[axis];
  int64_t ext[3] = {X, Y, Z};
  ext[axis] = lo != BC_PERIODIC ? n + 1 : n;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ext[0] * ext[1] * ext[2]) return;
  int64_t co[3];
  unravel(idx, ext[1], ext[2], co);
  const int64_t f = co[axis];
  const int64_t stride = axis == 0 ? Y * Z : (axis == 1 ? Z : 1);
  int64_t oc[3] = {co[0], co[1], co[2]};
  oc[axis] = 0;
  const int64_t base = (oc[0] * Y + oc[1]) * Z + oc[2];
  float Fs[NV], fv;
  llf_face<axis>(Q, ncell, base, stride, f, n, lo, hi, is_cons, e, Fs, fv);
  // the hi-wall plane over the two other axes, in order
  const int64_t a1 = axis == 0 ? 1 : 0, a2 = axis == 2 ? 1 : 2;
  store_face(F, vel, F_hi, vel_hi, ncell, dims[a1] * dims[a2], base + f * stride,
             co[a1] * dims[a2] + co[a2], f == n, Fs, fv);
}

// A cell flag of the FOFC mask at sweep coordinate c: wall ghosts are
// unflagged (the `_pad_mask` non-periodic fill), periodic axes wrap.
__device__ __forceinline__ float mask_at(const float* __restrict__ m,
                                         int64_t base, int64_t stride,
                                         int64_t c, int64_t n, int lo,
                                         int hi) {
  if ((c < 0 && lo != BC_PERIODIC) || (c >= n && hi != BC_PERIODIC))
    return 0.0f;
  return load_field(m, base, stride, c, n, lo, hi);
}

// Shared-memory floats of a cell tile of ta cells by tw lines: the face
// kernel's staged primitives, face states and dmins for its ta + 1 faces,
// and the 7 results (flux in state order, face velocity) of each face.
__host__ __device__ __forceinline__ int lean_smem_floats(int ta, int tw) {
  return NV * (ta + 6) * tw + (2 * NV + 2) * (ta + 2) * tw + (NV + 1) * (ta + 1) * tw;
}

// The tile kernels' modes: K2c / K2e (lean: no face array, accumulators,
// the FOFC blend, the register seed), K2 stage 1 (the faces written out
// beside the divergences), K2 stage 2 and K2d (averaged with stage 1's faces).
constexpr int TILE_LEAN = 0;
constexpr int TILE_FACES = 1;
constexpr int TILE_AVG = 2;

// The tile of K2c, K2e and K2's sweeps with a divergence (see the header):
// a block owns ta cells by tw lines, stages and reconstructs them as the
// face kernel does (phases 1-2), solves each of the ta + 1 faces those
// cells touch once into shared memory (phase 3: a face next to a flagged
// cell takes LLF, of `fo` from global memory or of the staged state;
// first_order takes LLF at every face and skips phase 2; TILE_FACES also
// stores the faces the tile owns, TILE_AVG averages each face with stage
// 1's), and then one thread a cell writes div = (F_lo - F_hi) / dx and
// dvel = (v_hi - v_lo) / dx, or adds them onto the accumulators in place,
// with a boundary mask the register seed corr, and with `favg` the
// averaged lo face (phase 4). Slot ta of the last tile of a line is the hi
// wall on a wall axis, face 0 through the index map on a periodic one.
// Every global offset is 64-bit. The kernels pass nullptr and 0 for what
// their mode does not take, which the compiler folds away.
template <int axis, int mode>
__device__ __forceinline__ void tile_sweep(
    const float* __restrict__ Q, const float* __restrict__ chi,
    const float* __restrict__ chi_glo, const float* __restrict__ chi_ghi,
    const float* __restrict__ dminv, const float* __restrict__ dminw,
    const float* __restrict__ mask, const float* __restrict__ fo, float* div, float* dvel,
    const float* __restrict__ cmask, float* corr, float* __restrict__ F,
    float* __restrict__ vel, float* __restrict__ F_hi, float* __restrict__ vel_hi,
    const float* __restrict__ F1, const float* __restrict__ v1,
    const float* __restrict__ F1_hi, const float* __restrict__ v1_hi,
    float* __restrict__ favg, int64_t X, int64_t Y, int64_t Z, int lo, int hi,
    int is_cons, int first_order, float K_visc, float dx, int accumulate,
    int corr_accumulate, int ta, int tw, const Eos& e) {
  extern __shared__ float smem[];
  const int64_t ncell = X * Y * Z;
  const Tile<int64_t> t =
      tile_of<axis, int64_t>(X, Y, Z, axis == 0 ? X : (axis == 1 ? Y : Z), ta, tw);
  const int nf = t.count + 1;  // faces a0 .. a0+cells
  const int cap_s = (ta + 6) * tw, cap_r = (ta + 2) * tw, cap_f = (ta + 1) * tw;
  float* prim_s = smem;                  // [NV][cap_s]
  float* qm_s = prim_s + NV * cap_s;     // [NV][cap_r]
  float* qp_s = qm_s + NV * cap_r;       // [NV][cap_r]
  float* dv_s = qp_s + NV * cap_r;       // [cap_r]
  float* dw_s = dv_s + cap_r;            // [cap_r]
  float* res_s = dw_s + cap_r;           // [NV + 1][cap_f]: flux, face velocity

  // the accumulators this block's cells add onto, into L2 now, so that
  // phase 4 finds them there
  if (mode == TILE_LEAN && (accumulate || corr_accumulate)) {
    for (int el = threadIdx.x; el < t.count * t.lines; el += FACE_THREADS) {
      int r, i;
      tpos<axis>(el, t.count, t.lines, r, i);
      const int64_t idx = t.base + i * t.stride_c + (t.a0 + r) * t.stride_a;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (accumulate) prefetch_l2(div + k * ncell + idx);
        if (corr_accumulate) prefetch_l2(corr + k * ncell + idx);
      }
      if (accumulate) prefetch_l2(dvel + idx);
    }
  }
  stage_prims<axis>(t, nf, Q, ncell, lo, hi, is_cons, e, prim_s, cap_s);
  __syncthreads();
  if (!first_order)
    reconstruct_cells<axis>(t, nf, chi, chi_glo, chi_ghi, dminv, dminw, lo, hi, prim_s,
                            cap_s, qm_s, qp_s, dv_s, dw_s, cap_r);
  __syncthreads();

  // 3. each face once: HLLC, or LLF next to a flagged cell
  const int ns = nf + 5;
  for (int el = threadIdx.x; el < nf * t.lines; el += FACE_THREADS) {
    int fa, i;
    tpos<axis>(el, nf, t.lines, fa, i);
    const int64_t lbase = t.base + i * t.stride_c;
    const int64_t f = t.a0 + fa;
    const bool flagged = mask != nullptr && (mask_at(mask, lbase, t.stride_a, f - 1, t.n,
                                                     lo, hi) > 0.0f ||
                                             mask_at(mask, lbase, t.stride_a, f, t.n, lo,
                                                     hi) > 0.0f);
    float Fs[NV], fv;
    if (flagged && fo != nullptr) {
      llf_face<axis>(fo, ncell, lbase, t.stride_a, f, t.n, lo, hi, is_cons, e, Fs, fv);
    } else if (flagged || first_order) {
      const int sL = tix<axis>(fa + 2, i, ns, t.lines);
      const int sR = tix<axis>(fa + 3, i, ns, t.lines);
      float qL[NV], qR[NV];
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        qL[c] = prim_s[c * cap_s + sL];
        qR[c] = prim_s[c * cap_s + sR];
      }
      llf_states<axis>(qL, qR, e, Fs, fv);
    } else {
      tile_hllc<axis>(fa, i, nf, t.lines, prim_s, cap_s, qm_s, qp_s, dv_s, dw_s, cap_r,
                      dminv != nullptr, dminw != nullptr, K_visc, e, Fs, fv);
    }
    if (mode != TILE_LEAN) {
      // face slot f in global memory: the face arrays below n; at n the
      // hi-wall plane on a wall axis, slot 0 on a periodic one
      const bool on_plane = f == t.n && lo != BC_PERIODIC;
      const int64_t off = lbase + (f == t.n ? 0 : f) * t.stride_a;
      const int64_t poff = t.fixed * t.n_across + t.c0 + i;
      if (mode == TILE_FACES) {
        // the tile's own slots a0 .. a0+cells-1, and the hi wall
        if (fa < t.count || on_plane)
          store_face(F, vel, F_hi, vel_hi, ncell, t.nplane, off, poff, on_plane, Fs, fv);
      } else {
#pragma unroll
        for (int c = 0; c < NV; ++c)
          Fs[c] = 0.5f * ((on_plane ? F1_hi[c * t.nplane + poff] : F1[c * ncell + off]) +
                          Fs[c]);
        if (v1 != nullptr) fv = 0.5f * ((on_plane ? v1_hi[poff] : v1[off]) + fv);
      }
    }
    const int o = tix<axis>(fa, i, nf, t.lines);
#pragma unroll
    for (int c = 0; c < NV; ++c) res_s[c * cap_f + o] = Fs[c];
    res_s[NV * cap_f + o] = fv;
  }
  __syncthreads();

  // 4. one thread a cell: the divergences (and the seed) from its two faces
  for (int el = threadIdx.x; el < t.count * t.lines; el += FACE_THREADS) {
    int r, i;
    tpos<axis>(el, t.count, t.lines, r, i);
    const int64_t lbase = t.base + i * t.stride_c;
    const int64_t c = t.a0 + r;
    const int64_t idx = lbase + c * t.stride_a;
    const int oL = tix<axis>(r, i, nf, t.lines);
    const int oH = tix<axis>(r + 1, i, nf, t.lines);
    // the accumulators' values are all loaded before the first store (the
    // stores may alias them as far as the compiler knows, which would
    // otherwise serialise seven load-store round trips to device memory)
    float old[NV + 1];
    if (accumulate) {
#pragma unroll
      for (int k = 0; k < NV; ++k) old[k] = div[k * ncell + idx];
      old[NV] = dvel[idx];
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float d = (res_s[k * cap_f + oL] - res_s[k * cap_f + oH]) / dx;
      if (accumulate) d = old[k] + d;
      div[k * ncell + idx] = d;
    }
    float dv = (res_s[NV * cap_f + oH] - res_s[NV * cap_f + oL]) / dx;
    if (accumulate) dv = old[NV] + dv;
    dvel[idx] = dv;
    if (favg != nullptr) {  // K2d: the averaged lo face
#pragma unroll
      for (int k = 0; k < NV; ++k) favg[k * ncell + idx] = res_s[k * cap_f + oL];
    }
    if (corr != nullptr) {  // K2e: the boundary-masked divergence
      const bool m_lo = load_field(cmask, lbase, t.stride_a, c, t.n, lo, hi) > 0.5f;
      const bool m_hi = load_field(cmask, lbase, t.stride_a, c + 1, t.n, lo, hi) > 0.5f;
      if (corr_accumulate) {
#pragma unroll
        for (int k = 0; k < NV; ++k) old[k] = corr[k * ncell + idx];
      }
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const float a = m_lo ? res_s[k * cap_f + oL] : 0.0f;
        const float b = m_hi ? res_s[k * cap_f + oH] : 0.0f;
        float d = (a - b) / dx;
        if (corr_accumulate) d = old[k] + d;
        corr[k * ncell + idx] = d;
      }
    }
  }
}

// K2c / K2e: the tile without a face array (see the header).
template <int axis>
__global__ void __launch_bounds__(FACE_THREADS, 4) lean_tile_kernel(
    const float* __restrict__ Q, const float* __restrict__ chi,
    const float* __restrict__ chi_glo, const float* __restrict__ chi_ghi,
    const float* __restrict__ dminv, const float* __restrict__ dminw,
    const float* __restrict__ mask, const float* __restrict__ fo, float* div, float* dvel,
    const float* __restrict__ cmask, float* corr, int64_t X, int64_t Y, int64_t Z, int lo,
    int hi, int is_cons, int first_order, float K_visc, float dx, int accumulate,
    int corr_accumulate, int ta, int tw, Eos e) {
  tile_sweep<axis, TILE_LEAN>(Q, chi, chi_glo, chi_ghi, dminv, dminw, mask, fo, div, dvel,
                              cmask, corr,
                              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, X, Y, Z, lo, hi, is_cons, first_order, K_visc,
                              dx, accumulate, corr_accumulate, ta, tw, e);
}

// K2's sweeps with a divergence (see the header): mode TILE_FACES writes
// the faces F, vel (F_hi, vel_hi on a wall axis) beside div and dvel;
// mode TILE_AVG averages with stage 1's F1, v1 (F1_hi, v1_hi), and with
// `favg` (K2d, v1 nullptr) also writes the averaged lo faces.
template <int axis, int mode>
__global__ void __launch_bounds__(FACE_THREADS, 4) sweep_tile_kernel(
    const float* __restrict__ Q, const float* __restrict__ chi,
    const float* __restrict__ chi_glo, const float* __restrict__ chi_ghi,
    const float* __restrict__ dminv, const float* __restrict__ dminw, float* __restrict__ div,
    float* __restrict__ dvel, float* __restrict__ F, float* __restrict__ vel,
    float* __restrict__ F_hi, float* __restrict__ vel_hi, const float* __restrict__ F1,
    const float* __restrict__ v1, const float* __restrict__ F1_hi,
    const float* __restrict__ v1_hi, float* __restrict__ favg, int64_t X, int64_t Y,
    int64_t Z, int lo, int hi, int is_cons, int first_order, float K_visc, float dx, int ta,
    int tw, Eos e) {
  tile_sweep<axis, mode>(Q, chi, chi_glo, chi_ghi, dminv, dminw, nullptr, nullptr, div, dvel,
                         nullptr, nullptr,
                         F, vel, F_hi, vel_hi, F1, v1, F1_hi, v1_hi, favg, X, Y, Z, lo, hi,
                         is_cons, first_order, K_visc, dx, 0, 0, ta, tw, e);
}

}  // namespace qk

extern "C" int qk_lean_smem(int ta, int tw) {
  return (int)sizeof(float) * qk::lean_smem_floats(ta, tw);
}

// K2c / K2e along one axis in tiles of ta cells by tw lines.
extern "C" int qk_axis_lean(const float* Q, const float* chi, const float* chi_glo,
                            const float* chi_ghi, const float* dminv, const float* dminw,
                            const float* mask, const float* fo, float* div,
                            float* dvel, const float* cmask, float* corr,
                            long long X, long long Y, long long Z,
                            int axis, int lo, int hi, int is_cons,
                            int first_order, float K_visc, float dx,
                            int accumulate, int corr_accumulate, int ta, int tw,
                            float gamma, float gm1, float inv_gm1, float s_n,
                            int reconstruct_eint, void* stream) {
  const qk::Eos e{gamma, gm1, inv_gm1, s_n, reconstruct_eint};
  const long long n = axis == 0 ? X : (axis == 1 ? Y : Z);
  const long long n_across = axis == 2 ? Y : Z;
  const long long fixed = axis == 0 ? Y : X;
  const long long tiles = ((n + ta - 1) / ta) * ((n_across + tw - 1) / tw) * fixed;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  auto kernel = axis == 0 ? qk::lean_tile_kernel<0>
                : (axis == 1 ? qk::lean_tile_kernel<1> : qk::lean_tile_kernel<2>);
  const int smem = qk_lean_smem(ta, tw);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)tiles, qk::FACE_THREADS, smem, (cudaStream_t)stream>>>(
      Q, chi, chi_glo, chi_ghi, dminv, dminw, mask, fo, div, dvel, cmask, corr, X, Y, Z, lo,
      hi, is_cons,
      first_order, K_visc, dx, accumulate, corr_accumulate, ta, tw, e);
  return (int)cudaGetLastError();
}

// The face kernels of one axis over a batch [nbatch, 6, X, Y, Z] (nbatch 1
// on a wall axis), in tiles of ta faces by tw lines (`face_tile_kernel`,
// or `fo_face_kernel` for the first-order fluxes).
extern "C" int qk_axis_flux(const float* Q, const float* chi, const float* chi_glo,
                            const float* chi_ghi, const float* dminv, const float* dminw, float* F,
                            float* vel, float* F_hi, float* vel_hi, long long X,
                            long long Y, long long Z, long long nbatch,
                            int axis, int lo, int hi,
                            int is_cons, int first_order, float K_visc,
                            int ta, int tw, float gamma, float gm1,
                            float inv_gm1, float s_n, int reconstruct_eint,
                            void* stream) {
  const qk::Eos e{gamma, gm1, inv_gm1, s_n, reconstruct_eint};
  const long long n = axis == 0 ? X : (axis == 1 ? Y : Z);
  const long long nf = lo != qk::BC_PERIODIC ? n + 1 : n;
  const long long n_across = axis == 2 ? Y : Z;
  const long long fixed = axis == 0 ? Y : X;
  const long long tiles = ((nf + ta - 1) / ta) * ((n_across + tw - 1) / tw) * fixed;
  const dim3 blocks((unsigned)tiles, (unsigned)nbatch);
  cudaStream_t st = (cudaStream_t)stream;
  if (first_order) {
    const long long total = X * Y * Z / n * nf;
    auto kernel = axis == 0 ? qk::fo_face_kernel<0>
                  : (axis == 1 ? qk::fo_face_kernel<1> : qk::fo_face_kernel<2>);
    kernel<<<dim3((unsigned)((total + qk::FACE_THREADS - 1) / qk::FACE_THREADS),
                  (unsigned)nbatch),
             qk::FACE_THREADS, 0, st>>>(Q, F, vel, F_hi, vel_hi, X, Y, Z, lo, hi, is_cons, e);
    return (int)cudaGetLastError();
  }
  auto kernel = axis == 0 ? qk::face_tile_kernel<0>
                : (axis == 1 ? qk::face_tile_kernel<1> : qk::face_tile_kernel<2>);
  const size_t smem =
      sizeof(float) * ((size_t)(ta + 5) * tw * qk::NV + (size_t)(ta + 1) * tw * (2 * qk::NV + 2));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, qk::FACE_THREADS, smem, st>>>(Q, chi, chi_glo, chi_ghi, dminv, dminw, F,
                                                 vel, F_hi, vel_hi, (int)X, (int)Y, (int)Z,
                                                 lo, hi, is_cons, K_visc, ta, tw, e);
  return (int)cudaGetLastError();
}

// K2's sweep with a divergence along one axis in tiles of ta cells by tw
// lines (`sweep_tile_kernel`): with F (stage 1) the faces are written out,
// with F1 (stage 2, K2d) averaged with; exactly one of the two is given.
extern "C" int qk_axis_sweep(const float* Q, const float* chi, const float* chi_glo,
                             const float* chi_ghi, const float* dminv,
                             const float* dminw, float* div, float* dvel, float* F,
                             float* vel, float* F_hi, float* vel_hi, const float* F1,
                             const float* v1, const float* F1_hi, const float* v1_hi,
                             float* favg, long long X, long long Y, long long Z, int axis,
                             int lo, int hi, int is_cons, int first_order, float K_visc,
                             float dx, int ta, int tw, float gamma, float gm1,
                             float inv_gm1, float s_n, int reconstruct_eint, void* stream) {
  if ((F == nullptr) == (F1 == nullptr)) return (int)cudaErrorInvalidValue;
  const qk::Eos e{gamma, gm1, inv_gm1, s_n, reconstruct_eint};
  const long long n = axis == 0 ? X : (axis == 1 ? Y : Z);
  const long long n_across = axis == 2 ? Y : Z;
  const long long fixed = axis == 0 ? Y : X;
  const long long tiles = ((n + ta - 1) / ta) * ((n_across + tw - 1) / tw) * fixed;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  using Kernel = decltype(&qk::sweep_tile_kernel<0, qk::TILE_FACES>);
  const Kernel kernels[2][3] = {
      {qk::sweep_tile_kernel<0, qk::TILE_FACES>, qk::sweep_tile_kernel<1, qk::TILE_FACES>,
       qk::sweep_tile_kernel<2, qk::TILE_FACES>},
      {qk::sweep_tile_kernel<0, qk::TILE_AVG>, qk::sweep_tile_kernel<1, qk::TILE_AVG>,
       qk::sweep_tile_kernel<2, qk::TILE_AVG>}};
  const Kernel kernel = kernels[F == nullptr][axis];
  const int smem = qk_lean_smem(ta, tw);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)tiles, qk::FACE_THREADS, smem, (cudaStream_t)stream>>>(
      Q, chi, chi_glo, chi_ghi, dminv, dminw, div, dvel, F, vel, F_hi, vel_hi, F1, v1, F1_hi,
      v1_hi, favg, X,
      Y, Z, lo, hi, is_cons, first_order, K_visc, dx, ta, tw, e);
  return (int)cudaGetLastError();
}
