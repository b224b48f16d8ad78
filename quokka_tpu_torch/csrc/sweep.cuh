// The device code of K2 (sweep.cu says what each kernel computes and why it
// is built so), and the host launchers of its kernels, templated on the
// reconstruction ORD (3 PPM, 2 PLM with the minmod slope) and the number NS
// of passive scalars that follow the 6 gas components in the state.
//
// sweep.cu instantiates the PPM form without scalars, the form the parent of
// these templates had, and dispatches the other forms to the translation
// units that instantiate them (QK_FORM_DEFINE below). With ORD 3 and NS 0
// every expression, loop and array here is the one-form code these
// templates replaced.
//
// Scalars (pallas_sweep.py:357, :401-402, :408-416): a scalar is staged and
// reconstructed as the gas components are (its conserved density, never
// converted or flipped), and its face flux is that of the face's Riemann
// fan, s u in the physical flux, S* (S s - s u) / (S - S*) in a star region,
// the LLF average beside it, and the CW84 viscosity's jump. With `nm` mass
// scalars (the first nm of them, runtime) their fluxes are then rescaled to
// the mass flux (consistent multi-species advection, Plewa & Muller 1999):
// the upwind side's rho_flux s_k / sum of its mass scalars, summed in index
// order.
#pragma once

#include "common.cuh"

namespace qk {

struct Face {
  float rho, rinv, u, v, w, P, cs, E, Eint;
};

__device__ __forceinline__ Face face_state(const float* q, int axis, int vax, int wax,
                                           const Eos& e) {
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

// The conserved state U and physical flux F of a face state, with its NS
// scalar densities `sc` after the 6 gas components.
template <int NS>
__device__ __forceinline__ void cons_flux(const Face& s, const float* sc, float* U,
                                          float* F) {
  U[0] = s.rho;
  U[1] = s.rho * s.u;
  U[2] = s.rho * s.v;
  U[3] = s.rho * s.w;
  U[4] = s.E;
  U[5] = s.Eint;
#pragma unroll
  for (int k = 0; k < NS; ++k) U[NV + k] = sc[k];
#pragma unroll
  for (int c = 0; c < NV + NS; ++c) F[c] = s.u * U[c];
  F[1] = F[1] + s.P;
  F[4] = F[4] + s.P * s.u;
}

template <int NS>
__device__ __forceinline__ void llf(const Face& L, const Face& R, const float* sL,
                                    const float* sR, float* out) {
  float UL[NV + NS], FL[NV + NS], UR[NV + NS], FR[NV + NS];
  cons_flux<NS>(L, sL, UL, FL);
  cons_flux<NS>(R, sR, UR, FR);
  const float sp = mx(fabsf(L.u) + L.cs, fabsf(R.u) + R.cs);
#pragma unroll
  for (int c = 0; c < NV + NS; ++c)
    out[c] = 0.5f * (FL[c] + FR[c]) - (0.5f * sp) * (UR[c] - UL[c]);
}

template <int NS>
__device__ __forceinline__ void hllc(const Face& L, const Face& R, const float* sL,
                                     const float* sR, float du, float dw, const Eos& e,
                                     float* out) {
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

  float UL[NV + NS], FL[NV + NS], UR[NV + NS], FR[NV + NS];
  cons_flux<NS>(L, sL, UL, FL);
  cons_flux<NS>(R, sR, UR, FR);
  const float coef_L = 1.0f / (S_L - S_star);
  const float coef_R = 1.0f / (S_R - S_star);
  const bool in_L = S_L > 0.0f;
  const bool in_sL = S_star > 0.0f;
  const bool in_sR = S_R >= 0.0f;
#pragma unroll
  for (int c = 0; c < NV + NS; ++c) {
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

// Canonical-frame flux `out` -> state component order (scalars stay in
// place after the gas components), and the face velocity from the upwind
// side's 1/rho.
template <int axis, int NS>
__device__ __forceinline__ void state_order(const float* out, float rinv_L, float rinv_R,
                                            float* Fs, float& fv) {
  constexpr int vax = axis == 0 ? 1 : (axis == 1 ? 2 : 0);
  constexpr int wax = axis == 0 ? 2 : (axis == 1 ? 0 : 1);
  Fs[0] = out[0];
  Fs[1 + axis] = out[1];
  Fs[1 + vax] = out[2];
  Fs[1 + wax] = out[3];
  Fs[4] = out[4];
  Fs[5] = out[5];
#pragma unroll
  for (int k = 0; k < NS; ++k) Fs[NV + k] = out[NV + k];
  fv = Fs[0] * (Fs[0] >= 0.0f ? rinv_R : rinv_L);
}

// The first nm scalars' fluxes rescaled to the mass flux Fs[0] (see the
// header): (rho_flux s_k) / sum, from the upwind side's face scalars.
template <int NS>
__device__ __forceinline__ void cma(float* Fs, const float* sL, const float* sR, int nm) {
  if (NS == 0 || nm <= 0) return;
  float sum_L = sL[0], sum_R = sR[0];
#pragma unroll
  for (int k = 1; k < NS; ++k) {
    if (k < nm) {
      sum_L = sum_L + sL[k];
      sum_R = sum_R + sR[k];
    }
  }
  const float mrho = Fs[0];
  const bool upwind_is_L = mrho >= 0.0f;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    if (k < nm)
      Fs[NV + k] = upwind_is_L ? (mrho * sL[k]) / sum_L : (mrho * sR[k]) / sum_R;
  }
}

// LLF between the donor-cell primitive states qL (cell f-1) and qR (cell
// f), in state component order.
template <int axis, int NS>
__device__ __forceinline__ void llf_states(const float* qL, const float* qR, const Eos& e,
                                           int nm, float* Fs, float& fv) {
  constexpr int vax = axis == 0 ? 1 : (axis == 1 ? 2 : 0);
  constexpr int wax = axis == 0 ? 2 : (axis == 1 ? 0 : 1);
  float out[NV + NS];
  const Face L = face_state(qL, axis, vax, wax, e);
  const Face R = face_state(qR, axis, vax, wax, e);
  llf<NS>(L, R, qL + NV, qR + NV, out);
  state_order<axis, NS>(out, L.rinv, R.rinv, Fs, fv);
  cma<NS>(Fs, qL + NV, qR + NV, nm);
}

// The first-order face f: donor-cell states of cells f-1 and f (through
// the wall map) and LLF, in state component order.
template <int axis, int NS>
__device__ __forceinline__ void llf_face(const float* __restrict__ Q, int64_t ncell,
                                         int64_t base, int64_t stride, int64_t f, int64_t n,
                                         int lo, int hi, int is_cons, const Eos& e, int nm,
                                         float* Fs, float& fv) {
  float qL[NV + NS], qR[NV + NS];
  load_prim<NS>(Q, ncell, base, stride, f - 1, n, lo, hi, axis, is_cons, e, qL);
  load_prim<NS>(Q, ncell, base, stride, f, n, lo, hi, axis, is_cons, e, qR);
  llf_states<axis, NS>(qL, qR, e, nm, Fs, fv);
}

// HLLC at one face from its reconstructed states qL, qR (primitives), the
// normal velocity jump du of the two cells, and their dmin values along
// the transverse axes (has_v / has_w: the field exists), with the CW84
// viscosity when K_visc > 0; in state component order.
template <int axis, int NS>
__device__ __forceinline__ void hllc_face(const float* qL, const float* qR, float du,
                                          bool has_v, float dvl, float dvr,
                                          bool has_w, float dwl, float dwr,
                                          float K_visc, const Eos& e, int nm,
                                          float* Fs, float& fv) {
  constexpr int vax = axis == 0 ? 1 : (axis == 1 ? 2 : 0);
  constexpr int wax = axis == 0 ? 2 : (axis == 1 ? 0 : 1);
  float out[NV + NS];
  const Face L = face_state(qL, axis, vax, wax, e);
  const Face R = face_state(qR, axis, vax, wax, e);
  float dw = 0.0f;
  if (has_v) dw = mn(dvl, dvr);
  if (has_w) {
    const float m2 = mn(dwl, dwr);
    dw = has_v ? mn(dw, m2) : m2;
  }
  hllc<NS>(L, R, qL + NV, qR + NV, du, dw, e, out);
  if (K_visc > 0.0f) {
    float div_v = du;
    if (has_v) div_v = div_v + 0.5f * (dvl + dvr);
    if (has_w) div_v = div_v + 0.5f * (dwl + dwr);
    const float visc = K_visc * mx(-div_v, 0.0f);
    float UL[NV + NS], FL[NV + NS], UR[NV + NS], FR[NV + NS];
    cons_flux<NS>(L, qL + NV, UL, FL);
    cons_flux<NS>(R, qR + NV, UR, FR);
#pragma unroll
    for (int c = 0; c < NV + NS; ++c) out[c] = out[c] + visc * (UL[c] - UR[c]);
  }
  state_order<axis, NS>(out, L.rinv, R.rinv, Fs, fv);
  cma<NS>(Fs, qL + NV, qR + NV, nm);
}

// Where face slot f of the line at (fixed, across) goes: the face arrays
// [6 + NS, X, Y, Z] / [X, Y, Z] below n, the hi-wall planes [6 + NS,
// plane] / [plane] at f = n (the plane over the two other axes in order:
// its offset is fixed * n_across + across for every axis).
template <int NS>
__device__ __forceinline__ void store_face(
    float* __restrict__ F, float* __restrict__ vel, float* __restrict__ F_hi,
    float* __restrict__ vel_hi, int64_t ncell, int64_t nplane, int64_t off,
    int64_t poff, bool on_plane, const float* Fs, float fv) {
  if (!on_plane) {
#pragma unroll
    for (int c = 0; c < NV + NS; ++c) F[c * ncell + off] = Fs[c];
    vel[off] = fv;
  } else {
#pragma unroll
    for (int c = 0; c < NV + NS; ++c) F_hi[c * nplane + poff] = Fs[c];
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
// a0+nfaces+1) into prim_s [6 + NS][cap_s], each loaded once through the
// wall index map and converted once.
template <int axis, int NS, typename I>
__device__ __forceinline__ void stage_prims(const Tile<I>& t, int nfaces,
                                            const float* __restrict__ Q, int64_t ncell,
                                            int lo, int hi, int is_cons, const Eos& e,
                                            float* prim_s, int cap_s) {
  const int ns = nfaces + 5;
  for (int el = threadIdx.x; el < ns * t.lines; el += FACE_THREADS) {
    int j, i;
    tpos<axis>(el, ns, t.lines, j, i);
    float q[NV + NS];
    load_prim<NS>(Q, ncell, t.base + i * t.stride_c, t.stride_a, t.a0 - 3 + j, t.n, lo,
                  hi, axis, is_cons, e, q);
    const int s = tix<axis>(j, i, ns, t.lines);
#pragma unroll
    for (int c = 0; c < NV + NS; ++c) prim_s[c * cap_s + s] = q[c];
  }
}

// Phase 2: the chi-blended face states (minus, plus) of the nfaces + 1
// cells the faces touch (a0-1 .. a0+nfaces-1), each reconstructed once,
// PPM (ORD 3) or PLM with the minmod slope (ORD 2: q0 -+ slope / 2), into
// qm_s / qp_s [6 + NS][cap_r], and their dmin values into dv_s / dw_s.
// chi_glo / chi_ghi: the outflow sides' wall-adjacent chi planes
// (common.cuh: load_chi), or nullptr.
template <int axis, int ORD, int NS, typename I>
__device__ __forceinline__ void reconstruct_cells(
    const Tile<I>& t, int nfaces, const float* __restrict__ chi,
    const float* __restrict__ chi_glo, const float* __restrict__ chi_ghi,
    const float* __restrict__ dminv, const float* __restrict__ dminw, int lo, int hi,
    const float* prim_s, int cap_s, float* qm_s, float* qp_s, float* dv_s, float* dw_s,
    int cap_r) {
  static_assert(ORD == 2 || ORD == 3, "K2 reconstructs with PLM or PPM");
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
    for (int c = 0; c < NV + NS; ++c) {
      const float* w = prim_s + c * cap_s + s;
      float minus, plus;
      if (ORD == 3) {
        ppm_cell(w[-2 * sa], w[-sa], w[0], w[sa], w[2 * sa], minus, plus);
      } else {
        const float slope = minmod(w[sa] - w[0], w[0] - w[-sa]);
        minus = w[0] - 0.5f * slope;
        plus = w[0] + 0.5f * slope;
      }
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
template <int axis, int NS>
__device__ __forceinline__ void tile_hllc(int fa, int i, int nfaces, int lines,
                                          const float* prim_s, int cap_s,
                                          const float* qm_s, const float* qp_s,
                                          const float* dv_s, const float* dw_s, int cap_r,
                                          bool has_v, bool has_w, float K_visc,
                                          const Eos& e, int nm, float* Fs, float& fv) {
  const int ns = nfaces + 5, nr = nfaces + 1;
  const int oL = tix<axis>(fa, i, nr, lines);
  const int oR = tix<axis>(fa + 1, i, nr, lines);
  const int sL = tix<axis>(fa + 2, i, ns, lines);
  const int sR = tix<axis>(fa + 3, i, ns, lines);
  float qL[NV + NS], qR[NV + NS];
#pragma unroll
  for (int c = 0; c < NV + NS; ++c) {
    qL[c] = qp_s[c * cap_r + oL];
    qR[c] = qm_s[c * cap_r + oR];
  }
  const float du = prim_s[(1 + axis) * cap_s + sR] - prim_s[(1 + axis) * cap_s + sL];
  hllc_face<axis, NS>(qL, qR, du, has_v, has_v ? dv_s[oL] : 0.0f, has_v ? dv_s[oR] : 0.0f,
                      has_w, has_w ? dw_s[oL] : 0.0f, has_w ? dw_s[oR] : 0.0f, K_visc, e,
                      nm, Fs, fv);
}

// The face kernel, a shared-memory tile (sweep.cu's header). Blocks of a
// batch [B, 6 + NS, X, Y, Z] are blockIdx.y; offsets inside one component
// of one block are 32-bit (the wrapper holds X Y Z below 2^31).
template <int axis, int ORD, int NS>
__global__ void __launch_bounds__(FACE_THREADS, 4) face_tile_kernel(
    const float* __restrict__ Q, const float* __restrict__ chi,
    const float* __restrict__ chi_glo, const float* __restrict__ chi_ghi,
    const float* __restrict__ dminv, const float* __restrict__ dminw,
    float* __restrict__ F, float* __restrict__ vel, float* __restrict__ F_hi,
    float* __restrict__ vel_hi, int X, int Y, int Z, int lo, int hi,
    int is_cons, float K_visc, int ta, int tw, Eos e, int nm) {
  constexpr int NT = NV + NS;
  extern __shared__ float smem[];
  const int64_t ncell = (int64_t)X * Y * Z;
  {  // batch index: block b of a [B, 6 + NS, X, Y, Z] chunk (B = 1 unbatched)
    const int64_t b = blockIdx.y;
    Q += b * NT * ncell;
    F += b * NT * ncell;
    vel += b * ncell;
    if (chi != nullptr) chi += b * ncell;
    if (dminv != nullptr) dminv += b * ncell;
    if (dminw != nullptr) dminw += b * ncell;
  }
  const int n = axis == 0 ? X : (axis == 1 ? Y : Z);
  const Tile<int> t = tile_of<axis, int>(X, Y, Z, lo != BC_PERIODIC ? n + 1 : n, ta, tw);
  const int cap_s = (ta + 5) * tw, cap_r = (ta + 1) * tw;
  float* prim_s = smem;                  // [NT][cap_s]
  float* qm_s = prim_s + NT * cap_s;     // [NT][cap_r] blended minus states
  float* qp_s = qm_s + NT * cap_r;       // [NT][cap_r] blended plus states
  float* dv_s = qp_s + NT * cap_r;       // [cap_r]
  float* dw_s = dv_s + cap_r;            // [cap_r]

  stage_prims<axis, NS>(t, t.count, Q, ncell, lo, hi, is_cons, e, prim_s, cap_s);
  __syncthreads();
  reconstruct_cells<axis, ORD, NS>(t, t.count, chi, chi_glo, chi_ghi, dminv, dminw, lo,
                                   hi, prim_s, cap_s, qm_s, qp_s, dv_s, dw_s, cap_r);
  __syncthreads();

  // 3. HLLC at faces a0 .. a0+faces-1
  for (int el = threadIdx.x; el < t.count * t.lines; el += FACE_THREADS) {
    int fa, i;
    tpos<axis>(el, t.count, t.lines, fa, i);
    float Fs[NT], fv;
    tile_hllc<axis, NS>(fa, i, t.count, t.lines, prim_s, cap_s, qm_s, qp_s, dv_s, dw_s,
                        cap_r, dminv != nullptr, dminw != nullptr, K_visc, e, nm, Fs, fv);
    const int f = t.a0 + fa;
    const int across = t.c0 + i;
    store_face<NS>(F, vel, F_hi, vel_hi, ncell, t.nplane,
                   t.base + (int64_t)f * t.stride_a + i * t.stride_c,
                   (int64_t)t.fixed * t.n_across + across, f == t.n, Fs, fv);
  }
}

// The first-order face kernel: one thread per (face, transverse position),
// z fastest, over ext = (X, Y, Z) with the axis extent n + 1 on a wall axis.
template <int axis, int NS>
__global__ void __launch_bounds__(FACE_THREADS) fo_face_kernel(
    const float* __restrict__ Q, float* __restrict__ F, float* __restrict__ vel,
    float* __restrict__ F_hi, float* __restrict__ vel_hi, int64_t X, int64_t Y,
    int64_t Z, int lo, int hi, int is_cons, Eos e, int nm) {
  const int64_t ncell = X * Y * Z;
  {
    const int64_t b = blockIdx.y;
    Q += b * (NV + NS) * ncell;
    F += b * (NV + NS) * ncell;
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
  float Fs[NV + NS], fv;
  llf_face<axis, NS>(Q, ncell, base, stride, f, n, lo, hi, is_cons, e, nm, Fs, fv);
  // the hi-wall plane over the two other axes, in order
  const int64_t a1 = axis == 0 ? 1 : 0, a2 = axis == 2 ? 1 : 2;
  store_face<NS>(F, vel, F_hi, vel_hi, ncell, dims[a1] * dims[a2], base + f * stride,
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

// Shared-memory floats of a cell tile of ta cells by tw lines with nt
// components (6 + the scalars): the face kernel's staged primitives, face
// states and dmins for its ta + 1 faces, and the nt + 1 results (flux in
// state order, face velocity) of each face.
__host__ __device__ __forceinline__ int lean_smem_floats(int ta, int tw, int nt) {
  return nt * (ta + 6) * tw + (2 * nt + 2) * (ta + 2) * tw + (nt + 1) * (ta + 1) * tw;
}

// Shared-memory bytes of a face-kernel tile of ta faces by tw lines.
__host__ __device__ __forceinline__ size_t face_smem_bytes(int ta, int tw, int nt) {
  return sizeof(float) * ((size_t)(ta + 5) * tw * nt + (size_t)(ta + 1) * tw * (2 * nt + 2));
}

// The tile kernels' modes: K2c / K2e (lean: no face array, accumulators,
// the FOFC blend, the register seed), K2 stage 1 (the faces written out
// beside the divergences), K2 stage 2 and K2d (averaged with stage 1's faces).
constexpr int TILE_LEAN = 0;
constexpr int TILE_FACES = 1;
constexpr int TILE_AVG = 2;

// The tile of K2c, K2e and K2's sweeps with a divergence (sweep.cu's
// header): a block owns ta cells by tw lines, stages and reconstructs them
// as the face kernel does (phases 1-2), solves each of the ta + 1 faces
// those cells touch once into shared memory (phase 3: a face next to a
// flagged cell takes LLF, of `fo` from global memory or of the staged
// state; first_order takes LLF at every face and skips phase 2; TILE_FACES
// also stores the faces the tile owns, TILE_AVG averages each face with
// stage 1's), and then one thread a cell writes div = (F_lo - F_hi) / dx
// and dvel = (v_hi - v_lo) / dx, or adds them onto the accumulators in
// place, with a boundary mask the register seed corr, and with `favg` the
// averaged lo face (phase 4). Slot ta of the last tile of a line is the hi
// wall on a wall axis, face 0 through the index map on a periodic one.
// Every global offset is 64-bit. The kernels pass nullptr and 0 for what
// their mode does not take, which the compiler folds away.
template <int axis, int mode, int ORD, int NS>
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
    int corr_accumulate, int ta, int tw, const Eos& e, int nm) {
  constexpr int NT = NV + NS;
  extern __shared__ float smem[];
  const int64_t ncell = X * Y * Z;
  const Tile<int64_t> t =
      tile_of<axis, int64_t>(X, Y, Z, axis == 0 ? X : (axis == 1 ? Y : Z), ta, tw);
  const int nf = t.count + 1;  // faces a0 .. a0+cells
  const int cap_s = (ta + 6) * tw, cap_r = (ta + 2) * tw, cap_f = (ta + 1) * tw;
  float* prim_s = smem;                  // [NT][cap_s]
  float* qm_s = prim_s + NT * cap_s;     // [NT][cap_r]
  float* qp_s = qm_s + NT * cap_r;       // [NT][cap_r]
  float* dv_s = qp_s + NT * cap_r;       // [cap_r]
  float* dw_s = dv_s + cap_r;            // [cap_r]
  float* res_s = dw_s + cap_r;           // [NT + 1][cap_f]: flux, face velocity

  // the accumulators this block's cells add onto, into L2 now, so that
  // phase 4 finds them there
  if (mode == TILE_LEAN && (accumulate || corr_accumulate)) {
    for (int el = threadIdx.x; el < t.count * t.lines; el += FACE_THREADS) {
      int r, i;
      tpos<axis>(el, t.count, t.lines, r, i);
      const int64_t idx = t.base + i * t.stride_c + (t.a0 + r) * t.stride_a;
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        if (accumulate) prefetch_l2(div + k * ncell + idx);
        if (corr_accumulate) prefetch_l2(corr + k * ncell + idx);
      }
      if (accumulate) prefetch_l2(dvel + idx);
    }
  }
  stage_prims<axis, NS>(t, nf, Q, ncell, lo, hi, is_cons, e, prim_s, cap_s);
  __syncthreads();
  if (!first_order)
    reconstruct_cells<axis, ORD, NS>(t, nf, chi, chi_glo, chi_ghi, dminv, dminw, lo, hi,
                                     prim_s, cap_s, qm_s, qp_s, dv_s, dw_s, cap_r);
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
    float Fs[NT], fv;
    if (flagged && fo != nullptr) {
      llf_face<axis, NS>(fo, ncell, lbase, t.stride_a, f, t.n, lo, hi, is_cons, e, nm, Fs,
                         fv);
    } else if (flagged || first_order) {
      const int sL = tix<axis>(fa + 2, i, ns, t.lines);
      const int sR = tix<axis>(fa + 3, i, ns, t.lines);
      float qL[NT], qR[NT];
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        qL[c] = prim_s[c * cap_s + sL];
        qR[c] = prim_s[c * cap_s + sR];
      }
      llf_states<axis, NS>(qL, qR, e, nm, Fs, fv);
    } else {
      tile_hllc<axis, NS>(fa, i, nf, t.lines, prim_s, cap_s, qm_s, qp_s, dv_s, dw_s, cap_r,
                          dminv != nullptr, dminw != nullptr, K_visc, e, nm, Fs, fv);
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
          store_face<NS>(F, vel, F_hi, vel_hi, ncell, t.nplane, off, poff, on_plane, Fs,
                         fv);
      } else {
#pragma unroll
        for (int c = 0; c < NT; ++c)
          Fs[c] = 0.5f * ((on_plane ? F1_hi[c * t.nplane + poff] : F1[c * ncell + off]) +
                          Fs[c]);
        if (v1 != nullptr) fv = 0.5f * ((on_plane ? v1_hi[poff] : v1[off]) + fv);
      }
    }
    const int o = tix<axis>(fa, i, nf, t.lines);
#pragma unroll
    for (int c = 0; c < NT; ++c) res_s[c * cap_f + o] = Fs[c];
    res_s[NT * cap_f + o] = fv;
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
    float old[NT + 1];
    if (accumulate) {
#pragma unroll
      for (int k = 0; k < NT; ++k) old[k] = div[k * ncell + idx];
      old[NT] = dvel[idx];
    }
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      float d = (res_s[k * cap_f + oL] - res_s[k * cap_f + oH]) / dx;
      if (accumulate) d = old[k] + d;
      div[k * ncell + idx] = d;
    }
    float dv = (res_s[NT * cap_f + oH] - res_s[NT * cap_f + oL]) / dx;
    if (accumulate) dv = old[NT] + dv;
    dvel[idx] = dv;
    if (favg != nullptr) {  // K2d: the averaged lo face
#pragma unroll
      for (int k = 0; k < NT; ++k) favg[k * ncell + idx] = res_s[k * cap_f + oL];
    }
    if (corr != nullptr) {  // K2e: the boundary-masked divergence
      const bool m_lo = load_field(cmask, lbase, t.stride_a, c, t.n, lo, hi) > 0.5f;
      const bool m_hi = load_field(cmask, lbase, t.stride_a, c + 1, t.n, lo, hi) > 0.5f;
      if (corr_accumulate) {
#pragma unroll
        for (int k = 0; k < NT; ++k) old[k] = corr[k * ncell + idx];
      }
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        const float a = m_lo ? res_s[k * cap_f + oL] : 0.0f;
        const float b = m_hi ? res_s[k * cap_f + oH] : 0.0f;
        float d = (a - b) / dx;
        if (corr_accumulate) d = old[k] + d;
        corr[k * ncell + idx] = d;
      }
    }
  }
}

// K2c / K2e: the tile without a face array (sweep.cu's header).
template <int axis, int ORD, int NS>
__global__ void __launch_bounds__(FACE_THREADS, 4) lean_tile_kernel(
    const float* __restrict__ Q, const float* __restrict__ chi,
    const float* __restrict__ chi_glo, const float* __restrict__ chi_ghi,
    const float* __restrict__ dminv, const float* __restrict__ dminw,
    const float* __restrict__ mask, const float* __restrict__ fo, float* div, float* dvel,
    const float* __restrict__ cmask, float* corr, int64_t X, int64_t Y, int64_t Z, int lo,
    int hi, int is_cons, int first_order, float K_visc, float dx, int accumulate,
    int corr_accumulate, int ta, int tw, Eos e, int nm) {
  tile_sweep<axis, TILE_LEAN, ORD, NS>(Q, chi, chi_glo, chi_ghi, dminv, dminw, mask, fo,
                                       div, dvel, cmask, corr, nullptr, nullptr, nullptr,
                                       nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                       X, Y, Z, lo, hi, is_cons, first_order, K_visc, dx,
                                       accumulate, corr_accumulate, ta, tw, e, nm);
}

// K2's sweeps with a divergence (sweep.cu's header): mode TILE_FACES
// writes the faces F, vel (F_hi, vel_hi on a wall axis) beside div and
// dvel; mode TILE_AVG averages with stage 1's F1, v1 (F1_hi, v1_hi), and
// with `favg` (K2d, v1 nullptr) also writes the averaged lo faces.
template <int axis, int mode, int ORD, int NS>
__global__ void __launch_bounds__(FACE_THREADS, 4) sweep_tile_kernel(
    const float* __restrict__ Q, const float* __restrict__ chi,
    const float* __restrict__ chi_glo, const float* __restrict__ chi_ghi,
    const float* __restrict__ dminv, const float* __restrict__ dminw, float* __restrict__ div,
    float* __restrict__ dvel, float* __restrict__ F, float* __restrict__ vel,
    float* __restrict__ F_hi, float* __restrict__ vel_hi, const float* __restrict__ F1,
    const float* __restrict__ v1, const float* __restrict__ F1_hi,
    const float* __restrict__ v1_hi, float* __restrict__ favg, int64_t X, int64_t Y,
    int64_t Z, int lo, int hi, int is_cons, int first_order, float K_visc, float dx, int ta,
    int tw, Eos e, int nm) {
  tile_sweep<axis, mode, ORD, NS>(Q, chi, chi_glo, chi_ghi, dminv, dminw, nullptr, nullptr,
                                  div, dvel, nullptr, nullptr, F, vel, F_hi, vel_hi, F1, v1,
                                  F1_hi, v1_hi, favg, X, Y, Z, lo, hi, is_cons, first_order,
                                  K_visc, dx, 0, 0, ta, tw, e, nm);
}

// ---------------------------------------------------------- host launchers
// The arguments of one launch of each entry point of sweep.cu.
struct LeanArgs {
  const float *Q, *chi, *chi_glo, *chi_ghi, *dminv, *dminw, *mask, *fo;
  float *div, *dvel;
  const float* cmask;
  float* corr;
  long long X, Y, Z;
  int axis, lo, hi, is_cons, first_order;
  float K_visc, dx;
  int accumulate, corr_accumulate, ta, tw;
  Eos e;
  int nm;
  cudaStream_t stream;
};

struct FaceArgs {
  const float *Q, *chi, *chi_glo, *chi_ghi, *dminv, *dminw;
  float *F, *vel, *F_hi, *vel_hi;
  long long X, Y, Z, nbatch;
  int axis, lo, hi, is_cons;
  float K_visc;
  int ta, tw;
  Eos e;
  int nm;
  cudaStream_t stream;
};

struct SweepArgs {
  const float *Q, *chi, *chi_glo, *chi_ghi, *dminv, *dminw;
  float *div, *dvel, *F, *vel, *F_hi, *vel_hi;
  const float *F1, *v1, *F1_hi, *v1_hi;
  float* favg;
  long long X, Y, Z;
  int axis, lo, hi, is_cons, first_order;
  float K_visc, dx;
  int ta, tw;
  Eos e;
  int nm;
  cudaStream_t stream;
};

// Raise the kernel's dynamic shared-memory limit where a block takes more
// than the default 48 KB.
template <typename Kernel>
__host__ inline int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// K2c / K2e along one axis in tiles of ta cells by tw lines.
template <int ORD, int NS>
__host__ int launch_lean(const LeanArgs& a) {
  const long long n = a.axis == 0 ? a.X : (a.axis == 1 ? a.Y : a.Z);
  const long long n_across = a.axis == 2 ? a.Y : a.Z;
  const long long fixed = a.axis == 0 ? a.Y : a.X;
  const long long tiles = ((n + a.ta - 1) / a.ta) * ((n_across + a.tw - 1) / a.tw) * fixed;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  auto kernel = a.axis == 0 ? lean_tile_kernel<0, ORD, NS>
                : (a.axis == 1 ? lean_tile_kernel<1, ORD, NS> : lean_tile_kernel<2, ORD, NS>);
  const int smem = (int)sizeof(float) * lean_smem_floats(a.ta, a.tw, NV + NS);
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<(unsigned)tiles, FACE_THREADS, smem, a.stream>>>(
      a.Q, a.chi, a.chi_glo, a.chi_ghi, a.dminv, a.dminw, a.mask, a.fo, a.div, a.dvel,
      a.cmask, a.corr, a.X, a.Y, a.Z, a.lo, a.hi, a.is_cons, a.first_order, a.K_visc, a.dx,
      a.accumulate, a.corr_accumulate, a.ta, a.tw, a.e, a.nm);
  return (int)cudaGetLastError();
}

// The PPM or PLM face kernel of one axis over a batch [nbatch, 6 + NS, X,
// Y, Z] (nbatch 1 on a wall axis), in tiles of ta faces by tw lines.
template <int ORD, int NS>
__host__ int launch_faces(const FaceArgs& a) {
  const long long n = a.axis == 0 ? a.X : (a.axis == 1 ? a.Y : a.Z);
  const long long nf = a.lo != BC_PERIODIC ? n + 1 : n;
  const long long n_across = a.axis == 2 ? a.Y : a.Z;
  const long long fixed = a.axis == 0 ? a.Y : a.X;
  const long long tiles = ((nf + a.ta - 1) / a.ta) * ((n_across + a.tw - 1) / a.tw) * fixed;
  auto kernel = a.axis == 0 ? face_tile_kernel<0, ORD, NS>
                : (a.axis == 1 ? face_tile_kernel<1, ORD, NS> : face_tile_kernel<2, ORD, NS>);
  const size_t smem = face_smem_bytes(a.ta, a.tw, NV + NS);
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<dim3((unsigned)tiles, (unsigned)a.nbatch), FACE_THREADS, smem, a.stream>>>(
      a.Q, a.chi, a.chi_glo, a.chi_ghi, a.dminv, a.dminw, a.F, a.vel, a.F_hi, a.vel_hi,
      (int)a.X, (int)a.Y, (int)a.Z, a.lo, a.hi, a.is_cons, a.K_visc, a.ta, a.tw, a.e, a.nm);
  return (int)cudaGetLastError();
}

// The first-order (donor cell + LLF) face kernel of one axis over a batch.
template <int NS>
__host__ int launch_fo_faces(const FaceArgs& a) {
  const long long n = a.axis == 0 ? a.X : (a.axis == 1 ? a.Y : a.Z);
  const long long nf = a.lo != BC_PERIODIC ? n + 1 : n;
  const long long total = a.X * a.Y * a.Z / n * nf;
  auto kernel = a.axis == 0 ? fo_face_kernel<0, NS>
                : (a.axis == 1 ? fo_face_kernel<1, NS> : fo_face_kernel<2, NS>);
  kernel<<<dim3((unsigned)((total + FACE_THREADS - 1) / FACE_THREADS), (unsigned)a.nbatch),
           FACE_THREADS, 0, a.stream>>>(a.Q, a.F, a.vel, a.F_hi, a.vel_hi, a.X, a.Y, a.Z,
                                        a.lo, a.hi, a.is_cons, a.e, a.nm);
  return (int)cudaGetLastError();
}

// K2's sweep with a divergence along one axis in tiles of ta cells by tw
// lines: with F (stage 1) the faces are written out, with F1 (stage 2,
// K2d) averaged with; exactly one of the two is given.
template <int ORD, int NS>
__host__ int launch_sweep(const SweepArgs& a) {
  if ((a.F == nullptr) == (a.F1 == nullptr)) return (int)cudaErrorInvalidValue;
  const long long n = a.axis == 0 ? a.X : (a.axis == 1 ? a.Y : a.Z);
  const long long n_across = a.axis == 2 ? a.Y : a.Z;
  const long long fixed = a.axis == 0 ? a.Y : a.X;
  const long long tiles = ((n + a.ta - 1) / a.ta) * ((n_across + a.tw - 1) / a.tw) * fixed;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  using Kernel = decltype(&sweep_tile_kernel<0, TILE_FACES, ORD, NS>);
  const Kernel kernels[2][3] = {
      {sweep_tile_kernel<0, TILE_FACES, ORD, NS>, sweep_tile_kernel<1, TILE_FACES, ORD, NS>,
       sweep_tile_kernel<2, TILE_FACES, ORD, NS>},
      {sweep_tile_kernel<0, TILE_AVG, ORD, NS>, sweep_tile_kernel<1, TILE_AVG, ORD, NS>,
       sweep_tile_kernel<2, TILE_AVG, ORD, NS>}};
  const Kernel kernel = kernels[a.F == nullptr][a.axis];
  const int smem = (int)sizeof(float) * lean_smem_floats(a.ta, a.tw, NV + NS);
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<(unsigned)tiles, FACE_THREADS, smem, a.stream>>>(
      a.Q, a.chi, a.chi_glo, a.chi_ghi, a.dminv, a.dminw, a.div, a.dvel, a.F, a.vel, a.F_hi,
      a.vel_hi, a.F1, a.v1, a.F1_hi, a.v1_hi, a.favg, a.X, a.Y, a.Z, a.lo, a.hi, a.is_cons,
      a.first_order, a.K_visc, a.dx, a.ta, a.tw, a.e, a.nm);
  return (int)cudaGetLastError();
}

// The forms other translation units instantiate, one (order, scalars) pair
// each, so that nvcc compiles them in parallel and no kernel is
// instantiated twice: QK_FORM_DEFINE(tag, ORD, NS) defines a form's entry
// points lean_<tag>, faces_<tag> and sweep_<tag> in its unit
// (sweep_ppm1.cu, sweep_ppm2.cu: PPM with 1 or 2 scalars, with the
// first-order faces fo_faces1 / fo_faces2; sweep_plm0.cu, sweep_plm1.cu,
// sweep_plm2.cu: PLM with 0-2 scalars); sweep.cu dispatches to them.
#define QK_FORM_FUNCS(tag)                \
  int lean_##tag(const LeanArgs& a);     \
  int faces_##tag(const FaceArgs& a);    \
  int sweep_##tag(const SweepArgs& a);
#define QK_FORM_DEFINE(tag, ORD, NS)                                      \
  int lean_##tag(const LeanArgs& a) { return launch_lean<ORD, NS>(a); }   \
  int faces_##tag(const FaceArgs& a) { return launch_faces<ORD, NS>(a); } \
  int sweep_##tag(const SweepArgs& a) { return launch_sweep<ORD, NS>(a); }
QK_FORM_FUNCS(ppm1)
QK_FORM_FUNCS(ppm2)
QK_FORM_FUNCS(plm0)
QK_FORM_FUNCS(plm1)
QK_FORM_FUNCS(plm2)
int fo_faces1(const FaceArgs& a);
int fo_faces2(const FaceArgs& a);

}  // namespace qk
