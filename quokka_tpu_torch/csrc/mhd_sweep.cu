// K8: one axis of the constrained-transport MHD sweep.
//
// Replaces quokka_tpu/mhd/pallas_sweep.py::compute_mhd_axis_pallas (the
// pallas_call at :98, kernel body :80-95) on the periodic, unpadded f32
// state: donor-cell / PLM (minmod) / PPM faces of the 8 primitives
// [rho, vx, vy, vz, P, Bx, By, Bz] along the axis, the density and pressure
// floors on the face states when they are > 0, the HLLD flux (Miyoshi &
// Kusano 2005 with all six regions, the degenerate star denominator and the
// bx -> 0 double-star branch, hydro/riemann.py::hlld) with the staggered
// normal field `bxf` at the face, and one [8, X, Y, Z] output:
//   rows 0-4  (F(i-1/2) - F(i+1/2)) * inv_dx in state order [rho, mx, my, mz, E]
//   row  5    the lo-face mass flux
//   rows 6-7  the lo-face canonical induction fluxes F[by'], F[bz']
// (the caller maps row 6 to -E_wax and row 7 to +E_vax, mhd/advance.py).
//
// Design: one thread per cell, z fastest, as K6. The thread reads cells
// i-3..i+3 of the 7 primitives the faces need (the one along the axis is
// the staggered bxf instead) through the periodic index map, builds the
// states of its lo and hi faces, and solves HLLD at both: each face is
// solved twice, once by each neighbour. The other design, a face kernel and
// a divergence kernel as K2, solves each face once but moves ~100 B a cell
// (faces written and read back) against this one's 64 B; at ~315 FP32
// operations of HLLD a face, doing them twice still keeps the arithmetic
// below the byte bound, so the single kernel is the simpler and the smaller
// bound.
//
// Bound on the H100 at 256^3: bytes. 32 B read a cell (7 primitives and
// bxf; the neighbours' reads hit L1/L2) and 32 B written, 1.07 GB an axis:
// 0.320 ms at 3.35 TB/s, 1.92 ms for the 6 launches of a step. The FP32
// operations, counted once a face (kernel_check.k8_ops_per_cell: 427 a cell
// with PLM), take 0.107 ms at 67 TFLOP/s; solving each face twice doubles
// that, still below the byte bound.
//
// Rounding: every expression keeps the grouping of the JAX package's hlld
// and of the plain version (mhd/sweep.py, hydro/riemann.py); squares are
// single products; P / (gamma - 1) divides by gm1, rounded once on the host.
#include "common.cuh"

namespace qk {

constexpr float HLLD_DELTA = (float)1.0e-4;  // reference src/hydro/HLLD.hpp:15

// Canonical-frame face state: u normal; (v, w) and (by, bz) along the
// (vax, wax) axes of the sweep.
struct MSide {
  float rho, u, v, w, P, by, bz;
};

// Conserved vector, physical flux and star states share this layout; the
// order of the canonical output rows without Eint.
struct MVec {
  float rho, mx, my, mz, E, by, bz;
};

__device__ __forceinline__ float fast_speed(float gamma, const MSide& s, float bx_sq) {
  const float gp = gamma * s.P;
  const float byz_sq = s.by * s.by + s.bz * s.bz;
  const float b_sq = bx_sq + byz_sq;
  const float bgp_p = b_sq + gp;
  const float bgp_m = b_sq - gp;
  return sqrtf((0.5f * (bgp_p + sqrtf(bgp_m * bgp_m + (4.0f * gp) * byz_sq))) / s.rho);
}

__device__ __forceinline__ MVec conserved(const MSide& s, float bx_sq, float gm1, float& pb) {
  pb = 0.5f * (bx_sq + (s.by * s.by + s.bz * s.bz));
  const float ke = (0.5f * s.rho) * (s.u * s.u + (s.v * s.v + s.w * s.w));
  return {s.rho, s.rho * s.u, s.rho * s.v, s.rho * s.w, (ke + pb) + s.P / gm1, s.by, s.bz};
}

// rho u v - Bx By and rho u w - Bx Bz (Miyoshi & Kusano 2005 eq. 2).
__device__ __forceinline__ MVec phys_flux(const MSide& s, const MVec& U, float ptot,
                                          float bx, float bx_sq) {
  return {U.mx,
          (U.mx * s.u + ptot) - bx_sq,
          U.my * s.u - bx * U.by,
          U.mz * s.u - bx * U.bz,
          s.u * ((U.E + ptot) - bx_sq) - bx * (s.v * U.by + s.w * U.bz),
          U.by * s.u - bx * s.v,
          U.bz * s.u - bx * s.w};
}

// Star state of one side (MK05 eqs 43-48) and its v.B.
__device__ __forceinline__ MVec star_state(const MSide& s, const MVec& U, float siui,
                                           float sism, float rho_star, float ptot,
                                           float ptot_star, float S2, float bx,
                                           float bx_sq, float& vb_star) {
  const float denom = (U.rho * siui) * sism - bx_sq;
  const bool degen = fabsf(denom) < HLLD_DELTA * ptot_star;
  const float safe = degen ? 1.0f : denom;
  const float tmp_m = (bx * (siui - sism)) / safe;
  const float my = degen ? rho_star * s.v : rho_star * (s.v - U.by * tmp_m);
  const float mz = degen ? rho_star * s.w : rho_star * (s.w - U.bz * tmp_m);
  const float tmp_b = (U.rho * (siui * siui) - bx_sq) / safe;
  const float by = degen ? U.by : U.by * tmp_b;
  const float bz = degen ? U.bz : U.bz * tmp_b;
  const float mxs = rho_star * S2;
  vb_star = (mxs * bx + (my * by + mz * bz)) / rho_star;
  const float E = (((siui * U.E - ptot * s.u) + ptot_star * S2) +
                   bx * ((s.u * bx + (s.v * U.by + s.w * U.bz)) - vb_star)) / sism;
  return {rho_star, mxs, my, mz, E, by, bz};
}

__device__ __forceinline__ float get(const MVec& a, int k) {
  switch (k) {
    case 0: return a.rho;
    case 1: return a.mx;
    case 2: return a.my;
    case 3: return a.mz;
    case 4: return a.E;
    case 5: return a.by;
    default: return a.bz;
  }
}

// HLLD flux at one face: F[7] = [rho, mx, my, mz, E, by, bz] (canonical).
__device__ __forceinline__ void hlld(const MSide& L, const MSide& R, float bx, float gamma,
                                     float gm1, float F[7]) {
  const float bx_sq = bx * bx;
  float pb_L, pb_R;
  const MVec U_L = conserved(L, bx_sq, gm1, pb_L);
  const MVec U_R = conserved(R, bx_sq, gm1, pb_R);
  const float cf_L = fast_speed(gamma, L, bx_sq);
  const float cf_R = fast_speed(gamma, R, bx_sq);
  const float S0 = mn(L.u - cf_L, R.u - cf_R);
  const float S4 = mx(L.u + cf_L, R.u + cf_R);
  const float ptot_L = L.P + pb_L;
  const float ptot_R = R.P + pb_R;

  if (S0 >= 0.0f || S4 <= 0.0f) {
    const MVec f = S0 >= 0.0f ? phys_flux(L, U_L, ptot_L, bx, bx_sq)
                              : phys_flux(R, U_R, ptot_R, bx, bx_sq);
#pragma unroll
    for (int k = 0; k < 7; ++k) F[k] = get(f, k);
    return;
  }

  const float siui_L = S0 - L.u;
  const float siui_R = S4 - R.u;
  const float S2 = ((siui_R * U_R.mx - siui_L * U_L.mx) + (ptot_L - ptot_R)) /
                   (siui_R * U_R.rho - siui_L * U_L.rho);
  const float sism_L = S0 - S2;
  const float sism_R = S4 - S2;
  const float rho_star_L = (U_L.rho * siui_L) / sism_L;
  const float rho_star_R = (U_R.rho * siui_R) / sism_R;
  const float rs_L = sqrtf(rho_star_L);
  const float rs_R = sqrtf(rho_star_R);
  const float S1 = S2 - fabsf(bx) / rs_L;
  const float S3 = S2 + fabsf(bx) / rs_R;
  const float ptot_star = 0.5f * ((ptot_L - (U_L.rho * siui_L) * (S2 - L.u)) +
                                  (ptot_R - (U_R.rho * siui_R) * (S2 - R.u)));

  if (S1 >= 0.0f || !(S2 >= 0.0f || S3 > 0.0f)) {
    // outer star regions: F*_L = F_L + S0 (U*_L - U_L), F*_R likewise
    const bool left = S1 >= 0.0f;
    float vb_unused;
    const MSide& s = left ? L : R;
    const MVec& U = left ? U_L : U_R;
    const MVec us = left ? star_state(L, U_L, siui_L, sism_L, rho_star_L, ptot_L,
                                      ptot_star, S2, bx, bx_sq, vb_unused)
                         : star_state(R, U_R, siui_R, sism_R, rho_star_R, ptot_R,
                                      ptot_star, S2, bx, bx_sq, vb_unused);
    const MVec f = phys_flux(s, U, left ? ptot_L : ptot_R, bx, bx_sq);
    const float S = left ? S0 : S4;
#pragma unroll
    for (int k = 0; k < 7; ++k) F[k] = get(f, k) + S * (get(us, k) - get(U, k));
    return;
  }

  // double-star regions (Alfven rotations, MK05 eqs 59-63); both star
  // states enter
  float vb_star_L, vb_star_R;
  const MVec us_L = star_state(L, U_L, siui_L, sism_L, rho_star_L, ptot_L, ptot_star, S2,
                               bx, bx_sq, vb_star_L);
  const MVec us_R = star_state(R, U_R, siui_R, sism_R, rho_star_R, ptot_R, ptot_star, S2,
                               bx, bx_sq, vb_star_R);
  const bool bx_near_zero = 0.5f * bx_sq < HLLD_DELTA * ptot_star;
  const float rho_sum_inv = 1.0f / (rs_L + rs_R);
  const float bx_sign = bx > 0.0f ? 1.0f : -1.0f;
  const float vL = us_L.my / us_L.rho, vR = us_R.my / us_R.rho;
  const float wL = us_L.mz / us_L.rho, wR = us_R.mz / us_R.rho;
  const float vdm = rho_sum_inv * ((rs_L * vL + rs_R * vR) + bx_sign * (us_R.by - us_L.by));
  const float wdm = rho_sum_inv * ((rs_L * wL + rs_R * wR) + bx_sign * (us_R.bz - us_L.bz));
  const float byd = rho_sum_inv * ((rs_L * us_R.by + rs_R * us_L.by) +
                                   ((bx_sign * rs_L) * rs_R) * (vR - vL));
  const float bzd = rho_sum_inv * ((rs_L * us_R.bz + rs_R * us_L.bz) +
                                   ((bx_sign * rs_L) * rs_R) * (wR - wL));
  const float vb_d = S2 * bx + (vdm * byd + wdm * bzd);

  const bool left = S2 >= 0.0f;
  const MSide& s = left ? L : R;
  const MVec& U = left ? U_L : U_R;
  const MVec& us = left ? us_L : us_R;
  // E** = E* + sgn_rs sign(bx) (vb** - vb*), sgn_rs = +rs_L / -rs_R
  const float sgn_rs = left ? rs_L : -rs_R;
  const float vb_star = left ? vb_star_L : vb_star_R;
  const MVec ud = bx_near_zero
                      ? us
                      : MVec{us.rho, us.mx, us.rho * vdm, us.rho * wdm,
                             us.E + (sgn_rs * bx_sign) * (vb_d - vb_star), byd, bzd};
  const MVec f = phys_flux(s, U, left ? ptot_L : ptot_R, bx, bx_sq);
  const float S_out = left ? S0 : S4;
  const float S_in = left ? S1 : S3;
#pragma unroll
  for (int k = 0; k < 7; ++k)
    F[k] = get(f, k) + (S_out * (get(us, k) - get(U, k)) + S_in * (get(ud, k) - get(us, k)));
}

struct MhdParams {
  float gamma, gm1, inv_dx, rho_floor, p_floor;
  int order;
};

__device__ __forceinline__ MSide face_side(const float q[7], const MhdParams& p) {
  return {p.rho_floor > 0.0f ? mx(q[0], p.rho_floor) : q[0], q[1], q[2], q[3],
          p.p_floor > 0.0f ? mx(q[4], p.p_floor) : q[4], q[5], q[6]};
}

template <int axis>
__global__ void __launch_bounds__(THREADS)
    mhd_axis_kernel(const float* __restrict__ prim, const float* __restrict__ bxf,
                    float* __restrict__ out, int64_t X, int64_t Y, int64_t Z,
                    MhdParams p) {
  constexpr int vax = axis == 0 ? 1 : (axis == 1 ? 2 : 0);
  constexpr int wax = axis == 0 ? 2 : (axis == 1 ? 0 : 1);
  const int64_t ncell = X * Y * Z;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  int64_t co[3];
  unravel(idx, Y, Z, co);
  const int64_t n = axis == 0 ? X : (axis == 1 ? Y : Z);
  const int64_t stride = axis == 0 ? Y * Z : (axis == 1 ? Z : 1);
  const int64_t base = idx - co[axis] * stride;
  int64_t off[7];
#pragma unroll
  for (int o = 0; o < 7; ++o) {
    bool flip;
    off[o] = base + map_cell(co[axis] - 3 + o, n, BC_PERIODIC, BC_PERIODIC, flip) * stride;
  }
  // the canonical face-state components: rho, u, v, w, P, by, bz
  const int comp[7] = {0, 1 + axis, 1 + vax, 1 + wax, 4, 5 + vax, 5 + wax};
  float qL_lo[7], qR_lo[7], qL_hi[7], qR_hi[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const float* c = prim + comp[k] * ncell;
    const float w[7] = {c[off[0]], c[off[1]], c[off[2]], c[off[3]],
                        c[off[4]], c[off[5]], c[off[6]]};
    line_faces(w, p.order, qL_lo[k], qR_lo[k], qL_hi[k], qR_hi[k]);
  }
  float F_lo[7], F_hi[7];
  hlld(face_side(qL_lo, p), face_side(qR_lo, p), bxf[idx], p.gamma, p.gm1, F_lo);
  hlld(face_side(qL_hi, p), face_side(qR_hi, p), bxf[off[4]], p.gamma, p.gm1, F_hi);
  // canonical [rho, m_ax, m_vax, m_wax, E] -> state rows
  int row[5];
  row[0] = 0;
  row[1] = 1 + axis;
  row[2] = 1 + vax;
  row[3] = 1 + wax;
  row[4] = 4;
#pragma unroll
  for (int k = 0; k < 5; ++k) out[row[k] * ncell + idx] = (F_lo[k] - F_hi[k]) * p.inv_dx;
  out[5 * ncell + idx] = F_lo[0];
  out[6 * ncell + idx] = F_lo[5];
  out[7 * ncell + idx] = F_lo[6];
}

}  // namespace qk

extern "C" int qk_mhd_axis(const float* prim, const float* bxf, float* out, long long X,
                           long long Y, long long Z, int axis, int order, float gamma,
                           float gm1, float inv_dx, float rho_floor, float p_floor,
                           void* stream) {
  const int64_t ncell = (int64_t)X * Y * Z;
  const unsigned blocks = (unsigned)((ncell + qk::THREADS - 1) / qk::THREADS);
  const qk::MhdParams p{gamma, gm1, inv_dx, rho_floor, p_floor, order};
  auto kernel = axis == 0 ? qk::mhd_axis_kernel<0>
                : (axis == 1 ? qk::mhd_axis_kernel<1> : qk::mhd_axis_kernel<2>);
  kernel<<<blocks, qk::THREADS, 0, (cudaStream_t)stream>>>(prim, bxf, out, X, Y, Z, p);
  return (int)cudaGetLastError();
}
