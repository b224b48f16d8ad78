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
// Design: a shared-memory tile, as K7 and K2's face kernel. A block owns
// ta cells along the axis by tw lines across it (`mhd.sweep.k8_tile`: up
// to 16 lines, 64 B of a row, and up to 512 faces, 29 x 16 at 256^3; the
// lines run along z, the contiguous axis, for the x and y sweeps and along
// y for the z sweep) and, in four
// phases separated by __syncthreads, 1. stages the 7 canonical primitives
// of the cells its faces read (g = 2, 1, 0 cells beyond the faces' two for
// PPM, PLM, donor cell; the one along the axis is the staggered bxf
// instead, staged at the ta + 1 faces), each loaded once through the
// periodic index map with neighbouring threads on neighbouring addresses;
// 2. forms both face states (minus, plus) of each of the ta + 2 cells the
// faces touch once per component (PPM, PLM or donor cell, as K7);
// 3. solves HLLD once at each of the ta + 1 faces, qL = plus(f-1), qR =
// minus(f), with the floors on both states, into shared memory over the
// staged primitives (only the tile's hi face is solved again, by the next
// tile); 4. writes each cell's 8 rows, one thread a cell. The form this
// replaces, one thread a cell, solved every face twice (HLLD, ~315 FP32
// operations and 6 IEEE divisions and square roots a face, is the most
// expensive Riemann solver in the repository) and made 49 strided loads a
// cell; its note argued that solving twice beat a face round trip through
// device memory, but the tile keeps the faces in shared memory and so
// avoids both. __launch_bounds__(256, 4) holds a thread to 64 registers
// (a few bytes spill), so 32 warps fit a multiprocessor where 80
// registers gave 24: 12% faster on Orszag-Tang (PERF.md).
//
// Bound on the H100 at 256^3: bytes on paper. 32 B read a cell (7
// primitives and bxf) and 32 B written, 1.07 GB an axis: 0.320 ms at 3.35
// TB/s, 1.92 ms for the 6 launches of a step. The FP32 operations, counted
// once a face (kernel_check.k8_ops_per_cell: 427 a cell with PLM), take
// 0.107 ms at 67 TFLOP/s; in practice HLLD's dependent divisions and
// square roots under -fmad=false bound it by instruction latency, which
// the tile halves by solving each face once.
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

// Field-wise selects: a reference bound to one of two structs (`c ? a :
// b`) puts both in local memory; these keep them in registers.
__device__ __forceinline__ MSide pick(bool c, const MSide& a, const MSide& b) {
  return {c ? a.rho : b.rho, c ? a.u : b.u, c ? a.v : b.v, c ? a.w : b.w,
          c ? a.P : b.P,     c ? a.by : b.by, c ? a.bz : b.bz};
}
__device__ __forceinline__ MVec pick(bool c, const MVec& a, const MVec& b) {
  return {c ? a.rho : b.rho, c ? a.mx : b.mx, c ? a.my : b.my, c ? a.mz : b.mz,
          c ? a.E : b.E,     c ? a.by : b.by, c ? a.bz : b.bz};
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
    const bool left = S0 >= 0.0f;
    const MVec f = phys_flux(pick(left, L, R), pick(left, U_L, U_R),
                             left ? ptot_L : ptot_R, bx, bx_sq);
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
    const MSide s = pick(left, L, R);
    const MVec U = pick(left, U_L, U_R);
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
  const MSide s = pick(left, L, R);
  const MVec U = pick(left, U_L, U_R);
  const MVec us = pick(left, us_L, us_R);
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

constexpr int K8_THREADS = 256;

// Shared-memory floats of a K8 tile of ta cells by tw lines at
// reconstruction order `order`: the 7 staged primitives of ta + 2 + 2g
// cells a line (g = 2, 1, 0 for PPM, PLM, donor cell), both face states of
// the ta + 2 reconstructed cells, and bxf at the ta + 1 faces. The face
// fluxes (7 a face) overwrite the staged primitives after phase 2.
__host__ __device__ __forceinline__ int mhd_smem_floats(int ta, int tw, int order) {
  const int g = order == 3 ? 2 : (order == 2 ? 1 : 0);
  return 7 * (ta + 2 + 2 * g) * tw + 14 * (ta + 2) * tw + (ta + 1) * tw;
}

// K8 (see the header): a block owns ta cells by tw lines of the periodic
// state; 1. stages the 7 canonical primitives of the cells its faces read
// and bxf at its ta + 1 faces; 2. forms both face states of each cell the
// faces touch once; 3. solves each face once (HLLD, the floors on both
// states) into shared memory; 4. one thread a cell writes its 8 rows.
template <int axis>
__global__ void __launch_bounds__(K8_THREADS, 4)
    mhd_tile_kernel(const float* __restrict__ prim, const float* __restrict__ bxf,
                    float* __restrict__ out, int64_t X, int64_t Y, int64_t Z, int ta,
                    int tw, MhdParams p) {
  constexpr int vax = axis == 0 ? 1 : (axis == 1 ? 2 : 0);
  constexpr int wax = axis == 0 ? 2 : (axis == 1 ? 0 : 1);
  extern __shared__ float smem[];
  const int64_t ncell = X * Y * Z;
  const int64_t n = axis == 0 ? X : (axis == 1 ? Y : Z);
  const int64_t n_across = axis == 2 ? Y : Z;
  const int64_t stride_a = axis == 0 ? Y * Z : (axis == 1 ? Z : 1);
  const int64_t stride_c = axis == 2 ? Z : 1;
  const int64_t stride_f = axis == 1 ? Y * Z : (axis == 0 ? Z : Y * Z);
  const int64_t tiles_a = (n + ta - 1) / ta;
  const int64_t tiles_c = (n_across + tw - 1) / tw;
  int64_t b = blockIdx.x;
  const int64_t a0 = (b % tiles_a) * ta;
  b /= tiles_a;
  const int64_t c0 = (b % tiles_c) * tw;
  const int64_t base = (b / tiles_c) * stride_f + c0 * stride_c;
  const int cells = (int)min((int64_t)ta, n - a0);
  const int lines = (int)min((int64_t)tw, n_across - c0);
  const int g = p.order == 3 ? 2 : (p.order == 2 ? 1 : 0);
  const int nf = cells + 1, nr = cells + 2, ns = cells + 2 + 2 * g;
  const int cap_s = (ta + 2 + 2 * g) * tw, cap_r = (ta + 2) * tw, cap_f = (ta + 1) * tw;
  float* prim_s = smem;                // [7][cap_s]; then the face fluxes [7][cap_f]
  float* qm_s = prim_s + 7 * cap_s;    // [7][cap_r]
  float* qp_s = qm_s + 7 * cap_r;      // [7][cap_r]
  float* bx_s = qp_s + 7 * cap_r;      // [cap_f]
  // the canonical face-state components: rho, u, v, w, P, by, bz
  const int comp[7] = {0, 1 + axis, 1 + vax, 1 + wax, 4, 5 + vax, 5 + wax};

  // 1. cells a0-1-g .. a0+cells+g (the periodic wrap resolved once a cell),
  // and bxf at faces a0 .. a0+cells (the lo faces of cells a0 .. a0+cells)
  for (int el = threadIdx.x; el < ns * lines; el += K8_THREADS) {
    int j, i;
    tpos<axis>(el, ns, lines, j, i);
    int64_t a = a0 - 1 - g + j;  // |wrap| < n: n >= 4
    a = a < 0 ? a + n : (a >= n ? a - n : a);
    const int64_t off = base + i * stride_c + a * stride_a;
    const int s = tix<axis>(j, i, ns, lines);
#pragma unroll
    for (int k = 0; k < 7; ++k) prim_s[k * cap_s + s] = prim[comp[k] * ncell + off];
  }
  for (int el = threadIdx.x; el < nf * lines; el += K8_THREADS) {
    int j, i;
    tpos<axis>(el, nf, lines, j, i);
    int64_t a = a0 + j;
    a = a >= n ? a - n : a;
    bx_s[tix<axis>(j, i, nf, lines)] = bxf[base + i * stride_c + a * stride_a];
  }
  __syncthreads();

  // 2. (minus, plus) of cells a0-1 .. a0+cells (staged r + g)
  for (int el = threadIdx.x; el < nr * lines; el += K8_THREADS) {
    int r, i;
    tpos<axis>(el, nr, lines, r, i);
    const int o = tix<axis>(r, i, nr, lines);
    const int s = tix<axis>(r + g, i, ns, lines);
    const int sa = axis == 2 ? 1 : lines;  // staged neighbour along the axis
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const float* w = prim_s + k * cap_s + s;
      float m, pl;
      if (p.order == 3) {
        ppm_cell(w[-2 * sa], w[-sa], w[0], w[sa], w[2 * sa], m, pl);
      } else if (p.order == 2) {
        const float slope = minmod(w[sa] - w[0], w[0] - w[-sa]);
        pl = w[0] + 0.5f * slope;
        m = w[0] - 0.5f * slope;
      } else {
        m = w[0];
        pl = w[0];
      }
      qm_s[k * cap_r + o] = m;
      qp_s[k * cap_r + o] = pl;
    }
  }
  __syncthreads();

  // 3. HLLD at faces a0 .. a0+cells: face fa lies between reconstructed
  // cells fa (its plus state) and fa+1 (its minus state); the fluxes go
  // where the staged primitives were (nothing reads them after phase 2)
  float* F_s = prim_s;
  for (int el = threadIdx.x; el < nf * lines; el += K8_THREADS) {
    int fa, i;
    tpos<axis>(el, nf, lines, fa, i);
    const int oL = tix<axis>(fa, i, nr, lines);
    const int oR = tix<axis>(fa + 1, i, nr, lines);
    float qL[7], qR[7], F[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      qL[k] = qp_s[k * cap_r + oL];
      qR[k] = qm_s[k * cap_r + oR];
    }
    const int o = tix<axis>(fa, i, nf, lines);
    hlld(face_side(qL, p), face_side(qR, p), bx_s[o], p.gamma, p.gm1, F);
#pragma unroll
    for (int k = 0; k < 7; ++k) F_s[k * cap_f + o] = F[k];
  }
  __syncthreads();

  // 4. one thread a cell: canonical [rho, m_ax, m_vax, m_wax, E] -> state
  // rows (F_lo - F_hi) * inv_dx, then the lo face's mass and induction
  // fluxes
  const int row[5] = {0, 1 + axis, 1 + vax, 1 + wax, 4};
  for (int el = threadIdx.x; el < cells * lines; el += K8_THREADS) {
    int r, i;
    tpos<axis>(el, cells, lines, r, i);
    const int64_t idx = base + i * stride_c + (a0 + r) * stride_a;
    const int oL = tix<axis>(r, i, nf, lines);
    const int oH = tix<axis>(r + 1, i, nf, lines);
#pragma unroll
    for (int k = 0; k < 5; ++k)
      out[row[k] * ncell + idx] = (F_s[k * cap_f + oL] - F_s[k * cap_f + oH]) * p.inv_dx;
    out[5 * ncell + idx] = F_s[oL];
    out[6 * ncell + idx] = F_s[5 * cap_f + oL];
    out[7 * ncell + idx] = F_s[6 * cap_f + oL];
  }
}

}  // namespace qk

extern "C" int qk_mhd_smem(int ta, int tw, int order) {
  return (int)sizeof(float) * qk::mhd_smem_floats(ta, tw, order);
}

extern "C" int qk_mhd_axis(const float* prim, const float* bxf, float* out, long long X,
                           long long Y, long long Z, int axis, int order, int ta, int tw,
                           float gamma, float gm1, float inv_dx, float rho_floor,
                           float p_floor, void* stream) {
  const long long n = axis == 0 ? X : (axis == 1 ? Y : Z);
  const long long n_across = axis == 2 ? Y : Z;
  const long long fixed = axis == 0 ? Y : X;
  const long long tiles = ((n + ta - 1) / ta) * ((n_across + tw - 1) / tw) * fixed;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const qk::MhdParams p{gamma, gm1, inv_dx, rho_floor, p_floor, order};
  auto kernel = axis == 0 ? qk::mhd_tile_kernel<0>
                : (axis == 1 ? qk::mhd_tile_kernel<1> : qk::mhd_tile_kernel<2>);
  const int smem = qk_mhd_smem(ta, tw, order);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)tiles, qk::K8_THREADS, smem, (cudaStream_t)stream>>>(
      prim, bxf, out, X, Y, Z, ta, tw, p);
  return (int)cudaGetLastError();
}
