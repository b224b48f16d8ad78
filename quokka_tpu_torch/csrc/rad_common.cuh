// Shared device functions of the radiation kernels K4 (rad_substep.cu), K5
// (rad_source.cu), K6 (rad_sweep.cu) and K7 (rad_axis_flux.cu): the M1 closure and Eddington
// tensor, the per-face HLL flux with its donor-cell fallback, the tiled
// per-axis transport divergence (K4's passes and K6), amendRadState, and
// the per-cell implicit matter coupling.
//
// Layout: the state is [10, X, Y, Z] f32 (6 gas + E, Fx, Fy, Fz of one
// photon group), contiguous, z fastest, as the JAX package keeps it; a
// radiation block is [4, X, Y, Z]. Every axis is periodic and unpadded:
// stencil cells are read through map_cell's wrap (common.cuh).
//
// Rounding: each expression keeps the operation order of the plain PyTorch
// versions (radiation/system.py, radiation/source_terms.py) and of the JAX
// package they mirror; the library is built with -fmad=false and without
// fast math. Python-float constants arrive in RadParams already rounded
// once from their double expressions (chat/c, chat*c, c/chat, 1/dx, ...),
// which is what a Python float does when it meets an f32 tensor.
#pragma once

#include "common.cuh"

namespace qk {

constexpr int NVR = 10;  // state components with one radiation group
constexpr int RS = 6;    // first radiation component
constexpr int MAX_NEWTON_ITER = 100;
constexpr int MAX_OUTER_ITER = 5;
constexpr float A32 = 0.5f;  // IMEX_A32 (exact in f32)

struct Opacity {
  float k0, rho_exp, T_exp;  // kappa = k0 * rho^rho_exp * T^T_exp
};

// Host-built constants, passed by value. Mirrored by a ctypes.Structure in
// radiation/sweep.py: keep the two in the same order.
struct RadParams {
  float c;             // c_light
  float chat;          // reduced speed of light
  float chat_over_c;   // chat / c
  float chat_times_c;  // chat * c
  float cscale;        // c / chat
  float c_times_chat;  // c * chat
  float c_sq;          // c * c
  float arad;          // radiation constant
  float four_arad;     // 4 * arad
  float erad_floor;    // Erad_floor / n_groups
  float c_v;           // EOS specific heat: Eint = rho * c_v * T
  float resid_tol;     // Newton tolerance, max(1e-11, 50 eps_f32)
  float lag_tol;       // work-term lag tolerance 1e-13
  float work_rtol;     // 1e-8
  float inv_dx[3];     // 1 / dx per axis
  Opacity kP, kE, kF;  // Planck, energy-mean, flux-mean
  int beta_order;
  int include_work;    // include_work_term (and beta_order != 0)
  int recon_order;     // 1 donor cell, 2 PLM (minmod), 3 PPM
};

// x^a as registry.power evaluates it: exponents 1, -1, 2 and 1/2 exactly.
__device__ __forceinline__ float ipow(float x, float a) {
  if (a == 1.0f) return x;
  if (a == -1.0f) return 1.0f / x;
  if (a == 2.0f) return x * x;
  if (a == 0.5f) return sqrtf(x);
  return powf(x, a);
}

__device__ __forceinline__ float opacity(const Opacity& o, float rho, float T) {
  float k = o.k0;
  if (o.rho_exp != 0.0f) k = k * ipow(rho, o.rho_exp);
  if (o.T_exp != 0.0f) k = k * ipow(T, o.T_exp);
  return k;
}

__device__ __forceinline__ float pow4(float x) { return (x * x) * (x * x); }

// Levermore 1984 closure chi as a function of f^2
// (system.eddington_factor_sq).
__device__ __forceinline__ float edd_factor_sq(float f2) {
  f2 = mn(mx(f2, 0.0f), 1.0f);
  const float f_fac = sqrtf(4.0f - 3.0f * f2);
  return (3.0f + 4.0f * f2) / (5.0f + 2.0f * f_fac);
}

// Row `row` of the Eddington tensor (system.eddington_tensor; every element
// is computed on its own there, so a row equals the full tensor's row).
__device__ __forceinline__ void eddington_row(const float f[3], int row,
                                              float out[3]) {
  const float f2 = (f[0] * f[0] + f[1] * f[1]) + f[2] * f[2];
  const float chi = edd_factor_sq(f2);
  const float Tdiag = 0.5f * (1.0f - chi);
  const float tf = f2 > 0.0f ? (0.5f * (3.0f * chi - 1.0f)) / f2 : 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    out[j] = Tdiag * (row == j ? 1.0f : 0.0f) + (tf * f[row]) * f[j];
}

// One side of a face after the admissibility test: the reconstructed (E, f)
// state, or the donor cell's conserved state where E <= 0 or |f|^2 >= 1.
struct RadSide {
  float erad, F[3], f[3];
};

__device__ __forceinline__ RadSide unpack_side(const float q[4],
                                               const float cons[4], float c) {
  RadSide s;
  const float f2 = (q[1] * q[1] + q[2] * q[2]) + q[3] * q[3];
  const bool bad = (q[0] <= 0.0f) || (f2 >= 1.0f);
  s.erad = bad ? cons[0] : q[0];
#pragma unroll
  for (int k = 0; k < 3; ++k) s.F[k] = bad ? cons[1 + k] : (q[1 + k] * c) * q[0];
  const float inv_cE = 1.0f / (c * s.erad);
#pragma unroll
  for (int k = 0; k < 3; ++k) s.f[k] = s.F[k] * inv_cE;
  return s;
}

// HLL flux of one photon group at one face along `axis`
// (system._hll_group_flux): frozen-Eddington transport flux on each side,
// wave speeds -s_L chat and +s_R chat with s = max(0.1, sqrt(T_nn)).
template <int axis>
__device__ __forceinline__ void hll_face(const float qL[4], const float qR[4],
                                         const float cL[4], const float cR[4],
                                         const RadParams& p, float out[4]) {
  const RadSide L = unpack_side(qL, cL, p.c);
  const RadSide R = unpack_side(qR, cR, p.c);
  float rowL[3], rowR[3];
  eddington_row(L.f, axis, rowL);
  eddington_row(R.f, axis, rowR);
  float FL[4] = {L.F[axis], rowL[0] * L.erad, rowL[1] * L.erad, rowL[2] * L.erad};
  float FR[4] = {R.F[axis], rowR[0] * R.erad, rowR[1] * R.erad, rowR[2] * R.erad};
  const float sL = mx(sqrtf(rowL[axis]), 0.1f);
  const float sR = mx(sqrtf(rowR[axis]), 0.1f);
  FL[0] = FL[0] * p.chat_over_c;
  FR[0] = FR[0] * p.chat_over_c;
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    FL[k] = FL[k] * p.chat_times_c;
    FR[k] = FR[k] * p.chat_times_c;
  }
  const float UL[4] = {L.erad, L.F[0], L.F[1], L.F[2]};
  const float UR[4] = {R.erad, R.F[0], R.F[1], R.F[2]};
  const float inv = 1.0f / (sR + sL);
  const float wL = sR * inv;
  const float wR = sL * inv;
  const float wD = ((sR * sL) * inv) * p.chat;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[k] = (wL * FL[k] + wR * FR[k]) - wD * (UR[k] - UL[k]);
}

// The transport divergence along one axis (K4's three passes a stage, K6's
// launch an axis): a tile of TR_TA cells along the axis by TR_TW lines
// across it a block (the lines run along z, the contiguous axis, for the x
// and y sweeps and along y for the z sweep; the third coordinate is fixed),
// in four phases separated by __syncthreads:
//   1. stage cells -3 .. TR_TA + 2 (the periodic wrap resolved once a cell
//      staged): the 4 conserved values and the primitives, f = F / (c E);
//   2. the face states (minus, plus) of cells -1 .. TR_TA, once a cell;
//   3. the HLL flux of faces 0 .. TR_TA (face f between cells f - 1 and f)
//      from qL = plus(f - 1), qR = minus(f), in the primitives' place;
//   4. each cell's (F(lo) - F(hi)) * inv_dx, written to div (`first`) or
//      added onto it (the JAX order of the axes' sum: ((x + y) + z)).
// The formulas and their order are those of the one-thread-a-cell kernel
// the tile replaced (which solved each face twice and reconstructed each
// cell three times an axis), so the outputs are its bits.
constexpr int TR_THREADS = 256;
constexpr int TR_TA = 32;         // cells along the axis a block
constexpr int TR_TW = 16;         // lines across it
constexpr int TR_SA = TR_TA + 6;  // staged cells along the axis
constexpr int TR_RA = TR_TA + 2;  // reconstructed cells
constexpr int TR_FA = TR_TA + 1;  // faces

// Shared-memory index of (along j, across i) in a [n_along][TR_TW] tile:
// the contiguous global axis is the fastest one in shared memory too.
template <int axis, int n_along>
__device__ __forceinline__ int pidx(int j, int i) {
  return axis == 2 ? i * n_along + j : j * TR_TW + i;
}

template <int axis, int n_along>
__device__ __forceinline__ void ppos(int e, int& j, int& i) {
  if (axis == 2) {
    j = e % n_along;
    i = e / n_along;
  } else {
    j = e / TR_TW;
    i = e % TR_TW;
  }
}

// Blocks of one axis's transport pass over X x Y x Z.
inline long long transport_tiles(int axis, long long X, long long Y, long long Z) {
  const long long n = axis == 0 ? X : (axis == 1 ? Y : Z);
  const long long n_across = axis == 2 ? Y : Z;
  const long long fixed = axis == 0 ? Y : X;
  return (n + TR_TA - 1) / TR_TA * ((n_across + TR_TW - 1) / TR_TW) * fixed;
}

// One block of the transport pass along `axis` of the radiation block R
// [4, X, Y, Z] into div [4, X, Y, Z] (see above).
template <int axis>
__device__ __forceinline__ void transport_axis_tile(const float* __restrict__ R,
                                                    float* __restrict__ div, int X, int Y,
                                                    int Z, int first, const RadParams& p) {
  __shared__ float cons_s[4][TR_SA * TR_TW];
  __shared__ float pf_s[4][TR_SA * TR_TW];  // primitives, then the face fluxes
  __shared__ float minus_s[4][TR_RA * TR_TW];
  __shared__ float plus_s[4][TR_RA * TR_TW];

  const int64_t ncell = (int64_t)X * Y * Z;
  const int n = axis == 0 ? X : (axis == 1 ? Y : Z);
  const int n_across = axis == 2 ? Y : Z;
  const int64_t stride_a = axis == 0 ? (int64_t)Y * Z : (axis == 1 ? Z : 1);
  const int64_t stride_c = axis == 2 ? Z : 1;
  const int64_t stride_f = axis == 0 ? Z : (int64_t)Y * Z;
  const int tiles_a = (n + TR_TA - 1) / TR_TA;
  const int tiles_c = (n_across + TR_TW - 1) / TR_TW;
  int t = blockIdx.x;
  const int ta = t % tiles_a;
  t /= tiles_a;
  const int tc = t % tiles_c;
  const int fixed = t / tiles_c;
  const int a0 = ta * TR_TA;
  const int c0 = tc * TR_TW;
  const int cells = min(TR_TA, n - a0);
  const int lines = min(TR_TW, n_across - c0);
  const int64_t base = fixed * stride_f + c0 * stride_c;

  // 1. stage cells a0-3 .. a0+cells+2
  for (int e = threadIdx.x; e < TR_SA * TR_TW; e += TR_THREADS) {
    int j, i;
    ppos<axis, TR_SA>(e, j, i);
    if (j >= cells + 6 || i >= lines) continue;
    int a = a0 - 3 + j;  // |wrap| < n: n >= 4
    a = a < 0 ? a + n : (a >= n ? a - n : a);
    const int64_t off = base + a * stride_a + i * stride_c;
    const int s = pidx<axis, TR_SA>(j, i);
    float c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = R[k * ncell + off];
    const float cE = p.c * c[0];
    cons_s[0][s] = c[0];
    pf_s[0][s] = c[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      cons_s[k][s] = c[k];
      pf_s[k][s] = c[k] / cE;
    }
  }
  __syncthreads();

  // 2. face states of cells a0-1 .. a0+cells (slot r, staged j = r + 2)
  for (int e = threadIdx.x; e < TR_RA * TR_TW; e += TR_THREADS) {
    int r, i;
    ppos<axis, TR_RA>(e, r, i);
    if (r > cells + 1 || i >= lines) continue;
    const int o = pidx<axis, TR_RA>(r, i);
    constexpr int sa = axis == 2 ? 1 : TR_TW;  // staged neighbour along the axis
    const int s = pidx<axis, TR_SA>(r + 2, i);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* w = pf_s[k] + s;
      float m, pl;
      if (p.recon_order == 3) {
        ppm_cell(w[-2 * sa], w[-sa], w[0], w[sa], w[2 * sa], m, pl);
      } else if (p.recon_order == 2) {
        const float slope = minmod(w[sa] - w[0], w[0] - w[-sa]);
        pl = w[0] + 0.5f * slope;
        m = w[0] - 0.5f * slope;
      } else {
        m = w[0];
        pl = w[0];
      }
      minus_s[k][o] = m;
      plus_s[k][o] = pl;
    }
  }
  __syncthreads();

  // 3. the HLL flux of faces a0 .. a0+cells; no thread reads the primitives
  // any more, so the fluxes take their place
  for (int e = threadIdx.x; e < TR_FA * TR_TW; e += TR_THREADS) {
    int f, i;
    ppos<axis, TR_FA>(e, f, i);
    if (f > cells || i >= lines) continue;
    // face f lies between reconstructed cells f and f+1 (staged f+2, f+3)
    const int oL = pidx<axis, TR_RA>(f, i);
    const int oR = pidx<axis, TR_RA>(f + 1, i);
    const int sL = pidx<axis, TR_SA>(f + 2, i);
    const int sR = pidx<axis, TR_SA>(f + 3, i);
    float qL[4], qR[4], cL[4], cR[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      qL[k] = plus_s[k][oL];
      qR[k] = minus_s[k][oR];
      cL[k] = cons_s[k][sL];
      cR[k] = cons_s[k][sR];
    }
    float F[4];
    hll_face<axis>(qL, qR, cL, cR, p, F);
    const int o = pidx<axis, TR_FA>(f, i);
#pragma unroll
    for (int k = 0; k < 4; ++k) pf_s[k][o] = F[k];
  }
  __syncthreads();

  // 4. (F(lo) - F(hi)) * inv_dx of cells a0 .. a0+cells-1
  for (int e = threadIdx.x; e < TR_TA * TR_TW; e += TR_THREADS) {
    int c, i;
    ppos<axis, TR_TA>(e, c, i);
    if (c >= cells || i >= lines) continue;
    const int64_t off = base + (a0 + c) * stride_a + i * stride_c;
    const int lo = pidx<axis, TR_FA>(c, i), hi = pidx<axis, TR_FA>(c + 1, i);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float d = (pf_s[k][lo] - pf_s[k][hi]) * p.inv_dx[axis];
      div[k * ncell + off] = first ? d : div[k * ncell + off] + d;
    }
  }
}

// amendRadState (system.amend_rad_state): E >= floor, |F| <= c E.
__device__ __forceinline__ void amend(float R[4], const RadParams& p) {
  const float E = mx(R[0], p.erad_floor);
  const float Fnorm = sqrtf((R[1] * R[1] + R[2] * R[2]) + R[3] * R[3]);
  const float Fmax = p.c * E;
  const float scale = Fnorm > Fmax ? Fmax / (Fnorm > 0.0f ? Fnorm : 1.0f) : 1.0f;
  R[0] = E;
#pragma unroll
  for (int k = 1; k < 4; ++k) R[k] = R[k] * scale;
}

// ---------------------------------------------------------------- K5 body

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

struct NewtonOut {
  float Egas, Erad, R, work, kP, kE, kF, fourPiB;
};

// True when no opacity law depends on T (every T_exp is 0): then kP, kE,
// kF, kP / kE, tau and the Jacobian's J11 are the same at every Newton
// iteration, and `newton<true>` computes them once a cell.
__host__ __device__ __forceinline__ bool constant_opacity(const RadParams& p) {
  return p.kP.T_exp == 0.0f && p.kE.T_exp == 0.0f && p.kF.T_exp == 0.0f;
}

// Newton-Raphson in (Egas, R) for one cell
// (source_terms._newton_energy_exchange); stops when this cell converges.
// kConstOpacity (`constant_opacity`): the T-independent quantities are
// hoisted out of the loop. They are computed by the very same operations
// as the loop would repeat, so both forms give the same bits.
template <bool kConstOpacity>
__device__ __forceinline__ NewtonOut newton(float Egas0, float Erad0,
                                            float rho, const float mom0[3],
                                            const float Frad0[3], float Src,
                                            float Etot0, float dt,
                                            bool has_work, float work_init,
                                            const RadParams& p) {
  const float cv_rho = rho * p.c_v;  // eint_temp_derivative
  float T = Egas0 / cv_rho;          // tgas_from_eint
  float fourPiB = p.arad * pow4(T);
  float kP = opacity(p.kP, rho, T);
  float kE = opacity(p.kE, rho, T);
  const float kF0 = opacity(p.kF, rho, T);
  float kPoE = kE > 0.0f ? kP / kE : 1.0f;
  float work;
  if (has_work)
    work = work_init;
  else if (p.beta_order != 0 && p.include_work)
    work = (((dot3(mom0, Frad0) * (2.0f * kE - kF0)) * p.chat) / p.c_sq) * dt;
  else
    work = 0.0f;
  float tau = ((dt * rho) * kP) * p.chat;
  float R = (fourPiB - Erad0 / kPoE) * tau + work;
  float Egas = Egas0, Erad = Erad0;
  // -1e100 of the JAX package is -inf in float32
  const float J11_const =
      kConstOpacity ? (tau > 0.0f ? -kPoE / tau - 1.0f : -__int_as_float(0x7f800000))
                    : 0.0f;
  for (int it = 0; it < MAX_NEWTON_ITER; ++it) {
    const float F_G = (Egas - Egas0) + p.cscale * R;
    const float F_D = (Erad - Erad0) - (R + Src);
    const float F_D_abs = tau > 0.0f ? fabsf(F_D) : fabsf(F_D + R);
    if ((fabsf(F_G) < p.resid_tol * Etot0) &&
        (p.cscale * F_D_abs < p.resid_tol * Etot0))
      break;
    const float d_fourpiB_dT = p.four_arad * (T * (T * T));
    const float dEg_dT = kPoE * d_fourpiB_dT;
    const float J00 = 1.0f;
    const float J01 = p.cscale;
    const float J10 = dEg_dT / cv_rho;
    const float J11 = kConstOpacity ? J11_const
                      : (tau > 0.0f ? -kPoE / tau - 1.0f : -__int_as_float(0x7f800000));
    const float det = J00 * J11 - J01 * J10;
    const float y0 = -F_G;
    const float y1 = -F_D;
    const float dEgas = (J11 * y0 - J01 * y1) / det;
    const float dR = (J00 * y1 - J10 * y0) / det;
    // enable_dE_constrain: a jump beyond max(T_gas, T_rad) takes T_rad
    const float T_rad = sqrtf(sqrtf(mx(Erad, 0.0f) / p.arad));
    const bool constrain = dEgas / cv_rho > mx(T, T_rad);
    const float Egas_new = constrain ? cv_rho * T_rad : Egas + dEgas;
    const float R_new = constrain ? R : R + dR;
    const float T_new = Egas_new / cv_rho;
    const float fourPiB_new = p.arad * pow4(T_new);
    if (!kConstOpacity) {
      kP = opacity(p.kP, rho, T_new);
      kE = opacity(p.kE, rho, T_new);
      kPoE = kE > 0.0f ? kP / kE : 1.0f;
      tau = ((dt * rho) * kP) * p.chat;
    }
    Erad = tau > 0.0f ? kPoE * (fourPiB_new - (R_new - work) / tau) : Erad;
    Egas = Egas_new;
    R = R_new;
    T = T_new;
    fourPiB = fourPiB_new;
  }
  return {Egas, Erad, R, work, kP, kE, kConstOpacity ? kF0 : opacity(p.kF, rho, T),
          fourPiB};
}

// Implicit flux update + momentum deposition (source_terms flux_update).
__device__ __forceinline__ void flux_update(const NewtonOut& nw, float rho,
                                            const float mom0[3],
                                            const float Frad0[3], float dt,
                                            const RadParams& p,
                                            float Frad_t1[3], float dMom[3]) {
  if (p.beta_order != 0) {
    const float erad = nw.Erad;
    const float f[3] = {Frad0[0] / (p.c * erad), Frad0[1] / (p.c * erad),
                        Frad0[2] / (p.c * erad)};
    const float F_coeff = ((p.chat * rho) * nw.kF) * dt;
    const float Planck_term = nw.kP * nw.fourPiB + (nw.kF - nw.kE) * erad;
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      float T[3];
      eddington_row(f, n, T);
      const float p_term = ((Planck_term * p.chat) * dt) * mom0[n];
      float pressure_term = 0.0f;
#pragma unroll
      for (int z = 0; z < 3; ++z) pressure_term = pressure_term + (mom0[z] * T[z]) * erad;
      pressure_term = ((pressure_term * p.chat) * dt) * nw.kF;
      Frad_t1[n] = ((Frad0[n] + p_term) + pressure_term) / (1.0f + F_coeff);
    }
  } else {
    const float denom = 1.0f + ((rho * nw.kF) * p.chat) * dt;
#pragma unroll
    for (int n = 0; n < 3; ++n) Frad_t1[n] = Frad0[n] / denom;
  }
#pragma unroll
  for (int n = 0; n < 3; ++n) dMom[n] = -(Frad_t1[n] - Frad0[n]) / p.c_times_chat;
}

__device__ __forceinline__ float work_term(const float mom0[3],
                                           const float Frad[3],
                                           const float dMom[3], float kE,
                                           float kF, float dt,
                                           const RadParams& p) {
  const float mom1[3] = {mom0[0] + dMom[0], mom0[1] + dMom[1], mom0[2] + dMom[2]};
  return (((dot3(mom1, Frad) * p.chat) / p.c_sq) * (2.0f * kE - kF)) * dt;
}

__device__ __forceinline__ bool lag_converged(float work_new, float work_old,
                                              float R, float Etot0,
                                              const RadParams& p) {
  const float dwork = fabsf(work_new - work_old);
  return (fabsf(work_new) == 0.0f) || (p.cscale * dwork < p.lag_tol * Etot0) ||
         (dwork <= p.lag_tol * fabsf(R)) || (dwork <= p.work_rtol * fabsf(work_new));
}

// The implicit matter coupling of one cell, in place on its NVR values
// (source_terms.add_source_terms_single_group, non-isothermal): Newton
// solve, implicit flux update, and the lagged work-term outer loop, each
// stopping when this cell converges.
template <bool kConstOpacity>
__device__ __forceinline__ void source_cell(float u[NVR], float Src_rate,
                                            bool has_src, float dt_radiation,
                                            int stage, const RadParams& p) {
  const float dt = stage == 1 ? dt_radiation : (1.0f - A32) * dt_radiation;
  const float guf = stage == 1 ? A32 : 1.0f;
  const float rho = u[0];
  const float mom0[3] = {u[1], u[2], u[3]};
  const float Erad0 = u[RS];
  const float Frad0[3] = {u[RS + 1], u[RS + 2], u[RS + 3]};
  const float Src = has_src ? (Src_rate * dt) * p.chat : 0.0f;
  const float ke0 = (0.5f * dot3(mom0, mom0)) / rho;
  const float Egas0 = u[4] - ke0;
  const float Etot0 = Egas0 + p.cscale * (Erad0 + Src);

  const NewtonOut nw = newton<kConstOpacity>(Egas0, Erad0, rho, mom0, Frad0, Src,
                                             Etot0, dt, false, 0.0f, p);
  float Egas_g = nw.Egas, Erad_g = nw.Erad, R = nw.R, work = nw.work;
  float Frad_t1[3], dMom[3];
  flux_update(nw, rho, mom0, Frad0, dt, p, Frad_t1, dMom);
  if (p.beta_order != 0 && p.include_work) {
    const float work_i = work_term(mom0, Frad_t1, dMom, nw.kE, nw.kF, dt, p);
    bool done = lag_converged(work_i, work, R, Etot0, p);
    if (!done) work = work_i;
    for (int ite = 1; ite < MAX_OUTER_ITER && !done; ++ite) {
      const NewtonOut n2 = newton<kConstOpacity>(Egas0, Erad0, rho, mom0, Frad0, Src,
                                                 Etot0, dt, true, work, p);
      float Fn[3], dMn[3];
      flux_update(n2, rho, mom0, Frad0, dt, p, Fn, dMn);
      const float work_new = work_term(mom0, Fn, dMn, n2.kE, n2.kF, dt, p);
      done = lag_converged(work_new, work, n2.R, Etot0, p);
      Egas_g = n2.Egas;
      Erad_g = n2.Erad;
      R = n2.R;
      work = work_new;
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        Frad_t1[n] = Fn[n];
        dMom[n] = dMn[n];
      }
    }
  }

  float mom1[3];
#pragma unroll
  for (int n = 0; n < 3; ++n) mom1[n] = mom0[n] + dMom[n] * guf;
  const float Egas_final = Egas0 + (Egas_g - Egas0) * guf;
  const float ke1 = (0.5f * dot3(mom1, mom1)) / rho;
#pragma unroll
  for (int n = 0; n < 3; ++n) u[1 + n] = mom1[n];
  u[5] = Egas_final;
  u[4] = Egas_final + ke1;
  u[RS] = Erad_g;
#pragma unroll
  for (int n = 0; n < 3; ++n) u[RS + 1 + n] = Frad_t1[n];
}

}  // namespace qk
