// Shared device helpers for the hydro kernels (K1 transverse.cu, K2 sweep.cu,
// K3 apply.cu); the radiation kernels (K4-K7, rad_common.cuh) take the index
// map, the NaN-propagating min/max, PPM and minmod from here, the MHD sweep
// (K8, mhd_sweep.cu) the min/max, PPM, minmod and, with K2, the
// shared-memory tile index (`tix`, `tpos`).
//
// Layout: the state is [6, X, Y, Z] f32, contiguous, z fastest, exactly as
// the JAX package keeps it; K2 and K3 also take passive scalars after the
// 6 gas components ([6 + nsc, X, Y, Z]), which K1 never reads. All offsets
// are 64-bit: 6 x 1024^3 elements already overflow int32.
//
// Rounding: every expression keeps the operation order of the JAX package
// and of the plain PyTorch versions in hydro/sweep.py. The library is built
// with -fmad=false and without fast math (IEEE division and sqrtf), so each
// product and sum is rounded on its own, as each PyTorch op rounds its
// result. Scalar constants are double expressions cast to float, which is
// what a Python float does when it meets an f32 tensor.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qk {

constexpr int NV = 6;  // RHO, MX1, MX2, MX3, EGAS, EINT
constexpr int BC_PERIODIC = 0;
constexpr int BC_REFLECT = 1;
constexpr int BC_OUTFLOW = 2;
constexpr int THREADS = 256;

// Gamma-law constants, each rounded once from its double expression.
struct Eos {
  float gamma;    // gamma
  float gm1;      // gamma - 1
  float inv_gm1;  // 1 / (gamma - 1)
  float s_n;      // 0.5 * (gamma + 1) / 2: Rider wavespeed correction factor
  int reconstruct_eint;
};

// NaN-propagating min/max (jnp.minimum / torch.minimum semantics; fminf
// would drop a NaN operand), one instruction each: min.NaN / max.NaN return
// the canonical NaN if either operand is NaN and equal min.f32 / max.f32
// (fminf / fmaxf) otherwise.
__device__ __forceinline__ float mn(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float mx(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float sgn(float a) {
  return a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : a);
}

// PPM on one component: (new_minus, new_plus) of the middle cell of
// (qm2, qm1, q0, qp1, qp2) -- reconstruct.ppm_faces (the JAX package's
// quokka_tpu/hydro/reconstruct.py:59-107, the same function without chi):
// the 4th-order interface estimates grouped for FP symmetry, clamped to the
// 3-cell range, the MC-limited PLM slope at a local extremum and the CW84
// overshoot resets elsewhere. Shared by the hydro sweep (K2) and the
// radiation transport (K4, K6).
__device__ __forceinline__ void ppm_cell(float qm2, float qm1, float q0,
                                         float qp1, float qp2, float& minus,
                                         float& plus) {
  const float c1 = (float)(7.0 / 12.0);
  const float c2 = (float)(-1.0 / 12.0);
  const float lo = mn(mn(qm1, q0), qp1);
  const float hi = mx(mx(qm1, q0), qp1);
  float a_minus = (c1 * q0 + c2 * qp1) + (c1 * qm1 + c2 * qm2);
  float a_plus = (c1 * qp1 + c2 * qp2) + (c1 * q0 + c2 * qm1);
  a_minus = mn(mx(a_minus, lo), hi);
  a_plus = mn(mx(a_plus, lo), hi);
  const float dq_minus = q0 - a_minus;
  const float dq_plus = a_plus - q0;
  const bool extremum = (dq_plus * dq_minus) <= 0.0f;
  const float a = qp1 - q0, b = q0 - qm1;
  const float dq0 = (0.5f * (sgn(a) + sgn(b))) *
                    mn(0.5f * fabsf(a + b), mn(2.0f * fabsf(a), 2.0f * fabsf(b)));
  const bool reset_minus = fabsf(dq_minus) >= 2.0f * fabsf(dq_plus);
  const bool reset_plus = fabsf(dq_plus) >= 2.0f * fabsf(dq_minus);
  const float mono_minus = reset_minus ? q0 - 2.0f * dq_plus : a_minus;
  const float mono_plus = reset_plus ? q0 + 2.0f * dq_minus : a_plus;
  minus = extremum ? q0 - 0.5f * dq0 : mono_minus;
  plus = extremum ? q0 + 0.5f * dq0 : mono_plus;
}

__device__ __forceinline__ float minmod(float a, float b) {
  return (0.5f * (sgn(a) + sgn(b))) * mn(fabsf(a), fabsf(b));
}

// Cell index along a sweep axis of length n, through the wall map:
// periodic wraps, reflect mirrors (ghost g_j = cell j on the lo side, cell
// n-1-j on the hi side) and sets `flip` (the normal velocity or momentum
// changes sign), outflow clamps to the edge cell (no flip). |c| stays
// within 4 of the domain, and n >= 4. Reflect and outflow share one
// select: a branch for each cost K1's march 3-4% on the H100 (PERF.md).
__device__ __forceinline__ int64_t map_cell(int64_t c, int64_t n, int lo,
                                            int hi, bool& flip) {
  flip = false;
  if (c < 0) {
    if (lo == BC_PERIODIC) return c + n;
    flip = lo == BC_REFLECT;
    return flip ? -1 - c : 0;
  }
  if (c >= n) {
    if (hi == BC_PERIODIC) return c - n;
    flip = hi == BC_REFLECT;
    return flip ? 2 * n - 1 - c : n - 1;
  }
  return c;
}

// Conserved -> primitive in registers (euler.cons_to_prim).
__device__ __forceinline__ void cons_to_prim(float q[NV], const Eos& e) {
  const float rho = q[0];
  const float inv_rho = 1.0f / rho;
  const float vx = q[1] * inv_rho;
  const float vy = q[2] * inv_rho;
  const float vz = q[3] * inv_rho;
  const float ke = (0.5f * rho) * ((vx * vx + vy * vy) + vz * vz);
  const float eint_cons = q[4] - ke;
  q[1] = vx;
  q[2] = vy;
  q[3] = vz;
  if (e.reconstruct_eint) {
    q[4] = eint_cons * inv_rho;
    q[5] = q[5] * inv_rho;
  } else {
    q[4] = e.gm1 * eint_cons;
  }
}

// Primitive state of the cell at sweep coordinate c (through the wall map)
// and transverse base offset `base`; `stride` is the sweep axis stride.
// NS passive scalars follow the 6 gas components in q, as they lie in the
// state: conserved densities, never flipped or converted (euler.
// cons_to_prim keeps them as they are).
template <int NS = 0>
__device__ __forceinline__ void load_prim(const float* __restrict__ Q,
                                          int64_t ncell, int64_t base,
                                          int64_t stride, int64_t c, int64_t n,
                                          int lo, int hi, int axis,
                                          int is_cons, const Eos& e,
                                          float* q) {
  bool flip;
  const int64_t off = base + map_cell(c, n, lo, hi, flip) * stride;
#pragma unroll
  for (int v = 0; v < NV + NS; ++v) q[v] = Q[v * ncell + off];
  if (flip) q[1 + axis] = -q[1 + axis];
  if (is_cons) cons_to_prim(q, e);
}

// A 3D field (chi, dmin) at sweep coordinate c: wall ghosts are even.
__device__ __forceinline__ float load_field(const float* __restrict__ A,
                                            int64_t base, int64_t stride,
                                            int64_t c, int64_t n, int lo,
                                            int hi) {
  bool flip;
  return A[base + map_cell(c, n, lo, hi, flip) * stride];
}

// chi_cell at sweep coordinate c: load_field, except that the
// wall-adjacent ghost of an outflow side (c = -1 or c = n) reads its exact
// plane (K1's outflow planes, `hydro.sweep.outflow_chi_planes`) at plane
// offset `poff`, where that plane is given; the other outflow ghosts copy
// the edge cell.
__device__ __forceinline__ float load_chi(const float* __restrict__ chi,
                                          const float* __restrict__ glo,
                                          const float* __restrict__ ghi,
                                          int64_t base, int64_t stride,
                                          int64_t poff, int64_t c, int64_t n,
                                          int lo, int hi) {
  if (c == -1 && glo != nullptr) return glo[poff];
  if (c == n && ghi != nullptr) return ghi[poff];
  return load_field(chi, base, stride, c, n, lo, hi);
}

// Shared-memory index of (along j, line i) in a tile with n_along entries
// a line: the contiguous global axis is the fastest one in shared memory
// too, and element e of a phase maps to (j, i) so that neighbouring e sit
// on neighbouring global and shared addresses.
template <int axis>
__device__ __forceinline__ int tix(int j, int i, int n_along, int lines) {
  return axis == 2 ? i * n_along + j : j * lines + i;
}
template <int axis>
__device__ __forceinline__ void tpos(int e, int n_along, int lines, int& j,
                                     int& i) {
  if (axis == 2) {
    j = e % n_along;
    i = e / n_along;
  } else {
    j = e / lines;
    i = e % lines;
  }
}

// Ask for the 128 B line holding *p to be brought into L2, ahead of a
// load that comes later in the kernel (no register is held meanwhile).
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Decompose a linear index over extents (E0, E1, E2), z fastest.
__device__ __forceinline__ void unravel(int64_t idx, int64_t E1, int64_t E2,
                                        int64_t co[3]) {
  co[2] = idx % E2;
  co[1] = (idx / E2) % E1;
  co[0] = idx / (E2 * E1);
}

}  // namespace qk
