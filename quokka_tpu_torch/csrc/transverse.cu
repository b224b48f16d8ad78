// K1: per-axis transverse fields for the hydro sweep.
//
// Replaces quokka_tpu/hydro/pallas_sweep.py::precompute_transverse_pallas
// (the pallas_call at :187). For one axis t and every cell c it writes
//   dmin_t(c) = min(v_t(c+1) - v_t(c), v_t(c) - v_t(c-1)),
//   chi_t(c)  = the Miller & Colella flattening coefficient
//               (reconstruct.flattening_chi), and
//   m3_t(c)   = min(chi_t(c-1), chi_t(c), chi_t(c+1)).
// The caller folds chi_cell = min over axes of m3_t in PyTorch, as the JAX
// package does in XLA.
//
// Batched: blockIdx.y picks a block of a [B, 6, X, Y, Z] chunk (the packed
// AMR engine's ghost-padded tiles, one launch a chunk and axis).
//
// Design: one thread per cell, z fastest, so a warp reads 32 consecutive
// z cells whatever the sweep axis, and every load of the +-3 stencil is
// coalesced. Wall ghosts are never stored: each stencil read goes through
// the reflect/periodic index map (common.cuh: map_cell) and flips the sign
// of the normal velocity on a mirrored read, which reproduces the JAX
// kernel's in-VMEM ghost assembly value for value. With is_cons the input
// is the conserved state and cons->prim runs in registers.
//
// Bound on the H100: bytes by design. Each cell needs its 6 components once
// from DRAM (neighbouring threads share the stencil through L1/L2) and
// writes 3 floats, 36 B. The design keeps the primitive state out of DRAM;
// the seven stencil cells are re-read through the cache rather than staged
// in shared memory (later work). Measured on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit: 0.47-0.61 ms an axis at 256^3, 1.0-1.3 TB/s of those
// 36 B a cell, a third of the DRAM roof. Each thread redoes cons->prim for
// seven cells and chi for three (about 19 IEEE divisions and 3 square
// roots), which is the likely limit; it was not isolated.
#include "common.cuh"

namespace qk {

__device__ __forceinline__ float chi_at(const float* P, const float* rho,
                                        const float* vel, int o,
                                        const Eos& e) {
  const float bd = fabsf(P[o + 2] - P[o - 2]);
  const float num = fabsf(P[o + 1] - P[o - 1]);
  const float beta = (bd != 0.0f) ? num / bd : 0.0f;
  const float chi_min =
      mn(mx(((float)0.85 - beta) / (float)(0.85 - 0.75), 0.0f), 1.0f);
  const float cs = sqrtf((e.gamma * P[o]) / rho[o]);
  const float k_s = (cs * cs) * rho[o];
  const float z = num / k_s;
  const bool converging = vel[o + 1] < vel[o - 1];
  const float chi_conv =
      mx(chi_min, mn(1.0f, ((float)0.75 - z) / (float)(0.75 - 0.25)));
  return converging ? chi_conv : 1.0f;
}

// The sweep axis is a template parameter so that every component index
// (the flipped normal velocity, the stencil arrays) is a compile-time
// constant and the stencil lives in registers, not local memory.
template <int axis>
__global__ void transverse_kernel(const float* __restrict__ U,
                                  float* __restrict__ dmin,
                                  float* __restrict__ m3,
                                  float* __restrict__ chi, int64_t X,
                                  int64_t Y, int64_t Z, int lo, int hi,
                                  int is_cons, int do_chi, Eos e) {
  const int64_t ncell = X * Y * Z;
  {  // batch index: block b of a [B, 6, X, Y, Z] chunk (B = 1 unbatched)
    const int64_t b = blockIdx.y;
    U += b * NV * ncell;
    dmin += b * ncell;
    if (m3 != nullptr) m3 += b * ncell;
    if (chi != nullptr) chi += b * ncell;
  }
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  int64_t co[3];
  unravel(idx, Y, Z, co);
  const int64_t n = axis == 0 ? X : (axis == 1 ? Y : Z);
  const int64_t stride = axis == 0 ? Y * Z : (axis == 1 ? Z : 1);
  const int64_t c = co[axis];
  const int64_t base = idx - c * stride;

  // offsets -3..3 stored at [0..6] (only -1..1 are used without flattening)
  float P[7], rho[7], vel[7];
#pragma unroll
  for (int o = -3; o <= 3; ++o) {
    float q[NV];
    load_prim(U, ncell, base, stride, c + o, n, lo, hi, axis, is_cons, e, q);
    rho[o + 3] = q[0];
    vel[o + 3] = q[1 + axis];
    P[o + 3] = e.reconstruct_eint ? e.gm1 * (q[0] * q[4]) : q[4];
  }
  dmin[idx] = mn(vel[4] - vel[3], vel[3] - vel[2]);
  if (do_chi) {
    const float c_m = chi_at(P, rho, vel, 2, e);
    const float c_0 = chi_at(P, rho, vel, 3, e);
    const float c_p = chi_at(P, rho, vel, 4, e);
    m3[idx] = mn(mn(c_m, c_0), c_p);
    chi[idx] = c_0;
  }
}

}  // namespace qk

extern "C" int qk_transverse(const float* U, float* dmin, float* m3,
                             float* chi, long long X, long long Y, long long Z,
                             long long nbatch, int axis, int lo, int hi,
                             int is_cons, int do_chi,
                             float gamma, float gm1, float inv_gm1, float s_n,
                             int reconstruct_eint, void* stream) {
  const qk::Eos e{gamma, gm1, inv_gm1, s_n, reconstruct_eint};
  const int64_t ncell = (int64_t)X * Y * Z;
  const dim3 blocks((unsigned)((ncell + qk::THREADS - 1) / qk::THREADS),
                    (unsigned)nbatch);
  auto kernel = axis == 0 ? qk::transverse_kernel<0>
                : (axis == 1 ? qk::transverse_kernel<1> : qk::transverse_kernel<2>);
  kernel<<<blocks, qk::THREADS, 0, (cudaStream_t)stream>>>(
      U, dmin, m3, chi, X, Y, Z, lo, hi, is_cons, do_chi, e);
  return (int)cudaGetLastError();
}
