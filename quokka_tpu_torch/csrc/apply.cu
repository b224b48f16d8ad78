// K3: pointwise finish of one RK stage.
//
// Replaces quokka_tpu/hydro/pallas_sweep.py::apply_update_pallas (the
// pallas_call at :1409, body :1326-1397). Per cell:
//   rhs   = div_0 + div_1 + div_2 (sorted-axis order), dv likewise;
//   rhs[EINT] -= P(Ug0) * dv                  (PdV source);
//   U_try = U + dt * rhs;
//   count U_try as invalid (non-positive rho or E - KE, or non-finite),
//     BEFORE any floor;
//   EnforceLimits (density floor, optional temperature floor);
//   SyncDualEnergy.
// NS passive scalars (a template count, 1 or 2; 0 is the form without)
// follow the 6 gas components: their rhs is the divergence alone, they
// count towards the validity test's finiteness, and where the density floor
// raised rho they are rescaled by rho / rho_new (pallas_sweep.py:1374-1380,
// euler.enforce_limits).
// dt is read from device memory, so a step whose dt was computed on the
// card needs no host round trip to launch this kernel.
//
// Padded stage inputs: Ug0 and the divergences may be ghost-padded along x
// (a hook-filled x axis stepped in the hybrid ghost-free mode,
// hydro/advance.py): component c of cell i is then read at c * pstride +
// poff + i, pstride the padded block's cells and poff the x ghosts' cells
// before the interior (pstride = ncell, poff = 0 unpadded); U and the
// output are the interior.
//
// Validity: an int32 count of invalid cells, kept with atomicAdd. Callers
// use only "any invalid" to gate the FOFC fallback. The JAX kernel keeps
// per-(8 x 8 x Z)-block flags instead, so the n_fofc statistic of the port
// counts cells, where the TPU path counted blocks.
//
// Design: one thread per cell, z fastest; every load and store is
// coalesced, and the atomic fires only on an invalid cell (rare). Nothing
// but the finished state reaches DRAM.
//
// Bound on the H100: bytes. Per cell it reads U, Ug0 and three divergences
// (5 x 6 floats) plus three dvel values and writes 6 floats: 156 B against
// ~80 flops. Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit:
// 0.72-0.77 ms at 256^3, 3.4-3.7 TB/s of those bytes, at the DRAM roof
// (some inputs are still in L2 from the sweep that wrote them).
#include "common.cuh"

namespace qk {

template <int NS>
__global__ void apply_kernel(const float* __restrict__ U,
                             const float* __restrict__ Ug0,
                             const float* __restrict__ d0,
                             const float* __restrict__ d1,
                             const float* __restrict__ d2,
                             const float* __restrict__ v0,
                             const float* __restrict__ v1,
                             const float* __restrict__ v2,
                             const float* __restrict__ dt_ptr,
                             float* __restrict__ out, int* __restrict__ n_bad,
                             int64_t ncell, int64_t pstride, int64_t poff,
                             float density_floor,
                             float temperature_floor, float c_v, float gm1,
                             int dual_energy) {
  constexpr int NT = NV + NS;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ncell) return;
  const float dt = *dt_ptr;
  const int64_t ip = poff + i;  // the cell in the padded inputs

  float rhs[NT];
#pragma unroll
  for (int c = 0; c < NT; ++c)
    rhs[c] = (d0[c * pstride + ip] + d1[c * pstride + ip]) + d2[c * pstride + ip];
  const float dv = (v0[ip] + v1[ip]) + v2[ip];

  // PdV source on the EINT slot (euler.pressure of the stage's input state)
  const float g_rho = Ug0[ip];
  const float g1 = Ug0[pstride + ip], g2 = Ug0[2 * pstride + ip],
              g3 = Ug0[3 * pstride + ip];
  const float g_ke = (0.5f * ((g1 * g1 + g2 * g2) + g3 * g3)) / g_rho;
  const float P = gm1 * (Ug0[4 * pstride + ip] - g_ke);
  rhs[5] = rhs[5] - P * dv;

  float u[NT];
#pragma unroll
  for (int c = 0; c < NT; ++c) u[c] = U[c * ncell + i] + dt * rhs[c];

  // validity of the raw update (euler.is_state_valid), before the floors
  bool ok = u[0] > 0.0f;
  const float ke_t = (0.5f * ((u[1] * u[1] + u[2] * u[2]) + u[3] * u[3])) /
                     (ok ? u[0] : 1.0f);
  ok = ok && ((u[4] - ke_t) > 0.0f);
#pragma unroll
  for (int c = 0; c < NT; ++c) ok = ok && isfinite(u[c]);
  if (!ok) atomicAdd(n_bad, 1);

  // EnforceLimits
  const float rho_new = mx(u[0], density_floor);
  if (NS > 0) {
    float scale = rho_new > 0.0f ? u[0] / rho_new : 0.0f;
    scale = u[0] < density_floor ? scale : 1.0f;
#pragma unroll
    for (int c = NV; c < NT; ++c) u[c] = u[c] * scale;
  }
  u[0] = rho_new;
  if (temperature_floor > 0.0f) {
    const float ke = (0.5f * ((u[1] * u[1] + u[2] * u[2]) + u[3] * u[3])) /
                     rho_new;
    const float eint_floor = (rho_new * c_v) * temperature_floor;
    u[4] = ke + mx(u[4] - ke, eint_floor);
    u[5] = mx(u[5], eint_floor);
  }

  // SyncDualEnergy
  if (dual_energy) {
    const float ke = (0.5f * ((u[1] * u[1] + u[2] * u[2]) + u[3] * u[3])) /
                     u[0];
    const float etot = u[4];
    const float eint_cons = etot - ke;
    const bool use_cons = eint_cons > (float)1.0e-3 * etot;
    const float eint_old = u[5];
    u[5] = use_cons ? eint_cons : eint_old;
    u[4] = use_cons ? etot : eint_old + ke;
  }

#pragma unroll
  for (int c = 0; c < NT; ++c) out[c * ncell + i] = u[c];
}

}  // namespace qk

extern "C" int qk_apply(const float* U, const float* Ug0, const float* d0,
                        const float* d1, const float* d2, const float* v0,
                        const float* v1, const float* v2, const float* dt,
                        float* out, int* n_bad, long long ncell,
                        long long pstride, long long poff, float density_floor,
                        float temperature_floor, float c_v, float gm1,
                        int dual_energy, int nsc, void* stream) {
  const unsigned blocks = (unsigned)((ncell + qk::THREADS - 1) / qk::THREADS);
  if (nsc < 0 || nsc > 2) return (int)cudaErrorInvalidValue;
  auto kernel = nsc == 0 ? qk::apply_kernel<0>
                : (nsc == 1 ? qk::apply_kernel<1> : qk::apply_kernel<2>);
  kernel<<<blocks, qk::THREADS, 0, (cudaStream_t)stream>>>(
      U, Ug0, d0, d1, d2, v0, v1, v2, dt, out, n_bad, ncell, pstride, poff, density_floor,
      temperature_floor, c_v, gm1, dual_energy);
  return (int)cudaGetLastError();
}
