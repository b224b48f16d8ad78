// K4: one IMEX PD-ARS radiation substep as two fused stage kernels.
//
// Replaces quokka_tpu/radiation/pallas_substep.py::fused_substep_pallas
// (:103): its kernel k1 (:151, pallas_call :183) and k2 (:163, pallas_call
// :196), for one photon group on the periodic, unpadded f32 state:
//
//   stage 1: divF0 = div F(R0) over the three axes ((x + y) + z);
//            R1 = amend(R0 + dt divF0); the K5 coupling at stage 1.
//            Writes U1 [10, ...] and divF0 [4, ...].
//   stage 2: divF1 = div F(R1) from U1's radiation block;
//            R2 = amend((1-a32) R0 + a32 R1 + dt (0.5-a32) divF0
//                       + dt 0.5 divF1)   (the JAX operand order);
//            the K5 coupling at stage 2. Writes U2 [10, ...].
//
// Design: one thread per cell, z fastest. The TPU kernel reads x/y halo
// windows of a periodic-padded copy and rolls z in VMEM; here every axis
// reads its 7-cell line through the same periodic index map, so no padded
// copy exists. Both stages read neighbours of their input, so each writes
// fresh buffers, never in place. The transport and the Newton coupling of
// a cell share one thread: nothing between them goes to DRAM. The coupling
// is K5's (rad_common.cuh `source_cell`), specialised like it on opacity
// laws that do not depend on T.
//
// Bound on the H100: bytes, unless the Newton loops run long. Stage 1 reads
// 40 B a cell (U; the neighbours' radiation reads hit L1/L2) and writes
// 56 B (U1, divF0); stage 2 reads 72 B (U1, R0, divF0) and writes 40 B:
// at 256^3 1.61 GB and 1.88 GB, >= 0.48 ms and >= 0.56 ms at 3.35 TB/s.
// The three-axis transport is about 1200 FP32 operations a cell, the
// coupling about 50 an iteration; chip_smoke.py reports the larger bound.
#include "rad_common.cuh"

namespace qk {

template <bool kConstOpacity>
__global__ void rad_stage1_kernel(const float* __restrict__ U,
                                  const float* __restrict__ src,
                                  float* __restrict__ U1,
                                  float* __restrict__ div0, int64_t X,
                                  int64_t Y, int64_t Z, float dt, RadParams p) {
  const int64_t ncell = X * Y * Z;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  const int64_t dims[3] = {X, Y, Z};
  int64_t co[3];
  unravel(idx, Y, Z, co);
  float d[4];
  rad_div_3d(U + RS * ncell, ncell, idx, co, dims, p, d);
  float u[NVR];
#pragma unroll
  for (int v = 0; v < NVR; ++v) u[v] = U[v * ncell + idx];
  float R1[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) R1[k] = u[RS + k] + dt * d[k];
  amend(R1, p);
#pragma unroll
  for (int k = 0; k < 4; ++k) u[RS + k] = R1[k];
  const bool has_src = src != nullptr;
  source_cell<kConstOpacity>(u, has_src ? src[idx] : 0.0f, has_src, dt, 1, p);
#pragma unroll
  for (int v = 0; v < NVR; ++v) U1[v * ncell + idx] = u[v];
#pragma unroll
  for (int k = 0; k < 4; ++k) div0[k * ncell + idx] = d[k];
}

template <bool kConstOpacity>
__global__ void rad_stage2_kernel(const float* __restrict__ U1,
                                  const float* __restrict__ R0,
                                  const float* __restrict__ div0,
                                  const float* __restrict__ src,
                                  float* __restrict__ U2, int64_t X,
                                  int64_t Y, int64_t Z, float dt, RadParams p) {
  const int64_t ncell = X * Y * Z;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  const int64_t dims[3] = {X, Y, Z};
  int64_t co[3];
  unravel(idx, Y, Z, co);
  float d[4];
  rad_div_3d(U1 + RS * ncell, ncell, idx, co, dims, p, d);
  float u[NVR];
#pragma unroll
  for (int v = 0; v < NVR; ++v) u[v] = U1[v * ncell + idx];
  const float w_d0 = dt * (0.5f - A32);
  const float w_d1 = dt * 0.5f;
  float R2[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    R2[k] = (((1.0f - A32) * R0[k * ncell + idx] + A32 * u[RS + k]) +
             w_d0 * div0[k * ncell + idx]) +
            w_d1 * d[k];
  amend(R2, p);
#pragma unroll
  for (int k = 0; k < 4; ++k) u[RS + k] = R2[k];
  const bool has_src = src != nullptr;
  source_cell<kConstOpacity>(u, has_src ? src[idx] : 0.0f, has_src, dt, 2, p);
#pragma unroll
  for (int v = 0; v < NVR; ++v) U2[v * ncell + idx] = u[v];
}

}  // namespace qk

extern "C" int qk_rad_stage1(const float* U, const float* src, float* U1,
                             float* div0, long long X, long long Y, long long Z,
                             float dt, const qk::RadParams* p, void* stream) {
  const int64_t ncell = (int64_t)X * Y * Z;
  const unsigned blocks = (unsigned)((ncell + qk::THREADS - 1) / qk::THREADS);
  auto kernel = qk::constant_opacity(*p) ? qk::rad_stage1_kernel<true>
                                         : qk::rad_stage1_kernel<false>;
  kernel<<<blocks, qk::THREADS, 0, (cudaStream_t)stream>>>(U, src, U1, div0, X, Y, Z,
                                                           dt, *p);
  return (int)cudaGetLastError();
}

extern "C" int qk_rad_stage2(const float* U1, const float* R0, const float* div0,
                             const float* src, float* U2, long long X,
                             long long Y, long long Z, float dt,
                             const qk::RadParams* p, void* stream) {
  const int64_t ncell = (int64_t)X * Y * Z;
  const unsigned blocks = (unsigned)((ncell + qk::THREADS - 1) / qk::THREADS);
  auto kernel = qk::constant_opacity(*p) ? qk::rad_stage2_kernel<true>
                                         : qk::rad_stage2_kernel<false>;
  kernel<<<blocks, qk::THREADS, 0, (cudaStream_t)stream>>>(U1, R0, div0, src, U2, X, Y,
                                                           Z, dt, *p);
  return (int)cudaGetLastError();
}
