// K4: one IMEX PD-ARS radiation substep, in two stages.
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
// Design: four launches a stage. Three transport passes, one an axis
// (rad_transport_axis_kernel, the tile of rad_common.cuh
// `transport_axis_tile`, which K6 shares), each give a block a tile of 32 cells along
// the axis by 16 lines across it: it stages the cells the tile's faces
// read once in shared memory (the 4 conserved values and the (E, f)
// primitives, f = F / (c E), formed once a cell; the periodic wrap
// resolved as each is staged), reconstructs each cell the faces need once
// (both face states per component: PPM, PLM or donor cell), solves each
// face once, qL = plus(f-1), qR = minus(f), with the two cells' conserved
// values for the fallback (rad_common.cuh hll_face), and writes each cell's
// (F(lo) - F(hi)) / dx to the divergence (the x pass) or adds it on (y,
// then z: the JAX order ((x + y) + z)); divF0 at stage 1, a scratch divF1
// at stage 2. A cell kernel (rad_stage1_kernel, rad_stage2_kernel), one
// thread a cell, then runs the predict (stage 1) or combine (stage 2),
// amend, and the K5 coupling (rad_common.cuh source_cell, specialised on
// opacity laws that do not depend on T). Measured on the H100 at 256^3,
// this form takes 2.7 ms a stage where one fused kernel a stage (the
// transport from an 8^3 tile staged once, the coupling after a barrier)
// took 3.7 and the same 8^3 tile as a transport kernel of its own 3.4: the
// fused kernel's one register allocation (the Newton coupling's, with
// spills) and its 54.8 KB of shared memory held it to 24 warps a
// multiprocessor through both halves, and the 8^3 tile restages a halo of
// 6 cells in 8 on every axis, where a 32-cell line restages 6 in 32, in
// 36.9 KB at 40 registers. The divergence's round trips (16 B a cell and
// pass) cost less than either. The formulas and their
// order are those of the one-thread-a-cell kernel this replaces (which
// solved each face twice and reconstructed each cell three times an
// axis), and the library is built with -fmad=false, so the outputs are
// its bits. Both stages read neighbours of their input, so each writes
// fresh buffers, never in place.
//
// Bound on the H100: bytes, unless the Newton loops run long. Stage 1 reads
// 40 B a cell (U) and writes 56 B (U1, divF0); stage 2 reads 72 B (U1, R0,
// divF0) and writes 40 B: at 256^3 1.61 GB and 1.88 GB, >= 0.48 ms and
// >= 0.56 ms at 3.35 TB/s. The three-axis transport is about 840 FP32
// operations a cell, each face solved once (7 divisions, 4 square roots);
// the coupling about 50 an iteration; chip_smoke.py reports the larger
// bound.
#include "rad_common.cuh"

namespace qk {

// One axis of the transport divergence (rad_common.cuh
// `transport_axis_tile`): written to div by the x pass (`first`), added
// onto it by the y and z passes.
template <int axis>
__global__ void __launch_bounds__(TR_THREADS) rad_transport_axis_kernel(
    const float* __restrict__ R, float* __restrict__ div, int X, int Y, int Z, int first,
    RadParams p) {
  transport_axis_tile<axis>(R, div, X, Y, Z, first, p);
}

// One thread a cell; held to 64 registers (4 blocks a multiprocessor).
template <bool kConstOpacity>
__global__ void __launch_bounds__(THREADS, 4) rad_stage1_kernel(
    const float* __restrict__ U, const float* __restrict__ src, float* __restrict__ U1,
    const float* __restrict__ div0, int64_t ncell, float dt, RadParams p) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  float u[NVR];
#pragma unroll
  for (int v = 0; v < NVR; ++v) u[v] = U[v * ncell + idx];
  float R1[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) R1[k] = u[RS + k] + dt * div0[k * ncell + idx];
  amend(R1, p);
#pragma unroll
  for (int k = 0; k < 4; ++k) u[RS + k] = R1[k];
  const bool has_src = src != nullptr;
  source_cell<kConstOpacity>(u, has_src ? src[idx] : 0.0f, has_src, dt, 1, p);
#pragma unroll
  for (int v = 0; v < NVR; ++v) U1[v * ncell + idx] = u[v];
}

template <bool kConstOpacity>
__global__ void __launch_bounds__(THREADS, 4) rad_stage2_kernel(
    const float* __restrict__ U1, const float* __restrict__ R0,
    const float* __restrict__ div0, const float* __restrict__ div1,
    const float* __restrict__ src, float* __restrict__ U2, int64_t ncell, float dt,
    RadParams p) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
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
            w_d1 * div1[k * ncell + idx];
  amend(R2, p);
#pragma unroll
  for (int k = 0; k < 4; ++k) u[RS + k] = R2[k];
  const bool has_src = src != nullptr;
  source_cell<kConstOpacity>(u, has_src ? src[idx] : 0.0f, has_src, dt, 2, p);
#pragma unroll
  for (int v = 0; v < NVR; ++v) U2[v * ncell + idx] = u[v];
}

// The transport divergence of the radiation block R into div, on `stream`:
// the three axes in order, each adding onto the one before.
inline int launch_transport(const float* R, float* div, long long X, long long Y,
                            long long Z, const RadParams& p, cudaStream_t stream) {
  rad_transport_axis_kernel<0><<<(unsigned)transport_tiles(0, X, Y, Z), TR_THREADS, 0,
                                 stream>>>(R, div, (int)X, (int)Y, (int)Z, 1, p);
  rad_transport_axis_kernel<1><<<(unsigned)transport_tiles(1, X, Y, Z), TR_THREADS, 0,
                                 stream>>>(R, div, (int)X, (int)Y, (int)Z, 0, p);
  rad_transport_axis_kernel<2><<<(unsigned)transport_tiles(2, X, Y, Z), TR_THREADS, 0,
                                 stream>>>(R, div, (int)X, (int)Y, (int)Z, 0, p);
  return (int)cudaGetLastError();
}

}  // namespace qk

// Shared-memory bytes of a transport block (all of it static).
extern "C" int qk_rad_stage_smem() {
  return (int)(4 * sizeof(float) *
               (2 * qk::TR_SA * qk::TR_TW + 2 * qk::TR_RA * qk::TR_TW));
}

extern "C" int qk_rad_stage1(const float* U, const float* src, float* U1,
                             float* div0, long long X, long long Y, long long Z,
                             float dt, const qk::RadParams* p, void* stream) {
  const long long ncell = X * Y * Z;
  const int err = qk::launch_transport(U + qk::RS * ncell, div0, X, Y, Z, *p,
                                       (cudaStream_t)stream);
  if (err != 0) return err;
  auto kernel = qk::constant_opacity(*p) ? qk::rad_stage1_kernel<true>
                                         : qk::rad_stage1_kernel<false>;
  kernel<<<(unsigned)((ncell + qk::THREADS - 1) / qk::THREADS), qk::THREADS, 0,
           (cudaStream_t)stream>>>(U, src, U1, div0, ncell, dt, *p);
  return (int)cudaGetLastError();
}

extern "C" int qk_rad_stage2(const float* U1, const float* R0, const float* div0,
                             float* div1, const float* src, float* U2, long long X,
                             long long Y, long long Z, float dt,
                             const qk::RadParams* p, void* stream) {
  const long long ncell = X * Y * Z;
  const int err = qk::launch_transport(U1 + qk::RS * ncell, div1, X, Y, Z, *p,
                                       (cudaStream_t)stream);
  if (err != 0) return err;
  auto kernel = qk::constant_opacity(*p) ? qk::rad_stage2_kernel<true>
                                         : qk::rad_stage2_kernel<false>;
  kernel<<<(unsigned)((ncell + qk::THREADS - 1) / qk::THREADS), qk::THREADS, 0,
           (cudaStream_t)stream>>>(U1, R0, div0, div1, src, U2, ncell, dt, *p);
  return (int)cudaGetLastError();
}
