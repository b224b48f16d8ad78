// K5: the implicit gas-radiation matter coupling, one cell per thread.
//
// Replaces quokka_tpu/radiation/pallas_source.py::source_update_pallas (the
// pallas_call at :59, kernel body :50-57 running
// source_terms.add_source_terms_single_group): the Newton-Raphson energy
// exchange (at most 100 iterations), the implicit flux and momentum update
// with the frozen Eddington tensor, and the lagged work-term outer loop
// (ite from 1 while < 5), for one photon group and beta_order 0 or 1.
//
// Design: each thread loads its cell's 10 components, runs the loops in
// registers and stops when ITS cell converges. The TPU kernel loops until
// every cell of its block has converged, but a converged cell is frozen by
// its `done` mask (source_terms.py:189-197, :327-349), so the per-cell
// result is the same. The loops are data-dependent: neighbouring cells in a
// warp that need different iteration counts diverge.
//
// Bound on the H100: bytes, unless the Newton loops run long. Per cell 40 B
// are read (plus 4 B of source when the problem has one) and 40 B written:
// at 256^3 0.67 GB, >= 0.2 ms at 3.35 TB/s. A Newton iteration is about 50
// FP32 operations; chip_smoke.py counts the iterations this run's data needs
// and reports the larger of the two bounds.
#include "rad_common.cuh"

namespace qk {

__global__ void rad_source_kernel(const float* __restrict__ U,
                                  const float* __restrict__ src,
                                  float* __restrict__ out, int64_t ncell,
                                  float dt, int stage, RadParams p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ncell) return;
  float u[NVR];
#pragma unroll
  for (int v = 0; v < NVR; ++v) u[v] = U[v * ncell + i];
  const bool has_src = src != nullptr;
  source_cell(u, has_src ? src[i] : 0.0f, has_src, dt, stage, p);
#pragma unroll
  for (int v = 0; v < NVR; ++v) out[v * ncell + i] = u[v];
}

}  // namespace qk

extern "C" int qk_rad_source(const float* U, const float* src, float* out,
                             long long ncell, float dt, int stage,
                             const qk::RadParams* p, void* stream) {
  const unsigned blocks = (unsigned)((ncell + qk::THREADS - 1) / qk::THREADS);
  qk::rad_source_kernel<<<blocks, qk::THREADS, 0, (cudaStream_t)stream>>>(
      U, src, out, ncell, dt, stage, *p);
  return (int)cudaGetLastError();
}
