// K7: the M1 radiation face flux along one axis.
//
// Replaces quokka_tpu/radiation/pallas_sweep.py::compute_rad_axis_flux_pallas
// (def :23, pallas_call :53) for one photon group: PPM / PLM / donor-cell
// faces of the (E, f) primitives, the donor-cell fallback on inadmissible
// faces (E <= 0 or |f|^2 >= 1), and the frozen-Eddington HLL flux
// [1, 4, X, Y, Z], slot f the face between cells f-1 and f. Its caller is
// compute_rad_fluxes (radiation/system.py), whose flux dicts the AMR flux
// registers consume (the dense levels' LevelRadiation).
//
// Design: one thread per face, z fastest. The thread reads cells f-3..f+2
// of the four conserved components along the axis through the periodic
// index map and forms the primitives in registers (f = F / (c E), as
// rad_cons_to_prim does), which reads 16 B a cell instead of the TPU
// kernel's 32 (it takes the primitives and the conserved block). The HLL
// arithmetic is K6's (rad_common.cuh), with the face flux written out
// instead of differenced.
//
// Batched: blockIdx.y picks a block of a [B, 4, X, Y, Z] chunk (the packed
// AMR engine's ghost-padded radiation tiles, one launch a chunk and axis).
//
// Layout: the input is the radiation block of a ghost-padded level. The
// padded array wraps periodically in index space, exactly as the JAX
// kernel's in-block rolls do; the wrap reaches ghost faces only, which the
// caller's interior() discards.
//
// Bound on the H100: bytes. 16 B are read and 16 B written a cell against
// roughly 230 FP32 operations (primitives, PPM of 4 components on two
// cells, one HLL face): at the fine level's padded 520^3 the 4.5 GB take
// >= 1.34 ms at 3.35 TB/s, the operations >= 0.48 ms at 67 TFLOP/s.
#include "rad_common.cuh"

namespace qk {

// Face states (qL from cell f-1, qR from cell f) of one primitive component
// from the 6-cell line w[0..5] = cells f-3..f+2
// (reconstruct.reconstruct_faces).
__device__ __forceinline__ void lo_face(const float w[6], int order, float& qL,
                                        float& qR) {
  if (order == 3) {
    float m_unused, p_unused;
    ppm_cell(w[0], w[1], w[2], w[3], w[4], m_unused, qL);
    ppm_cell(w[1], w[2], w[3], w[4], w[5], qR, p_unused);
  } else if (order == 2) {
    qL = w[2] + 0.5f * minmod(w[3] - w[2], w[2] - w[1]);
    qR = w[3] - 0.5f * minmod(w[4] - w[3], w[3] - w[2]);
  } else {
    qL = w[2];
    qR = w[3];
  }
}

template <int axis>
__global__ void rad_axis_flux_kernel(const float* __restrict__ R,
                                     float* __restrict__ flux, int64_t X,
                                     int64_t Y, int64_t Z, RadParams p) {
  const int64_t ncell = X * Y * Z;
  {  // batch index: block b of a [B, 4, X, Y, Z] chunk (B = 1 unbatched)
    const int64_t b = blockIdx.y;
    R += b * 4 * ncell;
    flux += b * 4 * ncell;
  }
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  const int64_t dims[3] = {X, Y, Z};
  int64_t co[3];
  unravel(idx, Y, Z, co);
  const int64_t n = dims[axis];
  const int64_t stride = axis == 0 ? Y * Z : (axis == 1 ? Z : 1);
  const int64_t base = idx - co[axis] * stride;
  float cons[6][4], prim[6][4];
#pragma unroll
  for (int o = 0; o < 6; ++o) {
    bool flip;
    const int64_t off =
        base + map_cell(co[axis] - 3 + o, n, BC_PERIODIC, BC_PERIODIC, flip) * stride;
#pragma unroll
    for (int k = 0; k < 4; ++k) cons[o][k] = R[k * ncell + off];
    const float cE = p.c * cons[o][0];
    prim[o][0] = cons[o][0];
#pragma unroll
    for (int k = 1; k < 4; ++k) prim[o][k] = cons[o][k] / cE;
  }
  float qL[4], qR[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float w[6] = {prim[0][k], prim[1][k], prim[2][k],
                        prim[3][k], prim[4][k], prim[5][k]};
    lo_face(w, p.recon_order, qL[k], qR[k]);
  }
  float F[4];
  hll_face<axis>(qL, qR, cons[2], cons[3], p, F);
#pragma unroll
  for (int k = 0; k < 4; ++k) flux[k * ncell + idx] = F[k];
}

}  // namespace qk

extern "C" int qk_rad_axis_flux(const float* R, float* flux, long long X,
                                long long Y, long long Z, long long nbatch,
                                int axis, const qk::RadParams* p,
                                void* stream) {
  const int64_t ncell = (int64_t)X * Y * Z;
  const dim3 blocks((unsigned)((ncell + qk::THREADS - 1) / qk::THREADS),
                    (unsigned)nbatch);
  auto kernel = axis == 0 ? qk::rad_axis_flux_kernel<0>
                : (axis == 1 ? qk::rad_axis_flux_kernel<1>
                             : qk::rad_axis_flux_kernel<2>);
  kernel<<<blocks, qk::THREADS, 0, (cudaStream_t)stream>>>(R, flux, X, Y, Z, *p);
  return (int)cudaGetLastError();
}
