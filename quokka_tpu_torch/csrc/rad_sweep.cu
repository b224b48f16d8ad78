// K6: the M1 radiation transport divergence along one axis.
//
// Replaces quokka_tpu/radiation/pallas_sweep.py::compute_rad_div_pallas
// (the pallas_call at :115, kernel body :98-113) for one photon group on
// the periodic, unpadded state: (E, f) primitives of the conserved block,
// PPM / PLM / donor-cell faces of the four primitives, the
// frozen-Eddington HLL flux with the donor-cell fallback on inadmissible
// faces, and (F(lo) - F(hi)) * inv_dx.
//
// Design: one thread per cell, z fastest. The thread reads cells i-3..i+3
// of the four components along the axis through the periodic index map
// (no padded copy; the TPU kernel's "top padded cell is garbage" caveat
// belongs to its padded layout and has no counterpart here), builds the
// states of its lo and hi faces and solves both. Each face is solved twice
// (once by each neighbour): simple and right first; sharing faces through
// shared memory is later work.
//
// Bound on the H100: bytes. Per cell 16 B are read (the four components;
// the neighbours' reads hit L1/L2) and 16 B written, against roughly 400
// FP32 operations for the two faces: at 256^3 the 0.54 GB take >= 0.16 ms
// at 3.35 TB/s, the operations >= 0.1 ms at 67 TFLOP/s.
#include "rad_common.cuh"

namespace qk {

template <int axis>
__global__ void rad_div_kernel(const float* __restrict__ R,
                               float* __restrict__ div, int64_t X, int64_t Y,
                               int64_t Z, RadParams p) {
  const int64_t ncell = X * Y * Z;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  const int64_t dims[3] = {X, Y, Z};
  int64_t co[3];
  unravel(idx, Y, Z, co);
  float d[4];
  rad_div_axis<axis>(R, ncell, idx, co, dims, p, d);
#pragma unroll
  for (int k = 0; k < 4; ++k) div[k * ncell + idx] = d[k];
}

}  // namespace qk

extern "C" int qk_rad_div(const float* R, float* div, long long X, long long Y,
                          long long Z, int axis, const qk::RadParams* p,
                          void* stream) {
  const int64_t ncell = (int64_t)X * Y * Z;
  const unsigned blocks = (unsigned)((ncell + qk::THREADS - 1) / qk::THREADS);
  auto kernel = axis == 0 ? qk::rad_div_kernel<0>
                : (axis == 1 ? qk::rad_div_kernel<1> : qk::rad_div_kernel<2>);
  kernel<<<blocks, qk::THREADS, 0, (cudaStream_t)stream>>>(R, div, X, Y, Z, *p);
  return (int)cudaGetLastError();
}
