// K6: the M1 radiation transport divergence along one axis.
//
// Replaces quokka_tpu/radiation/pallas_sweep.py::compute_rad_div_pallas
// (def :70, pallas_call :115, kernel body :98-113, its loop over the G
// photon groups :110-112) on the periodic, unpadded state: (E, f)
// primitives of the conserved block, PPM / PLM / donor-cell faces of the
// four primitives, the
// frozen-Eddington HLL flux with the donor-cell fallback on inadmissible
// faces, and (F(lo) - F(hi)) * inv_dx.
//
// Design: K4's transport pass (rad_common.cuh `transport_axis_tile`): a
// block owns a tile of 32 cells along the axis by 16 lines across it,
// stages each cell once (the periodic wrap resolved as it is staged; the
// TPU kernel's "top padded cell is garbage" caveat belongs to its padded
// layout and has no counterpart here), reconstructs it once, solves each
// face once and writes each cell's divergence, or adds it onto `div` in
// place (`first` = 0): `radiation.system.rad_transport_div` launches x
// into a fresh output and y and z onto it, which is the JAX order of the
// sum ((x + y) + z), so no PyTorch add and no other output is needed. The
// one-thread-a-cell kernel this replaces solved each face twice and
// reconstructed each cell three times an axis; the expressions and their
// order are its, so the outputs keep its bits. The kernel keeps a name of
// its own (`rad_div_tile_kernel`), so that a profile tells it from K4's
// passes.
//
// G photon groups: each group is independent (its own (E, f), faces and
// HLL flux; the per-group floor Erad_floor / G is already in RadParams), so
// one launch covers them all, blockIdx.y the group, whose block of R and of
// div lies 4 X Y Z values further on. One group is blockIdx.y = 0, the
// same tile at offset 0.
//
// Bound on the H100: bytes. Per cell and group 16 B are read and 16 B written (and
// 16 B more read onto the accumulator), against roughly 280 FP32
// operations (one face solved a cell): at 256^3 0.54 GB (0.81 GB
// accumulating) take >= 0.16 ms (0.24 ms) at 3.35 TB/s, the operations
// >= 0.07 ms at 67 TFLOP/s.
#include "rad_common.cuh"

namespace qk {

template <int axis>
__global__ void __launch_bounds__(TR_THREADS) rad_div_tile_kernel(
    const float* __restrict__ R, float* __restrict__ div, int X, int Y, int Z, int first,
    RadParams p) {
  const int64_t group = (int64_t)blockIdx.y * 4 * X * Y * Z;
  transport_axis_tile<axis>(R + group, div + group, X, Y, Z, first, p);
}

}  // namespace qk

// K6 along one axis over G photon groups (R and div [G, 4, X, Y, Z]): div =
// the axis's divergence (first = 1), or div += it (first = 0).
extern "C" int qk_rad_div(const float* R, float* div, long long X, long long Y,
                          long long Z, int G, int axis, int first, const qk::RadParams* p,
                          void* stream) {
  auto kernel = axis == 0 ? qk::rad_div_tile_kernel<0>
                : (axis == 1 ? qk::rad_div_tile_kernel<1> : qk::rad_div_tile_kernel<2>);
  kernel<<<dim3((unsigned)qk::transport_tiles(axis, X, Y, Z), (unsigned)G), qk::TR_THREADS,
           0, (cudaStream_t)stream>>>(R, div, (int)X, (int)Y, (int)Z, first, *p);
  return (int)cudaGetLastError();
}
