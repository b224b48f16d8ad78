// K2 with 1 passive scalar after the 6 gas components, PPM: the face
// kernel, K2c / K2e and K2's sweeps with a divergence, and the first-order
// face kernel (sweep.cuh says how a scalar crosses a face, sweep.cu what
// each kernel computes). One form a translation unit, so that nvcc
// compiles the forms in parallel.
//
// Replaces the scalar forms of quokka_tpu/hydro/pallas_sweep.py::
// compute_axis_flux_pallas (the pallas_call at :1148; scalars :357,
// :401-402, the mass scalars' rescaling :408-416). Bound on the H100: as the
// form without scalars, bytes on paper (a scalar adds a row read and its
// face and divergence rows written: 7/6 of the bytes a cell with one) and
// instruction issue in practice; a scalar adds its reconstruction and its
// share of the face solve (kernel_check.OPS_SCALAR_FACE).
#include "sweep.cuh"

namespace qk {

QK_FORM_DEFINE(ppm1, 3, 1)
int fo_faces1(const FaceArgs& a) { return launch_fo_faces<1>(a); }

}  // namespace qk
