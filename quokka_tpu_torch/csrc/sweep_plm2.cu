// K2 with PLM (hydro.reconstruction_order = 2, the minmod slope) and 2
// passive scalars: the face kernel, K2c / K2e and K2's sweeps with a
// divergence (sweep.cuh; sweep.cu says what each kernel computes). One
// form a translation unit, so that nvcc compiles the forms in parallel.
//
// Replaces the PLM form of quokka_tpu/hydro/pallas_sweep.py::
// compute_axis_flux_pallas (the pallas_call at :1148; the order at :326,
// reconstruct.py:113-114): a cell's face states q0 - slope / 2 and q0 +
// slope / 2, slope = minmod(q+1 - q0, q0 - q-1). K1 writes no chi under PLM
// (the flattening is PPM's), so the kernels blend none. Bound on the H100:
// as the PPM form, bytes on paper and instruction issue in practice; the
// reconstruction is ~12 operations a component where PPM's is ~45
// (kernel_check.OPS_PLM_COMPONENT).
#include "sweep.cuh"

namespace qk {

QK_FORM_DEFINE(plm2, 2, 2)

}  // namespace qk
