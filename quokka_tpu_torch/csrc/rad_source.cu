// K5: the implicit gas-radiation matter coupling, one cell per thread, over
// a batch of blocks read and written where they lie.
//
// Replaces quokka_tpu/radiation/pallas_source.py::source_update_pallas (the
// pallas_call at :59, kernel body :50-57 running
// source_terms.add_source_terms_single_group): the Newton-Raphson energy
// exchange (at most 100 iterations), the implicit flux and momentum update
// with the frozen Eddington tensor, and the lagged work-term outer loop
// (ite from 1 while < 5), for one photon group and beta_order 0 or 1.
//
// Operands: B blocks of X x Y x Z cells. The 6 gas and the 4 radiation
// components are two views, each with its own block, component, x and y
// strides (z contiguous), and so are the two outputs: the packed AMR
// engine's chunk [B, 6 | 4, ...] is read in place, a crop of a larger
// block included, and stage 2 writes straight into the pools' rows. A
// per-cell keep mask (the ring cells whose neighbour tile exists) leaves
// the other cells' values as they were and runs no Newton on them: the
// packed engine discards those cells (on the shell each of them took 30
// Newton residual evaluations, 71% of a stage-1 chunk's Newton work). The
// unigrid state [10, X, Y, Z] is the case B = 1, contiguous, without a
// mask.
//
// Design: each thread loads its cell's 10 components, runs the loops in
// registers and stops when ITS cell converges. The TPU kernel loops until
// every cell of its block has converged, but a converged cell is frozen by
// its `done` mask (source_terms.py:189-197, :327-349), so the per-cell
// result is the same. The loops are data-dependent: neighbouring cells in a
// warp that need different iteration counts diverge (on the shell's chunk
// a warp runs 1.27x the mean cell's residual evaluations, on RadhydroBench
// 1.02-1.08x: a persistent grid that rebalances lanes would win less than
// that, so the grid is one thread a cell). When no opacity law depends on
// T (both main paths), the loop-invariant opacities are hoisted
// (rad_common.cuh `newton<true>`), with the same bits.
// __launch_bounds__(256, 4) holds a thread to 64 registers (12 bytes of
// spills a thread in the constant-opacity form) so that four blocks (32
// warps) fit a multiprocessor; uncapped it took 80 registers, three
// blocks, and ran 8-14% slower.
//
// Bound on the H100: bytes, unless the Newton loops run long. Per cell 40 B
// are read (plus 4 B of source, 1 B of mask) and 40 B written: at 256^3
// 0.67 GB, >= 0.2 ms at 3.35 TB/s. A Newton iteration is about 50 FP32
// operations; kernel_check counts the iterations this run's data needs
// and reports the larger of the two bounds. In practice the IEEE divisions
// and square roots of each iteration (7 and 2; 9 and 2 without the
// hoisting) bound it.
#include "rad_common.cuh"

namespace qk {

// A [B, C, X, Y, Z] f32 view with unit z stride: element (b, c, x, y, z) at
// p[b * sb + c * sc + x * sx + y * sy + z]. Mirrored by a ctypes.Structure
// in radiation/source.py.
struct View5 {
  float* p;
  long long sb, sc, sx, sy;
};

// The operands of one launch (radiation/source.py `_SourceViews`).
struct SourceViews {
  View5 gas, rad, gas_out, rad_out;  // 6 and 4 components
  View5 src;                          // [B, X, Y, Z] (sc unused); p null: none
  const unsigned char* keep;          // [B, X, Y, Z] contiguous; null: all
  long long B, X, Y, Z;
};

__device__ __forceinline__ long long at(const View5& v, int b, int x, int y,
                                        int z) {
  return b * v.sb + x * v.sx + y * v.sy + z;
}

template <bool kConstOpacity>
__global__ void __launch_bounds__(THREADS, 4) rad_source_kernel(SourceViews v,
                                                             float dt,
                                                             int stage,
                                                             RadParams p) {
  const int Y = (int)v.Y, Z = (int)v.Z;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;  // cell of block b
  if (r >= (int)(v.X * v.Y * v.Z)) return;
  const int b = blockIdx.y;
  const int x = r / (Y * Z), y = (r / Z) % Y, z = r % Z;
  const long long og = at(v.gas, b, x, y, z), orad = at(v.rad, b, x, y, z);
  float u[NVR];
#pragma unroll
  for (int c = 0; c < RS; ++c) u[c] = v.gas.p[og + c * v.gas.sc];
#pragma unroll
  for (int k = 0; k < 4; ++k) u[RS + k] = v.rad.p[orad + k * v.rad.sc];
  if (v.keep == nullptr || v.keep[(long long)b * v.X * v.Y * v.Z + r]) {
    const bool has_src = v.src.p != nullptr;
    source_cell<kConstOpacity>(u, has_src ? v.src.p[at(v.src, b, x, y, z)] : 0.0f,
                               has_src, dt, stage, p);
  }
  const long long wg = at(v.gas_out, b, x, y, z), wr = at(v.rad_out, b, x, y, z);
#pragma unroll
  for (int c = 0; c < RS; ++c) v.gas_out.p[wg + c * v.gas_out.sc] = u[c];
#pragma unroll
  for (int k = 0; k < 4; ++k) v.rad_out.p[wr + k * v.rad_out.sc] = u[RS + k];
}

}  // namespace qk

extern "C" int qk_rad_source(const qk::SourceViews* v, float dt, int stage,
                             const qk::RadParams* p, void* stream) {
  const long long ncell = v->X * v->Y * v->Z;
  const dim3 blocks((unsigned)((ncell + qk::THREADS - 1) / qk::THREADS), (unsigned)v->B);
  auto kernel = qk::constant_opacity(*p) ? qk::rad_source_kernel<true>
                                         : qk::rad_source_kernel<false>;
  kernel<<<blocks, qk::THREADS, 0, (cudaStream_t)stream>>>(*v, dt, stage, *p);
  return (int)cudaGetLastError();
}
