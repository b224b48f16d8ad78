// K7: the M1 radiation face flux along one axis.
//
// Replaces quokka_tpu/radiation/pallas_sweep.py::compute_rad_axis_flux_pallas
// (def :23, pallas_call :53) for one photon group: PPM / PLM / donor-cell
// faces of the (E, f) primitives, the donor-cell fallback on inadmissible
// faces (E <= 0 or |f|^2 >= 1), and the frozen-Eddington HLL flux
// [B, 1, 4, X, Y, Z], slot f the face between cells f-1 and f. Its callers
// are compute_rad_fluxes (radiation/system.py), whose flux dicts the dense
// AMR levels' flux registers consume, and the packed engine's chunks (B
// ghost-padded radiation blocks [B, 4, X, Y, Z], one launch a chunk and
// axis; blockIdx.y picks the block).
//
// Layout: the padded array wraps periodically in index space, exactly as
// the JAX kernel's in-block rolls do; the wrap reaches ghost faces only,
// which the callers discard.
//
// Design: each cell is loaded once, its primitives are formed once and its
// reconstruction is done once. A thread block owns a tile of TILE_A faces
// along the axis by TILE_W lines across it (the tile's lines run along z,
// the contiguous axis, for the x and y sweeps and along y for the z sweep;
// the third coordinate is fixed), and stages the cells the tile reads,
// TILE_A + 5 along the axis (3 below, 2 above; the periodic wrap resolved
// once per cell staged), in shared memory in three phases separated by
// __syncthreads:
//   1. load the 4 conserved values of each staged cell (neighbouring
//      threads on neighbouring addresses, so every load is coalesced) and
//      form its primitives (f = F / (c E), 3 divisions a cell where the
//      one-thread-a-face form did 18 a face);
//   2. reconstruct each cell the faces need (TILE_A + 1 of them): both its
//      face states (minus, plus) per component, PPM (ppm_cell), PLM or
//      donor cell;
//   3. the HLL flux of each face from qL = plus(f-1), qR = minus(f) and the
//      two cells' conserved values (rad_common.cuh hll_face), stored
//      coalesced.
// The formulas and their order of operations are those of the plain
// version (and of the one-thread-a-face kernel this replaces), and the
// library is built with -fmad=false, so the result is bitwise the same.
// Offsets inside one component of one block are 32-bit (the wrapper holds
// 4 X Y Z below 2^31); the block's base is 64-bit.
//
// Bound on the H100: bytes. 16 B are read and 16 B written a cell against
// roughly 272 FP32 operations (primitives, PPM of 4 components, one HLL
// face; counted once a cell): at the fine level's padded 520^3 the 4.5 GB
// take >= 1.34 ms at 3.35 TB/s, the operations >= 0.57 ms at 67 TFLOP/s.
// The IEEE divisions and square roots (7 and 4 a face in the HLL flux, 3
// divisions a cell in the primitives) are instruction sequences, and
// -fmad=false keeps every product and sum apart, so in practice the
// kernel is bound by instruction issue; the tile removes the 6x re-reading
// and re-forming of each cell's primitives and the 2x reconstruction of
// the one-thread-a-face form.
#include "rad_common.cuh"

namespace qk {

constexpr int K7_THREADS = 256;
constexpr int TILE_A = 32;              // faces along the axis
constexpr int TILE_W = 16;              // lines across it
constexpr int STAGE_A = TILE_A + 5;     // staged cells along the axis
constexpr int RECON_A = TILE_A + 1;     // reconstructed cells along the axis

// Shared-memory index of (along j, across i) in a [n_along][TILE_W] tile:
// the contiguous global axis is the fastest one in shared memory too.
template <int axis, int n_along>
__device__ __forceinline__ int tidx(int j, int i) {
  return axis == 2 ? i * n_along + j : j * TILE_W + i;
}

// Element e of a [n_along][TILE_W] tile as (along j, across i), neighbouring
// e on neighbouring global (and shared) addresses.
template <int axis, int n_along>
__device__ __forceinline__ void tile_pos(int e, int& j, int& i) {
  if (axis == 2) {
    j = e % n_along;
    i = e / n_along;
  } else {
    j = e / TILE_W;
    i = e % TILE_W;
  }
}

template <int axis>
__global__ void __launch_bounds__(K7_THREADS) rad_axis_flux_kernel(
    const float* __restrict__ R, float* __restrict__ flux, int X, int Y, int Z,
    RadParams p) {
  __shared__ float cons_s[4][STAGE_A * TILE_W];
  __shared__ float prim_s[4][STAGE_A * TILE_W];
  __shared__ float minus_s[4][RECON_A * TILE_W];
  __shared__ float plus_s[4][RECON_A * TILE_W];

  const int ncell = X * Y * Z;
  {  // batch index: block b of a [B, 4, X, Y, Z] chunk (B = 1 unbatched)
    const int64_t base = static_cast<int64_t>(blockIdx.y) * 4 * ncell;
    R += base;
    flux += base;
  }
  // the axis, the across direction and the fixed third coordinate
  const int n = axis == 0 ? X : (axis == 1 ? Y : Z);
  const int n_across = axis == 2 ? Y : Z;
  const int stride_a = axis == 0 ? Y * Z : (axis == 1 ? Z : 1);
  const int stride_c = axis == 2 ? Z : 1;
  const int stride_f = axis == 1 ? Y * Z : (axis == 0 ? Z : Y * Z);
  const int tiles_a = (n + TILE_A - 1) / TILE_A;
  const int tiles_c = (n_across + TILE_W - 1) / TILE_W;
  int t = blockIdx.x;
  const int ta = t % tiles_a;
  t /= tiles_a;
  const int tc = t % tiles_c;
  const int fixed = t / tiles_c;
  const int a0 = ta * TILE_A;
  const int c0 = tc * TILE_W;
  const int faces_a = min(TILE_A, n - a0);
  const int lines = min(TILE_W, n_across - c0);
  const int base = fixed * stride_f + c0 * stride_c;

  // 1. stage cells a0-3 .. a0+faces_a+1: conserved values and primitives
  for (int e = threadIdx.x; e < STAGE_A * TILE_W; e += K7_THREADS) {
    int j, i;
    tile_pos<axis, STAGE_A>(e, j, i);
    if (j >= faces_a + 5 || i >= lines) continue;
    int a = a0 - 3 + j;  // |wrap| < n: n >= 4
    a = a < 0 ? a + n : (a >= n ? a - n : a);
    const int off = base + a * stride_a + i * stride_c;
    const int s = tidx<axis, STAGE_A>(j, i);
    float c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = R[k * ncell + off];
    const float cE = p.c * c[0];
    cons_s[0][s] = c[0];
    prim_s[0][s] = c[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      cons_s[k][s] = c[k];
      prim_s[k][s] = c[k] / cE;
    }
  }
  __syncthreads();

  // 2. face states of cells a0-1 .. a0+faces_a-1 (staged j = 2 .. faces_a+2)
  for (int e = threadIdx.x; e < RECON_A * TILE_W; e += K7_THREADS) {
    int r, i;
    tile_pos<axis, RECON_A>(e, r, i);
    if (r > faces_a || i >= lines) continue;
    const int j = r + 2;
    const int o = tidx<axis, RECON_A>(r, i);
    constexpr int sa = axis == 2 ? 1 : TILE_W;  // staged neighbour along the axis
    const int s = tidx<axis, STAGE_A>(j, i);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* w = prim_s[k] + s;
      float m, pl;
      if (p.recon_order == 3) {
        ppm_cell(w[-2 * sa], w[-sa], w[0], w[sa], w[2 * sa], m, pl);
      } else if (p.recon_order == 2) {
        const float slope = minmod(w[sa] - w[0], w[0] - w[-sa]);
        pl = w[0] + 0.5f * slope;
        m = w[0] - 0.5f * slope;
      } else {
        m = w[0];
        pl = w[0];
      }
      minus_s[k][o] = m;
      plus_s[k][o] = pl;
    }
  }
  __syncthreads();

  // 3. the HLL flux of faces a0 .. a0+faces_a-1
  for (int e = threadIdx.x; e < TILE_A * TILE_W; e += K7_THREADS) {
    int fa, i;
    tile_pos<axis, TILE_A>(e, fa, i);
    if (fa >= faces_a || i >= lines) continue;
    // face fa lies between reconstructed cells fa and fa+1 (staged fa+2, fa+3)
    const int oL = tidx<axis, RECON_A>(fa, i);
    const int oR = tidx<axis, RECON_A>(fa + 1, i);
    const int sL = tidx<axis, STAGE_A>(fa + 2, i);
    const int sR = tidx<axis, STAGE_A>(fa + 3, i);
    float qL[4], qR[4], cL[4], cR[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      qL[k] = plus_s[k][oL];
      qR[k] = minus_s[k][oR];
      cL[k] = cons_s[k][sL];
      cR[k] = cons_s[k][sR];
    }
    float F[4];
    hll_face<axis>(qL, qR, cL, cR, p, F);
    const int off = base + (a0 + fa) * stride_a + i * stride_c;
#pragma unroll
    for (int k = 0; k < 4; ++k) flux[k * ncell + off] = F[k];
  }
}

}  // namespace qk

extern "C" int qk_rad_axis_flux(const float* R, float* flux, long long X,
                                long long Y, long long Z, long long nbatch,
                                int axis, const qk::RadParams* p,
                                void* stream) {
  const long long n = axis == 0 ? X : (axis == 1 ? Y : Z);
  const long long n_across = axis == 2 ? Y : Z;
  const long long fixed = axis == 0 ? Y : X;
  const long long tiles = ((n + qk::TILE_A - 1) / qk::TILE_A) *
                          ((n_across + qk::TILE_W - 1) / qk::TILE_W) * fixed;
  const dim3 blocks((unsigned)tiles, (unsigned)nbatch);
  auto kernel = axis == 0 ? qk::rad_axis_flux_kernel<0>
                : (axis == 1 ? qk::rad_axis_flux_kernel<1>
                             : qk::rad_axis_flux_kernel<2>);
  kernel<<<blocks, qk::K7_THREADS, 0, (cudaStream_t)stream>>>(R, flux, (int)X, (int)Y,
                                                              (int)Z, *p);
  return (int)cudaGetLastError();
}
