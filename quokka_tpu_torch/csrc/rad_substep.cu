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
// (rad_transport_axis_kernel), each give a block a tile of 32 cells along
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

constexpr int K4_THREADS = 256;

// One axis of the transport divergence, a tile of K4_TA cells along the
// axis by K4_TW lines across it a block (the lines run along z, the
// contiguous axis, for the x and y sweeps and along y for the z sweep; the
// third coordinate is fixed), in four phases separated by __syncthreads:
//   1. stage cells -3 .. K4_TA + 2 (the periodic wrap resolved once a cell
//      staged): the 4 conserved values and the primitives, f = F / (c E);
//   2. the face states (minus, plus) of cells -1 .. K4_TA, once a cell;
//   3. the HLL flux of faces 0 .. K4_TA (face f between cells f - 1 and f)
//      from qL = plus(f - 1), qR = minus(f), in the primitives' place;
//   4. each cell's (F(lo) - F(hi)) * inv_dx, written to div (the first
//      axis) or added onto it (the JAX order: ((x + y) + z)).
constexpr int K4_TA = 32;         // cells along the axis a block
constexpr int K4_TW = 16;         // lines across it
constexpr int K4_SA = K4_TA + 6;  // staged cells along the axis
constexpr int K4_RA = K4_TA + 2;  // reconstructed cells
constexpr int K4_FA = K4_TA + 1;  // faces

// Shared-memory index of (along j, across i) in a [n_along][K4_TW] tile:
// the contiguous global axis is the fastest one in shared memory too.
template <int axis, int n_along>
__device__ __forceinline__ int pidx(int j, int i) {
  return axis == 2 ? i * n_along + j : j * K4_TW + i;
}

template <int axis, int n_along>
__device__ __forceinline__ void ppos(int e, int& j, int& i) {
  if (axis == 2) {
    j = e % n_along;
    i = e / n_along;
  } else {
    j = e / K4_TW;
    i = e % K4_TW;
  }
}

template <int axis>
__global__ void __launch_bounds__(K4_THREADS) rad_transport_axis_kernel(
    const float* __restrict__ R, float* __restrict__ div, int X, int Y, int Z, int first,
    RadParams p) {
  __shared__ float cons_s[4][K4_SA * K4_TW];
  __shared__ float pf_s[4][K4_SA * K4_TW];  // primitives, then the face fluxes
  __shared__ float minus_s[4][K4_RA * K4_TW];
  __shared__ float plus_s[4][K4_RA * K4_TW];

  const int64_t ncell = (int64_t)X * Y * Z;
  const int n = axis == 0 ? X : (axis == 1 ? Y : Z);
  const int n_across = axis == 2 ? Y : Z;
  const int64_t stride_a = axis == 0 ? (int64_t)Y * Z : (axis == 1 ? Z : 1);
  const int64_t stride_c = axis == 2 ? Z : 1;
  const int64_t stride_f = axis == 0 ? Z : (int64_t)Y * Z;
  const int tiles_a = (n + K4_TA - 1) / K4_TA;
  const int tiles_c = (n_across + K4_TW - 1) / K4_TW;
  int t = blockIdx.x;
  const int ta = t % tiles_a;
  t /= tiles_a;
  const int tc = t % tiles_c;
  const int fixed = t / tiles_c;
  const int a0 = ta * K4_TA;
  const int c0 = tc * K4_TW;
  const int cells = min(K4_TA, n - a0);
  const int lines = min(K4_TW, n_across - c0);
  const int64_t base = fixed * stride_f + c0 * stride_c;

  // 1. stage cells a0-3 .. a0+cells+2
  for (int e = threadIdx.x; e < K4_SA * K4_TW; e += K4_THREADS) {
    int j, i;
    ppos<axis, K4_SA>(e, j, i);
    if (j >= cells + 6 || i >= lines) continue;
    int a = a0 - 3 + j;  // |wrap| < n: n >= 4
    a = a < 0 ? a + n : (a >= n ? a - n : a);
    const int64_t off = base + a * stride_a + i * stride_c;
    const int s = pidx<axis, K4_SA>(j, i);
    float c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = R[k * ncell + off];
    const float cE = p.c * c[0];
    cons_s[0][s] = c[0];
    pf_s[0][s] = c[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      cons_s[k][s] = c[k];
      pf_s[k][s] = c[k] / cE;
    }
  }
  __syncthreads();

  // 2. face states of cells a0-1 .. a0+cells (slot r, staged j = r + 2)
  for (int e = threadIdx.x; e < K4_RA * K4_TW; e += K4_THREADS) {
    int r, i;
    ppos<axis, K4_RA>(e, r, i);
    if (r > cells + 1 || i >= lines) continue;
    const int o = pidx<axis, K4_RA>(r, i);
    constexpr int sa = axis == 2 ? 1 : K4_TW;  // staged neighbour along the axis
    const int s = pidx<axis, K4_SA>(r + 2, i);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* w = pf_s[k] + s;
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

  // 3. the HLL flux of faces a0 .. a0+cells; no thread reads the primitives
  // any more, so the fluxes take their place
  for (int e = threadIdx.x; e < K4_FA * K4_TW; e += K4_THREADS) {
    int f, i;
    ppos<axis, K4_FA>(e, f, i);
    if (f > cells || i >= lines) continue;
    // face f lies between reconstructed cells f and f+1 (staged f+2, f+3)
    const int oL = pidx<axis, K4_RA>(f, i);
    const int oR = pidx<axis, K4_RA>(f + 1, i);
    const int sL = pidx<axis, K4_SA>(f + 2, i);
    const int sR = pidx<axis, K4_SA>(f + 3, i);
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
    const int o = pidx<axis, K4_FA>(f, i);
#pragma unroll
    for (int k = 0; k < 4; ++k) pf_s[k][o] = F[k];
  }
  __syncthreads();

  // 4. (F(lo) - F(hi)) * inv_dx of cells a0 .. a0+cells-1
  for (int e = threadIdx.x; e < K4_TA * K4_TW; e += K4_THREADS) {
    int c, i;
    ppos<axis, K4_TA>(e, c, i);
    if (c >= cells || i >= lines) continue;
    const int64_t off = base + (a0 + c) * stride_a + i * stride_c;
    const int lo = pidx<axis, K4_FA>(c, i), hi = pidx<axis, K4_FA>(c + 1, i);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float d = (pf_s[k][lo] - pf_s[k][hi]) * p.inv_dx[axis];
      div[k * ncell + off] = first ? d : div[k * ncell + off] + d;
    }
  }
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
  const long long tiles[3] = {
      (X + K4_TA - 1) / K4_TA * ((Z + K4_TW - 1) / K4_TW) * Y,
      (Y + K4_TA - 1) / K4_TA * ((Z + K4_TW - 1) / K4_TW) * X,
      (Z + K4_TA - 1) / K4_TA * ((Y + K4_TW - 1) / K4_TW) * X};
  rad_transport_axis_kernel<0><<<(unsigned)tiles[0], K4_THREADS, 0, stream>>>(
      R, div, (int)X, (int)Y, (int)Z, 1, p);
  rad_transport_axis_kernel<1><<<(unsigned)tiles[1], K4_THREADS, 0, stream>>>(
      R, div, (int)X, (int)Y, (int)Z, 0, p);
  rad_transport_axis_kernel<2><<<(unsigned)tiles[2], K4_THREADS, 0, stream>>>(
      R, div, (int)X, (int)Y, (int)Z, 0, p);
  return (int)cudaGetLastError();
}

}  // namespace qk

// Shared-memory bytes of a transport block (all of it static).
extern "C" int qk_rad_stage_smem() {
  return (int)(4 * sizeof(float) *
               (2 * qk::K4_SA * qk::K4_TW + 2 * qk::K4_RA * qk::K4_TW));
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
