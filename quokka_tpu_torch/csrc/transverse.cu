// K1: the transverse fields of the hydro sweep, every active axis in one
// launch.
//
// Replaces quokka_tpu/hydro/pallas_sweep.py::precompute_transverse_pallas
// (the pallas_call at :187). For every active axis t and every cell c it
// writes
//   dmin_t(c) = min(v_t(c+1) - v_t(c), v_t(c) - v_t(c-1)),
// and, with PPM flattening, the folded
//   chi_cell(c) = min(min(m3_0(c), m3_1(c)), m3_2(c)),
//   m3_t(c) = min(chi_t(c-1), chi_t(c), chi_t(c+1)),
// chi_t the Miller & Colella flattening coefficient along t
// (reconstruct.flattening_chi), over the active axes in their order, with
// the NaN-propagating min (what the JAX package folds in XLA). No per-axis
// chi leaves the kernel. Its one reader in the JAX package, the exact
// outflow ghost planes (pallas_sweep.py:215-245), is K1's second pass,
// launched after the march only when a side is an outflow side: for each
// outflow side of an axis d it writes the plane
//   ghost_d = min(chi_d(edge), min over t != d of m3_t(edge)),
// the chi_cell of the wall-adjacent ghost cell that K2 reads there
// (hydro.sweep.outflow_chi_planes), one thread an edge cell, from the
// state (19 cells a plane cell with three axes; the planes hold 1/n of the
// cells). Folded into the march instead, the planes' code cost every
// launch of the march, outflow or not, 2-80% on the H100 (PERF.md): the
// march is held at 80 registers and its spills move with any code added.
//
// Batched: blockIdx.y picks a block of a [B, 6, X, Y, Z] chunk (the packed
// AMR engine's ghost-padded tiles, one launch a chunk).
//
// Walls are never stored: a cell outside the domain along one axis is read
// through the periodic/reflect/outflow index map (common.cuh: map_cell); a
// mirrored read flips that axis's velocity and an outflow read copies the
// edge cell, which reproduces the JAX kernel's in-VMEM ghost assembly value
// for value. With is_cons the input
// is the conserved state and cons->prim runs once a staged cell.
//
// Design: a march along x. A block owns a TY x TZ column tile and walks SX
// planes along x (+3 on each side). Each thread keeps its column's x
// stencil (7 planes of P, v_x, rho; 3 of chi_x) in registers and shifts it
// a plane at a time; each plane's y and z stencils (the plane's cells and a
// cross-shaped halo of 3) go through shared memory (two buffers,
// alternating), and their m3 wait 3 planes in registers for the x fold.
// The next plane's cells are loaded into registers while this plane's are
// worked on. Each cell's primitives (rho, the pressure of the flattening,
// the velocity) are formed once, and the halo's: 6/TY + 6/TZ + 6/SX of a
// conversion a cell. A 3D tile with a cross-shaped halo staged one axis at
// a time ran 1.6-2.0x slower on the H100 (more halo conversions, the x
// stencil through shared memory too).
//
// The formulas and their order of operations are those of the plain
// version and of the one-axis-a-launch kernel these replace, and the
// library is built with -fmad=false, so dmin and chi_cell are the same
// bits.
//
// Bound on the H100: bytes. A cell's 6 components are read once (24 B) and
// dmin (one float an active axis) and chi_cell written once: 40 B a cell
// with three axes and flattening. Each cell's cons->prim (3 divisions) and
// chi per axis (2 divisions, a square root) is computed once, plus the
// halo's share.
#include "common.cuh"

namespace qk {

constexpr int K1_THREADS = 256;
constexpr int K1_SMEM_MAX = 48 * 1024;   // bytes of shared memory a block takes at most

// The march's parameters, the fields of its form before outflow walls:
// six plane pointers and an outflow word appended here, unused, cost every
// launch 4-5% on the H100 (PERF.md), so the outflow bits share `walls` and
// the planes are the second pass's parameters (K1Planes).
struct K1Args {
  const float* U;
  float* dmin[3];  // one [B, X, Y, Z] field an active axis, else null
  float* chi;      // chi_cell [B, X, Y, Z], or null without flattening
  int X, Y, Z;
  int axes;   // bit t: axis t is active
  int walls;  // bit 2t / 2t+1: lo / hi wall of axis t reflects; 6+2t / 7+2t: outflow
  int is_cons, do_chi;
  int T[3];   // tile: SX planes of TY x TZ columns
  Eos e;
};

// chi of the middle cell from P at offsets -2..2, rho at 0 and v at -1, 1.
__device__ __forceinline__ float chi_of(float Pm2, float Pm1, float P0, float Pp1,
                                        float Pp2, float rho0, float vm1, float vp1,
                                        const Eos& e) {
  const float bd = fabsf(Pp2 - Pm2);
  const float num = fabsf(Pp1 - Pm1);
  const float beta = (bd != 0.0f) ? num / bd : 0.0f;
  const float chi_min =
      mn(mx(((float)0.85 - beta) / (float)(0.85 - 0.75), 0.0f), 1.0f);
  const float cs = sqrtf((e.gamma * P0) / rho0);
  const float k_s = (cs * cs) * rho0;
  const float z = num / k_s;
  const bool converging = vp1 < vm1;
  const float chi_conv =
      mx(chi_min, mn(1.0f, ((float)0.75 - z) / (float)(0.75 - 0.25)));
  return converging ? chi_conv : 1.0f;
}

// The BC_* code of side `side` (0 lo, 1 hi) of axis t.
__device__ __forceinline__ int wall_of(const K1Args& A, int t, int side) {
  const int bit = 2 * t + side;
  if ((A.walls >> (6 + bit)) & 1) return BC_OUTFLOW;
  return (A.walls >> bit) & 1;
}

// Shared memory (floats), two buffers that alternate plane by plane (so a
// plane needs two __syncthreads, not three): the plane's y stencil rho, P,
// v_y [3][(TY + 6) TZ] (row a + 3 for y offset a, z fastest), its z stencil
// rho, P, v_z [3][TY (TZ + 6)] (z fastest), chi_y [(TY + 2) TZ] and chi_z
// [TY (TZ + 2)]. The plane's halo (6 TZ + 6 TY <= 2 K1_THREADS cells) is
// spread over the threads, at most K1_HALO_SLOTS cells each; every thread
// loads the next plane's column cell and halo cells into registers while it
// works on this plane's.

constexpr int K1_HALO_SLOTS = 2;

__device__ __forceinline__ int k1_march_buffer_floats(int TY, int TZ) {
  return 3 * (TY + 6) * TZ + 3 * TY * (TZ + 6) + (TY + 2) * TZ + TY * (TZ + 2);
}

__device__ __forceinline__ void load6(const float* __restrict__ U, int64_t ncell, int64_t off,
                                      float q[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) q[k] = U[k * ncell + off];
}

// rho, the flattening's pressure and the velocity of a cell from its 6
// loaded values, as load_prim and the per-axis stencil formed them
__device__ __forceinline__ void prim_of(float q[NV], int is_cons, const Eos& e, float& rho,
                                        float& P, float v[3]) {
  if (is_cons) cons_to_prim(q, e);
  rho = q[0];
  v[0] = q[1];
  v[1] = q[2];
  v[2] = q[3];
  P = e.reconstruct_eint ? e.gm1 * (q[0] * q[4]) : q[4];
}

// Held to at most 85 registers (3 blocks a multiprocessor): 10-16% faster on the
// H100 than the 123 it takes unbounded (2 blocks).
__global__ void __launch_bounds__(K1_THREADS, 3) transverse_kernel_march(K1Args A) {
  extern __shared__ float sm[];
  const int SX = A.T[0], TY = A.T[1], TZ = A.T[2];
  const int64_t ncell = (int64_t)A.X * A.Y * A.Z;
  const int64_t plane_n = (int64_t)A.Y * A.Z;
  const float* U = A.U + (int64_t)blockIdx.y * NV * ncell;
  const int64_t bo = (int64_t)blockIdx.y * ncell;
  int x0, y0, z0;
  {
    int b = blockIdx.x;
    const int tz = (A.Z + TZ - 1) / TZ, ty = (A.Y + TY - 1) / TY;
    z0 = (b % tz) * TZ;
    b /= tz;
    y0 = (b % ty) * TY;
    x0 = (b / ty) * SX;
  }
  const int LX = min(SX, A.X - x0), LY = min(TY, A.Y - y0), LZ = min(TZ, A.Z - z0);
  const bool ax = A.axes & 1, ay = (A.axes >> 1) & 1, az = (A.axes >> 2) & 1;
  const int nbuf = k1_march_buffer_floats(TY, TZ);
  const int ny = (TY + 6) * TZ, nz = TY * (TZ + 6);
  const int lo0 = wall_of(A, 0, 0), hi0 = wall_of(A, 0, 1);

  const int j = threadIdx.x / TZ, k = threadIdx.x % TZ;
  const bool col = threadIdx.x < TY * TZ && j < LY && k < LZ;
  const int64_t col_off = (int64_t)(y0 + j) * A.Z + (z0 + k);

  // this thread's halo cells of every plane: offset in the plane, the
  // stencil array (1: y, 2: z; 0: none), the index in it, the mirror flip
  int64_t h_off[K1_HALO_SLOTS];
  int h_kind[K1_HALO_SLOTS], h_idx[K1_HALO_SLOTS];
  bool h_flip[K1_HALO_SLOTS];
#pragma unroll
  for (int sl = 0; sl < K1_HALO_SLOTS; ++sl) {
    const int e = threadIdx.x + sl * K1_THREADS;
    const int ey = ay ? 6 * TZ : 0;
    h_kind[sl] = 0;
    h_off[sl] = 0;
    h_idx[sl] = 0;
    h_flip[sl] = false;
    if (e < ey) {
      const int h = e / TZ, kk = e % TZ;
      if (kk < LZ) {
        const int a = h < 3 ? h - 3 : LY + h - 3;
        bool flip;
        const int64_t ym =
            map_cell(y0 + a, A.Y, wall_of(A, 1, 0), wall_of(A, 1, 1), flip);
        h_kind[sl] = 1;
        h_off[sl] = ym * A.Z + (z0 + kk);
        h_idx[sl] = (a + 3) * TZ + kk;
        h_flip[sl] = flip;
      }
    } else if (az && e - ey < 6 * TY) {
      const int h = (e - ey) % 6, jj = (e - ey) / 6;
      if (jj < LY) {
        const int a = h < 3 ? h - 3 : LZ + h - 3;
        bool flip;
        const int64_t zm =
            map_cell(z0 + a, A.Z, wall_of(A, 2, 0), wall_of(A, 2, 1), flip);
        h_kind[sl] = 2;
        h_off[sl] = (int64_t)(y0 + jj) * A.Z + zm;
        h_idx[sl] = jj * (TZ + 6) + a + 3;
        h_flip[sl] = flip;
      }
    }
  }

  // the column's x stencil, plane p - 6 + i at [i]; chi_x of planes p - 4 ..
  // p - 2; m3_y and m3_z of planes p - 3 .. p
  float Pq[7], vq[7], rq[7], cq[3], my[4], mz[4];
#pragma unroll
  for (int i = 0; i < 7; ++i) Pq[i] = vq[i] = rq[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    my[i] = mz[i] = 0.0f;
    if (i < 3) cq[i] = 0.0f;
  }
  // the next plane's raw values, loaded one plane ahead
  float nq[NV], nh[K1_HALO_SLOTS][NV];
  bool nflip = false;
  const int p_end = x0 + LX + 3;
  auto fetch = [&](int p) {
    if (col) {
      const int64_t xm = map_cell(p, A.X, lo0, hi0, nflip);
      load6(U, ncell, xm * plane_n + col_off, nq);
    }
    if (p >= x0 && p < x0 + LX) {
#pragma unroll
      for (int sl = 0; sl < K1_HALO_SLOTS; ++sl)
        if (h_kind[sl]) load6(U, ncell, (int64_t)p * plane_n + h_off[sl], nh[sl]);
    }
  };
  fetch(x0 - 3);

  for (int p = x0 - 3; p < p_end; ++p) {
    float q[NV], hq[K1_HALO_SLOTS][NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      q[v] = nq[v];
#pragma unroll
      for (int sl = 0; sl < K1_HALO_SLOTS; ++sl) hq[sl][v] = nh[sl][v];
    }
    const bool flip = nflip;
    if (p + 1 < p_end) fetch(p + 1);

    float rho = 0.0f, P = 0.0f, v[3] = {0.0f, 0.0f, 0.0f};
    if (col) {
      prim_of(q, A.is_cons, A.e, rho, P, v);
      if (flip) v[0] = -v[0];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      Pq[i] = Pq[i + 1];
      vq[i] = vq[i + 1];
      rq[i] = rq[i + 1];
    }
    Pq[6] = P;
    vq[6] = v[0];
    rq[6] = rho;
    cq[0] = cq[1];
    cq[1] = cq[2];
    if (ax && A.do_chi && p >= x0 + 1)  // chi_x of plane p - 2
      cq[2] = chi_of(Pq[2], Pq[3], Pq[4], Pq[5], Pq[6], rq[4], vq[3], vq[5], A.e);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      my[i] = my[i + 1];
      mz[i] = mz[i + 1];
    }

    if (p >= x0 && p < x0 + LX && (ay || az)) {  // the plane's y and z stencils
      float* buf = sm + ((p - x0) & 1) * nbuf;
      float* rho_y = buf;
      float* P_y = rho_y + ny;
      float* v_y = P_y + ny;
      float* rho_z = v_y + ny;
      float* P_z = rho_z + nz;
      float* v_z = P_z + nz;
      float* chi_y = v_z + nz;
      float* chi_z = chi_y + (TY + 2) * TZ;
      if (col) {
        rho_y[(j + 3) * TZ + k] = rho;
        P_y[(j + 3) * TZ + k] = P;
        v_y[(j + 3) * TZ + k] = v[1];
        rho_z[j * (TZ + 6) + k + 3] = rho;
        P_z[j * (TZ + 6) + k + 3] = P;
        v_z[j * (TZ + 6) + k + 3] = v[2];
      }
#pragma unroll
      for (int sl = 0; sl < K1_HALO_SLOTS; ++sl) {
        if (!h_kind[sl]) continue;
        float r2, P2, v2[3];
        prim_of(hq[sl], A.is_cons, A.e, r2, P2, v2);
        const int t = h_kind[sl];  // the axis of the offset
        float* rr = t == 1 ? rho_y : rho_z;
        float* pp = t == 1 ? P_y : P_z;
        float* vv = t == 1 ? v_y : v_z;
        rr[h_idx[sl]] = r2;
        pp[h_idx[sl]] = P2;
        const float vt = t == 1 ? v2[1] : v2[2];
        vv[h_idx[sl]] = h_flip[sl] ? -vt : vt;
      }
      __syncthreads();
      if (A.do_chi) {
        if (ay) {
          for (int e = threadIdx.x; e < (TY + 2) * TZ; e += K1_THREADS) {
            const int r = e / TZ, kk = e % TZ;  // y offset r - 1
            if (r > LY + 1 || kk >= LZ) continue;
            const int b = (r + 2) * TZ + kk;  // its row in the stencil
            chi_y[e] = chi_of(P_y[b - 2 * TZ], P_y[b - TZ], P_y[b], P_y[b + TZ],
                              P_y[b + 2 * TZ], rho_y[b], v_y[b - TZ], v_y[b + TZ], A.e);
          }
        }
        if (az) {
          for (int e = threadIdx.x; e < TY * (TZ + 2); e += K1_THREADS) {
            const int jj = e / (TZ + 2), r = e % (TZ + 2);  // z offset r - 1
            if (jj >= LY || r > LZ + 1) continue;
            const int b = jj * (TZ + 6) + r + 2;
            chi_z[e] = chi_of(P_z[b - 2], P_z[b - 1], P_z[b], P_z[b + 1], P_z[b + 2],
                              rho_z[b], v_z[b - 1], v_z[b + 1], A.e);
          }
        }
      }
      __syncthreads();
      if (col) {
        const int64_t g = bo + (int64_t)p * plane_n + col_off;
        if (ay) {
          const int b = (j + 3) * TZ + k;
          const float v0 = v_y[b];
          A.dmin[1][g] = mn(v_y[b + TZ] - v0, v0 - v_y[b - TZ]);
          if (A.do_chi)
            my[3] = mn(mn(chi_y[j * TZ + k], chi_y[(j + 1) * TZ + k]), chi_y[(j + 2) * TZ + k]);
        }
        if (az) {
          const int b = j * (TZ + 6) + k + 3;
          const float v0 = v_z[b];
          A.dmin[2][g] = mn(v_z[b + 1] - v0, v0 - v_z[b - 1]);
          if (A.do_chi) {
            const int c = j * (TZ + 2) + k;
            mz[3] = mn(mn(chi_z[c], chi_z[c + 1]), chi_z[c + 2]);
          }
        }
      }
      // the next plane works in the other buffer: the readers of this one
      // are past the next plane's first __syncthreads before it is reused
    }

    const int qx = p - 3;  // the plane whose x stencil is complete
    if (col && qx >= x0 && qx < x0 + LX) {
      const int64_t g = bo + (int64_t)qx * plane_n + col_off;
      float acc = 0.0f;
      if (ax) {
        A.dmin[0][g] = mn(vq[4] - vq[3], vq[3] - vq[2]);
        acc = mn(mn(cq[0], cq[1]), cq[2]);
      }
      if (A.do_chi) {
        if (ay) acc = ax ? mn(acc, my[0]) : my[0];
        if (az) acc = (ax || ay) ? mn(acc, mz[0]) : mz[0];
        A.chi[g] = acc;
      }
    }
  }
}

// The outflow chi planes, side s of axis t at [2t + s] (x: [B, Y, Z], y:
// [B, X, Z], z: [B, X, Y]), null where that side is not an outflow side.
struct K1Planes {
  float* p[6];
};

// chi_t of the cell c (c[t] may lie one cell outside the domain), from the
// five cells c[t] - 2 .. c[t] + 2 along t, each through t's walls as the
// march stages them (an outflow ghost copies the edge cell, a mirrored one
// flips v_t).
__device__ float chi_along(const K1Args& A, const float* __restrict__ U, int64_t ncell,
                           const int c[3], int t) {
  const int n = t == 0 ? A.X : (t == 1 ? A.Y : A.Z);
  const int lo = wall_of(A, t, 0), hi = wall_of(A, t, 1);
  float P[5], rho0 = 0.0f, vm = 0.0f, vp = 0.0f;
#pragma unroll
  for (int a = -2; a <= 2; ++a) {
    int q[3] = {c[0], c[1], c[2]};
    bool flip;
    q[t] = (int)map_cell(c[t] + a, n, lo, hi, flip);
    float v6[NV], rho, Pc, v[3];
    load6(U, ncell, ((int64_t)q[0] * A.Y + q[1]) * A.Z + q[2], v6);
    prim_of(v6, A.is_cons, A.e, rho, Pc, v);
    P[a + 2] = Pc;
    const float vt = flip ? -v[t] : v[t];
    if (a == 0) rho0 = rho;
    if (a == -1) vm = vt;
    if (a == 1) vp = vt;
  }
  return chi_of(P[0], P[1], P[2], P[3], P[4], rho0, vm, vp, A.e);
}

// K1's second pass: one thread a cell of the plane of side blockIdx.z % 2
// of axis blockIdx.z / 2 (a block of the batch a blockIdx.y), its chi_d
// folded with the other active axes' m3 in axis order, as the plain
// version folds them.
__global__ void __launch_bounds__(K1_THREADS) outflow_planes_kernel(K1Args A, K1Planes Q) {
  const int d = blockIdx.z / 2, side = blockIdx.z % 2;
  float* const out = Q.p[blockIdx.z];
  if (out == nullptr) return;
  const int n[3] = {A.X, A.Y, A.Z};
  const int u = d == 0 ? 1 : 0, w = d == 2 ? 1 : 2;  // the plane's axes, in order
  const int64_t m = (int64_t)n[u] * n[w];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int64_t ncell = (int64_t)A.X * A.Y * A.Z;
  const float* U = A.U + (int64_t)blockIdx.y * NV * ncell;
  int c[3];
  c[d] = side ? n[d] - 1 : 0;
  c[u] = (int)(i / n[w]);
  c[w] = (int)(i % n[w]);
  float g = chi_along(A, U, ncell, c, d);
  bool has_e = false;
  float E = 0.0f;
  for (int t = 0; t < 3; ++t) {
    if (t == d || !((A.axes >> t) & 1)) continue;
    int cm[3] = {c[0], c[1], c[2]}, cp[3] = {c[0], c[1], c[2]};
    cm[t] -= 1;
    cp[t] += 1;
    const float m3 = mn(mn(chi_along(A, U, ncell, cm, t), chi_along(A, U, ncell, c, t)),
                        chi_along(A, U, ncell, cp, t));
    E = has_e ? mn(E, m3) : m3;
    has_e = true;
  }
  out[(int64_t)blockIdx.y * m + i] = has_e ? mn(g, E) : g;
}

// Shared-memory bytes of a block: two buffers of a plane's stencils.
int k1_smem_bytes(int TY, int TZ) {
  return 8 * (3 * (TY + 6) * TZ + 3 * TY * (TZ + 6) + (TY + 2) * TZ + TY * (TZ + 2));
}

}  // namespace qk

extern "C" int qk_transverse_smem(int ty, int tz) { return qk::k1_smem_bytes(ty, tz); }

// `walls` holds the BC_* code of side s of axis t in bits 4t + 2s ..
// 4t + 2s + 1; a plane is given for each outflow side of an active axis
// with do_chi, and for no other side.
extern "C" int qk_transverse(const float* U, float* dmin0, float* dmin1, float* dmin2,
                             float* chi, float* x_lo, float* x_hi, float* y_lo, float* y_hi,
                             float* z_lo, float* z_hi, long long X, long long Y, long long Z,
                             long long nbatch, int axes, int walls, int is_cons,
                             int do_chi, float gamma, float gm1, float inv_gm1, float s_n,
                             int reconstruct_eint, int sx, int ty, int tz, void* stream) {
  qk::K1Args A;
  A.U = U;
  A.dmin[0] = dmin0;
  A.dmin[1] = dmin1;
  A.dmin[2] = dmin2;
  A.chi = chi;
  const qk::K1Planes Q = {{x_lo, x_hi, y_lo, y_hi, z_lo, z_hi}};
  bool planes = false;
  A.walls = 0;
  for (int t = 0; t < 3; ++t) {
    for (int side = 0; side < 2; ++side) {
      const int kind = (walls >> (4 * t + 2 * side)) & 3;
      if (kind == qk::BC_REFLECT) A.walls |= 1 << (2 * t + side);
      if (kind == qk::BC_OUTFLOW) A.walls |= 1 << (6 + 2 * t + side);
      const bool given = Q.p[2 * t + side] != nullptr;
      if (given != (kind == qk::BC_OUTFLOW && do_chi && (axes >> t & 1)))
        return (int)cudaErrorInvalidValue;
      planes = planes || given;
    }
  }
  A.X = (int)X;
  A.Y = (int)Y;
  A.Z = (int)Z;
  A.axes = axes;
  A.is_cons = is_cons;
  A.do_chi = do_chi;
  A.T[0] = sx;
  A.T[1] = ty;
  A.T[2] = tz;
  A.e = qk::Eos{gamma, gm1, inv_gm1, s_n, reconstruct_eint};
  const int smem = qk::k1_smem_bytes(ty, tz);
  if (sx < 1 || ty < 1 || tz < 1 || ty * tz > qk::K1_THREADS ||
      6 * (ty + tz) > qk::K1_HALO_SLOTS * qk::K1_THREADS || smem > qk::K1_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (Y + ty - 1) / ty * ((Z + tz - 1) / tz) * ((X + sx - 1) / sx);
  const dim3 blocks((unsigned)tiles, (unsigned)nbatch);
  qk::transverse_kernel_march<<<blocks, qk::K1_THREADS, smem, (cudaStream_t)stream>>>(A);
  if (planes) {
    long long m = Y * Z > X * Z ? Y * Z : X * Z;  // the largest plane
    m = m > X * Y ? m : X * Y;
    const dim3 pblocks((unsigned)((m + qk::K1_THREADS - 1) / qk::K1_THREADS), (unsigned)nbatch,
                       6);
    qk::outflow_planes_kernel<<<pblocks, qk::K1_THREADS, 0, (cudaStream_t)stream>>>(A, Q);
  }
  return (int)cudaGetLastError();
}
