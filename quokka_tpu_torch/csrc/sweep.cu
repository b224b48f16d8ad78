// K2: one hydro sweep along one axis -- face fluxes, face velocities and
// their divergence.
//
// Replaces quokka_tpu/hydro/pallas_sweep.py::compute_axis_flux_pallas (the
// pallas_call at :1148, body _sweep_body :314) for the variants the unigrid
// main paths run: wall or periodic axes, the divergence outputs
// (dx_axis), the stage-2 time average (avg_with), conserved input
// (state_is_cons), the first-order FOFC fluxes (donor cell + LLF), and the
// lean div-only sweep (K2c, below).
//
// Forms: every kernel below is a template (sweep.cuh) on the
// reconstruction, PPM or PLM (minmod), and on the number of passive
// scalars, 0-2, that follow the 6 gas components of the state ([6 + nsc,
// X, Y, Z]; mass scalars' fluxes rescaled to the mass flux). This file
// holds the device code's PPM form without scalars and the entry points;
// sweep_ppm1.cu, sweep_ppm2.cu and sweep_plm0-2.cu instantiate the other
// forms.
//
// Walls (`lo`, `hi`: common.cuh BC_*): a reflecting side mirrors the cells
// and flips the normal momentum, an outflow side copies the edge cell
// (map_cell), the two kinds freely mixed on one axis (reflect lo, outflow
// hi). On an outflow side chi_cell's wall-adjacent ghost (cell -1 or n) is
// read from K1's exact plane `chi_glo` / `chi_ghi` (pallas_sweep.py:828-843,
// :963-970; common.cuh load_chi), its other ghosts copy the edge cell, as
// do the dmin ghosts (:972-974); every K2 variant stages its cells through
// `stage_prims` and `reconstruct_cells`, so each takes them at once. The hi
// wall's face (slot n) goes to flux_hi / vel_hi on either kind, and the
// FOFC mask counts every wall ghost unflagged.
//
// face kernel (`face_tile_kernel`): a thread block owns a tile of `ta`
//   faces along the axis by `tw` lines across it (the lines run along z,
//   the contiguous axis, for the x and y sweeps and along y for the z
//   sweep; the third coordinate is fixed), and stages the cells the tile
//   reads in shared memory in three phases separated by __syncthreads:
//     1. load each of the ta + 5 cells a line needs (3 below the first
//        face, 2 above the last) once, through the wall index map
//        (common.cuh: periodic wrap, or the mirrored cell with its normal
//        momentum flipped), neighbouring threads on neighbouring
//        addresses, and convert it to primitives (state_is_cons) once;
//     2. reconstruct each of the ta + 1 cells the faces touch once: PPM
//        (ppm_cell) per component gives both its face states, blended with
//        the cell's chi; the cell's two dmin values are staged beside them;
//     3. each face builds its two states, qL = plus(f-1) and qR = minus(f),
//        and solves HLLC once with the carbuncle dw (CW84 viscosity when
//        K_visc > 0); F (state component order) and the face velocity are
//        written coalesced.
//   Face slot f lies between cells f-1 and f; on a wall axis slot n (the hi
//   wall) goes to the separate flux_hi / vel_hi planes. The expressions and
//   their order of operations are those of the one-thread-a-face form the
//   tile replaced, which computed each cell's primitives six times
//   and its reconstruction twice; with -fmad=false the fluxes are the same
//   bits (kernel_times.py --compare). Phases 1 and 2 are `stage_prims` and
//   `reconstruct_cells`, which K2c's tile shares.
//   `hydro.sweep._face_tile` picks (ta, tw) for the axis's face count and
//   line count: up to 40 faces along, up to 512 faces a tile, ~40 KB of
//   shared memory. __launch_bounds__(256, 4) holds a thread to 64
//   registers without spills, so four blocks (32 warps) fit a
//   multiprocessor; uncapped, the z sweep took 72 and ran 12% slower.
// first-order face kernel (`fo_face_kernel`): one thread per face, z
//   fastest, reads cells f-1 and f and solves LLF (the FOFC fallback
//   fluxes); no stencil is shared enough for a tile to pay.
// sweep kernel (`sweep_tile_kernel`, every sweep with dx_axis that is not
//   K2c): K2c's tile below (phases 1-3: each face its cells touch solved
//   once into shared memory), whose phase 3 also
//     - stage 1 (mode 1): writes the faces the tile owns to global memory,
//       coalesced as the face kernel writes them (slots a0 .. a0+ta-1, and
//       on a wall axis the hi-wall plane from the line's last tile); the
//       caller needs them, since the FOFC fallback re-blends them;
//     - stage 2 (mode 2, avg_with): reads stage 1's face at each slot (the
//       hi-wall plane F1_hi / v1_hi for slot n on a wall axis, slot 0 for
//       slot n on a periodic one) and averages in shared memory,
//       0.5 * (F1 + F2), and 0.5 * (v1 + v2) where v1 is given; no stage-2
//       face reaches global memory;
//   and phase 4, one thread a cell, writes div = (F(i) - F(i+1)) / dx and
//   dvel = (v(i+1) - v(i)) / dx from the faces in shared memory. The
//   expressions and their operand order are those of the one-thread-a-cell
//   divergence kernel that read the faces back from global memory, so the
//   outputs keep its bits (kernel_times.py --compare). `hydro.sweep.
//   sweep_tile` picks the tile: K2c's for the z sweep, whose faces run
//   along z, the contiguous axis; for the x and y sweeps, which store or
//   read a face row per tile line along z, 29 cells by 16 lines (rows of
//   64 B; 54.7 KB, four blocks a multiprocessor). Measured on the H100
//   (kernel_times.py --tiles --only k2s): a stage-1 x sweep at 256^3 takes
//   1.19 ms on 29 x 16, 1.29 on 37 x 12, 1.54 on K2c's 37 x 13, whose
//   52 B rows straddle sectors.
//
// K2d (emit_avg_flux, the AMR flux-register variant,
// pallas_sweep.py:743-746 and :1066-1085): mode 2 on a ghost-padded
// periodic array, which also writes the time-averaged face flux
// 0.5 * (F1 + F2) of each cell's lo face (phase 4) and takes no stage-1
// face velocity: dvel stays the RAW stage-2 velocity divergence, which the
// caller averages with stage 1's (hydro/advance.py). The padded array
// wraps in index space, as the JAX in-block rolls do; the wrap reaches
// ghost faces only. Its bytes at the dense shell's 520^3: the state, chi
// and two dmin fields read (9 rows), stage 1's faces read (6 rows), div,
// dvel and favg written (13 rows), 15.7 GB an axis, 4.7 ms.
//
// K2c (div_only, the lean large-domain step, pallas_sweep.py:695-718,
// :786-810, :924-1009, the blend of _window_flux :543-561): one kernel,
// `lean_tile_kernel`, that writes no face array to global memory. It takes
// the face kernel's tile of `ta` cells by `tw` lines (`hydro.sweep.
// lean_tile`: up to 40 cells along, up to 512 faces a tile) and its phases
// 1-2, then
//   3. solves each of the ta + 1 faces its cells touch once, into shared
//      memory (7 floats a face: the flux in state order and the face
//      velocity; only the tile's hi face is solved again, by the next
//      tile). A face next to a flagged cell of the FOFC mask (cells f-1 or
//      f; wall ghosts unflagged) takes the first-order donor-cell + LLF
//      flux instead, from `fo` in global memory or, without it, from the
//      staged primitives; first_order takes LLF at every face and skips
//      phase 2;
//   4. one thread a cell writes div = (F_lo - F_hi) / dx and dvel = (v_hi -
//      v_lo) / dx, or adds them onto the accumulators in place (acc, the
//      JAX kernel's aliased outputs: each cell is read and written by the
//      one thread that owns it, nothing of them is staged).
// Every global offset is 64-bit, so every extent the one-thread-a-cell
// form took is taken. Its bound at 512^3 is bytes, at 3.35 TB/s with one
// f32 row 0.537 GB: a clean first axis reads U, chi and two dmin fields (9
// rows) and writes div and dvel (7 rows), 8.6 GB, 2.6 ms; with acc it reads
// the 7 accumulator rows too, 12.3 GB, 3.7 ms; fo_mask adds one row and
// fo_from six (kernel_check.lean_cases computes each launch's bytes from
// its inputs). The FP32 work, one HLLC a face and one PPM a cell
// (OPS_K2_SWEEP, 620 a cell), is 1.24 ms at 67 TFLOP/s. The form this
// replaces, one thread a cell solving both of its faces, did every HLLC
// twice, converted each cell to primitives 12 times and reconstructed it 4
// times an axis; the tile does each once, at the face kernel's cost
// (latency-bound IEEE divisions and square roots, PERF.md), plus a 28 B
// shared-memory round trip a face. Bits: qL = plus(f-1), qR = minus(f) and
// the same expressions in the same order, so the outputs are the
// per-cell form's bits (kernel_times.py --compare).
//
// K2e (corr_mask / corr_acc, the AMR root's in-kernel flux-register seed,
// pallas_sweep.py:811-880, corr formula :623-633 and :1085-1090, output
// alias :1146-1147): phase 4 of the lean kernel also writes
//   corr[c] (+)= (m_lo F_lo - m_hi F_hi) / dx,
// m the per-axis coarse-fine boundary-face mask (slot f = the lo face of
// cell f, as the JAX kernel's bnd_blk), from the very blended faces in
// shared memory that feed div, so the register stays consistent with the
// update in every FOFC branch; with corr_accumulate the thread adds onto its own cell of the
// accumulator in place (the aliased output). Ghost-free periodic axes only,
// as the JAX kernel refuses walls (:811-814). Its bound is bytes: one more
// [X, Y, Z] mask row read and six corr rows written (and read with the
// accumulator), on top of K2c's traffic; the arithmetic adds 12 selects
// and 6 divisions a cell.
//
// Batched face kernel: the packed AMR engine sweeps a chunk of ghost-padded
// tile blocks [B, 6, X, Y, Z] at once (the JAX package vmaps its flux
// function over them); blockIdx.y picks the block, so a chunk is one launch
// an axis, not one a tile. Periodic (padded, roll semantics) blocks only.
//
// Why K2's stage 1 writes its faces to global memory and nothing else
// does: the stage-1 caller needs them (the FOFC fallback re-blends them,
// and stage 2 averages with them); stage 2, K2d and K2c keep theirs in the
// tile's shared memory.
//
// Bound on the H100: bytes on paper. A stage-1 sweep reads its cell's 6
// values, chi and two dmin fields once and writes 7 face floats and 7
// divergence floats, 92 B a cell, against roughly 620 FP32 operations
// counted once (kernel_check.OPS_K2_SWEEP): at 256^3 1.54 GB, >= 0.46 ms
// at 3.35 TB/s. In practice instruction issue bounds it: each face solve has
// ~10 IEEE divisions and 6 square roots, which are instruction sequences,
// and -fmad=false keeps every product and sum apart. The tile does one
// HLLC a face and one PPM a cell, plus a 28 B shared-memory round trip a
// face; the two-launch form this replaces also wrote every face to global
// memory and read it back (twice: once as a cell's lo face, once as its
// neighbour's hi face), stage 2's and K2d's included.
#include "sweep.cuh"

namespace qk {

// The form of one launch: PPM without scalars here, the other forms in the
// units that sweep.cuh names; first_order sweeps of the tile kernels take
// the instantiation of the run's order, which skips its reconstruction.
int dispatch_lean(int order, int nsc, const LeanArgs& a) {
  switch (10 * order + nsc) {
    case 30: return launch_lean<3, 0>(a);
    case 31: return lean_ppm1(a);
    case 32: return lean_ppm2(a);
    case 20: return lean_plm0(a);
    case 21: return lean_plm1(a);
    case 22: return lean_plm2(a);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch_faces(int order, int nsc, const FaceArgs& a) {
  switch (10 * order + nsc) {
    case 30: return launch_faces<3, 0>(a);
    case 31: return faces_ppm1(a);
    case 32: return faces_ppm2(a);
    case 20: return faces_plm0(a);
    case 21: return faces_plm1(a);
    case 22: return faces_plm2(a);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch_sweep(int order, int nsc, const SweepArgs& a) {
  switch (10 * order + nsc) {
    case 30: return launch_sweep<3, 0>(a);
    case 31: return sweep_ppm1(a);
    case 32: return sweep_ppm2(a);
    case 20: return sweep_plm0(a);
    case 21: return sweep_plm1(a);
    case 22: return sweep_plm2(a);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch_fo_faces(int nsc, const FaceArgs& a) {
  switch (nsc) {
    case 0: return launch_fo_faces<0>(a);
    case 1: return fo_faces1(a);
    case 2: return fo_faces2(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace qk

// Shared-memory bytes of a K2c block (and of K2's sweeps with a
// divergence) of ta cells by tw lines, with nsc scalars.
extern "C" int qk_lean_smem(int ta, int tw, int nsc) {
  return (int)sizeof(float) * qk::lean_smem_floats(ta, tw, qk::NV + nsc);
}

// K2c / K2e along one axis in tiles of ta cells by tw lines; `order` 3
// (PPM) or 2 (PLM), `nsc` scalars of which the first `nm` are mass scalars.
extern "C" int qk_axis_lean(const float* Q, const float* chi, const float* chi_glo,
                            const float* chi_ghi, const float* dminv, const float* dminw,
                            const float* mask, const float* fo, float* div,
                            float* dvel, const float* cmask, float* corr,
                            long long X, long long Y, long long Z,
                            int axis, int lo, int hi, int is_cons,
                            int first_order, float K_visc, float dx,
                            int accumulate, int corr_accumulate, int ta, int tw,
                            float gamma, float gm1, float inv_gm1, float s_n,
                            int reconstruct_eint, int order, int nsc, int nm,
                            void* stream) {
  const qk::LeanArgs a{Q, chi, chi_glo, chi_ghi, dminv, dminw, mask, fo, div, dvel, cmask,
                       corr, X, Y, Z, axis, lo, hi, is_cons, first_order, K_visc, dx,
                       accumulate, corr_accumulate, ta, tw,
                       qk::Eos{gamma, gm1, inv_gm1, s_n, reconstruct_eint}, nm,
                       (cudaStream_t)stream};
  return qk::dispatch_lean(order, nsc, a);
}

// The face kernels of one axis over a batch [nbatch, 6 + nsc, X, Y, Z]
// (nbatch 1 on a wall axis), in tiles of ta faces by tw lines
// (`face_tile_kernel`, or `fo_face_kernel` for the first-order fluxes).
extern "C" int qk_axis_flux(const float* Q, const float* chi, const float* chi_glo,
                            const float* chi_ghi, const float* dminv, const float* dminw,
                            float* F, float* vel, float* F_hi, float* vel_hi, long long X,
                            long long Y, long long Z, long long nbatch,
                            int axis, int lo, int hi,
                            int is_cons, int first_order, float K_visc,
                            int ta, int tw, float gamma, float gm1,
                            float inv_gm1, float s_n, int reconstruct_eint,
                            int order, int nsc, int nm, void* stream) {
  const qk::FaceArgs a{Q, chi, chi_glo, chi_ghi, dminv, dminw, F, vel, F_hi, vel_hi, X, Y,
                       Z, nbatch, axis, lo, hi, is_cons, K_visc, ta, tw,
                       qk::Eos{gamma, gm1, inv_gm1, s_n, reconstruct_eint}, nm,
                       (cudaStream_t)stream};
  return first_order ? qk::dispatch_fo_faces(nsc, a) : qk::dispatch_faces(order, nsc, a);
}

// K2's sweep with a divergence along one axis in tiles of ta cells by tw
// lines (`sweep_tile_kernel`): with F (stage 1) the faces are written out,
// with F1 (stage 2, K2d) averaged with; exactly one of the two is given.
extern "C" int qk_axis_sweep(const float* Q, const float* chi, const float* chi_glo,
                             const float* chi_ghi, const float* dminv,
                             const float* dminw, float* div, float* dvel, float* F,
                             float* vel, float* F_hi, float* vel_hi, const float* F1,
                             const float* v1, const float* F1_hi, const float* v1_hi,
                             float* favg, long long X, long long Y, long long Z, int axis,
                             int lo, int hi, int is_cons, int first_order, float K_visc,
                             float dx, int ta, int tw, float gamma, float gm1,
                             float inv_gm1, float s_n, int reconstruct_eint, int order,
                             int nsc, int nm, void* stream) {
  const qk::SweepArgs a{Q, chi, chi_glo, chi_ghi, dminv, dminw, div, dvel, F, vel, F_hi,
                        vel_hi, F1, v1, F1_hi, v1_hi, favg, X, Y, Z, axis, lo, hi, is_cons,
                        first_order, K_visc, dx, ta, tw,
                        qk::Eos{gamma, gm1, inv_gm1, s_n, reconstruct_eint}, nm,
                        (cudaStream_t)stream};
  return qk::dispatch_sweep(order, nsc, a);
}
