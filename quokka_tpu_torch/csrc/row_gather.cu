// K9: gather rows of a tile pool by index.
//
// Replaces quokka_tpu/amr/packed.py::row_gather (def :110, pallas_call
// :146): out[r] = pool[rows[r]] for a pool [cap, row] stored as contiguous
// rows (a packed level's hydro [cap, 6, tx, ty, tz] or radiation
// [cap, 4, tx, ty, tz] pool: the same bytes as the TPU's lane-packed
// [cap, row / 128, 128] rows). What carries over is the contract: only the
// requested rows are read, nothing of the pool is relaid out or copied
// whole. The TPU kernel's DMA semaphore ring has no counterpart: a block
// copies its row with vector loads and stores.
//
// Design: one block per gathered row; its threads copy the row in 16-byte
// vectors (the row is a multiple of 16 bytes and the pool and the output
// are 16-byte aligned: the wrapper checks), neighbouring threads on
// neighbouring addresses, so every load and store is coalesced. An index
// outside [0, cap) copies nothing (the row is zero-filled) and sets the
// error flag, which the wrapper's `check_gathers` turns into an IndexError.
//
// Bound on the H100: bytes. Each distinct row of the index is read once
// and each gathered row written once, (d + n) x row bytes: the index
// repeats rows (neighbouring tiles share neighbours; a missing neighbour
// is clamped to row 0). A level-2 chunk's 64 x 26 neighbour rows of the
// hydro pool (6 x 16^3 f32, 96 KiB a row) write 0.16 GB, >= 0.05 ms at
// 3.35 TB/s, before the reads. There is no arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace qk {

__global__ void row_gather_kernel(const int4* __restrict__ pool,
                                  const int* __restrict__ rows,
                                  int4* __restrict__ out, int64_t row_vec,
                                  int64_t cap, int* err) {
  const int64_t r = blockIdx.x;
  const int64_t idx = rows[r];
  int4* dst = out + r * row_vec;
  if (idx < 0 || idx >= cap) {
    if (threadIdx.x == 0) atomicOr(err, 1);
    const int4 z = make_int4(0, 0, 0, 0);
    for (int64_t i = threadIdx.x; i < row_vec; i += blockDim.x) dst[i] = z;
    return;
  }
  const int4* src = pool + idx * row_vec;
  for (int64_t i = threadIdx.x; i < row_vec; i += blockDim.x) dst[i] = src[i];
}

}  // namespace qk

extern "C" int qk_row_gather(const void* pool, const int* rows, void* out,
                             long long n, long long row_bytes, long long cap,
                             int* err, void* stream) {
  if (n == 0) return 0;
  const int64_t row_vec = row_bytes / 16;
  qk::row_gather_kernel<<<(unsigned)n, 256, 0, (cudaStream_t)stream>>>(
      (const int4*)pool, rows, (int4*)out, row_vec, cap, err);
  return (int)cudaGetLastError();
}
