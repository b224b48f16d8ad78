// K9: gather rows of a tile pool by index.
//
// Replaces quokka_tpu/amr/packed.py::row_gather (def :110, pallas_call
// :146): out[r] = pool[rows[r]] for a pool [cap, row] stored as contiguous
// rows (a packed level's hydro [cap, 6, tx, ty, tz] or radiation
// [cap, 4, tx, ty, tz] pool: the same bytes as the TPU's lane-packed
// [cap, row / 128, 128] rows). What carries over is the contract: only the
// requested rows are read, nothing of the pool is relaid out or copied
// whole. The TPU kernel's ring of DMAs under semaphores becomes Hopper's
// bulk copies under an mbarrier.
//
// Design: a persistent grid (three one-warp blocks an SM) walks the work
// items, each one segment of up to SEG bytes of one gathered row (a 96 KiB
// hydro row is 6 items), in output order: each block takes the next item
// from a counter in device memory, so the blocks' items in flight stay a
// narrow window of the output and the rows that neighbouring tiles share
// are read again while they are in L2 (a static assignment lets the
// blocks drift apart). In each block one thread issues everything:
// `cp.async.bulk` global -> shared into a ring of STAGES segments, each
// completing on its own mbarrier with the byte count, and, once a segment
// has landed, `cp.async.bulk` shared -> global into the output, completing
// through a bulk group. The ring keeps STAGES - 1 reads in flight while the
// writes drain, so no thread spends registers or instructions on the
// bytes. L2 hints: the pool reads are evict-last (neighbouring tiles share
// most of their 26 neighbours, so a row is read again within a chunk), the
// output writes evict-first (written once, read by the next kernel long
// after). Offsets inside a row are 32-bit; a row's base is 64-bit. Every
// address and size is a multiple of 16 bytes (the wrapper checks the row
// size and the pointers' alignment).
//
// An index outside [0, cap) reads nothing: its segments are zero-filled by
// the block's warp and the error flag is raised, which the wrapper's
// `check_gathers` turns into an IndexError.
//
// Bound on the H100: bytes. Each distinct row of the index is read once
// and each gathered row written once, (d + n) x row bytes: the index
// repeats rows (neighbouring tiles share neighbours; a missing neighbour
// is clamped to row 0). A level-2 chunk's 512 x 26 neighbour rows of the
// hydro pool (6 x 16^3 f32, 96 KiB a row) write 1.3 GB, >= 0.39 ms at
// 3.35 TB/s, before the reads. There is no arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace qk {

constexpr int GATHER_STAGES = 4;
constexpr unsigned GATHER_SEG = 16384;  // bytes of one work item
constexpr int GATHER_BLOCKS_PER_SM = 3;  // 64 KiB of ring each

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes,
                                           uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;" ::"l"(
          dst),
      "r"(src), "r"(bytes), "l"(policy)
      : "memory");
}

struct GatherItem {
  int64_t row;      // output row
  int idx;          // pool row
  uint32_t offset;  // bytes into the row
  uint32_t bytes;
};

__device__ __forceinline__ GatherItem gather_item(int64_t w, const int* rows,
                                                  uint32_t row_bytes, uint32_t nseg) {
  GatherItem it;
  it.row = w / nseg;
  it.offset = static_cast<uint32_t>(w - it.row * nseg) * GATHER_SEG;
  it.bytes = min(GATHER_SEG, row_bytes - it.offset);
  it.idx = rows[it.row];
  return it;
}

__global__ void __launch_bounds__(32) row_gather_kernel(
    const char* __restrict__ pool, const int* __restrict__ rows, char* __restrict__ out,
    uint32_t row_bytes, uint32_t nseg, int64_t n_items, int cap, int* err,
    unsigned long long* next) {  // next: the first item no block has taken
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[GATHER_STAGES];
  __shared__ int64_t item_of[GATHER_STAGES];  // each stage's item, -1: none left
  const bool leader = threadIdx.x == 0;
  if (leader) {
    for (int s = 0; s < GATHER_STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  const uint64_t pol_read = policy_evict_last();
  const uint64_t pol_write = policy_evict_first();

  auto issue = [&](int64_t k) {  // the leader takes the next item into stage k % STAGES
    const int s = static_cast<int>(k % GATHER_STAGES);
    const int64_t w = static_cast<int64_t>(atomicAdd(next, 1ull));
    item_of[s] = w < n_items ? w : -1;
    if (w >= n_items) return;
    const GatherItem it = gather_item(w, rows, row_bytes, nseg);
    const uint32_t bar = smem_u32(&full[s]);
    if (it.idx < 0 || it.idx >= cap) {
      mbar_arrive(bar);
      return;
    }
    mbar_expect_tx(bar, it.bytes);
    bulk_load(smem_u32(ring + s * GATHER_SEG),
              pool + static_cast<int64_t>(it.idx) * row_bytes + it.offset, it.bytes, bar,
              pol_read);
  };

  if (leader)
    for (int64_t k = 0; k < GATHER_STAGES - 1; ++k) issue(k);
  __syncwarp();
  for (int64_t k = 0;; ++k) {
    const int s = static_cast<int>(k % GATHER_STAGES);
    const int64_t w = item_of[s];
    if (w < 0) break;
    const GatherItem it = gather_item(w, rows, row_bytes, nseg);
    char* dst = out + it.row * row_bytes + it.offset;
    mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>((k / GATHER_STAGES) & 1));
    if (it.idx < 0 || it.idx >= cap) {
      if (leader) atomicOr(err, 1);
      const int4 z = make_int4(0, 0, 0, 0);
      for (uint32_t i = threadIdx.x; i < it.bytes / 16; i += 32)
        reinterpret_cast<int4*>(dst)[i] = z;
    }
    if (leader) {
      if (it.idx >= 0 && it.idx < cap)
        bulk_store(dst, smem_u32(ring + s * GATHER_SEG), it.bytes, pol_write);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      issue(k + GATHER_STAGES - 1);
    }
    __syncwarp();
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace qk

extern "C" int qk_row_gather(const void* pool, const int* rows, void* out,
                             long long n, long long row_bytes, long long cap,
                             int* err, unsigned long long* counter, void* stream) {
  // `counter` is zero on entry (the wrapper's), one per launch
  if (n == 0) return 0;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(qk::row_gather_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               qk::GATHER_STAGES * qk::GATHER_SEG);
    if (e != cudaSuccess) {
      n_sm = 0;
      return (int)e;
    }
  }
  const uint32_t nseg = (uint32_t)((row_bytes + qk::GATHER_SEG - 1) / qk::GATHER_SEG);
  const int64_t n_items = (int64_t)n * nseg;
  const int64_t max_blocks = (int64_t)n_sm * qk::GATHER_BLOCKS_PER_SM;
  const int64_t blocks = n_items < max_blocks ? n_items : max_blocks;
  qk::row_gather_kernel<<<(unsigned)blocks, 32, qk::GATHER_STAGES * qk::GATHER_SEG,
                          (cudaStream_t)stream>>>(
      (const char*)pool, rows, (char*)out, (uint32_t)row_bytes, nseg, n_items, (int)cap,
      err, counter);
  return (int)cudaGetLastError();
}
