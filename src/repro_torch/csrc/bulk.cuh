// Bulk copies into shared memory with mbarrier completion (Hopper's
// cp.async.bulk, the 1-D form of the Tensor Memory Accelerator), shared by
// the hop kernels that stage rows of the node-ts view.
//
// One thread arms a barrier with the bytes it expects and issues the
// copies; every thread that reads the rows waits on the barrier's phase.
// A copy moves whole 16-byte units between 16-byte aligned addresses, so a
// staged span starts at a row rounded down to 4 int32 and its bulk part
// ends at bulk_end(); the rows past that end are loaded by threads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// 1-D bulk copy global -> shared; 16-byte aligned ends, bytes % 16 == 0
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// End of the bulk part of rows [.., end) of a 4-byte array of `len` rows
// (16-byte aligned start): end rounded up to whole 16 bytes, but not past
// the array's last whole 16 bytes. Rows [bulk_end, end) are <= 3 and are
// loaded by threads.
__device__ __forceinline__ long long bulk_end(long long end, long long len) {
  const long long up = (end + 3) & ~3ll;
  const long long whole = len & ~3ll;
  return up < whole ? up : whole;
}

}  // namespace repro
