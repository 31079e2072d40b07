// cp.async helpers shared by the kernels that stage tiles in shared
// memory ahead of their use (int8_matmul.cu, paged_attention_tree.cu):
// 16-byte asynchronous copies from device to shared memory, committed in
// groups and waited on by count. Editing this header rebuilds every
// library (kernels.library_path hashes the csrc/*.cuh headers).

#pragma once

#include <stdint.h>

namespace gaie {

// Copy 16 bytes; with src_bytes 0 nothing is read and the 16 bytes are
// filled with zeros (masked rows and columns). Both addresses 16-byte
// aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace gaie
