// bf16 tensor-core helpers shared by the kernels (flash_attention.cu,
// encoder_attention.cu, paged_attention_int8.cu, int8_matmul.cu and the
// bf16 paged kernels through paged_bf16.cuh):
// mma.sync m16n8k16 with f32 accumulation, the register packing its
// fragments need, ldmatrix, and the exact int8 -> bf16 widening.
//
// Fragment layout of one warp (g = lane / 4, t4 = lane % 4):
//   A (16 x 16, row-major)  a[0] = (row g,     cols 2 t4, 2 t4 + 1)
//                           a[1] = (row g + 8, cols 2 t4, 2 t4 + 1)
//                           a[2] = (row g,     cols 2 t4 + 8, + 9)
//                           a[3] = (row g + 8, cols 2 t4 + 8, + 9)
//   B (16 x 8, col-major)   b[0] = (rows 2 t4, 2 t4 + 1,     col g)
//                           b[1] = (rows 2 t4 + 8, 2 t4 + 9, col g)
//   C (16 x 8, f32)         c[0..1] = (row g,     cols 2 t4, 2 t4 + 1)
//                           c[2..3] = (row g + 8, cols 2 t4, 2 t4 + 1)
// Editing this header rebuilds every library that includes it
// (kernels.library_path hashes the csrc/*.cuh headers with each source).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gaie {

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Two int8 codes as bf16x2, exactly: bytes lo and hi of `u`, which holds
// codes + 128 (the raw codes xor 0x80 per byte). 2^23 + u is an exact
// f32; subtracting 2^23 + 128 leaves the code, whose f32 has a zero low
// half, so its bf16 is the high half. Byte lo goes to the low half.
__device__ __forceinline__ uint32_t widen2(uint32_t u, int lo, int hi) {
  const float flo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | lo)) - 8388736.f;
  const float fhi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | hi)) - 8388736.f;
  return __byte_perm(__float_as_uint(flo), __float_as_uint(fhi), 0x7632);
}

// (a, b) as bf16x2 hi + lo: hi the rounded pair, lo the rounded
// remainders, so hi + lo carries ~16 bits of each value's mantissa.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_f32(a - hf.x, b - hf.y);
}

// D (16x8, f32) += A (16x16, bf16, row-major) * B (16x8, bf16, col-major).
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices from shared memory in one instruction: lanes
// 8 j .. 8 j + 7 give the row addresses (16 bytes each, 16-byte aligned)
// of matrix j, and r[j] receives this lane's fragment of matrix j, as
// (row lane / 4, cols 2 (lane % 4), + 1) or, with `trans`, as
// (rows 2 (lane % 4), + 1, col lane / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row_addr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row_addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* row_addr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row_addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Two 8x8 b16 matrices (lanes 0 .. 15 give the row addresses).
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* row_addr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row_addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

}  // namespace gaie
