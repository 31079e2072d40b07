// Weight-only int8 GEMM for Hopper (sm_90a):
//   y[R, M] = (x[R, K] @ q[K, M]) * scale[M]
// x bf16 row-major, q int8 row-major (the [in, out] layout of the
// parameter tree), scale f32, y bf16. The f32 accumulator is multiplied
// by the f32 scale and rounded once to bf16.
//
// Replaces the Pallas TPU kernels `_kernel` (K-blocked) and
// `_kernel_fullk` behind `int8_matmul` in
// generativeaiexamples_tpu/ops/int8_matmul.py, and with them the XLA
// route of ops/quant.py::mm (convert, dot, scale), which XLA fuses into
// the dot's weight read and eager PyTorch cannot.
//
// What bounds it on an H100: at decode (R = batch, 8 to 128) the work is
// 2 R flops per weight byte, far below the ~295 flops a byte the card
// needs before its tensor cores are the limit, so it is bound by reading
// the int8 codes from device memory -- half the bytes of the bf16 model,
// which is why the weights must cross memory as int8 and be widened on
// chip. At prefill (R in the thousands) it is bound by operations.
// The design, one kernel for both:
//   - tiles of x (bf16) and of the codes (int8) are staged in shared
//     memory with cp.async, STAGES deep, so the next tiles' loads are in
//     flight while the current one is multiplied;
//   - each staged code tile is widened to bf16 in shared memory (an int8
//     code in +-127 is exact in bf16), and both operands feed bf16
//     tensor cores through ldmatrix and mma.sync.m16n8k16 with f32
//     accumulation, so the product equals the XLA route's up to
//     summation order and no dequantized weight reaches device memory;
//   - the tile shape is chosen from R: a 16-row tile with deep K tiles
//     for small decode batches, 128 x 64 for decode batches up to 128
//     (more column blocks for the narrow projections), 128 x 128 for
//     prefill; ragged rows and columns are masked (K must be a multiple
//     of 16; a column count that is not a multiple of 16 takes a byte
//     load path for the codes).
// Not done yet (later work): wgmma and TMA, and split-K for the narrow
// M = 1024 projections, whose 16 column blocks leave most SMs idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "mma_bf16.cuh"

namespace {

using gaie::cp_async16;
using gaie::cp_async_commit;
using gaie::cp_async_wait;
using gaie::ldmatrix_x4;
using gaie::ldmatrix_x4_trans;
using gaie::mma_16816;
using gaie::pack_f32;

constexpr int STAGES = 3;

__device__ __forceinline__ float code(uint32_t word, int byte) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * byte)) & 0xffu));
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N>
struct Tile {
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int XSTR = BK + 8;       // bf16 elements per staged x row
  static constexpr int QSTR = BN + 16;      // bytes per staged code row
  static constexpr int WSTR = BN + 8;       // bf16 elements per widened row
  static constexpr int WTM = BM / WARPS_M;  // rows of one warp's tile
  static constexpr int WTN = BN / WARPS_N;  // columns of one warp's tile
  static constexpr int MI = WTM / 16;
  static constexpr int NI = WTN / 8;
  static constexpr int X_BYTES = BM * XSTR * 2;
  static constexpr int Q_BYTES = BK * QSTR;
  static constexpr int SMEM = STAGES * (X_BYTES + Q_BYTES) + BK * WSTR * 2;
  static_assert(WTM % 16 == 0 && WTN % 16 == 0 && BK % 16 == 0 && BN % 16 == 0, "tile");
};

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, bool VEC>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                   int R, int K, int M) {
  using T = Tile<BM, BN, BK, WARPS_M, WARPS_N>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BM][XSTR]
  int8_t* qs = reinterpret_cast<int8_t*>(smem + STAGES * T::X_BYTES);  // [STAGES][BK][QSTR]
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(
      smem + STAGES * (T::X_BYTES + T::Q_BYTES));  // [BK][WSTR], the widened codes

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int c0 = blockIdx.x * BN;  // first output column of the block
  const int r0 = blockIdx.y * BM;  // first output row of the block
  const int nk = (K + BK - 1) / BK;

  auto load_stage = [&](int buf, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* xb = xs + buf * BM * T::XSTR;
    for (int c = tid; c < BM * (BK / 8); c += T::THREADS) {
      const int row = c / (BK / 8);
      const int col = (c % (BK / 8)) * 8;
      // K % 16 == 0: an 8-wide chunk lies wholly inside or outside K.
      const bool ok = r0 + row < R && k0 + col < K;
      const __nv_bfloat16* src = ok ? x + static_cast<long long>(r0 + row) * K + k0 + col : x;
      cp_async16(xb + row * T::XSTR + col, src, ok ? 16 : 0);
    }
    int8_t* qb = qs + buf * T::Q_BYTES;
    if (VEC) {  // M % 16 == 0: 16-byte chunks, aligned, wholly in or out
      for (int c = tid; c < BK * (BN / 16); c += T::THREADS) {
        const int row = c / (BN / 16);
        const int col = (c % (BN / 16)) * 16;
        const bool ok = k0 + row < K && c0 + col < M;
        const int8_t* src = ok ? q + static_cast<long long>(k0 + row) * M + c0 + col : q;
        cp_async16(qb + row * T::QSTR + col, src, ok ? 16 : 0);
      }
    } else {  // rows not 16-byte aligned: plain byte loads
      for (int c = tid; c < BK * BN; c += T::THREADS) {
        const int row = c / BN;
        const int col = c % BN;
        qb[row * T::QSTR + col] = (k0 + row < K && c0 + col < M)
                                      ? q[static_cast<long long>(k0 + row) * M + c0 + col]
                                      : static_cast<int8_t>(0);
      }
    }
  };

  float acc[T::MI][T::NI][4];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt % STAGES;
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt landed
    __syncthreads();  // everyone's did; everyone finished tile kt - 1
    if (kt + STAGES - 1 < nk) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();

    // Widen the staged codes to bf16, 16 codes a thread.
    const int8_t* qb = qs + buf * T::Q_BYTES;
    for (int c = tid; c < BK * (BN / 16); c += T::THREADS) {
      const int row = c / (BN / 16);
      const int col = (c % (BN / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(qb + row * T::QSTR + col);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[2 * i] = pack_f32(code(words[i], 0), code(words[i], 1));
        w[2 * i + 1] = pack_f32(code(words[i], 2), code(words[i], 3));
      }
      uint4* dst = reinterpret_cast<uint4*>(ws + row * T::WSTR + col);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
    __syncthreads();

    const __nv_bfloat16* xb = xs + buf * BM * T::XSTR;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A (x) fragments: rows (lane % 16) of each 16-row tile, columns
      // 8 (lane / 16) .. + 7 of the 16-deep chunk.
      uint32_t af[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        ldmatrix_x4(af[mi], xb + (wm * T::WTM + mi * 16 + (lane & 15)) * T::XSTR + kk +
                                (lane >> 4) * 8);
      }
      // B (widened codes, [k][n] row-major) fragments, transposed: rows
      // (lane % 8) + 8 ((lane / 8) % 2) of the 16-deep chunk, columns
      // 8 (lane / 16) .. + 7; the four matrices are two 8-wide n-tiles.
#pragma unroll
      for (int ni = 0; ni < T::NI; ni += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * T::WSTR +
                                  wn * T::WTN + ni * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi) {
          mma_16816(acc[mi][ni], af[mi], bf);
          mma_16816(acc[mi][ni + 1], af[mi], bf + 2);
        }
      }
    }
  }

  // Epilogue: f32 accumulator times f32 scale, one rounding to bf16.
#pragma unroll
  for (int ni = 0; ni < T::NI; ++ni) {
    const int col = c0 + wn * T::WTN + ni * 8 + t4 * 2;
    const float s0 = col < M ? scale[col] : 0.f;
    const float s1 = col + 1 < M ? scale[col + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + wm * T::WTM + mi * 16 + g + 8 * half;
        if (row >= R || col >= M) continue;
        const float v0 = acc[mi][ni][2 * half] * s0;
        const float v1 = acc[mi][ni][2 * half + 1] * s1;
        __nv_bfloat16* dst = y + static_cast<long long>(row) * M + col;
        if (VEC) {  // M even: col + 1 < M and a 4-byte aligned pair
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (col + 1 < M) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, bool VEC>
int run(const void* x, const void* q, const void* scale, void* y, int R, int K, int M,
        cudaStream_t stream) {
  using T = Tile<BM, BN, BK, WARPS_M, WARPS_N>;
  auto kernel = int8_matmul_kernel<BM, BN, BK, WARPS_M, WARPS_N, VEC>;
  // Above 48 KB of shared memory needs the opt-in, once per instantiation.
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid((M + BN - 1) / BN, (R + BM - 1) / BM);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), R, K, M);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int dispatch(const void* x, const void* q, const void* scale, void* y, int R, int K, int M,
             cudaStream_t s) {
  if (R <= 16) return run<16, 64, 128, 1, 4, VEC>(x, q, scale, y, R, K, M, s);
  if (R <= 128) return run<128, 64, 64, 4, 2, VEC>(x, q, scale, y, R, K, M, s);
  return run<128, 128, 32, 2, 4, VEC>(x, q, scale, y, R, K, M, s);
}

}  // namespace

// x [R, K] bf16, q [K, M] int8 (both contiguous, 16-byte aligned),
// scale [M] f32, y [R, M] bf16 on the device; R >= 1, K a positive
// multiple of 16, any M >= 1. Returns the launch's cudaError_t.
extern "C" int gaie_int8_matmul_bf16(const void* x, const void* q, const void* scale, void* y,
                                     int R, int K, int M, void* stream) {
  if (R < 1 || M < 1 || K < 16 || K % 16 != 0 || R > 65535 * 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M % 16 == 0) return dispatch<true>(x, q, scale, y, R, K, M, s);
  return dispatch<false>(x, q, scale, y, R, K, M, s);
}
