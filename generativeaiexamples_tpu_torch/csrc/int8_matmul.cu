// Weight-only int8 GEMM for Hopper (sm_90a):
//   y[R, M] = (x[R, K] @ q[K, M]) * scale[M]
// x bf16 row-major, q int8 row-major (the [in, out] layout of the
// parameter tree, not re-laid-out), scale f32, y bf16. The f32
// accumulator is multiplied by the f32 scale and rounded once to bf16.
//
// Replaces the Pallas TPU kernels `_kernel` (K-blocked) and
// `_kernel_fullk` behind `int8_matmul` in
// generativeaiexamples_tpu/ops/int8_matmul.py, and with them the XLA
// route of ops/quant.py::mm (convert, dot, scale), which XLA fuses into
// the dot's weight read and eager PyTorch cannot.
//
// What bounds it on an H100: at decode (R = batch, 8 to 128) the work is
// 2 R flops per weight byte, below the ~295 flops a byte the card needs
// before its tensor cores are the limit, so it is bound by reading the
// int8 codes (half the bytes of the bf16 model); at R = 128 it sits near
// the ridge, so the tensor cores must keep up too. At prefill and at the
// speculative verify shapes (R in the hundreds and thousands) it is bound
// by operations. The design, one warp-specialised kernel for both:
//   - the product is computed transposed, y^T = q^T x^T: the codes are
//     wgmma's A operand, widened from int8 to bf16 straight into the
//     registers of the A fragment (ldmatrix.trans of the staged bytes,
//     then a byte permute and one f32 add per code, exact for +-127), and
//     x is the B operand read from shared memory by descriptor. No
//     widened tile is written back to shared memory and no block-wide
//     barrier sits between the copy and the product: one warpgroup
//     widens its next tile while the other's wgmmas run. A warpgroup
//     retires its own wgmmas before it rewrites their A registers
//     (widening the next tile while they ran made ptxas serialise every
//     wgmma, warning C7513, and measured 7-10% slower at prefill shapes
//     in one call). The ldmatrix of byte pairs puts output columns 2i
//     and 2i + 1 on fragment rows i and i + 8, which the epilogue
//     undoes;
//   - a CTA computes 128 output columns (two consumer warpgroups of 64)
//     by `row_tile` rows of x (the wgmma's N: 8 to 128 at decode, 256
//     above); one producer warp streams 64-deep code tiles (8 KB) and x
//     tiles through a ring of up to 8 stages by TMA (128-byte swizzle,
//     mbarriers), so 40-64 KB of codes are in flight per SM;
//   - split-K: the Python wrapper's plan (ops/int8_matmul.py) cuts K into
//     `splits` slices so that tiles x splits fill the 132 SMs in one wave
//     even for the narrow projections (w_down and wk_wv at decode). Each slice
//     writes its f32 partial to a workspace; the last CTA to arrive for
//     an output tile (an atomic ticket it resets itself) sums the slices
//     in slice order, scales and writes bf16, so the result does not
//     depend on the order in which CTAs finish;
//   - ragged rows of x and ragged columns are zero-filled by TMA and
//     masked in the epilogue; K only needs to be a multiple of 16.
// A column count that is not a multiple of 16 leaves the codes' rows
// without the 16-byte alignment TMA needs; such a matrix (on no Llama-3-8B
// path) takes a simple mma.sync kernel that stages the codes with byte
// loads and widens them in shared memory. It is slow and only there to
// keep the contract.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace gaie::hopper;
using gaie::widen2;

// ---- the TMA / wgmma kernel (M % 16 == 0) ----------------------------------

constexpr int BM = 128;  // output columns per CTA (64 per consumer warpgroup)
constexpr int BK = 64;   // reduction depth of one staged tile
constexpr int THREADS = 384;
constexpr int CODE_BYTES = BK * BM;  // one staged code tile, [BK][128] bytes

template <int BN>
struct Ring {
  static constexpr int X_BYTES = BN * BK * 2;  // one staged x tile, [BN][64] bf16
  static constexpr int STAGES = (200 * 1024) / (CODE_BYTES + X_BYTES) < 8
                                    ? (200 * 1024) / (CODE_BYTES + X_BYTES)
                                    : 8;
  static constexpr int BAR_OFF = STAGES * (CODE_BYTES + X_BYTES);
  static constexpr int SMEM = BAR_OFF + 256 + 1024;  // barriers, flag, alignment slack
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
int8_matmul_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tq,
                   const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                   float* __restrict__ ws, int* __restrict__ tickets, int R, int M, int nk,
                   int kt_per_split) {
  using T = Ring<BN>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;                        // [STAGES] code tiles
  unsigned char* xs = smem + STAGES * CODE_BYTES;  // [STAGES] x tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* empty = full + STAGES;
  int* last_flag = reinterpret_cast<int*>(empty + STAGES);

  const int m0 = blockIdx.x * BM;  // first output column
  const int r0 = blockIdx.y * BN;  // first row of x / y
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int kt0 = split * kt_per_split;
  const int kt1 = min(nk, kt0 + kt_per_split);
  const int nt = kt1 - kt0;  // >= 1 (the plan guarantees it)

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    regs_dec<40>();
    if (threadIdx.x == 0) {
      for (int t = 0; t < nt; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) + 1) & 1);
        mbar_arrive_expect_tx(&full[s], CODE_BYTES + T::X_BYTES);
        const int k = (kt0 + t) * BK;
        tma_load_2d(qs + s * CODE_BYTES, &tq, &full[s], m0, k);
        tma_load_2d(xs + s * T::X_BYTES, &tx, &full[s], k, r0);
      }
    }
    return;
  }

  regs_inc<232>();
  const int cw = wg - 1;
  const int tid = threadIdx.x - 128;  // 0 .. 255 over both consumer warpgroups
  const int warp = (tid >> 5) & 3;    // warp within the warpgroup
  const int lane = tid & 31;
  const int chunk = 4 * cw + warp;    // this warp's 16 output columns: bytes 16 chunk ..

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // Per staged tile: widen its codes into `af` (the A fragments of its
  // four k16 steps) and issue its four wgmmas, accumulating into acc.
  uint32_t af[4][4];
  for (int t = 0; t < nt; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    // The previous tile's wgmmas read af: retire them, and release
    // their stage, before af is rewritten.
    wgmma_wait<0>();
    if (t > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
    }
    const unsigned char* qt = qs + s * CODE_BYTES;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t w[4];  // k rows 32 p + (0-7, 8-15, 16-23, 24-31)
      gaie::ldmatrix_x4_trans(w, qt + sw128(32 * p + lane, chunk));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t lo = w[2 * h] ^ 0x80808080u;      // k rows 0-7 of the step
        const uint32_t hi = w[2 * h + 1] ^ 0x80808080u;  // k rows 8-15
        uint32_t* a = af[2 * p + h];
        a[0] = widen2(lo, 0, 2);  // column 2i (fragment row i), k 2t, 2t + 1
        a[1] = widen2(lo, 1, 3);  // column 2i + 1 (fragment row i + 8)
        a[2] = widen2(hi, 0, 2);
        a[3] = widen2(hi, 1, 3);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_sw128(xs + s * T::X_BYTES + kk * 32, 0, 1024);
      Wgmma<BN>::template rs<0>(acc, af[kk], db, 1);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue. This thread holds rows r0 + 8 j + 2 (lane % 4) + c and the
  // column pair m + (0, 1) (fragment rows i and i + 8).
  const int m = m0 + 16 * chunk + 2 * (lane >> 2);
  const int rt = 2 * (lane & 3);
  const bool col_ok = m < M;  // M is even, so m + 1 < M too
  if (splits == 1) {
    if (!col_ok) return;
    const float2 sc = *reinterpret_cast<const float2*>(scale + m);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = r0 + 8 * j + rt + c;
        if (r < R) {
          *reinterpret_cast<__nv_bfloat162*>(y + static_cast<long long>(r) * M + m) =
              __floats2bfloat162_rn(acc[4 * j + c] * sc.x, acc[4 * j + 2 + c] * sc.y);
        }
      }
    }
    return;
  }

  // Split-K: this slice's partial to ws[split], then the last CTA of the
  // output tile sums ws[0 .. splits - 1] in that order.
  if (col_ok) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = r0 + 8 * j + rt + c;
        if (r < R) {
          __stcg(reinterpret_cast<float2*>(ws + (static_cast<long long>(split) * R + r) * M + m),
                 make_float2(acc[4 * j + c], acc[4 * j + 2 + c]));
        }
      }
    }
  }
  __threadfence();
  named_sync(1, 256);
  const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) {
    const int ticket = atomicAdd(&tickets[tile_id], 1);
    const int last = ticket == splits - 1;
    if (last) tickets[tile_id] = 0;  // ready for the next launch
    *last_flag = last;
  }
  named_sync(1, 256);
  if (!*last_flag) return;
  __threadfence();
  // The tile's 128 columns by BN rows, coalesced: 32 threads a row, four
  // columns a thread, 8 rows a pass; each sum runs over the slices in
  // slice order whichever CTA arrived last.
  const int col = m0 + 4 * (tid & 31);
  if (col >= M) return;  // M % 16 == 0: the four columns are in or out together
  const float4 sc4 = *reinterpret_cast<const float4*>(scale + col);
  const long long slice = static_cast<long long>(R) * M;
  for (int rr = tid >> 5; rr < BN; rr += 8) {
    const int r = r0 + rr;
    if (r >= R) break;
    const float* src = ws + static_cast<long long>(r) * M + col;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    int sp = 0;
    for (; sp + 4 <= splits; sp += 4) {
      float4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __ldcg(reinterpret_cast<const float4*>(src + (sp + i) * slice));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sum.x += v[i].x;
        sum.y += v[i].y;
        sum.z += v[i].z;
        sum.w += v[i].w;
      }
    }
    for (; sp < splits; ++sp) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(src + sp * slice));
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    __nv_bfloat162 out[2] = {__floats2bfloat162_rn(sum.x * sc4.x, sum.y * sc4.y),
                             __floats2bfloat162_rn(sum.z * sc4.z, sum.w * sc4.w)};
    *reinterpret_cast<uint2*>(y + static_cast<long long>(r) * M + col) =
        *reinterpret_cast<const uint2*>(out);
  }
}

template <int BN>
int run(const void* x, const void* q, const void* scale, void* y, void* ws, void* tickets, int R,
        int K, int M, int splits, int kt_per_split, cudaStream_t stream) {
  CUtensorMap tx, tq;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(R)};
  const uint64_t x_strides[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t x_box[2] = {BK, BN};
  const uint64_t q_dims[2] = {static_cast<uint64_t>(M), static_cast<uint64_t>(K)};
  const uint64_t q_strides[1] = {static_cast<uint64_t>(M)};
  const uint32_t q_box[2] = {BM, BK};
  if (!encode_tiled_sw128(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, x_dims, x_strides, x_box) ||
      !encode_tiled_sw128(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, q_dims, q_strides, q_box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = int8_matmul_kernel<BN>;
  static const cudaError_t opted = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<BN>::SMEM);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  dim3 grid((M + BM - 1) / BM, (R + BN - 1) / BN, splits);
  kernel<<<grid, THREADS, Ring<BN>::SMEM, stream>>>(
      tx, tq, static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(ws), static_cast<int*>(tickets), R, M, (K + BK - 1) / BK, kt_per_split);
  return static_cast<int>(cudaGetLastError());
}

// ---- the simple kernel for M % 16 != 0 ------------------------------------
// A 128 x 64 output tile per block of 8 warps; x staged with cp.async, the
// codes with byte loads, widened to bf16 in shared memory, mma.sync.

constexpr int U_BM = 128, U_BN = 64, U_BK = 64;
constexpr int U_THREADS = 256;
constexpr int U_XSTR = U_BK + 8;  // bf16 elements per staged x row
constexpr int U_WSTR = U_BN + 8;  // bf16 elements per widened code row

__global__ void __launch_bounds__(U_THREADS)
int8_matmul_kernel_unaligned(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                             const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                             int R, int K, int M) {
  __shared__ __align__(16) __nv_bfloat16 xs[U_BM * U_XSTR];
  __shared__ __align__(16) __nv_bfloat16 wsm[U_BK * U_WSTR];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm = warp / 2;  // 4 x 2 warps, each 32 rows x 32 columns
  const int wn = warp % 2;
  const int c0 = blockIdx.x * U_BN;
  const int r0 = blockIdx.y * U_BM;

  float acc[2][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += U_BK) {
    __syncthreads();  // the previous tile has been consumed
    for (int c = tid; c < U_BM * (U_BK / 8); c += U_THREADS) {
      const int row = c / (U_BK / 8);
      const int col = (c % (U_BK / 8)) * 8;
      // K % 16 == 0: an 8-wide chunk lies wholly inside or outside K.
      const bool ok = r0 + row < R && k0 + col < K;
      const __nv_bfloat16* src = ok ? x + static_cast<long long>(r0 + row) * K + k0 + col : x;
      gaie::cp_async16(xs + row * U_XSTR + col, src, ok ? 16 : 0);
    }
    gaie::cp_async_commit();
    for (int c = tid; c < U_BK * U_BN; c += U_THREADS) {
      const int row = c / U_BN;
      const int col = c % U_BN;
      const bool ok = k0 + row < K && c0 + col < M;
      const float v = ok ? static_cast<float>(q[static_cast<long long>(k0 + row) * M + c0 + col]) : 0.f;
      wsm[row * U_WSTR + col] = __float2bfloat16(v);  // exact for +-127
    }
    gaie::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < U_BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        gaie::ldmatrix_x4(af[mi], xs + (wm * 32 + mi * 16 + (lane & 15)) * U_XSTR + kk +
                                      (lane >> 4) * 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ni += 2) {
        uint32_t bf[4];
        gaie::ldmatrix_x4_trans(bf, wsm + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * U_WSTR +
                                        wn * 32 + ni * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          gaie::mma_16816(acc[mi][ni], af[mi], bf);
          gaie::mma_16816(acc[mi][ni + 1], af[mi], bf + 2);
        }
      }
    }
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = c0 + wn * 32 + ni * 8 + t4 * 2;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + wm * 32 + mi * 16 + g + 8 * half;
        if (row >= R) continue;
        __nv_bfloat16* dst = y + static_cast<long long>(row) * M + col;
        if (col < M) dst[0] = __float2bfloat16(acc[mi][ni][2 * half] * scale[col]);
        if (col + 1 < M) dst[1] = __float2bfloat16(acc[mi][ni][2 * half + 1] * scale[col + 1]);
      }
    }
  }
}

}  // namespace

// x [R, K] bf16, q [K, M] int8 (both contiguous, 16-byte aligned),
// scale [M] f32, y [R, M] bf16 on the device; R >= 1, K a positive
// multiple of 16, any M >= 1. The plan (ops/int8_matmul.py's
// int8_matmul_plan) gives row_tile (8, 16, 32, 64, 128 or 256), splits
// and the 64-deep K tiles of each split; with splits > 1, ws is an f32
// [splits, R, M] workspace and tickets a zeroed int32 array of one entry
// per output tile, which the kernel leaves zeroed. With M % 16 != 0 the
// plan is ignored. Returns the launch's cudaError_t.
extern "C" int gaie_int8_matmul_bf16(const void* x, const void* q, const void* scale, void* y,
                                     void* ws, void* tickets, int R, int K, int M, int row_tile,
                                     int splits, int kt_per_split, void* stream) {
  if (R < 1 || M < 1 || K < 16 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M % 16 != 0) {
    if ((R + U_BM - 1) / U_BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((M + U_BN - 1) / U_BN, (R + U_BM - 1) / U_BM);
    int8_matmul_kernel_unaligned<<<grid, U_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), R, K, M);
    return static_cast<int>(cudaGetLastError());
  }
  const int nk = (K + BK - 1) / BK;
  if (splits < 1 || splits > 65535 || kt_per_split < 1 || (splits - 1) * kt_per_split >= nk ||
      splits * kt_per_split < nk || (splits > 1 && (ws == nullptr || tickets == nullptr)) ||
      (R + row_tile - 1) / row_tile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (row_tile) {
    case 8: return run<8>(x, q, scale, y, ws, tickets, R, K, M, splits, kt_per_split, s);
    case 16: return run<16>(x, q, scale, y, ws, tickets, R, K, M, splits, kt_per_split, s);
    case 32: return run<32>(x, q, scale, y, ws, tickets, R, K, M, splits, kt_per_split, s);
    case 64: return run<64>(x, q, scale, y, ws, tickets, R, K, M, splits, kt_per_split, s);
    case 128: return run<128>(x, q, scale, y, ws, tickets, R, K, M, splits, kt_per_split, s);
    case 256: return run<256>(x, q, scale, y, ws, tickets, R, K, M, splits, kt_per_split, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
