// Bidirectional, key-padding-masked encoder attention for Hopper
// (sm_90a): bf16 in, f32 scores and softmax, bf16 out. head_dim 64,
// any number of heads, S up to 512.
//
// Replaces the Pallas TPU kernel `_encoder_kernel` behind
// `encoder_attention` in generativeaiexamples_tpu/ops/encoder_attention.py.
//
// What it computes (the TPU kernel's contract and order of operations):
//   s[i, j] = scale * q[b, h, i] . k[b, h, j]          (f32 accumulate)
//   s[i, j] = -1e30 for keys j >= lengths[b]           (queries unmasked)
//   p = exp(s - max_j s);  denom = sum_j p
//   out[b, h, i] = bf16(p / denom) . v[b, h]           (f32 accumulate)
// A row of a sequence whose lengths is 0 has every score at -1e30, so
// its softmax is uniform over all S keys and the output is the average
// of V (the flash kernel writes zeros there; this one must not).
//
// What bounds it on an H100: at BERT shapes (S <= 512, D = 64) the work is
// 4 S^2 D flops per (batch, head) against 4 S D * 2 bytes of q/k/v/o, so
// up to ~S/2 flops per byte. At S = 512 the byte and flop bounds are
// within 15% of each other (bytes win by a little at full lengths), and
// at S <= 128 bytes dominate. The design therefore reads each input once:
//   - one block per (head, batch row): the head's whole K and V (at most
//     512 x 64 bf16 = 64 KB each) are staged in shared memory ONCE and
//     serve every query row of that head (dynamic shared memory opted in
//     above 48 KB), and only the keys below lengths[b] are staged;
//   - each warp owns 16-row query tiles (one, or two at S = 512; up to
//     16 warps a block), Q fragments in registers; both products run on
//     the tensor cores (mma.sync m16n8k16, bf16 inputs, f32 accumulate),
//     their K and V operands read from shared memory with ldmatrix (V
//     transposed on the way);
//   - the softmax is the plain one of the TPU kernel, not an online one:
//     a first sweep over the staged keys takes each row's exact max and
//     denominator, a second recomputes the scores, forms p / denom (p
//     times the reciprocal, exp as __expf: f32 rounding differences well
//     below the bf16 cast that follows), casts it to bf16 and multiplies
//     by V. The score matrix never leaves the registers; the price is
//     QK^T computed twice (1.5x the flops).
// Not done yet (later work): wgmma, TMA staging, and overlapping the
// K/V load of the next head with this head's math.
//
// Tensors are addressed through (batch, head, seq) strides in elements;
// the last dimension must be contiguous (a view of a fused-QKV projection
// is accepted as is).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using gaie::ldmatrix_x4;
using gaie::ldmatrix_x4_trans;
using gaie::mma_16816;
using gaie::pack_f32;

constexpr int D = 64;
constexpr int STR = D + 8;  // padded smem row stride (elements): no bank conflicts
constexpr int MAX_WARPS = 16;
constexpr int MAX_THREADS = MAX_WARPS * 32;
constexpr int BK = 64;      // keys per score tile
constexpr int MAX_S = 512;
constexpr float NEG_INF = -1e30f;  // same sentinel as the JAX package

// Scores of this warp's 16 query rows against keys [k0, k0 + 64), scaled
// and masked: keys >= n_keys get NEG_INF; with `uniform` (lengths 0)
// every staged key scores 0, so the softmax is uniform.
__device__ __forceinline__ void score_tile(float (*s)[4], const uint32_t (*qf)[4],
                                           const __nv_bfloat16* ks, int k0, int lane,
                                           int t4, int n_keys, bool uniform,
                                           float scale) {
  // ldmatrix row address of this lane: key (lane % 8) of an 8-key n-tile,
  // head-dim columns 8 (lane / 8) .. + 7 (the four matrices of one x4
  // load are the B operands of two 16-deep k-chunks).
  const __nv_bfloat16* kaddr = ks + (k0 + (lane & 7)) * STR + (lane >> 3) * 8;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; kc += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, kaddr + nt * 8 * STR + kc * 16);
      mma_16816(s[nt], qf[kc], bf);
      mma_16816(s[nt], qf[kc + 1], bf + 2);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = k0 + nt * 8 + t4 * 2 + e < n_keys;
      const float a = uniform ? 0.f : s[nt][e] * scale;
      const float c = uniform ? 0.f : s[nt][2 + e] * scale;
      s[nt][e] = ok ? a : NEG_INF;
      s[nt][2 + e] = ok ? c : NEG_INF;
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
encoder_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         const int* __restrict__ lengths, int S,
                         long long q_sb, long long q_sh, long long q_ss,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         long long o_sb, long long o_sh, long long o_ss,
                         float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int s_pad = (S + BK - 1) / BK * BK;
  __nv_bfloat16* vs = ks + s_pad * STR;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const int valid = lengths[b];
  const bool uniform = valid <= 0;
  const int n_keys = uniform ? S : (valid < S ? valid : S);
  const int k_stage = (n_keys + BK - 1) / BK * BK;  // staged rows, zero-padded

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;

  // Stage the head's K and V rows below n_keys once (16 bytes a thread).
  for (int c = threadIdx.x; c < k_stage * (D / 8); c += blockDim.x) {
    const int row = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 kv4 = make_uint4(0u, 0u, 0u, 0u);
    uint4 vv4 = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_keys) {
      kv4 = *reinterpret_cast<const uint4*>(kb + row * k_ss + col);
      vv4 = *reinterpret_cast<const uint4*>(vb + row * v_ss + col);
    }
    *reinterpret_cast<uint4*>(ks + row * STR + col) = kv4;
    *reinterpret_cast<uint4*>(vs + row * STR + col) = vv4;
  }
  __syncthreads();

  const int n_row_tiles = (S + 15) / 16;
  for (int rt = warp; rt < n_row_tiles; rt += nwarps) {
    const int r0 = rt * 16 + g;
    const int r1 = r0 + 8;
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int c = kc * 16 + t4 * 2;
      qf[kc][0] = r0 < S ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_ss + c) : 0u;
      qf[kc][1] = r1 < S ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_ss + c) : 0u;
      qf[kc][2] = r0 < S ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_ss + c + 8) : 0u;
      qf[kc][3] = r1 < S ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_ss + c + 8) : 0u;
    }

    // Sweep 1: each row's max over all its keys, then its denominator
    // (accumulated against the running max and rescaled when it moves).
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    for (int k0 = 0; k0 < n_keys; k0 += BK) {
      float s[BK / 8][4];
      score_tile(s, qf, ks, k0, lane, t4, n_keys, uniform, scale);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ps0 += s[nt][e] > 0.5f * NEG_INF ? __expf(s[nt][e] - mn0) : 0.f;
          ps1 += s[nt][2 + e] > 0.5f * NEG_INF ? __expf(s[nt][2 + e] - mn1) : 0.f;
        }
      }
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
      l0 = l0 * __expf(m0 - mn0) + ps0;
      l1 = l1 * __expf(m1 - mn1) + ps1;
      m0 = mn0;
      m1 = mn1;
    }

    // Sweep 2: p / denom in f32 (as p times 1 / denom), cast to bf16,
    // times V.
    const float inv0 = 1.f / l0;
    const float inv1 = 1.f / l1;
    // ldmatrix row address: key (lane % 8) + 8 ((lane / 8) % 2) of a
    // 16-key block, head-dim columns 8 (lane / 16) .. + 7; transposed,
    // the four matrices are the B operands of two 8-wide d-tiles.
    const __nv_bfloat16* vaddr =
        vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * STR + (lane >> 4) * 8;
    float acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    }
    for (int k0 = 0; k0 < n_keys; k0 += BK) {
      float s[BK / 8][4];
      score_tile(s, qf, ks, k0, lane, t4, n_keys, uniform, scale);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][e] = s[nt][e] > 0.5f * NEG_INF ? __expf(s[nt][e] - m0) * inv0 : 0.f;
          s[nt][2 + e] = s[nt][2 + e] > 0.5f * NEG_INF ? __expf(s[nt][2 + e] - m1) * inv1 : 0.f;
        }
      }
      // Keys [16 kk, 16 kk + 16) of the tile are n-tiles 2 kk and 2 kk + 1.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dt = 0; dt < D / 8; dt += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, vaddr + (k0 + kk * 16) * STR + dt * 8);
          mma_16816(acc[dt], pa, bf);
          mma_16816(acc[dt + 1], pa, bf + 2);
        }
      }
    }

#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int c = dt * 8 + t4 * 2;
      if (r0 < S) {
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * o_ss + c) =
            __floats2bfloat162_rn(acc[dt][0], acc[dt][1]);
      }
      if (r1 < S) {
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * o_ss + c) =
            __floats2bfloat162_rn(acc[dt][2], acc[dt][3]);
      }
    }
  }
}

}  // namespace

// q / k / v / o [B, H, S, 64] bf16, addressed by the 12 strides in
// `strides` (q, k, v, o; each batch, head, seq, in elements); lengths [B]
// int32 on the device. Returns the launch's cudaError_t (0 on success).
extern "C" int gaie_encoder_attention_bf16(
    const void* q, const void* k, const void* v, void* o, const void* lengths,
    int B, int H, int S, int Dh, const long long* st, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S > MAX_S || Dh != D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int s_pad = (S + BK - 1) / BK * BK;
  const int smem = 2 * s_pad * STR * static_cast<int>(sizeof(__nv_bfloat16));
  // The opt-in above 48 KB is set once, for the largest size seen (a
  // racing second caller sets the same value again).
  static int opted_in = 0;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        encoder_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  // One warp per 16-row query tile, at most 16 (two tiles a warp at 512).
  const int n_row_tiles = (S + 15) / 16;
  const int threads = 32 * (n_row_tiles < MAX_WARPS ? n_row_tiles : MAX_WARPS);
  dim3 grid(H, B);
  encoder_attention_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<const int*>(lengths), S, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return static_cast<int>(cudaGetLastError());
}
