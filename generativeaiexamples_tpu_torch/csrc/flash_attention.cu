// Causal / padded prefill flash attention for Hopper (sm_90a), bf16 in,
// f32 softmax state, bf16 out.
//
// Replaces the Pallas TPU kernel `_flash_kernel` behind
// `flash_attention` in generativeaiexamples_tpu/ops/attention.py.
//
// What it computes (the same contract as the TPU kernel):
//   out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[b, h / group, j]
// over keys j with j < lengths[b] and, when causal, j <= i + q_offset[b].
// Rows with no valid key are written as zeros.
//
// What bounds it on an H100: at the prefill buckets (S = 128 ... 4096,
// head_dim 128) the work is 4 * S^2 * D / 2 flops per (batch, head)
// against 4 * S * D * 2 bytes, far above the 295 flop/byte ridge, so it
// is bound by tensor-core throughput. The design therefore:
//   - runs both products on the tensor cores (mma.sync m16n8k16 bf16,
//     f32 accumulate) and keeps the S x S score matrix in registers, so
//     it never reaches device memory;
//   - keeps the running max / denominator / output accumulator of each
//     query row in registers for the whole key loop (the TPU version
//     carried them in VMEM scratch across sequential grid steps; here the
//     key loop is inside the block);
//   - skips key tiles wholly above the shifted causal diagonal and past
//     lengths[b];
//   - indexes the kv head as h / group, so KV is never repeated.
// Not done yet (later work): cp.async / TMA double buffering of the K/V
// tiles and wgmma; the K/V tile load is synchronous.
//
// Layout: one block of 4 warps per (64-row query tile, head, batch row);
// each warp owns 16 query rows. K and V tiles of 64 keys are staged in
// shared memory with a padded row stride so the fragment reads are free
// of bank conflicts. Any Sq / Sk is accepted; ragged edges are masked.
// Tensors are addressed through (batch, head, seq) strides in elements;
// the last dimension must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using gaie::mma_16816;
using gaie::pack_bf16;
using gaie::pack_f32;

constexpr int BQ = 64;      // query rows per block (16 per warp)
constexpr int BK = 64;      // keys per shared-memory tile
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;  // same sentinel as ops/attention.py

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 const int* __restrict__ lengths,
                 const int* __restrict__ q_offset,
                 int group, int Sq, int Sk,
                 long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 long long o_sb, long long o_sh, long long o_ss,
                 float scale, int causal) {
  constexpr int STR = D + 8;  // padded smem row stride (elements)
  __shared__ __align__(16) __nv_bfloat16 ks[BK * STR];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * STR];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int t4 = lane & 3;   // thread within the group
  const int q0 = blockIdx.x * BQ;
  const int r0 = q0 + warp * 16 + g;  // the two query rows this thread owns
  const int r1 = r0 + 8;

  int kv_len = lengths[b];
  kv_len = kv_len < 0 ? 0 : (kv_len > Sk ? Sk : kv_len);
  const int off = causal ? q_offset[b] : 0;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;

  // Q fragments stay in registers for the whole key loop.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + t4 * 2;
    qf[kc][0] = r0 < Sq ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_ss + c) : 0u;
    qf[kc][1] = r1 < Sq ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_ss + c) : 0u;
    qf[kc][2] = r0 < Sq ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_ss + c + 8) : 0u;
    qf[kc][3] = r1 < Sq ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_ss + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // Keys past this bound are masked for every row of the block: tiles
  // wholly above the (q_offset-shifted) causal diagonal are skipped.
  int k_end = kv_len;
  if (causal) {
    const int diag = q0 + BQ + off;  // last visible key + 1
    k_end = k_end < diag ? k_end : diag;
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    for (int c = threadIdx.x; c < BK * D / 8; c += NTHREADS) {
      const int row = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + row < kv_len) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (k0 + row) * k_ss + col);
        vv4 = *reinterpret_cast<const uint4*>(vb + (k0 + row) * v_ss + col);
      }
      *reinterpret_cast<uint4*>(ks + row * STR + col) = kv4;
      *reinterpret_cast<uint4*>(vs + row * STR + col) = vv4;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = ks + (nt * 8 + g) * STR + t4 * 2;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(krow + kc * 16);
        bf[1] = *reinterpret_cast<const uint32_t*>(krow + kc * 16 + 8);
        mma_16816(s[nt], qf[kc], bf);
      }
    }

    // Mask, scale and take the tile's row maxima.
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + nt * 8 + t4 * 2 + e;
        const bool ok0 = kp < kv_len && (!causal || kp <= r0 + off);
        const bool ok1 = kp < kv_len && (!causal || kp <= r1 + off);
        s[nt][e] = ok0 ? s[nt][e] * scale : NEG_INF;
        s[nt][2 + e] = ok1 ? s[nt][2 + e] * scale : NEG_INF;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float a0 = __expf(m0 - mn0);
    const float a1 = __expf(m1 - mn1);

    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = s[nt][e] > 0.5f * NEG_INF ? __expf(s[nt][e] - mn0) : 0.f;
        const float p1 = s[nt][2 + e] > 0.5f * NEG_INF ? __expf(s[nt][2 + e] - mn1) : 0.f;
        s[nt][e] = p0;
        s[nt][2 + e] = p1;
        ps0 += p0;
        ps1 += p1;
      }
    }
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= a0;
      acc[dt][1] *= a0;
      acc[dt][2] *= a1;
      acc[dt][3] *= a1;
    }

    // O += P V. The score accumulators are reused as the A operand:
    // keys [16 kk, 16 kk + 16) are n-tiles 2 kk and 2 kk + 1.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vrow = vs + (kk * 16 + t4 * 2) * STR + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vp = vrow + dt * 8;
        uint32_t bf[2];
        bf[0] = pack_bf16(vp[0], vp[STR]);
        bf[1] = pack_bf16(vp[8 * STR], vp[9 * STR]);
        mma_16816(acc[dt], pa, bf);
      }
    }
  }

  // Rows with no valid key have l == 0 and an all-zero accumulator.
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < Sq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * o_ss + c) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    }
    if (r1 < Sq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * o_ss + c) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
    }
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o,
            const void* lengths, const void* q_offset, int B, int H, int group,
            int Sq, int Sk, const long long* st, float scale, int causal,
            cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<const int*>(lengths), static_cast<const int*>(q_offset),
      group, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale, causal);
}

}  // namespace

// q [B, H, Sq, D], k / v [B, KH, Sk, D], o [B, H, Sq, D], all bf16 and
// addressed by the 12 strides in `strides` (q, k, v, o; each batch, head,
// seq, in elements). lengths / q_offset: [B] int32 on the device.
// Returns the launch's cudaError_t (0 on success).
extern "C" int gaie_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, const void* lengths,
    const void* q_offset, int B, int H, int KH, int Sq, int Sk, int D,
    const long long* strides, float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = H / KH;
  if (D == 128) {
    launch<128>(q, k, v, o, lengths, q_offset, B, H, group, Sq, Sk, strides, scale, causal, s);
  } else if (D == 64) {
    launch<64>(q, k, v, o, lengths, q_offset, B, H, group, Sq, Sk, strides, scale, causal, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
