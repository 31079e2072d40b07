// Bidirectional, key-padding-masked encoder attention for Hopper
// (sm_90a): bf16 in, f32 scores and softmax, bf16 out. head_dim 64,
// any number of heads, S up to 512.
//
// Replaces the Pallas TPU kernel `_encoder_kernel` behind
// `encoder_attention` in generativeaiexamples_tpu/ops/encoder_attention.py.
//
// What it computes (the TPU kernel's contract):
//   s[i, j] = scale * q[b, h, i] . k[b, h, j]          (f32 accumulate)
//   s[i, j] = -1e30 for keys j >= lengths[b]           (queries unmasked)
//   out[b, h, i] = softmax_j(s[i, :]) . v[b, h]        (f32 accumulate)
// A row of a sequence whose lengths is 0 has every score at -1e30, so
// its softmax is uniform over all S keys and the output is the average
// of V (the flash kernel writes zeros there; this one must not).
//
// What bounds it on an H100: at BERT shapes (S <= 512, D = 64) the work is
// 4 S^2 D flops per (batch, head) against 4 S D * 2 bytes of q/k/v/o, so
// up to ~S/2 flops per byte: at S = 512 the byte and flop bounds are
// within 15% of each other, at S <= 128 bytes dominate. The design is the
// flash kernel's (flash_attention.cu) cut to this shape:
//   - one CTA per (128-query tile, head, batch row): two consumer
//     warpgroups of 64 query rows and one producer warp, so arctic-embed-l
//     at S = 512 (B = 16, H = 16) gives 1,024 CTAs, two resident per SM
//     (83 KB of shared memory and at most 112 registers a thread each);
//     the query tiles of one head re-read its K and V from L2;
//   - the producer brings Q once and K / V tiles of 64 keys through a
//     four-stage ring by TMA (128-byte swizzle, completion on mbarriers,
//     separate K and V barriers), straight from the strided views
//     bert.forward passes (the maps carry the view's seq stride); tiles
//     past lengths[b] are never loaded;
//   - S = Q K^T is a wgmma with both operands in shared memory; P is
//     rounded to bf16 in registers and O += P V is a wgmma with P as the
//     register A operand and V read through a transposed descriptor;
//   - the softmax is online, in the accumulator registers (exp2 with the
//     scale folded into log2 units): out = (bf16(p) . V) / denom. The TPU
//     kernel's order, bf16(p / denom) . V, rounds p after the division;
//     the two differ by bf16 rounding of p (2^-9 relative), far inside the
//     2e-2 tolerance. That order on tensor cores needs two sweeps (exact
//     max and denominator first, then S again for P . V), which measured
//     slower at arctic-embed-l, as did 128-key tiles (PERF.md). Tile
//     0 always holds a valid key (lengths 0 counts all S keys), so the
//     running max is finite from the first tile and a masked score's
//     exp2 is exactly 0.
// Tensors are addressed through (batch, head, seq) strides in elements;
// the last dimension is contiguous, other strides multiples of 8 and the
// bases 16-byte aligned (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace gaie::hopper;
using gaie::pack_f32;

constexpr int D = 64;
constexpr int BQ = 128;       // query rows per CTA (64 per consumer warpgroup)
constexpr int BK = 64;        // keys per K / V tile
constexpr int STAGES = 4;     // K / V ring depth
constexpr int THREADS = 288;  // two consumer warpgroups + one producer warp
constexpr int MAX_S = 512;
constexpr int Q_BYTES = BQ * D * 2;
constexpr int KV_BYTES = BK * D * 2;
constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
constexpr int SMEM = BAR_OFF + 256 + 1024;  // barriers, alignment slack
constexpr float NEG_INF = -1e30f;  // same sentinel as the JAX package

__global__ void __launch_bounds__(THREADS, 2)
encoder_attention_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                         const int* __restrict__ lengths, int S, long long o_sb, long long o_sh,
                         long long o_ss, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;
  unsigned char* ks = smem + Q_BYTES;                    // [STAGES] K tiles
  unsigned char* vs = smem + Q_BYTES + STAGES * KV_BYTES;  // [STAGES] V tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.z * BQ;
  const int valid = lengths[b];
  const bool uniform = valid <= 0;
  const int n_keys = uniform ? S : (valid < S ? valid : S);
  const int nt = (n_keys + BK - 1) / BK;  // >= 1

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 8) {
    // Producer: one thread issues every copy.
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, Q_BYTES);
      tma_load_4d(qs, &tq, q_full, 0, q0, h, b);
      for (int t = 0; t < nt; ++t) {
        const int s = t % STAGES;
        const int k0 = t * BK;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) + 1) & 1);
        mbar_arrive_expect_tx(&k_full[s], KV_BYTES);
        tma_load_4d(ks + s * KV_BYTES, &tk, &k_full[s], 0, k0, h, b);
        mbar_arrive_expect_tx(&v_full[s], KV_BYTES);
        tma_load_4d(vs + s * KV_BYTES, &tv, &v_full[s], 0, k0, h, b);
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63.
  const int cw = warp >> 2;
  const int w = warp & 3;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = q0 + 64 * cw + 16 * w + g;  // the two query rows this thread owns
  const int r1 = r0 + 8;
  const unsigned char* qw = qs + cw * 64 * 128;

  float acc[D / 2];  // O, 64 x D over the warpgroup
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  mbar_wait(q_full, 0);

  for (int t = 0; t < nt; ++t) {
    const int s = t % STAGES;
    const int k0 = t * BK;

    // S = Q K^T, 64 x BK, both operands in shared memory.
    float sc[BK / 2];
    mbar_wait(&k_full[s], (t / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint64_t da = desc_sw128(qw + kc * 32, 0, 1024);
      const uint64_t db = desc_sw128(ks + s * KV_BYTES + kc * 32, 0, 1024);
      Wgmma<BK>::ss<0>(sc, da, db, kc > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Scale into log2 units (0 everywhere for a lengths-0 row) and mask
    // keys at and past n_keys (TMA zero-fills past S; those score 0 too).
    const bool need_mask = k0 + BK > n_keys;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float s0 = uniform ? 0.f : sc[4 * j + c] * scale_log2;
        float s1 = uniform ? 0.f : sc[4 * j + 2 + c] * scale_log2;
        if (need_mask && k0 + 8 * j + 2 * t4 + c >= n_keys) {
          s0 = NEG_INF;
          s1 = NEG_INF;
        }
        sc[4 * j + c] = s0;
        sc[4 * j + 2 + c] = s1;
        mx0 = fmaxf(mx0, s0);
        mx1 = fmaxf(mx1, s1);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);

    // P in f32 for the row sums, then as bf16 A fragments: keys
    // [16 kk, 16 kk + 16) are accumulator column 8-blocks 2 kk, 2 kk + 1.
    uint32_t pf[BK / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        p[c] = exp2f(sc[4 * j + c] - mn0);
        p[2 + c] = exp2f(sc[4 * j + 2 + c] - mn1);
        ps0 += p[c];
        ps1 += p[2 + c];
      }
      pf[j / 2][2 * (j % 2)] = pack_f32(p[0], p[1]);
      pf[j / 2][2 * (j % 2) + 1] = pack_f32(p[2], p[3]);
    }
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
    const float a0 = exp2f(m0 - mn0);
    const float a1 = exp2f(m1 - mn1);
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= a0;
      acc[4 * j + 1] *= a0;
      acc[4 * j + 2] *= a1;
      acc[4 * j + 3] *= a1;
    }

    // O += P V: P from registers, V (keys x D, D contiguous) MN-major.
    mbar_wait(&v_full[s], (t / STAGES) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = desc_sw128(vs + s * KV_BYTES + kk * 16 * 128, BK * 128, 1024);
      Wgmma<D>::template rs<1>(acc, pf[kk], db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // Every row saw at least one valid key, so l > 0.
  const float out0 = 1.f / l0;
  const float out1 = 1.f / l1;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (r0 < S) {
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * o_ss + c) =
          __floats2bfloat162_rn(acc[4 * j] * out0, acc[4 * j + 1] * out0);
    }
    if (r1 < S) {
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * o_ss + c) =
          __floats2bfloat162_rn(acc[4 * j + 2] * out1, acc[4 * j + 3] * out1);
    }
  }
}

}  // namespace

// q / k / v / o [B, H, S, 64] bf16, addressed by the 12 strides in
// `strides` (q, k, v, o; each batch, head, seq, in elements; q, k and v
// strides multiples of 8 and the bases 16-byte aligned); lengths [B]
// int32 on the device. Returns the launch's cudaError_t (0 on success).
extern "C" int gaie_encoder_attention_bf16(
    const void* q, const void* k, const void* v, void* o, const void* lengths,
    int B, int H, int S, int Dh, const long long* st, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S > MAX_S || Dh != D || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv;
  if (!encode_bhsd_sw128(&tq, q, B, H, S, D, st, BQ) ||
      !encode_bhsd_sw128(&tk, k, B, H, S, D, st + 3, BK) ||
      !encode_bhsd_sw128(&tv, v, B, H, S, D, st + 6, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Above 48 KB of shared memory needs the opt-in, once.
  static const cudaError_t opted = cudaFuncSetAttribute(
      encoder_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  dim3 grid(H, B, (S + BQ - 1) / BQ);
  encoder_attention_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<const int*>(lengths), S, st[9],
      st[10], st[11], scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}
