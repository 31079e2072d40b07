// Causal / padded prefill flash attention for Hopper (sm_90a), bf16 in,
// f32 softmax state, bf16 out.
//
// Replaces the Pallas TPU kernel `_flash_kernel` behind
// `flash_attention` in generativeaiexamples_tpu/ops/attention.py.
//
// What it computes (the same contract as the TPU kernel):
//   out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[b, h / group, j]
// over keys j with j < lengths[b] and, when causal, j <= i + q_offset[b].
// Rows with no valid key are written as zeros. Keys at or past lengths[b]
// weigh exactly 0, so their k/v rows below Sk must be finite (the callers'
// buffers are: bucket padding and zero-initialised scratch caches).
//
// What bounds it on an H100: at the prefill buckets (S = 128 ... 4096,
// head_dim 128) the work is 4 * S^2 * D / 2 flops per (batch, head)
// against 4 * S * D * 2 bytes, far above the 295 flop/byte ridge, so it
// is bound by tensor-core throughput. The design (FlashAttention-3 shaped):
//   - one CTA per (128-query tile, head, batch row): one producer warp
//     and two consumer warpgroups of 64 query rows each; the producer
//     gives up registers (setmaxnreg) so the consumers hold a 64 x 128
//     score tile and a 64 x D output tile in registers;
//   - the producer brings Q once and K / V tiles of 128 keys through a
//     two-stage ring by TMA (128-byte swizzle, completion on mbarriers,
//     separate K and V barriers so S = Q K^T starts before V lands);
//   - S = Q K^T is a wgmma with both operands in shared memory; the
//     online softmax stays in the accumulator registers in f32 (exp2
//     with the scale folded into log2 units, the -1e30 sentinel of
//     ops/attention.py); P is rounded to bf16 in registers and
//     O += P V is a wgmma with P as the register A operand and V read
//     through a transposed (MN-major) descriptor, so V is never
//     gathered by hand; each product is waited for before the registers
//     it owns are touched, so ptxas keeps the wgmmas asynchronous (an
//     S of the next tile issued behind P.V made it serialise them,
//     warning C7515); the two warpgroups' softmaxes and products
//     interleave on the SM;
//   - key tiles past min(lengths[b], q0 + 128 + q_offset[b]) are never
//     loaded; only tiles that cross the diagonal or lengths[b] are
//     masked (TMA zero-fills the ragged edges, but a zero key still
//     scores 0, so those columns are masked too); a warpgroup whose rows
//     all lie below a tile's diagonal skips its products;
//   - the heaviest causal q tiles are scheduled first (grid z reversed);
//   - GQA indexes the kv head as h / group, so KV is never repeated.
// head_dim 64 is the same code with 64-wide boxes and an n64 P.V product.
// q, k and v are 4-D tensor maps over their (batch, head, seq) strides, so
// they may be views of token-major buffers; every stride must be a
// multiple of 16 bytes (the wrapper checks). The output is written from
// the accumulators with plain stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace gaie::hopper;
using gaie::pack_f32;

constexpr int BQ = 128;       // query rows per CTA (64 per consumer warpgroup)
constexpr int BK = 128;       // keys per K / V tile
constexpr int STAGES = 2;     // K / V ring depth
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr float NEG_INF = -1e30f;  // same sentinel as ops/attention.py
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int BOXES = D / 64;         // 128-byte boxes per row
  static constexpr int Q_BYTES = BQ * D * 2;   // BOXES boxes of [BQ][64]
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 256 + 1024;  // barriers, alignment slack
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                 const int* __restrict__ lengths, const int* __restrict__ q_offset, int group,
                 int Sq, int Sk, long long o_sb, long long o_sh, long long o_ss,
                 float scale_log2, int causal) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;
  unsigned char* ks = smem + L::Q_BYTES;                         // [STAGES] K tiles
  unsigned char* vs = smem + L::Q_BYTES + STAGES * L::KV_BYTES;  // [STAGES] V tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest causal tiles first
  const int kvh = h / group;
  int kv_len = lengths[b];
  kv_len = kv_len < 0 ? 0 : (kv_len > Sk ? Sk : kv_len);
  const int off = causal ? q_offset[b] : 0;
  // Keys past k_end are masked for every row of the CTA and never loaded.
  int k_end = kv_len;
  if (causal && q0 + BQ + off < k_end) k_end = q0 + BQ + off;
  const int nt = k_end > 0 ? (k_end + BK - 1) / BK : 0;

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

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread issues every copy.
    regs_dec<40>();
    if (threadIdx.x == 0 && nt > 0) {
      mbar_arrive_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int x = 0; x < L::BOXES; ++x) {
        tma_load_4d(qs + x * BQ * 128, &tq, q_full, 64 * x, q0, h, b);
      }
      for (int t = 0; t < nt; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) + 1) & 1);
        mbar_arrive_expect_tx(&k_full[s], L::KV_BYTES);
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x) {
          tma_load_4d(ks + s * L::KV_BYTES + x * BK * 128, &tk, &k_full[s], 64 * x, t * BK, kvh,
                      b);
        }
        mbar_arrive_expect_tx(&v_full[s], L::KV_BYTES);
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x) {
          tma_load_4d(vs + s * L::KV_BYTES + x * BK * 128, &tv, &v_full[s], 64 * x, t * BK, kvh,
                      b);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns query rows row0 .. row0 + 63.
  regs_inc<232>();
  const int cw = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row0 = q0 + 64 * cw;
  const int r0 = row0 + 16 * warp + g;  // the two query rows this thread owns
  const int r1 = r0 + 8;

  float acc[D / 2];  // O, 64 x D over the warpgroup
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  if (nt > 0) mbar_wait(q_full, 0);

  for (int t = 0; t < nt; ++t) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;
    const int k0 = t * BK;
    if (causal && k0 > row0 + 63 + off) {
      // Every key of this tile (and of the later ones) lies above this
      // warpgroup's diagonal. Release the stage once its copy has landed,
      // so the other warpgroup's arrivals for it are never overtaken.
      mbar_wait(&v_full[s], parity);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }

    // S = Q K^T, 64 x BK, both operands in shared memory.
    float sc[BK / 2];
    mbar_wait(&k_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int x = kc / 4;
      const int within = (kc % 4) * 32;
      const uint64_t da = desc_sw128(qs + x * BQ * 128 + cw * 64 * 128 + within, 0, 1024);
      const uint64_t db = desc_sw128(ks + s * L::KV_BYTES + x * BK * 128 + within, 0, 1024);
      Wgmma<BK>::ss<0>(sc, da, db, kc > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Scale into log2 units, mask where the tile crosses the diagonal or
    // lengths[b], and take the tile's row maxima.
    const bool need_mask = k0 + BK > kv_len || (causal && k0 + BK - 1 > row0 + off);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float s0 = sc[4 * j + c] * scale_log2;
        float s1 = sc[4 * j + 2 + c] * scale_log2;
        if (need_mask) {
          const int kp = k0 + 8 * j + 2 * t4 + c;
          if (kp >= kv_len || (causal && kp > r0 + off)) s0 = NEG_INF;
          if (kp >= kv_len || (causal && kp > r1 + off)) s1 = NEG_INF;
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
    const float a0 = exp2f(m0 - mn0);
    const float a1 = exp2f(m1 - mn1);

    // P in f32 for the row sums, then as bf16 A fragments: keys
    // [16 kk, 16 kk + 16) are accumulator columns 8-blocks 2 kk, 2 kk + 1.
    uint32_t pf[BK / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float s0 = sc[4 * j + c];
        const float s1 = sc[4 * j + 2 + c];
        p[c] = s0 > 0.5f * NEG_INF ? exp2f(s0 - mn0) : 0.f;
        p[2 + c] = s1 > 0.5f * NEG_INF ? exp2f(s1 - mn1) : 0.f;
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
    mbar_wait(&v_full[s], parity);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = desc_sw128(vs + s * L::KV_BYTES + kk * 16 * 128, BK * 128, 1024);
      Wgmma<D>::template rs<1>(acc, pf[kk], db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // Rows with no valid key have l == 0 and an all-zero accumulator.
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (r0 < Sq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * o_ss + c) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    }
    if (r1 < Sq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * o_ss + c) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, const void* lengths,
           const void* q_offset, int B, int H, int KH, int Sq, int Sk, const long long* st,
           float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_bhsd_sw128(&tq, q, B, H, Sq, D, st, BQ) ||
      !encode_bhsd_sw128(&tk, k, B, KH, Sk, D, st + 3, BK) ||
      !encode_bhsd_sw128(&tv, v, B, KH, Sk, D, st + 6, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_kernel<D>;
  // Above 48 KB of shared memory needs the opt-in, once per instantiation.
  static const cudaError_t opted = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::SMEM);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, Layout<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<const int*>(lengths),
      static_cast<const int*>(q_offset), H / KH, Sq, Sk, st[9], st[10], st[11], scale * LOG2E,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, Sq, D], k / v [B, KH, Sk, D], o [B, H, Sq, D], all bf16 and
// addressed by the 12 strides in `strides` (q, k, v, o; each batch, head,
// seq, in elements; q, k and v strides multiples of 8 and the bases
// 16-byte aligned). lengths / q_offset: [B] int32 on the device. Returns
// the launch's cudaError_t (0 on success).
extern "C" int gaie_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                         const void* lengths, const void* q_offset, int B, int H,
                                         int KH, int Sq, int Sk, int D, const long long* strides,
                                         float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0 || B > 65535 ||
      H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return launch<128>(q, k, v, o, lengths, q_offset, B, H, KH, Sq, Sk, strides, scale, causal, s);
  }
  if (D == 64) {
    return launch<64>(q, k, v, o, lengths, q_offset, B, H, KH, Sq, Sk, strides, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
