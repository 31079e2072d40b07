// Paged decode attention over the fused int8 KV pool for Hopper
// (sm_90a): one query token per sequence, int8 codes with one f32 scale
// per (k|v, layer, kv head, token), f32 online softmax, bf16 output.
//
// Replaces the Pallas TPU kernel `_int8_kernel` behind
// `paged_attention_int8` in
// generativeaiexamples_tpu/serving/paged_attention_int8.py (its q_rep = 1
// form; the q_rep > 1 and tree forms belong to speculation).
//
// What it computes (the TPU kernel's contract):
//   s[h, j] = (q[b, h] . kcode[j]) * kscale[j]        (q f32, scale folded)
//   out[b, h] = sum_j softmax_j(s)[h, j] * vscale[j] * vcode[j],  j < len
// over the FULL pool: codes [2, L, KH, P, ps, Hd] int8 ([0] = k, [1] = v)
// and scales [2, L, KH, P, ps] f32, with the layer indexed inside the
// kernel (a host-side slice kv[:, l] of the kv-leading layout is strided).
// Token j of sequence b lives in page page_table[b, j / ps] at offset
// j % ps. len = clamp(lengths[b], 1, maxp * ps), as the TPU wrapper
// clamps it; a row whose denominator is 0 is divided by 1. Table slots at
// and past ceil(len / ps) are never read.
//
// What bounds it on an H100: decode attention is far below the ridge, so
// it is bound by reading the pool. A page of one kv head is ps * Hd bytes
// of k codes plus as many of v codes plus 8 ps bytes of scales (33 KB at
// ps = Hd = 128, against 64 KB for bf16 pages), and dequantization never
// widens head_dim: the k scales multiply score columns and the v scales
// fold into the probabilities. The design:
//   - one block per (kv head, batch row); the group's H / KH query heads
//     share each staged page, so every page is read once;
//   - pages are staged in shared memory with 16-byte cp.async, double
//     buffered: page p + 1 is in flight while page p is computed;
//   - codes are widened to f32 in registers on CUDA cores: a group of
//     4 query rows gives tensor cores little to do;
//   - the online softmax runs over pages with f32 state in shared memory.
// Not done yet (later work): splitting the page axis across blocks
// (flash-decoding), which 64 blocks at B = 8 x KH = 8 would need to fill
// 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using gaie::cp_async16;
using gaie::cp_async_commit;
using gaie::cp_async_wait;

constexpr int NTHREADS = 256;
constexpr int MAX_G = 8;  // query heads per kv head
constexpr int MAX_OUT = MAX_G * 128 / NTHREADS;  // outputs per thread
constexpr float NEG_INF = -1e30f;  // same sentinel as the JAX package

__device__ __forceinline__ float code(uint32_t word, int byte) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * byte)) & 0xffu));
}

template <int HD>
__host__ __device__ constexpr int code_stride() {
  return HD + 16;  // bytes per staged code row (keeps 16-byte reads conflict-free)
}

__host__ __device__ inline int stage_bytes(int ps, int cstr) {
  return 2 * ps * cstr + 2 * ps * static_cast<int>(sizeof(float));
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
paged_int8_kernel(const float* __restrict__ q, const int8_t* __restrict__ kv,
                  const float* __restrict__ scales, __nv_bfloat16* __restrict__ o,
                  const int* __restrict__ page_table, const int* __restrict__ lengths,
                  int H, int L, int KH, int P, int ps, int maxp, int group, int layer) {
  constexpr int CSTR = code_stride<HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int sbytes = stage_bytes(ps, CSTR);
  float* qs = reinterpret_cast<float*>(smem + 2 * sbytes);  // [group][HD]
  float* sc = qs + group * HD;                               // [group][ps]
  float* alpha = sc + group * ps;                            // [group]
  float* mrun = alpha + group;                               // [group]
  float* lrun = mrun + group;                                // [group]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  int len = lengths[b];
  len = len < 1 ? 1 : (len > maxp * ps ? maxp * ps : len);
  const int npages = (len + ps - 1) / ps;
  const int nout = group * HD;
  const long long plane = static_cast<long long>(L) * KH * P;  // pages per k|v plane

  // Stage page slot p of row b into buffer buf: k codes, v codes [ps][CSTR]
  // then k scales, v scales [ps].
  auto load_page = [&](int buf, int p) {
    int page = page_table[static_cast<long long>(b) * maxp + p];
    if (page < 0 || page >= P) page = 0;  // as a clamped TPU gather would
    const long long kpage = (static_cast<long long>(layer) * KH + kvh) * P + page;
    const long long vpage = kpage + plane;
    const int8_t* kc = kv + kpage * ps * HD;
    const int8_t* vc = kv + vpage * ps * HD;
    unsigned char* st = smem + buf * sbytes;
    int8_t* kcs = reinterpret_cast<int8_t*>(st);
    int8_t* vcs = kcs + ps * CSTR;
    float* kss = reinterpret_cast<float*>(vcs + ps * CSTR);
    float* vss = kss + ps;
    for (int c = tid; c < ps * (HD / 16); c += NTHREADS) {
      const int row = c / (HD / 16);
      const int col = (c % (HD / 16)) * 16;
      cp_async16(kcs + row * CSTR + col, kc + row * HD + col);
      cp_async16(vcs + row * CSTR + col, vc + row * HD + col);
    }
    for (int c = tid; c < ps / 4; c += NTHREADS) {
      cp_async16(kss + 4 * c, scales + kpage * ps + 4 * c);
      cp_async16(vss + 4 * c, scales + vpage * ps + 4 * c);
    }
  };

  load_page(0, 0);
  cp_async_commit();

  const float* qb = q + (static_cast<long long>(b) * H + kvh * group) * HD;
  for (int i = tid; i < nout; i += NTHREADS) qs[i] = qb[i];
  for (int i = tid; i < group; i += NTHREADS) {
    mrun[i] = NEG_INF;
    lrun[i] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) acc[j] = 0.f;

  for (int p = 0; p < npages; ++p) {
    if (p + 1 < npages) load_page((p + 1) & 1, p + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of page p landed
    __syncthreads();     // everyone's did (and qs / state are written)

    const unsigned char* st = smem + (p & 1) * sbytes;
    const int8_t* kcs = reinterpret_cast<const int8_t*>(st);
    const int8_t* vcs = kcs + ps * CSTR;
    const float* kss = reinterpret_cast<const float*>(vcs + ps * CSTR);
    const float* vss = kss + ps;

    // Scores for every (query head of the group, token of the page).
    for (int i = tid; i < group * ps; i += NTHREADS) {
      const int h = i / ps;
      const int j = i - h * ps;
      float s = NEG_INF;
      if (p * ps + j < len) {
        const float* qh = qs + h * HD;
        const int8_t* kr = kcs + j * CSTR;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; d += 16) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
          const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
#pragma unroll
            for (int e = 0; e < 4; ++e) dot = fmaf(qh[d + 4 * w + e], code(words[w], e), dot);
          }
        }
        s = dot * kss[j];
      }
      sc[i] = s;
    }
    __syncthreads();

    // Online softmax, one warp per query head: the running max and
    // denominator take p, and the P.V weights p * vscale replace the
    // scores (masked tokens weigh 0 whatever their scale holds).
    for (int h = warp; h < group; h += NTHREADS / 32) {
      float mx = NEG_INF;
      for (int j = lane; j < ps; j += 32) mx = fmaxf(mx, sc[h * ps + j]);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = mrun[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < ps; j += 32) {
        const float s = sc[h * ps + j];
        const bool valid = s > 0.5f * NEG_INF;
        const float e = valid ? __expf(s - m_new) : 0.f;
        sc[h * ps + j] = valid ? e * vss[j] : 0.f;
        sum += e;
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (lane == 0) {
        const float a = __expf(m_old - m_new);
        alpha[h] = a;
        lrun[h] = lrun[h] * a + sum;
        mrun[h] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + (p * vscale) . vcode for this thread's outputs.
#pragma unroll
    for (int jo = 0; jo < MAX_OUT; ++jo) {
      const int idx = tid + jo * NTHREADS;
      if (idx < nout) {
        const int h = idx / HD;
        const int d = idx - h * HD;
        const float* wh = sc + h * ps;
        float a = acc[jo] * alpha[h];
        for (int j = 0; j < ps; ++j) {
          a = fmaf(wh[j], static_cast<float>(vcs[j * CSTR + d]), a);
        }
        acc[jo] = a;
      }
    }
    __syncthreads();  // buffer p & 1 and sc are free for the next page
  }

  __nv_bfloat16* ob = o + (static_cast<long long>(b) * H + kvh * group) * HD;
#pragma unroll
  for (int jo = 0; jo < MAX_OUT; ++jo) {
    const int idx = tid + jo * NTHREADS;
    if (idx < nout) {
      const float l = lrun[idx / HD];
      ob[idx] = __float2bfloat16(acc[jo] / (l == 0.f ? 1.f : l));
    }
  }
}

template <int HD>
int launch(const void* q, const void* kv, const void* scales, void* o, const void* table,
           const void* lengths, int B, int H, int KH, int L, int P, int ps, int maxp,
           int layer, cudaStream_t stream) {
  const int group = H / KH;
  const int smem = 2 * stage_bytes(ps, code_stride<HD>()) +
                   static_cast<int>(sizeof(float)) * (group * HD + group * ps + 3 * group);
  cudaError_t err = cudaFuncSetAttribute(paged_int8_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(KH, B);
  paged_int8_kernel<HD><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kv),
      static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(o),
      static_cast<const int*>(table), static_cast<const int*>(lengths), H, L, KH, P, ps, maxp,
      group, layer);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, Hd] f32 (softmax scale folded in), codes [2, L, KH, P, ps, Hd]
// int8, scales [2, L, KH, P, ps] f32, o [B, H, Hd] bf16, all contiguous;
// page_table [B, maxp] and lengths [B] int32 on the device; layer in
// [0, L). Hd in {64, 128}, ps a multiple of 16 up to 128, H / KH <= 8.
// Returns the launch's cudaError_t (0 on success).
extern "C" int gaie_paged_attention_int8(const void* q, const void* kv, const void* scales,
                                         void* o, const void* page_table, const void* lengths,
                                         int B, int H, int KH, int L, int P, int ps, int maxp,
                                         int Hd, int layer, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || H / KH > MAX_G || ps <= 0 || ps % 16 != 0 ||
      ps > 128 || maxp <= 0 || P <= 0 || L <= 0 || layer < 0 || layer >= L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hd == 128) return launch<128>(q, kv, scales, o, page_table, lengths, B, H, KH, L, P, ps, maxp, layer, s);
  if (Hd == 64) return launch<64>(q, kv, scales, o, page_table, lengths, B, H, KH, L, P, ps, maxp, layer, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
