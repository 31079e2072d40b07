// Paged decode attention for Hopper (sm_90a): one query token per
// sequence over that sequence's KV pages, bf16 pages and queries, f32
// online softmax, output in the query's dtype (bf16).
//
// Replaces the Pallas TPU kernel `_paged_kernel` behind
// `paged_attention` in generativeaiexamples_tpu/serving/paged_attention.py,
// and with it the `_paged_tpu` route to JAX's bundled JetStream kernel.
//
// What it computes (the same contract as the TPU kernel):
//   out[b, h] = softmax_j(scale * q[b, h] . K[b, j]) V[b, j],  j < lengths[b]
// where token j of sequence b lives in page page_table[b, j / ps] at
// offset j % ps of the [KH, P, ps, Hd] pool slice of one layer; lengths
// counts the current token (its k/v are already written). Table slots
// past ceil(lengths[b] / ps) are never read (they point at sink page 0).
//
// What bounds it on an H100: decode attention does 4 * Hd flops per
// (head, cached token) against 2 * Hd * 2 bytes of K/V per (kv head,
// token), about group = H / KH flops per byte -- far below the ridge, so
// it is bound by reading the KV pages from device memory. The design:
//   - one block per (kv head, batch row); the group's H / KH query heads
//     share every K/V page staged in shared memory, so each page is read
//     from device memory once, not once per query head;
//   - only the pages below lengths[b] are read;
//   - the softmax runs online over pages with f32 state in shared memory.
// Not done yet (later work): splitting the page axis across blocks
// (flash-decoding) so that small B x KH fills the 132 SMs, and
// overlapping the next page's load with this page's math (cp.async).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int MAX_OUT = 8;  // outputs per thread: group * Hd <= 1024
constexpr float NEG_INF = -1e30f;  // same sentinel as the JAX package

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    __nv_bfloat16* __restrict__ o,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    int H, int P, int ps, int maxp, int group, float scale) {
  constexpr int STR = HD + 8;  // padded smem row stride (elements)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [ps][STR]
  __nv_bfloat16* vs = ks + ps * STR;                           // [ps][STR]
  float* qs = reinterpret_cast<float*>(vs + ps * STR);         // [group][HD]
  float* sc = qs + group * HD;                                 // [group][ps]
  float* alpha = sc + group * ps;                              // [group]
  float* mrun = alpha + group;                                 // [group]
  float* lrun = mrun + group;                                  // [group]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > maxp * ps ? maxp * ps : len);
  const int npages = (len + ps - 1) / ps;
  const int nout = group * HD;

  const __nv_bfloat16* qb = q + (static_cast<long long>(b) * H + kvh * group) * HD;
  for (int i = tid; i < nout; i += NTHREADS) {
    qs[i] = __bfloat162float(qb[i]) * scale;
  }
  for (int i = tid; i < group; i += NTHREADS) {
    mrun[i] = NEG_INF;
    lrun[i] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) acc[j] = 0.f;

  for (int p = 0; p < npages; ++p) {
    int page = page_table[static_cast<long long>(b) * maxp + p];
    // Out-of-range ids read the sink page, as a clamped TPU gather would.
    if (page < 0 || page >= P) page = 0;
    const long long base = (static_cast<long long>(kvh) * P + page) * ps * HD;
    const __nv_bfloat16* kp = k_pages + base;
    const __nv_bfloat16* vp = v_pages + base;

    __syncthreads();  // the previous page has been consumed
    for (int c = tid; c < ps * HD / 8; c += NTHREADS) {
      const int row = c / (HD / 8);
      const int col = (c % (HD / 8)) * 8;
      *reinterpret_cast<uint4*>(ks + row * STR + col) =
          *reinterpret_cast<const uint4*>(kp + row * HD + col);
      *reinterpret_cast<uint4*>(vs + row * STR + col) =
          *reinterpret_cast<const uint4*>(vp + row * HD + col);
    }
    __syncthreads();

    // Scores for every (query head of the group, key of the page).
    for (int i = tid; i < group * ps; i += NTHREADS) {
      const int h = i / ps;
      const int j = i - h * ps;
      float s = NEG_INF;
      if (p * ps + j < len) {
        const float* qh = qs + h * HD;
        const __nv_bfloat16* kr = ks + j * STR;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; d += 8) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 kf = __bfloat1622float2(k2[e]);
            dot = fmaf(qh[d + 2 * e], kf.x, dot);
            dot = fmaf(qh[d + 2 * e + 1], kf.y, dot);
          }
        }
        s = dot;
      }
      sc[i] = s;
    }
    __syncthreads();

    // Online softmax update, one warp per query head.
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
        const float e = s > 0.5f * NEG_INF ? __expf(s - m_new) : 0.f;
        sc[h * ps + j] = e;
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

    // acc = alpha * acc + P V for this thread's (head, dim) outputs.
#pragma unroll
    for (int jo = 0; jo < MAX_OUT; ++jo) {
      const int idx = tid + jo * NTHREADS;
      if (idx < nout) {
        const int h = idx / HD;
        const int d = idx - h * HD;
        const float* ph = sc + h * ps;
        float a = acc[jo] * alpha[h];
        for (int j = 0; j < ps; ++j) {
          a = fmaf(ph[j], __bfloat162float(vs[j * STR + d]), a);
        }
        acc[jo] = a;
      }
    }
  }
  __syncthreads();

  __nv_bfloat16* ob = o + (static_cast<long long>(b) * H + kvh * group) * HD;
#pragma unroll
  for (int jo = 0; jo < MAX_OUT; ++jo) {
    const int idx = tid + jo * NTHREADS;
    if (idx < nout) {
      const float l = lrun[idx / HD];
      ob[idx] = __float2bfloat16(l > 0.f ? acc[jo] / l : 0.f);
    }
  }
}

template <int HD>
int launch(const void* q, const void* kp, const void* vp, void* o,
           const void* table, const void* lengths, int B, int H, int KH, int P,
           int ps, int maxp, float scale, cudaStream_t stream) {
  const int group = H / KH;
  const size_t smem = static_cast<size_t>(2) * ps * (HD + 8) * sizeof(__nv_bfloat16) +
                      sizeof(float) * (static_cast<size_t>(group) * HD +
                                       static_cast<size_t>(group) * ps + 3 * group);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(KH, B);
  paged_decode_kernel<HD><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<__nv_bfloat16*>(o),
      static_cast<const int*>(table), static_cast<const int*>(lengths), H, P, ps,
      maxp, group, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q / o [B, H, Hd], k_pages / v_pages [KH, P, ps, Hd], all bf16 and
// contiguous; page_table [B, maxp] and lengths [B] int32 on the device.
// Returns the launch's cudaError_t (0 on success).
extern "C" int gaie_paged_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages, void* o,
    const void* page_table, const void* lengths, int B, int H, int KH, int P,
    int ps, int maxp, int Hd, float scale, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || (H / KH) * Hd > NTHREADS * MAX_OUT ||
      ps <= 0 || ps % 8 != 0 || ps > 128 || maxp <= 0 || P <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hd == 128) return launch<128>(q, k_pages, v_pages, o, page_table, lengths, B, H, KH, P, ps, maxp, scale, s);
  if (Hd == 64) return launch<64>(q, k_pages, v_pages, o, page_table, lengths, B, H, KH, P, ps, maxp, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
