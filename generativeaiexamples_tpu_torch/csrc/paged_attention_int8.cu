// Paged attention over the fused int8 KV pool for Hopper (sm_90a): int8
// codes with one f32 scale per (k|v, layer, kv head, token), f32 online
// softmax, bf16 output.
//
// Replaces the Pallas TPU kernel `_int8_kernel` behind
// `paged_attention_int8` in
// generativeaiexamples_tpu/serving/paged_attention_int8.py, in its three
// forms: one query per sequence (q_rep = 1, decode), R consecutive verify
// positions (q_rep = R, linear speculation) and the packed tree of tree
// verify (tree = (k, M), q_rep = 1 + k M).
//
// What it computes (the TPU kernel's contract), for query position j < R
// of row b (node j of the tree):
//   s[h, j, t] = (q[b, j, h] . kcode[t]) * kscale[t]      (q f32, scale folded)
//   out[b, j, h] = sum_t softmax_t(s)[h, j, t] * vscale[t] * vcode[t]
// over the slots t that query may see (tree_mask.cuh): t < len + j, or
// under `tree` the committed prefix plus j's ancestor-or-self chain. The
// pool is the FULL one: codes [2, L, KH, P, ps, Hd] int8 ([0] = k,
// [1] = v) and scales [2, L, KH, P, ps] f32, with the layer indexed
// inside the kernel (a host-side slice kv[:, l] of the kv-leading layout
// is strided). Token t of sequence b lives in page page_table[b, t / ps]
// at offset t % ps. len = max(lengths[b], 1), as the TPU wrapper clamps
// it; the span read is min(len + R - 1, maxp * ps) tokens, and table
// slots at and past ceil(span / ps) are never read. A row whose
// denominator is 0 is divided by 1.
//
// What bounds it on an H100: attention over the cache is far below the
// ridge, so it is bound by reading the pool. A page of one kv head is
// ps * Hd bytes of k codes plus as many of v codes plus 8 ps bytes of
// scales (33 KB at ps = Hd = 128, against 64 KB for bf16 pages), and
// dequantization never widens head_dim: the k scales multiply score
// columns and the v scales fold into the probabilities. The design:
//   - one block per (kv head, batch row); all G = (H / KH) * R query rows
//     of the group share each staged page, so every page is read once
//     however many verify positions there are (the point of q_rep);
//   - pages are staged in shared memory with 16-byte cp.async, double
//     buffered: page p + 1 is in flight while page p is computed;
//   - codes are widened to f32 in registers on CUDA cores;
//   - the query rows, their scores, and their output accumulators live
//     in shared memory ([G][Hd], [G][ps], [G][Hd] f32), so G is bounded
//     by the 227 KB of a block (52 rows at the 8B shape with k = 3,
//     M = 4 take 156 KB) and no register array grows with it;
//   - in P.V each thread owns CPT adjacent head_dim columns of a set of
//     rows, taken RT at a time: one CPT-byte code load serves CPT * RT
//     FMAs and one probability load CPT, instead of a shared-memory load
//     per FMA. CPT is 4 when the rows are many (verify) and drops to 2
//     or 1 when G * Hd / 4 would leave threads idle (decode: G = 4), and
//     RT is 1 when each thread has a single row;
//   - the online softmax runs over pages, one warp per query row.
// Not done yet (later work): splitting the page axis across blocks
// (flash-decoding), which 64 blocks at B = 8 x KH = 8 would need to fill
// 132 SMs, and tensor cores for the many-row verify forms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tree_mask.cuh"

namespace {

using gaie::cp_async16;
using gaie::cp_async_commit;
using gaie::cp_async_wait;
using gaie::verify_keep;

constexpr int NTHREADS = 256;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use
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

// Dynamic shared memory of one block: two page stages, then q [G][HD],
// scores [G][ps], accumulators [G][HD] and alpha / max / sum [G], f32.
template <int HD>
__host__ __device__ inline long long smem_bytes(int ps, int G) {
  return 2LL * stage_bytes(ps, code_stride<HD>()) +
         static_cast<long long>(sizeof(float)) * (2LL * G * HD + 1LL * G * ps + 3LL * G);
}

// CPT consecutive codes (CPT in {1, 2, 4}, aligned) widened to f32.
template <int CPT>
__device__ __forceinline__ void load_codes(const int8_t* p, float* v) {
  if constexpr (CPT == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = code(w, e);
  } else if constexpr (CPT == 2) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(p);
    v[0] = code(w, 0);
    v[1] = code(w, 1);
  } else {
    v[0] = static_cast<float>(*p);
  }
}

// HD: head_dim. CPT: head_dim columns a thread owns in P.V. RT: rows it
// carries in registers at a time there (1 when every row slot has at
// most one row, so no predicated-off rows are issued).
template <int HD, int CPT, int RT>
__global__ void __launch_bounds__(NTHREADS)
paged_int8_kernel(const float* __restrict__ q, const int8_t* __restrict__ kv,
                  const float* __restrict__ scales, __nv_bfloat16* __restrict__ o,
                  const int* __restrict__ page_table, const int* __restrict__ lengths,
                  int H, int L, int KH, int P, int ps, int maxp, int group, int layer,
                  int R, int tree_k) {
  constexpr int CSTR = code_stride<HD>();
  constexpr int TPR = HD / CPT;          // threads per row in P.V (CPT columns each)
  constexpr int RS = NTHREADS / TPR;     // row slots in P.V
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = group * R;               // query rows, j-major: row = j * group + g
  const int sbytes = stage_bytes(ps, CSTR);
  float* qs = reinterpret_cast<float*>(smem + 2 * sbytes);  // [G][HD]
  float* acc = qs + G * HD;                                  // [G][HD]
  float* sc = acc + G * HD;                                  // [G][ps]
  float* alpha = sc + G * ps;                                // [G]
  float* mrun = alpha + G;                                   // [G]
  float* lrun = mrun + G;                                    // [G]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  int len = lengths[b];
  len = len < 1 ? 1 : len;
  const int cap = maxp * ps;
  const int span = len + R - 1 < cap ? len + R - 1 : cap;  // slots the last query sees
  const int npages = (span + ps - 1) / ps;
  const int nout = G * HD;
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

  for (int i = tid; i < nout; i += NTHREADS) {
    const int row = i / HD;
    const int j = row / group;
    const int h = kvh * group + (row - j * group);
    qs[i] = q[((static_cast<long long>(b) * R + j) * H + h) * HD + (i - row * HD)];
    acc[i] = 0.f;
  }
  for (int i = tid; i < G; i += NTHREADS) {
    mrun[i] = NEG_INF;
    lrun[i] = 0.f;
  }

  for (int p = 0; p < npages; ++p) {
    if (p + 1 < npages) load_page((p + 1) & 1, p + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of page p landed
    __syncthreads();     // everyone's did (and qs / acc / state are written)

    const unsigned char* st = smem + (p & 1) * sbytes;
    const int8_t* kcs = reinterpret_cast<const int8_t*>(st);
    const int8_t* vcs = kcs + ps * CSTR;
    const float* kss = reinterpret_cast<const float*>(vcs + ps * CSTR);
    const float* vss = kss + ps;

    // Scores for every (query row, token of the page) the mask keeps.
    for (int i = tid; i < G * ps; i += NTHREADS) {
      const int h = i / ps;
      const int j = i - h * ps;
      float s = NEG_INF;
      if (verify_keep(p * ps + j, len, h / group, R, tree_k)) {
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

    // Online softmax, one warp per query row: the running max and
    // denominator take p, and the P.V weights p * vscale replace the
    // scores (masked tokens weigh 0 whatever their scale holds).
    for (int h = warp; h < G; h += NTHREADS / 32) {
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

    // acc = alpha * acc + (p * vscale) . vcode. Thread (slot rs, columns
    // c .. c + CPT - 1) takes rows rs, rs + RS, ... RT at a time.
    {
      const int c = (tid % TPR) * CPT;
      const int rs = tid / TPR;
      for (int h0 = rs; h0 < G; h0 += RS * RT) {
        float a[RT][CPT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int h = h0 + r * RS;
          const float al = h < G ? alpha[h] : 0.f;
#pragma unroll
          for (int e = 0; e < CPT; ++e) a[r][e] = h < G ? acc[h * HD + c + e] * al : 0.f;
        }
        for (int j = 0; j < ps; ++j) {
          float v[CPT];
          load_codes<CPT>(vcs + j * CSTR + c, v);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const int h = h0 + r * RS;
            if (h < G) {
              const float w = sc[h * ps + j];
#pragma unroll
              for (int e = 0; e < CPT; ++e) a[r][e] = fmaf(w, v[e], a[r][e]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int h = h0 + r * RS;
          if (h < G) {
#pragma unroll
            for (int e = 0; e < CPT; ++e) acc[h * HD + c + e] = a[r][e];
          }
        }
      }
    }
    __syncthreads();  // buffer p & 1, sc and alpha are free for the next page
  }

  for (int i = tid; i < nout; i += NTHREADS) {
    const int row = i / HD;
    const int j = row / group;
    const int h = kvh * group + (row - j * group);
    const float l = lrun[row];
    o[((static_cast<long long>(b) * R + j) * H + h) * HD + (i - row * HD)] =
        __float2bfloat16(acc[i] / (l == 0.f ? 1.f : l));
  }
}

template <int HD, int CPT, int RT>
int launch_v(const void* q, const void* kv, const void* scales, void* o, const void* table,
             const void* lengths, int B, int H, int KH, int L, int P, int ps, int maxp,
             int layer, int R, int tree_k, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(paged_int8_kernel<HD, CPT, RT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(KH, B);
  paged_int8_kernel<HD, CPT, RT><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kv),
      static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(o),
      static_cast<const int*>(table), static_cast<const int*>(lengths), H, L, KH, P, ps, maxp,
      H / KH, layer, R, tree_k);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int CPT>
int launch_cpt(const void* q, const void* kv, const void* scales, void* o, const void* table,
               const void* lengths, int B, int H, int KH, int L, int P, int ps, int maxp,
               int layer, int R, int tree_k, int smem, cudaStream_t stream) {
  const int row_slots = NTHREADS / (HD / CPT);
  if ((H / KH) * R <= row_slots) {
    return launch_v<HD, CPT, 1>(q, kv, scales, o, table, lengths, B, H, KH, L, P, ps, maxp,
                                layer, R, tree_k, smem, stream);
  }
  return launch_v<HD, CPT, 4>(q, kv, scales, o, table, lengths, B, H, KH, L, P, ps, maxp,
                              layer, R, tree_k, smem, stream);
}

template <int HD>
int launch(const void* q, const void* kv, const void* scales, void* o, const void* table,
           const void* lengths, int B, int H, int KH, int L, int P, int ps, int maxp,
           int layer, int R, int tree_k, cudaStream_t stream) {
  const int G = (H / KH) * R;
  const long long smem = smem_bytes<HD>(ps, G);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  // The widest column group that still gives every thread a row in P.V.
  if (G * HD >= 4 * NTHREADS) {
    return launch_cpt<HD, 4>(q, kv, scales, o, table, lengths, B, H, KH, L, P, ps, maxp,
                             layer, R, tree_k, static_cast<int>(smem), stream);
  }
  if (G * HD >= 2 * NTHREADS) {
    return launch_cpt<HD, 2>(q, kv, scales, o, table, lengths, B, H, KH, L, P, ps, maxp,
                             layer, R, tree_k, static_cast<int>(smem), stream);
  }
  return launch_cpt<HD, 1>(q, kv, scales, o, table, lengths, B, H, KH, L, P, ps, maxp, layer,
                           R, tree_k, static_cast<int>(smem), stream);
}

}  // namespace

// q [B, R, H, Hd] f32 (softmax scale folded in; R = q_rep, 1 for decode),
// codes [2, L, KH, P, ps, Hd] int8, scales [2, L, KH, P, ps] f32,
// o [B, R, H, Hd] bf16, all contiguous; page_table [B, maxp] and lengths
// [B] int32 on the device; layer in [0, L). tree_k = tree_m = 0 for
// linear masks, else the (k, M) lattice with q_rep == 1 + k M. Hd in
// {64, 128}, ps a multiple of 16 up to 128, and (H / KH) * q_rep rows
// whose shared-memory staging fits a block. Returns the launch's
// cudaError_t (0 on success).
extern "C" int gaie_paged_attention_int8(const void* q, const void* kv, const void* scales,
                                         void* o, const void* page_table, const void* lengths,
                                         int B, int H, int KH, int L, int P, int ps, int maxp,
                                         int Hd, int layer, int q_rep, int tree_k, int tree_m,
                                         void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || ps <= 0 || ps % 16 != 0 || ps > 128 ||
      maxp <= 0 || P <= 0 || L <= 0 || layer < 0 || layer >= L || q_rep < 1 ||
      tree_k < 0 || (tree_k > 0 && q_rep != 1 + tree_k * tree_m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hd == 128) {
    return launch<128>(q, kv, scales, o, page_table, lengths, B, H, KH, L, P, ps, maxp, layer,
                       q_rep, tree_k, s);
  }
  if (Hd == 64) {
    return launch<64>(q, kv, scales, o, page_table, lengths, B, H, KH, L, P, ps, maxp, layer,
                      q_rep, tree_k, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
