// Paged tree-verify attention over a bf16 page pool for Hopper (sm_90a):
// bf16 in, f32 online softmax, bf16 out.
//
// Replaces the Pallas TPU kernel `_tree_kernel` behind
// `paged_tree_attention` in
// generativeaiexamples_tpu/serving/paged_attention_tree.py.
//
// What it computes (the TPU kernel's contract): tree speculation writes
// r = 1 + k M packed draft nodes at pool slots len - 1 .. len - 2 + r
// (node 0, the root, is the current token; node 1 + m k + (d - 1) is
// branch m's depth-d draft), and node j attends the committed prefix
// (slots < len - 1) plus its ancestor-or-self chain:
//   out[b, h, j] = softmax_t(scale * q[b, h, j] . k[t]) v[t]
// over the slots t that tree_mask.cuh's verify_keep allows, with
// len = max(lengths[b], 1). k / v are one layer's pages [KH, P, ps, Hd];
// token t of row b lives in page page_table[b, t / ps] at offset t % ps.
// Only the span = min(len + r - 1, maxp * ps) slots the deepest node sees
// are read; table slots past it never are. A row whose denominator is 0
// is divided by 1.
//
// What bounds it on an H100: every kv token of the span is read once for
// G = (H / KH) r query rows (52 at the 8B shape with k = 3, M = 4): 4 G Hd
// flops per 4 Hd bytes, about G / 2 = 26 flops a byte, far below the
// 295 flop/byte ridge, so it is bound by reading the pool. The design:
//   - one block per (kv head, batch row), so each page is read from
//     device memory once for all the group's query rows and tree nodes;
//   - chunks of 64 slots are staged in shared memory with 16-byte
//     cp.async, double buffered (chunk c + 1 in flight while c is
//     computed); slots past the span are zero-filled, never read;
//   - both products run on the tensor cores (mma.sync m16n8k16 bf16,
//     f32 accumulate), one warp per 16 query rows, the scores and the
//     output accumulator in registers, as in flash_attention.cu;
//   - the mask is arithmetic in (row, slot), so no table crosses from
//     the host.
// Not done yet (later work): splitting the span across blocks
// (flash-decoding) to fill 132 SMs at small B x KH.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "mma_bf16.cuh"
#include "tree_mask.cuh"

namespace {

using gaie::cp_async16;
using gaie::cp_async_commit;
using gaie::cp_async_wait;
using gaie::mma_16816;
using gaie::pack_bf16;
using gaie::pack_f32;
using gaie::verify_keep;

constexpr int BK = 64;          // kv slots per staged chunk
constexpr int MAX_WARPS = 8;    // 16 query rows each: G <= 128
constexpr float NEG_INF = -1e30f;  // same sentinel as ops/attention.py

template <int D>
__host__ __device__ constexpr int row_stride() {
  return D + 8;  // padded smem row stride (elements): conflict-free fragment reads
}

template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
paged_tree_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k_pages,
                  const __nv_bfloat16* __restrict__ v_pages,
                  __nv_bfloat16* __restrict__ o,
                  const int* __restrict__ page_table,
                  const int* __restrict__ lengths,
                  int H, int KH, int P, int ps, int maxp, int group, int r,
                  int tree_k, float scale) {
  constexpr int STR = row_stride<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // Stage s: K chunk at smem + s * 2 * BK * STR, V chunk right after.

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int t4 = lane & 3;   // thread within the group
  const int G = group * r;   // query rows, j-major: row = j * group + gg
  const int r0 = warp * 16 + g;  // the two query rows this thread owns
  const int r1 = r0 + 8;
  const int j0 = r0 / group, j1 = r1 / group;

  int len = lengths[b];
  len = len < 1 ? 1 : len;
  const int cap = maxp * ps;
  const int span = len + r - 1 < cap ? len + r - 1 : cap;
  const int nchunks = (span + BK - 1) / BK;

  const __nv_bfloat16* kh_k = k_pages + static_cast<long long>(kvh) * P * ps * D;
  const __nv_bfloat16* kh_v = v_pages + static_cast<long long>(kvh) * P * ps * D;

  auto load_chunk = [&](int buf, int k0) {
    __nv_bfloat16* ks = smem + buf * 2 * BK * STR;
    __nv_bfloat16* vs = ks + BK * STR;
    for (int c = tid; c < BK * (D / 8); c += nthreads) {
      const int row = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      const int pos = k0 + row;
      long long off = 0;
      int bytes = 0;  // zero-fill: slots past the span are never read
      if (pos < span) {
        int page = page_table[static_cast<long long>(b) * maxp + pos / ps];
        if (page < 0 || page >= P) page = 0;  // as a clamped TPU gather would
        off = (static_cast<long long>(page) * ps + pos % ps) * D + col;
        bytes = 16;
      }
      cp_async16(ks + row * STR + col, kh_k + off, bytes);
      cp_async16(vs + row * STR + col, kh_v + off, bytes);
    }
  };

  load_chunk(0, 0);
  cp_async_commit();

  // Q fragments stay in registers for the whole kv loop.
  auto q_row = [&](int row) {
    const int j = row / group;
    const int h = kvh * group + (row - j * group);
    return q + ((static_cast<long long>(b) * H + h) * r + j) * D;
  };
  const __nv_bfloat16* q0p = r0 < G ? q_row(r0) : nullptr;
  const __nv_bfloat16* q1p = r1 < G ? q_row(r1) : nullptr;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + t4 * 2;
    qf[kc][0] = q0p ? *reinterpret_cast<const uint32_t*>(q0p + c) : 0u;
    qf[kc][1] = q1p ? *reinterpret_cast<const uint32_t*>(q1p + c) : 0u;
    qf[kc][2] = q0p ? *reinterpret_cast<const uint32_t*>(q0p + c + 8) : 0u;
    qf[kc][3] = q1p ? *reinterpret_cast<const uint32_t*>(q1p + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int ci = 0; ci < nchunks; ++ci) {
    if (ci + 1 < nchunks) load_chunk((ci + 1) & 1, (ci + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of chunk ci landed
    __syncthreads();     // everyone's did

    const int k0 = ci * BK;
    const __nv_bfloat16* ks = smem + (ci & 1) * 2 * BK * STR;
    const __nv_bfloat16* vs = ks + BK * STR;

    // S = Q K^T for this warp's 16 rows x 64 slots (8 n-tiles of 8).
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

    // Mask, scale and take the chunk's row maxima.
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + nt * 8 + t4 * 2 + e;
        const bool ok0 = kp < span && verify_keep(kp, len, j0, r, tree_k);
        const bool ok1 = kp < span && verify_keep(kp, len, j1, r, tree_k);
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

    // O += P V: the score accumulators are the A operand (slots
    // [16 kk, 16 kk + 16) are n-tiles 2 kk and 2 kk + 1).
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
    __syncthreads();  // buffer ci & 1 is free for chunk ci + 2
  }

  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  __nv_bfloat16* o0 = r0 < G ? o + (q0p - q) : nullptr;
  __nv_bfloat16* o1 = r1 < G ? o + (q1p - q) : nullptr;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (o0) {
      *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    }
    if (o1) {
      *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, const void* table,
           const void* lengths, int B, int H, int KH, int P, int ps, int maxp, int r,
           int tree_k, float scale, cudaStream_t stream) {
  const int group = H / KH;
  const int warps = (group * r + 15) / 16;
  if (warps > MAX_WARPS) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * 2 * BK * row_stride<D>() * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(paged_tree_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(KH, B);
  paged_tree_kernel<D><<<grid, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<const int*>(table), static_cast<const int*>(lengths), H, KH, P, ps, maxp,
      group, r, tree_k, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, r, Hd] bf16 (r = 1 + tree_k * tree_m packed nodes), k_pages /
// v_pages [KH, P, ps, Hd] bf16 (one layer's slice), o [B, H, r, Hd] bf16,
// all contiguous; page_table [B, maxp] and lengths [B] int32 on the
// device. Hd in {64, 128}, tree_k >= 1, tree_m >= 1, (H / KH) * r <= 128.
// Returns the launch's cudaError_t (0 on success).
extern "C" int gaie_paged_tree_attention_bf16(const void* q, const void* k_pages,
                                              const void* v_pages, void* o,
                                              const void* page_table, const void* lengths, int B,
                                              int H, int KH, int P, int ps, int maxp, int Hd,
                                              int tree_k, int tree_m, float scale,
                                              void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || P <= 0 || ps <= 0 || maxp <= 0 || tree_k < 1 ||
      tree_m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int r = 1 + tree_k * tree_m;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hd == 128) {
    return launch<128>(q, k_pages, v_pages, o, page_table, lengths, B, H, KH, P, ps, maxp, r,
                       tree_k, scale, s);
  }
  if (Hd == 64) {
    return launch<64>(q, k_pages, v_pages, o, page_table, lengths, B, H, KH, P, ps, maxp, r,
                      tree_k, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
