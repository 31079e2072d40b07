// Paged attention over the fused int8 KV pool for Hopper (sm_90a): int8
// codes with one f32 scale per (k|v, layer, kv head, token), bf16 query,
// f32 online softmax, bf16 output.
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
//   s[h, j, t] = (q[b, j, h] . kcode[t]) * kscale[t] * scale
//   out[b, j, h] = sum_t softmax_t(s)[h, j, t] * vscale[t] * vcode[t]
// over the slots t that query may see (tree_mask.cuh): t < len + j, or
// under `tree` the committed prefix plus j's ancestor-or-self chain. The
// pool is the FULL one: codes [2, L, KH, P, ps, Hd] int8 ([0] = k,
// [1] = v) and scales [2, L, KH, P, ps] f32, with the layer indexed
// inside the kernel. Token t of sequence b lives in page
// page_table[b, t / ps] at offset t % ps. len = max(lengths[b], 1), as
// the TPU wrapper clamps it; the span read is min(len + R - 1, maxp * ps)
// tokens, and table slots at and past ceil(span / ps) are never read.
//
// What bounds it on an H100: attention over the cache is far below the
// ridge, so it is bound by reading the pool: a page of one kv head is
// 2 ps Hd bytes of codes plus 8 ps bytes of scales (33 KB at ps = Hd =
// 128). The design:
//   - both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate). The G = (H / KH) R query rows of a kv head are the
//     M dimension, in 16-row tiles (G = 4 at decode, 52 for the (3, 4)
//     tree at the 8B shape): mma.sync's 16-row tile pads decode 4x where
//     a 64-row wgmma would pad it 16x, and decode is bound by bytes, not
//     by the tensor cores. The bf16 query is used as it is: int8 codes
//     are exact in bf16, so q . code is exact up to the f32 accumulation
//     order, and the softmax scale and kscale multiply the score columns
//     (no f32 copy of q, no extra launch);
//   - the codes are widened to bf16 in registers, from ldmatrix
//     fragments of the staged bytes (widen2: a byte permute and an f32
//     subtract per code, exact); K's fragments are read as byte quads, so
//     each k16 step of Q K^T takes head_dim columns 4 t .. 4 t + 3 in a
//     permuted order that the staged q rows repeat; V's are read
//     transposed as byte pairs, which puts head_dim columns 2 i and
//     2 i + 1 on two n-tiles that the epilogue interleaves again. vscale
//     multiplies P's columns, and P . V takes P as hi + lo bf16 (two
//     MMAs on the same widened V fragment): P as one bf16 roughly
//     doubled the kernel's error against the plain version, most of the
//     way to the 1e-2 tolerance of a row's max |out|;
//   - one producer warp stages pages by TMA (a 3-D map over the codes,
//     [planes][ps][Hd] with the 128-byte swizzle, 64-byte at Hd = 64, the
//     page id from page_table) and bulk copies of the two scale rows, in a
//     ring of 2-8 stages (~100 KB) with full / empty mbarriers: no
//     block-wide barrier per page;
//   - consumer warps are (row tile, key slice) pairs, at most 8: a warp
//     keeps its 16 rows' accumulators and online-softmax state (m, l) in
//     registers over its slice of every page, 32 keys a step (16 where a
//     slice is narrower). Key slices of one row tile are merged at the
//     end in slice order through shared memory. Each row tile widens the
//     page's codes again: widening, not the MMAs, is most of a warp's
//     instructions, so the (3, 4) tree's four tiles are its cost. (A
//     warp carrying two tiles, one widening for both, needs twice the
//     accumulators and so 16-key steps; it was not faster.) The plan
//     (key slices, pages per split) was chosen by measurement
//     (chip_smoke.py --variants);
//   - flash-decoding: when B x KH CTAs leave the card idle (64 at B = 8),
//     the page axis is split into chunks of `pages_per_split` pages (the
//     wrapper's plan, grid z). A split whose chunk starts past the row's
//     pages exits at once. Each split writes its (m, l, acc) to a
//     workspace; the last split to arrive for a (row, kv head) (an
//     atomic ticket it resets itself) merges them in split order, so the
//     result is the same bits on every run.
// Masked slots weigh exactly 0 whatever their scale or code holds. A
// row whose denominator is 0 is divided by 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"
#include "partials.cuh"
#include "tree_mask.cuh"

namespace {

using namespace gaie::hopper;
using gaie::ldmatrix_x2;
using gaie::ldmatrix_x4;
using gaie::ldmatrix_x4_trans;
using gaie::merge_partial;
using gaie::mma_16816;
using gaie::pack_f32;
using gaie::split_bf16x2;
using gaie::store_partial;
using gaie::verify_keep;
using gaie::widen2;

constexpr int MAX_WARPS = 8;          // consumer warps (row tiles x key slices)
constexpr int MAX_SMEM = 232448;      // bytes of shared memory a block may use
constexpr int RING_BUDGET = 104 * 1024;
constexpr float NEG_INF = -1e30f;     // same sentinel as the JAX package
constexpr uint32_t FLIP = 0x80808080u;  // codes -> codes + 128, per byte

template <int HD>
struct Shape {
  static constexpr int NACC = HD / 2;       // accumulator floats a thread (HD / 8 n-tiles)
  static constexpr int REC = NACC + 4;      // a thread's partial: acc, then m, l of rows g, g + 8
  static constexpr int QSTR = HD * 2 + 16;  // bytes per staged q row (ldmatrix conflict-free)
  static constexpr int SWZ = HD == 128 ? 7 : 3;  // TMA 128- / 64-byte swizzle
};

// Byte offset of 16-byte chunk c of code row r in a TMA-swizzled tile
// of HD-byte rows (1024-byte aligned).
template <int HD>
__device__ __forceinline__ uint32_t code_off(int r, int c) {
  const uint32_t o = static_cast<uint32_t>(r * HD + 16 * c);
  return o ^ (((o >> 7) & Shape<HD>::SWZ) << 4);
}

// HD: head_dim. NC: keys a consumer warp takes per step (32, or 16 when
// its slice of a page is an odd number of 16-key groups).
template <int HD, int NC>
__global__ void __launch_bounds__(32 * (MAX_WARPS + 1), 1)
paged_int8_kernel(const __grid_constant__ CUtensorMap tmap, const __nv_bfloat16* __restrict__ q,
                  const float* __restrict__ scales, __nv_bfloat16* __restrict__ o,
                  const int* __restrict__ page_table, const int* __restrict__ lengths,
                  float* __restrict__ ws, int* __restrict__ tickets, int H, int L, int KH, int P,
                  int ps, int maxp, int group, int layer, int R, int tree_k, int KS, int pps,
                  int stages, int stage_bytes, int q_off, int bar_off, float scale_log2) {
  using Sh = Shape<HD>;
  constexpr int REC = Sh::REC * 32;  // floats of one row tile's partial
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int G = group * R;  // query rows, j-major: row = j * group + g
  const int RT = (G + 15) / 16;
  const int NW = RT * KS;  // consumer warps; the producer is warp NW
  int len = lengths[b];
  len = len < 1 ? 1 : len;
  const int cap = maxp * ps;
  const int span = len + R - 1 < cap ? len + R - 1 : cap;  // slots the last query sees
  const int npages = (span + ps - 1) / ps;
  const int nsplit = (npages + pps - 1) / pps;  // splits that hold pages of this row
  if (sp >= nsplit) return;
  const int p0 = sp * pps;
  const int np = (npages < p0 + pps ? npages : p0 + pps) - p0;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + bar_off);
  uint64_t* empty = full + stages;
  int* last_flag = reinterpret_cast<int*>(empty + stages);
  unsigned char* qs = smem + q_off;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NW);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int code_bytes = ps * HD;
  if (warp == NW) {
    // Producer: one thread stages every page of this split (k codes, v
    // codes, k scales, v scales).
    if (lane == 0) {
      const long long plane = static_cast<long long>(L) * KH * P;  // pages per k|v plane
      for (int i = 0; i < np; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) + 1) & 1);
        int page = page_table[static_cast<long long>(b) * maxp + p0 + i];
        if (page < 0 || page >= P) page = 0;  // as a clamped TPU gather would
        const long long kplane = (static_cast<long long>(layer) * KH + kvh) * P + page;
        unsigned char* st = smem + s * stage_bytes;
        mbar_arrive_expect_tx(&full[s], 2 * code_bytes + 8 * ps);
        tma_load_3d(st, &tmap, &full[s], 0, 0, static_cast<int>(kplane));
        tma_load_3d(st + code_bytes, &tmap, &full[s], 0, 0, static_cast<int>(kplane + plane));
        bulk_load(st + 2 * code_bytes, scales + kplane * ps, 4 * ps, &full[s]);
        bulk_load(st + 2 * code_bytes + 4 * ps, scales + (kplane + plane) * ps, 4 * ps,
                  &full[s]);
      }
    }
    return;
  }

  const int nthr = NW * 32;
  // Stage the q rows in bf16, each 16-column block permuted for the K
  // fragments' order: head_dim 4 t + {0, 1} at positions 2 t + {0, 1},
  // 4 t + {2, 3} at positions 8 + 2 t + {0, 1}. Rows past G are zeros.
  for (int i = threadIdx.x; i < RT * 16 * (HD / 4); i += nthr) {
    const int row = i / (HD / 4);
    const int quad = i % (HD / 4);
    uint2 v = make_uint2(0u, 0u);
    if (row < G) {
      const int j = row / group;
      const int h = kvh * group + (row - j * group);
      v = *reinterpret_cast<const uint2*>(
          q + ((static_cast<long long>(b) * R + j) * H + h) * HD + 4 * quad);
    }
    unsigned char* rp = qs + row * Sh::QSTR + (quad / 4) * 32 + 4 * (quad % 4);
    *reinterpret_cast<uint32_t*>(rp) = v.x;
    *reinterpret_cast<uint32_t*>(rp + 16) = v.y;
  }
  named_sync(1, nthr);

  const int rt = warp / KS;
  const int ks = warp % KS;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int lrow = lane & 7;   // ldmatrix: the row this lane addresses
  const int lmat = lane >> 3;  // and its matrix
  const int kpw = ps / KS;     // keys of each page in this warp's slice
  const int rowA = rt * 16 + g;  // the two query rows this thread owns
  const int rowB = rowA + 8;
  const int jA = rowA / group;
  const int jB = rowB / group;
  const unsigned char* qa = qs + (rt * 16 + lrow + 8 * (lmat & 1)) * Sh::QSTR + 16 * (lmat >> 1);

  float acc[Sh::NACC];
#pragma unroll
  for (int i = 0; i < Sh::NACC; ++i) acc[i] = 0.f;
  float mA = NEG_INF, mB = NEG_INF, lA = 0.f, lB = 0.f;

  for (int i = 0; i < np; ++i) {
    const int s = i % stages;
    const int pos0 = (p0 + i) * ps;
    const unsigned char* kst = smem + s * stage_bytes;
    const unsigned char* vst = kst + code_bytes;
    const float* kss = reinterpret_cast<const float*>(kst + 2 * code_bytes);
    const float* vss = kss + ps;
    mbar_wait(&full[s], (i / stages) & 1);

    for (int c0 = ks * kpw; c0 < (ks + 1) * kpw && pos0 + c0 < span; c0 += NC) {
      // S = Q K^T over keys c0 .. c0 + NC - 1 of the page.
      float sc[NC / 8][4];
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qa + kk * 32);
        uint32_t kr[NC / 8];
        if constexpr (NC == 32) {
          ldmatrix_x4(kr, kst + code_off<HD>(c0 + 8 * lmat + lrow, kk));
        } else {
          ldmatrix_x2(kr, kst + code_off<HD>(c0 + 8 * (lmat & 1) + lrow, kk));
        }
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const uint32_t u = kr[j] ^ FLIP;  // key 8 j + g, head_dim 16 kk + 4 t4 .. + 3
          const uint32_t bf[2] = {widen2(u, 0, 1), widen2(u, 2, 3)};
          mma_16816(sc[j], a, bf);
        }
      }

      // Scale each key's column by scale * kscale (log2 units), mask what
      // the query may not see (only steps that reach slot len or past),
      // update the running max and denominators, and form P as hi + lo
      // bf16 A fragments of p * vscale (a masked slot weighs exactly 0).
      // Keys [16 kk, 16 kk + 16) of the step are score n-tiles 2 kk and
      // 2 kk + 1.
      const bool need_mask = pos0 + c0 + NC > len;
      uint32_t ph[NC / 16][4], pl[NC / 16][4];
      float mxA = NEG_INF, mxB = NEG_INF;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int kc = c0 + 8 * j + 2 * t4;
        const float2 ksc = *reinterpret_cast<const float2*>(kss + kc);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float f = scale_log2 * (e ? ksc.y : ksc.x);
          float sa = sc[j][e] * f;
          float sb = sc[j][2 + e] * f;
          if (need_mask) {
            const int pos = pos0 + kc + e;
            if (!verify_keep(pos, len, jA, R, tree_k)) sa = NEG_INF;
            if (!verify_keep(pos, len, jB, R, tree_k)) sb = NEG_INF;
          }
          sc[j][e] = sa;
          sc[j][2 + e] = sb;
          mxA = fmaxf(mxA, sa);
          mxB = fmaxf(mxB, sb);
        }
      }
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 1));
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 2));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 1));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 2));
      const float mnA = fmaxf(mA, mxA);
      const float mnB = fmaxf(mB, mxB);
      float sA = 0.f, sB = 0.f;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const float2 vsc = *reinterpret_cast<const float2*>(vss + c0 + 8 * j + 2 * t4);
        float p[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = sc[j][e] > 0.5f * NEG_INF ? exp2f(sc[j][e] - mnA) : 0.f;
          p[2 + e] = sc[j][2 + e] > 0.5f * NEG_INF ? exp2f(sc[j][2 + e] - mnB) : 0.f;
        }
        sA += p[0] + p[1];
        sB += p[2] + p[3];
        const int f = 2 * (j % 2);
        split_bf16x2(p[0] * vsc.x, p[1] * vsc.y, ph[j / 2][f], pl[j / 2][f]);
        split_bf16x2(p[2] * vsc.x, p[3] * vsc.y, ph[j / 2][f + 1], pl[j / 2][f + 1]);
      }
      sA += __shfl_xor_sync(0xffffffffu, sA, 1);
      sA += __shfl_xor_sync(0xffffffffu, sA, 2);
      sB += __shfl_xor_sync(0xffffffffu, sB, 1);
      sB += __shfl_xor_sync(0xffffffffu, sB, 2);
      const float aA = exp2f(mA - mnA);
      const float aB = exp2f(mB - mnB);
      lA = lA * aA + sA;
      lB = lB * aB + sB;
      mA = mnA;
      mB = mnB;
      if (__any_sync(0xffffffffu, aA != 1.f || aB != 1.f)) {  // the max moved
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          acc[4 * n] *= aA;
          acc[4 * n + 1] *= aA;
          acc[4 * n + 2] *= aB;
          acc[4 * n + 3] *= aB;
        }
      }

      // O += P V. A transposed x4 load of keys kb .. kb + 15 and 16-byte
      // chunks c, c + 1 gives, per chunk, byte quads (keys 2 t4, 2 t4 + 1)
      // x (head_dim 2 g, 2 g + 1): bytes {0, 2} feed the n-tile of column
      // 16 c + 2 g, bytes {1, 3} that of 16 c + 2 g + 1.
#pragma unroll
      for (int kk = 0; kk < NC / 16; ++kk) {
        const int kb = c0 + 16 * kk;
#pragma unroll
        for (int c = 0; c < HD / 16; c += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vst + code_off<HD>(kb + 8 * (lmat & 1) + lrow, c + (lmat >> 1)));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const uint32_t u0 = r[2 * hh] ^ FLIP;
            const uint32_t u1 = r[2 * hh + 1] ^ FLIP;
            const uint32_t be[2] = {widen2(u0, 0, 2), widen2(u1, 0, 2)};
            const uint32_t bo[2] = {widen2(u0, 1, 3), widen2(u1, 1, 3)};
            float* ae = acc + 8 * (c + hh);
            mma_16816(ae, ph[kk], be);
            mma_16816(ae, pl[kk], be);
            mma_16816(ae + 4, ph[kk], bo);
            mma_16816(ae + 4, pl[kk], bo);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // Key slices of a row tile fold into slice 0 in slice order, through
  // shared memory that held the ring (every page has been consumed).
  if (KS > 1) {
    float* recs = reinterpret_cast<float*>(smem);
    named_sync(1, nthr);
    if (ks > 0) {
      store_partial<HD>(recs + (rt * (KS - 1) + ks - 1) * REC, acc, mA, lA, mB, lB, lane);
    }
    named_sync(1, nthr);
    if (ks == 0) {
      for (int k2 = 1; k2 < KS; ++k2) {
        merge_partial<HD, false>(acc, mA, lA, mB, lB, recs + (rt * (KS - 1) + k2 - 1) * REC,
                                 lane);
      }
    }
  }

  if (nsplit > 1) {
    // This split's partial to the workspace [B, KH, splits, RT][REC];
    // the last split to arrive merges all of them in split order.
    float* wsb = ws + (static_cast<long long>(b) * KH + kvh) * gridDim.z * RT * REC;
    if (ks == 0) {
      store_partial<HD>(wsb + (static_cast<long long>(sp) * RT + rt) * REC, acc, mA, lA, mB,
                        lB, lane);
    }
    __threadfence();
    named_sync(1, nthr);
    if (threadIdx.x == 0) {
      int* ticket = tickets + b * KH + kvh;
      const int last = atomicAdd(ticket, 1) == nsplit - 1;
      if (last) *ticket = 0;  // every split has arrived: ready for the next launch
      *last_flag = last;
    }
    named_sync(1, nthr);
    if (!*last_flag) return;
    __threadfence();
    if (ks == 0) {
      mA = mB = NEG_INF;
      lA = lB = 0.f;
#pragma unroll
      for (int i = 0; i < Sh::NACC; ++i) acc[i] = 0.f;
      for (int s2 = 0; s2 < nsplit; ++s2) {
        merge_partial<HD, true>(acc, mA, lA, mB, lB,
                                wsb + (static_cast<long long>(s2) * RT + rt) * REC, lane);
      }
    }
  }
  if (ks != 0) return;

  // Row g: head_dim 16 c + 4 t4 + {0, 1, 2, 3} are n-tiles (2 c, 2 c + 1)
  // columns (2 t4, 2 t4 + 1) interleaved; row g + 8 likewise.
#pragma unroll
  for (int hb = 0; hb < 2; ++hb) {
    const int row = hb ? rowB : rowA;
    if (row >= G) continue;
    const float l = hb ? lB : lA;
    const float inv = l == 0.f ? 1.f : 1.f / l;
    const int j = row / group;
    const int h = kvh * group + (row - j * group);
    __nv_bfloat16* op = o + ((static_cast<long long>(b) * R + j) * H + h) * HD + 4 * t4;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const float* ev = acc + 8 * c + 2 * hb;
      const float* od = ev + 4;
      *reinterpret_cast<uint2*>(op + 16 * c) =
          make_uint2(pack_f32(ev[0] * inv, od[0] * inv), pack_f32(ev[1] * inv, od[1] * inv));
    }
  }
}

struct Layout {
  int stages, stage_bytes, q_off, bar_off, smem;
};

// RT: 16-row tiles staged; merge: the key slices' partials that fold
// through shared memory.
template <int HD>
Layout layout(int ps, int RT, int KS) {
  Layout t;
  t.stage_bytes = (2 * ps * HD + 8 * ps + 1023) / 1024 * 1024;
  t.stages = RING_BUDGET / t.stage_bytes;
  t.stages = t.stages < 2 ? 2 : (t.stages > 8 ? 8 : t.stages);
  const int ring = t.stages * t.stage_bytes;
  const int merge = RT * (KS - 1) * Shape<HD>::REC * 32 * 4;
  t.q_off = ring > merge ? ring : merge;
  t.bar_off = t.q_off + RT * 16 * Shape<HD>::QSTR;
  t.smem = t.bar_off + 2 * t.stages * 8 + 16 + 1024;  // barriers, flag, alignment slack
  return t;
}

template <int HD, int NC>
int launch(const void* q, const void* kv, const void* scales, void* o, const void* table,
           const void* lengths, void* ws, void* tickets, int B, int H, int KH, int L, int P,
           int ps, int maxp, int layer, int R, int tree_k, int KS, int pps, float scale,
           cudaStream_t stream) {
  const int RT = ((H / KH) * R + 15) / 16;
  const Layout t = layout<HD>(ps, RT, KS);
  if (t.smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  // The codes as [2 L KH P planes][ps][HD] bytes; a box is one page.
  CUtensorMap tmap;
  const uint64_t dims[3] = {static_cast<uint64_t>(HD), static_cast<uint64_t>(ps),
                            static_cast<uint64_t>(2) * L * KH * P};
  const uint64_t strides[2] = {static_cast<uint64_t>(HD), static_cast<uint64_t>(ps) * HD};
  const uint32_t box[3] = {static_cast<uint32_t>(HD), static_cast<uint32_t>(ps), 1};
  if (!encode_tiled(&tmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, kv, dims, strides, box,
                    HD == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = paged_int8_kernel<HD, NC>;
  static const cudaError_t opted =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const int splits = (maxp + pps - 1) / pps;
  dim3 grid(KH, B, splits);
  kernel<<<grid, 32 * (RT * KS + 1), t.smem, stream>>>(
      tmap, static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(scales),
      static_cast<__nv_bfloat16*>(o), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<float*>(ws), static_cast<int*>(tickets), H,
      L, KH, P, ps, maxp, H / KH, layer, R, tree_k, KS, pps, t.stages, t.stage_bytes, t.q_off,
      t.bar_off, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, R, H, Hd] bf16 (R = q_rep, 1 for decode), codes [2, L, KH, P, ps,
// Hd] int8, scales [2, L, KH, P, ps] f32, o [B, R, H, Hd] bf16, all
// contiguous and 16-byte aligned; page_table [B, maxp] and lengths [B]
// int32 on the device; layer in [0, L). tree_k = tree_m = 0 for linear
// masks, else the (k, M) lattice with q_rep == 1 + k M. Hd in {64, 128},
// ps a multiple of 16 up to 128. The plan (the wrapper's
// paged_int8_plan): key_slices consumer warps per 16-row tile of the
// (H / KH) q_rep query rows (row tiles x key_slices <= 8, ps /
// key_slices a multiple of 16; 32 keys a step where it is a multiple of
// 32) and pages_per_split; with more than one split (ceil(maxp /
// pages_per_split)), ws holds B KH splits row-tiles x (Hd / 2 + 4) x 32
// f32 and tickets B KH int32 zeros, which every launch leaves zero.
// Returns the launch's cudaError_t (0 on success).
extern "C" int gaie_paged_attention_int8(const void* q, const void* kv, const void* scales,
                                         void* o, const void* page_table, const void* lengths,
                                         void* ws, void* tickets, int B, int H, int KH, int L,
                                         int P, int ps, int maxp, int Hd, int layer, int q_rep,
                                         int tree_k, int tree_m, int key_slices,
                                         int pages_per_split, float scale, void* stream) {
  if (B <= 0 || B > 65535 || KH <= 0 || H % KH != 0 || ps <= 0 || ps % 16 != 0 || ps > 128 ||
      maxp <= 0 || P <= 0 || L <= 0 || layer < 0 || layer >= L || q_rep < 1 || tree_k < 0 ||
      (tree_k > 0 && q_rep != 1 + tree_k * tree_m) || 2LL * L * KH * P >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int KS = key_slices;
  const int RT = ((H / KH) * q_rep + 15) / 16;
  if (KS < 1 || RT * KS > MAX_WARPS || ps % KS != 0 ||
      (ps / KS) % 16 != 0 || pages_per_split < 1 ||
      (maxp + pages_per_split - 1) / pages_per_split > 65535 ||
      (pages_per_split < maxp && (ws == nullptr || tickets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = (ps / KS) % 32 == 0;
#define GAIE_K4_LAUNCH(HD, NC)                                                                \
  launch<HD, NC>(q, kv, scales, o, page_table, lengths, ws, tickets, B, H, KH, L, P, ps, maxp, \
                 layer, q_rep, tree_k, KS, pages_per_split, scale, s)
  if (Hd == 128) return wide ? GAIE_K4_LAUNCH(128, 32) : GAIE_K4_LAUNCH(128, 16);
  if (Hd == 64) return wide ? GAIE_K4_LAUNCH(64, 32) : GAIE_K4_LAUNCH(64, 16);
#undef GAIE_K4_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
