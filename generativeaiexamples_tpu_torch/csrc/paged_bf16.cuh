// Paged attention over a bf16 page pool for Hopper (sm_90a): the body
// that K2 (paged_attention.cu, one query per sequence) and K5
// (paged_attention_tree.cu, the packed verify tree) share. bf16 q and
// pages, f32 online softmax, bf16 output.
//
// What it computes, for query position j < R of row b (R = 1 for K2; the
// node j of the tree for K5):
//   out[b, h, j] = softmax_t(scale * q[b, h, j] . k[t]) v[t]
// over the slots t that tree_mask.cuh's verify_keep(t, len, j, R, tree_k)
// allows, with k / v one layer's pages [KH, P, ps, Hd] and token t of row
// b in page page_table[b, t / ps] at offset t % ps. len = lengths[b],
// clamped to >= min_len (K5 clamps to 1, K2 takes 0 as it is); the span
// read is min(len + R - 1, maxp * ps) slots, and nothing past it is read
// (the sink page and the tail slots of the table may hold NaN). A row
// whose denominator is 0 (K2 at length 0) is divided by 1, giving zeros.
//
// What bounds it on an H100: every kv slot of the span is read once for
// the G = (H / KH) R query rows of its kv head, 4 G Hd flops per 4 Hd
// bytes: G flops a byte (4 for decode, 52 for the (3, 4) tree), far below
// the ~295 flop/byte ridge. It is bound by reading the pool. The design:
//   - the page axis is split across CTAs (grid z, flash-decoding) when
//     B x KH CTAs would leave the card idle: `pages_per_split` table
//     slots a split (the wrapper's paged_bf16_plan). A split that starts
//     past its row's span exits at once. Each split writes its (m, l,
//     acc) to a workspace; the last split to arrive for a (row, kv head)
//     (an atomic ticket it resets itself) merges them in a fixed order
//     (each key-slice warp a strided share of the splits, then the
//     slices in order), so repeats give the same bits and nothing is
//     reset on the host;
//   - one producer warp stages K and V by TMA into a ring of full / empty
//     mbarriers, `ring_stages` deep. A stage holds `stage_keys`
//     consecutive slots of the split (32 KB of K and V at Hd = 128),
//     loaded as boxes of
//     gcd(ps, stage_keys) rows x 64 columns with the 128-byte swizzle (a
//     256-byte Hd = 128 row is two boxes): a box never crosses a page, so
//     any page size that is a multiple of 8 works, a stage may hold
//     several small pages, and a page larger than a stage fills several.
//     Lane i of the producer takes box i of every stage, its page id read
//     from page_table one stage ahead. Boxes that start past the span are
//     not loaded. No block-wide barrier per page;
//   - consumer warps are (16-row tile, key slice) pairs, at most 8. Each
//     runs mma.sync m16n8k16 (bf16 in, f32 accumulate) on its slice of
//     every stage: Q K^T with the query's A fragments by ldmatrix from
//     the staged q rows and K's B fragments by ldmatrix straight from the
//     swizzled stage; P V with V's B fragments by transposed ldmatrix. P
//     goes in as hi + lo bf16 (two MMAs on one V fragment), which keeps
//     the error of the f32 P; P as one bf16 roughly doubled it in the
//     int8 kernel (paged_attention_int8.cu). Accumulators and (m, l) stay
//     in registers over the slice; key slices of a tile are merged in
//     slice order through shared memory at the end. 16-row tiles pad
//     decode's 4 rows 4x where a 64-row wgmma would pad them 16x, and
//     decode is bound by bytes, not by the tensor cores;
//   - the mask is arithmetic (verify_keep), so no table crosses from the
//     host. In the last step of a split, V columns past the split's end
//     are zeroed in registers: their P is 0, but the staged bytes there
//     were never loaded, and 0 x NaN would be NaN.
// Editing this header rebuilds every library (kernels.library_path hashes
// the csrc/*.cuh headers).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"
#include "partials.cuh"
#include "tree_mask.cuh"

namespace gaie {
namespace paged_bf16 {

using namespace gaie::hopper;

constexpr int MAX_WARPS = 8;          // consumer warps (row tiles x key slices)
constexpr int MAX_SMEM = 232448;      // bytes of shared memory a block may use
constexpr float NEG_INF = -1e30f;     // same sentinel as the JAX package

template <int HD>
struct Shape {
  static constexpr int NACC = HD / 2;       // accumulator floats a thread (HD / 8 n-tiles)
  static constexpr int REC = NACC + 4;      // a thread's partial: acc, then m, l of rows g, g + 8
  static constexpr int QSTR = HD * 2 + 16;  // bytes per staged q row (ldmatrix conflict-free)
};

// What a launch reads and how (element strides of q and o: row b, head
// h, query position j).
struct Args {
  const __nv_bfloat16* q;
  __nv_bfloat16* o;
  const int* page_table;
  const int* lengths;
  float* ws;
  int* tickets;
  long long q_sb;
  int q_sh, q_sj;
  int H, KH, P, ps, maxp, group, R, tree_k, min_len;
  int KS, SK, BR, pps;  // key slices, keys a stage, rows a TMA box, pages a split
  int stages, stage_bytes, q_off, bar_off;  // the ring and the shared-memory layout
  float scale_log2;
};

// Byte offset of 16-byte chunk c (head_dim columns 8 c .. 8 c + 7) of
// row r of a stage tile of sk rows: a row's columns are HD / 64 boxes of
// 128 bytes, box c / 8 at c / 8 * sk * 128, each 128-byte swizzled.
__device__ __forceinline__ uint32_t kv_off(int sk, int r, int c) {
  return static_cast<uint32_t>((c >> 3) * sk * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// The kernel body. HD: head_dim. NC: keys a consumer warp takes per step
// (32, or 16 when its slice of a stage is an odd number of 16-key
// groups). Each source wraps it in a __global__ of its own name
// (GAIE_PAGED_BF16_KERNEL), so a profile tells K2 from K5.
template <int HD, int NC>
__device__ __forceinline__ void body(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                     const Args& a) {
  using Sh = Shape<HD>;
  constexpr int REC = Sh::REC * 32;  // floats of one row tile's partial
  constexpr int HALVES = HD / 64;    // 128-byte boxes a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int G = a.group * a.R;  // query rows, j-major: row = j * group + g
  const int RT = (G + 15) / 16;
  const int NW = RT * a.KS;  // consumer warps; the producer is warp NW
  int len = a.lengths[b];
  len = len < a.min_len ? a.min_len : len;
  const int cap = a.maxp * a.ps;
  int span = len + a.R - 1 < cap ? len + a.R - 1 : cap;  // slots the last query sees
  span = span < 0 ? 0 : span;
  const int npages = (span + a.ps - 1) / a.ps;
  int nsplit = (npages + a.pps - 1) / a.pps;  // splits that hold slots of this row
  nsplit = nsplit < 1 ? 1 : nsplit;           // an empty row still writes its zeros
  if (sp >= nsplit) return;
  const int s0 = sp * a.pps * a.ps;  // the split's first slot
  const int e = span < s0 + a.pps * a.ps ? span : s0 + a.pps * a.ps;  // one past its last
  const int nst = e > s0 ? (e - s0 + a.SK - 1) / a.SK : 0;             // ring stages it fills

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.bar_off);
  uint64_t* empty = full + a.stages;
  int* last_flag = reinterpret_cast<int*>(empty + a.stages);
  unsigned char* qs = smem + a.q_off;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int SK = a.SK;
  // The producer (warp NW): lane i stages box i (BR slots, every column
  // block, K and V) of each stage. Its first page id is read before the
  // block's barrier, the next stage's before waiting for a ring slot.
  const int nbox = SK / a.BR;
  const int* row_table = a.page_table + static_cast<long long>(b) * a.maxp;
  auto page_of = [&](int t) {
    int page = row_table[t / a.ps];
    return page < 0 || page >= a.P ? 0 : page;  // as a clamped TPU gather would
  };
  int t = s0 + lane * a.BR;  // this lane's box in stage 0
  int page = warp == NW && lane < nbox && t < e ? page_of(t) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NW);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  // Stage the q rows (bf16, as they are); rows past G are zeros.
  for (int i = threadIdx.x; i < RT * 16 * (HD / 8); i += blockDim.x) {
    const int row = i / (HD / 8);
    const int ch = i % (HD / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < G) {
      const int j = row / a.group;
      const int h = kvh * a.group + (row - j * a.group);
      v = *reinterpret_cast<const uint4*>(a.q + b * a.q_sb + static_cast<long long>(h) * a.q_sh +
                                          static_cast<long long>(j) * a.q_sj + 8 * ch);
    }
    *reinterpret_cast<uint4*>(qs + row * Sh::QSTR + 16 * ch) = v;
  }
  __syncthreads();

  if (warp == NW) {
    for (int i = 0; i < nst; ++i) {
      const int s = i % a.stages;
      const int tn = t + SK;
      const int next = lane < nbox && tn < e ? page_of(tn) : 0;
      if (i >= a.stages) mbar_wait(&empty[s], ((i / a.stages) + 1) & 1);
      const int left = e - (s0 + i * SK);  // slots of the split from this stage on
      const int nload = (left < SK ? left + a.BR - 1 : SK) / a.BR;
      if (lane == 0) mbar_arrive_expect_tx(&full[s], nload * a.BR * HD * 4);
      __syncwarp();
      if (lane < nload) {
        unsigned char* st = smem + s * a.stage_bytes + lane * a.BR * 128;
        const int plane = kvh * a.P + page;
        const int row = t % a.ps;
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
          tma_load_3d(st + h * SK * 128, kmap, &full[s], 64 * h, row, plane);
          tma_load_3d(st + (HALVES + h) * SK * 128, vmap, &full[s], 64 * h, row, plane);
        }
      }
      t = tn;
      page = next;
    }
    return;
  }

  const int nthr = NW * 32;
  const int rt = warp / a.KS;
  const int ks = warp % a.KS;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int lrow = lane & 7;   // ldmatrix: the row this lane addresses
  const int lmat = lane >> 3;  // and its matrix
  const int kpw = SK / a.KS;   // keys of each stage in this warp's slice
  const int rowA = rt * 16 + g;  // the two query rows this thread owns
  const int rowB = rowA + 8;
  const int jA = rowA / a.group;
  const int jB = rowB / a.group;
  const unsigned char* qa = qs + (rt * 16 + lrow + 8 * (lmat & 1)) * Sh::QSTR + 16 * (lmat >> 1);
  const int lim = e < len ? e : len;  // slots below it are kept by every query

  float acc[Sh::NACC];
#pragma unroll
  for (int i = 0; i < Sh::NACC; ++i) acc[i] = 0.f;
  float mA = NEG_INF, mB = NEG_INF, lA = 0.f, lB = 0.f;

  for (int i = 0; i < nst; ++i) {
    const int s = i % a.stages;
    const int pos0 = s0 + i * SK;  // the slot of stage row 0
    const unsigned char* kst = smem + s * a.stage_bytes;
    const unsigned char* vst = kst + HALVES * SK * 128;
    mbar_wait(&full[s], (i / a.stages) & 1);

    for (int c0 = ks * kpw; c0 < (ks + 1) * kpw && pos0 + c0 < e; c0 += NC) {
      // S = Q K^T over keys c0 .. c0 + NC - 1 of the stage.
      float sc[NC / 8][4];
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t qf[4];
        ldmatrix_x4(qf, qa + kk * 32);
#pragma unroll
        for (int jj = 0; jj < NC / 16; ++jj) {
          // Keys c0 + 16 jj .. + 15 x head_dim 16 kk .. + 15: matrices
          // (keys +0, cols +0), (+0, +8), (+8, +0), (+8, +8).
          uint32_t kr[4];
          ldmatrix_x4(kr, kst + kv_off(SK, c0 + 16 * jj + 8 * (lmat >> 1) + lrow,
                                       2 * kk + (lmat & 1)));
          mma_16816(sc[2 * jj], qf, kr);
          mma_16816(sc[2 * jj + 1], qf, kr + 2);
        }
      }

      // Scale (log2 units), mask what the query may not see (only steps
      // that reach slot `lim` or past), update the running max and
      // denominators, and form P as hi + lo bf16 A fragments. Keys
      // [16 kk, 16 kk + 16) of the step are score n-tiles 2 kk, 2 kk + 1.
      const bool need_mask = pos0 + c0 + NC > lim;
      uint32_t ph[NC / 16][4], pl[NC / 16][4];
      float mxA = NEG_INF, mxB = NEG_INF;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          float sa = sc[j][e2] * a.scale_log2;
          float sb = sc[j][2 + e2] * a.scale_log2;
          if (need_mask) {
            const int pos = pos0 + c0 + 8 * j + 2 * t4 + e2;
            if (pos >= e || !verify_keep(pos, len, jA, a.R, a.tree_k)) sa = NEG_INF;
            if (pos >= e || !verify_keep(pos, len, jB, a.R, a.tree_k)) sb = NEG_INF;
          }
          sc[j][e2] = sa;
          sc[j][2 + e2] = sb;
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
        float p[4];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          p[e2] = sc[j][e2] > 0.5f * NEG_INF ? exp2f(sc[j][e2] - mnA) : 0.f;
          p[2 + e2] = sc[j][2 + e2] > 0.5f * NEG_INF ? exp2f(sc[j][2 + e2] - mnB) : 0.f;
        }
        sA += p[0] + p[1];
        sB += p[2] + p[3];
        const int f = 2 * (j % 2);
        split_bf16x2(p[0], p[1], ph[j / 2][f], pl[j / 2][f]);
        split_bf16x2(p[2], p[3], ph[j / 2][f + 1], pl[j / 2][f + 1]);
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

      // O += P V. A transposed x4 load of keys kb .. kb + 15 and chunks
      // c, c + 1 gives the B fragments (keys 2 t4, 2 t4 + 1 | + 8, + 9;
      // head_dim column g) of n-tiles c and c + 1.
#pragma unroll
      for (int kk = 0; kk < NC / 16; ++kk) {
        const int kb = c0 + 16 * kk;
        // Keys at and past the split's end were not loaded: zero them.
        uint32_t m0 = 0xffffffffu, m1 = 0xffffffffu;
        if (pos0 + kb + 16 > e) {
          const int k0 = pos0 + kb + 2 * t4;
          m0 = (k0 < e ? 0x0000ffffu : 0u) | (k0 + 1 < e ? 0xffff0000u : 0u);
          m1 = (k0 + 8 < e ? 0x0000ffffu : 0u) | (k0 + 9 < e ? 0xffff0000u : 0u);
        }
#pragma unroll
        for (int c = 0; c < HD / 8; c += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vst + kv_off(SK, kb + 8 * (lmat & 1) + lrow, c + (lmat >> 1)));
          r[0] &= m0;
          r[1] &= m1;
          r[2] &= m0;
          r[3] &= m1;
          mma_16816(acc + 4 * c, ph[kk], r);
          mma_16816(acc + 4 * c, pl[kk], r);
          mma_16816(acc + 4 * c + 4, ph[kk], r + 2);
          mma_16816(acc + 4 * c + 4, pl[kk], r + 2);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // Key slices of a row tile fold into slice 0 in slice order, through
  // shared memory that held the ring (every stage has been consumed).
  auto fold_slices = [&]() {
    if (a.KS == 1) return;
    float* recs = reinterpret_cast<float*>(smem);
    named_sync(1, nthr);
    if (ks > 0) {
      store_partial<HD>(recs + (rt * (a.KS - 1) + ks - 1) * REC, acc, mA, lA, mB, lB, lane);
    }
    named_sync(1, nthr);
    if (ks == 0) {
      for (int k2 = 1; k2 < a.KS; ++k2) {
        merge_partial<HD, false>(acc, mA, lA, mB, lB, recs + (rt * (a.KS - 1) + k2 - 1) * REC,
                                 lane);
      }
    }
  };
  fold_slices();

  if (nsplit > 1) {
    // This split's partial to the workspace [B, KH, splits, RT][REC].
    // The last split to arrive merges them: slice warp ks takes splits
    // ks, ks + KS, ... in order, then the slices fold in slice order, so
    // the merge order is fixed and KS partials load at a time.
    float* wsb = a.ws + (static_cast<long long>(b) * a.KH + kvh) * gridDim.z * RT * REC;
    if (ks == 0) {
      store_partial<HD>(wsb + (static_cast<long long>(sp) * RT + rt) * REC, acc, mA, lA, mB,
                        lB, lane);
    }
    __threadfence();
    named_sync(1, nthr);
    if (threadIdx.x == 0) {
      int* ticket = a.tickets + b * a.KH + kvh;
      const int last = atomicAdd(ticket, 1) == nsplit - 1;
      if (last) *ticket = 0;  // every split has arrived: ready for the next launch
      *last_flag = last;
    }
    named_sync(1, nthr);
    if (!*last_flag) return;
    __threadfence();
    mA = mB = NEG_INF;
    lA = lB = 0.f;
#pragma unroll
    for (int i = 0; i < Sh::NACC; ++i) acc[i] = 0.f;
    for (int s2 = ks; s2 < nsplit; s2 += a.KS) {
      merge_partial<HD, true>(acc, mA, lA, mB, lB,
                              wsb + (static_cast<long long>(s2) * RT + rt) * REC, lane);
    }
    fold_slices();
  }
  if (ks != 0) return;

  // Row g: head_dim 8 n + 2 t4, + 1 are acc[4 n], acc[4 n + 1]; row g + 8
  // acc[4 n + 2], acc[4 n + 3].
#pragma unroll
  for (int hb = 0; hb < 2; ++hb) {
    const int row = hb ? rowB : rowA;
    if (row >= G) continue;
    const float l = hb ? lB : lA;
    const float inv = l == 0.f ? 1.f : 1.f / l;
    const int j = row / a.group;
    const int h = kvh * a.group + (row - j * a.group);
    __nv_bfloat16* op = a.o + b * a.q_sb + static_cast<long long>(h) * a.q_sh +
                        static_cast<long long>(j) * a.q_sj + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(op + 8 * n) =
          pack_f32(acc[4 * n + 2 * hb] * inv, acc[4 * n + 2 * hb + 1] * inv);
    }
  }
}

// Defines kernel NAME<HD, NC> over the body, and NAME##_family, which
// hands `run` its instantiations (nullptr if the kernel may not have
// MAX_SMEM bytes of shared memory), each opted in once.
#define GAIE_PAGED_BF16_KERNEL(NAME)                                                       \
  template <int HD, int NC>                                                                \
  __global__ void __launch_bounds__(32 * (gaie::paged_bf16::MAX_WARPS + 1), 1)             \
      NAME(const __grid_constant__ CUtensorMap kmap,                                       \
           const __grid_constant__ CUtensorMap vmap,                                       \
           const __grid_constant__ gaie::paged_bf16::Args a) {                             \
    gaie::paged_bf16::body<HD, NC>(&kmap, &vmap, a);                                       \
  }                                                                                        \
  struct NAME##_family {                                                                   \
    template <int HD, int NC>                                                              \
    static gaie::paged_bf16::KernelFn get() {                                              \
      static const cudaError_t opted = cudaFuncSetAttribute(                               \
          NAME<HD, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,                       \
          gaie::paged_bf16::MAX_SMEM);                                                     \
      return opted == cudaSuccess ? NAME<HD, NC> : nullptr;                                \
    }                                                                                      \
  };

using KernelFn = void (*)(CUtensorMap, CUtensorMap, Args);

struct Layout {
  int stages, stage_bytes, q_off, bar_off, smem;
};

// RT: 16-row tiles staged; the key slices' partials fold through the
// ring's shared memory at the end.
template <int HD>
inline Layout layout(int SK, int stages, int RT, int KS) {
  Layout t;
  t.stage_bytes = 4 * SK * HD;  // K and V rows of SK slots, bf16
  t.stages = stages;
  const int ring = t.stages * t.stage_bytes;
  const int merge = RT * (KS - 1) * Shape<HD>::REC * 32 * 4;
  t.q_off = ring > merge ? ring : merge;
  t.bar_off = t.q_off + RT * 16 * Shape<HD>::QSTR;
  t.smem = t.bar_off + 2 * t.stages * 8 + 16 + 1024;  // barriers, flag, alignment slack
  return t;
}

inline int gcd(int x, int y) {
  while (y != 0) {
    const int r = x % y;
    x = y;
    y = r;
  }
  return x;
}

template <int HD>
int launch(KernelFn kernel, const void* k_pages, const void* v_pages, Args a, int B,
           int splits, cudaStream_t stream) {
  const int RT = (a.group * a.R + 15) / 16;
  const Layout t = layout<HD>(a.SK, a.stages, RT, a.KS);
  if (kernel == nullptr || t.smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  a.stage_bytes = t.stage_bytes;
  a.q_off = t.q_off;
  a.bar_off = t.bar_off;
  // The pages as [KH P planes][ps][HD] bf16; a box is BR rows x 64
  // columns (128 bytes), inside one page.
  CUtensorMap maps[2];
  const uint64_t dims[3] = {static_cast<uint64_t>(HD), static_cast<uint64_t>(a.ps),
                            static_cast<uint64_t>(a.KH) * a.P};
  const uint64_t strides[2] = {static_cast<uint64_t>(HD) * 2,
                               static_cast<uint64_t>(a.ps) * HD * 2};
  const uint32_t box[3] = {64, static_cast<uint32_t>(a.BR), 1};
  const void* bases[2] = {k_pages, v_pages};
  for (int i = 0; i < 2; ++i) {
    if (!encode_tiled_sw128(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, bases[i], dims,
                            strides, box)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  dim3 grid(a.KH, B, splits);
  kernel<<<grid, 32 * (RT * a.KS + 1), t.smem, stream>>>(maps[0], maps[1], a);
  return static_cast<int>(cudaGetLastError());
}

// Checks the plan and launches: q / o rows at element strides (q_sb,
// q_sh, q_sj), R query positions a row, the verify mask of tree_k
// (tree_mask.cuh), lengths clamped to >= min_len. The plan (the
// wrapper's paged_bf16_plan): key_slices consumer warps per 16-row tile
// of the (H / KH) R query rows (row tiles x key_slices <= 8),
// stage_keys slots a ring stage (a multiple of 16 up to 128, stage_keys
// / key_slices a multiple of 16; 32 keys a step where it is a multiple
// of 32), ring_stages (2 to 8) and pages_per_split; with more than one
// split (ceil(maxp / pages_per_split)), ws holds B KH splits row-tiles x
// (Hd / 2 + 4) x 32 f32 and tickets B KH int32 zeros, which every launch
// leaves zero.
template <class Family>
int run(const void* q, const void* k_pages, const void* v_pages, void* o,
               const void* page_table, const void* lengths, void* ws, void* tickets, int B,
               int H, int KH, int P, int ps, int maxp, int Hd, int R, int tree_k, int min_len,
               long long q_sb, int q_sh, int q_sj, int key_slices, int stage_keys,
               int ring_stages, int pages_per_split, float scale, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || KH <= 0 || H % KH != 0 || ps <= 0 || ps % 8 != 0 || ps > 128 ||
      maxp <= 0 || P <= 0 || static_cast<long long>(KH) * P >= (1LL << 31) || R < 1 ||
      tree_k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int KS = key_slices;
  const int SK = stage_keys;
  const int RT = ((H / KH) * R + 15) / 16;
  const int splits = pages_per_split < 1 ? 0 : (maxp + pages_per_split - 1) / pages_per_split;
  if (KS < 1 || RT * KS > MAX_WARPS || SK < 16 || SK > 128 || SK % KS != 0 ||
      ring_stages < 2 || ring_stages > 8 ||
      (SK / KS) % 16 != 0 || splits < 1 || splits > 65535 ||
      (splits > 1 && (ws == nullptr || tickets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.page_table = static_cast<const int*>(page_table);
  a.lengths = static_cast<const int*>(lengths);
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.q_sj = q_sj;
  a.H = H;
  a.KH = KH;
  a.P = P;
  a.ps = ps;
  a.maxp = maxp;
  a.group = H / KH;
  a.R = R;
  a.tree_k = tree_k;
  a.min_len = min_len;
  a.KS = KS;
  a.SK = SK;
  a.BR = gcd(ps, SK);  // a multiple of 8: boxes never cross a page or a stage
  a.pps = pages_per_split;
  a.stages = ring_stages;
  a.scale_log2 = scale * 1.4426950408889634f;
  const bool wide = (SK / KS) % 32 == 0;
  if (Hd == 128) {
    return launch<128>(wide ? Family::template get<128, 32>() : Family::template get<128, 16>(),
                       k_pages, v_pages, a, B, splits, stream);
  }
  if (Hd == 64) {
    return launch<64>(wide ? Family::template get<64, 32>() : Family::template get<64, 16>(),
                      k_pages, v_pages, a, B, splits, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace paged_bf16
}  // namespace gaie
