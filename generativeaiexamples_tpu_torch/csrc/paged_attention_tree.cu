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
// flops per 4 Hd bytes, G = 52 flops a byte, far below the ~295
// flop/byte ridge, so it is bound by reading the pool. The design is
// paged_bf16.cuh's, shared with the decode kernel (paged_attention.cu):
// the span split across CTAs when B x KH CTAs would leave the card idle
// (one CTA per (kv head, row) left a row of 8,191 slots to one SM),
// merged in split order; a TMA producer warp and an mbarrier ring; the G
// rows in 16-row tiles on mma.sync, each tile's warps taking slices of
// every ring stage; the ancestor mask arithmetic (verify_keep), so no
// table crosses from the host.

#include "paged_bf16.cuh"

namespace {
GAIE_PAGED_BF16_KERNEL(paged_tree_kernel)
}  // namespace

// q [B, H, r, Hd] bf16 (r = 1 + tree_k * tree_m packed nodes), k_pages /
// v_pages [KH, P, ps, Hd] bf16 (one layer's slice), o [B, H, r, Hd] bf16,
// all contiguous and 16-byte aligned; page_table [B, maxp] and lengths
// [B] int32 on the device. Hd in {64, 128}, ps a multiple of 8 up to
// 128, tree_k >= 1, tree_m >= 1, (H / KH) r <= 128. The plan (the
// wrapper's paged_bf16_plan) and ws / tickets as in paged_attention.cu.
// Returns the launch's cudaError_t (0 on success).
extern "C" int gaie_paged_tree_attention_bf16(const void* q, const void* k_pages,
                                              const void* v_pages, void* o,
                                              const void* page_table, const void* lengths,
                                              void* ws, void* tickets, int B, int H, int KH,
                                              int P, int ps, int maxp, int Hd, int tree_k,
                                              int tree_m, int key_slices, int stage_keys,
                                              int ring_stages, int pages_per_split, float scale,
                                              void* stream) {
  if (tree_k < 1 || tree_m < 1 || KH <= 0 || H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int r = 1 + tree_k * tree_m;
  return gaie::paged_bf16::run<paged_tree_kernel_family>(
      q, k_pages, v_pages, o, page_table, lengths, ws, tickets, B, H, KH, P, ps, maxp, Hd, r,
      tree_k, /*min_len=*/1, static_cast<long long>(H) * r * Hd, r * Hd, Hd, key_slices,
      stage_keys, ring_stages, pages_per_split, scale, static_cast<cudaStream_t>(stream));
}
