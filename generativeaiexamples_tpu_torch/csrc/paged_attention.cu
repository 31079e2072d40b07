// Paged decode attention for Hopper (sm_90a): one query token per
// sequence over that sequence's KV pages, bf16 pages and queries, f32
// online softmax, bf16 output.
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
// A row of length 0 has no key and gets zeros.
//
// What bounds it on an H100: decode attention does 4 Hd flops per (query
// head, cached token) against 4 Hd bytes of K/V per (kv head, token),
// H / KH = 4 flops a byte at the 8B shape, far below the ridge: it is
// bound by reading the pages. The design is paged_bf16.cuh's (shared with
// the tree-verify kernel, paged_attention_tree.cu): the page axis split
// across CTAs when B x KH CTAs would leave the card idle, merged in split
// order; K and V staged by one TMA producer warp in an mbarrier ring;
// both products on the tensor cores (mma.sync m16n8k16) for the group's
// H / KH query rows in 16-row tiles (one at the 8B shape), whose warps
// take slices of every ring stage.

#include "paged_bf16.cuh"

namespace {
GAIE_PAGED_BF16_KERNEL(paged_decode_kernel)
}  // namespace

// q / o [B, H, Hd], k_pages / v_pages [KH, P, ps, Hd], all bf16,
// contiguous and 16-byte aligned; page_table [B, maxp] and lengths [B]
// int32 on the device. Hd in {64, 128}, ps a multiple of 8 up to 128,
// (H / KH) <= 128. The plan (the wrapper's paged_bf16_plan): key_slices,
// stage_keys, ring_stages and pages_per_split as paged_bf16.cuh's `run`
// takes them; with more than one split, ws holds B KH splits x (Hd / 2 +
// 4) x 32 f32 per 16-row tile and tickets B KH int32 zeros, which every
// launch leaves zero. Returns the launch's cudaError_t (0 on success).
extern "C" int gaie_paged_attention_bf16(const void* q, const void* k_pages,
                                         const void* v_pages, void* o, const void* page_table,
                                         const void* lengths, void* ws, void* tickets, int B,
                                         int H, int KH, int P, int ps, int maxp, int Hd,
                                         int key_slices, int stage_keys, int ring_stages,
                                         int pages_per_split, float scale, void* stream) {
  if (KH <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return gaie::paged_bf16::run<paged_decode_kernel_family>(
      q, k_pages, v_pages, o, page_table, lengths, ws, tickets, B, H, KH, P, ps, maxp, Hd,
      /*R=*/1, /*tree_k=*/0, /*min_len=*/0, static_cast<long long>(H) * Hd, Hd, 0, key_slices,
      stage_keys, ring_stages, pages_per_split, scale, static_cast<cudaStream_t>(stream));
}
