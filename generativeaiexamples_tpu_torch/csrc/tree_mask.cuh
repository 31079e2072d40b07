// The verify masks shared by the speculative attention kernels
// (paged_attention_int8.cu's q_rep / tree forms, paged_bf16.cuh's body of
// paged_attention.cu and paged_attention_tree.cu),
// the device form of serving/paged_attention_int8.py::_tree_keep.
// Editing this header rebuilds every library (kernels.library_path hashes
// the csrc/*.cuh headers).

#pragma once

namespace gaie {

// May query row `jrow` (its node index: the verify position, or the node
// of the packed tree) attend kv slot `pos`? `len` is the row's length
// including node 0, which sits at slot len - 1.
//   tree_k == 0: linear verify, query j attends pos < len + j.
//   tree_k  > 0: the packed (k, M) lattice of r = 1 + k M nodes, node
//     1 + m k + (d - 1) being branch m's depth-d draft: the committed
//     prefix, the root, and the nodes t on j's branch with
//     depth(t) <= depth(j) (ancestor-or-self), computed from the indices
//     alone so no mask table is needed.
__device__ __forceinline__ bool verify_keep(int pos, int len, int jrow, int r, int tree_k) {
  if (tree_k == 0) return pos < len + jrow;
  const int rel = pos - (len - 1);
  if (rel < 0) return true;   // committed prefix
  if (rel >= r) return false;  // past the tree
  if (rel == 0) return true;   // the root
  if (jrow == 0) return false;
  const int jn = jrow - 1;
  const int tn = rel - 1;
  return jn / tree_k == tn / tree_k && tn % tree_k <= jn % tree_k;
}

}  // namespace gaie
