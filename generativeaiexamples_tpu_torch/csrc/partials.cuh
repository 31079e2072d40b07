// The split paged-attention kernels' partials (paged_attention_int8.cu,
// paged_bf16.cuh): a thread's running max m, denominator l and HD / 2
// accumulator floats for rows g and g + 8 of its mma.sync fragments
// (a m16n8 accumulator tile per 8 head_dim columns: floats 4 n, 4 n + 1
// of row g, 4 n + 2, 4 n + 3 of row g + 8), stored lane-strided, [HD / 2
// + 4][32] floats a warp, so a warp's loads and stores are coalesced.
// Partials merge in whatever fixed order the caller takes them, so a
// repeat launch gives the same bits. Editing this header rebuilds every
// library (kernels.library_path hashes the csrc/*.cuh headers).

#pragma once

namespace gaie {

// Folds a partial (acc, m, l of rows g and g + 8; lane-strided at r)
// into this thread's state: another CTA's partial in global memory
// (GLOBAL) or one of this CTA's in shared memory.
template <int HD, bool GLOBAL>
__device__ __forceinline__ void merge_partial(float* acc, float& mA, float& lA, float& mB,
                                              float& lB, const float* r, int lane) {
  constexpr int N = HD / 2;
  auto ld = [&](int i) -> float {
    if constexpr (GLOBAL) {
      return __ldcg(r + i * 32 + lane);  // another CTA's write: read through L2
    } else {
      return r[i * 32 + lane];
    }
  };
  const float m2A = ld(N), l2A = ld(N + 1), m2B = ld(N + 2), l2B = ld(N + 3);
  const float MA = fmaxf(mA, m2A), MB = fmaxf(mB, m2B);
  const float fA = exp2f(mA - MA), gA = exp2f(m2A - MA);
  const float fB = exp2f(mB - MB), gB = exp2f(m2B - MB);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool rowA = (i & 3) < 2;
    acc[i] = acc[i] * (rowA ? fA : fB) + ld(i) * (rowA ? gA : gB);
  }
  lA = lA * fA + l2A * gA;
  lB = lB * fB + l2B * gB;
  mA = MA;
  mB = MB;
}

template <int HD>
__device__ __forceinline__ void store_partial(float* r, const float* acc, float mA, float lA,
                                              float mB, float lB, int lane) {
  constexpr int N = HD / 2;
#pragma unroll
  for (int i = 0; i < N; ++i) r[i * 32 + lane] = acc[i];
  r[N * 32 + lane] = mA;
  r[(N + 1) * 32 + lane] = lA;
  r[(N + 2) * 32 + lane] = mB;
  r[(N + 3) * 32 + lane] = lB;
}

}  // namespace gaie
