// One kv tile of the flash-attention forward recurrence, for one warp:
// the step shared by the dense flash forward (flash_attention.cu) and
// the paged chunked prefill (paged_prefill.cu), for Hopper (sm_90a).
//
// A warp owns 16 query rows; its thread (gr, tg) holds rows gr and
// gr + 8 ("halves" h = 0, 1). The step computes the 16 x kBK scores S =
// Q K^T * scale with mma.sync (or f32 FMAs) into registers, takes the
// online softmax (m, l) there with quad shuffles for the row max, and
// adds P V into the 16 x DH output straight from the score registers
// (warp_mma_cfrag: no shuffle, no round trip through shared memory).
// Each tile's P V starts
// from zero and is added to the running sum with one rounded f32 FMA
// (the tensor cores' accumulation truncates; mma_sm90.cuh).
#pragma once

#include "mma_sm90.cuh"

namespace {

constexpr int kBK = 32;  // keys a kv tile

// qw: the warp's 16 Q rows (row stride LDQ); ks, vs: the staged K and V
// tile (row stride LDKV) of keys kv0 .. kv0 + kBK. When `masked`, key t
// counts for the thread's row half h iff valid(t, h); otherwise every
// key counts. A row with no valid key so far keeps m = -inf and l = 0.
// kFmaScores: the scores as float32 FMAs on CUDA cores (each dot in
// order over dh) instead of mma.sync. The tensor cores' sums truncate
// (mma_sm90.cuh), and exp() turns a score's error into a relative error
// of the output: at |q|, |k| ~ 30-40, as a randomly initialised model
// gives them, the mma scores left the float32 tolerance (measured on the
// card, paged_prefill.cu), where the FMA scores hold it.
// P V runs as bf16 products when Q and K/V are both bf16 (P rounded to
// bf16), else with P split for TF32 (V split too when it is float).
template <typename TQ, typename TKV, int DH, int LDQ, int LDKV,
          bool kFmaScores = false, typename Valid>
__device__ __forceinline__ void attend_tile(const TQ* qw, const TKV* ks,
                                            const TKV* vs, int kv0,
                                            bool masked, Valid valid,
                                            float scale, float (&m)[2],
                                            float (&l)[2],
                                            float (&acc)[DH / 8][4]) {
  constexpr int NO = DH / 8;
  using TP = typename std::conditional<
      std::is_same<TQ, float>::value || std::is_same<TKV, float>::value,
      float, TKV>::type;
  const int tg = threadIdx.x & 3;
  float s[1][kBK / 8][4] = {};
  if constexpr (kFmaScores) {  // the accumulator layout of the mma path
    const int gr = (threadIdx.x & 31) >> 2;
    const TQ* q0 = qw + gr * LDQ;
    const TQ* q1 = q0 + 8 * LDQ;
#pragma unroll 8
    for (int c = 0; c < DH; ++c) {
      const float a0 = to_f32(q0[c]), a1 = to_f32(q1[c]);
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float b = to_f32(ks[(8 * n + 2 * tg + e) * LDKV + c]);
          s[0][n][e] = fmaf(a0, b, s[0][n][e]);
          s[0][n][2 + e] = fmaf(a1, b, s[0][n][2 + e]);
        }
    }
  } else {
    warp_mma<TQ, TKV, 1, kBK / 8, DH>(
        s, [&](int r, int c) { return to_f32(qw[r * LDQ + c]); },
        [&](int c, int n) { return to_f32(ks[n * LDKV + c]); });
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = kv0 + 8 * n + 2 * tg + (e & 1), h = e >> 1;
      float x = s[0][n][e] * scale;
      if (masked && !valid(t, h)) x = -INFINITY;
      s[0][n][e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    alpha[h] = expf(m[h] - m_safe);  // 0 while the row had no valid key
    m[h] = m_new;
    mx[h] = m_safe;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[0][n][e] - mx[e >> 1]);
      s[0][n][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
  float pv[NO][4] = {};
  warp_mma_cfrag<TP, NO, kBK, TKV>(
      pv, s[0], [&](int t, int c) { return to_f32(vs[t * LDKV + c]); });
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[n][e]);
    }
}

}  // namespace
