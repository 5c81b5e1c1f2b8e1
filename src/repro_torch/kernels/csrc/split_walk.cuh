// The split kv walk of the paged attention kernels (flash-decoding's
// split-KV), shared by the paged prefill (paged_prefill.cu) and the paged
// decode (decode_attention.cu): each query row's walk over its keys is
// cut into `splits` runs, one thread block each, which write their
// unnormalised partial (acc, m, l) to an f32 scratch; a second launch
// sums the runs of each row in split order.
#pragma once

#include "common.cuh"

namespace {

// The partial scratch of a split walk over NR query rows: acc (splits,
// NR, DH) unnormalised, then (m, l) (splits, NR, 2).
template <int DH>
struct Partials {
  float* acc;
  float* ml;
  __device__ Partials(float* part, int splits, size_t nr)
      : acc(part), ml(part + (size_t)splits * nr * DH) {}
};

// The runs of query row `row` summed by one warp, each run's acc and l
// rescaled by exp(m_run - m) to the row's largest m, and written to
// out[row * DH ..]. A row that is not `live`, or saw no valid key, is
// exact zeros.
template <typename TQ, int DH>
__device__ __forceinline__ void combine_runs(const float* __restrict__ part,
                                             size_t nr, int splits,
                                             size_t row, bool live,
                                             TQ* __restrict__ out) {
  constexpr int PER = (DH + 31) / 32;  // values a lane
  const int lane = threadIdx.x & 31;
  const Partials<DH> pt(const_cast<float*>(part), splits, nr);
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, pt.ml[2 * (s * nr + row)]);
  float l = 0.f, o[PER] = {};
  for (int s = 0; s < splits; ++s) {
    const size_t at = s * nr + row;
    const float m = pt.ml[2 * at];
    const float w = m == -INFINITY ? 0.f : expf(m - mx);
    l += w * pt.ml[2 * at + 1];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int d = lane + 32 * k;
      if (d < DH) o[k] += w * pt.acc[at * DH + d];
    }
  }
  live = live && l > 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int d = lane + 32 * k;
    if (d < DH) out[row * DH + d] = from_f32<TQ>(live ? o[k] / l : 0.f);
  }
}

}  // namespace
