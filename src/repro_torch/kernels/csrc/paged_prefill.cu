// Paged chunked-prefill GQA attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_prefill.py:66
// (_prefill_kernel, reached through paged_prefill_attention_pallas).
//
// One thread block per (chunk lane c, kv head kh, q tile qi) of bq chunk
// rows; with G = H/Kh the tile holds R = bq*G query rows (row r = i*G + g
// is chunk row qi*bq + i, query head kh*G + g). Row i attends pool
// positions <= starts[c] + i (causal on ABSOLUTE positions: the chunk's
// own k/v, earlier chunks and shared prefix blocks are all just pool
// reads — the mixed step wrote the chunk before attention). The block
// walk stops at the tile's causal limit ceil((starts[c] + min((qi+1)*bq,
// lens[c])) / bs); a tile past lens[c] walks nothing. Online softmax
// (m, l, acc) in f32 over f32 or bf16 pools; rows i >= lens[c] and rows
// with no valid key are exact zeros.
//
// Bound on this card: 4*R*bs*dh FLOP against 2*bs*dh pool bytes per step —
// 32 rows x 16 keys at the serve shapes, still below the f32 ridge, so it
// is bound by the bytes of the blocks each tile attends (each lane's
// prefix is re-read once per q tile and kv head group, from L2). Tensor
// cores (mma/wgmma over the R x bs score tile) are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxAcc = 16;  // R*dh <= kThreads*kMaxAcc accumulators

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
    prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                   const TKV* __restrict__ vp, const int* __restrict__ tables,
                   const int* __restrict__ starts,
                   const int* __restrict__ lens, TQ* __restrict__ out, int C,
                   int H, int Kh, int dh, int bs, int nb, int bq,
                   float scale) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, kh = blockIdx.y, qi = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = H / Kh, R = bq * G;
  const int ldk = dh + 1;
  float* qs = smem;              // [R][dh]
  float* ks = qs + R * dh;       // [bs][dh+1]
  float* vs = ks + bs * ldk;     // [bs][dh]
  float* ss = vs + bs * dh;      // [R][bs]
  float* ms = ss + R * bs;       // [R]
  float* ls = ms + R;            // [R]
  float* as = ls + R;            // [R]

  const int ln = lens[c], st = starts[c];
  const int row0 = qi * bq;  // first chunk row of this tile
  // q[c, row0 + i, kh*G + g, :] -> qs[(i*G + g)*dh + d]
  for (int x = tid; x < R * dh; x += kThreads) {
    const int r = x / dh, d = x - r * dh;
    const int i = r / G, g = r - i * G;
    qs[x] = to_f32(q[(((size_t)c * C + row0 + i) * H + kh * G + g) * dh + d]);
  }
  for (int r = tid; r < R; r += kThreads) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.f;
  int nlive = 0;
  if (row0 < ln) {
    const int limit = st + min(row0 + bq, ln);  // causal limit of the tile
    nlive = min((limit + bs - 1) / bs, nb);
  }
  __syncthreads();

  for (int j = 0; j < nlive; ++j) {
    const size_t base = (size_t)tables[(size_t)c * nb + j] * bs * Kh * dh;
    for (int x = tid; x < bs * dh; x += kThreads) {
      const int t = x / dh, d = x - t * dh;
      const size_t off = base + ((size_t)t * Kh + kh) * dh + d;
      ks[t * ldk + d] = to_f32(kp[off]);
      vs[t * dh + d] = to_f32(vp[off]);
    }
    __syncthreads();
    for (int x = tid; x < R * bs; x += kThreads) {
      const int r = x / bs, t = x - r * bs;
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot += qs[r * dh + d] * ks[t * ldk + d];
      ss[x] = dot * scale;
    }
    __syncthreads();
    const int kv0 = j * bs;
    for (int r = tid >> 5; r < R; r += kThreads / 32) {
      const int i = row0 + r / G;  // chunk row of query row r
      const float alpha = softmax_update(
          ss + r * bs, bs,
          [&](int t) { return i < ln && kv0 + t <= st + i; }, ms + r,
          ls + r);
      if ((tid & 31) == 0) as[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) {
      const int x = tid + k * kThreads;
      if (x < R * dh) {
        const int r = x / dh, d = x - r * dh;
        float a = acc[k] * as[r];
        for (int t = 0; t < bs; ++t) a += ss[r * bs + t] * vs[t * dh + d];
        acc[k] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int x = tid + k * kThreads;
    if (x < R * dh) {
      const int r = x / dh, d = x - r * dh;
      const int i = r / G, g = r - i * G;
      const float l = ls[r];
      out[(((size_t)c * C + row0 + i) * H + kh * G + g) * dh + d] =
          from_f32<TQ>(acc[k] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* starts, const void* lens, void* out, int NC, int C,
           int H, int Kh, int dh, int bs, int nb, int bq,
           cudaStream_t stream) {
  const int R = bq * (H / Kh);
  const size_t smem =
      sizeof(float) * ((size_t)R * dh + (size_t)bs * (dh + 1) +
                       (size_t)bs * dh + (size_t)R * bs + 3 * (size_t)R);
  auto kernel = prefill_kernel<TQ, TKV>;
  allow_smem(kernel, smem);
  const float scale = (float)(1.0 / sqrt((double)dh));
  kernel<<<dim3(NC, Kh, C / bq), kThreads, smem, stream>>>(
      (const TQ*)q, (const TKV*)kp, (const TKV*)vp, (const int*)tables,
      (const int*)starts, (const int*)lens, (TQ*)out, C, H, Kh, dh, bs, nb,
      bq, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (NC,C,H,dh), pools (P,bs,Kh,dh), tables (NC,nb), starts/lens (NC,)
// int32 -> out (NC,C,H,dh) in q's type; bq must divide C. Launches on
// `stream`; no sync, no allocation.
extern "C" int paged_prefill_attention(const void* q, const void* kp,
                                       const void* vp, const void* tables,
                                       const void* starts, const void* lens,
                                       void* out, int NC, int C, int H,
                                       int Kh, int dh, int bs, int nb,
                                       int bq, int q_bf16, int kv_bf16,
                                       void* stream) {
  if (H % Kh != 0 || bq < 1 || C % bq != 0 ||
      bq * (H / Kh) * dh > kThreads * kMaxAcc) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  using bf = __nv_bfloat16;
  if (q_bf16) {
    return kv_bf16 ? launch<bf, bf>(q, kp, vp, tables, starts, lens, out, NC,
                                    C, H, Kh, dh, bs, nb, bq, s)
                   : launch<bf, float>(q, kp, vp, tables, starts, lens, out,
                                       NC, C, H, Kh, dh, bs, nb, bq, s);
  }
  return kv_bf16 ? launch<float, bf>(q, kp, vp, tables, starts, lens, out,
                                     NC, C, H, Kh, dh, bs, nb, bq, s)
                 : launch<float, float>(q, kp, vp, tables, starts, lens,
                                        out, NC, C, H, Kh, dh, bs, nb, bq,
                                        s);
}
