// Paged GQA single-query flash-decode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:65
// (_decode_kernel, reached through paged_decode_attention_pallas).
//
// One thread block per (slot b, kv head kh). The block loads the G = H/Kh
// query rows of its kv group once, then walks ONLY the slot's
// ceil(len/bs) live block-table entries: each step stages one pool block
// of k and v in shared memory (as f32; pools may be f32 or bf16), scores
// it against the G rows, folds it into an online softmax (m, l, acc) in
// f32 and moves on. The output is written once. A slot of length 0 walks
// nothing and writes exact zeros (the l == 0 guard of the reference).
//
// Bound on this card: the bytes of the live KV blocks (each read once),
// G*bs*dh*4 FLOP per block against 2*bs*dh*bytes — far below the ridge, so
// it is memory- and latency-bound. The design keeps reads ragged (dead
// table entries are never touched) and reads each block once for the
// whole GQA group. Faster versions (several blocks in flight per step,
// split-KV across blocks for long sequences) are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxAcc = 4;  // G*dh <= kThreads*kMaxAcc accumulators

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                  const TKV* __restrict__ vp, const int* __restrict__ tables,
                  const int* __restrict__ lengths, TQ* __restrict__ out,
                  int H, int Kh, int dh, int bs, int nb, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kh = blockIdx.y, tid = threadIdx.x;
  const int G = H / Kh;
  const int ldk = dh + 1;  // padded k rows: conflict-free dot products
  float* qs = smem;              // [G][dh]
  float* ks = qs + G * dh;       // [bs][dh+1]
  float* vs = ks + bs * ldk;     // [bs][dh]
  float* ss = vs + bs * dh;      // [G][bs] scores, then probabilities
  float* ms = ss + G * bs;       // [G] running max
  float* ls = ms + G;            // [G] running sum
  float* as = ls + G;            // [G] rescale factor of this step

  const int len = lengths[b];
  const size_t qbase = ((size_t)b * H + (size_t)kh * G) * dh;
  for (int i = tid; i < G * dh; i += kThreads) qs[i] = to_f32(q[qbase + i]);
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = -INFINITY;
    ls[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.f;
  const int nlive = min((len + bs - 1) / bs, nb);
  __syncthreads();

  for (int j = 0; j < nlive; ++j) {
    const size_t base = (size_t)tables[(size_t)b * nb + j] * bs * Kh * dh;
    for (int i = tid; i < bs * dh; i += kThreads) {
      const int t = i / dh, d = i - t * dh;
      const size_t off = base + ((size_t)t * Kh + kh) * dh + d;
      ks[t * ldk + d] = to_f32(kp[off]);
      vs[t * dh + d] = to_f32(vp[off]);
    }
    __syncthreads();
    const int kv0 = j * bs;
    for (int i = tid; i < G * bs; i += kThreads) {
      const int g = i / bs, t = i - g * bs;
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot += qs[g * dh + d] * ks[t * ldk + d];
      ss[i] = dot * scale;
    }
    __syncthreads();
    const int warp = tid >> 5;
    for (int g = warp; g < G; g += kThreads / 32) {
      const float alpha = softmax_update(
          ss + g * bs, bs, [&](int t) { return kv0 + t < len; }, ms + g,
          ls + g);
      if ((tid & 31) == 0) as[g] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) {
      const int i = tid + k * kThreads;
      if (i < G * dh) {
        const int g = i / dh, d = i - g * dh;
        float a = acc[k] * as[g];
        for (int t = 0; t < bs; ++t) a += ss[g * bs + t] * vs[t * dh + d];
        acc[k] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int i = tid + k * kThreads;
    if (i < G * dh) {
      const float l = ls[i / dh];
      out[qbase + i] = from_f32<TQ>(acc[k] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* lengths, void* out, int B, int H, int Kh, int dh,
           int bs, int nb, cudaStream_t stream) {
  const int G = H / Kh;
  const size_t smem =
      sizeof(float) * ((size_t)G * dh + (size_t)bs * (dh + 1) +
                       (size_t)bs * dh + (size_t)G * bs + 3 * (size_t)G);
  auto kernel = decode_kernel<TQ, TKV>;
  allow_smem(kernel, smem);
  const float scale = (float)(1.0 / sqrt((double)dh));
  kernel<<<dim3(B, Kh), kThreads, smem, stream>>>(
      (const TQ*)q, (const TKV*)kp, (const TKV*)vp, (const int*)tables,
      (const int*)lengths, (TQ*)out, H, Kh, dh, bs, nb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,H,dh), pools (P,bs,Kh,dh), tables (B,nb) int32, lengths (B,)
// int32 -> out (B,H,dh) in q's type. Launches on `stream`; no sync, no
// allocation.
extern "C" int paged_decode_attention(const void* q, const void* kp,
                                      const void* vp, const void* tables,
                                      const void* lengths, void* out, int B,
                                      int H, int Kh, int dh, int bs, int nb,
                                      int q_bf16, int kv_bf16, void* stream) {
  if (H % Kh != 0 || (H / Kh) * dh > kThreads * kMaxAcc) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  using bf = __nv_bfloat16;
  if (q_bf16) {
    return kv_bf16 ? launch<bf, bf>(q, kp, vp, tables, lengths, out, B, H,
                                    Kh, dh, bs, nb, s)
                   : launch<bf, float>(q, kp, vp, tables, lengths, out, B,
                                       H, Kh, dh, bs, nb, s);
  }
  return kv_bf16 ? launch<float, bf>(q, kp, vp, tables, lengths, out, B, H,
                                     Kh, dh, bs, nb, s)
                 : launch<float, float>(q, kp, vp, tables, lengths, out, B,
                                        H, Kh, dh, bs, nb, s);
}
