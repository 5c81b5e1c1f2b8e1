// Dense GQA flash-attention forward for Hopper (sm_90a), returning the
// output and the per-row log-sum-exp the backward kernels need.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:94
// (_kernel, reached through flash_attention_pallas with
// return_residuals=True).
//
// One thread block per (q tile qi of bq query rows, kv head kh, batch b);
// with G = H/Kh the tile holds R = bq*G rows (row r = i*G + g is query
// row qi*bq + i of head kh*G + g), so the G heads of one kv head share
// every staged K/V tile. The block walks kv tiles of kBK keys with an
// online softmax (m, l, acc) in f32. Query row i sits at absolute
// position q_offset + i and attends key t iff t < kv_len and, when
// causal, t <= q_offset + i; q_offset and kv_len are read from device
// memory. The walk stops at the tile's last live key, so a causal tile
// wholly in the future is never visited. A row with no valid key gives
// exact zeros and lse = +inf (so exp(s - lse) = 0 in the backward).
//
// Bound on this card: at the training shapes (B 16, S 512, H 16, Kh 8,
// dh 64, causal) the live pairs need 4*dh*B*H*S(S+1)/2 = 8.6 GFLOP
// against ~100 MB of q/k/v/o, so the f32 FLOPs bound it (0.13 ms at
// 67 TFLOP/s). This kernel computes the score and PV products on CUDA
// cores from shared memory, one product per thread and entry; tensor
// cores (mma/wgmma on bf16 tiles) are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxAcc = 16;  // R*dh <= kThreads*kMaxAcc accumulators
constexpr int kBK = 64;      // keys per kv tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ qoff_p,
                     const int* __restrict__ kvlen_p, T* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Skv, int H, int Kh,
                     int dh, int bq, int causal, float scale) {
  extern __shared__ float smem[];
  const int qi = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = H / Kh, R = bq * G;
  const int ldk = dh + 1;
  float* qs = smem;              // [R][dh]
  float* ks = qs + R * dh;       // [kBK][dh+1]
  float* vs = ks + kBK * ldk;    // [kBK][dh]
  float* ss = vs + kBK * dh;     // [R][kBK]
  float* ms = ss + R * kBK;      // [R]
  float* ls = ms + R;            // [R]
  float* as = ls + R;            // [R]

  const int qoff = *qoff_p;
  const int kvlen = min(*kvlen_p, Skv);
  const int row0 = qi * bq;
  for (int x = tid; x < R * dh; x += kThreads) {
    const int r = x / dh, d = x - r * dh;
    const int i = row0 + r / G, h = kh * G + r % G;
    qs[x] = i < Sq ? to_f32(q[(((size_t)b * Sq + i) * H + h) * dh + d]) : 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.f;
  // Keys past `limit` are masked for every row of the tile.
  int limit = kvlen;
  if (causal) limit = min(limit, qoff + min(row0 + bq, Sq));
  const int nlive = row0 < Sq && limit > 0 ? (limit + kBK - 1) / kBK : 0;
  __syncthreads();

  for (int j = 0; j < nlive; ++j) {
    const int kv0 = j * kBK;
    for (int x = tid; x < kBK * dh; x += kThreads) {
      const int t = x / dh, d = x - t * dh;
      float kx = 0.f, vx = 0.f;
      if (kv0 + t < Skv) {
        const size_t off = (((size_t)b * Skv + kv0 + t) * Kh + kh) * dh + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[t * ldk + d] = kx;
      vs[t * dh + d] = vx;
    }
    __syncthreads();
    for (int x = tid; x < R * kBK; x += kThreads) {
      const int r = x / kBK, t = x - r * kBK;
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot += qs[r * dh + d] * ks[t * ldk + d];
      ss[x] = dot * scale;
    }
    __syncthreads();
    for (int r = tid >> 5; r < R; r += kThreads / 32) {
      const int i = row0 + r / G;
      const float alpha = softmax_update(
          ss + r * kBK, kBK,
          [&](int t) {
            const int pos = kv0 + t;
            return i < Sq && pos < kvlen && (!causal || pos <= qoff + i);
          },
          ms + r, ls + r);
      if ((tid & 31) == 0) as[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int x = tid + a * kThreads;
      if (x < R * dh) {
        const int r = x / dh, d = x - r * dh;
        float s = acc[a] * as[r];
        for (int t = 0; t < kBK; ++t) s += ss[r * kBK + t] * vs[t * dh + d];
        acc[a] = s;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int x = tid + a * kThreads;
    if (x < R * dh) {
      const int r = x / dh, d = x - r * dh;
      const int i = row0 + r / G, h = kh * G + r % G;
      if (i < Sq) {
        const float l = ls[r];
        o[(((size_t)b * Sq + i) * H + h) * dh + d] =
            from_f32<T>(l > 0.f ? acc[a] / l : 0.f);
      }
    }
  }
  for (int r = tid; r < R; r += kThreads) {
    const int i = row0 + r / G, h = kh * G + r % G;
    if (i < Sq) {
      const float l = ls[r];
      lse[((size_t)b * H + h) * Sq + i] = l > 0.f ? ms[r] + logf(l) : INFINITY;
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* qoff,
           const void* kvlen, void* o, void* lse, int B, int Sq, int Skv,
           int H, int Kh, int dh, int bq, int causal, cudaStream_t stream) {
  const int R = bq * (H / Kh);
  const size_t smem =
      sizeof(float) * ((size_t)R * dh + (size_t)kBK * (dh + 1) +
                       (size_t)kBK * dh + (size_t)R * kBK + 3 * (size_t)R);
  auto kernel = flash_fwd_kernel<T>;
  allow_smem(kernel, smem);
  const float scale = (float)(1.0 / sqrt((double)dh));
  kernel<<<dim3((Sq + bq - 1) / bq, Kh, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)qoff,
      (const int*)kvlen, (T*)o, (float*)lse, Sq, Skv, H, Kh, dh, bq, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,Sq,H,dh), k/v (B,Skv,Kh,dh) of one type (f32 or bf16); q_offset
// and kv_len are int32 scalars in device memory -> o (B,Sq,H,dh) in q's
// type, lse (B,H,Sq) f32. bq*(H/Kh)*dh must fit the accumulators.
// Launches on `stream`; no sync, no allocation.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* qoff,
                                   const void* kvlen, void* o, void* lse,
                                   int B, int Sq, int Skv, int H, int Kh,
                                   int dh, int bq, int causal, int bf16,
                                   void* stream) {
  if (Kh < 1 || H % Kh != 0 || bq < 1 ||
      bq * (H / Kh) * dh > kThreads * kMaxAcc) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(q, k, v, qoff, kvlen, o, lse, B, Sq, Skv, H,
                                 Kh, dh, bq, causal, s);
  }
  return launch<float>(q, k, v, qoff, kvlen, o, lse, B, Sq, Skv, H, Kh, dh,
                       bq, causal, s);
}
