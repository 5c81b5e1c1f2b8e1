// Dense GQA flash-attention backward for Hopper (sm_90a): two kernels,
// dq and dk/dv, sharing the forward's masking and recomputing each
// probability tile from (q, k, lse) instead of storing it.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py:256
// (_dq_kernel) and :285 (_dkv_kernel), reached through
// _flash_attention_pallas_bwd; each tile pair recomputes, as
// _recompute_p_ds does,
//   p  = exp(q k^T * scale - lse)   (0 where masked),
//   ds = p * (dO v^T - delta),      delta = rowsum(dO * O) (given).
//
// dq: one thread block per (q tile of bq rows, kv head, batch), R = bq*G
// rows as in the forward; it walks the live kv tiles (the forward's
// causal limit) and accumulates dq = scale * ds k in registers.
// dk/dv: one thread block per (kv tile of bkv keys, kv head, batch); it
// walks every q tile that can see the kv tile (causal: those ending at
// or past its first key) with all G query heads of the group at once,
// accumulating dv = p^T dO and dk = scale * ds^T q in registers. The GQA
// sum happens inside the block: no per-head buffers, no atomics. A kv
// tile past kv_len, or never seen, writes zeros. Rows with lse = +inf
// (no valid key) and padded rows (dO = 0, delta = 0) contribute zero.
//
// Bound on this card: f32 FLOPs over the live pairs — dq recomputes s
// and dO v^T and forms ds k (6*dh a pair), dk/dv adds ds^T q and p^T dO
// (8*dh): 0.19 and 0.26 ms at the training shapes at 67 TFLOP/s. These
// kernels run the products on CUDA cores from shared memory; tensor
// cores are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxAcc = 16;  // R*dh <= kThreads*kMaxAcc (dq rows)
constexpr int kBK = 64;      // keys per kv tile in the dq walk
constexpr int kMaxKV = 16;   // bkv*dh <= kThreads*kMaxKV (dk and dv each)

// Is key `pos` valid for query row i?
__device__ __forceinline__ bool key_ok(int pos, int i, int Sq, int kvlen,
                                       int qoff, int causal) {
  return i < Sq && pos < kvlen && (!causal || pos <= qoff + i);
}

template <typename T>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* src,
                                              int row0, int nrows, int G,
                                              int kh, int Sq, int H, int dh,
                                              size_t bbase) {
  // src[b, row0 + i, kh*G + g, :] -> dst[(i*G + g)*dh + d]; rows past Sq
  // are zero.
  for (int x = threadIdx.x; x < nrows * dh; x += kThreads) {
    const int r = x / dh, d = x - r * dh;
    const int i = row0 + r / G, h = kh * G + r % G;
    dst[x] = i < Sq ? to_f32(src[((bbase + i) * H + h) * dh + d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ qoff_p,
                    const int* __restrict__ kvlen_p, T* __restrict__ dq,
                    int Sq, int Skv, int H, int Kh, int dh, int bq,
                    int causal, float scale) {
  extern __shared__ float smem[];
  const int qi = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = H / Kh, R = bq * G;
  const int ldk = dh + 1;
  float* qs = smem;              // [R][dh]
  float* dos = qs + R * dh;      // [R][dh]
  float* ks = dos + R * dh;      // [kBK][dh+1]
  float* vs = ks + kBK * ldk;    // [kBK][dh+1]
  float* ss = vs + kBK * ldk;    // [R][kBK]  ds
  float* lses = ss + R * kBK;    // [R]
  float* dels = lses + R;        // [R]

  const int qoff = *qoff_p;
  const int kvlen = min(*kvlen_p, Skv);
  const int row0 = qi * bq;
  load_rows_f32(qs, q, row0, R, G, kh, Sq, H, dh, (size_t)b * Sq);
  load_rows_f32(dos, dout, row0, R, G, kh, Sq, H, dh, (size_t)b * Sq);
  for (int r = tid; r < R; r += kThreads) {
    const int i = row0 + r / G, h = kh * G + r % G;
    const size_t at = ((size_t)b * H + h) * Sq + i;
    lses[r] = i < Sq ? lse[at] : INFINITY;
    dels[r] = i < Sq ? delta[at] : 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.f;
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
      vs[t * ldk + d] = vx;
    }
    __syncthreads();
    for (int x = tid; x < R * kBK; x += kThreads) {
      const int r = x / kBK, t = x - r * kBK;
      const int i = row0 + r / G;
      float ds = 0.f;
      if (key_ok(kv0 + t, i, Sq, kvlen, qoff, causal)) {
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < dh; ++d) {
          s += qs[r * dh + d] * ks[t * ldk + d];
          dp += dos[r * dh + d] * vs[t * ldk + d];
        }
        const float p = expf(s * scale - lses[r]);
        ds = p * (dp - dels[r]);
      }
      ss[x] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int x = tid + a * kThreads;
      if (x < R * dh) {
        const int r = x / dh, d = x - r * dh;
        float s = acc[a];
        for (int t = 0; t < kBK; ++t) s += ss[r * kBK + t] * ks[t * ldk + d];
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
        dq[(((size_t)b * Sq + i) * H + h) * dh + d] =
            from_f32<T>(acc[a] * scale);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ qoff_p,
                     const int* __restrict__ kvlen_p, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Skv, int H, int Kh,
                     int dh, int bq, int bkv, int causal, float scale) {
  extern __shared__ float smem[];
  const int ki = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = H / Kh, R = bq * G;
  const int ldk = dh + 1;
  float* qs = smem;              // [R][dh]
  float* dos = qs + R * dh;      // [R][dh]
  float* ks = dos + R * dh;      // [bkv][dh+1]
  float* vs = ks + bkv * ldk;    // [bkv][dh+1]
  float* ps = vs + bkv * ldk;    // [R][bkv]  p
  float* dss = ps + R * bkv;     // [R][bkv]  ds
  float* lses = dss + R * bkv;   // [R]
  float* dels = lses + R;        // [R]

  const int qoff = *qoff_p;
  const int kvlen = min(*kvlen_p, Skv);
  const int kv0 = ki * bkv;
  for (int x = tid; x < bkv * dh; x += kThreads) {
    const int t = x / dh, d = x - t * dh;
    float kx = 0.f, vx = 0.f;
    if (kv0 + t < Skv) {
      const size_t off = (((size_t)b * Skv + kv0 + t) * Kh + kh) * dh + d;
      kx = to_f32(k[off]);
      vx = to_f32(v[off]);
    }
    ks[t * ldk + d] = kx;
    vs[t * ldk + d] = vx;
  }
  float dk_acc[kMaxKV], dv_acc[kMaxKV];
#pragma unroll
  for (int a = 0; a < kMaxKV; ++a) dk_acc[a] = dv_acc[a] = 0.f;
  // q tiles that can see this kv tile: all of them unless causal, then
  // those whose last row sits at or past the tile's first key.
  const int nq = (Sq + bq - 1) / bq;
  int qi0 = 0;
  if (causal) qi0 = max(0, kv0 - qoff) / bq;
  if (kv0 >= kvlen) qi0 = nq;  // the whole tile is past kv_len

  for (int qi = qi0; qi < nq; ++qi) {
    const int row0 = qi * bq;
    __syncthreads();  // the previous tile's reads of qs/dos/ps/dss
    load_rows_f32(qs, q, row0, R, G, kh, Sq, H, dh, (size_t)b * Sq);
    load_rows_f32(dos, dout, row0, R, G, kh, Sq, H, dh, (size_t)b * Sq);
    for (int r = tid; r < R; r += kThreads) {
      const int i = row0 + r / G, h = kh * G + r % G;
      const size_t at = ((size_t)b * H + h) * Sq + i;
      lses[r] = i < Sq ? lse[at] : INFINITY;
      dels[r] = i < Sq ? delta[at] : 0.f;
    }
    __syncthreads();
    for (int x = tid; x < R * bkv; x += kThreads) {
      const int r = x / bkv, t = x - r * bkv;
      const int i = row0 + r / G;
      float p = 0.f, ds = 0.f;
      if (key_ok(kv0 + t, i, Sq, kvlen, qoff, causal)) {
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < dh; ++d) {
          s += qs[r * dh + d] * ks[t * ldk + d];
          dp += dos[r * dh + d] * vs[t * ldk + d];
        }
        p = expf(s * scale - lses[r]);
        ds = p * (dp - dels[r]);
      }
      ps[x] = p;
      dss[x] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kMaxKV; ++a) {
      const int x = tid + a * kThreads;
      if (x < bkv * dh) {
        const int t = x / dh, d = x - t * dh;
        float sv = dv_acc[a], sk = dk_acc[a];
        for (int r = 0; r < R; ++r) {
          sv += ps[r * bkv + t] * dos[r * dh + d];
          sk += dss[r * bkv + t] * qs[r * dh + d];
        }
        dv_acc[a] = sv;
        dk_acc[a] = sk;
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kMaxKV; ++a) {
    const int x = tid + a * kThreads;
    if (x < bkv * dh) {
      const int t = x / dh, d = x - t * dh;
      if (kv0 + t < Skv) {
        const size_t off = (((size_t)b * Skv + kv0 + t) * Kh + kh) * dh + d;
        dk[off] = from_f32<T>(dk_acc[a] * scale);
        dv[off] = from_f32<T>(dv_acc[a]);
      }
    }
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* qoff,
              const void* kvlen, void* dq, int B, int Sq, int Skv, int H,
              int Kh, int dh, int bq, int causal, cudaStream_t stream) {
  const int R = bq * (H / Kh);
  const size_t smem =
      sizeof(float) * (2 * (size_t)R * dh + 2 * (size_t)kBK * (dh + 1) +
                       (size_t)R * kBK + 2 * (size_t)R);
  auto kernel = flash_dq_kernel<T>;
  allow_smem(kernel, smem);
  const float scale = (float)(1.0 / sqrt((double)dh));
  kernel<<<dim3((Sq + bq - 1) / bq, Kh, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (const int*)qoff,
      (const int*)kvlen, (T*)dq, Sq, Skv, H, Kh, dh, bq, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* qoff,
               const void* kvlen, void* dk, void* dv, int B, int Sq, int Skv,
               int H, int Kh, int dh, int bq, int bkv, int causal,
               cudaStream_t stream) {
  const int R = bq * (H / Kh);
  const size_t smem =
      sizeof(float) * (2 * (size_t)R * dh + 2 * (size_t)bkv * (dh + 1) +
                       2 * (size_t)R * bkv + 2 * (size_t)R);
  auto kernel = flash_dkv_kernel<T>;
  allow_smem(kernel, smem);
  const float scale = (float)(1.0 / sqrt((double)dh));
  kernel<<<dim3((Skv + bkv - 1) / bkv, Kh, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (const int*)qoff,
      (const int*)kvlen, (T*)dk, (T*)dv, Sq, Skv, H, Kh, dh, bq, bkv, causal,
      scale);
  return (int)cudaGetLastError();
}

bool shapes_ok(int H, int Kh, int dh, int bq) {
  return Kh >= 1 && H % Kh == 0 && bq >= 1 &&
         bq * (H / Kh) * dh <= kThreads * kMaxAcc;
}

}  // namespace

// q, dout (B,Sq,H,dh), k/v (B,Skv,Kh,dh) of one type (f32 or bf16);
// lse, delta (B,H,Sq) f32; q_offset, kv_len int32 scalars in device
// memory -> dq (B,Sq,H,dh). Launches on `stream`.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* qoff,
                                  const void* kvlen, void* dq, int B, int Sq,
                                  int Skv, int H, int Kh, int dh, int bq,
                                  int causal, int bf16, void* stream) {
  if (!shapes_ok(H, Kh, dh, bq)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = torch_stream(stream);
  if (bf16) {
    return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, qoff, kvlen,
                                    dq, B, Sq, Skv, H, Kh, dh, bq, causal, s);
  }
  return launch_dq<float>(q, k, v, dout, lse, delta, qoff, kvlen, dq, B, Sq,
                          Skv, H, Kh, dh, bq, causal, s);
}

// As flash_attention_dq -> dk, dv (B,Skv,Kh,dh); bkv keys per block,
// bkv*dh <= 2048.
extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* qoff, const void* kvlen,
                                   void* dk, void* dv, int B, int Sq, int Skv,
                                   int H, int Kh, int dh, int bq, int bkv,
                                   int causal, int bf16, void* stream) {
  if (!shapes_ok(H, Kh, dh, bq) || bkv < 1 ||
      bkv * dh > kThreads * kMaxKV) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  if (bf16) {
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, qoff, kvlen,
                                     dk, dv, B, Sq, Skv, H, Kh, dh, bq, bkv,
                                     causal, s);
  }
  return launch_dkv<float>(q, k, v, dout, lse, delta, qoff, kvlen, dk, dv, B,
                           Sq, Skv, H, Kh, dh, bq, bkv, causal, s);
}
