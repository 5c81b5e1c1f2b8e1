// Grouped-GEMM expert FFN over the expert-sorted, block-aligned ragged
// token buffer, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/grouped_mlp.py:225
// (_fwd_kernel, reached through _grouped_mlp_pallas_tables).
//
// One thread block per (row block m of BM rows, group g); the block's
// expert comes from the block_expert table and dead blocks
// (block_live == 0: tail blocks, an empty expert's one block) write
// zeros and read nothing. A live block stages its BM x d input rows in
// shared memory (transposed, as f32), then
//   phase 1: h = act(x @ wi) * (x @ wg) into shared memory (f32), each
//            thread owning 2 hidden columns for all BM rows, streaming
//            wi/wg rows from device memory once;
//   phase 2: y = h @ wo, each thread owning 4 output columns for all BM
//            rows, streaming wo once; written in the output dtype.
// Accumulation is f32 for f32 and bf16 weights; activation silu or
// tanh-gelu; the gate is optional.
//
// Bound on this card: the expert weights of the live experts (3*d*f
// values each) — 201 MB per layer at the f32 serve shapes, ~60 us at
// 3.35 TB/s. This kernel streams an expert's weights once per live row
// block (from L2 when blocks of one expert run together) and computes on
// CUDA cores in f32: its FLOPs (2*3*BM*d*f per block) put it near the
// f32 ridge. Tensor cores (wgmma with TMA-fed weight tiles, several row
// blocks per weight tile) are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BM = 16;    // rows per block (ROW_BLOCK in grouped_mlp.py)
constexpr int kHid = 2;   // hidden columns per thread, phase 1
constexpr int kOut = 4;   // output columns per thread, phase 2

__device__ __forceinline__ void load_rows(const float* __restrict__ p,
                                          float v[BM]) {
#pragma unroll
  for (int r = 0; r < BM; r += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + r);
    v[r] = t.x;
    v[r + 1] = t.y;
    v[r + 2] = t.z;
    v[r + 3] = t.w;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    grouped_mlp_kernel(const T* __restrict__ xs, const T* __restrict__ wi,
                       const T* __restrict__ wg, const T* __restrict__ wo,
                       const int* __restrict__ block_expert,
                       const int* __restrict__ block_live,
                       T* __restrict__ out, int M, int d, int f, int act) {
  extern __shared__ __align__(16) float smem[];
  float* xT = smem;          // [d][BM]  x transposed
  float* hT = xT + d * BM;   // [f][BM]  hidden transposed
  const int m = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int nb = M / BM;
  const size_t row0 = (size_t)g * M + (size_t)m * BM;
  T* o = out + row0 * d;
  if (!block_live[(size_t)g * nb + m]) {
    for (int i = tid; i < BM * d; i += kThreads) o[i] = from_f32<T>(0.f);
    return;
  }
  const int e = block_expert[(size_t)g * nb + m];
  const T* x = xs + row0 * d;
  for (int i = tid; i < BM * d; i += kThreads) {
    const int k = i / BM, r = i - k * BM;  // neighbours write neighbours
    xT[i] = to_f32(x[(size_t)r * d + k]);
  }
  __syncthreads();

  // phase 1: hT[c][r] = act(sum_k x[r][k] wi[k][c]) * sum_k x[r][k] wg[k][c]
  const T* wie = wi + (size_t)e * d * f;
  const T* wge = wg ? wg + (size_t)e * d * f : nullptr;
  for (int c0 = 0; c0 < f; c0 += kThreads * kHid) {
    float a[kHid][BM], b[kHid][BM];
#pragma unroll
    for (int j = 0; j < kHid; ++j)
#pragma unroll
      for (int r = 0; r < BM; ++r) a[j][r] = b[j][r] = 0.f;
    int col[kHid];
    bool ok[kHid];
#pragma unroll
    for (int j = 0; j < kHid; ++j) {
      col[j] = c0 + tid + j * kThreads;
      ok[j] = col[j] < f;
    }
#pragma unroll 8
    for (int k = 0; k < d; ++k) {
      float xv[BM];
      load_rows(xT + k * BM, xv);
#pragma unroll
      for (int j = 0; j < kHid; ++j) {
        if (!ok[j]) continue;
        const float w1 = to_f32(wie[(size_t)k * f + col[j]]);
#pragma unroll
        for (int r = 0; r < BM; ++r) a[j][r] += xv[r] * w1;
        if (wge) {
          const float w2 = to_f32(wge[(size_t)k * f + col[j]]);
#pragma unroll
          for (int r = 0; r < BM; ++r) b[j][r] += xv[r] * w2;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kHid; ++j) {
      if (!ok[j]) continue;
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float h = act_fn(a[j][r], act);
        hT[col[j] * BM + r] = wge ? h * b[j][r] : h;
      }
    }
  }
  __syncthreads();

  // phase 2: y[r][c] = sum_k hT[k][r] wo[k][c]
  const T* woe = wo + (size_t)e * f * d;
  for (int c0 = 0; c0 < d; c0 += kThreads * kOut) {
    float y[kOut][BM];
#pragma unroll
    for (int j = 0; j < kOut; ++j)
#pragma unroll
      for (int r = 0; r < BM; ++r) y[j][r] = 0.f;
    int col[kOut];
    bool ok[kOut];
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      col[j] = c0 + tid + j * kThreads;
      ok[j] = col[j] < d;
    }
#pragma unroll 8
    for (int k = 0; k < f; ++k) {
      float hv[BM];
      load_rows(hT + k * BM, hv);
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        if (!ok[j]) continue;
        const float w = to_f32(woe[(size_t)k * d + col[j]]);
#pragma unroll
        for (int r = 0; r < BM; ++r) y[j][r] += hv[r] * w;
      }
    }
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      if (!ok[j]) continue;
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        o[(size_t)r * d + col[j]] = from_f32<T>(y[j][r]);
      }
    }
  }
}

template <typename T>
int launch(const void* xs, const void* wi, const void* wg, const void* wo,
           const void* be, const void* bl, void* out, int G, int M, int d,
           int f, int act, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)BM * (d + f);
  auto kernel = grouped_mlp_kernel<T>;
  allow_smem(kernel, smem);
  kernel<<<dim3(M / BM, G), kThreads, smem, stream>>>(
      (const T*)xs, (const T*)wi, (const T*)wg, (const T*)wo, (const int*)be,
      (const int*)bl, (T*)out, M, d, f, act);
  return (int)cudaGetLastError();
}

}  // namespace

// xs (G,M,d), wi/wg (E,d,f) (wg may be null), wo (E,f,d), block tables
// (G, M/BM) int32 -> out (G,M,d); all tensors of one dtype (f32 or bf16).
// Launches on `stream`; no sync, no allocation.
extern "C" int grouped_mlp(const void* xs, const void* wi, const void* wg,
                           const void* wo, const void* be, const void* bl,
                           void* out, int G, int M, int d, int f, int E,
                           int act, int bf16, void* stream) {
  if (M % BM != 0 || E < 1 || (act != 0 && act != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(xs, wi, wg, wo, be, bl, out, G, M, d, f,
                                 act, s);
  }
  return launch<float>(xs, wi, wg, wo, be, bl, out, G, M, d, f, act, s);
}
