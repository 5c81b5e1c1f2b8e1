// RWKV-6 ("Finch") WKV forward and final state for Hopper (sm_90a):
//   o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_kernel.py:31 (_kernel,
// reached through rwkv6_pallas). The TPU kernel walks the sequence in
// chunks of c steps and rewrites the recurrence as MXU matmuls over a
// (c, c, K) tensor of decay ratios built from log-space cumulative
// products. On Hopper's CUDA cores the recurrence itself is the simple
// and exact form, so this kernel runs it step by step:
//
// One thread block per (b, h), one thread per value column j of the
// (K, V) state (the block is V threads rounded up to a warp; the extra
// lanes only help with loads). Thread j keeps S[:, j], K floats, in
// registers for the whole sequence. The block stages r, k, w (K floats a
// step) and v (V floats a step) of kTile steps at a time in shared
// memory, loaded coalesced (each (b, t, h) row is contiguous) and
// converted to f32 on load; u[h] is loaded once. Each step a thread reads
// r_i, k_i, w_i, u_i as shared-memory broadcasts, four channels to a
// 16-byte load (every lane reads the same address: no bank conflicts),
// and its own v_j, computes
//   kv_i = k_i v_j;  o += r_i (S_i + u_i kv_i);  S_i = w_i S_i + kv_i
// over i < K, and writes o[b, t, h, j] in v's type (coalesced over j).
// The final S goes to the f32 state output. There is no chunking and so
// no padding: T = 1 (a decode step) and T not a multiple of 64 take the
// same path.
//
// Decay: w lies in (0, 1). The reference's chunked forms clip it to
// [1e-12, 1] before taking its log; the sequential oracle (rwkv6_ref)
// does not, and neither does this kernel. Where w < 1e-12 the two differ
// by at most 1e-12 |S|, far under any tolerance used for them.
//
// Bound on this card: bytes. Each (b, t, h) reads 3K + V inputs and
// writes V outputs, against about 4 K V FLOPs: at (B, T, H, K, V) =
// (8, 512, 64, 64, 64) in f32 that is 352 MB (0.105 ms at 3.35 TB/s)
// against 4.3 GFLOP (0.064 ms at 67 TFLOP/s). With one (b, h) a block
// the card holds only B*H blocks of V threads (512 blocks of 2 warps
// there), so the staging runs at the memory's latency rather than its
// rate: the loads are unrolled to keep several in flight. Splitting the
// state over four thread groups (four times the warps, the partial
// outputs summed through shared memory) measured slower on the card.
// Double-buffered staging (cp.async) is later work.

#include "common.cuh"

namespace {

constexpr int kTile = 32;  // timesteps staged in shared memory per pass

template <typename T, int K>
__global__ void wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ w,
                            const float* __restrict__ u,
                            const float* __restrict__ s0, T* __restrict__ o,
                            float* __restrict__ s_out, int T_, int H,
                            int V) {
  extern __shared__ __align__(16) float smem[];
  float* us = smem;            // [K]
  float* rs = us + K;          // [kTile][K]
  float* ks = rs + kTile * K;  // [kTile][K]
  float* ws = ks + kTile * K;  // [kTile][K]
  float* vs = ws + kTile * K;  // [kTile][V]
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int j = threadIdx.x, nt = blockDim.x;
  const bool live = j < V;

  for (int i = j; i < K; i += nt) us[i] = u[(size_t)h * K + i];
  const size_t sbase = (size_t)bh * K * V;
  float S[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    S[i] = (s0 != nullptr && live) ? s0[sbase + (size_t)i * V + j] : 0.f;
  }

  for (int t0 = 0; t0 < T_; t0 += kTile) {
    const int nstep = min(kTile, T_ - t0);
    __syncthreads();  // the previous tile has been consumed
#pragma unroll 4
    for (int e = j; e < nstep * K; e += nt) {
      const int t = e / K, i = e - t * K;
      const size_t off = (((size_t)b * T_ + t0 + t) * H + h) * K + i;
      rs[e] = to_f32(r[off]);
      ks[e] = to_f32(k[off]);
      ws[e] = w[off];
    }
#pragma unroll 4
    for (int e = j; e < nstep * V; e += nt) {
      const int t = e / V, c = e - t * V;
      vs[e] = to_f32(v[(((size_t)b * T_ + t0 + t) * H + h) * V + c]);
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < nstep; ++t) {
      const float vj = vs[t * V + j];
      const float* rt = rs + t * K;
      const float* kt = ks + t * K;
      const float* wt = ws + t * K;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i4 = 0; i4 < K; i4 += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rt + i4);
        const float4 k4 = *reinterpret_cast<const float4*>(kt + i4);
        const float4 w4 = *reinterpret_cast<const float4*>(wt + i4);
        const float4 u4 = *reinterpret_cast<const float4*>(us + i4);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i4 + q;
          const float kv = kk[q] * vj;
          acc[q] += rr[q] * (S[i] + uu[q] * kv);
          S[i] = ww[q] * S[i] + kv;
        }
      }
      o[(((size_t)b * T_ + t0 + t) * H + h) * V + j] =
          from_f32<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < K; ++i) s_out[sbase + (size_t)i * V + j] = S[i];
  }
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* o, void* s_out, int B,
           int T_, int H, int V, cudaStream_t stream) {
  const int threads = ((V + 31) / 32) * 32;
  const size_t smem =
      sizeof(float) * ((size_t)K + 3 * (size_t)kTile * K + (size_t)kTile * V);
  auto kernel = wkv6_kernel<T, K>;
  allow_smem(kernel, smem);
  kernel<<<B * H, threads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w,
      (const float*)u, (const float*)s0, (T*)o, (float*)s_out, T_, H, V);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* o, void* s_out, int B,
             int T_, int H, int K, int V, cudaStream_t s) {
  switch (K) {
    case 8:
      return launch<T, 8>(r, k, v, w, u, s0, o, s_out, B, T_, H, V, s);
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, o, s_out, B, T_, H, V, s);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, o, s_out, B, T_, H, V, s);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, o, s_out, B, T_, H, V, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k (B,T,H,K) and v (B,T,H,V) in one type (f32 or bf16, `bf16` says
// which); w (B,T,H,K), u (H,K), s0 (B,H,K,V) or null (zeros) in f32 ->
// o (B,T,H,V) in v's type, s_out (B,H,K,V) f32. K in {8, 16, 32, 64},
// 1 <= V <= 1024. Launches on `stream`; no sync, no allocation.
extern "C" int rwkv6_fwd(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         void* o, void* s_out, int B, int T_, int H, int K,
                         int V, int bf16, void* stream) {
  if (B < 1 || H < 1 || T_ < 0 || V < 1 || V > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  return bf16 ? dispatch<__nv_bfloat16>(r, k, v, w, u, s0, o, s_out, B, T_,
                                        H, K, V, s)
              : dispatch<float>(r, k, v, w, u, s0, o, s_out, B, T_, H, K, V,
                                s);
}
