// Expert FFN over the padded (G, E, cap, d) capacity buffer of the
// gather/einsum dispatches, for Hopper (sm_90a):
//   y[g, e] = act(x[g, e] wi[e]) [* (x[g, e] wg[e])] wo[e].
//
// Replaces the TPU kernel src/repro/kernels/expert_mlp.py:79 (_kernel,
// reached through expert_ffn_pallas), which the reference vmaps over G.
//
// One thread block per (BM-row tile of one (g, e) segment, g, e); the
// grid runs the blocks of one expert together, so its weights stay in
// L2 while its G * cap rows pass. A block walks f in tiles of BF hidden
// columns, as the TPU grid does: it computes the (BM, BF) hidden tile
// h = act(x wi[:, tile]) [* x wg[:, tile]] into shared memory (f32) and
// adds h wo[tile, :] into the (BM, d) output, which stays in registers
// (32 x 768 f32 per block, 96 values a thread) across the f tiles and is
// rounded once to the output type at the end (the TPU kernel accumulated
// in the output block's own dtype). The (rows, f) hidden never reaches
// device memory. For d > DC the block makes one pass per DC output
// columns and recomputes h in each. Rows past cap (cap need not be a
// multiple of BM) read as zeros and are not written; zero rows (unfilled
// slots) give zero outputs, since act(0) = 0 for silu, tanh-gelu and
// squared relu.
//
// Bound on this card: operations. 4 * rows * d * f f32 FLOPs (6 gated)
// — 386.5 GFLOP at the ViT-B/16 MoE shapes (40,960 rows, d 768, f 3072),
// 5.77 ms at 67 TFLOP/s — against 0.6 GB of weights and activations
// (0.2 ms at 3.35 TB/s). The products run on CUDA cores in f32 from
// shared-memory tiles (8 x 4 and 8 x 12 register tiles a thread);
// tensor cores (wgmma on TMA-fed tiles, in TF32 or bf16) are later work.

#include "expert_tiles.cuh"

namespace {

template <typename T, bool kGated>
__global__ void __launch_bounds__(kThreads, 1)
    expert_ffn_kernel(const T* __restrict__ xe, const T* __restrict__ wi,
                      const T* __restrict__ wg, const T* __restrict__ wo,
                      T* __restrict__ out, int cap, int d, int f, int act) {
  extern __shared__ __align__(16) float smem[];
  float* ht = smem;           // [BF][XS]  hidden tile, transposed
  float* lt = ht + BF * XS;   // [BK][XS]  staged x chunk, transposed
  float* rs = lt + BK * XS;   // [BK][RS]  staged wi / wg chunk
  float* ws = lt;             // [BK2][WS2] staged wo chunk (reuses both)
  const int tid = threadIdx.x, ty = tid >> 6, tx = tid & 63;
  const int r0 = blockIdx.x * BM, g = blockIdx.y, e = blockIdx.z;
  const int E = gridDim.z;
  const int nrows = min(BM, cap - r0);
  const size_t row0 = ((size_t)g * E + e) * cap + r0;
  const T* x = xe + row0 * d;
  const T* wie = wi + (size_t)e * d * f;
  const T* wge = kGated ? wg + (size_t)e * d * f : nullptr;
  const T* woe = wo + (size_t)e * f * d;

  for (int c0 = 0; c0 < d; c0 += DC) {
    float y[8][12];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j) y[i][j] = 0.f;
    for (int f0 = 0; f0 < f; f0 += BF) {
      float p[8][4];
      tile_product<T, false>(p, x, nrows, wie, d, f, f0, lt, rs);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          ht[(tx * 4 + q) * XS + ty * 8 + i] = act_fn(p[i][q], act);
      if (kGated) {
        tile_product<T, false>(p, x, nrows, wge, d, f, f0, lt, rs);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            ht[(tx * 4 + q) * XS + ty * 8 + i] *= p[i][q];
      }
      out_product<T, false, false>(y, ht, woe, nullptr, nullptr, ws, nullptr,
                                   d, f, f0, c0);
    }
    store_rows<T>(out + row0 * d, y, nrows, d, c0);
  }
}

template <typename T, bool kGated>
int launch(const void* xe, const void* wi, const void* wg, const void* wo,
           void* out, int G, int E, int cap, int d, int f, int act,
           cudaStream_t stream) {
  constexpr int kProd = BK * XS + BK * RS, kOut = BK2 * WS2;
  const size_t smem =
      sizeof(float) * (size_t)(BF * XS + (kProd > kOut ? kProd : kOut));
  auto kernel = expert_ffn_kernel<T, kGated>;
  allow_smem(kernel, smem);
  const dim3 grid((cap + BM - 1) / BM, G, E);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)xe, (const T*)wi, (const T*)wg, (const T*)wo, (T*)out, cap,
      d, f, act);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* xe, const void* wi, const void* wg, const void* wo,
             void* out, int G, int E, int cap, int d, int f, int act,
             cudaStream_t s) {
  if (wg) return launch<T, true>(xe, wi, wg, wo, out, G, E, cap, d, f, act, s);
  return launch<T, false>(xe, wi, wg, wo, out, G, E, cap, d, f, act, s);
}

}  // namespace

// xe (G,E,cap,d), wi/wg (E,d,f) (wg may be null), wo (E,f,d) -> out
// (G,E,cap,d); all tensors of one dtype (f32 or bf16). Launches on
// `stream`; no sync, no allocation.
extern "C" int expert_mlp(const void* xe, const void* wi, const void* wg,
                          const void* wo, void* out, int G, int E, int cap,
                          int d, int f, int act, int bf16, void* stream) {
  if (G < 1 || E < 1 || cap < 1 || d < 1 || f < 1 ||
      (act < 0 || act > 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  if (bf16) {
    return launch_t<__nv_bfloat16>(xe, wi, wg, wo, out, G, E, cap, d, f, act,
                                   s);
  }
  return launch_t<float>(xe, wi, wg, wo, out, G, E, cap, d, f, act, s);
}
