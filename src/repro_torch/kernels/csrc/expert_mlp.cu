// Expert FFN over the padded (G, E, cap, d) capacity buffer of the
// gather/einsum dispatches, for Hopper (sm_90a):
//   y[g, e] = act(x[g, e] wi[e]) [* (x[g, e] wg[e])] wo[e].
//
// Replaces the TPU kernel src/repro/kernels/expert_mlp.py:79 (_kernel,
// reached through expert_ffn_pallas), which the reference vmaps over G.
//
// Bound on this card. 4 * rows * d * f FLOPs (6 gated) over every row of
// the buffer, and the weights read once. float32 products run on tensor
// cores as 3xTF32 (mma_sm90.cuh: f32 accuracy at three TF32 products),
// so the tensor-core bound is max(bytes / 3.35 TB/s, 3 * FLOPs / 495
// TFLOP/s); the CUDA-core bound, FLOPs / 67 TFLOP/s, is what an f32 FMA
// kernel could reach. At the main path's shapes:
//   ViT-B/16 MoE (5, 32, 256, 768), f 3072: 386.5 GFLOP, 0.6 GB —
//     2.34 ms on tensor cores (5.77 on CUDA cores);
//   rwkv6 MoE prefill (1, 32, 1024, 4096), f 14336: 7.70 TFLOP, 15.0 GB
//     of weights — 46.7 ms (115 ms);
//   rwkv6 MoE decode (1, 32, 8, 4096): 15.0 GB of weights, 4.49 ms;
//   granite static decode (1, 32, 4, 1024), f 512, gated: 201 MB, 0.060 ms.
// A decode step is bound by the weight bytes, a prefill or a training
// step by the products.
//
// Design: two passes inside one entry point, each a tensor-core GEMM over
// (row tile, column tile, expert) with the weights streamed through a
// 3-stage cp.async ring in shared memory (expert_gemm.cuh; the pass
// product of expert_ffn.cuh, which the ragged buffer's forward shares):
//   pass 1: h = act(x wi) [* x wg] into a float32 (G, E, cap, f) scratch
//           that the wrapper allocates;
//   pass 2: y = h wo, each block over the full depth f. For bf16 inputs
//           h stays f32 and is split for two TF32 products with the bf16
//           weights (rounding h to bf16 would add an error the size of
//           the bf16 tolerance).
// Every weight byte is read once a row tile (never recomputed for wide
// d), and the column tiles give every expert f/128 (pass 1) or d/128
// (pass 2) blocks, so at small capacity — one 16-row tile, rows past cap
// zero-filled — every SM streams weights (rwkv decode: 3,584 and 1,024
// blocks). At large capacity 64- or 128-row tiles feed each staged weight
// tile to many rows. The scratch costs 2 * rows * f * 4 bytes of traffic
// (3.76 GB, ~1.1 ms, at the rwkv prefill against >= 46.7 ms of products).
// Rows past cap are neither read nor written; zero rows (unfilled slots)
// give zero rows, since act(0) = 0 for silu, tanh-gelu and squared relu.

#include "expert_ffn.cuh"

namespace {

// One pass over one (BM-row tile of segment (g, e), BN-column tile,
// expert e) block (ffn_product): A and C hold G * E segments of cap
// rows; B and B2 are (E, K, N).
template <typename TA, typename TB, typename TC, int BM, int WM, int WN,
          bool kGated, bool kAct>
__global__ void __launch_bounds__(32 * WM * WN)
    ffn_gemm(const TA* __restrict__ A, const TB* __restrict__ B,
             const TB* __restrict__ B2, TC* __restrict__ C, int cap, int K,
             int N, int act, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ffn_product<TA, TB, TC, BM, WM, WN, kGated, kAct>(
      block_tile<BM>(cap, N), A, B, B2, C, K, N, act, aligned, smem_raw);
}

template <typename TA, typename TB, typename TC, int BM, int WM, int WN,
          bool kGated, bool kAct>
int launch_gemm(const TA* A, const TB* B, const TB* B2, TC* C, int G, int E,
                int cap, int K, int N, int act, cudaStream_t stream) {
  const size_t smem = ring_bytes<TA, TB, BM, kGated ? 2 : 1, false>();
  auto kernel = ffn_gemm<TA, TB, TC, BM, WM, WN, kGated, kAct>;
  allow_smem(kernel, smem);
  auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const bool aligned = K % (16 / sizeof(TA)) == 0 &&
                       N % (16 / sizeof(TB)) == 0 && al(A) && al(B) &&
                       (!kGated || al(B2));
  const dim3 grid(G * ((cap + BM - 1) / BM), (N + BN - 1) / BN, E);
  kernel<<<grid, 32 * WM * WN, smem, stream>>>(A, B, B2, C, cap, K, N, act,
                                              aligned);
  return (int)cudaGetLastError();
}

// Pass 1 then pass 2 at one row tiling; h is float32 for either T.
template <typename T, int BM, int WM, int WN>
int run(const T* xe, const T* wi, const T* wg, const T* wo, float* h, T* out,
        int G, int E, int cap, int d, int f, int act, cudaStream_t s) {
  const int rc =
      wg ? launch_gemm<T, T, float, BM, WM, WN, true, true>(
               xe, wi, wg, h, G, E, cap, d, f, act, s)
         : launch_gemm<T, T, float, BM, WM, WN, false, true>(
               xe, wi, nullptr, h, G, E, cap, d, f, act, s);
  if (rc != 0) return rc;
  return launch_gemm<float, T, T, BM, WM, WN, false, false>(
      h, wo, nullptr, out, G, E, cap, f, d, act, s);
}

// Row tiling by capacity: one 16-row tile (4 warps across the columns)
// at decode-sized cap, 64 rows (2 x 2 warps) in between, else 128 rows
// (4 x 2 warps); a warp holds 16 x 32 or 32 x 64 accumulators.
template <typename T>
int run_t(const void* xe, const void* wi, const void* wg, const void* wo,
          void* h, void* out, int G, int E, int cap, int d, int f, int act,
          cudaStream_t s) {
  auto args = [&](auto fn) {
    return fn((const T*)xe, (const T*)wi, (const T*)wg, (const T*)wo,
              (float*)h, (T*)out, G, E, cap, d, f, act, s);
  };
  if (cap <= 16) return args(run<T, 16, 1, 4>);
  if (cap <= 64) return args(run<T, 64, 2, 2>);
  return args(run<T, 128, 4, 2>);
}

}  // namespace

// xe (G,E,cap,d), wi/wg (E,d,f) (wg may be null), wo (E,f,d) -> out
// (G,E,cap,d), through the f32 scratch h (G,E,cap,f); all tensors but h
// of one dtype (f32 or bf16). Two launches on `stream`; no sync, no
// allocation.
extern "C" int expert_mlp(const void* xe, const void* wi, const void* wg,
                          const void* wo, void* h, void* out, int G, int E,
                          int cap, int d, int f, int act, int bf16,
                          void* stream) {
  if (G < 1 || E < 1 || cap < 1 || d < 1 || f < 1 || E > 65535 ||
      (f + BN - 1) / BN > 65535 || (d + BN - 1) / BN > 65535 ||
      (act < 0 || act > 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  if (bf16) {
    return run_t<__nv_bfloat16>(xe, wi, wg, wo, h, out, G, E, cap, d, f, act,
                                s);
  }
  return run_t<float>(xe, wi, wg, wo, h, out, G, E, cap, d, f, act, s);
}
