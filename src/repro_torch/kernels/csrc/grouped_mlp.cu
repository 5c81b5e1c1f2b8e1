// Grouped-GEMM expert FFN over the expert-sorted, block-aligned ragged
// token buffer, for Hopper (sm_90a):
//   y[rows of expert e's segment] = act(x wi[e]) [* (x wg[e])] wo[e].
//
// Replaces the TPU kernel src/repro/kernels/grouped_mlp.py:225
// (_fwd_kernel, reached through _grouped_mlp_pallas_tables).
//
// Design: the expert forward's two passes (expert_mlp.cu), each a
// tensor-core GEMM (expert_gemm.cuh: 3xTF32 mma.sync for float32, bf16
// products for bf16) over (row tile, 128-column tile) blocks of one
// expert's segment:
//   pass 1: h = act(x wi) [* x wg] into a float32 (G, M, f) scratch that
//           the wrapper allocates;
//   pass 2: y = h wo. For bf16 inputs h stays f32 and is split for two
//           TF32 products with the bf16 weights, as in expert_mlp.cu.
// A row tile is BM in {16, 64, 128} rows: up to BM / 16 consecutive live
// 16-row blocks of one segment, the last tile ragged, so each staged
// weight slab feeds all of them (the CUDA-core kernel this replaces read
// an expert's whole wi, wg and wo once per 16-row block). The wrapper
// picks BM from static shapes (the average segment length). The grid is
// static, ceil(M / BM) + E slots a group (an upper bound on the live
// tiles); each block finds its tile on the device from the group sizes
// (ragged_tile: a warp's scan of the sizes, no table, no host read).
// Slots past the live tiles exit in pass 1 and, in pass 2, zero-fill the
// output rows of the dead blocks (an empty expert's block, the blocks
// past the last segment), so every row of the output is written. Padded
// rows of a live block are zero in, so zero comes out (act(0) = 0).
//
// Bound on this card: the weights of the live experts (3 d f values
// each) read once, the valid rows read, every row of the output written;
// 6 d f FLOPs a valid row (4 ungated), 3 x that on the tensor cores for
// float32 (3 x FLOPs / 495 TFLOP/s), 67 TFLOP/s on CUDA cores. At
// granite's shapes (d 1024, f 512, gated, 32 experts): the serve step's
// buffer (1,088 assignments) is bound by the weight bytes, 0.054 ms; the
// training buffer (two groups of 33,280 rows, 16,128 valid) by the
// products, 0.307 ms (0.757 for f32 FMAs).

#include "expert_ffn.cuh"

namespace {

// One pass over ragged tiles (ffn_product): kAct: C = act(A B) [* A B2]
// (pass 1), else C = A B (pass 2), whose spare slots zero-fill the dead
// blocks' rows of C. A, C: (G, M, K) / (G, M, N); B, B2: (E, K, N);
// sizes: (G, E) int32. The tile table lives in the ring's memory: only
// spare slots read it, and they stage nothing.
template <typename TA, typename TB, typename TC, int BM, int WM, int WN,
          bool kGated, bool kAct>
__global__ void __launch_bounds__(32 * WM * WN)
    grouped_mlp_kernel(const TA* __restrict__ A, const TB* __restrict__ B,
                       const TB* __restrict__ B2, TC* __restrict__ C,
                       const int* __restrict__ sizes, int M, int E, int K,
                       int N, int act, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* row_off = reinterpret_cast<int*>(smem_raw);
  const RaggedTile rt =
      ragged_tile<BM>(sizes, M, E, N, kAct ? nullptr : row_off);
  if (rt.t.nrows > 0) {
    ffn_product<TA, TB, TC, BM, WM, WN, kGated, kAct>(
        rt.t, A, B, B2, C, K, N, act, aligned, smem_raw);
  } else if (!kAct && rt.spare >= 0) {
    const size_t g = blockIdx.z;
    zero_dead_blocks<TC, 32 * WM * WN>(C + g * M * N, sizes + g * E, row_off,
                                       M, E, N, rt.t.n0, rt.t.ncols,
                                       rt.spare, rt.nspare);
  }
}

template <typename TA, typename TB, typename TC, int BM, int WM, int WN,
          bool kGated, bool kAct>
int launch_pass(const TA* A, const TB* B, const TB* B2, TC* C,
                const int* sizes, int G, int M, int E, int slots, int K,
                int N, int act, cudaStream_t stream) {
  constexpr size_t smem = ring_bytes<TA, TB, BM, kGated ? 2 : 1, false>();
  if ((size_t)(E + 1) * sizeof(int) > smem) return (int)cudaErrorInvalidValue;
  auto kernel = grouped_mlp_kernel<TA, TB, TC, BM, WM, WN, kGated, kAct>;
  allow_smem(kernel, smem);
  auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const bool aligned = K % (16 / sizeof(TA)) == 0 &&
                       N % (16 / sizeof(TB)) == 0 && al(A) && al(B) &&
                       (!kGated || al(B2));
  const dim3 grid(slots, (N + BN - 1) / BN, G);
  kernel<<<grid, 32 * WM * WN, smem, stream>>>(A, B, B2, C, sizes, M, E, K,
                                              N, act, aligned);
  return (int)cudaGetLastError();
}

// Pass 1 then pass 2 at one row tiling; h is float32 for either T. The
// gated pass 1 holds two sums a warp: below 128 rows it runs twice the
// warps across the columns, each holding half the columns (at 64 rows
// the f32 pass then fits 233 registers instead of spilling 252 bytes at
// 255; same bits, 15% faster at the serve step on an H100). At 128 rows
// the 512 threads would be held to 128 registers and spill more.
template <typename T, int BM, int WM, int WN>
int run(const T* xs, const T* wi, const T* wg, const T* wo, const int* sizes,
        float* h, T* out, int G, int M, int E, int slots, int d, int f,
        int act, cudaStream_t s) {
  constexpr int kGatedWN = BM < 128 ? 2 * WN : WN;
  const int rc =
      wg ? launch_pass<T, T, float, BM, WM, kGatedWN, true, true>(
               xs, wi, wg, h, sizes, G, M, E, slots, d, f, act, s)
         : launch_pass<T, T, float, BM, WM, WN, false, true>(
               xs, wi, nullptr, h, sizes, G, M, E, slots, d, f, act, s);
  if (rc != 0) return rc;
  return launch_pass<float, T, T, BM, WM, WN, false, false>(
      h, wo, nullptr, out, sizes, G, M, E, slots, f, d, act, s);
}

// The row tilings, as the expert forward's: 16 rows (4 warps across the
// columns), 64 rows (2 x 2 warps), 128 rows (4 x 2 warps); a warp holds
// 16 x 32 or 32 x 64 sums (the gated pass 1 below 128 rows: see run).
template <typename T>
int run_t(const void* xs, const void* wi, const void* wg, const void* wo,
          const void* sizes, void* h, void* out, int G, int M, int E,
          int slots, int d, int f, int act, int bm, cudaStream_t s) {
  auto args = [&](auto fn) {
    return fn((const T*)xs, (const T*)wi, (const T*)wg, (const T*)wo,
              (const int*)sizes, (float*)h, (T*)out, G, M, E, slots, d, f,
              act, s);
  };
  if (bm == 16) return args(run<T, 16, 1, 4>);
  if (bm == 64) return args(run<T, 64, 2, 2>);
  return args(run<T, 128, 4, 2>);
}

}  // namespace

// xs (G,M,d), wi/wg (E,d,f) (wg may be null), wo (E,f,d), group sizes
// (G,E) int32 -> out (G,M,d), through the f32 scratch h (G,M,f); all
// tensors but h and the sizes of one dtype (f32 or bf16). bm: the row
// tile (16, 64 or 128); slots: tiles a group, at least ceil(M/bm) + E.
// Two launches on `stream`; no sync, no allocation.
extern "C" int grouped_mlp(const void* xs, const void* wi, const void* wg,
                           const void* wo, const void* sizes, void* h,
                           void* out, int G, int M, int d, int f, int E,
                           int act, int bf16, int bm, int slots,
                           void* stream) {
  if (G < 1 || M < 1 || M % kRowBlock != 0 || d < 1 || f < 1 || E < 1 ||
      G > 65535 || (act != 0 && act != 1) ||
      (bm != 16 && bm != 64 && bm != 128) ||
      slots < (M + bm - 1) / bm + E || (f + BN - 1) / BN > 65535 ||
      (d + BN - 1) / BN > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  if (bf16) {
    return run_t<__nv_bfloat16>(xs, wi, wg, wo, sizes, h, out, G, M, E,
                                slots, d, f, act, bm, s);
  }
  return run_t<float>(xs, wi, wg, wo, sizes, h, out, G, M, E, slots, d, f,
                      act, bm, s);
}
