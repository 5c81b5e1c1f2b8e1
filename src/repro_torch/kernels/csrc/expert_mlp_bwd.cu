// Backward of the expert FFN over the padded (G, E, cap, d) capacity
// buffer, for Hopper (sm_90a): a dx kernel and a dW kernel.
//
// Replaces the TPU kernels src/repro/kernels/expert_mlp.py:227
// (_dx_kernel) and :299 (_dw_kernel), reached through
// _expert_ffn_pallas_bwd. With a = x wi, g = x wg, h = act(a) * g,
// y = h wo and dh = dy wo^T (as the TPU kernels recompute them):
//   da = act'(a) * dh * g,  dg = dh * act(a),
//   dx = da wi^T + dg wg^T,  dwi = x^T da,  dwg = x^T dg,  dwo = h^T dy.
//
// dx: tensor-core GEMM launches over (row tile, 128-column tile, expert)
// blocks (expert_gemm.cuh, the forward's GEMM: 3xTF32 mma.sync for
// float32, bf16 products for bf16; the products of expert_ffn.cuh, which
// the ragged buffer's dx shares):
//   hidden products, over 128 columns of f: a = x wi, writing h = act(a)
//     and act'(a) into the f32 scratch h and da (G, E, cap, f); when
//     gated, g = x wg into dg; then dh = dy wo^T, wo^T staged from wo's
//     rows, whose epilogue reads back its own entries of the scratch and
//     leaves there da = act'(a) dh [g] (and dg = dh act(a), h = act(a)
//     g), the scratch the dW kernel reads. Each launch holds one sum a
//     warp: the products in one block would need two or three 32 x 64
//     sums, or kept tiles in shared memory; one such kernel (a and dh
//     kept in shared memory) timed slower on the card than the launches
//     one after another;
//   out product, over 128 columns of d: dx = da wi^T [+ dg wg^T] over
//     depth f into one sum, wi^T [wg^T] staged from the weights' rows;
//     for bf16 weights the f32 scratch is split for two TF32 products,
//     as the forward's pass 2 reads h.
// Row tiles of 16 rows at decode-sized capacity, else 64 (below). Zero
// rows give dx rows of act'(0) dh wi^T, as the plain version does, and
// add nothing to dW below (x = 0 and h = act(0) = 0 there).
//
// dW: tensor-core GEMM launches on the same header with A read
// transposed (gemm_slabs' kTransA; dw_tile of expert_ffn.cuh, which the
// ragged buffer's dW shares): dwi [and dwg, sharing each staged x^T
// slab] = x^T da [x^T dg], then dwo = h^T dy, one block per (128 x 128
// tile of the (d, f) or (f, d) product, expert e). The depth is the
// expert's G * cap rows of the buffer (its cap rows in every group g,
// the scratch from the dx kernel), walked group after group inside the
// block: each 32-deep part is summed from zero on the tensor cores and
// added in f32, every entry in one fixed order and written once — no
// split-K, no atomics, two calls give the same bits. float32 runs as
// 3xTF32; bf16 x and dy are exact in TF32, so only the f32 scratch is
// split (two products). The TPU dW kernel instead recomputes (a, g, dh)
// per (cap, f) tile from full-d rows; on this card that would repeat the
// dx kernel's products once per d tile, so dW reads da, dg and h from
// scratch: 2 (3 gated) x rows x f x 4 B, 1.0 GB at the ViT-B/16 shapes,
// alive only between the two launches of one layer's backward.
//
// Bound on this card: operations. dx 6 * rows * d * f FLOPs (10 gated:
// a, g, dh, then two products), dW 4 * rows * d * f (6 gated): 580 and
// 386.5 GFLOP at the ViT-B/16 MoE shapes (40,960 rows, d 768, f 3072).
// Both run on tensor cores as 3xTF32, held to 3 * FLOPs / 495 TFLOP/s =
// 3.52 and 2.34 ms (8.65 and 5.77 ms for f32 FMAs at 67 TFLOP/s).

#include "expert_ffn.cuh"

namespace {

// One hidden product of dx (dx_hidden_product) over a (BM-row tile, BN
// columns of f, expert) block.
template <typename T, int BM, int WM, int WN, int P, bool kGated>
__global__ void __launch_bounds__(32 * WM * WN)
    expert_dx_hidden(const T* __restrict__ rows, const T* __restrict__ w,
                     float* __restrict__ da, float* __restrict__ dg,
                     float* __restrict__ h, int cap, int d, int f, int act,
                     bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dx_hidden_product<T, BM, WM, WN, P, kGated>(
      block_tile<BM>(cap, f), rows, w, da, dg, h, d, f, act, aligned,
      smem_raw);
}

// dx's out product (dx_out_product) over one (BM-row tile, BN columns of
// d, expert) block.
template <typename T, int BM, int WM, int WN, bool kGated>
__global__ void __launch_bounds__(32 * WM * WN)
    expert_dx_out(const float* __restrict__ da, const float* __restrict__ dg,
                  const T* __restrict__ wi, const T* __restrict__ wg,
                  T* __restrict__ dx, int cap, int d, int f, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dx_out_product<T, BM, WM, WN, kGated>(block_tile<BM>(cap, d), da, dg, wi,
                                        wg, dx, d, f, aligned, smem_raw);
}

// dW over the padded buffer (dw_tile): one block per (128 x 128 tile of
// C, expert e = blockIdx.z); the depth is the expert's cap rows in every
// group, G * cap deep.
template <typename TA, typename TB, int NB>
__global__ void __launch_bounds__(DwTile<NB>::NT)
    expert_dw_kernel(const TA* __restrict__ A, const TB* __restrict__ B0,
                     const TB* __restrict__ B1, float* __restrict__ C0,
                     float* __restrict__ C1, int G, int cap, int M, int N,
                     bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.z;
  const size_t r0 = (size_t)e * cap;  // the expert's first row (g = 0)
  const size_t c0 = (size_t)e * M * N;
  dw_tile<TA, TB, NB>(A + r0 * M, B0 + r0 * N,
                      NB == 2 ? B1 + r0 * N : nullptr, C0 + c0,
                      NB == 2 ? C1 + c0 : nullptr, M, N, G * cap,
                      DepthRows(cap, gridDim.z), aligned, smem_raw);
}

template <typename T, int BM, int WM, int WN, int P, bool kGated>
int launch_hidden(const T* rows, const T* w, float* da, float* dg, float* h,
                  int G, int E, int cap, int d, int f, int act, bool aligned,
                  cudaStream_t stream) {
  constexpr size_t smem = dx_ring_bytes<T, BM, P, kGated>();
  auto kernel = expert_dx_hidden<T, BM, WM, WN, P, kGated>;
  allow_smem(kernel, smem);
  const dim3 grid(G * ((cap + BM - 1) / BM), (f + BN - 1) / BN, E);
  kernel<<<grid, 32 * WM * WN, smem, stream>>>(rows, w, da, dg, h, cap, d,
                                              f, act, aligned);
  return (int)cudaGetLastError();
}

template <typename T, int BM, int WM, int WN, bool kGated>
int launch_dx(const T* xe, const T* wi, const T* wg, const T* wo,
              const T* dy, T* dx, float* da, float* dg, float* h, int G,
              int E, int cap, int d, int f, int act, cudaStream_t stream) {
  auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  constexpr int V = 16 / sizeof(T);
  const bool aligned = d % V == 0 && f % V == 0 && al(xe) && al(wi) &&
                       al(wo) && al(dy) && al(da) && al(h) &&
                       (!kGated || (al(wg) && al(dg)));
  int rc = launch_hidden<T, BM, WM, WN, kA, kGated>(
      xe, wi, da, dg, h, G, E, cap, d, f, act, aligned, stream);
  if (kGated && rc == 0) {
    rc = launch_hidden<T, BM, WM, WN, kG, kGated>(
        xe, wg, da, dg, h, G, E, cap, d, f, act, aligned, stream);
  }
  if (rc == 0) {
    rc = launch_hidden<T, BM, WM, WN, kDH, kGated>(
        dy, wo, da, dg, h, G, E, cap, d, f, act, aligned, stream);
  }
  if (rc != 0) return rc;
  constexpr size_t smem = dx_ring_bytes<T, BM, kOut, kGated>();
  auto out = expert_dx_out<T, BM, WM, WN, kGated>;
  allow_smem(out, smem);
  out<<<dim3(G * ((cap + BM - 1) / BM), (d + BN - 1) / BN, E), 32 * WM * WN,
        smem, stream>>>(da, dg, wi, wg, dx, cap, d, f, aligned);
  return (int)cudaGetLastError();
}

template <typename TA, typename TB, int NB>
int launch_dw_product(const TA* A, const TB* B0, const TB* B1, float* C0,
                      float* C1, int G, int E, int cap, int M, int N,
                      cudaStream_t stream) {
  constexpr size_t smem = dw_ring_bytes<TA, TB, NB>();
  auto kernel = expert_dw_kernel<TA, TB, NB>;
  allow_smem(kernel, smem);
  const bool aligned = dw_aligned<TA, TB>(A, B0, B1, M, N);
  using D = DwTile<NB>;
  const dim3 grid((M + D::BM - 1) / D::BM, (N + BN - 1) / BN, E);
  kernel<<<grid, D::NT, smem, stream>>>(A, B0, B1, C0, C1, G, cap, M, N,
                                        aligned);
  return (int)cudaGetLastError();
}

// Two launches: dwi [and dwg] = x^T da [, x^T dg], then dwo = h^T dy.
template <typename T>
int dw_t(const void* xe, const void* dy, const void* da, const void* dg,
         const void* h, void* dwi, void* dwg, void* dwo, int G, int E,
         int cap, int d, int f, cudaStream_t s) {
  const int rc =
      dg ? launch_dw_product<T, float, 2>(
               (const T*)xe, (const float*)da, (const float*)dg,
               (float*)dwi, (float*)dwg, G, E, cap, d, f, s)
         : launch_dw_product<T, float, 1>(
               (const T*)xe, (const float*)da, nullptr, (float*)dwi,
               nullptr, G, E, cap, d, f, s);
  if (rc != 0) return rc;
  return launch_dw_product<float, T, 1>((const float*)h, (const T*)dy,
                                        nullptr, (float*)dwo, nullptr, G, E,
                                        cap, f, d, s);
}

// Row tiling by capacity: one 16-row tile (4 warps across the columns)
// at decode-sized cap, else 64 rows (2 x 2 warps); a warp holds 16 x 32
// or 32 x 64 sums. Not the forward's 128 rows at large cap: at 64 two
// blocks fit an SM, so one block's epilogue (the scratch writes)
// overlaps the other's products; the hidden products timed faster that
// way at the ViT shape.
template <typename T, bool kGated>
int dx_g(const void* xe, const void* wi, const void* wg, const void* wo,
         const void* dy, void* dx, void* da, void* dg, void* h, int G, int E,
         int cap, int d, int f, int act, cudaStream_t s) {
  auto args = [&](auto fn) {
    return fn((const T*)xe, (const T*)wi, (const T*)wg, (const T*)wo,
              (const T*)dy, (T*)dx, (float*)da, (float*)dg, (float*)h, G, E,
              cap, d, f, act, s);
  };
  if (cap <= 16) return args(launch_dx<T, 16, 1, 4, kGated>);
  return args(launch_dx<T, 64, 2, 2, kGated>);
}

template <typename T>
int dx_t(const void* xe, const void* wi, const void* wg, const void* wo,
         const void* dy, void* dx, void* da, void* dg, void* h, int G, int E,
         int cap, int d, int f, int act, cudaStream_t s) {
  auto fn = wg ? dx_g<T, true> : dx_g<T, false>;
  return fn(xe, wi, wg, wo, dy, dx, da, dg, h, G, E, cap, d, f, act, s);
}

}  // namespace

// xe, dy (G,E,cap,d), wi/wg (E,d,f) (wg may be null), wo (E,f,d) of one
// type (f32 or bf16) -> dx (G,E,cap,d) in that type and f32 scratch da,
// dg (null when ungated), h (G,E,cap,f). Launches on `stream`; no sync,
// no allocation.
extern "C" int expert_mlp_dx(const void* xe, const void* wi, const void* wg,
                             const void* wo, const void* dy, void* dx,
                             void* da, void* dg, void* h, int G, int E,
                             int cap, int d, int f, int act, int bf16,
                             void* stream) {
  if (G < 1 || E < 1 || cap < 1 || d < 1 || f < 1 || E > 65535 ||
      (f + BN - 1) / BN > 65535 || (d + BN - 1) / BN > 65535 ||
      (act < 0 || act > 2) || (wg == nullptr) != (dg == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  if (bf16) {
    return dx_t<__nv_bfloat16>(xe, wi, wg, wo, dy, dx, da, dg, h, G, E, cap,
                               d, f, act, s);
  }
  return dx_t<float>(xe, wi, wg, wo, dy, dx, da, dg, h, G, E, cap, d, f, act,
                     s);
}

// xe, dy (G,E,cap,d) of one type; da, dg (null when ungated), h
// (G,E,cap,f) f32 from expert_mlp_dx -> f32 dwi, dwg (E,d,f) and dwo
// (E,f,d), summed over every group and slot.
extern "C" int expert_mlp_dw(const void* xe, const void* dy, const void* da,
                             const void* dg, const void* h, void* dwi,
                             void* dwg, void* dwo, int G, int E, int cap,
                             int d, int f, int bf16, void* stream) {
  if (G < 1 || E < 1 || cap < 1 || d < 1 || f < 1 || E > 65535 ||
      (f + BN - 1) / BN > 65535 || (d + BN - 1) / BN > 65535 ||
      (long long)G * cap > 0x7fffffff || (dg == nullptr) != (dwg == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  if (bf16) {
    return dw_t<__nv_bfloat16>(xe, dy, da, dg, h, dwi, dwg, dwo, G, E, cap, d,
                               f, s);
  }
  return dw_t<float>(xe, dy, da, dg, h, dwi, dwg, dwo, G, E, cap, d, f, s);
}
