// The expert FFN's tile products on the tensor-core GEMM of
// expert_gemm.cuh, shared by the kernels over the padded capacity buffer
// (expert_mlp.cu, expert_mlp_bwd.cu) and over the ragged buffer
// (grouped_mlp.cu, grouped_mlp_bwd.cu). Each __global__ finds its Tile
// (block_tile or ragged_tile) and runs one of these over it: the
// forward's pass product, or one of the dx kernel's products.
#pragma once

#include "expert_gemm.cuh"

namespace {

// C (rows, N) = epilogue(A (rows, K) B_e (K, N)) over tile t: with kAct,
// C = act(A B) [* A B2 when kGated]; else C = A B. A and C are indexed
// by t.row0; B and B2 are (E, K, N).
template <typename TA, typename TB, typename TC, int BM, int WM, int WN,
          bool kGated, bool kAct>
__device__ __forceinline__ void ffn_product(
    const Tile& t, const TA* __restrict__ A, const TB* __restrict__ B,
    const TB* __restrict__ B2, TC* __restrict__ C, int K, int N, int act,
    bool aligned, unsigned char* smem) {
  using W = Warps<BM, WM, WN>;
  constexpr int NB = kGated ? 2 : 1;
  const size_t boff = (size_t)t.e * K * N + t.n0;
  float acc[NB][W::MI][W::NI][4] = {};  // acc[1]: the gate
  gemm_slabs<TA, TB, BM, WM, WN, NB, false>(
      acc, A + t.row0 * K, B + boff, kGated ? B2 + boff : nullptr, N, K,
      t.nrows, t.ncols, aligned, smem);
  TC* c = C + t.row0 * N + t.n0;
  each_entry<BM, WM, WN>([&](int mi, int ni, int q, int r, int col) {
    if (r >= t.nrows || col >= t.ncols) return;
    float v = acc[0][mi][ni][q];
    if (kAct) v = act_fn(v, act);
    if (kGated) v *= acc[NB - 1][mi][ni][q];
    c[(size_t)r * N + col] = from_f32<TC>(v);
  });
}

// The products of dx, in launch order: the hidden products a, g, dh,
// then the out product.
enum Product { kA, kG, kDH, kOut };

// dx's ring by product: the transposed products of the ViT's path (dh =
// dy wo^T and the ungated out product) stage 64-deep slabs (each summed
// as two 32-deep parts) two at a time, half the forward's barriers,
// timed faster each at the ViT shape; the others keep the forward's
// 32 x 3 ring, with which they fit their registers without spilling.
template <int P, bool kGated>
__host__ __device__ constexpr int slab_depth() {
  return P == kDH || (P == kOut && !kGated) ? 2 * BK : BK;
}
template <int P, bool kGated>
__host__ __device__ constexpr int ring_slabs() {
  return slab_depth<P, kGated>() == BK ? STAGES : 2;
}
// The ring's bytes of product P (the out product reads the f32 scratch).
template <typename T, int BM, int P, bool kGated>
__host__ __device__ constexpr size_t dx_ring_bytes() {
  using TA = typename std::conditional<P == kOut, float, T>::type;
  return ring_bytes<TA, T, BM, 1, P == kDH || P == kOut,
                    slab_depth<P, kGated>(), ring_slabs<P, kGated>()>();
}

// One hidden product over tile t (BN columns of f), its epilogue on the
// f32 scratch (entries of the tile only):
//   kA:  a = x wi;     h = act(a), da = act'(a);
//   kG:  g = x wg;     dg = g;
//   kDH: dh = dy wo^T; da *= dh [* g], and when gated dg = dh h,
//        h *= g (h still act(a), dg still g).
// rows: x (kA, kG) or dy (kDH), row stride d; w: wi, wg (E, d, f) or wo
// (E, f, d), whose rows are staged as the column-major B of dy wo^T.
template <typename T, int BM, int WM, int WN, int P, bool kGated>
__device__ __forceinline__ void dx_hidden_product(
    const Tile& t, const T* __restrict__ rows, const T* __restrict__ w,
    float* __restrict__ da, float* __restrict__ dg, float* __restrict__ h,
    int d, int f, int act, bool aligned, unsigned char* smem) {
  using W = Warps<BM, WM, WN>;
  constexpr int SK = slab_depth<P, kGated>(), NS = ring_slabs<P, kGated>();
  const size_t w0 = (size_t)t.e * d * f;
  float acc[1][W::MI][W::NI][4] = {};
  if constexpr (P == kDH) {
    gemm_slabs<T, T, BM, WM, WN, 1, true, SK, NS>(
        acc, rows + t.row0 * d, w + w0 + (size_t)t.n0 * d, nullptr, d, d,
        t.nrows, t.ncols, aligned, smem);
  } else {
    gemm_slabs<T, T, BM, WM, WN, 1, false, SK, NS>(
        acc, rows + t.row0 * d, w + w0 + t.n0, nullptr, f, d, t.nrows,
        t.ncols, aligned, smem);
  }
  const size_t o = t.row0 * f + t.n0;
  each_entry<BM, WM, WN>([&](int mi, int ni, int q, int r, int col) {
    if (r >= t.nrows || col >= t.ncols) return;
    const size_t at = o + (size_t)r * f + col;
    const float v = acc[0][mi][ni][q];
    if constexpr (P == kA) {
      h[at] = act_fn(v, act);
      da[at] = act_grad(v, act);
    } else if constexpr (P == kG) {
      dg[at] = v;
    } else if constexpr (kGated) {
      const float g = dg[at], s = h[at];
      da[at] = da[at] * v * g;
      dg[at] = v * s;
      h[at] = s * g;
    } else {
      da[at] = da[at] * v;
    }
  });
}

// The out product over tile t (BN columns of d): dx = da wi^T [+ dg
// wg^T], depth f, into one sum; wi^T [wg^T] staged from the weights'
// rows. For bf16 weights the f32 scratch is split for two TF32 products.
template <typename T, int BM, int WM, int WN, bool kGated>
__device__ __forceinline__ void dx_out_product(
    const Tile& t, const float* __restrict__ da,
    const float* __restrict__ dg, const T* __restrict__ wi,
    const T* __restrict__ wg, T* __restrict__ dx, int d, int f,
    bool aligned, unsigned char* smem) {
  using W = Warps<BM, WM, WN>;
  constexpr int SK = slab_depth<kOut, kGated>();
  constexpr int NS = ring_slabs<kOut, kGated>();
  const size_t w0 = (size_t)t.e * d * f + (size_t)t.n0 * f;
  float acc[1][W::MI][W::NI][4] = {};
  gemm_slabs<float, T, BM, WM, WN, 1, true, SK, NS>(
      acc, da + t.row0 * f, wi + w0, nullptr, f, f, t.nrows, t.ncols,
      aligned, smem);
  if (kGated) {
    gemm_slabs<float, T, BM, WM, WN, 1, true, SK, NS>(
        acc, dg + t.row0 * f, wg + w0, nullptr, f, f, t.nrows, t.ncols,
        aligned, smem);
  }
  T* out = dx + t.row0 * d + t.n0;
  each_entry<BM, WM, WN>([&](int mi, int ni, int q, int r, int col) {
    if (r < t.nrows && col < t.ncols) {
      out[(size_t)r * d + col] = from_f32<T>(acc[0][mi][ni][q]);
    }
  });
}

}  // namespace
