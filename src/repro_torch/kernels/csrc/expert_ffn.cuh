// The expert FFN's tile products on the tensor-core GEMM of
// expert_gemm.cuh, shared by the kernels over the padded capacity buffer
// (expert_mlp.cu, expert_mlp_bwd.cu) and over the ragged buffer
// (grouped_mlp.cu, grouped_mlp_bwd.cu). Each __global__ finds its Tile
// (block_tile or ragged_tile) and runs one of these over it: the
// forward's pass product, or one of the dx kernel's products; the dW
// kernels run dw_tile over the expert's depth map.
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

// dW: C_i (M, N) of one expert = A^T B_i over its depth rows, i < NB,
// for the block's (DwTile<NB>::BM x BN tile of C) = (blockIdx.x,
// blockIdx.y):
//   dwi [, dwg] (d, f) = x^T da [, x^T dg]: A = x (row stride d), B_i =
//     da [, dg], the f32 scratch (stride f); the gated dwg shares each
//     staged x^T slab;
//   dwo (f, d) = h^T dy: A = h, the f32 scratch (stride f), B = dy
//     (stride d).
// So A's row stride is M and B's is N. A, B0 and B1 point at the buffer
// row that depth row 0 counts from; C0 and C1 at the expert's (M, N)
// matrix. The depth map (gemm_slabs) walks the expert's rows in every
// group inside the block: the sums start at zero, run in one fixed
// order and every entry is written once (no split-K, no atomics).
//
// The tiling, timed at the ViT shape (expert_mlp_bwd.cu): 128 x 128
// tiles of C, 4 x 2 warps of 32 x 64 sums, a ring of 2 slabs 64 deep
// (each summed as two 32-deep parts, so the bits are those of 32-deep
// slabs). It timed faster than the forward's 3 slabs 32 deep and than
// 64-row tiles. Splitting each staged float once a block in shared
// memory, instead of in every warp that reads it, timed slower: the
// split pass sat between each slab's wait and its barrier. The gated
// pair (NB = 2, granite's dwi and dwg) takes 64 x 128 tiles, 2 x 4 warps
// of 32 x 32 sums each: at 128 rows its two 32 x 64 sums a warp spill
// (588 B in float32), at 64 rows not, with the same bits.
template <int NB>
struct DwTile {
  static constexpr bool kNarrow = NB == 2;  // 64-row tiles
  static constexpr int BM = kNarrow ? 64 : 128, WM = kNarrow ? 2 : 4;
  static constexpr int WN = 8 / WM, SK = 2 * BK, NS = 2;
  static constexpr int NT = 32 * WM * WN;  // threads
};

template <typename TA, typename TB, int NB>
__host__ __device__ constexpr size_t dw_ring_bytes() {
  using D = DwTile<NB>;
  return ring_bytes<TA, TB, D::BM, NB, false, D::SK, D::NS, true>();
}

// Whether dw_tile's slabs move as cp.async chunks (see gemm_slabs).
template <typename TA, typename TB>
inline bool dw_aligned(const void* A, const void* B0, const void* B1,
                       int M, int N) {
  auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  return M % (16 / sizeof(TA)) == 0 && N % (16 / sizeof(TB)) == 0 &&
         al(A) && al(B0) && (B1 == nullptr || al(B1));
}

template <typename TA, typename TB, int NB, typename Depth>
__device__ __forceinline__ void dw_tile(const TA* __restrict__ A,
                                        const TB* __restrict__ B0,
                                        const TB* __restrict__ B1,
                                        float* __restrict__ C0,
                                        float* __restrict__ C1, int M, int N,
                                        int K, Depth depth, bool aligned,
                                        unsigned char* smem) {
  using D = DwTile<NB>;
  using W = Warps<D::BM, D::WM, D::WN>;
  const int m0 = blockIdx.x * D::BM, n0 = blockIdx.y * BN;
  const int nm = min(D::BM, M - m0), nn = min(BN, N - n0);
  float acc[NB][W::MI][W::NI][4] = {};
  gemm_slabs<TA, TB, D::BM, D::WM, D::WN, NB, false, D::SK, D::NS, true,
             Depth>(
      acc, A + m0, B0 + n0, NB == 2 ? B1 + n0 : nullptr, N, K, nm, nn,
      aligned, smem, M, depth);
  const size_t o = (size_t)m0 * N + n0;
  each_entry<D::BM, D::WM, D::WN>([&](int mi, int ni, int q, int r,
                                      int col) {
    if (r >= nm || col >= nn) return;
    C0[o + (size_t)r * N + col] = acc[0][mi][ni][q];
    if (NB == 2) C1[o + (size_t)r * N + col] = acc[NB - 1][mi][ni][q];
  });
}

}  // namespace
