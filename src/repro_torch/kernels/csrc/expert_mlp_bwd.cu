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
// float32, bf16 products for bf16):
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
// dW kernel: one thread block per (64 x 128 tile of (d, f), expert e)
// walks all G * cap rows of expert e (its cap rows in every group g,
// from the dx kernel's scratch) and sums the tile of dwi = x^T da,
// dwg = x^T dg and dwo = h^T dy in registers (8 x 4 entries a thread),
// writing each entry once: the sum over the groups is taken inside the
// block, in f32, in a fixed order — no atomics, no dependence on launch
// order. The TPU dW kernel instead recomputes (a, g, dh) per (cap, f)
// tile from full-d rows; on this card that would repeat the dx kernel's
// products once per d tile, so dW reads da, dg and h from scratch:
// 2 (3 gated) x rows x f x 4 B, 1.0 GB at the ViT-B/16 shapes, alive
// only between the two launches of one layer's backward.
//
// Bound on this card: operations. dx 6 * rows * d * f FLOPs (10 gated:
// a, g, dh, then two products), dW 4 * rows * d * f (6 gated): 580 and
// 386.5 GFLOP at the ViT-B/16 MoE shapes (40,960 rows, d 768, f 3072).
// dx runs on tensor cores as 3xTF32, held to 3 * FLOPs / 495 TFLOP/s =
// 3.52 ms (8.65 ms for f32 FMAs at 67 TFLOP/s); dW runs on CUDA cores
// in f32, 5.77 ms at 67 TFLOP/s.

#include "expert_gemm.cuh"

namespace {

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

// One hidden product over a (BM-row tile, BN columns of f, expert)
// block, its epilogue on the f32 scratch (entries of the tile only):
//   kA:  a = x wi;     h = act(a), da = act'(a);
//   kG:  g = x wg;     dg = g;
//   kDH: dh = dy wo^T; da *= dh [* g], and when gated dg = dh h,
//        h *= g (h still act(a), dg still g).
template <typename T, int BM, int WM, int WN, int P, bool kGated>
__global__ void __launch_bounds__(32 * WM * WN)
    expert_dx_hidden(const T* __restrict__ rows, const T* __restrict__ w,
                     float* __restrict__ da, float* __restrict__ dg,
                     float* __restrict__ h, int cap, int d, int f, int act,
                     bool aligned) {
  using W = Warps<BM, WM, WN>;
  constexpr int SK = slab_depth<P, kGated>(), NS = ring_slabs<P, kGated>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile t = block_tile<BM>(cap, f);
  const size_t w0 = (size_t)t.e * d * f;
  float acc[1][W::MI][W::NI][4] = {};
  if constexpr (P == kDH) {
    gemm_slabs<T, T, BM, WM, WN, 1, true, SK, NS>(
        acc, rows + t.row0 * d, w + w0 + (size_t)t.n0 * d, nullptr, d, d,
        t.nrows, t.ncols, aligned, smem_raw);
  } else {
    gemm_slabs<T, T, BM, WM, WN, 1, false, SK, NS>(
        acc, rows + t.row0 * d, w + w0 + t.n0, nullptr, f, d, t.nrows,
        t.ncols, aligned, smem_raw);
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

// dx, out product: dx = da wi^T [+ dg wg^T] over one (BM-row tile, BN
// columns of d, expert) block, depth f, into one sum.
template <typename T, int BM, int WM, int WN, bool kGated>
__global__ void __launch_bounds__(32 * WM * WN)
    expert_dx_out(const float* __restrict__ da, const float* __restrict__ dg,
                  const T* __restrict__ wi, const T* __restrict__ wg,
                  T* __restrict__ dx, int cap, int d, int f, bool aligned) {
  using W = Warps<BM, WM, WN>;
  constexpr int SK = slab_depth<kOut, kGated>();
  constexpr int NS = ring_slabs<kOut, kGated>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile t = block_tile<BM>(cap, d);
  const size_t w0 = (size_t)t.e * d * f + (size_t)t.n0 * f;
  float acc[1][W::MI][W::NI][4] = {};
  gemm_slabs<float, T, BM, WM, WN, 1, true, SK, NS>(
      acc, da + t.row0 * f, wi + w0, nullptr, f, f, t.nrows, t.ncols,
      aligned, smem_raw);
  if (kGated) {
    gemm_slabs<float, T, BM, WM, WN, 1, true, SK, NS>(
        acc, dg + t.row0 * f, wg + w0, nullptr, f, f, t.nrows, t.ncols,
        aligned, smem_raw);
  }
  T* out = dx + t.row0 * d + t.n0;
  each_entry<BM, WM, WN>([&](int mi, int ni, int q, int r, int col) {
    if (r < t.nrows && col < t.ncols) {
      out[(size_t)r * d + col] = from_f32<T>(acc[0][mi][ni][q]);
    }
  });
}

// dW kernel: thread (ty, tx) = (tid / 32, tid % 32) sums d rows
// 8 ty .. 8 ty + 7 and f columns 4 tx .. 4 tx + 3 of the tile.
constexpr int kThreads = 256;
constexpr int TD = 64, TF = 128;  // dW tile of (d, f)
constexpr int RB = 16;            // rows staged per dW step

__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T, bool kGated>
__global__ void __launch_bounds__(kThreads)
    expert_dw_kernel(const T* __restrict__ xe, const T* __restrict__ dy,
                     const float* __restrict__ da,
                     const float* __restrict__ dg,
                     const float* __restrict__ hh, float* __restrict__ dwi,
                     float* __restrict__ dwg, float* __restrict__ dwo,
                     int G, int cap, int d, int f) {
  __shared__ __align__(16) float xs[RB][TD];
  __shared__ __align__(16) float ys[RB][TD];
  __shared__ __align__(16) float as[RB][TF];
  __shared__ __align__(16) float gs[kGated ? RB : 1][TF];
  __shared__ __align__(16) float hs[RB][TF];
  const int nft = (f + TF - 1) / TF;
  const int k0 = (blockIdx.x / nft) * TD, c0 = (blockIdx.x % nft) * TF;
  const int e = blockIdx.y, E = gridDim.y;
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int n = G * cap;

  float ai[8][4], ag[8][4], ao[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) ai[i][q] = ag[i][q] = ao[i][q] = 0.f;

  for (int j0 = 0; j0 < n; j0 += RB) {
    __syncthreads();  // the previous step's reads
    for (int i = tid; i < RB * TD; i += kThreads) {
      const int r = i / TD, k = i % TD, j = j0 + r;
      const bool ok = j < n && k0 + k < d;
      const size_t row = ((size_t)(j / cap) * E + e) * cap + j % cap;
      xs[r][k] = ok ? to_f32(xe[row * d + k0 + k]) : 0.f;
      ys[r][k] = ok ? to_f32(dy[row * d + k0 + k]) : 0.f;
    }
    for (int i = tid; i < RB * TF; i += kThreads) {
      const int r = i / TF, c = i % TF, j = j0 + r;
      const bool ok = j < n && c0 + c < f;
      const size_t at =
          (((size_t)(j / cap) * E + e) * cap + j % cap) * f + c0 + c;
      as[r][c] = ok ? da[at] : 0.f;
      if (kGated) gs[r][c] = ok ? dg[at] : 0.f;
      hs[r][c] = ok ? hh[at] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < RB; ++r) {
      float xv[8], yv[8];
      load8(&xs[r][ty * 8], xv);
      load8(&ys[r][ty * 8], yv);
      const float4 av = *reinterpret_cast<const float4*>(&as[r][tx * 4]);
      const float4 hv = *reinterpret_cast<const float4*>(&hs[r][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ai[i][q] += xv[i] * a4[q];
          ao[i][q] += yv[i] * h4[q];
        }
      if (kGated) {
        const float4 gv = *reinterpret_cast<const float4*>(&gs[r][tx * 4]);
        const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) ag[i][q] += xv[i] * g4[q];
      }
    }
  }

  const size_t base = (size_t)e * d * f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + ty * 8 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + tx * 4 + q;
      if (k < d && c < f) {
        dwi[base + (size_t)k * f + c] = ai[i][q];
        if (kGated) dwg[base + (size_t)k * f + c] = ag[i][q];
        dwo[base + (size_t)c * d + k] = ao[i][q];
      }
    }
  }
}

template <typename T, int BM, int WM, int WN, int P, bool kGated>
int launch_hidden(const T* rows, const T* w, float* da, float* dg, float* h,
                  int G, int E, int cap, int d, int f, int act, bool aligned,
                  cudaStream_t stream) {
  constexpr size_t smem =
      ring_bytes<T, T, BM, 1, P == kDH, slab_depth<P, kGated>(),
                 ring_slabs<P, kGated>()>();
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
  constexpr size_t smem =
      ring_bytes<float, T, BM, 1, true, slab_depth<kOut, kGated>(),
                 ring_slabs<kOut, kGated>()>();
  auto out = expert_dx_out<T, BM, WM, WN, kGated>;
  allow_smem(out, smem);
  out<<<dim3(G * ((cap + BM - 1) / BM), (d + BN - 1) / BN, E), 32 * WM * WN,
        smem, stream>>>(da, dg, wi, wg, dx, cap, d, f, aligned);
  return (int)cudaGetLastError();
}

template <typename T, bool kGated>
int launch_dw(const void* xe, const void* dy, const void* da, const void* dg,
              const void* h, void* dwi, void* dwg, void* dwo, int G, int E,
              int cap, int d, int f, cudaStream_t stream) {
  const int tiles = ((d + TD - 1) / TD) * ((f + TF - 1) / TF);
  expert_dw_kernel<T, kGated><<<dim3(tiles, E), kThreads, 0, stream>>>(
      (const T*)xe, (const T*)dy, (const float*)da, (const float*)dg,
      (const float*)h, (float*)dwi, (float*)dwg, (float*)dwo, G, cap, d, f);
  return (int)cudaGetLastError();
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

template <typename T>
int dw_t(const void* xe, const void* dy, const void* da, const void* dg,
         const void* h, void* dwi, void* dwg, void* dwo, int G, int E,
         int cap, int d, int f, cudaStream_t s) {
  if (dg) {
    return launch_dw<T, true>(xe, dy, da, dg, h, dwi, dwg, dwo, G, E, cap, d,
                              f, s);
  }
  return launch_dw<T, false>(xe, dy, da, dg, h, dwi, dwg, dwo, G, E, cap, d,
                             f, s);
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
  if (G < 1 || E < 1 || cap < 1 || d < 1 || f < 1 ||
      (dg == nullptr) != (dwg == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  if (bf16) {
    return dw_t<__nv_bfloat16>(xe, dy, da, dg, h, dwi, dwg, dwo, G, E, cap, d,
                               f, s);
  }
  return dw_t<float>(xe, dy, da, dg, h, dwi, dwg, dwo, G, E, cap, d, f, s);
}
