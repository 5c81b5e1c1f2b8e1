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
// dx kernel: one thread block per (BM-row tile of one (g, e) segment,
// g, e), as the forward in expert_mlp.cu. For each tile of BF hidden
// columns it recomputes a (and g) from x and dh from dy into a (BM, BF)
// shared tile, applies the activation's VJP there, writes da, dg and h
// of its rows to f32 scratch (G, E, cap, f) for the dW kernel, and adds
// da wi^T + dg wg^T into the (BM, d) dx, which stays in registers across
// the f tiles and is rounded once at the end. Zero rows give dx rows of
// act'(0) dh wi^T, as the plain version does, and add nothing to dW
// below (x = 0 and h = act(0) = 0 there).
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
// Bound on this card: operations. dx 6 * rows * d * f f32 FLOPs (10
// gated: a, g, dh, then two products), dW 4 * rows * d * f (6 gated):
// 580 and 386.5 GFLOP at the ViT-B/16 MoE shapes (40,960 rows, d 768,
// f 3072), 8.65 and 5.77 ms at 67 TFLOP/s. Both run on CUDA cores in
// f32; tensor cores are later work.

#include "expert_tiles.cuh"

namespace {

constexpr int TD = 64, TF = 128;  // dW tile of (d, f)
constexpr int RB = 16;            // rows staged per dW step

template <typename T, bool kGated>
__global__ void __launch_bounds__(kThreads, 1)
    expert_dx_kernel(const T* __restrict__ xe, const T* __restrict__ wi,
                     const T* __restrict__ wg, const T* __restrict__ wo,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ da_out, float* __restrict__ dg_out,
                     float* __restrict__ h_out, int cap, int d, int f,
                     int act) {
  extern __shared__ __align__(16) float smem[];
  float* at = smem;                            // [BF][XS] a, then da
  float* gt = at + BF * XS;                    // [BF][XS] g, then dg
  float* lt = kGated ? gt + BF * XS : gt;      // [BK][XS] staged rows
  float* rs = lt + BK * XS;                    // [BK][RS] staged weights
  float* ws = lt;                              // [BK2][WS2] wi^T chunk
  float* ws2 = ws + BK2 * WS2;                 // [BK2][WS2] wg^T chunk
  const int tid = threadIdx.x, ty = tid >> 6, tx = tid & 63;
  const int r0 = blockIdx.x * BM, g = blockIdx.y, e = blockIdx.z;
  const int E = gridDim.z;
  const int nrows = min(BM, cap - r0);
  const size_t row0 = ((size_t)g * E + e) * cap + r0;
  const T* x = xe + row0 * d;
  const T* gy = dy + row0 * d;
  const T* wie = wi + (size_t)e * d * f;
  const T* wge = kGated ? wg + (size_t)e * d * f : nullptr;
  const T* woe = wo + (size_t)e * f * d;

  for (int c0 = 0; c0 < d; c0 += DC) {
    float acc[8][12];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j) acc[i][j] = 0.f;
    for (int f0 = 0; f0 < f; f0 += BF) {
      float p[8][4];
      tile_product<T, false>(p, x, nrows, wie, d, f, f0, lt, rs);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) at[(tx * 4 + q) * XS + ty * 8 + i] = p[i][q];
      if (kGated) {
        tile_product<T, false>(p, x, nrows, wge, d, f, f0, lt, rs);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            gt[(tx * 4 + q) * XS + ty * 8 + i] = p[i][q];
      }
      tile_product<T, true>(p, gy, nrows, woe, d, f, f0, lt, rs);  // dh
      // The activation's VJP on the thread's own entries; the scratch is
      // written once, in the first pass over the output columns.
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty * 8 + i;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = tx * 4 + q, s_at = c * XS + r;
          const float a = at[s_at], dh = p[i][q], s = act_fn(a, act);
          float da, h, dgv = 0.f;
          if (kGated) {
            const float gv = gt[s_at];
            da = act_grad(a, act) * dh * gv;
            dgv = dh * s;
            h = s * gv;
            gt[s_at] = dgv;
          } else {
            da = act_grad(a, act) * dh;
            h = s;
          }
          at[s_at] = da;
          if (c0 == 0 && r < nrows && f0 + c < f) {
            const size_t o = (row0 + r) * f + f0 + c;
            da_out[o] = da;
            h_out[o] = h;
            if (kGated) dg_out[o] = dgv;
          }
        }
      }
      out_product<T, true, kGated>(acc, at, wie, gt, wge, ws, ws2, d, f, f0,
                                   c0);
    }
    store_rows<T>(dx + row0 * d, acc, nrows, d, c0);
  }
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

template <typename T, bool kGated>
int launch_dx(const void* xe, const void* wi, const void* wg, const void* wo,
              const void* dy, void* dx, void* da, void* dg, void* h, int G,
              int E, int cap, int d, int f, int act, cudaStream_t stream) {
  constexpr int kProd = BK * XS + BK * RS;
  constexpr int kOut = (kGated ? 2 : 1) * BK2 * WS2;
  const size_t smem = sizeof(float) * (size_t)((kGated ? 2 : 1) * BF * XS +
                                               (kProd > kOut ? kProd : kOut));
  auto kernel = expert_dx_kernel<T, kGated>;
  allow_smem(kernel, smem);
  const dim3 grid((cap + BM - 1) / BM, G, E);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)xe, (const T*)wi, (const T*)wg, (const T*)wo, (const T*)dy,
      (T*)dx, (float*)da, (float*)dg, (float*)h, cap, d, f, act);
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

template <typename T>
int dx_t(const void* xe, const void* wi, const void* wg, const void* wo,
         const void* dy, void* dx, void* da, void* dg, void* h, int G, int E,
         int cap, int d, int f, int act, cudaStream_t s) {
  if (wg) {
    return launch_dx<T, true>(xe, wi, wg, wo, dy, dx, da, dg, h, G, E, cap, d,
                              f, act, s);
  }
  return launch_dx<T, false>(xe, wi, wg, wo, dy, dx, da, dg, h, G, E, cap, d,
                             f, act, s);
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
  if (G < 1 || E < 1 || cap < 1 || d < 1 || f < 1 ||
      (act != 0 && act != 1) || (wg == nullptr) != (dg == nullptr)) {
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
