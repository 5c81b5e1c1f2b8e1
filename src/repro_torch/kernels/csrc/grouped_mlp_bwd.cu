// Backward of the grouped-GEMM expert FFN over the expert-sorted,
// block-aligned ragged token buffer, for Hopper (sm_90a): a dx kernel
// and a segment-walk dW kernel.
//
// Replaces the TPU kernels src/repro/kernels/grouped_mlp.py:406
// (_dx_kernel) and :476 (_dw_kernel), reached through
// _grouped_mlp_pallas_bwd. With a = x wi, g = x wg, h = act(a) * g,
// y = h wo and dh = dy wo^T (as _recompute_grads_f_tile has them):
//   da = act'(a) * dh * g,  dg = dh * act(a),
//   dx = da wi^T + dg wg^T,  dwi = x^T da,  dwg = x^T dg,  dwo = h^T dy.
//
// dx kernel: one thread block per (row block m of BM rows, group g), as
// the forward in grouped_mlp.cu. A dead block (block_live == 0) writes
// zero dx rows and reads nothing: the dx = 0 contract for tail blocks
// and dropped assignments. A live block stages its x rows (transposed)
// and dy rows in shared memory (f32), recomputes a and g (one thread per
// hidden column, weights read along their rows) and dh (one warp per
// hidden column, lanes along d), applies the activation's VJP, and
// writes da, dg and h of its rows to f32 scratch (G, M, f) for the dW
// kernel; then dx = da wi^T + dg wg^T, one warp per output column.
//
// dW kernel: one thread block per (64 x 64 tile of (d, f), expert e,
// group g) walks expert e's segment of group g (rows row_off[g][e] ..
// + group_sizes[g][e], found from the int32 tables, so dead blocks are
// never visited) and accumulates the tile of dwi = x^T da, dwg = x^T dg
// and dwo = h^T dy in registers, 4 x 4 entries a thread, writing each
// once into per-group f32 outputs (G, E, d, f) / (G, E, f, d); the sum
// over G is taken outside in f32, so no atomics and no dependence on
// launch order. An empty expert writes zeros. dW reads the dx kernel's
// da/dg/h instead of recomputing them per tile (the TPU kernel's
// recompute per f tile would cost d/64 times the forward here).
//
// Bound on this card: f32 FLOPs over the valid rows — dx 10*d*f a row
// (a, g, dh, then two products for dx), dW 6*d*f a row: 1.26 and 0.76 ms
// at the training shapes (~16.5k valid rows a layer) at 67 TFLOP/s.
// Both kernels run on CUDA cores; tensor cores are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int BM = 16;  // rows per block (ROW_BLOCK in grouped_mlp.py)
constexpr int kCols = 2;  // output columns per warp step (warp products)
constexpr int TD = 64, TF = 64;  // dW tile of (d, f)
constexpr int kRows = 32;  // segment rows staged per dW step

// Sum each of v[0..15] over the warp. Returns, in every lane, the total
// of row lane >> 1 (lanes 2r and 2r+1 hold row r): 16 shuffles instead
// of 16 separate butterflies.
__device__ __forceinline__ float warp_sum16(float v[16]) {
  const int lane = threadIdx.x & 31;
  float v8[8], v4[4], v2[2];
  const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4, b2 = lane & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float send = b16 ? v[i] : v[i + 8];
    v8[i] = (b16 ? v[i + 8] : v[i]) +
            __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b8 ? v8[i] : v8[i + 4];
    v4[i] = (b8 ? v8[i + 4] : v8[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b4 ? v4[i] : v4[i + 2];
    v2[i] = (b4 ? v4[i + 2] : v4[i]) + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  const float send = b2 ? v2[0] : v2[1];
  float v1 = (b2 ? v2[1] : v2[0]) + __shfl_xor_sync(0xffffffffu, send, 2);
  return v1 + __shfl_xor_sync(0xffffffffu, v1, 1);
}

__device__ __forceinline__ void load16(const float* __restrict__ p,
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
    grouped_dx_kernel(const T* __restrict__ xs, const T* __restrict__ wi,
                      const T* __restrict__ wg, const T* __restrict__ wo,
                      const T* __restrict__ dy,
                      const int* __restrict__ block_expert,
                      const int* __restrict__ block_live,
                      T* __restrict__ dx, float* __restrict__ da_out,
                      float* __restrict__ dg_out, float* __restrict__ h_out,
                      int M, int d, int f, int act) {
  extern __shared__ __align__(16) float smem[];
  float* xT = smem;           // [d][BM]  x transposed
  float* dys = xT + d * BM;   // [BM][d]  dy
  float* as = dys + BM * d;   // [BM][f]  a, then da
  float* gs = as + BM * f;    // [BM][f]  g, then dg (gated only)
  const int m = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nb = M / BM;
  const size_t row0 = (size_t)g * M + (size_t)m * BM;
  T* out = dx + row0 * d;
  if (!block_live[(size_t)g * nb + m]) {
    for (int i = tid; i < BM * d; i += kThreads) out[i] = from_f32<T>(0.f);
    return;
  }
  const int e = block_expert[(size_t)g * nb + m];
  const T* x = xs + row0 * d;
  const T* dyb = dy + row0 * d;
  for (int i = tid; i < BM * d; i += kThreads) {
    const int k = i / BM, r = i - k * BM;
    xT[i] = to_f32(x[(size_t)r * d + k]);
    dys[i] = to_f32(dyb[i]);
  }
  __syncthreads();

  // a = x wi, g = x wg: one thread per hidden column, all BM rows.
  const T* wie = wi + (size_t)e * d * f;
  const T* wge = wg ? wg + (size_t)e * d * f : nullptr;
  for (int c = tid; c < f; c += kThreads) {
    float a[BM], b[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) a[r] = b[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < d; ++k) {
      float xv[BM];
      load16(xT + k * BM, xv);
      const float w1 = to_f32(wie[(size_t)k * f + c]);
#pragma unroll
      for (int r = 0; r < BM; ++r) a[r] += xv[r] * w1;
      if (wge) {
        const float w2 = to_f32(wge[(size_t)k * f + c]);
#pragma unroll
        for (int r = 0; r < BM; ++r) b[r] += xv[r] * w2;
      }
    }
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      as[r * f + c] = a[r];
      if (wge) gs[r * f + c] = b[r];
    }
  }
  __syncthreads();

  // dh = dy wo^T, one warp per hidden column (lanes along d, wo read
  // along its rows), then the activation's VJP in place.
  const T* woe = wo + (size_t)e * f * d;
  for (int c0 = warp * kCols; c0 < f; c0 += kWarps * kCols) {
    float p[kCols][BM];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int r = 0; r < BM; ++r) p[j][r] = 0.f;
    for (int k = lane; k < d; k += 32) {
      float w[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        w[j] = c0 + j < f ? to_f32(woe[(size_t)(c0 + j) * d + k]) : 0.f;
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float yv = dys[r * d + k];
#pragma unroll
        for (int j = 0; j < kCols; ++j) p[j][r] += yv * w[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float dh = warp_sum16(p[j]);
      const int c = c0 + j, r = lane >> 1;
      if ((lane & 1) == 0 && c < f) {
        const float a = as[r * f + c];
        const float s = act_fn(a, act);
        const size_t at = (row0 + r) * f + c;
        if (wge) {
          const float gv = gs[r * f + c];
          as[r * f + c] = act_grad(a, act) * dh * gv;
          gs[r * f + c] = dh * s;
          dg_out[at] = dh * s;
          h_out[at] = s * gv;
        } else {
          as[r * f + c] = act_grad(a, act) * dh;
          h_out[at] = s;
        }
        da_out[at] = as[r * f + c];
      }
    }
  }
  __syncthreads();

  // dx = da wi^T + dg wg^T, one warp per output column (lanes along f).
  for (int k0 = warp * kCols; k0 < d; k0 += kWarps * kCols) {
    float p[kCols][BM];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int r = 0; r < BM; ++r) p[j][r] = 0.f;
    for (int c = lane; c < f; c += 32) {
      float w1[kCols], w2[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const bool ok = k0 + j < d;
        w1[j] = ok ? to_f32(wie[(size_t)(k0 + j) * f + c]) : 0.f;
        w2[j] = ok && wge ? to_f32(wge[(size_t)(k0 + j) * f + c]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float dav = as[r * f + c];
        const float dgv = wge ? gs[r * f + c] : 0.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) p[j][r] += dav * w1[j] + dgv * w2[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float v = warp_sum16(p[j]);
      const int k = k0 + j, r = lane >> 1;
      if ((lane & 1) == 0 && k < d) out[(size_t)r * d + k] = from_f32<T>(v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    grouped_dw_kernel(const T* __restrict__ xs, const T* __restrict__ dy,
                      const float* __restrict__ da,
                      const float* __restrict__ dg,
                      const float* __restrict__ hh,
                      const int* __restrict__ row_off,
                      const int* __restrict__ group_sizes,
                      float* __restrict__ dwi, float* __restrict__ dwg,
                      float* __restrict__ dwo, int M, int d, int f, int E) {
  __shared__ __align__(16) float xs_s[kRows][TD];
  __shared__ __align__(16) float dy_s[kRows][TD];
  __shared__ __align__(16) float da_s[kRows][TF];
  __shared__ __align__(16) float dg_s[kRows][TF];
  __shared__ __align__(16) float h_s[kRows][TF];
  const int nft = (f + TF - 1) / TF;
  const int k0 = (blockIdx.x / nft) * TD, c0 = (blockIdx.x % nft) * TF;
  const int e = blockIdx.y, g = blockIdx.z, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // 4 d rows x 4 f columns each
  const bool gated = dg != nullptr;
  const size_t seg0 = (size_t)g * M + row_off[(size_t)g * (E + 1) + e];
  const int n = group_sizes[(size_t)g * E + e];

  float ai[4][4], ag[4][4], ao[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ai[i][j] = ag[i][j] = ao[i][j] = 0.f;

  for (int r0 = 0; r0 < n; r0 += kRows) {
    __syncthreads();  // the previous step's reads
    for (int i = tid; i < kRows * TD; i += kThreads) {
      const int r = i / TD, k = i - r * TD;
      const bool ok = r0 + r < n && k0 + k < d;
      const size_t at = (seg0 + r0 + r) * d + k0 + k;
      xs_s[r][k] = ok ? to_f32(xs[at]) : 0.f;
      dy_s[r][k] = ok ? to_f32(dy[at]) : 0.f;
    }
    for (int i = tid; i < kRows * TF; i += kThreads) {
      const int r = i / TF, c = i - r * TF;
      const bool ok = r0 + r < n && c0 + c < f;
      const size_t at = (seg0 + r0 + r) * f + c0 + c;
      da_s[r][c] = ok ? da[at] : 0.f;
      dg_s[r][c] = ok && gated ? dg[at] : 0.f;
      h_s[r][c] = ok ? hh[at] : 0.f;
    }
    __syncthreads();
    const int rows = min(kRows, n - r0);
    for (int r = 0; r < rows; ++r) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs_s[r][ty * 4]);
      const float4 yv = *reinterpret_cast<const float4*>(&dy_s[r][ty * 4]);
      const float4 av = *reinterpret_cast<const float4*>(&da_s[r][tx * 4]);
      const float4 gv = *reinterpret_cast<const float4*>(&dg_s[r][tx * 4]);
      const float4 hv = *reinterpret_cast<const float4*>(&h_s[r][tx * 4]);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ya[4] = {yv.x, yv.y, yv.z, yv.w};
      const float daa[4] = {av.x, av.y, av.z, av.w};
      const float dga[4] = {gv.x, gv.y, gv.z, gv.w};
      const float ha[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ai[i][j] += xa[i] * daa[j];
          ag[i][j] += xa[i] * dga[j];
          ao[i][j] += ha[j] * ya[i];
        }
    }
  }

  const size_t base = ((size_t)g * E + e) * (size_t)d * f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (k < d && c < f) {
        dwi[base + (size_t)k * f + c] = ai[i][j];
        if (gated) dwg[base + (size_t)k * f + c] = ag[i][j];
        dwo[base + (size_t)c * d + k] = ao[i][j];
      }
    }
  }
}

template <typename T>
int launch_dx(const void* xs, const void* wi, const void* wg, const void* wo,
              const void* dy, const void* be, const void* bl, void* dx,
              void* da, void* dg, void* h, int G, int M, int d, int f,
              int act, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)BM * (2 * d + 2 * f);
  auto kernel = grouped_dx_kernel<T>;
  allow_smem(kernel, smem);
  kernel<<<dim3(M / BM, G), kThreads, smem, stream>>>(
      (const T*)xs, (const T*)wi, (const T*)wg, (const T*)wo, (const T*)dy,
      (const int*)be, (const int*)bl, (T*)dx, (float*)da, (float*)dg,
      (float*)h, M, d, f, act);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* xs, const void* dy, const void* da, const void* dg,
              const void* h, const void* row_off, const void* sizes,
              void* dwi, void* dwg, void* dwo, int G, int M, int d, int f,
              int E, cudaStream_t stream) {
  const int tiles = ((d + TD - 1) / TD) * ((f + TF - 1) / TF);
  grouped_dw_kernel<T><<<dim3(tiles, E, G), kThreads, 0, stream>>>(
      (const T*)xs, (const T*)dy, (const float*)da, (const float*)dg,
      (const float*)h, (const int*)row_off, (const int*)sizes, (float*)dwi,
      (float*)dwg, (float*)dwo, M, d, f, E);
  return (int)cudaGetLastError();
}

}  // namespace

// xs, dy (G,M,d), wi/wg (E,d,f) (wg may be null), wo (E,f,d) of one type
// (f32 or bf16); block tables (G, M/BM) int32 -> dx (G,M,d) in that type
// and f32 scratch da, dg (null when ungated), h (G,M,f), written for the
// live blocks only. Launches on `stream`; no sync, no allocation.
extern "C" int grouped_mlp_dx(const void* xs, const void* wi, const void* wg,
                              const void* wo, const void* dy, const void* be,
                              const void* bl, void* dx, void* da, void* dg,
                              void* h, int G, int M, int d, int f, int E,
                              int act, int bf16, void* stream) {
  if (M % BM != 0 || E < 1 || (act != 0 && act != 1) ||
      (wg == nullptr) != (dg == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  if (bf16) {
    return launch_dx<__nv_bfloat16>(xs, wi, wg, wo, dy, be, bl, dx, da, dg, h,
                                    G, M, d, f, act, s);
  }
  return launch_dx<float>(xs, wi, wg, wo, dy, be, bl, dx, da, dg, h, G, M, d,
                          f, act, s);
}

// xs, dy (G,M,d) of one type; da, dg (null when ungated), h (G,M,f) f32
// from grouped_mlp_dx; row_off (G,E+1) and group_sizes (G,E) int32 ->
// per-group f32 dwi, dwg (G,E,d,f) and dwo (G,E,f,d).
extern "C" int grouped_mlp_dw(const void* xs, const void* dy, const void* da,
                              const void* dg, const void* h,
                              const void* row_off, const void* sizes,
                              void* dwi, void* dwg, void* dwo, int G, int M,
                              int d, int f, int E, int bf16, void* stream) {
  if (M % BM != 0 || E < 1 || (dg == nullptr) != (dwg == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  if (bf16) {
    return launch_dw<__nv_bfloat16>(xs, dy, da, dg, h, row_off, sizes, dwi,
                                    dwg, dwo, G, M, d, f, E, s);
  }
  return launch_dw<float>(xs, dy, da, dg, h, row_off, sizes, dwi, dwg, dwo,
                          G, M, d, f, E, s);
}
