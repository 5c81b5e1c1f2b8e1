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
// dx: the expert dx's tensor-core launches (expert_mlp_bwd.cu, on the
// products of expert_ffn.cuh: 3xTF32 mma.sync for float32, bf16 products
// for bf16) over ragged tiles, (row tile, 128-column tile) blocks of one
// expert's segment found from the group sizes on the device
// (ragged_tile, expert_gemm.cuh; the grouped forward's map):
//   hidden products, over 128 columns of f: a = x wi, writing h = act(a)
//     and act'(a) into the f32 scratch h and da (G, M, f); when gated,
//     g = x wg into dg; then dh = dy wo^T, wo's rows staged as the
//     column-major B, whose epilogue leaves da = act'(a) dh [g] (and dg =
//     dh act(a), h = act(a) g) there, the scratch the dW kernel reads;
//   out product, over 128 columns of d: dx = da wi^T [+ dg wg^T].
// A row tile is BM in {16, 64} rows of one segment's live blocks (the
// wrapper picks it from static shapes), so each staged weight slab
// feeds all of them; the CUDA-core kernel this replaces streamed an
// expert's three weights once per 16-row block. Rows of live blocks are
// written in the scratch; rows of dead blocks (tail blocks, an empty
// expert's block) are left unwritten there and never read. The out
// product's slots past the live tiles zero-fill the dead blocks' dx
// rows: dx = 0 there exactly, the contract for tail blocks and dropped
// assignments.
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
// Bound on this card: FLOPs over the valid rows, dx 10 d f a row (a, g,
// dh, then two products; 6 ungated), dW 6 d f a row. At the training
// shapes (16,128 valid rows, d 1024, f 512): dx 84.6 GFLOP, 0.513 ms on
// the tensor cores as 3xTF32 (3 x FLOPs / 495 TFLOP/s; 1.262 for f32
// FMAs at 67 TFLOP/s); dW 0.757 ms on CUDA cores, which it runs on.

#include "expert_ffn.cuh"

namespace {

constexpr int kThreads = 256;  // dW
constexpr int TD = 64, TF = 64;  // dW tile of (d, f)
constexpr int kRows = 32;  // segment rows staged per dW step

// One hidden product of dx (dx_hidden_product) over a ragged tile (BN
// columns of f).
template <typename T, int BM, int WM, int WN, int P, bool kGated>
__global__ void __launch_bounds__(32 * WM * WN)
    grouped_dx_kernel_hidden(const T* __restrict__ rows,
                             const T* __restrict__ w, float* __restrict__ da,
                             float* __restrict__ dg, float* __restrict__ h,
                             const int* __restrict__ sizes, int M, int E,
                             int d, int f, int act, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RaggedTile rt = ragged_tile<BM>(sizes, M, E, f, nullptr);
  if (rt.t.nrows > 0) {
    dx_hidden_product<T, BM, WM, WN, P, kGated>(rt.t, rows, w, da, dg, h, d,
                                                f, act, aligned, smem_raw);
  }
}

// dx's out product (dx_out_product) over a ragged tile (BN columns of
// d); the spare slots zero-fill the dead blocks' dx rows (the tile table
// in the ring's memory, which they do not stage into).
template <typename T, int BM, int WM, int WN, bool kGated>
__global__ void __launch_bounds__(32 * WM * WN)
    grouped_dx_kernel_out(const float* __restrict__ da,
                          const float* __restrict__ dg,
                          const T* __restrict__ wi, const T* __restrict__ wg,
                          T* __restrict__ dx, const int* __restrict__ sizes,
                          int M, int E, int d, int f, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* row_off = reinterpret_cast<int*>(smem_raw);
  const RaggedTile rt = ragged_tile<BM>(sizes, M, E, d, row_off);
  if (rt.t.nrows > 0) {
    dx_out_product<T, BM, WM, WN, kGated>(rt.t, da, dg, wi, wg, dx, d, f,
                                          aligned, smem_raw);
  } else if (rt.spare >= 0) {
    const size_t g = blockIdx.z;
    zero_dead_blocks<T, 32 * WM * WN>(dx + g * M * d, sizes + g * E, row_off,
                                      M, E, d, rt.t.n0, rt.t.ncols, rt.spare,
                                      rt.nspare);
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

template <typename T, int BM, int WM, int WN, int P, bool kGated>
int launch_hidden(const T* rows, const T* w, float* da, float* dg, float* h,
                  const int* sizes, int G, int M, int E, int slots, int d,
                  int f, int act, bool aligned, cudaStream_t stream) {
  constexpr size_t smem = dx_ring_bytes<T, BM, P, kGated>();
  auto kernel = grouped_dx_kernel_hidden<T, BM, WM, WN, P, kGated>;
  allow_smem(kernel, smem);
  const dim3 grid(slots, (f + BN - 1) / BN, G);
  kernel<<<grid, 32 * WM * WN, smem, stream>>>(rows, w, da, dg, h, sizes, M,
                                              E, d, f, act, aligned);
  return (int)cudaGetLastError();
}

template <typename T, int BM, int WM, int WN, bool kGated>
int launch_dx(const T* xs, const T* wi, const T* wg, const T* wo,
              const T* dy, const int* sizes, T* dx, float* da, float* dg,
              float* h, int G, int M, int E, int slots, int d, int f,
              int act, cudaStream_t stream) {
  constexpr size_t smem = dx_ring_bytes<T, BM, kOut, kGated>();
  if ((size_t)(E + 1) * sizeof(int) > smem) return (int)cudaErrorInvalidValue;
  auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  constexpr int V = 16 / sizeof(T);
  const bool aligned = d % V == 0 && f % V == 0 && al(xs) && al(wi) &&
                       al(wo) && al(dy) && al(da) && al(h) &&
                       (!kGated || (al(wg) && al(dg)));
  int rc = launch_hidden<T, BM, WM, WN, kA, kGated>(
      xs, wi, da, dg, h, sizes, G, M, E, slots, d, f, act, aligned, stream);
  if (kGated && rc == 0) {
    rc = launch_hidden<T, BM, WM, WN, kG, kGated>(
        xs, wg, da, dg, h, sizes, G, M, E, slots, d, f, act, aligned,
        stream);
  }
  if (rc == 0) {
    rc = launch_hidden<T, BM, WM, WN, kDH, kGated>(
        dy, wo, da, dg, h, sizes, G, M, E, slots, d, f, act, aligned,
        stream);
  }
  if (rc != 0) return rc;
  auto out = grouped_dx_kernel_out<T, BM, WM, WN, kGated>;
  allow_smem(out, smem);
  out<<<dim3(slots, (d + BN - 1) / BN, G), 32 * WM * WN, smem, stream>>>(
      da, dg, wi, wg, dx, sizes, M, E, d, f, aligned);
  return (int)cudaGetLastError();
}

// The row tilings, as the expert dx's: 16 rows (4 warps across the
// columns) and 64 rows (2 x 2 warps); a warp holds 16 x 32 or 32 x 64
// sums. 128-row tiles timed slower than 64 at the training shape.
template <typename T, bool kGated>
int dx_g(const void* xs, const void* wi, const void* wg, const void* wo,
         const void* dy, const void* sizes, void* dx, void* da, void* dg,
         void* h, int G, int M, int E, int slots, int d, int f, int act,
         int bm, cudaStream_t s) {
  auto args = [&](auto fn) {
    return fn((const T*)xs, (const T*)wi, (const T*)wg, (const T*)wo,
              (const T*)dy, (const int*)sizes, (T*)dx, (float*)da,
              (float*)dg, (float*)h, G, M, E, slots, d, f, act, s);
  };
  if (bm == 16) return args(launch_dx<T, 16, 1, 4, kGated>);
  return args(launch_dx<T, 64, 2, 2, kGated>);
}

template <typename T>
int dx_t(const void* xs, const void* wi, const void* wg, const void* wo,
         const void* dy, const void* sizes, void* dx, void* da, void* dg,
         void* h, int G, int M, int E, int slots, int d, int f, int act,
         int bm, cudaStream_t s) {
  auto fn = wg ? dx_g<T, true> : dx_g<T, false>;
  return fn(xs, wi, wg, wo, dy, sizes, dx, da, dg, h, G, M, E, slots, d, f,
            act, bm, s);
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
// (f32 or bf16); group sizes (G,E) int32 -> dx (G,M,d) in that type and
// f32 scratch da, dg (null when ungated), h (G,M,f), written for the live
// blocks only. bm: the row tile (16 or 64); slots: tiles a group, at
// least ceil(M/bm) + E. Launches on `stream`; no sync, no allocation.
extern "C" int grouped_mlp_dx(const void* xs, const void* wi, const void* wg,
                              const void* wo, const void* dy,
                              const void* sizes, void* dx, void* da, void* dg,
                              void* h, int G, int M, int d, int f, int E,
                              int act, int bf16, int bm, int slots,
                              void* stream) {
  if (G < 1 || M < 1 || M % kRowBlock != 0 || d < 1 || f < 1 || E < 1 ||
      G > 65535 || (act != 0 && act != 1) || (bm != 16 && bm != 64) ||
      slots < (M + bm - 1) / bm + E || (f + BN - 1) / BN > 65535 ||
      (d + BN - 1) / BN > 65535 || (wg == nullptr) != (dg == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  if (bf16) {
    return dx_t<__nv_bfloat16>(xs, wi, wg, wo, dy, sizes, dx, da, dg, h, G,
                               M, E, slots, d, f, act, bm, s);
  }
  return dx_t<float>(xs, wi, wg, wo, dy, sizes, dx, da, dg, h, G, M, E,
                     slots, d, f, act, bm, s);
}

// xs, dy (G,M,d) of one type; da, dg (null when ungated), h (G,M,f) f32
// from grouped_mlp_dx; row_off (G,E+1) and group_sizes (G,E) int32 ->
// per-group f32 dwi, dwg (G,E,d,f) and dwo (G,E,f,d).
extern "C" int grouped_mlp_dw(const void* xs, const void* dy, const void* da,
                              const void* dg, const void* h,
                              const void* row_off, const void* sizes,
                              void* dwi, void* dwg, void* dwo, int G, int M,
                              int d, int f, int E, int bf16, void* stream) {
  if (M % kRowBlock != 0 || E < 1 || (dg == nullptr) != (dwg == nullptr)) {
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
