// Backward of the grouped-GEMM expert FFN over the expert-sorted,
// block-aligned ragged token buffer, for Hopper (sm_90a): a dx kernel
// and a dW kernel, both on the tensor-core GEMM of expert_gemm.cuh.
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
// dW: the expert dW's tensor-core tile (dw_tile, expert_ffn.cuh: 3xTF32
// mma.sync for float32; bf16 x and dy are exact in TF32, so only the f32
// scratch is split, two products) with A read transposed: dwi [and dwg,
// sharing each staged x^T slab] = x^T da [x^T dg], then dwo = h^T dy,
// two launches, one block per (128 x 128 tile of the (d, f) or (f, d)
// product, expert e). The depth is expert e's segment in every group,
// walked inside the block into the same register sums (SegmentRuns
// below), so the kernel writes the sums over the groups, (E, d, f) /
// (E, f, d) f32, once; the TPU kernel writes per-group outputs, summed
// outside. A segment is one run of group_sizes[g][e] rows from row g * M
// + row_off[g][e] (the int32 tables on the device; dead blocks are never
// read). Each run is padded to whole 64-deep slabs, so a slab never
// crosses a group and moves as one run of rows, and one ring walks every
// group's run: the next group's first slab loads while the last one's is
// summed. A ragged map whose slabs cross groups would stage every chunk
// by its own row (stage_rows), which made the padded-buffer dW 14%
// slower (expert_gemm.cuh, DepthRows); calling the ring once per group
// would restart its prologue each group (granite: ~4 slabs a segment).
// Every 32-deep part is summed from zero on the tensor cores and added
// in f32 in one fixed order: no split-K, no atomics, two calls give the
// same bits. An expert with no rows in any group writes zeros. dW reads
// the dx kernel's da/dg/h instead of recomputing them per tile (the TPU
// kernel's recompute per f tile would cost d/64 times the forward here).
//
// Bound on this card: operations over the valid rows, dx 10 d f a row
// (a, g, dh, then two products; 6 ungated), dW 6 d f a row (4
// ungated). At the training shapes (16,128 valid rows, d 1024, f 512):
// dx 84.6 GFLOP, dW 50.7 GFLOP; on the tensor cores as 3xTF32 (3 x FLOPs
// / 495 TFLOP/s) 0.513 and 0.307 ms (1.262 and 0.757 for f32 FMAs at 67
// TFLOP/s).

#include "expert_ffn.cuh"

namespace {

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

// The grouped dW's depth map (gemm_slabs): expert e's runs of every
// group, one after another, each padded to whole slabs of SK rows. Run g
// starts at buffer row g * M + row_off[g][e] and holds n_g =
// sizes[g][e] valid rows; padded depth p0 + j of it (j < n_g) is row j
// of the run. The slabs are asked for in increasing depth, so a cursor
// (run g from padded depth p0) moves on as they are; empty runs take no
// depth.
template <int SK>
struct SegmentRuns {
  static constexpr bool kAnyRow = false;
  const int* row_off;  // (G, E + 1)
  const int* sizes;    // (G, E)
  int M, E, e;
  int g = -1, p0 = 0, n = 0;

  __device__ __forceinline__ SegmentRuns(const int* row_off_,
                                         const int* sizes_, int M_, int E_,
                                         int e_)
      : row_off(row_off_), sizes(sizes_), M(M_), E(E_), e(e_) {}
  __device__ __forceinline__ int rows(int g_) const {
    return max(sizes[(size_t)g_ * E + e], 0);
  }
  static __device__ __forceinline__ int padded(int n_) {
    return (n_ + SK - 1) / SK * SK;
  }
  __device__ __forceinline__ int depth(int G) const {
    int K = 0;
    for (int g_ = 0; g_ < G; ++g_) K += padded(rows(g_));
    return K;
  }
  __device__ __forceinline__ bool slab(int k0, int, int& nk, size_t& r0) {
    while (k0 >= p0 + padded(n)) {
      p0 += padded(n);
      n = rows(++g);
    }
    nk = min(nk, n - (k0 - p0));
    r0 = (size_t)g * M + row_off[(size_t)g * (E + 1) + e] + (k0 - p0);
    return true;
  }
};

// One dW product over the ragged buffer (dw_tile): C (E, Mc, Nc) = A^T B
// over each expert's runs; A and B are the (G, M, .) buffers.
template <typename TA, typename TB, int NB>
__global__ void __launch_bounds__(DwTile<NB>::NT)
    grouped_dw_kernel(const TA* __restrict__ A, const TB* __restrict__ B0,
                      const TB* __restrict__ B1, float* __restrict__ C0,
                      float* __restrict__ C1, const int* __restrict__ row_off,
                      const int* __restrict__ sizes, int G, int M, int E,
                      int Mc, int Nc, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.z;
  const SegmentRuns<DwTile<NB>::SK> runs(row_off, sizes, M, E, e);
  const size_t c0 = (size_t)e * Mc * Nc;
  dw_tile<TA, TB, NB>(A, B0, B1, C0 + c0, NB == 2 ? C1 + c0 : nullptr, Mc,
                      Nc, runs.depth(G), runs, aligned, smem_raw);
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

template <typename TA, typename TB, int NB>
int launch_dw_product(const TA* A, const TB* B0, const TB* B1, float* C0,
                      float* C1, const int* row_off, const int* sizes, int G,
                      int M, int E, int Mc, int Nc, cudaStream_t stream) {
  constexpr size_t smem = dw_ring_bytes<TA, TB, NB>();
  auto kernel = grouped_dw_kernel<TA, TB, NB>;
  allow_smem(kernel, smem);
  const bool aligned = dw_aligned<TA, TB>(A, B0, B1, Mc, Nc);
  using D = DwTile<NB>;
  const dim3 grid((Mc + D::BM - 1) / D::BM, (Nc + BN - 1) / BN, E);
  kernel<<<grid, D::NT, smem, stream>>>(
      A, B0, B1, C0, C1, row_off, sizes, G, M, E, Mc, Nc, aligned);
  return (int)cudaGetLastError();
}

// Two launches: dwi [and dwg] = x^T da [, x^T dg], then dwo = h^T dy.
template <typename T>
int dw_t(const void* xs, const void* dy, const void* da, const void* dg,
         const void* h, const void* row_off, const void* sizes, void* dwi,
         void* dwg, void* dwo, int G, int M, int d, int f, int E,
         cudaStream_t s) {
  const int* ro = (const int*)row_off;
  const int* n = (const int*)sizes;
  const int rc =
      dg ? launch_dw_product<T, float, 2>(
               (const T*)xs, (const float*)da, (const float*)dg,
               (float*)dwi, (float*)dwg, ro, n, G, M, E, d, f, s)
         : launch_dw_product<T, float, 1>(
               (const T*)xs, (const float*)da, nullptr, (float*)dwi,
               nullptr, ro, n, G, M, E, d, f, s);
  if (rc != 0) return rc;
  return launch_dw_product<float, T, 1>((const float*)h, (const T*)dy,
                                        nullptr, (float*)dwo, nullptr, ro, n,
                                        G, M, E, f, d, s);
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
// f32 dwi, dwg (E,d,f) and dwo (E,f,d), summed over the groups.
extern "C" int grouped_mlp_dw(const void* xs, const void* dy, const void* da,
                              const void* dg, const void* h,
                              const void* row_off, const void* sizes,
                              void* dwi, void* dwg, void* dwo, int G, int M,
                              int d, int f, int E, int bf16, void* stream) {
  if (G < 1 || M < 1 || M % kRowBlock != 0 || d < 1 || f < 1 || E < 1 ||
      E > 65535 || (long long)G * M > 0x7fffffff ||
      (dg == nullptr) != (dwg == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  if (bf16) {
    return dw_t<__nv_bfloat16>(xs, dy, da, dg, h, row_off, sizes, dwi, dwg,
                               dwo, G, M, d, f, E, s);
  }
  return dw_t<float>(xs, dy, da, dg, h, row_off, sizes, dwi, dwg, dwo, G, M,
                     d, f, E, s);
}
