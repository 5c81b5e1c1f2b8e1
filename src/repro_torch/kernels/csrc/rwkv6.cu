// RWKV-6 ("Finch") WKV forward and final state for Hopper (sm_90a):
//   o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_kernel.py:31 (_kernel,
// reached through rwkv6_pallas). The TPU kernel walks the sequence in
// chunks of c steps and rewrites the recurrence as MXU matmuls over a
// (c, c, K) tensor of decay ratios built from log-space cumulative
// products. This kernel runs the recurrence itself, step by step, on
// CUDA cores. At K = V = 64 its 4 K V FLOPs a (b, t, h) take less time
// than its bytes (below), so tensor cores would not lower the bound; and
// the chunked form needs exp of differences of log cumulative sums,
// which the reference clips (w >= 1e-12) and whose rounding is its own
// (the chunked plain version parts from the sequential oracle by ~10x
// the oracle's own f32 rounding at the prefill shape).
//
// The bonus term factors out of the state: o_t[j] = sum_i r_i S_i[j] +
// v_j beta_t with beta_t = sum_i r_i u_i k_i, one scalar a step for the
// whole (b, h), as the TPU kernel's diagonal term has it. A step then
// costs three operations a state entry: acc = fma(r, S, acc), kv = k v,
// S = fma(w, S, kv).
//
// Layout. One block per (b, h, 64 value columns): V columns take
// ceil(V / 64) blocks. Each lane holds a 4-column group of the (K, V)
// state, split by rows over P lanes of one warp (lane = P g + p): lane p
// holds, in registers, rows 4c .. 4c + 3 of chunks c = p, p + P, ... in
// its 4 columns (4 K / P floats), and reads r, k and w of its chunks as
// 16-byte shared loads that serve all 4 columns. Each step the P partial
// sums of a column meet by a fixed __shfl_xor_sync tree, with no shared
// memory and no barrier, and lane p writes the group's columns c = p
// (mod P), its 4 outputs side by side. P = 8 at K >= 32, K / 4 below
// (one chunk a lane, so the reads stay 16 bytes). The shared loads bound
// the walk: with one column a lane (4 lanes a column) a warp's step took
// 12 16-byte loads, each from 4 different chunks, for 8 columns, and the
// kernel timed slower than one thread a column; 4 columns a lane serve
// 4 times the state entries from each load. At the prefill shape,
// (B, T, H, K, V) = (8, 512, 64, 64, 64), that is 512 blocks of 4 warps
// (all resident at once), against 2 warps with one thread a column and
// one block a (b, h), the kernel this replaces. Column blocks keep the
// lanes at every V: one block of V P / 4 threads at V = 1024 would be
// 2048 threads.
//
// Staging. The block stages kTile steps of r, k (the input type), w
// (f32) and v (its columns) in shared memory, double-buffered: tile n + 1
// moves by cp.async while tile n is walked, when every staged row is
// 16-byte aligned (else by plain loads, without the overlap). Between
// two barriers each warp takes some of the tile's steps and computes
// beta_t from the staged r, k and u: lane l sums i = l, l + 32, ..., then
// a shuffle tree. Every sum has one fixed order, so two calls give the
// same bits. There is no chunking and so no padding: T = 1 (a decode
// step) and T not a multiple of the tile take the same path.
//
// Decay: w lies in (0, 1). The reference's chunked forms clip it to
// [1e-12, 1] before taking its log; the sequential oracle (rwkv6_ref)
// does not, and neither does this kernel. Where w < 1e-12 the two differ
// by at most 1e-12 |S|, far under any tolerance used for them.
//
// Bound on this card: bytes. Each (b, t, h) reads 3K + V inputs and
// writes V outputs, against about 4 K V FLOPs: at the prefill shape in
// f32 that is 352 MB (0.105 ms at 3.35 TB/s) against 4.3 GFLOP (0.064 ms
// at 67 TFLOP/s). A decode step (T = 1) is its (K, V) state read and
// written a (b, h), 16 KB each way at K = V = 64.

#include "mma_sm90.cuh"  // cp.async

namespace {

constexpr int kTile = 16;  // steps staged a pass: 4 blocks fit an SM
constexpr int kCols = 64;  // value columns a block
constexpr int kC = 4;      // value columns a lane

// Lanes a state column: 16-byte reads of 4-row chunks, at most 8 lanes.
template <int K>
__host__ __device__ constexpr int lanes() {
  return K >= 32 ? 8 : K / 4;
}
// Threads of a block: its 64 columns in groups of 4, each over P lanes.
template <int K>
constexpr int kThreads = kCols / kC * lanes<K>();

// One staged tile: r, k (T), w (f32), v (T, the block's columns), each
// [kTile][row] with 16-byte aligned rows.
template <typename T, int K>
struct TileBuf {
  T* r;
  T* k;
  float* w;
  T* v;
  __device__ __forceinline__ TileBuf(unsigned char* p) {
    r = reinterpret_cast<T*>(p);
    k = r + kTile * K;
    w = reinterpret_cast<float*>(k + kTile * K);
    v = reinterpret_cast<T*>(w + kTile * K);
  }
  __host__ __device__ static constexpr size_t bytes() {
    return kTile * (2 * K * sizeof(T) + K * sizeof(float) +
                    kCols * sizeof(T));
  }
};

// dst[t][c] = src(t)[c] for t < nstep, c < n, rows of `row` elements in
// dst; by 16-byte cp.async chunks when `aligned`, else element by
// element (then complete on return). Not mma_sm90.cuh's stage_rows,
// whose whole-tile loops (zero-filling past the last step) made this
// kernel's prefill 11% slower with the same bits (launch/ab_dw.py
// --kernel wkv; H100 80GB HBM3, 700 W).
template <typename E, typename Src>
__device__ __forceinline__ void stage_rows_of(E* dst, int row, Src src,
                                              int nstep, int n,
                                              bool aligned) {
  constexpr int V = 16 / sizeof(E);
  if (aligned) {
    const int per = n / V;
    for (int i = threadIdx.x; i < nstep * per; i += blockDim.x) {
      const int t = i / per, c = (i - t * per) * V;
      cp_async16(dst + t * row + c, src(t) + c, true);
    }
  } else {
    for (int i = threadIdx.x; i < nstep * n; i += blockDim.x) {
      const int t = i / n, c = i - t * n;
      dst[t * row + c] = src(t)[c];
    }
  }
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  x[0] = __low2float(a);
  x[1] = __high2float(a);
  x[2] = __low2float(b);
  x[3] = __high2float(b);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads<K>)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ o, float* __restrict__ s_out, int T_, int H,
                int V, bool aligned) {
  constexpr int P = lanes<K>();
  constexpr int NC = K / (4 * P);  // chunks a lane
  extern __shared__ __align__(16) unsigned char smem[];
  auto buf = [&](int n) {  // tile n's buffer
    return TileBuf<T, K>(smem + (n & 1) * TileBuf<T, K>::bytes());
  };
  float* beta = reinterpret_cast<float*>(smem + 2 * TileBuf<T, K>::bytes());
  float* us = beta + kTile;  // [K]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int c0 = blockIdx.y * kCols, nc = min(kCols, V - c0);
  const int lane = threadIdx.x & 31, p = lane % P;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int jb = kC * (warp * (32 / P) + lane / P);  // the group's column
  const size_t row0 = (size_t)b * T_ * H + h;         // (b, t = 0, h)

  auto stage = [&](int t0, const TileBuf<T, K>& d) {
    const int n = min(kTile, T_ - t0);
    auto at = [&](int t) { return (row0 + (size_t)(t0 + t) * H); };
    stage_rows_of(d.r, K, [&](int t) { return r + at(t) * K; }, n, K,
                  aligned);
    stage_rows_of(d.k, K, [&](int t) { return k + at(t) * K; }, n, K,
                  aligned);
    stage_rows_of(d.w, K, [&](int t) { return w + at(t) * K; }, n, K,
                  aligned);
    stage_rows_of(d.v, kCols, [&](int t) { return v + at(t) * V + c0; }, n,
                  nc, aligned);
    cp_async_commit();
  };
  if (T_ > 0) stage(0, buf(0));
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    us[i] = u[(size_t)h * K + i];
  }

  // Lane p's state: S[cc][q][c] = S[4 (cc P + p) + q][c0 + jb + c]; its
  // row i of the (b, h) state starts at at_row(i).
  const bool vec = aligned && V % 4 == 0 && jb + kC <= nc;
  auto at_row = [&](int i) { return ((size_t)bh * K + i) * V + c0 + jb; };
  float S[NC][4][kC];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const size_t at = at_row(4 * (cc * P + p) + q);
      if (vec && s0 != nullptr) {
        load4(s0 + at, S[cc][q]);
      } else {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          S[cc][q][c] = s0 != nullptr && jb + c < nc ? s0[at + c] : 0.f;
        }
      }
    }

  for (int t0 = 0, n = 0; t0 < T_; t0 += kTile, ++n) {
    const TileBuf<T, K> cur = buf(n);
    const int nstep = min(kTile, T_ - t0);
    cp_async_wait<0>();
    __syncthreads();  // tile n is in; every warp is done with tile n - 1
    if (t0 + kTile < T_) stage(t0 + kTile, buf(n + 1));
    // beta_t = sum_i r_i u_i k_i, a warp a step.
    for (int t = warp; t < nstep; t += nwarps) {
      float part = 0.f;
      for (int i = lane; i < K; i += 32) {
        part = fmaf(to_f32(cur.r[t * K + i]) * us[i],
                    to_f32(cur.k[t * K + i]), part);
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, m);
      }
      if (lane == 0) beta[t] = part;
    }
    __syncthreads();  // beta is in

    for (int t = 0; t < nstep; ++t) {
      float vv[kC], acc[kC] = {};
      load4(cur.v + t * kCols + jb, vv);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int i0 = 4 * (cc * P + p);
        float rr[4], kk[4], ww[4];
        load4(cur.r + t * K + i0, rr);
        load4(cur.k + t * K + i0, kk);
        load4(cur.w + t * K + i0, ww);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            float& x = S[cc][q][c];
            acc[c] = fmaf(rr[q], x, acc[c]);
            x = fmaf(ww[q], x, kk[q] * vv[c]);
          }
      }
      const float bt = beta[t];
      T* out = o + (row0 + (size_t)(t0 + t) * H) * V + c0 + jb;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
#pragma unroll
        for (int m = 1; m < P; m <<= 1) {
          acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], m);
        }
        if (c % P == p && jb + c < nc) {
          out[c] = from_f32<T>(fmaf(vv[c], bt, acc[c]));
        }
      }
    }
  }
#pragma unroll
  for (int cc = 0; cc < NC; ++cc)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const size_t at = at_row(4 * (cc * P + p) + q);
      if (vec) {
        *reinterpret_cast<float4*>(s_out + at) = make_float4(
            S[cc][q][0], S[cc][q][1], S[cc][q][2], S[cc][q][3]);
      } else {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          if (jb + c < nc) s_out[at + c] = S[cc][q][c];
        }
      }
    }
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* o, void* s_out, int B,
           int T_, int H, int V, cudaStream_t stream) {
  const size_t smem =
      2 * TileBuf<T, K>::bytes() + sizeof(float) * (kTile + K);
  auto al = [](const void* x) { return ((uintptr_t)x & 15) == 0; };
  const bool aligned = (V * sizeof(T)) % 16 == 0 && al(r) && al(k) &&
                       al(v) && al(w) && al(s0) && al(s_out);
  auto kernel = wkv6_kernel<T, K>;
  allow_smem(kernel, smem);
  kernel<<<dim3(B * H, (V + kCols - 1) / kCols), kThreads<K>, smem,
           stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w,
      (const float*)u, (const float*)s0, (T*)o, (float*)s_out, T_, H, V,
      aligned);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* o, void* s_out, int B,
             int T_, int H, int K, int V, cudaStream_t s) {
  switch (K) {
    case 8:
      return launch<T, 8>(r, k, v, w, u, s0, o, s_out, B, T_, H, V, s);
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, o, s_out, B, T_, H, V, s);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, o, s_out, B, T_, H, V, s);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, o, s_out, B, T_, H, V, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k (B,T,H,K) and v (B,T,H,V) in one type (f32 or bf16, `bf16` says
// which); w (B,T,H,K), u (H,K), s0 (B,H,K,V) or null (zeros) in f32 ->
// o (B,T,H,V) in v's type, s_out (B,H,K,V) f32. K in {8, 16, 32, 64},
// 1 <= V <= 1024. Launches on `stream`; no sync, no allocation.
extern "C" int rwkv6_fwd(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         void* o, void* s_out, int B, int T_, int H, int K,
                         int V, int bf16, void* stream) {
  if (B < 1 || H < 1 || T_ < 0 || V < 1 || V > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  return bf16 ? dispatch<__nv_bfloat16>(r, k, v, w, u, s0, o, s_out, B, T_,
                                        H, K, V, s)
              : dispatch<float>(r, k, v, w, u, s0, o, s_out, B, T_, H, K, V,
                                s);
}
