// Tile products of the expert-FFN backward kernels (expert_mlp_bwd.cu;
// the forward runs on tensor cores): f32 CUDA-core matrix products over
// one block of BM rows of the padded (G, E, cap, d) capacity buffer,
// staged through shared memory in chunks. 256 threads; thread (ty, tx) =
// (tid / 64, tid % 64) owns rows ty*8 .. ty*8+7 of the block.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BM = 32;       // rows per block
constexpr int BF = 256;      // hidden columns per f tile
constexpr int BK = 16;       // depth of a staged (rows, d) / weight chunk
constexpr int BK2 = 8;       // hidden rows of a staged output-weight chunk
constexpr int DC = 768;      // output columns a pass keeps in registers
constexpr int XS = BM + 4;   // row stride of the transposed (., BM) tiles
constexpr int RS = BF + 4;   // row stride of the staged (BK, BF) weights
constexpr int WS2 = DC + 4;  // row stride of the staged (BK2, DC) weights

__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// acc[i][q] = sum_{k < d} rows[ty*8 + i][k] * R[k][f0 + tx*4 + q]: the
// thread's 8 x 4 part of one (BM, BF) tile of x wi or x wg (kTransR
// false: R[k][c] = w[k * f + c]) or of dy wo^T (kTransR true:
// R[k][c] = w[c * d + k]). `rows` points at the block's first row
// (row stride d); rows past `nrows`, depth past d and columns past f read
// as zeros. `lt` ([BK][XS]) and `rs` ([BK][RS]) are the staging buffers.
// Starts with a barrier, so the caller's earlier reads of any shared
// buffer are done before the staging writes.
template <typename T, bool kTransR>
__device__ __forceinline__ void tile_product(
    float acc[8][4], const T* __restrict__ rows, int nrows,
    const T* __restrict__ w, int d, int f, int f0, float* lt, float* rs) {
  const int tid = threadIdx.x, ty = tid >> 6, tx = tid & 63;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  for (int k0 = 0; k0 < d; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, k = i % BK;
      lt[k * XS + r] = (r < nrows && k0 + k < d)
                           ? to_f32(rows[(size_t)r * d + k0 + k])
                           : 0.f;
    }
    for (int i = tid; i < BK * BF; i += kThreads) {
      // Neighbouring threads read neighbouring addresses of w.
      const int k = kTransR ? i % BK : i / BF;
      const int c = kTransR ? i / BK : i % BF;
      const bool ok = k0 + k < d && f0 + c < f;
      const size_t at = kTransR ? (size_t)(f0 + c) * d + k0 + k
                                : (size_t)(k0 + k) * f + f0 + c;
      rs[k * RS + c] = ok ? to_f32(w[at]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float lv[8];
      load8(lt + k * XS + ty * 8, lv);
      const float4 wv = *reinterpret_cast<const float4*>(rs + k * RS + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] += lv[i] * wv.x;
        acc[i][1] += lv[i] * wv.y;
        acc[i][2] += lv[i] * wv.z;
        acc[i][3] += lv[i] * wv.w;
      }
    }
  }
}

// acc[i][4*jj + q] += sum_{c < BF} L[c][ty*8 + i] * W[c][c0 + tx*4 +
// 256*jj + q] over one f tile (hidden columns f0 ..), plus the same with
// (L2, W2) when kTwo: the thread's 8 x 12 part of the block's (BM, DC)
// output columns from c0. L, L2 are (BF, BM) tiles in shared memory (row
// stride XS). W[c][j] is w[j * f + f0 + c] (wi^T, wg^T); hidden rows past
// f and columns past d read as zeros. `ws`, `ws2` ([BK2][WS2]) are the
// staging buffers. Starts with a barrier.
template <typename T, bool kTwo>
__device__ __forceinline__ void out_product(
    float acc[8][12], const float* lt, const T* __restrict__ w,
    const float* lt2, const T* __restrict__ w2, float* ws, float* ws2,
    int d, int f, int f0, int c0) {
  const int tid = threadIdx.x, ty = tid >> 6, tx = tid & 63;
  for (int kk = 0; kk < BF && f0 + kk < f; kk += BK2) {
    __syncthreads();
    for (int i = tid; i < BK2 * DC; i += kThreads) {
      const int k = i % BK2, j = i / BK2;
      const bool ok = f0 + kk + k < f && c0 + j < d;
      const size_t at = (size_t)(c0 + j) * f + f0 + kk + k;
      ws[k * WS2 + j] = ok ? to_f32(w[at]) : 0.f;
      if (kTwo) ws2[k * WS2 + j] = ok ? to_f32(w2[at]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK2; ++k) {
      float lv[8], lv2[8];
      load8(lt + (kk + k) * XS + ty * 8, lv);
      if (kTwo) load8(lt2 + (kk + k) * XS + ty * 8, lv2);
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) {
        const int at = k * WS2 + tx * 4 + jj * 256;
        const float4 wv = *reinterpret_cast<const float4*>(ws + at);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][jj * 4 + 0] += lv[i] * wv.x;
          acc[i][jj * 4 + 1] += lv[i] * wv.y;
          acc[i][jj * 4 + 2] += lv[i] * wv.z;
          acc[i][jj * 4 + 3] += lv[i] * wv.w;
        }
        if (kTwo) {
          const float4 wv2 = *reinterpret_cast<const float4*>(ws2 + at);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][jj * 4 + 0] += lv2[i] * wv2.x;
            acc[i][jj * 4 + 1] += lv2[i] * wv2.y;
            acc[i][jj * 4 + 2] += lv2[i] * wv2.z;
            acc[i][jj * 4 + 3] += lv2[i] * wv2.w;
          }
        }
      }
    }
  }
}

// Write the thread's 8 x 12 output part (rows ty*8 + i < nrows, columns
// c0 + tx*4 + 256*jj + q < d) of the block whose first row is `out`.
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ out,
                                           const float acc[8][12],
                                           int nrows, int d, int c0) {
  const int tid = threadIdx.x, ty = tid >> 6, tx = tid & 63;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (r >= nrows) continue;
#pragma unroll
    for (int jj = 0; jj < 3; ++jj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + tx * 4 + jj * 256 + q;
        if (c < d) out[(size_t)r * d + c] = from_f32<T>(acc[i][jj * 4 + q]);
      }
  }
}

}  // namespace
