// Dense GQA flash-attention forward for Hopper (sm_90a), returning the
// output and the per-row log-sum-exp the backward kernels need.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:94
// (_kernel, reached through flash_attention_pallas with
// return_residuals=True).
//
// Bound on this card: the live (query, key) pairs need 4 * dh FLOPs
// each against a few bytes, so the products bound it. float32 runs P V
// on tensor cores as 3xTF32 (mma_sm90.cuh) and its scores as f32 FMAs;
// the bound takes every product as 3xTF32, max(bytes / 3.35 TB/s,
// 3 * FLOPs / 495 TFLOP/s): granite's training shapes (B 16, S 512, H
// 16, Kh 8, dh 64, causal; 8.6 GFLOP, ~100 MB) 0.052 ms, 0.1285 on CUDA
// cores at 67 TFLOP/s; the ViT's (104, 196, 12, 64), non-causal, 0.074
// ms (0.1832).
//
// Design (FlashAttention-2's shape): one block of 4 warps per (tile of
// bq = 64 / G query positions, kv head kh, batch b). With G = H/Kh the
// block's 64 rows are r = i*G + g (query row qi*bq + i of head kh*G + g),
// so the G heads of one kv head share every K/V tile; each warp owns 16
// rows. Q is staged once; K/V tiles of 32 keys stream through a 2-stage
// cp.async ring (rows padded so that fragment reads are free of bank
// conflicts; 32-key tiles keep a block at 52 KB of shared memory in f32,
// against 87 KB at 64 keys, so more blocks share an SM: 64-key tiles
// timed slower on the card).
// A warp computes its 16 x 32 scores S = Q K^T into registers (bf16:
// mma.sync; float32: f32 FMAs, see below), takes the online softmax
// (m, l) there with quad shuffles for the row max, and adds P V into
// its 16 x dh output straight from the score registers
// (flash_tile.cuh's attend_tile, which the paged prefill shares).
// Query row i sits at q_offset + i and attends key t iff t < kv_len
// and, when causal, t <= q_offset + i; q_offset and kv_len are read
// from device memory. The walk stops at the tile's last live key, so a
// causal tile wholly in the future is never visited, and only tiles
// that cross the diagonal or kv_len are masked.
// A row with no valid key gives exact zeros and lse = +inf (so exp(s -
// lse) = 0 in the backward).

#include "flash_tile.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // query rows (position x head) a block

template <typename T, int DH>
struct Layout {
  static constexpr int LD = DH + (sizeof(T) == 4 ? 4 : 8);  // row stride
  static constexpr int QT = kRows * LD, KVT = kBK * LD;  // Q, K or V tile
  static constexpr size_t BYTES = sizeof(T) * (QT + 4 * KVT);  // 2 stages
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ qoff_p,
                     const int* __restrict__ kvlen_p, T* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Skv, int H, int Kh,
                     int bq, int causal, float scale) {
  constexpr int LD = Layout<T, DH>::LD, KVT = Layout<T, DH>::KVT;
  constexpr int V = 16 / sizeof(T), NO = DH / 8;
  // float32 scores are f32 FMAs (flash_tile.cuh): at |q|, |k| ~ 30-40,
  // as granite's reference init gives them, the mma scores left the
  // float32 tolerance (tests/test_torch_kernels.py::
  // test_flash_kernels_hold_large_scores).
  constexpr bool kFmaScores = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* kv = qs + Layout<T, DH>::QT;  // stage s: K, V at kv + (2s, 2s+1) KVT

  // Heavier (later) causal tiles first.
  const int qi = gridDim.x - 1 - blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kh, R = bq * G, row0 = qi * bq;
  const int qoff = *qoff_p;
  const int kvlen = min(*kvlen_p, Skv);
  // Keys past `limit` are masked for every row of the tile; keys below
  // `full` are valid for every row.
  int limit = kvlen, full = kvlen;
  if (causal) {
    limit = min(limit, qoff + min(row0 + bq, Sq));
    full = min(full, qoff + row0 + 1);
  }
  const int nlive = limit > 0 ? (limit + kBK - 1) / kBK : 0;

  for (int x = threadIdx.x; x < kRows * DH / V; x += kThreads) {
    const int r = x / (DH / V), c = (x % (DH / V)) * V;
    const int i = row0 + r / G;
    const bool ok = r < R && i < Sq;
    const size_t row = ((size_t)b * Sq + i) * H + kh * G + r % G;
    const T* src = ok ? q + row * DH + c : q;
    cp_async16(qs + r * LD + c, src, ok);
  }
  const size_t kv_ld = (size_t)Kh * DH;
  const T* kb = k + ((size_t)b * Skv * Kh + kh) * DH;
  const T* vb = v + ((size_t)b * Skv * Kh + kh) * DH;
  auto load = [&](int j) {
    T* s = kv + (j & 1) * 2 * KVT;
    const int kv0 = j * kBK, nr = min(kBK, kvlen - kv0);
    stage_tile<T, kBK, DH, kThreads>(s, LD, kb + kv0 * kv_ld, kv_ld, nr, DH,
                                     true);
    stage_tile<T, kBK, DH, kThreads>(s + KVT, LD, vb + kv0 * kv_ld, kv_ld,
                                     nr, DH, true);
  };
  if (nlive > 0) load(0);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tg = lane & 3;
  // The thread's two rows (gr and gr + 8 of the warp's 16) and their
  // query positions.
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pos[h] = qoff + row0 + (16 * warp + gr + 8 * h) / G;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4] = {};
  const T* qw = qs + 16 * warp * LD;

  for (int j = 0; j < nlive; ++j) {
    if (j + 1 < nlive) load(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // Q and tile j are in
    const T* ks = kv + (j & 1) * 2 * KVT;
    const T* vs = ks + KVT;
    const int kv0 = j * kBK;

    attend_tile<T, T, DH, LD, LD, kFmaScores>(
        qw, ks, vs, kv0, kv0 + kBK > full,
        [&](int t, int h) { return t < kvlen && (!causal || t <= pos[h]); },
        scale, m, l, acc);
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // Q's copy when no tile was live

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + gr + 8 * h, i = row0 + r / G;
    if (r >= R || i >= Sq) continue;
    const int head = kh * G + r % G;
    T* orow = o + (((size_t)b * Sq + i) * H + head) * DH;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        orow[8 * n + 2 * tg + e] =
            from_f32<T>(l[h] > 0.f ? acc[n][2 * h + e] / l[h] : 0.f);
      }
    if (tg == 0) {
      lse[((size_t)b * H + head) * Sq + i] =
          l[h] > 0.f ? m[h] + logf(l[h]) : INFINITY;
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* qoff,
           const void* kvlen, void* o, void* lse, int B, int Sq, int Skv,
           int H, int Kh, int bq, int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DH>;
  const size_t smem = Layout<T, DH>::BYTES;
  allow_smem(kernel, smem);
  const float scale = (float)(1.0 / sqrt((double)DH));
  kernel<<<dim3((Sq + bq - 1) / bq, Kh, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)qoff,
      (const int*)kvlen, (T*)o, (float*)lse, Sq, Skv, H, Kh, bq, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(int dh, const void* q, const void* k, const void* v,
             const void* qoff, const void* kvlen, void* o, void* lse, int B,
             int Sq, int Skv, int H, int Kh, int bq, int causal,
             cudaStream_t s) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, qoff, kvlen, o, lse, B, Sq, Skv, H, Kh,
                           bq, causal, s);
    case 32:
      return launch<T, 32>(q, k, v, qoff, kvlen, o, lse, B, Sq, Skv, H, Kh,
                           bq, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, qoff, kvlen, o, lse, B, Sq, Skv, H, Kh,
                           bq, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, qoff, kvlen, o, lse, B, Sq, Skv, H, Kh,
                            bq, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B,Sq,H,dh), k/v (B,Skv,Kh,dh) of one type (f32 or bf16), 16-byte
// aligned, dh in {16, 32, 64, 128}; q_offset and kv_len are int32
// scalars in device memory -> o (B,Sq,H,dh) in q's type, lse (B,H,Sq)
// f32. bq query positions a block, bq * (H/Kh) <= 64. Launches on
// `stream`; no sync, no allocation.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* qoff,
                                   const void* kvlen, void* o, void* lse,
                                   int B, int Sq, int Skv, int H, int Kh,
                                   int dh, int bq, int causal, int bf16,
                                   void* stream) {
  if (Kh < 1 || H % Kh != 0 || bq < 1 || bq * (H / Kh) > kRows ||
      Kh > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  if (bf16) {
    return launch_t<__nv_bfloat16>(dh, q, k, v, qoff, kvlen, o, lse, B, Sq,
                                   Skv, H, Kh, bq, causal, s);
  }
  return launch_t<float>(dh, q, k, v, qoff, kvlen, o, lse, B, Sq, Skv, H, Kh,
                         bq, causal, s);
}
