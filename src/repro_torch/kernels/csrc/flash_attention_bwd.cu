// Dense GQA flash-attention backward for Hopper (sm_90a): two kernels,
// dq and dk/dv, sharing the forward's masking and recomputing each
// probability tile from (q, k, lse) instead of storing it.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py:256
// (_dq_kernel) and :285 (_dkv_kernel), reached through
// _flash_attention_pallas_bwd; each tile pair recomputes, as
// _recompute_p_ds does,
//   p  = exp(q k^T * scale - lse)   (0 where masked),
//   ds = p * (dO v^T - delta),      delta = rowsum(dO * O) (given).
//
// Bound on this card: the live (query, key) pairs need 6 * dh FLOPs
// each in dq (q k^T, dO v^T, ds k) and 8 * dh in dk/dv (q k^T, dO v^T,
// p^T dO, ds^T q) against a few bytes, so the products bound both.
// float32 runs on tensor cores as 3xTF32 (mma_sm90.cuh), held to
// max(bytes / 3.35 TB/s, 3 * FLOPs / 495 TFLOP/s): at granite's
// training shapes (B 16, S 512, H 16, Kh 8, dh 64, causal) dq 0.078 ms
// and dk/dv 0.104 (0.193 and 0.257 on CUDA cores at 67 TFLOP/s); at the
// ViT's (104, 196, 12, 64), non-causal, 0.112 and 0.149 (0.275, 0.366).
//
// Rows. Both kernels see the queries of kv head kh as one run of Sq * G
// rows (G = H / Kh), r = i * G + g: query position i of head kh * G + g.
// A tile of rows may hold parts of two positions; each row carries its
// own position for the mask, so any G is taken and no row is padding
// but the tail past Sq * G. Query row i sits at q_offset + i and
// attends key t iff t < kv_len and, when causal, t <= q_offset + i;
// q_offset and kv_len are read from device memory. Rows with lse = +inf
// (no valid key) give exactly zero, and so do rows past the tail: their
// q and dO are zero-filled, so p = exp(0 - lse) meets dO = 0 and dP = 0.
// Both grids put the tile index in their slowest dimension, so the
// heaviest causal tiles of every (kv head, batch) start first and the
// light ones fill the tail (a tile-fastest order timed slower on the
// card at both training shapes).
//
// dq: the forward's shape. One block of 4 warps per (64 rows, kv head,
// batch); each warp owns 16 rows and skips its products when they all
// lie past the tail. Q and dO are staged once, lse and delta sit in
// registers, and K/V tiles of 32 keys stream through a 2-stage cp.async
// ring (rows padded so that fragment reads are free of bank conflicts).
// For each tile a warp computes S = Q K^T and dP = dO V^T (16 x 32 each,
// mma.sync into registers), p and ds = p (dP - delta) in place, and dQ
// += ds K with ds taken straight from the registers (warp_mma_cfrag).
// The walk stops at the block's last live key; only tiles that cross
// the diagonal or kv_len are masked.
//
// dk/dv: key-major. One block per (64 keys, kv head, batch), each warp
// owning 16 keys; K and V are staged once. The block walks the q tiles
// of 32 rows that can see its keys (causal: from the tile holding the
// first row at a position >= its first key), streaming Q, dO and the
// tile's lse and delta through a 2-stage cp.async ring (32-row tiles
// keep a block at 70 KB and 168 registers at dh 64, three blocks an SM;
// 64-row tiles timed slower on the card). A warp computes S^T = K Q^T and
// dP^T = V dO^T in transposed form, so that p^T and ds^T sit in
// registers as A fragments, and adds dV += p^T dO and dK += ds^T Q
// through warp_mma_cfrag: no shared-memory round trip, no transposed
// copy. A warp skips a tile whose rows see none of its keys; only tiles
// that cross the diagonal or kv_len are masked, the causal mask as a row
// threshold (row r sees key t iff r >= (t - q_offset) * G). The G heads
// of the group are summed inside the block (no per-head buffers, no
// atomics); a kv tile past kv_len, or one no query sees, writes zeros.
// dK is scaled once at the end.
//
// The tensor cores' f32 sums truncate (mma_sm90.cuh), so every product
// of one tile (and, within it, of up to 32 output columns) starts from
// zero and is added to the running f32 sum with an ordinary add.
// bfloat16 runs S and dP as mma_bf16 with f32 sums; p and ds stay f32
// and meet the bf16 K, Q or dO in two TF32 products (bf16 is exact in
// TF32).

#include <limits.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // dq: query rows a block, 16 a warp
constexpr int kBK = 32;        // dq: keys a streamed K/V tile
constexpr int kKeys = 64;      // dk/dv: keys a block, 16 a warp
constexpr int kChunk = 4;      // 8-column tiles of one fresh product

// Shared-memory row stride (elements): rows stay 16-byte aligned for
// cp.async and fragment reads free of bank conflicts.
template <typename T, int DH>
__host__ __device__ constexpr int row_stride() {
  return DH + (sizeof(T) == 4 ? 4 : 8);
}

template <typename T, int DH>
struct DqLayout {
  static constexpr int LD = row_stride<T, DH>();
  static constexpr int QT = kRows * LD, KVT = kBK * LD;
  // Q, dO; then K, V of stage s at 2 QT + (2s, 2s+1) KVT.
  static constexpr size_t BYTES = sizeof(T) * (2 * QT + 4 * KVT);
};

template <typename T, int DH>
struct DkvLayout {
  static constexpr int LD = row_stride<T, DH>();
  static constexpr int KQ = 32;  // q rows a q tile
  static constexpr int KVT = kKeys * LD, QT = KQ * LD;
  // K, V; Q, dO of stage s at 2 KVT + (2s, 2s+1) QT; then, as float,
  // lse and delta of stage s at (2s, 2s+1) KQ.
  static constexpr size_t BYTES =
      sizeof(T) * (2 * KVT + 4 * QT) + sizeof(float) * 4 * KQ;
};

// A 4-byte cp.async, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

// Stage rows r0 .. r0 + ROWS - 1 of kv head kh's run of rows (row r is
// src[b, r / G, kh * G + r % G, :], `bq0` = b * Sq) as cp.async chunks;
// rows at or past `nrows` are zero-filled.
template <typename T, int ROWS, int DH>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int r0, int nrows, int G, int kh,
                                           int H, size_t bq0) {
  constexpr int V = 16 / sizeof(T), LD = row_stride<T, DH>();
  for (int x = threadIdx.x; x < ROWS * DH / V; x += kThreads) {
    const int r = x / (DH / V), c = (x % (DH / V)) * V;
    const int rr = r0 + r, i = rr / G;
    const bool ok = rr < nrows;
    const T* p =
        ok ? src + ((bq0 + i) * H + kh * G + (rr - i * G)) * DH + c : src;
    cp_async16(dst + r * LD + c, p, ok);
  }
}

// As warp_mma_cfrag<float> for a B of bf16 values (`b` returns them as
// float), which TF32 holds exactly: P split, two TF32 products. p and ds
// stay f32 for bf16 inputs too; rounding them to bf16 would cost the
// bf16 tolerance over a long sum (the dk of a 64-head group).
template <int NI, int K, typename FB>
__device__ __forceinline__ void cfrag_mma_bf16b(float (&acc)[NI][4],
                                                const float (&p)[K / 8][4],
                                                FB b) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    uint32_t ab[4], as[4];
    split_tf32(p[j][0], ab[0], as[0]);
    split_tf32(p[j][2], ab[1], as[1]);
    split_tf32(p[j][1], ab[2], as[2]);
    split_tf32(p[j][3], ab[3], as[3]);
    const int k = 8 * j + 2 * tg;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const uint32_t bb[2] = {__float_as_uint(b(k, 8 * ni + gr)),
                              __float_as_uint(b(k + 1, 8 * ni + gr))};
      mma_tf32(acc[ni], as, bb);
      mma_tf32(acc[ni], ab, bb);
    }
  }
}

// acc[n] += P B over P's K columns, P in registers in the accumulator
// layout (warp_mma_cfrag), in chunks of kChunk output tiles: each chunk's
// product starts from zero and is added to acc in f32.
template <typename T, int NO, int K, typename FB>
__device__ __forceinline__ void cfrag_add(float (&acc)[NO][4],
                                          const float (&p)[K / 8][4], FB b) {
  constexpr int NC = NO < kChunk ? NO : kChunk;
#pragma unroll
  for (int c0 = 0; c0 < NO; c0 += NC) {
    float part[NC][4] = {};
    auto bc = [&](int k, int n) { return b(k, 8 * c0 + n); };
    if constexpr (std::is_same<T, float>::value) {
      warp_mma_cfrag<T, NC, K>(part, p, bc);
    } else {
      cfrag_mma_bf16b<NC, K>(part, p, bc);
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 + n][e] += part[n][e];
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ qoff_p,
                    const int* __restrict__ kvlen_p, T* __restrict__ dq,
                    int Sq, int Skv, int H, int Kh, int causal,
                    float scale) {
  using L = DqLayout<T, DH>;
  constexpr int LD = L::LD, KVT = L::KVT, NO = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + L::QT;
  T* kv = dos + L::QT;

  // Heavier (later) causal tiles first, over the whole grid.
  const int qi = gridDim.z - 1 - blockIdx.z, kh = blockIdx.x, b = blockIdx.y;
  const int G = H / Kh, nrows = Sq * G, r0 = qi * kRows;
  const int qoff = *qoff_p;
  const int kvlen = min(*kvlen_p, Skv);
  // Keys past `limit` are masked for every row of the block; keys below
  // `full` are valid for every row.
  int limit = kvlen, full = kvlen;
  if (causal) {
    limit = min(limit, qoff + (min(r0 + kRows, nrows) - 1) / G + 1);
    full = min(full, qoff + r0 / G + 1);
  }
  const int nlive = limit > 0 ? (limit + kBK - 1) / kBK : 0;

  stage_rows<T, kRows, DH>(qs, q, r0, nrows, G, kh, H, (size_t)b * Sq);
  stage_rows<T, kRows, DH>(dos, dout, r0, nrows, G, kh, H, (size_t)b * Sq);
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
  // The thread's two rows (gr and gr + 8 of the warp's 16): query
  // position, lse and delta.
  int pos[2];
  float lse_r[2], del_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + gr + 8 * h, i = r / G;
    pos[h] = qoff + i;
    lse_r[h] = INFINITY;
    del_r[h] = 0.f;
    if (r < nrows) {
      const size_t at = ((size_t)b * H + kh * G + (r - i * G)) * Sq + i;
      lse_r[h] = lse[at];
      del_r[h] = delta[at];
    }
  }
  float acc[NO][4] = {};
  const T* qw = qs + 16 * warp * LD;
  const T* dow = dos + 16 * warp * LD;
  const bool warp_live = r0 + 16 * warp < nrows;

  for (int j = 0; j < nlive; ++j) {
    if (j + 1 < nlive) load(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // Q, dO and tile j are in
    const T* ks = kv + (j & 1) * 2 * KVT;
    const T* vs = ks + KVT;
    const int kv0 = j * kBK;
    if (!warp_live) {
      __syncthreads();
      continue;
    }

    float s[1][kBK / 8][4] = {}, dp[1][kBK / 8][4] = {};
    warp_mma<T, T, 1, kBK / 8, DH>(
        s, [&](int r, int c) { return to_f32(qw[r * LD + c]); },
        [&](int c, int n) { return to_f32(ks[n * LD + c]); });
    warp_mma<T, T, 1, kBK / 8, DH>(
        dp, [&](int r, int c) { return to_f32(dow[r * LD + c]); },
        [&](int c, int n) { return to_f32(vs[n * LD + c]); });
    const bool masked = kv0 + kBK > full;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = kv0 + 8 * n + 2 * tg + (e & 1), h = e >> 1;
        float p = expf(s[0][n][e] * scale - lse_r[h]);
        if (masked && !(t < kvlen && (!causal || t <= pos[h]))) p = 0.f;
        s[0][n][e] = p * (dp[0][n][e] - del_r[h]);  // ds
      }
    cfrag_add<T, NO, kBK>(
        acc, s[0], [&](int t, int c) { return to_f32(ks[t * LD + c]); });
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // Q's and dO's copies when no tile was live

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + gr + 8 * h;
    if (r >= nrows) continue;
    const int i = r / G;
    T* row = dq + (((size_t)b * Sq + i) * H + kh * G + (r - i * G)) * DH;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        row[8 * n + 2 * tg + e] = from_f32<T>(acc[n][2 * h + e] * scale);
      }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ qoff_p,
                     const int* __restrict__ kvlen_p, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Skv, int H, int Kh,
                     int causal, float scale) {
  using L = DkvLayout<T, DH>;
  constexpr int LD = L::LD, KQ = L::KQ, QT = L::QT, NO = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + L::KVT;
  T* ring = vs + L::KVT;
  float* rowv = reinterpret_cast<float*>(ring + 4 * QT);

  // Heavier (earlier) causal tiles first, over the whole grid.
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / Kh, nrows = Sq * G, kv0 = blockIdx.z * kKeys;
  const int qoff = *qoff_p;
  const int kvlen = min(*kvlen_p, Skv);
  const int ntiles = (nrows + KQ - 1) / KQ;
  // The q tiles that see these keys: all unless causal, then from the
  // one holding the first row at a position >= the first key; none if
  // every key is past kv_len.
  int t0 = 0;
  if (causal) {
    const long long first = (long long)G * max(0, kv0 - qoff);
    t0 = first >= nrows ? ntiles : (int)(first / KQ);
  }
  if (kv0 >= kvlen) t0 = ntiles;

  const size_t kv_ld = (size_t)Kh * DH;
  auto load = [&](int t) {
    T* s = ring + (t & 1) * 2 * QT;
    stage_rows<T, KQ, DH>(s, q, t * KQ, nrows, G, kh, H, (size_t)b * Sq);
    stage_rows<T, KQ, DH>(s + QT, dout, t * KQ, nrows, G, kh, H,
                          (size_t)b * Sq);
    // lse, then delta; zero past the tail (harmless: q and dO are zero
    // there, see the header).
    float* rv = rowv + (t & 1) * 2 * KQ;
    for (int x = threadIdx.x; x < 2 * KQ; x += kThreads) {
      const int r = t * KQ + x % KQ, i = r / G;
      const bool ok = r < nrows;
      const float* src = x < KQ ? lse : delta;
      const size_t at = ((size_t)b * H + kh * G + (r - i * G)) * Sq + i;
      cp_async4(rv + x, ok ? src + at : src, ok);
    }
  };
  if (t0 < ntiles) {
    const size_t at = ((size_t)b * Skv * Kh + kh) * DH + kv0 * kv_ld;
    const int nr = min(kKeys, kvlen - kv0);
    stage_tile<T, kKeys, DH, kThreads>(ks, LD, k + at, kv_ld, nr, DH, true);
    stage_tile<T, kKeys, DH, kThreads>(vs, LD, v + at, kv_ld, nr, DH, true);
    load(t0);
  }
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tg = lane & 3;
  // The thread's two keys and, causal, the first row that sees each
  // (row r sees key t iff r >= (t - q_offset) * G).
  int key[2], rmin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = kv0 + 16 * warp + gr + 8 * h;
    rmin[h] = causal ? (key[h] - qoff) * G : INT_MIN;
  }
  const int wkey0 = kv0 + 16 * warp;  // the warp's first key
  float dk_acc[NO][4] = {}, dv_acc[NO][4] = {};
  const T* kw = ks + 16 * warp * LD;
  const T* vw = vs + 16 * warp * LD;

  for (int t = t0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // K, V and q tile t are in
    const T* qt = ring + (t & 1) * 2 * QT;
    const T* dot = qt + QT;
    const float* lses = rowv + (t & 1) * 2 * KQ;
    const float* dels = lses + KQ;
    const int rt0 = t * KQ;
    // A warp whose keys are all past kv_len, or (causal) all after the
    // tile's last row, has nothing to add. Otherwise every pair is valid
    // unless a key is past kv_len or, causal, the tile's first row comes
    // before the warp's last key.
    if (wkey0 >= kvlen ||
        (causal && qoff + (min(rt0 + KQ, nrows) - 1) / G < wkey0)) {
      __syncthreads();
      continue;
    }
    const bool masked = wkey0 + 16 > kvlen ||
                        (causal && qoff + rt0 / G < wkey0 + 15);

    // S^T = K Q^T, then p^T in place.
    float st[1][KQ / 8][4] = {};
    warp_mma<T, T, 1, KQ / 8, DH>(
        st, [&](int r, int c) { return to_f32(kw[r * LD + c]); },
        [&](int c, int n) { return to_f32(qt[n * LD + c]); });
#pragma unroll
    for (int n = 0; n < KQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * tg + (e & 1), h = e >> 1;
        float p = expf(st[0][n][e] * scale - lses[col]);
        if (masked && !(key[h] < kvlen && rt0 + col >= rmin[h])) p = 0.f;
        st[0][n][e] = p;
      }
    cfrag_add<T, NO, KQ>(
        dv_acc, st[0], [&](int r, int c) { return to_f32(dot[r * LD + c]); });
    // dP^T = V dO^T, then ds^T = p^T (dP^T - delta) in place.
    float dpt[1][KQ / 8][4] = {};
    warp_mma<T, T, 1, KQ / 8, DH>(
        dpt, [&](int r, int c) { return to_f32(vw[r * LD + c]); },
        [&](int c, int n) { return to_f32(dot[n * LD + c]); });
#pragma unroll
    for (int n = 0; n < KQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * tg + (e & 1);
        dpt[0][n][e] = st[0][n][e] * (dpt[0][n][e] - dels[col]);
      }
    cfrag_add<T, NO, KQ>(
        dk_acc, dpt[0], [&](int r, int c) { return to_f32(qt[r * LD + c]); });
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= Skv) continue;
    const size_t off = (((size_t)b * Skv + key[h]) * Kh + kh) * DH;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * tg + e;
        dk[off + c] = from_f32<T>(dk_acc[n][2 * h + e] * scale);
        dv[off + c] = from_f32<T>(dv_acc[n][2 * h + e]);
      }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *qoff, *kvlen;
  void *dq, *dk, *dv;
  int B, Sq, Skv, H, Kh, causal;
  cudaStream_t stream;
};

template <bool kDq, typename T, int DH>
int launch(const Args& a) {
  const float scale = (float)(1.0 / sqrt((double)DH));
  if constexpr (kDq) {
    auto kernel = flash_dq_kernel<T, DH>;
    const size_t smem = DqLayout<T, DH>::BYTES;
    allow_smem(kernel, smem);
    const int nrows = a.Sq * (a.H / a.Kh);
    kernel<<<dim3(a.Kh, a.B, (nrows + kRows - 1) / kRows), kThreads, smem,
             a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (const int*)a.qoff,
        (const int*)a.kvlen, (T*)a.dq, a.Sq, a.Skv, a.H, a.Kh, a.causal,
        scale);
  } else {
    auto kernel = flash_dkv_kernel<T, DH>;
    const size_t smem = DkvLayout<T, DH>::BYTES;
    allow_smem(kernel, smem);
    kernel<<<dim3(a.Kh, a.B, (a.Skv + kKeys - 1) / kKeys), kThreads, smem,
             a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (const int*)a.qoff,
        (const int*)a.kvlen, (T*)a.dk, (T*)a.dv, a.Sq, a.Skv, a.H, a.Kh,
        a.causal, scale);
  }
  return (int)cudaGetLastError();
}

template <bool kDq, typename T>
int launch_t(int dh, const Args& a) {
  switch (dh) {
    case 16:
      return launch<kDq, T, 16>(a);
    case 32:
      return launch<kDq, T, 32>(a);
    case 64:
      return launch<kDq, T, 64>(a);
    case 128:
      return launch<kDq, T, 128>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kDq>
int launch_any(int dh, int bf16, const Args& a) {
  if (a.Kh < 1 || a.H % a.Kh != 0 || a.B > 65535 ||
      (long long)a.Sq * (a.H / a.Kh) > 65535LL * kRows ||
      a.Skv > 65535 * kKeys) {
    return (int)cudaErrorInvalidValue;
  }
  return bf16 ? launch_t<kDq, __nv_bfloat16>(dh, a)
              : launch_t<kDq, float>(dh, a);
}

}  // namespace

// q, dout (B,Sq,H,dh), k/v (B,Skv,Kh,dh) of one type (f32 or bf16),
// 16-byte aligned, dh in {16, 32, 64, 128}, any GQA group H/Kh; lse,
// delta (B,H,Sq) f32; q_offset, kv_len int32 scalars in device memory
// -> dq (B,Sq,H,dh). Launches on `stream`; no sync, no allocation.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* qoff,
                                  const void* kvlen, void* dq, int B, int Sq,
                                  int Skv, int H, int Kh, int dh, int causal,
                                  int bf16, void* stream) {
  const Args a = {q,  k,       v,       dout, lse, delta, qoff,
                  kvlen, dq, nullptr, nullptr, B, Sq,  Skv,   H,
                  Kh, causal, torch_stream(stream)};
  return launch_any<true>(dh, bf16, a);
}

// As flash_attention_dq -> dk, dv (B,Skv,Kh,dh), each summed over its kv
// head's G query heads.
extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* qoff, const void* kvlen,
                                   void* dk, void* dv, int B, int Sq, int Skv,
                                   int H, int Kh, int dh, int causal,
                                   int bf16, void* stream) {
  const Args a = {q,     k,       v,  dout, lse, delta, qoff,
                  kvlen, nullptr, dk, dv,   B,   Sq,    Skv,
                  H,     Kh,      causal, torch_stream(stream)};
  return launch_any<false>(dh, bf16, a);
}
