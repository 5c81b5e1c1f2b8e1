// Paged chunked-prefill GQA attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_prefill.py:66
// (_prefill_kernel, reached through paged_prefill_attention_pallas).
//
// For chunk lane c, row i < lens[c] of query head h attends pool
// positions <= starts[c] + i (causal on ABSOLUTE positions: the chunk's
// own k/v, earlier chunks and shared prefix blocks are all just pool
// reads; the mixed step wrote the chunk before attention), read through
// block_tables[c] from the (P, bs, Kh, dh) pools, GQA group G = H / Kh.
// Rows i >= lens[c] and rows with no valid key are exact zeros.
//
// Bound on this card: the live (row, key) pairs need 4 * dh FLOPs each,
// over the blocks the chunk rows attend. Held to the tensor cores' rate
// (3 * FLOPs / 495 TFLOP/s for float32 as 3xTF32, mma_sm90.cuh) it is
// ~0.0007 ms at the serve shapes (two 64-row lanes at positions 192 and
// 256, granite's 16/8 heads of 64), 0.0017 ms on CUDA cores. At that
// size the launch and the walk's latency, not the card's rates, set the
// time.
//
// Design: the flash forward's warp layout (flash_attention.cu) over
// paged K/V. One block of 4 warps per (tile of bq = 64 / G chunk rows,
// kv head kh, lane c); its 64 rows are r = i*G + g (chunk row qi*bq + i
// of head kh*G + g), so the group shares every K/V tile, and each warp
// owns 16 rows. Q is staged once. K/V tiles of 32 keys are gathered
// through the block table key by key (key t sits in pool block
// tables[c, t / bs] at slot t % bs, its dh values contiguous) as 16-byte
// cp.async chunks into a 2-stage ring, so any block size works. Each
// warp runs flash_tile.cuh's step: S = Q K^T into registers (mma.sync
// for a bf16 output; f32 FMAs for a float32 one, below), the online
// softmax there, P V on mma.sync from the score registers. The walk stops
// at the tile's last live key, min(starts[c] + min((qi+1)*bq, lens[c]),
// nb*bs); a tile past lens[c] walks nothing, and only tiles that cross
// the first row's causal limit are masked. Head dims 16/32/64/128, GQA
// groups up to 64, f32 or bf16 queries against f32 or bf16 pools.
//
// Split walk: at the serve shapes the grid is 2 lanes x 8 kv heads x 2
// q tiles = 32 blocks on 132 SMs, each walking up to 10 tiles one after
// another (a deeper K/V ring timed no faster: the walk waits on each
// tile's dependent products, not on its loads). With splits > 1 each
// (q tile, kv head, lane) walk is cut into `splits` even runs of its
// live tiles, one block each, which write their unnormalised partial
// (acc, m, l) to an f32 scratch; prefill_kernel_combine then rescales
// and sums the runs of each row (flash-decoding's split-KV).

#include "flash_tile.cuh"
#include "split_walk.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // query rows (chunk row x head) a block
constexpr int kStages = 2;     // K/V tiles in flight

template <typename TQ, typename TKV, int DH>
struct Layout {
  static constexpr int LDQ = DH + (sizeof(TQ) == 4 ? 4 : 8);  // row strides
  static constexpr int LDKV = DH + (sizeof(TKV) == 4 ? 4 : 8);
  static constexpr int KVT = kBK * LDKV;  // a K or V tile
  static constexpr size_t QBYTES = sizeof(TQ) * kRows * LDQ;
  static constexpr size_t BYTES = QBYTES + sizeof(TKV) * 2 * kStages * KVT;
};

template <typename TQ, typename TKV, int DH>
__global__ void __launch_bounds__(kThreads)
    prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                   const TKV* __restrict__ vp, const int* __restrict__ tables,
                   const int* __restrict__ starts,
                   const int* __restrict__ lens, TQ* __restrict__ out,
                   float* __restrict__ part, int C, int H, int Kh, int bs,
                   int nb, int bq, int splits, float scale) {
  using L = Layout<TQ, TKV, DH>;
  constexpr int VQ = 16 / sizeof(TQ), VK = 16 / sizeof(TKV), NO = DH / 8;
  // A float32 output takes its scores from f32 FMAs (flash_tile.cuh):
  // with mma scores, a mixed step of granite at the reference's init (|q|
  // up to 31, |k| up to 42) left the float32 tolerance, which FMA scores
  // hold, for a little more time at the serve shapes.
  constexpr bool kFmaScores = std::is_same<TQ, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TQ* qs = reinterpret_cast<TQ*>(smem_raw);
  // Stage s: K, V at kv + (2s, 2s + 1) KVT.
  TKV* kv = reinterpret_cast<TKV*>(smem_raw + L::QBYTES);

  const int qi = blockIdx.x, kh = blockIdx.y;
  const int c = blockIdx.z / splits, sp = blockIdx.z % splits;
  const int G = H / Kh, R = bq * G, row0 = qi * bq;
  const int st = starts[c], ln = min(lens[c], C);
  // The walk stops at `limit`; keys below `full` are valid for every
  // live row of the tile.
  const int limit = row0 < ln ? min(st + min(row0 + bq, ln), nb * bs) : 0;
  const int full = min(st + row0 + 1, limit);
  const int nlive = limit > 0 ? (limit + kBK - 1) / kBK : 0;
  // This block's run of the walk: tiles j0 .. j1 - 1.
  const int per = (nlive + splits - 1) / splits;
  const int j0 = min(sp * per, nlive), j1 = min(j0 + per, nlive);

  for (int x = threadIdx.x; x < kRows * DH / VQ; x += kThreads) {
    const int r = x / (DH / VQ), cc = (x % (DH / VQ)) * VQ;
    const int i = row0 + r / G;
    const bool ok = r < R && i < C;
    const size_t row = ((size_t)c * C + i) * H + kh * G + r % G;
    cp_async16(qs + r * L::LDQ + cc, ok ? q + row * DH + cc : q, ok);
  }
  const int* tab = tables + (size_t)c * nb;
  auto load = [&](int j) {
    TKV* ks = kv + (j % kStages) * 2 * L::KVT;
    for (int x = threadIdx.x; x < kBK * DH / VK; x += kThreads) {
      const int kk = x / (DH / VK), cc = (x % (DH / VK)) * VK;
      const int t = j * kBK + kk;
      const bool ok = t < limit;
      size_t at = 0;
      if (ok) at = (((size_t)tab[t / bs] * bs + t % bs) * Kh + kh) * DH + cc;
      cp_async16(ks + kk * L::LDKV + cc, kp + at, ok);
      cp_async16(ks + L::KVT + kk * L::LDKV + cc, vp + at, ok);
    }
  };
#pragma unroll
  for (int j = j0; j < j0 + kStages - 1; ++j) {
    if (j < j1) load(j);
    cp_async_commit();  // Q's copy joins the first group
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tg = lane & 3;
  // The absolute positions of the thread's two rows (gr and gr + 8 of
  // the warp's 16).
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pos[h] = st + row0 + (16 * warp + gr + 8 * h) / G;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4] = {};
  const TQ* qw = qs + 16 * warp * L::LDQ;

  for (int j = j0; j < j1; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // Q and tile j are in; every warp is done with j - 1
    if (j + kStages - 1 < j1) load(j + kStages - 1);
    cp_async_commit();
    const TKV* ks = kv + (j % kStages) * 2 * L::KVT;
    const int kv0 = j * kBK;
    attend_tile<TQ, TKV, DH, L::LDQ, L::LDKV, kFmaScores>(
        qw, ks, ks + L::KVT, kv0, kv0 + kBK > full,
        [&](int t, int h) { return t <= pos[h] && t < limit; }, scale, m, l,
        acc);
  }
  cp_async_wait<0>();  // Q's copy when no tile was live

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const size_t nr = (size_t)gridDim.z / splits * C * H;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + gr + 8 * h, i = row0 + r / G;
    if (r >= R || i >= C) continue;
    const size_t row = ((size_t)c * C + i) * H + kh * G + r % G;
    if (splits > 1) {
      const Partials<DH> pt(part, splits, nr);
      const size_t at = (size_t)sp * nr + row;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pt.acc[at * DH + 8 * n + 2 * tg + e] = acc[n][2 * h + e];
        }
      if (tg == 0) {
        pt.ml[2 * at] = m[h];
        pt.ml[2 * at + 1] = l[h];
      }
      continue;
    }
    const bool live = i < ln && l[h] > 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        out[row * DH + 8 * n + 2 * tg + e] =
            from_f32<TQ>(live ? acc[n][2 * h + e] / l[h] : 0.f);
      }
  }
}

// The runs of a split walk summed (split_walk.cuh): one warp per query
// row (c, i, head). Rows i >= lens[c] and rows with no valid key are
// exact zeros.
template <typename TQ, int DH>
__global__ void __launch_bounds__(kThreads)
    prefill_kernel_combine(const float* __restrict__ part,
                           const int* __restrict__ lens,
                           TQ* __restrict__ out, int NC, int C, int H,
                           int splits) {
  const size_t nr = (size_t)NC * C * H;
  const size_t row = (size_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= nr) return;
  const int c = (int)(row / ((size_t)C * H)), i = (int)(row / H % C);
  combine_runs<TQ, DH>(part, nr, splits, row, i < min(lens[c], C), out);
}

template <typename TQ, typename TKV, int DH>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* starts, const void* lens, void* out, void* part,
           int NC, int C, int H, int Kh, int bs, int nb, int bq, int splits,
           cudaStream_t stream) {
  auto kernel = prefill_kernel<TQ, TKV, DH>;
  const size_t smem = Layout<TQ, TKV, DH>::BYTES;
  allow_smem(kernel, smem);
  const float scale = (float)(1.0 / sqrt((double)DH));
  kernel<<<dim3((C + bq - 1) / bq, Kh, NC * splits), kThreads, smem,
           stream>>>((const TQ*)q, (const TKV*)kp, (const TKV*)vp,
                     (const int*)tables, (const int*)starts,
                     (const int*)lens, (TQ*)out, (float*)part, C, H, Kh, bs,
                     nb, bq, splits, scale);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || splits == 1) return rc;
  const size_t rows = (size_t)NC * C * H, per = kThreads / 32;
  prefill_kernel_combine<TQ, DH><<<(rows + per - 1) / per, kThreads, 0,
                                   stream>>>(
      (const float*)part, (const int*)lens, (TQ*)out, NC, C, H, splits);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_dh(int dh, const void* q, const void* kp, const void* vp,
              const void* tables, const void* starts, const void* lens,
              void* out, void* part, int NC, int C, int H, int Kh, int bs,
              int nb, int bq, int splits, cudaStream_t s) {
  switch (dh) {
    case 16:
      return launch<TQ, TKV, 16>(q, kp, vp, tables, starts, lens, out, part,
                                 NC, C, H, Kh, bs, nb, bq, splits, s);
    case 32:
      return launch<TQ, TKV, 32>(q, kp, vp, tables, starts, lens, out, part,
                                 NC, C, H, Kh, bs, nb, bq, splits, s);
    case 64:
      return launch<TQ, TKV, 64>(q, kp, vp, tables, starts, lens, out, part,
                                 NC, C, H, Kh, bs, nb, bq, splits, s);
    case 128:
      return launch<TQ, TKV, 128>(q, kp, vp, tables, starts, lens, out, part,
                                 NC, C, H, Kh, bs, nb, bq, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (NC,C,H,dh), pools (P,bs,Kh,dh), tables (NC,nb), starts/lens (NC,)
// int32 -> out (NC,C,H,dh) in q's type; q and the pools 16-byte
// aligned, dh in {16, 32, 64, 128}; bq chunk rows a block, bq * (H/Kh)
// <= 64. With splits > 1, part is an f32 scratch of splits * NC * C * H
// * (dh + 2) values. One launch, two when split, on `stream`; no sync,
// no allocation.
extern "C" int paged_prefill_attention(const void* q, const void* kp,
                                       const void* vp, const void* tables,
                                       const void* starts, const void* lens,
                                       void* out, void* part, int NC, int C,
                                       int H, int Kh, int dh, int bs, int nb,
                                       int bq, int splits, int q_bf16,
                                       int kv_bf16, void* stream) {
  if (Kh < 1 || H % Kh != 0 || bq < 1 || bq * (H / Kh) > kRows ||
      bs < 1 || Kh > 65535 || splits < 1 || (long)NC * splits > 65535 ||
      (splits > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  using bf = __nv_bfloat16;
  auto go = [&](auto fn) {
    return fn(dh, q, kp, vp, tables, starts, lens, out, part, NC, C, H, Kh,
              bs, nb, bq, splits, s);
  };
  if (q_bf16) {
    return kv_bf16 ? go(launch_dh<bf, bf>) : go(launch_dh<bf, float>);
  }
  return kv_bf16 ? go(launch_dh<float, bf>) : go(launch_dh<float, float>);
}
