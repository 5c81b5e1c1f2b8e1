// Paged GQA single-query flash-decode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:65
// (_decode_kernel, reached through paged_decode_attention_pallas).
//
// Slot b's query heads of kv head kh (the GQA group, G = H / Kh) attend
// the slot's first lengths[b] pool positions, read through
// tables[b, t / bs] at slot t % bs of the (P, bs, Kh, dh) pools, with an
// online softmax in f32. A slot of length 0 gives exact zeros (the l ==
// 0 guard of the reference).
//
// Bound on this card: the bytes of each slot's keys and values below its
// length, each read once (G * dh * 4 FLOPs a key against 2 * dh * bytes:
// far below the ridge). At the serve shapes (8 slots of lengths 0..511,
// 16-token blocks, granite's 16/8 heads of 64) the 1,380 keys are 5.7 MB
// in f32, 0.0017 ms at 3.35 TB/s: at that size the launch and the
// latency of the walk, not the card's rates, set the time.
//
// Design: a split walk (flash-decoding). Each (slot, kv head, tile of GT
// query heads) walk over the slot's ceil(len / bs) live table entries is
// cut into `splits` even runs of pool blocks (the wrapper's pick_splits:
// enough blocks for four an SM), one 4-warp block a run; dead table
// entries are never read. Within a run the warps take pool blocks in
// turn, so four are in flight, each warp reading its next table entry
// ahead of the block's K/V. K and V move as 16-byte loads. A warp takes
// a block's keys 32 at a time, one a lane: the lane reads its key's row
// in chunks of 16 bytes, 8 in flight, and sums each score as one chain of
// f32 FMAs in order over dh from zero, q read from shared memory (the
// plain version's product sums in that order: at |q|, |k| ~ 30-40, as a
// random init gives them, exp() turns another order's rounding into
// errors past the float32 tolerance, which a card test holds). The
// warp's online softmax takes the 32 scores at once (two shuffle
// reductions a query head), so the walk needs no barrier. P V swaps the
// layout: dh / V lanes (V = 16 bytes of the pool's type) hold one key's
// V row, the warp 32 / (dh / V) keys at once, 8 keys a lane in flight,
// each lane summing p v over its V dims (p shuffled from the key's
// lane). At the run's end the warp's lanes are summed by shuffles and
// the four warps merged through shared memory, in a fixed order. One run
// (splits == 1) writes the normalised output; otherwise each run writes
// its partial (acc, m, l) to an f32 scratch and decode_kernel_combine
// sums the runs of each row in split order (split_walk.cuh, the paged
// prefill's combine). Scores and P V stay on CUDA cores: a single query
// row gives an mma tile of G of its 16 rows (1/8 used at G = 2), and mma
// scores left the float32 tolerance at the reference init's score sizes
// in the paged prefill. Head dims 16, 32, 64 and 128; GQA groups up to
// 64 (tiles of GT = 1, 2, 4 or 32 / V query heads, each tile a walk of
// its own); f32 or bf16 queries against f32 or bf16 pools; any block
// size.

#include "split_walk.cuh"

namespace {

constexpr int kThreads = 128, kWarps = kThreads / 32;
constexpr int kNK = 8;  // V chunks (keys) a lane holds in flight

// The 16-byte chunk u as floats (4 of float, 8 of bf16).
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u,
                                       float (&f)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

// (m, l, acc) <- the merge of two online-softmax states over disjoint
// keys; a state that saw no key has m = -inf and adds nothing.
__device__ __forceinline__ void merge_state(float& m, float& l, float& acc,
                                            float mo, float lo, float ao) {
  const float mn = fmaxf(m, mo);
  const float a = m == -INFINITY ? 0.f : expf(m - mn);
  const float b = mo == -INFINITY ? 0.f : expf(mo - mn);
  l = l * a + lo * b;
  acc = acc * a + ao * b;
  m = mn;
}

template <typename TQ, typename TKV, int DH, int GT>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                  const TKV* __restrict__ vp, const int* __restrict__ tables,
                  const int* __restrict__ lengths, TQ* __restrict__ out,
                  float* __restrict__ part, int H, int Kh, int bs, int nb,
                  int splits, float scale) {
  constexpr int V = 16 / sizeof(TKV);  // pool values a 16-byte chunk
  constexpr int NCH = DH / V;          // chunks a key row
  constexpr int LPK = NCH;             // P V: lanes a key (V dims each)
  constexpr int KPW = 32 / LPK;        // P V: keys a warp reads at once
  static_assert(LPK >= 1 && LPK <= 32, "a key fits one warp");
  __shared__ __align__(16) float qs[GT][DH];
  __shared__ float sm_ml[kWarps][GT][2];
  __shared__ float sm_acc[kWarps][GT][DH];

  const int b = blockIdx.x, sp = blockIdx.z;
  const int G = H / Kh, ngt = (G + GT - 1) / GT;
  const int kh = blockIdx.y / ngt, g0 = (blockIdx.y % ngt) * GT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kk = lane / LPK, c = (lane % LPK) * V;
  const int len = lengths[b];
  const int nlive = min((len + bs - 1) / bs, nb);
  // This block's run of the walk: pool blocks j0 .. j1 - 1.
  const int per = (nlive + splits - 1) / splits;
  const int j0 = min(sp * per, nlive), j1 = min(j0 + per, nlive);

  const size_t qrow = (size_t)b * H + (size_t)kh * G + g0;
  for (int i = threadIdx.x; i < GT * DH; i += kThreads) {
    qs[i / DH][i % DH] = i / DH + g0 < G ? to_f32(q[qrow * DH + i]) : 0.f;
  }
  // (m, l) of the walk so far, the same in every lane of the warp; acc
  // over the lane's V dims and the keys kk, kk + KPW, ... it reads.
  float m[GT], l[GT], acc[GT][V];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[g][v] = 0.f;
  }
  __syncthreads();

  const int* tab = tables + (size_t)b * nb;
  const size_t kstep = (size_t)Kh * DH;  // one key to the next in a block
  int j = j0 + warp;
  int blk = j < j1 ? tab[j] : 0;
  for (; j < j1; j += kWarps) {
    const int next = j + kWarps < j1 ? tab[j + kWarps] : 0;
    const size_t base = ((size_t)blk * bs * Kh + kh) * DH;
    const int nkeys = min(bs, len - j * bs);
    // A pass: up to 32 keys of the block, key t0 + lane in lane `lane`.
    for (int t0 = 0; t0 < nkeys; t0 += 32) {
      const int nt = min(32, nkeys - t0);
      const bool has = lane < nt;
      // Scores: the lane's key row in order over dh (each dot a chain of
      // f32 FMAs from zero, as the plain version's product takes it), in
      // rounds of up to 8 chunks in flight; q is read from shared memory.
      const TKV* krow = kp + base + (size_t)(t0 + (has ? lane : 0)) * kstep;
      float dot[GT] = {};
#pragma unroll
      for (int c0 = 0; c0 < NCH; c0 += 8) {
        uint4 kc[8];
#pragma unroll
        for (int u = 0; u < 8 && c0 + u < NCH; ++u) {
          kc[u] = has ? __ldg(reinterpret_cast<const uint4*>(
                            krow + (c0 + u) * V))
                      : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < 8 && c0 + u < NCH; ++u) {
          float kf[V];
          unpack<TKV>(kc[u], kf);
#pragma unroll
          for (int g = 0; g < GT; ++g)
#pragma unroll
            for (int v = 0; v < V; ++v) {
              dot[g] = fmaf(qs[g][(c0 + u) * V + v], kf[v], dot[g]);
            }
        }
      }
      // The online softmax over the pass's keys, warp-wide.
      float p[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float s = has ? dot[g] * scale : -INFINITY;
        float mx = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        }
        const float mn = fmaxf(m[g], mx);  // finite: the pass has a key
        const float alpha = expf(m[g] - mn);
        p[g] = has ? expf(s - mn) : 0.f;
        float sum = p[g];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        }
        l[g] = l[g] * alpha + sum;
        m[g] = mn;
#pragma unroll
        for (int v = 0; v < V; ++v) acc[g][v] *= alpha;
      }
      // P V: lanes (kk, c) read the V dims c.. of keys t0 + kk + KPW u
      // as 16-byte chunks, kNK keys in flight; key t0 + i's p is lane i's.
      for (int u0 = 0; u0 * KPW < nt; u0 += kNK) {
        uint4 vr[kNK];
#pragma unroll
        for (int u = 0; u < kNK; ++u) {
          const int i = (u0 + u) * KPW + kk;
          vr[u] = i < nt ? __ldg(reinterpret_cast<const uint4*>(
                               vp + base + (size_t)(t0 + i) * kstep + c))
                         : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kNK; ++u) {
          if ((u0 + u) * KPW >= nt) break;  // uniform: no lane has a key
          const int i = (u0 + u) * KPW + kk;
          float vf[V];
          unpack<TKV>(vr[u], vf);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            const float pk = __shfl_sync(0xffffffffu, p[g], i & 31);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[g][v] = fmaf(pk, vf[v], acc[g][v]);
          }
        }
      }
    }
    blk = next;
  }

  // The warp's key groups summed (they share m; lanes kk = 0 end with the
  // warp's sums for their V dims), then the warps merged in order 0..3.
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc[g][v] += __shfl_xor_sync(0xffffffffu, acc[g][v], o);
      }
  if (kk == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int v = 0; v < V; ++v) sm_acc[warp][g][c + v] = acc[g][v];
      if (c == 0) {
        sm_ml[warp][g][0] = m[g];
        sm_ml[warp][g][1] = l[g];
      }
    }
  }
  __syncthreads();
  const size_t nr = (size_t)gridDim.x * H;
  for (int i = threadIdx.x; i < GT * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    if (g0 + g >= G) break;
    float mm = sm_ml[0][g][0], ll = sm_ml[0][g][1], a = sm_acc[0][g][d];
    for (int w = 1; w < kWarps; ++w) {
      merge_state(mm, ll, a, sm_ml[w][g][0], sm_ml[w][g][1], sm_acc[w][g][d]);
    }
    const size_t row = qrow + g;
    if (splits == 1) {
      out[row * DH + d] = from_f32<TQ>(ll > 0.f ? a / ll : 0.f);
      continue;
    }
    const Partials<DH> pt(part, splits, nr);
    const size_t at = (size_t)sp * nr + row;
    pt.acc[at * DH + d] = a;
    if (d == 0) {
      pt.ml[2 * at] = mm;
      pt.ml[2 * at + 1] = ll;
    }
  }
}

// The runs of a split walk summed (split_walk.cuh): one warp per query
// row (slot, head); a slot of length 0 is exact zeros.
template <typename TQ, int DH>
__global__ void __launch_bounds__(kThreads)
    decode_kernel_combine(const float* __restrict__ part,
                          TQ* __restrict__ out, int B, int H, int splits) {
  const size_t nr = (size_t)B * H;
  const size_t row = (size_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= nr) return;
  combine_runs<TQ, DH>(part, nr, splits, row, true, out);
}

// Query heads a block: the group's, up to 32 / V a tile (the lane's acc
// values, GT x V).
template <typename TQ, typename TKV, int DH>
int launch_gt(const void* q, const void* kp, const void* vp,
              const void* tables, const void* lengths, void* out,
              void* part, int B, int H, int Kh, int bs, int nb, int splits,
              cudaStream_t stream) {
  constexpr int GTMAX = 32 / (16 / sizeof(TKV));
  const int G = H / Kh;
  const int gt = G <= 2 ? G : G <= 4 ? 4 : GTMAX;
  const float scale = (float)(1.0 / sqrt((double)DH));
  auto go = [&](auto kernel, int GT) {
    const dim3 grid(B, Kh * ((G + GT - 1) / GT), splits);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    kernel<<<grid, kThreads, 0, stream>>>(
        (const TQ*)q, (const TKV*)kp, (const TKV*)vp, (const int*)tables,
        (const int*)lengths, (TQ*)out, (float*)part, H, Kh, bs, nb, splits,
        scale);
    return (int)cudaGetLastError();
  };
  int rc;
  switch (gt) {
    case 1: rc = go(decode_kernel<TQ, TKV, DH, 1>, 1); break;
    case 2: rc = go(decode_kernel<TQ, TKV, DH, 2>, 2); break;
    case 4: rc = go(decode_kernel<TQ, TKV, DH, 4>, 4); break;
    default: rc = go(decode_kernel<TQ, TKV, DH, GTMAX>, GTMAX); break;
  }
  if (rc != 0 || splits == 1) return rc;
  const size_t rows = (size_t)B * H;
  decode_kernel_combine<TQ, DH><<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                                  stream>>>((const float*)part, (TQ*)out, B,
                                            H, splits);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_dh(int dh, const void* q, const void* kp, const void* vp,
              const void* tables, const void* lengths, void* out, void* part,
              int B, int H, int Kh, int bs, int nb, int splits,
              cudaStream_t s) {
  auto go = [&](auto fn) {
    return fn(q, kp, vp, tables, lengths, out, part, B, H, Kh, bs, nb,
              splits, s);
  };
  switch (dh) {
    case 16: return go(launch_gt<TQ, TKV, 16>);
    case 32: return go(launch_gt<TQ, TKV, 32>);
    case 64: return go(launch_gt<TQ, TKV, 64>);
    case 128: return go(launch_gt<TQ, TKV, 128>);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B,H,dh), pools (P,bs,Kh,dh), tables (B,nb) int32, lengths (B,)
// int32 -> out (B,H,dh) in q's type; the pools 16-byte aligned, dh in
// {16, 32, 64, 128}, H / Kh <= 64. With splits > 1, part is an f32
// scratch of splits * B * H * (dh + 2) values. One launch, two when
// split, on `stream`; no sync, no allocation.
extern "C" int paged_decode_attention(const void* q, const void* kp,
                                      const void* vp, const void* tables,
                                      const void* lengths, void* out,
                                      void* part, int B, int H, int Kh,
                                      int dh, int bs, int nb, int splits,
                                      int q_bf16, int kv_bf16, void* stream) {
  if (B < 1 || Kh < 1 || H % Kh != 0 || H / Kh > 64 || bs < 1 ||
      splits < 1 || splits > 65535 || (splits > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = torch_stream(stream);
  using bf = __nv_bfloat16;
  auto go = [&](auto fn) {
    return fn(dh, q, kp, vp, tables, lengths, out, part, B, H, Kh, bs, nb,
              splits, s);
  };
  if (q_bf16) {
    return kv_bf16 ? go(launch_dh<bf, bf>) : go(launch_dh<bf, float>);
  }
  return kv_bf16 ? go(launch_dh<float, bf>) : go(launch_dh<float, float>);
}
