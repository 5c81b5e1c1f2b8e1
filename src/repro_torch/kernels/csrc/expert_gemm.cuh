// The tensor-core GEMM of the expert-FFN kernels, for Hopper (sm_90a):
// over the padded (G, E, cap, .) capacity buffer (expert_mlp.cu,
// expert_mlp_bwd.cu: the forward's two passes, the dx kernel's products,
// the dW kernel's two) and over the expert-sorted ragged buffer
// (grouped_mlp.cu, grouped_mlp_bwd.cu: the forward's two passes and the
// dx kernel's products). Each runs it over (row tile, column tile)
// blocks of one expert; block_tile and ragged_tile map a block to its
// tile of the one buffer or the other.
//
// A block computes C = A B over a (BM rows) x (BN columns) tile of
// expert e, K deep. A's rows and the weights stream through a cp.async
// ring of slabs in shared memory (the forward's: 3 slabs 32 deep; dx's:
// 2 slabs 64 deep; strides padded so that the fragment reads are free of
// bank conflicts). A is read as stored, its BM rows a tile of one
// expert's segment, or transposed (kTransA, the dW kernels' x^T and h^T):
// the depth is then the expert's rows in every group, walked group after
// group inside the block through a depth map (DepthRows over the padded
// buffer, where a slab may cross a group boundary; SegmentRuns over the
// ragged one, in grouped_mlp_bwd.cu), staged as row-major (depth, BM)
// slabs and read by the fragments as as[k * LD + m]. B is read as
// stored, (K, N) row-major (x wi: wi (E, d, f); dW's da, dg, dy over the
// same depth rows as A), or transposed from the rows of an (N, K)
// matrix (dy wo^T: wo (E, f, d); da wi^T: wi (E, d, f)): each stored row
// holds one column of B contiguous in k, the column-major B that
// mma.sync takes. Warps tile the block WM x WN; a warp holds (BM / WM) x
// (BN / WN) f32 sums in registers. Each slab's products start from zero
// and are added to the sums with an ordinary f32 add (the tensor cores'
// accumulation truncates; mma_sm90.cuh).
#pragma once

#include "mma_sm90.cuh"

namespace {

constexpr int BN = 128;  // output columns a block
// The depth of one product summed from zero in the tensor cores (their
// truncating accumulation runs at most this deep), and the ring's
// defaults (the forward's): slabs of BK staged, STAGES in flight.
constexpr int BK = 32;
constexpr int STAGES = 3;

// Shared-memory row strides: rows stay 16-byte aligned for cp.async and
// the fragment reads stay free of bank conflicts. lda: a slab row SK
// deep; LDB: a row of BN columns.
template <typename T, int SK = BK>
__host__ __device__ constexpr int lda() {
  return SK + (sizeof(T) == 4 ? 4 : 8);
}
constexpr int LDB = BN + 8;
// A transposed: a slab row of BM columns, read down a column by the
// fragments (k = tg rows apart): the stride is 8 banks (mod 32) past a
// multiple of the 32 banks, in 32-bit words.
template <typename T, int BM>
__host__ __device__ constexpr int lda_t() {
  return BM + (sizeof(T) == 4 ? 8 : 16);
}

template <int BM, int WM, int WN>
struct Warps {
  static constexpr int NT = 32 * WM * WN;         // threads
  static constexpr int WTM = BM / WM, WTN = BN / WN;  // a warp's tile
  static constexpr int MI = WTM / 16, NI = WTN / 8;   // its mma tiles
};

// Shared bytes of the ring: NS slabs, SK deep, of A and NB B operands.
template <typename TA, typename TB, int BM, int NB, bool kTransB,
          int SK = BK, int NS = STAGES, bool kTransA = false>
__host__ __device__ constexpr size_t ring_bytes() {
  return NS * (sizeof(TA) * (kTransA ? SK * lda_t<TA, BM>()
                                     : BM * lda<TA, SK>()) +
               NB * sizeof(TB) * (kTransB ? BN * lda<TB, SK>() : SK * LDB));
}

// The depth rows of the A-transposed mode: depth index j (the expert's
// row j of its G * cap) lies in buffer row (j / cap) * E * cap + j % cap
// past the expert's first, for A and B alike. The division is a multiply
// by floor(2^32 / cap) (capped at 2^32 - 1) and one correction: for j <
// 2^32 that estimate is low by at most one. When cap is a multiple of
// the slab depth a slab lies in one group and is staged as one run of
// rows (stage_tile); otherwise each staged chunk finds its row
// (stage_rows). Finding every chunk's row, also inside one group, made
// the ViT-B/16 dW 8.10 ms against 7.13 (H100 80GB HBM3, 700 W, same bits;
// launch/ab_dw.py).
//
// A depth map of gemm_slabs: slab(k0, sk, nk, r0) says whether the
// sk-deep slab at depth k0 is one run of rows, and if so sets r0 to its
// first row and may lower nk (in: min(sk, K - k0)) to its valid rows;
// with kAnyRow, operator()(j) finds any depth row (for stage_rows).
struct DepthRows {
  static constexpr bool kAnyRow = true;
  unsigned cap, inv;
  size_t stride;  // E * cap
  __host__ __device__ DepthRows(int cap_, int E)
      : cap((unsigned)cap_),
        inv(cap_ == 1 ? 0xffffffffu : (unsigned)((1ull << 32) / cap_)),
        stride((size_t)E * cap_) {}
  __device__ __forceinline__ bool slab(int k0, int sk, int&,
                                       size_t& r0) const {
    if (cap % sk != 0) return false;  // a slab may cross into a group
    r0 = (*this)(k0);
    return true;
  }
  __device__ __forceinline__ size_t operator()(int j) const {
    unsigned g = __umulhi((unsigned)j, inv), r = (unsigned)j - g * cap;
    if (r >= cap) {
      ++g;
      r -= cap;
    }
    return g * stride + r;
  }
};

// The block's tile: blockIdx = (g * row tiles + row tile, column tile,
// expert e) over an (N)-column output.
struct Tile {
  size_t row0;  // first row of the tile in the G * E * cap rows
  int nrows, n0, ncols, e;
};

template <int BM>
__device__ __forceinline__ Tile block_tile(int cap, int N) {
  const int rtiles = (cap + BM - 1) / BM;
  const int g = blockIdx.x / rtiles, r0 = (blockIdx.x % rtiles) * BM;
  Tile t;
  t.e = blockIdx.z;
  t.row0 = ((size_t)g * gridDim.z + t.e) * cap + r0;
  t.nrows = min(BM, cap - r0);
  t.n0 = blockIdx.y * BN;
  t.ncols = min(BN, N - t.n0);
  return t;
}

// The ragged buffer's layout block (ROW_BLOCK in grouped_mlp.py): expert
// e's segment of group g holds max(1, ceil(n / 16)) blocks of 16 rows,
// n its valid rows; the first ceil(n / 16) are live, the rest (an empty
// expert's one block, the blocks past the last segment) are dead.
constexpr int kRowBlock = 16;

// A block's tile in the ragged buffer (G, M, .): t.row0 counts rows of
// all G * M; t.nrows == 0 when the slot holds no live tile. Slots past
// the live tiles are spare: spare >= 0 numbers them, nspare counts them.
struct RaggedTile {
  Tile t;
  int spare, nspare;
};

// The tile of blockIdx = (slot, column tile, group g) over an N-column
// output, from the group's expert sizes (int32, E of them, on the
// device; no table built beforehand). A live segment of L rows (L a
// multiple of 16) is covered by ceil(L / BM) row tiles of BM rows, the
// last one ragged; the tiles are numbered segment after segment, so
// tiles of one expert run side by side and share its weight slabs in L2.
// Warp 0 scans the sizes 32 experts at a time (tiles and rows a
// segment, inclusive sums by shuffles) and the lane whose segment holds
// the slot's tile records it. With `row_off` (shared, E + 1 ints), the
// segment starts and the segments' end are written there for
// zero_dead_blocks. The live tiles of a group number at most
// ceil(M / BM) + E, the grid's slots (tile_slots in grouped_mlp.py); a
// group whose sizes fit its M rows always leaves at least one spare slot.
// Sizes past M (no valid layout) are clipped to the buffer.
template <int BM>
__device__ __forceinline__ RaggedTile ragged_tile(const int* __restrict__ sizes,
                                                  int M, int E, int N,
                                                  int* row_off) {
  static_assert(BM % kRowBlock == 0, "a row tile holds whole blocks");
  __shared__ int found[4];  // first row in the group, rows, expert, live
  const int g = blockIdx.z, slot = blockIdx.x;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int* n_g = sizes + (size_t)g * E;
    if (lane == 0) found[0] = found[1] = found[2] = 0;
    __syncwarp();
    int tiles0 = 0, rows0 = 0;  // tiles and rows of the earlier chunks
    for (int c = 0; c < E; c += 32) {
      const int e = c + lane;
      const int n = e < E ? max(n_g[e], 0) : 0;
      const int live = (n + kRowBlock - 1) / kRowBlock * kRowBlock;
      const int tiles = (n + BM - 1) / BM;
      const int rows = e < E ? max(live, kRowBlock) : 0;
      int ti = tiles, ri = rows;  // inclusive sums over the chunk
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int tu = __shfl_up_sync(0xffffffffu, ti, o);
        const int ru = __shfl_up_sync(0xffffffffu, ri, o);
        if (lane >= o) {
          ti += tu;
          ri += ru;
        }
      }
      const int t0 = tiles0 + ti - tiles, r0 = rows0 + ri - rows;
      if (row_off && e < E) row_off[e] = min(r0, M);
      if (slot >= t0 && slot < t0 + tiles) {
        const int k = (slot - t0) * BM;
        found[0] = r0 + k;
        found[1] = max(0, min(min(BM, live - k), M - r0 - k));
        found[2] = e;
      }
      tiles0 += __shfl_sync(0xffffffffu, ti, 31);
      rows0 += __shfl_sync(0xffffffffu, ri, 31);
    }
    if (lane == 0) {
      found[3] = tiles0;
      if (row_off) row_off[E] = min(rows0, M);
    }
  }
  __syncthreads();
  RaggedTile rt;
  const int live = found[3];
  rt.t.nrows = found[1];
  rt.t.row0 = (size_t)g * M + found[0];
  rt.t.e = found[2];
  rt.t.n0 = blockIdx.y * BN;
  rt.t.ncols = min(BN, N - rt.t.n0);
  rt.spare = slot >= live ? slot - live : -1;
  rt.nspare = (int)gridDim.x - live;
  return rt;
}

// Zero the dead 16-row blocks of one group's (M, N) output `out` in
// columns [n0, n0 + ncols): an empty expert's block and the blocks past
// the last segment, item i of E + (tail blocks) taken by spare slot i %
// nspare. row_off: ragged_tile's table; n_g: the group's sizes.
template <typename T, int NT>
__device__ __forceinline__ void zero_dead_blocks(T* __restrict__ out,
                                                 const int* __restrict__ n_g,
                                                 const int* row_off, int M,
                                                 int E, int N, int n0,
                                                 int ncols, int spare,
                                                 int nspare) {
  const int end = row_off[E];
  const int items = E + (M - end + kRowBlock - 1) / kRowBlock;
  for (int i = spare; i < items; i += nspare) {
    if (i < E && n_g[i] > 0) continue;
    const int r0 = i < E ? row_off[i] : end + (i - E) * kRowBlock;
    const int nr = min(kRowBlock, M - r0);
    for (int j = threadIdx.x; j < kRowBlock * ncols; j += NT) {
      const int r = j / ncols, c = j - r * ncols;
      if (r < nr) out[(size_t)(r0 + r) * N + n0 + c] = from_f32<T>(0.f);
    }
  }
}

template <int MI, int NI>
__device__ __forceinline__ void add_to(float (&sum)[MI][NI][4],
                                       const float (&part)[MI][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[mi][ni][q] += part[mi][ni][q];
}

// acc[i] += A B_i over k < K for the block's tile, i < NB (NB B operands
// share each staged A slab). a: the tile's first row (row stride K);
// b0, b1: B_0, B_1 at the tile's first column (b1 read when NB == 2),
// row stride ldb; rows past nrows, columns past ncols and depth past K
// read as zeros. kTransA: a is A^T's storage at the tile's first column
// m0, row stride a_ld, and nrows counts its valid columns; the depth map
// `depth` places depth row j of a and of the B operands (b's
// non-transposed mode only), its slabs asked for in increasing depth,
// alike by every thread (so a map may keep a cursor). `aligned`
// (uniform): every staged row is 16-byte aligned and a whole number of
// chunks, so slabs move as cp.async chunks; otherwise element by
// element. The ring holds NS slabs of depth SK (ring_bytes),
// a multiple of BK; each BK of a slab is summed from zero and added to
// acc. Ends with a barrier, so the caller may restage the ring.
template <typename TA, typename TB, int BM, int WM, int WN, int NB,
          bool kTransB, int SK = BK, int NS = STAGES, bool kTransA = false,
          typename Depth = DepthRows>
__device__ __forceinline__ void gemm_slabs(
    float (&acc)[NB][Warps<BM, WM, WN>::MI][Warps<BM, WM, WN>::NI][4],
    const TA* __restrict__ a, const TB* __restrict__ b0,
    const TB* __restrict__ b1, size_t ldb, int K, int nrows, int ncols,
    bool aligned, unsigned char* smem, size_t a_ld = 0,
    Depth depth = DepthRows(1, 1)) {
  using W = Warps<BM, WM, WN>;
  static_assert(SK % BK == 0, "a slab holds whole BK-deep parts");
  static_assert(!(kTransA && kTransB), "one operand transposed");
  constexpr int NT = W::NT, MI = W::MI, NI = W::NI;
  constexpr int LDA = kTransA ? lda_t<TA, BM>() : lda<TA, SK>();
  constexpr int LDT = lda<TB, SK>();
  constexpr size_t SA = sizeof(TA) * (kTransA ? SK * LDA : BM * LDA);
  constexpr size_t SB = sizeof(TB) * (kTransB ? BN * LDT : SK * LDB);
  constexpr size_t SS = SA + NB * SB;
  auto tile_a = [=](int kt) {
    return reinterpret_cast<TA*>(smem + (kt % NS) * SS);
  };
  auto tile_b = [=](int kt, int i) {
    return reinterpret_cast<TB*>(smem + (kt % NS) * SS + SA + i * SB);
  };

  auto load = [&](int kt) {
    const int k0 = kt * SK;
    int nk = min(SK, K - k0);
    if constexpr (kTransA) {
      size_t r0;
      if (depth.slab(k0, SK, nk, r0)) {  // the slab is one run of rows
        stage_tile<TA, SK, BM, NT>(tile_a(kt), LDA, a + r0 * a_ld, a_ld, nk,
                                   nrows, aligned);
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          stage_tile<TB, SK, BN, NT>(tile_b(kt, i), LDB,
                                     (i == 0 ? b0 : b1) + r0 * ldb, ldb, nk,
                                     ncols, aligned);
        }
        return;
      }
      if constexpr (Depth::kAnyRow) {
        stage_rows<TA, SK, BM, NT>(
            tile_a(kt), LDA,
            [&](int r) { return a + depth(k0 + r) * a_ld; }, a, nk, nrows,
            aligned);
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const TB* b = i == 0 ? b0 : b1;
          stage_rows<TB, SK, BN, NT>(
              tile_b(kt, i), LDB,
              [&](int r) { return b + depth(k0 + r) * ldb; }, b, nk, ncols,
              aligned);
        }
      }
      return;
    }
    stage_tile<TA, BM, SK, NT>(tile_a(kt), LDA, a + k0, K, nrows, nk,
                               aligned);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const TB* b = i == 0 ? b0 : b1;
      if constexpr (kTransB) {
        stage_tile<TB, BN, SK, NT>(tile_b(kt, i), LDT, b + k0, ldb, ncols,
                                   nk, aligned);
      } else {
        stage_tile<TB, SK, BN, NT>(tile_b(kt, i), LDB, b + k0 * ldb, ldb,
                                   nk, ncols, aligned);
      }
    }
  };

  const int warp = threadIdx.x >> 5, wm = warp / WN, wn = warp % WN;
  const int nk = (K + SK - 1) / SK;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // slab kt is in; every warp is done with kt - 1
    if (kt + NS - 1 < nk) load(kt + NS - 1);
    cp_async_commit();
#pragma unroll
    for (int k0 = 0; k0 < SK; k0 += BK) {
      const TA* as = kTransA ? tile_a(kt) + k0 * LDA + wm * W::WTM
                             : tile_a(kt) + wm * W::WTM * LDA + k0;
      auto ra = [&](int r, int k) {
        return to_f32(kTransA ? as[k * LDA + r] : as[r * LDA + k]);
      };
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        float part[MI][NI][4] = {};
        if constexpr (kTransB) {
          const TB* bs = tile_b(kt, i) + wn * W::WTN * LDT + k0;
          warp_mma<TA, TB, MI, NI, BK>(part, ra, [&](int k, int n) {
            return to_f32(bs[n * LDT + k]);
          });
        } else {
          const TB* bs = tile_b(kt, i) + k0 * LDB + wn * W::WTN;
          warp_mma<TA, TB, MI, NI, BK>(part, ra, [&](int k, int n) {
            return to_f32(bs[k * LDB + n]);
          });
        }
        add_to(acc[i], part);
      }
    }
  }
  __syncthreads();  // every warp is done with the ring
}

// f(mi, ni, q, r, col) for each sum the thread holds: acc[.][mi][ni][q]
// is the tile's entry (r, col).
template <int BM, int WM, int WN, typename F>
__device__ __forceinline__ void each_entry(F f) {
  using W = Warps<BM, WM, WN>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN, gr = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        f(mi, ni, q, wm * W::WTM + 16 * mi + gr + (q >= 2 ? 8 : 0),
          wn * W::WTN + 8 * ni + 2 * tg + (q & 1));
      }
}

}  // namespace
