// Warp-level tensor-core products for the port's kernels (sm_90a), in
// inline PTX, and the cp.async staging that feeds them.
//
// float32 operands run as 3xTF32 on mma.sync.m16n8k8: each operand x is
// split into big = tf32(x) and small = tf32(x - big) (cvt.rna's rounding:
// to nearest, ties away from zero) and the product is accumulated in f32
// as small*big + big*small + big*big, the small terms first. The dropped
// small*small term and the rounding of small are ~2^-21 of |x y|, so the
// sums keep float32 accuracy (a single TF32 product keeps ~2^-11);
// tests/test_torch_tf32x3.py emulates both on the CPU. bfloat16 operands
// run as one mma.sync.m16n8k16 bf16 product, accumulated in f32.
//
// Fragment layouts (PTX ISA, warp-level mma): lane = 4 * gr + tg. An
// f32 accumulator tile of 16 x 8 is c[4]: c[0..1] at row gr, columns
// 2tg, 2tg+1; c[2..3] at row gr + 8.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

// cvt.rna.tf32.f32 for finite x, in two integer ops: add half of the 13
// dropped bits to the magnitude and clear them (nearest, ties away from
// zero; the sign bit is untouched). The cvt instruction itself issues at
// a fraction of the integer rate and, two a split, bounded both kernels.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small up to ~2^-22 |x|; both are TF32 bit patterns.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in f32 accuracy from split operands, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two values as one bf16x2 register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc[mi][ni] += A[16 mi .., k] B[k, 8 ni ..] over k < K for one warp:
// an (16 MI) x (8 NI) tile. `a(r, k)` and `b(k, n)` return float
// (shared-memory readers; a bf16 value converts exactly). TA and TB are
// the operands' types. Both bf16: one m16n8k16 product a k-step of 16.
// Otherwise m16n8k8 TF32 a k-step of 8, each float operand split: three
// products for float x float, two for float x bf16 (a bf16 value is
// exact in TF32, its small part zero). K is a multiple of the step.
//
// The tensor cores' f32 accumulation truncates toward zero, so a long
// running sum passed in as `acc` drifts by ~2^-24 of its size a product
// (3e-4 relative over 14,336 f32 terms): callers start `acc` at zero for
// a short depth (one staged slab) and add it to their long sum with an
// ordinary f32 add.
template <typename TA, typename TB, int MI, int NI, int K, typename FA,
          typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NI][4], FA a,
                                         FB b) {
  constexpr bool kSplitA = std::is_same<TA, float>::value;
  constexpr bool kSplitB = std::is_same<TB, float>::value;
  const int lane = threadIdx.x & 31, gr = lane >> 2, tg = lane & 3;
  if constexpr (kSplitA || kSplitB) {
    auto to_tf32 = [](float x, uint32_t& big, uint32_t& small, bool split) {
      if (split) {
        split_tf32(x, big, small);
      } else {
        big = __float_as_uint(x);  // bf16 -> f32 is exact in TF32
      }
    };
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 8) {
      uint32_t ab[MI][4], as[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = 16 * mi + gr;
        to_tf32(a(r, k0 + tg), ab[mi][0], as[mi][0], kSplitA);
        to_tf32(a(r + 8, k0 + tg), ab[mi][1], as[mi][1], kSplitA);
        to_tf32(a(r, k0 + tg + 4), ab[mi][2], as[mi][2], kSplitA);
        to_tf32(a(r + 8, k0 + tg + 4), ab[mi][3], as[mi][3], kSplitA);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        uint32_t bb[2], bs[2];
        to_tf32(b(k0 + tg, 8 * ni + gr), bb[0], bs[0], kSplitB);
        to_tf32(b(k0 + tg + 4, 8 * ni + gr), bb[1], bs[1], kSplitB);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          if (kSplitA) mma_tf32(acc[mi][ni], as[mi], bb);
          if (kSplitB) mma_tf32(acc[mi][ni], ab[mi], bs);
          mma_tf32(acc[mi][ni], ab[mi], bb);
        }
      }
    }
  } else {
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int k = k0 + 2 * tg;
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = 16 * mi + gr;
        af[mi][0] = pack_bf16(a(r, k), a(r, k + 1));
        af[mi][1] = pack_bf16(a(r + 8, k), a(r + 8, k + 1));
        af[mi][2] = pack_bf16(a(r, k + 8), a(r, k + 9));
        af[mi][3] = pack_bf16(a(r + 8, k + 8), a(r + 8, k + 9));
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = 8 * ni + gr;
        const uint32_t bf[2] = {pack_bf16(b(k, n), b(k + 1, n)),
                                pack_bf16(b(k + 8, n), b(k + 9, n))};
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_bf16(acc[mi][ni], af[mi], bf);
      }
    }
  }
}

// acc[ni] += P[16 rows, k] B[k, 8 ni ..] over k < K for one warp (start
// acc at zero, as for warp_mma), where
// P is held in registers in the accumulator layout of an earlier
// product: p[j] is the 16 x 8 tile of columns 8j .. 8j+7 (a probability
// tile kept in registers). float: P is split for 3xTF32, and the k-slots
// of each step are permuted (slot tg <-> column 8j + 2tg, slot tg + 4 <->
// 8j + 2tg + 1) so that P needs no shuffle; B is read with the same
// permutation. bf16: two tiles make one k16 step, P rounded to bf16.
// TB is B's stored type: a bf16 B under a float P is exact in TF32, so
// it is not split and takes two products.
template <typename T, int NI, int K, typename TB = T, typename FB>
__device__ __forceinline__ void warp_mma_cfrag(float (&acc)[NI][4],
                                               const float (&p)[K / 8][4],
                                               FB b) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tg = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
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
        if constexpr (std::is_same<TB, float>::value) {
          uint32_t bb[2], bs[2];
          split_tf32(b(k, 8 * ni + gr), bb[0], bs[0]);
          split_tf32(b(k + 1, 8 * ni + gr), bb[1], bs[1]);
          mma_3xtf32(acc[ni], ab, as, bb, bs);
        } else {
          const uint32_t bb[2] = {__float_as_uint(b(k, 8 * ni + gr)),
                                  __float_as_uint(b(k + 1, 8 * ni + gr))};
          mma_tf32(acc[ni], as, bb);
          mma_tf32(acc[ni], ab, bb);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < K / 8; j += 2) {
      const uint32_t af[4] = {pack_bf16(p[j][0], p[j][1]),
                              pack_bf16(p[j][2], p[j][3]),
                              pack_bf16(p[j + 1][0], p[j + 1][1]),
                              pack_bf16(p[j + 1][2], p[j + 1][3])};
      const int k = 8 * j + 2 * tg;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = 8 * ni + gr;
        const uint32_t bf[2] = {pack_bf16(b(k, n), b(k + 1, n)),
                                pack_bf16(b(k + 8, n), b(k + 9, n))};
        mma_bf16(acc[ni], af, bf);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// staging: global -> shared
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage a ROWS x COLS tile of T into shared memory (row stride lds):
// dst[r][c] = src[r * ld + c] for r < nr and c < nc, else 0. `aligned`
// (uniform over the block): every row start of src is 16-byte aligned
// and nc is a multiple of a 16-byte chunk, so the tile moves as cp.async
// chunks (zero-filled past the edge; wait with cp_async_wait); otherwise
// element by element through registers. `src` itself must be a valid
// address. Called by all NT threads of the block.
template <typename T, int ROWS, int COLS, int NT>
__device__ __forceinline__ void stage_tile(T* dst, int lds,
                                           const T* __restrict__ src,
                                           size_t ld, int nr, int nc,
                                           bool aligned) {
  constexpr int V = 16 / sizeof(T);  // elements a chunk
  if (aligned) {
#pragma unroll
    for (int i = threadIdx.x; i < ROWS * COLS / V; i += NT) {
      const int r = i / (COLS / V), c = (i % (COLS / V)) * V;
      const bool ok = r < nr && c < nc;
      cp_async16(dst + r * lds + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      dst[r * lds + c] = r < nr && c < nc ? src[r * ld + c] : from_f32<T>(0.f);
    }
  }
}

// stage_tile with rows found one by one: dst[r][c] = row(r)[c], row(r)
// the address of the tile's row r, read only for r < nr; `any` is a
// valid address for the zero-filled chunks. A loop of its own: stage_tile
// written as this loop over a lambda timed 5% slower in the flash dq
// kernel's step, which stages K/V with it.
template <typename T, int ROWS, int COLS, int NT, typename Row>
__device__ __forceinline__ void stage_rows(T* dst, int lds, Row row,
                                           const T* __restrict__ any, int nr,
                                           int nc, bool aligned) {
  constexpr int V = 16 / sizeof(T);  // elements a chunk
  if (aligned) {
#pragma unroll
    for (int i = threadIdx.x; i < ROWS * COLS / V; i += NT) {
      const int r = i / (COLS / V), c = (i % (COLS / V)) * V;
      const bool ok = r < nr && c < nc;
      cp_async16(dst + r * lds + c, ok ? row(r) + c : any, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      dst[r * lds + c] = r < nr && c < nc ? row(r)[c] : from_f32<T>(0.f);
    }
  }
}

}  // namespace
