// 3xTF32 tile products for the f32 tensor-core kernels (fused_sdf_tf32.cu:
// K1, field_fwd_tf32.cu: K3-fwd). The tensor cores take f32 operands only as
// TF32 (10 mantissa bits); each f32 operand v is split as hi = tf32(v) and
// lo = tf32(v - hi) (cvt.rna: nearest, ties away), and a product is three
// wgmma products: A_lo B_hi + A_hi B_lo + A_hi B_hi. The term A_lo B_lo
// (2^-22 of the product) is dropped.
//
// The accumulation. Each wgmma adds its k8 sum into the tensor core's
// accumulator rounding toward zero, so over a 256-wide layer (96 wgmmas)
// the errors pile up on one side: about ten times plain f32's error
// against f64 (ops/tf32.py models it; tests/test_torch_tf32_*_design.py print it
// as "one_accumulator"). So the tensor core sums one pair (two k8 steps,
// six wgmmas: the four small terms first, while the accumulator is small,
// then the two large ones) into a fresh accumulator, and the pairs' sums
// go into an f32 running sum rounded to nearest. Each pair's sum still
// comes out truncated, so the product is short by about 0.65 ulp on
// average (on the card, against f64: the sdf's mean error -1.5e-7 of its
// largest value without a correction, +8.5e-8 with a whole ulp given back
// to every entry; plain f32 -6.3e-8). So at the end of each product five
// entries in eight, chosen by the low three bits of the running sum, move
// one ulp away from zero: 0.625 ulp on average. That takes the mean error
// to -2.5e-9 and the root mean square from 1.03e-7 (a whole ulp) to
// 4.9e-8, below plain f32's 9.2e-8 (tools/tf32_variants.py prints them:
// "no_nudge", "whole_ulp", "frac12", "frac34"). A warp's running sum of
// its 16 x 256 outputs is 128 registers; the fresh accumulator covers a
// quarter of the columns (wgmma m64n64k8, 32 registers), so a pair is four
// products of 64 columns.
//
// The shape of a product is the bf16 kernels' (mma_tile.cuh): a warp owns
// a strip of 16 rows of the tile, a warpgroup multiplies its four strips
// (64 rows) by a weight panel in shared memory, the 16 x 256 result of each
// warp in 128 f32 registers. Unlike the bf16 kernels the two warpgroups of a
// block do not take turns at the tensor cores (named barriers): a turn for
// each quarter of a pair measured slower (tools/tf32_variants.py). They
// meet only at the ring, which holds two pairs: a warpgroup can run at most
// a pair ahead of the other.
//
// Operands.
//   A (the activations) stay f32 in shared memory, row-major, row stride
//   LDA (or the embedding's LDE): 264 % 32 == 8, so the 8-byte loads of a
//   half warp (rows g = 0..3, columns 2t, 2t+1) hit 32 different banks. For
//   each k8 step a warp loads its fragment and splits it into 4 hi and 4 lo
//   registers. The tf32 A fragment of k8 holds (row g, k t), (row g+8, k t),
//   (row g, k t+4), (row g+8, k t+4); the panels permute k inside each group
//   of 8 (ops/tf32.py: K_PERM) so that slot t is column 2t and slot t+4
//   column 2t+1: two float2 loads a step. The epilogues store the running
//   sum's (row g, columns 2t, 2t+1) as float2 into the same layout.
//   B (the weights) are pairs of K-major panels (the only layout wgmma takes
//   for tf32): a hi panel, then its lo panel, 256 rows x 16 k each, a row's
//   64 bytes with the 64-byte swizzle (16-byte piece c at c ^ ((n >> 1) &
//   3)), 16 KB; a pair is 32 KB, one slot of mma_tile's PanelRing, filled by
//   one bulk copy. A k8 step is the panel's descriptor plus 32 bytes, a
//   quarter of the columns plus 64 rows (4 KB).
#pragma once

#include "common.cuh"
#include "mma_tile.cuh"

namespace tf32_tile {

constexpr int PANEL_K = 16;                    // k values of a panel: a 64-byte row
constexpr int PANEL_ROWS = 256;                // its rows: the product's output columns
constexpr int PANEL_ELEMS = PANEL_ROWS * PANEL_K;  // 16 KB of f32
constexpr int PAIR_ELEMS = 2 * PANEL_ELEMS;    // the hi panel, then the lo panel
constexpr int LDA = 264;                       // f32 row stride of the activations
static_assert(PAIR_ELEMS * 4 == mma_tile::PANEL_ELEMS * 2, "a pair fills one slot of the panel ring");
static_assert(LDA % 32 == 8, "float2 loads of a half warp on 32 banks");

// a pair of the ring by its bf16 element offset: PanelRing counts in the
// bf16 elements of its 32 KB slots
__host__ __device__ constexpr long ring_offset(long f32_offset) { return 2 * f32_offset; }

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// the split A fragment of one k8 step at column 0 of A (row stride LD)
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* A) {
  static_assert(LD % 32 == 8, "float2 loads of a half warp on 32 banks");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2 r0 = *reinterpret_cast<const float2*>(A + g * LD + 2 * t);
  const float2 r1 = *reinterpret_cast<const float2*>(A + (g + 8) * LD + 2 * t);
  const float v[4] = {r0.x, r1.x, r0.y, r1.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(v[i]);
    lo[i] = tf32_rna(v[i] - __uint_as_float(hi[i]));
  }
}

// descriptor of a K-major panel with the 64-byte swizzle at shared byte addr
__device__ __forceinline__ uint64_t panel_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)  // leading offset: unused
         | ((uint64_t)(512 >> 4) << 32)                            // 8-row groups 512 bytes apart
         | ((uint64_t)2 << 62);                                    // 64-byte swizzle
}

#define TF32_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define TF32_D16(j) TF32_D4(j), TF32_D4(j + 1), TF32_D4(j + 2), TF32_D4(j + 3)
// d = (accumulate ? d : 0) + a (64 x 8 tf32, registers) * B(desc) (8 x 64:
// the panel's 64 rows at desc); asynchronous
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : TF32_D16(0), TF32_D16(4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
#undef TF32_D16
#undef TF32_D4

// v moved one ulp away from zero (zero stays zero)
__device__ __forceinline__ float ulp_away(float v) { return __int_as_float(__float_as_int(v) + (v != 0.f)); }

// the truncations' average loss given back: v one ulp away from zero where
// its low three bits are below 5 (five values in eight), else v
__device__ __forceinline__ float give_back(float v) {
  return (__float_as_int(v) & 7) < 5 ? ulp_away(v) : v;
}

// keeps the compiler from reusing A's registers before the wgmmas reading them are done
template <int KS> __device__ __forceinline__ void fence_a(uint32_t (&hi)[KS][4], uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(hi[k][i]), "+r"(lo[k][i])::"memory");
}

// sum = (accumulate ? sum : 0) + A[16 x 8 * ksteps] W^T over the next NP
// pairs of the ring, two k8 steps of each but LAST of the last. A: the
// warp's strip at the product's first column (row stride LD). Each quarter
// of a pair's columns is summed by the tensor core from zero and added into
// sum (f32, rounded to nearest). All four warps of the warpgroup call it
// together; it returns with the product finished.
template <int NP, int LAST, int LD, class Ring>
__device__ __forceinline__ void products(float (&sum)[32][4], const float* A, Ring& ring, bool feeder,
                                         bool accumulate) {
  static_assert(LAST == 1 || LAST == 2, "one or two k8 steps of a pair");
  constexpr uint64_t QUARTER = (64 * PANEL_K * 4) >> 4;  // 64 panel rows, in descriptor units
  // a quarter's accumulator, one register block for every quarter; the sum
  // starts from zero and takes one add a quarter (a select between a sum
  // and a first value cost 40 registers and spills: tools/tf32_variants.py)
  float part[8][4];
  if (!accumulate) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[j][i] = 0.f;
  }
#pragma unroll 1
  for (int q = 0; q < NP; ++q) {
    uint32_t hi[2][4], lo[2][4];
    const bool two = q < NP - 1 || LAST == 2;
    load_a<LD>(hi[0], lo[0], A + q * PANEL_K);
    if (two) load_a<LD>(hi[1], lo[1], A + q * PANEL_K + 8);
    const uint32_t slot = mma_tile::smem_u32(ring.wait(q));
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint64_t dh = panel_desc(slot) + c * QUARTER, dl = panel_desc(slot + PANEL_ELEMS * 4) + c * QUARTER;
      mma_tile::wgmma_fence();
      // the small terms of both k8 steps first (+ 2: 32 bytes, the panel's
      // second k8 step), while the accumulator is small, then the large ones
      wgmma_m64n64k8(part, lo[0], dh, 0);
      wgmma_m64n64k8(part, hi[0], dl, 1);
      if (two) {
        wgmma_m64n64k8(part, lo[1], dh + 2, 1);
        wgmma_m64n64k8(part, hi[1], dl + 2, 1);
      }
      wgmma_m64n64k8(part, hi[0], dh, 1);
      if (two) wgmma_m64n64k8(part, hi[1], dh + 2, 1);
      mma_tile::wgmma_commit();
      mma_tile::wgmma_wait<0>();
      mma_tile::fence_acc(part);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[8 * c + j][i] += part[j][i];
    }
    fence_a<2>(hi, lo);
    ring.release(q);
    if (feeder) ring.refill(q);
  }
  // the truncations toward zero leave the product about 0.65 ulp short on
  // average: an ulp away from zero for five entries in eight
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) sum[j][i] = give_back(sum[j][i]);
  ring.seq += NP;
}

}  // namespace tf32_tile
