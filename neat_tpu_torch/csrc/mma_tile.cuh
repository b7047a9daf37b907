// Tensor-core tile products for the fused MLP kernels: bf16 x bf16 summed in
// f32, weights staged into shared memory by bulk copies. Two products on the
// same operands: warpgroup_mma (wgmma.mma_async m64n256k16: four warps, 64
// rows, B read from shared memory once per warpgroup; the fast one) and
// warp_mma (mma.sync m16n8k16 with ldmatrix: one warp, 16 rows, usable where
// a tile has fewer than 64 rows). Beside them: the ring of weight panels
// that bulk copies fill (PanelRing, with its mbarriers), and the named
// barriers by which two warpgroups take turns at the tensor cores.
//
// The shape of a product. A block's tile of points is cut into strips of
// WARP_ROWS = 16 rows, one strip per warp. A warp multiplies its strip of the
// activations A (16 x K, bf16, row-major in shared memory) by a staged weight
// chunk and keeps the whole 16 x N result in registers as f32 fragments. A
// row of the output depends only on the same row of the input, so a warp
// reads and writes only its own strip: a layer's output can overwrite its
// input after a __syncwarp(), and the block needs no barrier between layers.
//
// Shared-memory layouts (all bf16):
//   activations  [row][k], row stride lda = K + PAD elements. A stride that
//                is an odd multiple of 16 bytes puts the eight 16-byte rows
//                of one ldmatrix 8 x 8 block into eight different bank
//                groups: no conflicts.
//   weights      panels of PANEL_K = 64 k columns, "K-major with the
//                128-byte swizzle" (what wgmma reads): in a panel, row n (an
//                output column of the layer) holds its 64 values (128 bytes)
//                at byte n * 128, with its eight 16-byte pieces permuted:
//                piece c sits at position c ^ (n % 8). A panel starts on 1024
//                bytes. ldmatrix reads the same layout without conflicts.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16; g = lane / 4, t = lane % 4):
//   A, 4 registers of 2 bf16: (row g, k 2t..2t+1), (row g+8, k 2t..2t+1),
//                             (row g, k 2t+8..2t+9), (row g+8, k 2t+8..2t+9)
//   B, 2 registers:           (k 2t..2t+1, n g), (k 2t+8..2t+9, n g)
//   C/D, 4 floats:            (row g, n 2t), (row g, n 2t+1),
//                             (row g+8, n 2t), (row g+8, n 2t+1)
// wgmma's m64nNk16 fragments are these, stacked: warp w of the warpgroup holds
// rows 16w .. 16w + 15 of A and of D, D's n8 tile j in registers 4j .. 4j+3.
// One ldmatrix.x4 fills an A fragment (lane l addresses row l % 16, column
// 8 * (l / 16)), or the B fragments of two neighbouring n8 tiles (lane l
// addresses weight row n0 + l % 8 + 8 * (l / 16), piece 2 * kstep + (l / 8) % 2).
// Two neighbouring C tiles, rounded to bf16 and packed in pairs, are the A
// fragment of the next layer's k16 step: the epilogue stores (n 2t, n 2t+1)
// as one 32-bit word, which ldmatrix reads back in exactly that order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_tile {

constexpr int WARP_ROWS = 16;  // rows of the tile that one warp owns
constexpr int PAD = 8;         // bf16 elements added to each row of the activations
constexpr int PANEL_K = 64;    // k columns of one swizzled weight panel
constexpr int PANEL_ROWS = 256;                     // its rows: the layer's output columns
constexpr int PANEL_ELEMS = PANEL_ROWS * PANEL_K;  // 32 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// ---------------------------------------------------------------------------
// acc[j] += A[16 x 16*KSTEPS] * W[n = 8j .. 8j+7][k]^T for j < 2*NPAIRS.
// A: the warp's strip at the product's first k column (row stride LDA);
// W: the panels of this product, one after the other.
// ---------------------------------------------------------------------------
template <int KSTEPS, int NPAIRS, int LDA, int NACC>
__device__ __forceinline__ void warp_mma(float (&acc)[NACC][4], const __nv_bfloat16* A,
                                         const __nv_bfloat16* W) {
  static_assert(2 * NPAIRS <= NACC && 16 * NPAIRS <= PANEL_ROWS, "accumulator or panel too small");
  static_assert((LDA * 2) % 32 == 16, "row stride of A: an odd multiple of 16 bytes");
  const int lane = threadIdx.x & 31;
  const uint32_t a_addr = smem_u32(A + (lane & 15) * LDA + ((lane >> 4) << 3));
  const uint32_t w_row = smem_u32(W) + ((lane & 7) + ((lane >> 4) << 3)) * (PANEL_K * 2);
#pragma unroll 2
  for (int ks = 0; ks < KSTEPS; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, a_addr + ks * 32);
    const int piece = 2 * (ks % 4) + ((lane >> 3) & 1);
    const uint32_t w_addr = w_row + (ks / 4) * (PANEL_ELEMS * 2) + ((piece ^ (lane & 7)) << 4);
#pragma unroll
    for (int p = 0; p < NPAIRS; ++p) {
      uint32_t b[4];
      ldmatrix_x4(b, w_addr + p * 16 * PANEL_K * 2);
      mma_16816(acc[2 * p], a, b[0], b[1]);
      mma_16816(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

template <int NACC> __device__ __forceinline__ void zero_acc(float (&acc)[NACC][4]) {
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// ---------------------------------------------------------------------------
// Warpgroup products (wgmma, sm_90a): D (64 x 256, f32 in registers) +=
// A (64 x 16, from registers: each warp's own A fragment) * B (16 x 256, a
// swizzled panel in shared memory, named by a descriptor: the panel's first
// byte plus 32 bytes per k16 step inside it; 8-row groups 1024 bytes apart).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// returns when at most N committed groups of this thread's wgmmas are unfinished
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across a wgmma
template <int NACC> __device__ __forceinline__ void fence_acc(float (&d)[NACC][4]) {
#pragma unroll
  for (int j = 0; j < NACC; ++j)
    asm volatile("" : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])::"memory");
}

// descriptor of a swizzled panel at shared-memory byte address addr
__device__ __forceinline__ uint64_t panel_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)  // leading offset: unused
         | ((uint64_t)(1024 >> 4) << 32)                           // 8-row groups 1024 bytes apart
         | ((uint64_t)1 << 62);                                    // 128-byte swizzle
}

#define MMA_TILE_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define MMA_TILE_D16(j) MMA_TILE_D4(j), MMA_TILE_D4(j + 1), MMA_TILE_D4(j + 2), MMA_TILE_D4(j + 3)
// d = (accumulate ? d : 0) + a * B(desc); asynchronous: commit and wait before reading d
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[32][4], const uint32_t (&a)[4],
                                                 uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : MMA_TILE_D16(0), MMA_TILE_D16(4), MMA_TILE_D16(8), MMA_TILE_D16(12), MMA_TILE_D16(16),
        MMA_TILE_D16(20), MMA_TILE_D16(24), MMA_TILE_D16(28)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
// the same with A from shared memory too: d = (accumulate ? d : 0) + A(desc_a)
// * B(desc_b), both K-major swizzled panels (A: 64 rows of the product)
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[32][4], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : MMA_TILE_D16(0), MMA_TILE_D16(4), MMA_TILE_D16(8), MMA_TILE_D16(12), MMA_TILE_D16(16),
        MMA_TILE_D16(20), MMA_TILE_D16(24), MMA_TILE_D16(28)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
// d = (accumulate ? d : 0) + A(desc_a) * B(desc_b): 64 rows x 64 columns, both
// operands K-major swizzled panels in shared memory (B: 64 rows of a panel)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : MMA_TILE_D16(0), MMA_TILE_D16(4)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
#undef MMA_TILE_D16
#undef MMA_TILE_D4

// acc (the warp's 16 x 256 share of the warpgroup's 64 x 256) = (accumulate ?
// acc : 0) + A[16 x 16*KS*NP] * W^T. A: the warp's strip at the product's
// first k column (row-major, stride LDA); W: NP panels, KS k16 steps read of
// each (PANEL_K columns of A go with a panel). All four warps of the
// warpgroup call it together; it returns with the product finished. wgmma
// reads the A fragments while it runs, so each k16 step has registers of its
// own (NP * KS * 4 of them).
template <int NP, int KS, int LDA>
__device__ __forceinline__ void warpgroup_mma(float (&acc)[32][4], const __nv_bfloat16* A,
                                              const __nv_bfloat16* (&W)[NP], bool accumulate) {
  const int lane = threadIdx.x & 31;
  const uint32_t a_addr = smem_u32(A + (lane & 15) * LDA + ((lane >> 4) << 3));
  uint32_t a[NP * KS][4];
#pragma unroll
  for (int i = 0; i < NP * KS; ++i)
    ldmatrix_x4(a[i], a_addr + ((i / KS) * (PANEL_K / 16) + i % KS) * 32);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < NP * KS; ++i)
    wgmma_m64n256k16(acc, a[i], panel_desc(smem_u32(W[i / KS])) + 2 * (i % KS), accumulate || i > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

// ---------------------------------------------------------------------------
// A ring of panels filled by bulk copies (cp.async.bulk: one thread asks, the
// copy engine moves the bytes and reports them to an mbarrier in shared
// memory), and named barriers by which two warpgroups take turns.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
// after the inits, before the block's barrier that publishes them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// returns when the barrier's phase of this parity has completed; a wait of
// some twenty seconds (4e10 cycles) is a fault of the pipeline: trap, do not hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 40000000000LL) __trap();
  } while (!done);
}
// bytes: a multiple of 16; dst and src 16-byte aligned; reported to bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  const uint32_t d = smem_u32(dst), b = smem_u32(bar);
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               :
               : "r"(d), "l"(src), "r"(bytes), "r"(b)
               : "memory");
}
// barrier `id` (1..15) completes when `threads` threads have synced on or arrived at it
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The ring of SLOTS weight panels that K1, the bf16 field forward and the
// split backward's row-local pass take their products' B operands from.
// Panel s of the block's sequence (the tile's Panels::COUNT panels, again and
// again; the tile's panel p at element Panels::at(p) of W) sits in slot
// s % SLOTS once the slot's `full` barrier has completed for the
// (s / SLOTS)-th time: a bulk copy reports its bytes there. Each warp that
// reads the panel reports to `empty`; the last of the `readers` reports
// (init) frees the slot for panel s + SLOTS. A turn at the tensor cores
// reads at most SLOTS panels, so a warpgroup that waits for its turn never
// holds a slot that another one needs. slots: SLOTS panels on 1024 bytes;
// full, empty: SLOTS barriers each.
template <int SLOTS, class Panels>
struct PanelRing {
  const __nv_bfloat16* W;
  __nv_bfloat16* slots;
  uint64_t* full;
  uint64_t* empty;
  int seq, total;

  // one thread, before the block's barrier that publishes the barriers
  __device__ __forceinline__ void init(int readers) const {
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(full + i, 1);  // the thread that asks for the copy, with the bytes it expects
      mbar_init(empty + i, readers);
    }
    mbar_init_fence();
  }
  // one thread (the feeder), after that barrier: the first panels
  __device__ __forceinline__ void prime() {
    for (int s = 0; s < SLOTS && s < total; ++s) fill(s);
  }
  __device__ __forceinline__ void fill(int s) {
    const int slot = s % SLOTS;
    mbar_arrive_expect_tx(full + slot, PANEL_ELEMS * 2);
    bulk_copy(slots + slot * PANEL_ELEMS, W + Panels::at(s % Panels::COUNT), PANEL_ELEMS * 2, full + slot);
  }
  __device__ __forceinline__ const __nv_bfloat16* wait(int j) {
    const int s = seq + j;
    mbar_wait(full + (s % SLOTS), (s / SLOTS) & 1);
    return slots + (s % SLOTS) * PANEL_ELEMS;
  }
  __device__ __forceinline__ void release(int j) {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + ((seq + j) % SLOTS));
  }
  // the feeder, of the warpgroup that reads each panel last: when the slot is
  // free, ask for the panel that takes its place
  __device__ __forceinline__ void refill(int j) {
    const int s = seq + j;
    if (s + SLOTS < total) {
      mbar_wait(empty + (s % SLOTS), (s / SLOTS) & 1);
      fill(s + SLOTS);
    }
  }
};

}  // namespace mma_tile
