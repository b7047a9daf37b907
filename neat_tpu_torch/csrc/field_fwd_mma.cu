// The field pass's forward on the tensor cores (bf16): K2-fwd, which stashes
// its residuals, and K3-fwd, which keeps none. Replaces
// neat_tpu/ops/fused_field_stash.py:_fwd_stash_kernel and
// neat_tpu/ops/fused_field.py:_fwd_kernel; the math is field_fwd_res of
// ops/fused_field_stash.py (K3-fwd returns its four outputs alone).
//
// Per point: the 9-layer implicit chain (softplus 100, the skip at layer 4),
// the sphere clamp, the spatial gradient by a sweep back through the eight
// implicit layers (dX = dY W^T, times sigma' = 1 - exp(-100 h) of the stashed
// post-activation h), then the rendering head ([x, PE4(d), grads, feats] ->
// 4 x 256 relu -> 3, sigmoid) and the attraction head ([x, d, grads, feats]
// -> 4 x 256 relu -> 6).
//
// What bounds it: operations (3.04 MFLOP a point, 0.31 ms at 100,352 points
// at the bf16 tensor-core rate) and, for K2, the stash it writes (8.1 KB of
// bf16 and 1.2 KB of f32 a point, 0.28 ms at the memory's rate).
//
// The design is K1's (fused_sdf.cu: fused_sdf_mma) carried to 27 products
// a tile: 128 points a block, two warpgroups of four warps, each warp owning
// 16 rows through every layer; wgmma m64n256k16 with A from registers and B
// from a ring of four 32 KB swizzled weight panels in shared memory, filled
// by cp.async.bulk with an mbarrier a slot; the warpgroups take turns at the
// tensor cores (named barriers), so one's epilogue runs under the other's
// products; persistent over tiles. The weights are pack_field_weights'
// buffer: the shared-memory image of 99 panels in the order a tile reads
// them (K1's 29, layer 8's features, the sweep's transposed panels, the
// heads), then W_13 and W_18 for the per-row dot products of the two output
// layers.
//
// Everything a warp computes stays in its own 16 rows, so no block barrier
// separates layers: an epilogue overwrites the warp's strip of the one
// activation buffer after a __syncwarp(). Shared memory holds the panels,
// that buffer, a per-warp union of the bf16 embedding (layer 0's and the
// skip's input, later a head's leading inputs) and the f32 embedding
// cotangent, and a few floats a row. The eight implicit post-activations do
// not fit: each is written out (the stash in K2, a per-block scratch in K3)
// and read back, row by row, when the sweep needs its sigma'. The stash row
// is 4057 bf16, so rows alternate in 4-byte alignment: the warp copies its
// rows out of (and back into) the activation buffer as runs of bf16 pairs,
// never from the accumulator fragments. Layer 8's features go out as f32 (z8
// of stash_f32, or the scratch) and come back, rounded to bf16, as each
// head's feature input.
//
// Rounding is the plain version's: each activation, the skip concat with
// bf16(1/sqrt 2), each sweep cotangent after its sigma' product (the
// embedding's cotangent stays f32), the heads' inputs.
#include "common.cuh"
#include "mma_tile.cuh"

// The packed operands; ops/fused_field_stash.py:pack_field_weights writes
// them and exports the same numbers.
constexpr int TILE_POINTS = 128;   // points a block works on at a time
constexpr int MMA_THREADS = 256;   // 8 warps x 16 rows: two warpgroups
constexpr int N_SDF_PANELS = 29;   // K1's panels, first in the buffer
constexpr int N_FIELD_PANELS = 99;  // the panels a tile reads, in order
constexpr int SDF_W_TOTAL = 475392;  // K1's buffer: its panels and W_8's sdf column
constexpr int W8_OFF = 475136;     // W_8's sdf column, 256 bf16
constexpr int W13_OFF = 1622272;   // W_13^T (3 x 256)
constexpr int W18_OFF = 1623040;   // W_18^T (6 x 256)
constexpr int FIELD_W_TOTAL = 1624576;
constexpr int B8_OFF = 2048;       // biases: layer l < 8 at 256 * l, b_8's sdf entry,
constexpr int B8F_OFF = 2304;      // b_8's features,
constexpr int B9_OFF = 2560;       // b_9 .. b_12 256 apart, b_13,
constexpr int B13_OFF = 3584;
constexpr int B14_OFF = 3840;      // b_14 .. b_17, b_18
constexpr int B18_OFF = 4864;
constexpr int FIELD_B_TOTAL = 5120;
static_assert(SDF_W_TOTAL == N_SDF_PANELS * mma_tile::PANEL_ELEMS + 256 && W8_OFF == SDF_W_TOTAL - 256,
              "K1's buffer leads");
static_assert(W13_OFF == SDF_W_TOTAL + (N_FIELD_PANELS - N_SDF_PANELS) * mma_tile::PANEL_ELEMS &&
                  W18_OFF == W13_OFF + 3 * 256 && FIELD_W_TOTAL == W18_OFF + 6 * 256,
              "packed weight layout");

constexpr int N_SKIP = 217;                // h3's columns in the skip concat
constexpr int LDA = 256 + mma_tile::PAD;   // 264: row stride of the activations
constexpr int LDEM = 48 + mma_tile::PAD;   // 56: row stride of the embedding / leading inputs
constexpr int LDCE = 40;                   // row stride of the f32 embedding cotangent
constexpr int EC_WARP = 2560;              // bytes of a warp's embedding / cotangent union
constexpr int LDR = 16;                    // floats a row: x 0..2, d 4..6, grads 8..10, m_raw, m_sph, |x| 12..14
constexpr int PRODUCTS = 27;               // turns at the tensor cores a tile (layer 9 and 14 take two)
static_assert(mma_tile::WARP_ROWS * LDEM * 2 <= EC_WARP && mma_tile::WARP_ROWS * LDCE * 4 == EC_WARP,
              "the embedding and its cotangent share a warp's bytes");
// the per-block scratch of K3-fwd: the implicit post-activations (bf16, the
// stash's first 2009 columns) and layer 8's features (f32)
constexpr int W_IMPLICIT = 2009;
constexpr long SCRATCH_CD = (long)TILE_POINTS * W_IMPLICIT;
constexpr long SCRATCH_F32 = (long)TILE_POINTS * 256;

constexpr int N_SLOTS = 4;  // weight panels in shared memory at a time
constexpr int SMEM_MMA = 2 * (N_SLOTS * mma_tile::PANEL_ELEMS + TILE_POINTS * LDA) + 8 * EC_WARP +
                         4 * TILE_POINTS * LDR + 2 * N_SLOTS * 8 + 1024;
static_assert(SMEM_MMA <= 232448, "shared memory of one block");

// softplus(100 z) / 100 in seven operations, two on the special-function
// unit (K1's); below z = -0.166 it gives 0 where the true value is under 6e-10
__device__ __forceinline__ float softplus100_fast(float z) {
  float e, l;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fabsf(z) * -144.26950408889634f));
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(1.f + e));
  return fmaf(l, 0.0069314718055994531f, fmaxf(z, 0.f));
}
// sigma'(z) = 1 - exp(-100 h) of the post-activation h = softplus100(z)
__device__ __forceinline__ float sigma_prime(float h) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(h * -144.26950408889634f));
  return 1.f - e;
}

// the ring of N_SLOTS weight panels (mma_tile::PanelRing, as K1's): the
// tile's N_FIELD_PANELS panels, K1's first, then the heads' after K1's
// buffer
struct FieldPanels {
  static constexpr int COUNT = N_FIELD_PANELS;
  __device__ static long at(int p) {
    return p < N_SDF_PANELS ? (long)p * mma_tile::PANEL_ELEMS
                            : SDF_W_TOTAL + (long)(p - N_SDF_PANELS) * mma_tile::PANEL_ELEMS;
  }
};
using PanelRing = mma_tile::PanelRing<N_SLOTS, FieldPanels>;

// acc = (accumulate ? acc : 0) + A[16 x 16*KS*NP] W^T from the next NP panels
// of the ring, KS k16 steps of each; two panels to a wgmma group
template <int NP, int KS, int LD>
__device__ __forceinline__ void products(float (&acc)[32][4], const __nv_bfloat16* A, PanelRing& ring,
                                         bool feeder, bool accumulate) {
  constexpr int G = NP < 2 ? 1 : 2;
#pragma unroll
  for (int j0 = 0; j0 < NP; j0 += G) {
    const __nv_bfloat16* w[G];
#pragma unroll
    for (int jj = 0; jj < G; ++jj) w[jj] = ring.wait(j0 + jj);
    mma_tile::warpgroup_mma<G, KS, LD>(acc, A + j0 * mma_tile::PANEL_K, w, accumulate || j0 > 0);
#pragma unroll
    for (int jj = 0; jj < G; ++jj) ring.release(j0 + jj);
    if (feeder) {
#pragma unroll
      for (int jj = 0; jj < G; ++jj) ring.refill(j0 + jj);
    }
  }
  ring.seq += NP;
}

// A[g or g+8][8j + 2t ..] <- rnd(act(acc + b)) for all 256 columns;
// RELU: relu, else softplus 100
template <bool RELU>
__device__ __forceinline__ void store_act(const float (&acc)[32][4], const float* __restrict__ b,
                                          __nv_bfloat16* A) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b + col));
    float v[4] = {acc[j][0] + bb.x, acc[j][1] + bb.y, acc[j][2] + bb.x, acc[j][3] + bb.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = RELU ? fmaxf(v[i], 0.f) : softplus100_fast(v[i]);
    uint32_t* p = reinterpret_cast<uint32_t*>(A + g * LDA + col);
    p[0] = mma_tile::pack_bf16x2(v[0], v[1]);
    p[4 * LDA] = mma_tile::pack_bf16x2(v[2], v[3]);
  }
}

// out[o] (rows g and g+8, summed over the warp's 4 lanes of the row) =
// A[row][:] . M[o][:] over the 256 columns of the strip (M: NOUT rows of 256 bf16)
template <int NOUT>
__device__ __forceinline__ void row_dots(const __nv_bfloat16* A, const __nv_bfloat16* __restrict__ M,
                                         float (&lo)[NOUT], float (&hi)[NOUT]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int o = 0; o < NOUT; ++o) lo[o] = hi[o] = 0.f;
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 a = mma_tile::unpack_bf16x2(*reinterpret_cast<const uint32_t*>(A + g * LDA + col));
    const float2 c = mma_tile::unpack_bf16x2(*reinterpret_cast<const uint32_t*>(A + (g + 8) * LDA + col));
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      const float2 w = mma_tile::unpack_bf16x2(__ldg(reinterpret_cast<const uint32_t*>(M + o * 256 + col)));
      lo[o] = fmaf(a.x, w.x, lo[o]);
      lo[o] = fmaf(a.y, w.y, lo[o]);
      hi[o] = fmaf(c.x, w.x, hi[o]);
      hi[o] = fmaf(c.y, w.y, hi[o]);
    }
  }
#pragma unroll
  for (int o = 0; o < NOUT; ++o) {
    lo[o] += __shfl_xor_sync(0xffffffffu, lo[o], 1);
    hi[o] += __shfl_xor_sync(0xffffffffu, hi[o], 1);
    lo[o] += __shfl_xor_sync(0xffffffffu, lo[o], 2);
    hi[o] += __shfl_xor_sync(0xffffffffu, hi[o], 2);
  }
}

// Moving the warp's rows between the activation buffer and the stash. A
// stash row starts anywhere in a 16-byte piece (its rows are 4057 bf16
// apart): m = its start's element offset in the piece. Out: bf16 pairs, the
// row's first element alone where it is not 4-byte aligned, an odd last
// element alone (16-byte pieces with shifted reads measured slower). In:
// whole 16-byte pieces. The memory accesses of ROW_BATCH rows are in flight
// together: one round trip a batch.
constexpr int ROW_BATCH = 4;

__device__ __forceinline__ int piece_offset(const __nv_bfloat16* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 1) & 7);
}

// elements p, p + 1 of an activation row as one word (p may be odd)
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* row, int p) {
  if (!(p & 1)) return *reinterpret_cast<const uint32_t*>(row + p);
  const unsigned short* q = reinterpret_cast<const unsigned short*>(row + p);
  return (uint32_t)q[0] | ((uint32_t)q[1] << 16);
}

// the warp's valid rows, columns [0, width) of A, out to the stash rows
// S[r * ld + col0 ..]
__device__ __forceinline__ void copy_out(const __nv_bfloat16* __restrict__ A, __nv_bfloat16* __restrict__ S,
                                         long ld, int col0, int width, int rows) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int r0 = 0; r0 < rows; r0 += ROW_BATCH) {
    uint32_t v[ROW_BATCH][4];
    __nv_bfloat16 first[ROW_BATCH], last[ROW_BATCH];
#pragma unroll
    for (int rr = 0; rr < ROW_BATCH; ++rr) {
      const __nv_bfloat16* src = A + (r0 + rr) * LDA;
      const int head = piece_offset(S + (r0 + rr) * ld + col0) & 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = head + 2 * (lane + 32 * i);
        v[rr][i] = c + 1 < width ? ld_pair(src, c) : 0u;
      }
      first[rr] = src[0];
      last[rr] = src[width - 1];
    }
#pragma unroll
    for (int rr = 0; rr < ROW_BATCH; ++rr) {
      if (r0 + rr >= rows) break;
      __nv_bfloat16* dst = S + (r0 + rr) * ld + col0;
      const int head = piece_offset(dst) & 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = head + 2 * (lane + 32 * i);
        if (c + 1 < width) *reinterpret_cast<uint32_t*>(dst + c) = v[rr][i];
      }
      if (head && lane == 0) dst[0] = first[rr];
      if (((width - head) & 1) && lane == 1) dst[width - 1] = last[rr];
    }
  }
}

// the reverse, as a copy of whole 16-byte pieces: A's row r receives the 33
// pieces that hold stash columns [col0, col0 + 256), so its column m_r + c
// holds column col0 + c (m_r = piece_offset of the stash row, which
// sweep_epilogue takes into account); rows past `rows` are zeros
__device__ __forceinline__ void load_in(__nv_bfloat16* A, const __nv_bfloat16* S, long ld, int col0,
                                        int rows) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int r0 = 0; r0 < mma_tile::WARP_ROWS; r0 += ROW_BATCH) {
    uint4 v[ROW_BATCH], last[ROW_BATCH];
#pragma unroll
    for (int rr = 0; rr < ROW_BATCH; ++rr) {
      const __nv_bfloat16* src = S + (r0 + rr) * ld + col0;
      const uint4* base = reinterpret_cast<const uint4*>(src - piece_offset(src));
      const bool ok = r0 + rr < rows;
      v[rr] = ok ? base[lane] : make_uint4(0u, 0u, 0u, 0u);
      last[rr] = ok && lane == 0 ? base[32] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int rr = 0; rr < ROW_BATCH; ++rr) {
      uint4* dst = reinterpret_cast<uint4*>(A + (r0 + rr) * LDA);
      dst[lane] = v[rr];
      if (lane == 0) dst[32] = last[rr];
    }
  }
}

// asks L2 for bytes [off, off + bytes) of each of the warp's valid rows
// (row stride ld bytes), one lane a row: issued a step before the rows are
// read, it turns the read's trips to device memory into hits in L2
__device__ __forceinline__ void prefetch_rows(const void* base, long ld, int off, int bytes, int rows) {
  const int lane = threadIdx.x & 31;
  if (lane < rows) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(base) + lane * ld + off;
    const uintptr_t lo = a & ~(uintptr_t)15, hi = (a + bytes + 15) & ~(uintptr_t)15;
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(lo), "r"((uint32_t)(hi - lo)) : "memory");
  }
}

// layer 8's features of the warp's valid rows, rounded to bf16, into A (a
// head's feature input); rows past `rows` are zeros. Eight 16-byte loads a
// lane in flight at a time.
__device__ __forceinline__ void load_feats(__nv_bfloat16* A, const float* Z, long ldz, int rows) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int i0 = 0; i0 < mma_tile::WARP_ROWS * 64; i0 += 8 * 32) {
    float4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + 32 * k + lane, r = i >> 6, c = (i & 63) * 4;
      v[k] = r < rows ? *reinterpret_cast<const float4*>(Z + r * ldz + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + 32 * k + lane, r = i >> 6, c = (i & 63) * 4;
      uint2 p;
      p.x = mma_tile::pack_bf16x2(v[k].x, v[k].y);
      p.y = mma_tile::pack_bf16x2(v[k].z, v[k].w);
      *reinterpret_cast<uint2*>(A + r * LDA + c) = p;
    }
  }
}

// One step of the gradient sweep, on u = V_L W_L^T in acc: the cotangent of
// layer L-1's pre-activation, V_{L-1} = rnd(u sigma'(h_{L-1})), over the
// h_{L-1} that A holds (read back from the stash), in place. Layer 4
// (skip): u / sqrt 2, and its columns >= N_SKIP are the embedding's share,
// CE = u / sqrt 2, V = 0 there. One copy of the code serves every layer
// (L is a runtime value, the layer-4 terms predicated): the steps run as a
// loop, out of the instruction cache.
__device__ __forceinline__ void sweep_epilogue(const float (&acc)[32][4], __nv_bfloat16* A, float* CE,
                                               bool skip, const int (&m)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float cs = skip ? INV_SQRT2 : 1.f;
  // h sits at column m + col of the row as load_in left it: a half's reads
  // (columns up to m + 128 * (half + 1)) all come before its writes
  // (columns below 128 * (half + 1)), and after the previous half's writes
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t hw[16][2];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int col = 8 * (16 * half + jj) + 2 * t;
        const uint32_t* hp = reinterpret_cast<const uint32_t*>(A + (g + 8 * hf) * LDA) + ((m[hf] + col) >> 1);
        hw[jj][hf] = (m[hf] & 1) ? __byte_perm(hp[0], hp[1], 0x5432) : hp[0];
      }
    }
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = 16 * half + jj, col = 8 * j + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = g + 8 * hf;
        const float u0 = acc[j][2 * hf] * cs, u1 = acc[j][2 * hf + 1] * cs;
        const float2 h = mma_tile::unpack_bf16x2(hw[jj][hf]);
        float v0 = u0 * sigma_prime(h.x), v1 = u1 * sigma_prime(h.y);
        if (8 * j + 8 > N_SKIP) {  // the tile of columns that reaches the embedding's share
          if (skip && col >= N_SKIP) {
            CE[r * LDCE + col - N_SKIP] = u0;
            v0 = 0.f;
          }
          if (skip && col + 1 >= N_SKIP) {
            CE[r * LDCE + col + 1 - N_SKIP] = u1;
            v1 = 0.f;
          }
        }
        *reinterpret_cast<uint32_t*>(A + r * LDA + col) = mma_tile::pack_bf16x2(v0, v1);
      }
    }
    __syncwarp();
  }
}

// FULL (K2-fwd): the stash rows, stash_f32 and the heads' activations are
// written; else (K3-fwd) the implicit post-activations and the features go
// to this block's scratch and nothing else is kept
template <bool FULL>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    field_fwd_mma(const float* __restrict__ x, const float* __restrict__ d,
                  const __nv_bfloat16* __restrict__ W, const float* __restrict__ B,
                  float* __restrict__ o_sdf, float* __restrict__ o_grads, float* __restrict__ o_rgb,
                  float* __restrict__ o_att, __nv_bfloat16* scd, float* sz, int n, float radius,
                  float scale) {
  extern __shared__ unsigned char smem_raw[];
  // the panel slots first, on 1024 bytes (a swizzled panel's alignment)
  __nv_bfloat16* slots = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024u - (mma_tile::smem_u32(smem_raw) & 1023u)) & 1023u));
  __nv_bfloat16* act = slots + N_SLOTS * mma_tile::PANEL_ELEMS;  // TILE_POINTS x LDA
  unsigned char* ec = reinterpret_cast<unsigned char*>(act + TILE_POINTS * LDA);  // 8 x EC_WARP
  float* rowf = reinterpret_cast<float*>(ec + 8 * EC_WARP);                      // TILE_POINTS x LDR
  uint64_t* full = reinterpret_cast<uint64_t*>(rowf + TILE_POINTS * LDR);
  uint64_t* empty = full + N_SLOTS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  const int tiles = (n + TILE_POINTS - 1) / TILE_POINTS;
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  PanelRing ring{W, slots, full, empty, 0, mine * N_FIELD_PANELS};
  if (threadIdx.x == 0) ring.init(8);  // one lane of each warp reads each panel
  __syncthreads();
  const bool feeder = threadIdx.x == 128;  // warpgroup 1 reads every panel last
  if (feeder) ring.prime();

  // the two warpgroups take turns at the tensor cores: barrier 1 + wg is "wg's turn"
  const int wg = warp >> 2;
  int turns_left = mine * PRODUCTS;
  auto take_turn = [&]() { mma_tile::named_sync(1 + wg, MMA_THREADS); };
  auto give_turn = [&]() {  // the other's, unless this was the kernel's last turn
    --turns_left;
    if (wg == 0 || turns_left > 0) mma_tile::named_arrive(2 - wg, MMA_THREADS);
  };
  if (wg == 1) mma_tile::named_arrive(1, MMA_THREADS);  // warpgroup 0 goes first

  constexpr int R = mma_tile::WARP_ROWS;
  __nv_bfloat16* A = act + warp * R * LDA;  // this warp's strips
  __nv_bfloat16* E = reinterpret_cast<__nv_bfloat16*>(ec + warp * EC_WARP);
  float* CE = reinterpret_cast<float*>(ec + warp * EC_WARP);
  float* RF = rowf + warp * R * LDR;
  const float c = rnd<__nv_bfloat16>(INV_SQRT2);
  const long ld_s = FULL ? W_CD : W_IMPLICIT;
  const long ld_z = FULL ? W_F32 : 256;

  float acc[32][4];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * TILE_POINTS + warp * R;  // the strip's first row
    const int rows = n - row0 >= R ? R : (n - row0 > 0 ? (int)(n - row0) : 0);
    // the strip's stash rows and features: K2's own rows, K3's scratch
    __nv_bfloat16* S = FULL ? scd + row0 * W_CD
                            : scd + (long)blockIdx.x * SCRATCH_CD + (long)warp * R * W_IMPLICIT;
    float* Z = FULL ? sz + row0 * W_F32 + 40 : sz + (long)blockIdx.x * SCRATCH_F32 + (long)warp * R * 256;

    // x and d (rows past the end: x = 1, d = 0), the embedding
    if (lane < R) {
      const bool ok = lane < rows;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        RF[lane * LDR + k] = ok ? x[(row0 + lane) * 3 + k] : 1.f;
        RF[lane * LDR + 4 + k] = ok ? d[(row0 + lane) * 3 + k] : 0.f;
      }
    }
    __syncwarp();
    for (int i = lane; i < R * 48; i += 32) {
      const int r = i / 48, j = i % 48;
      const float v = j < 39 ? pe_val(RF + r * LDR, j) : 0.f;
      E[r * LDEM + j] = __float2bfloat16_rn(v);
      if (FULL && j < 39 && r < rows) sz[(row0 + r) * W_F32 + j] = v;
    }
    __syncwarp();

    // ---- the implicit chain, each post-activation out to the stash ----
#pragma unroll 1
    for (int l = 0; l <= 7; ++l) {
      take_turn();
      if (l == 0) products<1, 3, LDEM>(acc, E, ring, feeder, false);
      else products<4, 4, LDA>(acc, A, ring, feeder, false);
      give_turn();
      __syncwarp();  // the strip is read: it may be overwritten
      if (l < 7) {
        store_act<false>(acc, B + 256 * l, A);
        __syncwarp();
        copy_out(A, S, ld_s, soff(l), l == 3 ? N_SKIP : 256, rows);
        if (l == 3) {  // the skip concat: [h3, emb] * rnd(1/sqrt 2), rounded
          __syncwarp();
          for (int i = lane; i < R * 256; i += 32) {
            const int r = i >> 8, j = i & 255;
            const float v = j < N_SKIP ? __bfloat162float(A[r * LDA + j]) : __bfloat162float(E[r * LDEM + j - N_SKIP]);
            A[r * LDA + j] = __float2bfloat16_rn(v * c);
          }
        }
        __syncwarp();
        continue;
      }
      // layer 7: h7, and the last layer's sdf column as a dot product over it
      float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(B + 256 * 7 + col));
        const float2 w8 = mma_tile::unpack_bf16x2(__ldg(reinterpret_cast<const uint32_t*>(W + W8_OFF + col)));
        const uint32_t lo = mma_tile::pack_bf16x2(softplus100_fast(acc[j][0] + bb.x), softplus100_fast(acc[j][1] + bb.y));
        const uint32_t hi = mma_tile::pack_bf16x2(softplus100_fast(acc[j][2] + bb.x), softplus100_fast(acc[j][3] + bb.y));
        *reinterpret_cast<uint32_t*>(A + g * LDA + col) = lo;
        *reinterpret_cast<uint32_t*>(A + (g + 8) * LDA + col) = hi;
        const float2 fl = mma_tile::unpack_bf16x2(lo), fh = mma_tile::unpack_bf16x2(hi);
        s_lo = fmaf(fl.x, w8.x, s_lo);
        s_lo = fmaf(fl.y, w8.y, s_lo);
        s_hi = fmaf(fh.x, w8.x, s_hi);
        s_hi = fmaf(fh.y, w8.y, s_hi);
      }
      s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 1);
      s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 1);
      s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 2);
      s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 2);
      if (t == 0) {  // the sphere clamp with balanced tie multipliers, rows g and g + 8
        const float b8 = __ldg(B + B8_OFF);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = g + 8 * hf;
          const float raw = (hf ? s_hi : s_lo) + b8;
          const float* xr = RF + r * LDR;
          const float nx = sqrtf(xr[0] * xr[0] + xr[1] * xr[1] + xr[2] * xr[2]);
          const float sph = scale * (radius - nx);
          RF[r * LDR + 12] = raw < sph ? 1.f : (raw == sph ? 0.5f : 0.f);
          RF[r * LDR + 13] = sph < raw ? 1.f : (raw == sph ? 0.5f : 0.f);
          RF[r * LDR + 14] = nx;
          if (r < rows) {
            o_sdf[row0 + r] = fminf(raw, sph);
            if (FULL) sz[(row0 + r) * W_F32 + 39] = raw;
          }
        }
      }
      __syncwarp();
      copy_out(A, S, ld_s, soff(7), 256, rows);
      __syncwarp();
    }

    // ---- layer 8's features, out as f32; the sweep's seed over h7 ----
    take_turn();
    products<4, 4, LDA>(acc, A, ring, feeder, false);
    give_turn();
    prefetch_rows(S, 2 * ld_s, 2 * soff(6), 2 * 256, rows);  // the sweep's first read
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(B + B8F_OFF + col));
      const float2 w8 = mma_tile::unpack_bf16x2(__ldg(reinterpret_cast<const uint32_t*>(W + W8_OFF + col)));
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = g + 8 * hf;
        if (r < rows)
          *reinterpret_cast<float2*>(Z + r * ld_z + col) =
              make_float2(acc[j][2 * hf] + bb.x, acc[j][2 * hf + 1] + bb.y);
        // the seed is one-hot on the sdf channel: u = W_8's sdf column, V7 = rnd(u sigma'_7)
        uint32_t* p = reinterpret_cast<uint32_t*>(A + r * LDA + col);
        const float2 h = mma_tile::unpack_bf16x2(*p);
        *p = mma_tile::pack_bf16x2(w8.x * sigma_prime(h.x), w8.y * sigma_prime(h.y));
      }
    }
    __syncwarp();

    // ---- the spatial-gradient sweep over the transposed panels ----
#pragma unroll 1
    for (int L = 7; L >= 1; --L) {
      take_turn();
      products<4, 4, LDA>(acc, A, ring, feeder, false);
      give_turn();
      if (L >= 2)  // the next step's rows; after the last step, the features
        prefetch_rows(S, 2 * ld_s, 2 * soff(L - 2), 512, rows);
      else
        prefetch_rows(Z, 4 * ld_z, 0, 1024, rows);
      __syncwarp();
      load_in(A, S, ld_s, soff(L - 1), rows);
      __syncwarp();
      const int m[2] = {piece_offset(S + g * ld_s + soff(L - 1)), piece_offset(S + (g + 8) * ld_s + soff(L - 1))};
      sweep_epilogue(acc, A, CE, L == 4, m);
      __syncwarp();
    }
    take_turn();
    products<4, 4, LDA>(acc, A, ring, feeder, false);
    give_turn();
#pragma unroll
    for (int j = 0; j < 5; ++j) {  // layer 0: the embedding's columns 0..38
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = g + 8 * hf;
        if (col < 39) CE[r * LDCE + col] += acc[j][2 * hf];
        if (col + 1 < 39) CE[r * LDCE + col + 1] += acc[j][2 * hf + 1];
      }
    }
    __syncwarp();
    // grads = m_raw J_PE(x)^T CE + m_sph (-scale x / |x|)
    if (lane < R) {
      float* rf = RF + lane * LDR;
      const float* ce = CE + lane * LDCE;
      float gm[3] = {ce[0], ce[1], ce[2]};
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float f = (float)(1 << k);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          float sn, cs;
          sincosf(f * rf[q], &sn, &cs);
          gm[q] = gm[q] + f * (ce[3 + 6 * k + q] * cs - ce[6 + 6 * k + q] * sn);
        }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float gs = -scale * rf[q] / rf[14];
        const float gc = rf[12] * gm[q] + rf[13] * gs;
        rf[8 + q] = gc;
        if (lane < rows) o_grads[(row0 + lane) * 3 + q] = gc;
      }
    }
    __syncwarp();

    // ---- the two heads ----
#pragma unroll 1
    for (int head = 0; head < 2; ++head) {
      // leading inputs: [x, PE4(d), grads] (33) or [x, d, grads] (9), rounded
      const int nd = head == 0 ? 27 : 3;
      for (int i = lane; i < R * 48; i += 32) {
        const int r = i / 48, j = i % 48;
        const float* rf = RF + r * LDR;
        float v = 0.f;
        if (j < 3) v = rf[j];
        else if (j < 3 + nd) v = pe_val(rf + 4, j - 3);
        else if (j < 6 + nd) v = rf[8 + j - 3 - nd];
        E[r * LDEM + j] = __float2bfloat16_rn(v);
      }
      load_feats(A, Z, ld_z, rows);
      __syncwarp();
      // the first layer in two turns: the leading panel, then the features'
      take_turn();
      if (head == 0) products<1, 3, LDEM>(acc, E, ring, feeder, false);
      else products<1, 1, LDEM>(acc, E, ring, feeder, false);
      give_turn();
      take_turn();
      products<4, 4, LDA>(acc, A, ring, feeder, true);
      give_turn();
      if (head == 0) prefetch_rows(Z, 4 * ld_z, 0, 1024, rows);  // the attraction head's features
      const float* bh = B + (head == 0 ? B9_OFF : B14_OFF);
      const int col0 = head == 0 ? S_RENDER : S_ATTR;
#pragma unroll 1
      for (int l = 0; l < 4; ++l) {
        if (l > 0) {
          take_turn();
          products<4, 4, LDA>(acc, A, ring, feeder, false);
          give_turn();
        }
        __syncwarp();
        store_act<true>(acc, bh + 256 * l, A);
        __syncwarp();
        if (FULL) {
          copy_out(A, S, ld_s, col0 + 256 * l, 256, rows);
          __syncwarp();
        }
      }
      // the output layer: per-row dot products over the last hidden layer
      if (head == 0) {
        float lo[3], hi[3];
        row_dots<3>(A, W + W13_OFF, lo, hi);
        if (t == 0) {
#pragma unroll
          for (int o = 0; o < 3; ++o) {
            const float bo = __ldg(B + B13_OFF + o);
            if (g < rows) o_rgb[(row0 + g) * 3 + o] = 1.f / (1.f + expf(-(lo[o] + bo)));
            if (g + 8 < rows) o_rgb[(row0 + g + 8) * 3 + o] = 1.f / (1.f + expf(-(hi[o] + bo)));
          }
        }
      } else {
        float lo[6], hi[6];
        row_dots<6>(A, W + W18_OFF, lo, hi);
        if (t == 0) {
#pragma unroll
          for (int o = 0; o < 6; ++o) {
            const float bo = __ldg(B + B18_OFF + o);
            if (g < rows) o_att[(row0 + g) * 6 + o] = lo[o] + bo;
            if (g + 8 < rows) o_att[(row0 + g + 8) * 6 + o] = hi[o] + bo;
          }
        }
      }
      __syncwarp();
    }
  }
}

template <bool FULL>
static int launch(const void* x, const void* d, const void* w, const void* b, void* sdf, void* grads,
                  void* rgb, void* att, void* scd, void* sz, int n, int max_blocks, float radius,
                  float scale, void* stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(field_fwd_mma<FULL>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MMA);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int tiles = (n + TILE_POINTS - 1) / TILE_POINTS;
  field_fwd_mma<FULL><<<tiles < max_blocks ? tiles : max_blocks, MMA_THREADS, SMEM_MMA,
                        (cudaStream_t)stream>>>(
      (const float*)x, (const float*)d, (const __nv_bfloat16*)w, (const float*)b, (float*)sdf,
      (float*)grads, (float*)rgb, (float*)att, (__nv_bfloat16*)scd, (float*)sz, n, radius, scale);
  return (int)cudaGetLastError();
}

// K3-fwd's scratch, per block: bf16 post-activations and f32 features
extern "C" void field_fwd_mma_layout(int n, int max_blocks, int* n_blocks, long long* scratch_cd,
                                     long long* scratch_f32) {
  const int tiles = (n + TILE_POINTS - 1) / TILE_POINTS;
  *n_blocks = tiles < max_blocks ? tiles : max_blocks;
  *scratch_cd = SCRATCH_CD;
  *scratch_f32 = SCRATCH_F32;
}

// K2-fwd: outputs, stash_cd (N x 4057 bf16) and stash_f32 (N x 296 f32);
// packed operands (pack_field_weights)
extern "C" int field_fwd_mma_stash(const void* x, const void* d, const void* w, const void* b, void* sdf,
                                   void* grads, void* rgb, void* att, void* scd, void* sf32, int n,
                                   int max_blocks, float radius, float scale, void* stream) {
  return launch<true>(x, d, w, b, sdf, grads, rgb, att, scd, sf32, n, max_blocks, radius, scale, stream);
}

// K3-fwd: outputs only; scratch as field_fwd_mma_layout sizes it
extern "C" int field_fwd_mma_primal(const void* x, const void* d, const void* w, const void* b, void* sdf,
                                    void* grads, void* rgb, void* att, void* scratch_cd, void* scratch_f32,
                                    int n, int max_blocks, float radius, float scale, void* stream) {
  return launch<false>(x, d, w, b, sdf, grads, rgb, att, scratch_cd, scratch_f32, n, max_blocks, radius,
                       scale, stream);
}
