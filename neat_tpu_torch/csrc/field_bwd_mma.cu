// The split field backward's row-local pass on the tensor cores (bf16): the
// "mma" variant of K2-bwd's and K3-bwd's row-local pass. Replaces the scalar
// tile with EMIT (field_tile.cuh: field_bwd_tile) for
// neat_tpu/ops/fused_field_stash.py:_bwd_stash_kernel and, chunk by chunk,
// neat_tpu/ops/fused_field.py:_bwd_kernel. The math is _bwd_rowlocal of
// ops/fused_field_stash.py (its plain version field_bwd_rowlocal_plain): from
// the stash and the output cotangents, the two heads' backward, the tangent
// forward (xdot = C_g m_raw) over the stashed activations, the combined
// primal + tangent reverse sweep, and dx, dd. It writes what the scalar tile
// writes: every weight-gradient operand, rounded to bf16, into the
// feature-major workspace (rows from ops/field_dw.py:ws_row_table), the bias
// gradients and layer 8's tangent column as per-block partials, dx and dd.
// The GEMM of field_dw_mma.cu sums the workspace afterwards.
//
// What bounds it: bytes. It reads the stash (9.3 KB a point) and writes the
// workspace (25.7 KB a point): 1.06 ms at 100,352 points at 3.35 TB/s; its
// products (0.48 M MACs a point outside the GEMM) take 0.1 ms at the bf16
// rate.
//
// The design. A block of 512 threads (four warpgroups) works on 64 points at
// a time, persistent over tiles. Every product is 64 rows x 256 columns, and
// each warpgroup computes a quarter of the columns: wgmma m64n64k16 with A
// the activation buffer and B the rows [64 wg, 64 wg + 64) of a weight
// panel, both 128-byte-swizzled in shared memory. So a thread holds, for the
// same 32 elements, the primal and the tangent chain's sums of the combined
// sweep (two 64 x 64 accumulators), and every epilogue is elementwise on the
// accumulator fragments in registers: sigma' and the tangent terms, the relu
// masks, rounding to bf16, the column sums of the bias gradients (shuffles
// across the warp's rows, then the warpgroup's four warps in order:
// deterministic), the stores of the next layer's A operand (swizzled, then
// published to the async proxy before the block's barrier) and of the
// workspace. The panels come from a ring of four slots, filled by
// cp.async.bulk with an mbarrier a slot (mma_tile.cuh's PanelRing); a
// product waits for its four panels and issues all its wgmmas as one group.
// The stash rows are 4057 bf16 long, so odd rows are not 4-byte aligned: an
// epilogue reads its stash elements as bf16 pairs where the pair is aligned
// and one by one where it is not. The tangent pre-activations zdot stay f32
// (the scalar tile's ZD), in a per-block scratch in the fragment layout: the
// thread that writes an element in the tangent forward reads it back in the
// sweep.
//
// A comes from shared memory (wgmma's form with both operands by descriptor,
// as in field_dw_mma.cu), not from registers as in field_fwd_mma.cu: beside
// both chains' accumulators, the registers an A fragment takes are the ones
// the epilogues lack.
//
// What sets its time: the epilogues' memory latency, not the products. Four
// warpgroups of a quarter of the columns each (sixteen warps an SM, 128
// registers a thread) hide more of it than two of a half; what ptxas spills
// goes to local memory that, beside this much shared memory, lives in L2.
//
// Shared memory: the ring (131,072 bytes), the primal and the tangent chain's
// activation buffers (64 x 256 bf16 each: 65,536), 104 floats a row (26,624)
// and the bias sums' staging (4,096): 228,416 bytes with the barriers and the
// panel alignment, of 232,448.
#include "common.cuh"
#include "mma_tile.cuh"

namespace {

using mma_tile::PANEL_ELEMS;

constexpr int TILE = 64;              // points a block works on at a time
constexpr int N_WG = 4;               // warpgroups: each every row, 1 / N_WG of every product's columns
constexpr int THREADS = 128 * N_WG;
constexpr int WG_COLS = 256 / N_WG;   // a warpgroup's columns of a product
constexpr int NJ = WG_COLS / 8;       // its n8 tiles
static_assert(NJ == 8, "the products are wgmma m64n64k16");
static_assert(WG_COLS >= 40, "warpgroup 0 holds the leading cotangents and layer 0's 39 columns");
constexpr int N_PANELS = 105;     // the panels a tile reads, in order (ops/fused_field_stash.py:BWD_PANELS)
constexpr long W13T_OFF = (long)N_PANELS * PANEL_ELEMS;  // W_13^T (3 x 256)
constexpr long W18T_OFF = W13T_OFF + 3 * 256;            // W_18^T (6 x 256)
constexpr long W8S_OFF = W18T_OFF + 6 * 256;             // W_8's sdf column
constexpr int N_SLOTS = 4;
// an activation buffer: the 64 rows x 256 k of a product's A operand as four
// panels of 64 k, each row's 128 bytes with the 128-byte swizzle (the weight
// panels' layout, with 64 rows), so wgmma reads A from shared memory
constexpr int A_PANEL = TILE * 64;  // bf16 elements of one panel of A
constexpr int A_ELEMS = 4 * A_PANEL;
constexpr int N_LEAD_R = 33;  // a head's first layer's leading inputs: [x, PE4(d), grads]
constexpr int N_LEAD_A = 9;   // [x, d, grads]
constexpr int N_SKIP = 217;
// floats a row: fixed slots, then a union (the heads' deltas and leading
// cotangents; later the embedding's cotangents CE and CED)
constexpr int RF = 104;
enum {
  R_X = 0, R_CSDF = 3, R_D = 4, R_MRAW = 7, R_MSPH = 11, R_CG = 12, R_NX = 15, R_CGM = 16,
  R_V0 = 19, R_DXA = 20, R_V0PRE = 23,
  R_D13 = 24, R_D13PRE = 27, R_D18 = 30, R_D18PRE = 36, R_LEADR = 42, R_LEADA = 75,  // the heads
  R_CE = 24, R_CED = 64                                                             // the sweep
};
static_assert(R_LEADA + N_LEAD_A <= RF && R_CED + 40 <= RF, "a row's floats");
// the bias partials of a block: every bias (at common.cuh's b_off: 4,323 in
// all, the sum of the layers' widths), then layer 8's tangent column
constexpr int N_BIAS = 4323;
constexpr int COL8 = N_BIAS;
constexpr int NB = N_BIAS + 256;
// the per-block f32 scratch: zdot of the eight tangent layers and the
// rendering head's feature cotangent, 64 floats a thread each
constexpr int ZD_THREAD = 4 * NJ;
constexpr long SCRATCH = (long)9 * ZD_THREAD * THREADS;
constexpr int STAGE = 4 * N_WG * WG_COLS;  // the bias sums' staging: a float a warp and column
constexpr int SMEM = N_SLOTS * PANEL_ELEMS * 2 + 2 * A_ELEMS * 2 + TILE * RF * 4 + STAGE * 4 +
                     2 * N_SLOTS * 8 + 1024;
static_assert(SMEM <= 232448, "shared memory of one block");

// what the kernel indexes by a runtime layer, in the order of the launch's
// int table (ops/fused_field_stash.py:bwd_mma_table): the first workspace row
// of each operand (ops/field_dw.py:ws_row_table), each bias's offset in a
// block's partials (common.cuh's b_off) and in the gradient vector, and
// where layer 8's tangent column goes (dW_8[k][0], rows out8 apart)
struct Tables {
  int in[19], tin[8], cot[19], tcot[8];
  int boff[20], gbias[19];
  int g8, out8;
};
// in constant memory, where a runtime index costs nothing (a kernel
// argument indexed so is copied to the stack); written before each launch
__constant__ Tables c_rows;

__device__ __forceinline__ float sigma_arg(float h) { return expf(-100.f * h); }  // the scalar tile's em100

// the ring of N_SLOTS weight panels (mma_tile::PanelRing): the tile's
// N_PANELS panels, one after another in W
struct BwdPanels {
  static constexpr int COUNT = N_PANELS;
  __device__ static long at(int p) { return (long)p * PANEL_ELEMS; }
};
using Ring = mma_tile::PanelRing<N_SLOTS, BwdPanels>;

// acc[c] = A_c[64 x 16 KS NP] W^T over the next NP panels of the ring, this
// warpgroup's WG_COLS columns (rows [WG_COLS wg, + WG_COLS) of each panel), for
// the NC chains c whose A buffers are given (the same panels for both)
template <int NP, int KS, int NC>
__device__ __forceinline__ void products(float (&acc)[2][NJ][4], const __nv_bfloat16* A0,
                                         const __nv_bfloat16* A1, Ring& ring, bool feeder, int wg) {
  const uint64_t desc_a[2] = {mma_tile::panel_desc(mma_tile::smem_u32(A0)),
                              mma_tile::panel_desc(mma_tile::smem_u32(NC > 1 ? A1 : A0))};
  // all the product's panels (the ring holds them), then every wgmma in one
  // group: straight-line code, no loop carrying the accumulators
  uint64_t desc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) desc[p] = mma_tile::panel_desc(mma_tile::smem_u32(ring.wait(p))) + (WG_COLS * 128 / 16) * wg;
#pragma unroll
  for (int c = 0; c < NC; ++c) mma_tile::fence_acc(acc[c]);
  mma_tile::wgmma_fence();
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        mma_tile::wgmma_m64n64k16_ss(acc[c], desc_a[c] + (A_PANEL * 2 / 16) * p + 2 * ks, desc[p] + 2 * ks, p > 0 || ks > 0);
  mma_tile::wgmma_commit();
  mma_tile::wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NC; ++c) mma_tile::fence_acc(acc[c]);
#pragma unroll
  for (int p = 0; p < NP; ++p) ring.release(p);
  if (feeder) {
#pragma unroll 1
    for (int p = 0; p < NP; ++p) ring.refill(p);
  }
  ring.seq += NP;
}

__device__ __forceinline__ float rnd16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// two bf16 of a stash row at p (4-byte aligned or not: stash rows are 4057
// bf16 long, so every other row starts mid-word)
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  if (!(reinterpret_cast<uintptr_t>(p) & 2))
    return mma_tile::unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p));
  return make_float2(__bfloat162float(p[0]), __bfloat162float(p[1]));
}

// The thread's part of a product's 64 x 256 result: n8 tile j of its
// warpgroup's columns, element e: row 16 wq + g + 8 (e >> 1), column
// WG_COLS wg + 8 j + 2 t + (e & 1).
struct Frag {
  int wg, wq, g, t;
  __device__ __forceinline__ int row(int e) const { return 16 * wq + g + 8 * (e >> 1); }
  __device__ __forceinline__ int col(int j, int e) const { return WG_COLS * wg + 8 * j + 2 * t + (e & 1); }
};

// the workspace: rows of 64 nc points, at the tile's first point. 12,852
// rows of past 167,000 points pass 2^31 elements, so a row's start is
// counted in 64-point chunks in 32 bits and scaled to elements in 64 (a
// 64-bit product of row and width takes registers the epilogues lack)
struct Ws {
  __nv_bfloat16* p;
  int nc, valid;
  // row `row` (a feature), point r: v rounded (0 past the last point)
  __device__ __forceinline__ void put(int row, int r, float v) const {
    (p + r)[(size_t)((uint32_t)row * (uint32_t)nc) * 64] = __float2bfloat16_rn(r < valid ? v : 0.f);
  }
  // the thread's values at its point r of the features col (va) and col + 1
  // (vb) of an operand whose first row is `row`, those below `width`
  __device__ __forceinline__ void pair(int row, int col, int width, int r, float va, float vb) const {
    if (col < width) put(row + col, r, va);
    if (col + 1 < width) put(row + col + 1, r, vb);
  }
};


// adds the column sums over the tile's 64 rows of v (this thread's 64
// elements) to part[0 .. width) at the thread's columns: the warp's 16 rows
// by shuffles, then the warpgroup's four warps in order (named barrier 1 +
// wg); stage: STAGE floats
__device__ __forceinline__ void col_sums(const float (&v)[NJ][4], float* stage, float* part, int width,
                                         const Frag& f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = v[j][h] + v[j][2 + h];
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
      if (lane < 4) stage[warp * WG_COLS + 8 * j + 2 * f.t + h] = s;
    }
  }
  mma_tile::named_sync(1 + f.wg, 128);
  const int k = threadIdx.x & 127, c = WG_COLS * f.wg + k;
  if (k < WG_COLS && c < width) {
    const float* st = stage + 4 * f.wg * WG_COLS + k;
    part[c] += ((st[0] + st[WG_COLS]) + st[2 * WG_COLS]) + st[3 * WG_COLS];
  }
  mma_tile::named_sync(1 + f.wg, 128);
}

// element (row r, column k) of an activation buffer: panel k / 64, the
// row's 16-byte piece (k % 64) / 8 at position piece ^ (r % 8)
__device__ __forceinline__ int act_at(int r, int k) {
  return (k >> 6) * A_PANEL + r * 64 + ((((k & 63) >> 3) ^ (r & 7)) << 3) + (k & 7);
}
// the bf16 pair (v0, v1) at row r, columns col and col + 1 (col even)
__device__ __forceinline__ void put_act(__nv_bfloat16* A, int r, int col, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(A + act_at(r, col)) = mma_tile::pack_bf16x2(v0, v1);
}
// the generic-proxy stores into an activation buffer made visible to the
// wgmma that reads it (before the block's barrier)
__device__ __forceinline__ void act_fence() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// column j < 39 of a row's tangent embedding edot = J_PE(x) Cg_mlp, from the
// stashed sin / cos columns e of the embedding and Cg_mlp (cgm), unrounded
__device__ __forceinline__ float edot_at(const float* cgm, const float* e, int j) {
  if (j < 3) return cgm[j];
  const int k = (j - 3) / 6, rr = (j - 3) % 6, c = rr % 3;
  const float fk = (float)(1 << k), xd = cgm[c];
  return rr < 3 ? fk * e[j + 3] * xd : -fk * e[j - 3] * xd;
}

// the output layer's transposed product (depth NO: 3 or 6) on the CUDA cores,
// over each row's rounded deltas dr (rowf, RF apart) and W^T (NO rows of
// 256), then the last hidden layer's relu mask from its stashed
// post-activation (the layer's input, emitted as in_row): v[j][e] = u or 0
template <int NO>
__device__ __forceinline__ void out_layer(float (&v)[NJ][4], const float* dr, const __nv_bfloat16* WT,
                                          const __nv_bfloat16* post, const Ws& ws, int in_row, const Frag& f) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f.row(2 * h), col = f.col(j, 0);
      float w[NO][2];
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        const float2 wp = mma_tile::unpack_bf16x2(*reinterpret_cast<const uint32_t*>(WT + o * 256 + col));
        w[o][0] = wp.x;
        w[o][1] = wp.y;
      }
      const float2 p = r < ws.valid ? ld_pair(post + (long)r * W_CD + col) : make_float2(0.f, 0.f);
      const float pv[2] = {p.x, p.y};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float* d = dr + r * RF;
        float u = d[0] * w[0][k];
#pragma unroll
        for (int o = 1; o < NO; ++o) u = fmaf(d[o], w[o][k], u);
        v[j][2 * h + k] = pv[k] > 0.f ? u : 0.f;
      }
      ws.pair(in_row, col, 256, r, p.x, p.y);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    field_bwd_mma(const float* __restrict__ x, const float* __restrict__ d, const __nv_bfloat16* __restrict__ scd,
                  const float* __restrict__ sf32, const float* __restrict__ rgb, const float* __restrict__ grads,
                  const float* __restrict__ c_sdf, const float* __restrict__ c_g, const float* __restrict__ c_rgb,
                  const float* __restrict__ c_att, const __nv_bfloat16* __restrict__ W,
                  float* __restrict__ dx_out, float* __restrict__ dd_out, float* __restrict__ partials,
                  float* __restrict__ scratch, __nv_bfloat16* __restrict__ ws_base, int np, int n,
                  float radius, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const Tables& rows = c_rows;
  __nv_bfloat16* slots = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024u - (mma_tile::smem_u32(smem_raw) & 1023u)) & 1023u));
  __nv_bfloat16* Vr = slots + N_SLOTS * PANEL_ELEMS;  // the primal chain's A (1024-byte aligned)
  __nv_bfloat16* VDr = Vr + A_ELEMS;                  // the tangent chain's A
  float* rowf = reinterpret_cast<float*>(VDr + A_ELEMS);  // TILE x RF
  float* stage = rowf + TILE * RF;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + STAGE);
  uint64_t* empty = full + N_SLOTS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Frag f{warp >> 2, warp & 3, lane >> 2, lane & 3};
  float* part = partials + (long)blockIdx.x * NB;
  float* zd_scr = scratch + (long)blockIdx.x * SCRATCH + tid;  // element q of layer l at [(l * ZD_THREAD + q) * THREADS]
  float* cf_scr = zd_scr + (long)8 * ZD_THREAD * THREADS;

  const int tiles = (n + TILE - 1) / TILE;
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  for (int i = tid; i < NB; i += THREADS) part[i] = 0.f;
  Ring ring{W, slots, full, empty, 0, mine * N_PANELS};
  if (tid == 0) ring.init(4 * N_WG);  // every warp reads every panel
  __syncthreads();
  const bool feeder = tid == 0;
  if (feeder) ring.prime();

  const float c_skip = rnd16(INV_SQRT2);  // the skip concat's bf16 constant
  const __nv_bfloat16* W8s = W + W8S_OFF;
  float acc[2][NJ][4];

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * TILE;
    const int valid = n - row0 < TILE ? (int)(n - row0) : TILE;
    const Ws ws{ws_base + row0, np / 64, valid};
    const __nv_bfloat16* S = scd + row0 * W_CD;  // the tile's stash rows
    const float* SF = sf32 + row0 * W_F32;
    // the stash pair (col, col + 1) of row r at column col0
    auto post_at = [&](int col0, int r, int col) { return ld_pair(S + (long)r * W_CD + col0 + col); };

    // ---- per row: inputs, the clamp multipliers, the output layers' deltas ----
    if (tid < TILE) {
      const int r = tid;
      const bool ok = r < valid;
      float* rf = rowf + r * RF;
      const long q = (row0 + r) * 3;
      float xv[3], dv[3], gv[3];
      for (int c = 0; c < 3; ++c) {
        xv[c] = ok ? x[q + c] : 1.f;
        dv[c] = ok ? d[q + c] : 0.f;
        gv[c] = ok ? grads[q + c] : 0.f;
        rf[R_X + c] = xv[c];
        rf[R_D + c] = dv[c];
        rf[R_CG + c] = ok ? c_g[q + c] : 0.f;
      }
      const float nx = sqrtf(xv[0] * xv[0] + xv[1] * xv[1] + xv[2] * xv[2]);
      const float sph = scale * (radius - nx);
      const float raw = ok ? SF[(long)r * W_F32 + 39] : 0.f;
      rf[R_MRAW] = raw < sph ? 1.f : (raw == sph ? 0.5f : 0.f);
      rf[R_MSPH] = sph < raw ? 1.f : (raw == sph ? 0.5f : 0.f);
      rf[R_NX] = nx;
      rf[R_CSDF] = ok ? c_sdf[row0 + r] : 0.f;
      for (int o = 0; o < 3; ++o) {
        const float rg = ok ? rgb[q + o] : 0.f;
        const float v = (ok ? c_rgb[q + o] : 0.f) * rg * (1.f - rg);
        rf[R_D13PRE + o] = v;
        rf[R_D13 + o] = rnd16(v);
        ws.put(rows.cot[13] + o, r, rf[R_D13 + o]);
      }
      for (int o = 0; o < 6; ++o) {
        const float v = ok ? c_att[(row0 + r) * 6 + o] : 0.f;
        rf[R_D18PRE + o] = v;
        rf[R_D18 + o] = rnd16(v);
        ws.put(rows.cot[18] + o, r, rf[R_D18 + o]);
      }
      // the heads' leading inputs [x, PE4(d), grads] and [x, d, grads]
      for (int j = 0; j < N_LEAD_R; ++j) {
        const float v = j < 3 ? xv[j] : (j < 30 ? pe_val(dv, j - 3) : gv[j - 30]);
        ws.put(rows.in[9] + j, r, rnd16(v));
      }
      for (int j = 0; j < N_LEAD_A; ++j) ws.put(rows.in[14] + j, r, rnd16(j < 3 ? xv[j] : (j < 6 ? dv[j - 3] : gv[j - 6])));
    }
    act_fence();
    __syncthreads();
    if (tid < 9) {  // db_13, db_18: the rows in order
      const int o = tid < 3 ? tid : tid - 3, slot = tid < 3 ? R_D13PRE : R_D18PRE;
      float s = 0.f;
      for (int r = 0; r < TILE; ++r) s += rowf[r * RF + slot + o];
      part[rows.boff[tid < 3 ? 13 : 18] + o] += s;
    }

    // ---- the two heads' backward ----
#pragma unroll 1
    for (int head = 0; head < 2; ++head) {
      const int l0 = head == 0 ? 9 : 14, s0 = head == 0 ? S_RENDER : S_ATTR;
      // the output layer's transposed product (depth 3 or 6) on the CUDA cores,
      // then hidden layer l0 + 3's delta under its relu mask
      {
        float v[NJ][4];
        if (head == 0) out_layer<3>(v, rowf + R_D13, W + W13T_OFF, S + s0 + 768, ws, rows.in[13], f);
        else out_layer<6>(v, rowf + R_D18, W + W18T_OFF, S + s0 + 768, ws, rows.in[18], f);
        col_sums(v, stage, part + rows.boff[l0 + 3], 256, f);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = f.col(j, 0);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = f.row(2 * h);
            const float a = rnd16(v[j][2 * h]), b = rnd16(v[j][2 * h + 1]);
            put_act(Vr, r, col, a, b);
            ws.pair(rows.cot[l0 + 3], col, 256, r, a, b);
          }
        }
      }
      act_fence();
      __syncthreads();
      // hidden layers l0 + 3 .. l0 + 1: delta_{L-1} = (delta_L W_L^T) (post_{L-1} > 0)
#pragma unroll 1
      for (int L = l0 + 3; L > l0; --L) {
        const int pc = s0 + 256 * (L - 1 - l0);  // post_{L-1}'s stash column
        products<4, 4, 1>(acc, Vr, nullptr, ring, feeder, f.wg);
        act_fence();
        __syncthreads();  // both warpgroups have read Vr
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = f.row(2 * h), col = f.col(j, 0);
            const float2 p = r < valid ? post_at(pc, r, col) : make_float2(0.f, 0.f);
            ws.pair(rows.in[L], col, 256, r, p.x, p.y);
            acc[0][j][2 * h] = p.x > 0.f ? acc[0][j][2 * h] : 0.f;
            acc[0][j][2 * h + 1] = p.y > 0.f ? acc[0][j][2 * h + 1] : 0.f;
          }
        }
        col_sums(acc[0], stage, part + rows.boff[L - 1], 256, f);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = f.col(j, 0);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = f.row(2 * h);
            const float a = rnd16(acc[0][j][2 * h]), b = rnd16(acc[0][j][2 * h + 1]);
            put_act(Vr, r, col, a, b);
            ws.pair(rows.cot[L - 1], col, 256, r, a, b);
          }
        }
        act_fence();
        __syncthreads();
      }
      // the first layer: its leading rows' cotangents (per row), then its
      // feature rows' (the rendering head's kept, the attraction head's added:
      // C_f, the seed of the sweep)
      const int n_lead = head == 0 ? N_LEAD_R : N_LEAD_A;
      products<4, 4, 1>(acc, Vr, nullptr, ring, feeder, f.wg);
      if (f.wg == 0) {
#pragma unroll
        for (int j = 0; j < 5; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = f.col(j, e);
            if (col < n_lead) rowf[f.row(e) * RF + (head == 0 ? R_LEADR : R_LEADA) + col] = acc[0][j][e];
          }
      }
      products<4, 4, 1>(acc, Vr, nullptr, ring, feeder, f.wg);
      act_fence();
      __syncthreads();  // Vr is read; the leading cotangents are in
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = f.row(2 * hh), col = f.col(j, 0);
          const float2 z = r < valid ? *reinterpret_cast<const float2*>(SF + (long)r * W_F32 + 40 + col)
                                     : make_float2(0.f, 0.f);  // the feature input
          ws.pair(rows.in[l0] + n_lead, col, 256, r, rnd16(z.x), rnd16(z.y));
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int e = 2 * hh + k;
            float* cf = cf_scr + (long)(4 * j + e) * THREADS;
            if (head == 0) *cf = acc[0][j][e];
            else acc[0][j][e] = *cf + acc[0][j][e];
          }
        }
      }
      if (head == 1) {  // the sweep's seed: v = [c_sdf m_raw, C_f], rounded, into Vr
        col_sums(acc[0], stage, part + rows.boff[8] + 1, 256, f);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = f.col(j, 0);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = f.row(2 * h);
            const float a = rnd16(acc[0][j][2 * h]), b = rnd16(acc[0][j][2 * h + 1]);
            put_act(Vr, r, col, a, b);
            ws.pair(rows.cot[8] + 1, col, 256, r, a, b);
          }
        }
      }
      act_fence();
      __syncthreads();
    }

    // ---- per row: C_g, dd, the head terms of dx, the sdf seed, the tangent embedding ----
    if (tid < TILE) {
      const int r = tid;
      float* rf = rowf + r * RF;
      const float* cr = rf + R_LEADR;  // [x 3, PE4(d) 27, grads 3]
      const float* ca = rf + R_LEADA;  // [x 3, d 3, grads 3]
      float ed[27], pd[3];
      for (int j = 0; j < 27; ++j) ed[j] = pe_val(rf + R_D, j);
      pe_transpose(cr + 3, ed, 4, pd);
      const float m_raw = rf[R_MRAW];
      for (int c = 0; c < 3; ++c) {
        if (r < valid) dd_out[(row0 + r) * 3 + c] = ca[3 + c] + pd[c];
        const float cg = rf[R_CG + c] + cr[30 + c] + ca[6 + c];
        rf[R_CG + c] = cg;
        rf[R_CGM + c] = cg * m_raw;
        rf[R_DXA + c] = cr[c] + ca[c];
      }
      const float v0 = rf[R_CSDF] * m_raw;
      rf[R_V0PRE] = v0;
      rf[R_V0] = rnd16(v0);
      ws.put(rows.cot[8], r, rf[R_V0]);
      // edot = J_PE(x) Cg_mlp from the stashed sin / cos columns, rounded:
      // the tangent forward's first A
      const float* e = SF + (long)r * W_F32;
      for (int j = 0; j < 48; ++j) {
        const float v = j < 39 && (j < 3 || r < valid) ? rnd16(edot_at(rf + R_CGM, e, j)) : 0.f;
        VDr[act_at(r, j)] = __float2bfloat16_rn(v);
        if (j < 39) {
          ws.put(rows.tin[0] + j, r, v);
          // layer 0's primal input, and the embedding's part of layer 4's
          const float ec = r < valid ? rnd16(e[j]) : 0.f;
          ws.put(rows.in[0] + j, r, ec);
        }
      }
    }
    act_fence();
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int r = 0; r < TILE; ++r) s += rowf[r * RF + R_V0PRE];
      part[rows.boff[8]] += s;
    }

    // ---- the tangent forward over the stashed activations ----
#pragma unroll 1
    for (int l = 0; l < 8; ++l) {
      if (l == 0) products<1, 3, 1>(acc, VDr, nullptr, ring, feeder, f.wg);
      else products<4, 4, 1>(acc, VDr, nullptr, ring, feeder, f.wg);
      act_fence();
      __syncthreads();  // both warpgroups have read VDr
      const int n_out = l == 3 ? N_SKIP : 256;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = f.row(2 * hh), col = f.col(j, 0);
          float z[2] = {acc[0][j][2 * hh], acc[0][j][2 * hh + 1]};
          zd_scr[(long)(l * ZD_THREAD + 4 * j + 2 * hh) * THREADS] = z[0];
          zd_scr[(long)(l * ZD_THREAD + 4 * j + 2 * hh + 1) * THREADS] = z[1];
          float2 p = make_float2(0.f, 0.f);
          if (r < valid && col < n_out) p = post_at(soff(l), r, col);
          const float pv[2] = {p.x, p.y};
          float hv[2], iv[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float s = r < valid ? 1.f - sigma_arg(pv[k]) : 0.f;
            hv[k] = rnd16(s * z[k]);
            // layer l + 1's primal input h_l and tangent input; layer 4's are
            // the skip concats [h_3, e] and [hdot_4, edot] * rnd(1/sqrt 2),
            // rounded (their e parts written per row)
            iv[k] = l == 3 ? rnd16(pv[k] * c_skip) : pv[k];
            if (l == 3) hv[k] = rnd16(hv[k] * c_skip);
          }
          ws.pair(rows.in[l + 1], col, 256, r, iv[0], iv[1]);  // layer 4's columns 217.. rewritten per row
          if (l == 7) {  // layer 8's tangent input: its column sums are dW_8's column 0
            acc[0][j][2 * hh] = r < valid ? hv[0] : 0.f;
            acc[0][j][2 * hh + 1] = r < valid ? hv[1] : 0.f;
            continue;
          }
          ws.pair(rows.tin[l + 1], col, 256, r, hv[0], hv[1]);
          put_act(VDr, r, col, hv[0], hv[1]);
        }
      }
      if (l == 7) col_sums(acc[0], stage, part + COL8, 256, f);
      if (l == 3) {  // layer 4's inputs, the embedding parts: rnd(rnd(e or edot) rnd(1/sqrt 2))
        __syncthreads();  // over the fragments' writes of these columns
        if (tid < TILE) {
          const int r = tid;
          const float* e = SF + (long)r * W_F32;
          for (int j = 0; j < 39; ++j) {
            const float v = j < 3 || r < valid ? rnd16(rnd16(edot_at(rowf + r * RF + R_CGM, e, j)) * c_skip) : 0.f;
            VDr[act_at(r, N_SKIP + j)] = __float2bfloat16_rn(v);
            ws.put(rows.tin[4] + N_SKIP + j, r, v);
            ws.put(rows.in[4] + N_SKIP + j, r, r < valid ? rnd16(rnd16(e[j]) * c_skip) : 0.f);
          }
        }
      }
      act_fence();
      __syncthreads();
    }

    // ---- the combined primal + tangent reverse sweep ----
    // layer 8: u = v W_8^T (the features' panels, then the sdf column), and
    // the tangent chain's u is W_8's sdf column (its seed is one-hot)
    products<4, 4, 1>(acc, Vr, nullptr, ring, feeder, f.wg);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = f.row(e), col = f.col(j, e);
        const float w8 = __bfloat162float(W8s[col]);
        acc[0][j][e] = fmaf(rowf[r * RF + R_V0], w8, acc[0][j][e]);
        acc[1][j][e] = r < valid ? w8 : 0.f;
      }
    act_fence();
    __syncthreads();  // both warpgroups have read Vr
#pragma unroll 1
    for (int L = 8; L >= 1; --L) {
      if (L < 8) {
        products<4, 4, 2>(acc, Vr, VDr, ring, feeder, f.wg);
        act_fence();
        __syncthreads();  // both warpgroups have read Vr and VDr
      }
      // the cotangents of layer L-1's pre-activation over its stashed
      // post-activation h: v = u' s + u'_dot s'' zdot, vdot = u'_dot s, with
      // s = sigma'(h), s'' = 100 s (1 - s); layer 4's input is the skip
      // concat: u' = u / sqrt 2, its columns >= 217 the embedding's share
      const bool skip = L == 4;
      const int n_out = L - 1 == 3 ? N_SKIP : 256;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = f.row(2 * hh), col = f.col(j, 0);
          float2 p = make_float2(0.f, 0.f);
          if (r < valid && col < n_out) p = post_at(soff(L - 1), r, col);
          const float pv[2] = {p.x, p.y};
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int e = 2 * hh + k, c = col + k;
            float u = acc[0][j][e], ud = acc[1][j][e];
            if (skip) {
              if (c >= N_SKIP) {
                rowf[r * RF + R_CE + c - N_SKIP] = u * INV_SQRT2;
                rowf[r * RF + R_CED + c - N_SKIP] = ud * INV_SQRT2;
              }
              u = u * INV_SQRT2;
              ud = ud * INV_SQRT2;
            }
            float v = 0.f, vd = 0.f;
            if (r < valid && c < n_out) {
              const float em = sigma_arg(pv[k]);
              const float s = 1.f - em;
              const float spp = 100.f * s * em;
              const float zd = zd_scr[(long)((L - 1) * ZD_THREAD + 4 * j + e) * THREADS];
              v = u * s + ud * spp * zd;
              vd = ud * s;
            }
            acc[0][j][e] = v;
            acc[1][j][e] = vd;
          }
        }
      }
      col_sums(acc[0], stage, part + rows.boff[L - 1], n_out, f);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = f.col(j, 0);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = f.row(2 * hh);
          const float a = rnd16(acc[0][j][2 * hh]), b = rnd16(acc[0][j][2 * hh + 1]);
          const float ad = rnd16(acc[1][j][2 * hh]), bd = rnd16(acc[1][j][2 * hh + 1]);
          put_act(Vr, r, col, a, b);
          put_act(VDr, r, col, ad, bd);
          ws.pair(rows.cot[L - 1], col, n_out, r, a, b);
          ws.pair(rows.tcot[L - 1], col, n_out, r, ad, bd);
        }
      }
      act_fence();
      __syncthreads();
    }
    // layer 0: the embedding's cotangents
    products<4, 4, 2>(acc, Vr, VDr, ring, feeder, f.wg);
    if (f.wg == 0) {
#pragma unroll
      for (int j = 0; j < 5; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = f.row(e), col = f.col(j, e);
          if (col < 39) {
            float* rf = rowf + r * RF;
            rf[R_CE + col] += acc[0][j][e];
            rf[R_CED + col] += acc[1][j][e];
          }
        }
    }
    act_fence();
    __syncthreads();

    // ---- per row: dx, the PE transposes and the sphere branch ----
    if (tid < valid) {
      const int r = tid;
      const float* rf = rowf + r * RF;
      const float* e = SF + (long)r * W_F32;
      float ev[39];
      for (int j = 0; j < 39; ++j) ev[j] = e[j];
      float p[3];
      pe_transpose(rf + R_CE, ev, 6, p);
      float q[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < 6; ++k) {
        const float fk = (float)(1 << k);
        for (int c = 0; c < 3; ++c) {
          const float cs = rf[R_CED + 3 + 6 * k + c], cc = rf[R_CED + 6 + 6 * k + c];
          q[c] = q[c] + fk * fk * (-cs * ev[3 + 6 * k + c] - cc * ev[6 + 6 * k + c]) * rf[R_CGM + c];
        }
      }
      const float m_sph = rf[R_MSPH], nx = rf[R_NX], csdf = rf[R_CSDF];
      const float* xt = rf + R_X;
      const float* cg = rf + R_CG;
      const float xdotc = xt[0] * cg[0] + xt[1] * cg[1] + xt[2] * cg[2];
      for (int c = 0; c < 3; ++c) {
        float v = rf[R_DXA + c] + p[c];
        v = v + q[c];
        v = v + csdf * m_sph * (-scale) * xt[c] / nx;
        v = v + m_sph * (-scale) * (cg[c] / nx - xt[c] * xdotc / (nx * nx * nx));
        dx_out[(row0 + r) * 3 + c] = v;
      }
    }
    act_fence();
    __syncthreads();
  }
}

// dparams[the bias and col-8 entries] = the sum of the blocks' partials, in
// block order; the caller zeroed the other entries
__global__ void bias_reduce(const float* __restrict__ partials, float* __restrict__ dparams, int n_blocks) {
  const Tables& tb = c_rows;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NB) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partials[(long)b * NB + i];
  if (i >= COL8) {
    dparams[tb.g8 + (long)(i - COL8) * tb.out8] = s;
    return;
  }
  int l = 0;
  while (tb.boff[l + 1] <= i) ++l;
  dparams[tb.gbias[l] + (i - tb.boff[l])] = s;
}

}  // namespace

// blocks, bias partial floats a block, scratch floats a block for n points
extern "C" void field_bwd_mma_layout(int n, int max_blocks, int* n_blocks, long long* n_bias,
                                     long long* scratch) {
  const int tiles = (n + TILE - 1) / TILE;
  *n_blocks = tiles < 1 ? 1 : (tiles < max_blocks ? tiles : max_blocks);
  *n_bias = NB;
  *scratch = SCRATCH;
}

// the row-local pass: dx, dd; the bias gradients and layer 8's tangent column
// into dparams (its other entries zeroed by the caller); every weight-gradient
// operand into the workspace ws (ws_np points a row, a multiple of 64; the
// rows and offsets of ``table``, bwd_mma_table's); w is
// pack_field_bwd_weights' buffer
extern "C" int field_bwd_mma_rowlocal(const void* x, const void* d, const void* scd, const void* sf32,
                                      const void* rgb, const void* grads, const void* c_sdf, const void* c_g,
                                      const void* c_rgb, const void* c_att, const void* w, void* dx, void* dd,
                                      void* dparams, void* partials, void* scratch, void* ws,
                                      const int* table, int n, int max_blocks, int ws_np, float radius,
                                      float scale, void* stream) {
  if (ws_np % 64 != 0) return (int)cudaErrorInvalidValue;  // the workspace rows are counted in 64-point chunks
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(field_bwd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  static_assert(sizeof(Tables) == 95 * sizeof(int), "the launch's int table");
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyToSymbolAsync(c_rows, table, sizeof(Tables), 0, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  int n_blocks;
  long long nb, sc;
  field_bwd_mma_layout(n, max_blocks, &n_blocks, &nb, &sc);
  field_bwd_mma<<<n_blocks, THREADS, SMEM, s>>>(
      (const float*)x, (const float*)d, (const __nv_bfloat16*)scd, (const float*)sf32, (const float*)rgb,
      (const float*)grads, (const float*)c_sdf, (const float*)c_g, (const float*)c_rgb, (const float*)c_att,
      (const __nv_bfloat16*)w, (float*)dx, (float*)dd, (float*)partials, (float*)scratch, (__nv_bfloat16*)ws,
      ws_np, n, radius, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bias_reduce<<<(NB + 255) / 256, 256, 0, s>>>((const float*)partials, (float*)dparams, n_blocks);
  return (int)cudaGetLastError();
}
