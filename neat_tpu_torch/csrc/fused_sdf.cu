// K1: the sampler's fused SDF MLP (replaces neat_tpu/ops/fused_sdf.py:_kernel).
//
// emb (N, 39) in CD -> sdf_raw (N,) f32 through the canonical 9-layer
// softplus-100 MLP with the skip concat at layer 4; the final layer is
// sliced to the sdf channel.
//
// What bounds it: operations (0.918 MFLOP a point against 82 bytes), and
// after the products moved to the tensor cores the softplus epilogue, 2,009
// evaluations a point on the CUDA cores and the special-function unit, is a
// cost of the same order as the products.
//
// Two kernels:
//  * fused_sdf_mma (bf16): 128 points a block, 8 warps of 16 rows each, two
//    warpgroups (mma_tile.cuh). Persistent: one block per SM walks the tiles.
//    Products are wgmma m64n256k16: A from registers (each warp's ldmatrix
//    of its own strip), B from shared memory, read once per warpgroup.
//    Weights come from a packed buffer that is the shared-memory image of 29
//    swizzled panels of 256 x 64 (odd widths zero-padded: K 39 -> 64, N 217
//    -> 256), one for layer 0 and four for each hidden layer. A ring of four
//    32 KB slots holds the panels in flight: one thread asks for a panel with
//    a bulk copy (cp.async.bulk) that reports to the slot's mbarrier, the
//    warps wait on that, and the eighth warp to hand a slot back frees it
//    for the panel four further on. No block-wide barrier after the set-up.
//    The two warpgroups take turns at the tensor cores, layer by layer
//    (named barriers): while one multiplies, the other runs its epilogue.
//    Activations live in one 128 x 256 bf16 buffer that each warp overwrites
//    in place, strip by strip; bias, softplus and the rounding to bf16
//    happen on the accumulator registers. The last layer (256 -> 1) is a dot
//    product in layer 7's epilogue, reduced over the four lanes that share a
//    row. WGMMA = false runs the same kernel with mma.sync products and no
//    turns, as a yardstick.
//  * fused_sdf_kernel (f32, and bf16 under the name ..._bf16_scalar as the
//    yardstick of the old design): scalar FMAs, 32 points a block.
#include "common.cuh"
#include "mma_tile.cuh"

// ---------------------------------------------------------------------------
// scalar kernel: one block per 32-point tile, one thread per output column
// ---------------------------------------------------------------------------
template <typename CD>
__global__ void __launch_bounds__(NT) fused_sdf_kernel(const CD* __restrict__ emb,
                                                       const CD* __restrict__ W,
                                                       const float* __restrict__ B,
                                                       float* __restrict__ out, int n) {
  extern __shared__ float4 smem4[];
  float* E = reinterpret_cast<float*>(smem4);  // TT x LDE
  float* H0 = E + TT * LDE;                    // TT x LDH
  float* H1 = H0 + TT * LDH;                   // TT x LDH
  const long row0 = (long)blockIdx.x * TT;
  const int valid = min(TT, (int)(n - row0));

  for (int i = threadIdx.x; i < TT * LDE; i += NT) {
    const int t = i / LDE, j = i % LDE;
    E[i] = (t < valid && j < 39) ? to_f(emb[(row0 + t) * 39 + j]) : 0.f;
  }
  __syncthreads();

  implicit_hidden<0, CD>(E, LDE, H0, W, B, nullptr, row0, valid);
  implicit_hidden<1, CD>(H0, LDH, H1, W, B, nullptr, row0, valid);
  implicit_hidden<2, CD>(H1, LDH, H0, W, B, nullptr, row0, valid);
  implicit_hidden<3, CD>(H0, LDH, H1, W, B, nullptr, row0, valid);
  skip_concat<CD>(H1, E, H0);
  implicit_hidden<4, CD>(H0, LDH, H1, W, B, nullptr, row0, valid);
  implicit_hidden<5, CD>(H1, LDH, H0, W, B, nullptr, row0, valid);
  implicit_hidden<6, CD>(H0, LDH, H1, W, B, nullptr, row0, valid);
  implicit_hidden<7, CD>(H1, LDH, H0, W, B, nullptr, row0, valid);
  // final layer, sdf channel only: W_8 is (256, 1) here
  tile_mm<CD>(H0, LDH, W + Lyr<8>::w, 1, 256, 1, [&](int t, int, float v) {
    if (t < valid) out[row0 + t] = v + B[Lyr<8>::b];
  });
}

template <typename CD>
static int launch(const void* emb, const void* w, const void* b, void* out, int n, void* stream) {
  const size_t smem = sizeof(float) * (TT * LDE + 2 * TT * LDH);
  cudaError_t err = cudaFuncSetAttribute(fused_sdf_kernel<CD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + TT - 1) / TT;
  fused_sdf_kernel<CD><<<blocks, NT, smem, (cudaStream_t)stream>>>(
      (const CD*)emb, (const CD*)w, (const float*)b, (float*)out, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor-core kernel (bf16)
// ---------------------------------------------------------------------------
// The packed operands; ops/fused_sdf.py:pack_sdf_weights writes them and
// exports the same numbers.
constexpr int TILE_POINTS = 128;  // points a block works on at a time
constexpr int MMA_THREADS = 256;  // 8 warps x 16 rows: two warpgroups
constexpr int K0_STEPS = 3;       // layer 0's K = 39: three k16 steps of its zero-padded panel
constexpr int N_SKIP = 217;       // h3's columns in the skip concat
constexpr int N_PANELS = 29;      // layer 0: one; layers 1..7: four each
constexpr int LDA = 256 + mma_tile::PAD;   // 264: row stride of the activations
constexpr int LDEM = 48 + mma_tile::PAD;   // 56: row stride of the embedding tile
constexpr int W8_OFF = 475136;    // the last layer's sdf column, 256 bf16
constexpr int W_TOTAL = 475392;   // elements of the packed weights
constexpr int B8_OFF = 2048;      // biases: layer l < 8 at 256 * l (zero-padded), then b8
constexpr int B_TOTAL = 2049;
static_assert(mma_tile::PANEL_K == 64 && mma_tile::PANEL_ROWS == 256, "panel shape");
static_assert(N_PANELS * mma_tile::PANEL_ELEMS == W8_OFF && W8_OFF + 256 == W_TOTAL,
              "packed weight layout");

constexpr int N_SLOTS = 4;  // weight panels in shared memory at a time
// bytes: the panel slots, the activations, the embedding tile, the slots'
// barriers, and room to start the slots on 1024 bytes
constexpr int SMEM_MMA = 2 * (N_SLOTS * mma_tile::PANEL_ELEMS + TILE_POINTS * LDA + TILE_POINTS * LDEM) +
                         2 * N_SLOTS * 8 + 1024;

// softplus(100 z) / 100 = max(z, 0) + log1p(exp(-100 |z|)) / 100. EXACT: the
// scalar kernel's expf / log1pf / division. Otherwise seven operations, two
// of them on the special-function unit (ex2.approx, lg2.approx); below
// z = -0.166 it gives 0 where the true value is under 6e-10.
template <bool EXACT> __device__ __forceinline__ float softplus100_mma(float z) {
  if (EXACT) return softplus100(z);
  float e, l;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fabsf(z) * -144.26950408889634f));
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(1.f + e));
  return fmaf(l, 0.0069314718055994531f, fmaxf(z, 0.f));
}

// the ring of N_SLOTS weight panels (mma_tile::PanelRing): the tile's
// N_PANELS panels, one after another in W
struct SdfPanels {
  static constexpr int COUNT = N_PANELS;
  __device__ static long at(int p) { return (long)p * mma_tile::PANEL_ELEMS; }
};
using PanelRing = mma_tile::PanelRing<N_SLOTS, SdfPanels>;

// one layer on the warp's strip: acc = A[16 x 16*KS*NP] W_l^T from the next NP
// panels of the ring, KS k16 steps of each. By wgmma, two panels to a group,
// handed back when the group has finished; or by mma.sync, panel by panel.
template <bool WGMMA, int NP, int KS, int LD>
__device__ __forceinline__ void layer_products(float (&acc)[32][4], const __nv_bfloat16* A,
                                               PanelRing& ring, bool feeder) {
  constexpr int G = !WGMMA || NP < 2 ? 1 : 2;
  if (!WGMMA) mma_tile::zero_acc(acc);
#pragma unroll
  for (int j0 = 0; j0 < NP; j0 += G) {
    const __nv_bfloat16* w[G];
#pragma unroll
    for (int jj = 0; jj < G; ++jj) w[jj] = ring.wait(j0 + jj);
    const __nv_bfloat16* a = A + j0 * mma_tile::PANEL_K;
    if constexpr (WGMMA) {
      mma_tile::warpgroup_mma<G, KS, LD>(acc, a, w, j0 > 0);
    } else {
      mma_tile::warp_mma<KS, 16, LD>(acc, a, w[0]);
    }
#pragma unroll
    for (int jj = 0; jj < G; ++jj) ring.release(j0 + jj);
    if (feeder) {
#pragma unroll
      for (int jj = 0; jj < G; ++jj) ring.refill(j0 + jj);
    }
  }
  ring.seq += NP;
}

// A[g or g+8][8j + 2t ..] <- rnd(softplus100(acc + b)) for all 256 columns
template <bool EXACT>
__device__ __forceinline__ void store_hidden(const float (&acc)[32][4], const float* __restrict__ b,
                                             __nv_bfloat16* A) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b + col));
    uint32_t* p = reinterpret_cast<uint32_t*>(A + g * LDA + col);
    p[0] = mma_tile::pack_bf16x2(softplus100_mma<EXACT>(acc[j][0] + bb.x),
                                 softplus100_mma<EXACT>(acc[j][1] + bb.y));
    p[4 * LDA] = mma_tile::pack_bf16x2(softplus100_mma<EXACT>(acc[j][2] + bb.x),
                                       softplus100_mma<EXACT>(acc[j][3] + bb.y));
  }
}

// layer 3 into the skip concat: A[..][col] <- rnd(c * rnd(softplus100(acc + b)))
// for col < N_SKIP; the embedding's columns follow (the caller writes them)
template <bool EXACT>
__device__ __forceinline__ void store_skip(const float (&acc)[32][4], const float* __restrict__ b,
                                           __nv_bfloat16* A, float c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < (N_SKIP + 7) / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b + col));
    const float2 lo = mma_tile::unpack_bf16x2(mma_tile::pack_bf16x2(
        softplus100_mma<EXACT>(acc[j][0] + bb.x), softplus100_mma<EXACT>(acc[j][1] + bb.y)));
    const float2 hi = mma_tile::unpack_bf16x2(mma_tile::pack_bf16x2(
        softplus100_mma<EXACT>(acc[j][2] + bb.x), softplus100_mma<EXACT>(acc[j][3] + bb.y)));
    __nv_bfloat16* p = A + g * LDA + col;
    if (col + 1 < N_SKIP) {
      *reinterpret_cast<uint32_t*>(p) = mma_tile::pack_bf16x2(lo.x * c, lo.y * c);
      *reinterpret_cast<uint32_t*>(p + 8 * LDA) = mma_tile::pack_bf16x2(hi.x * c, hi.y * c);
    } else if (col < N_SKIP) {
      p[0] = __float2bfloat16_rn(lo.x * c);
      p[8 * LDA] = __float2bfloat16_rn(hi.x * c);
    }
  }
}

// WGMMA: the products by wgmma (else mma.sync); EXACT: the scalar kernel's softplus
template <bool WGMMA, bool EXACT>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    fused_sdf_mma(const __nv_bfloat16* __restrict__ emb, const __nv_bfloat16* __restrict__ W,
                  const float* __restrict__ B, float* __restrict__ out, int n) {
  extern __shared__ unsigned char smem_raw[];
  // the panel slots first, on 1024 bytes (a swizzled panel's alignment)
  __nv_bfloat16* slots = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024u - (mma_tile::smem_u32(smem_raw) & 1023u)) & 1023u));
  __nv_bfloat16* act = slots + N_SLOTS * mma_tile::PANEL_ELEMS;  // TILE_POINTS x LDA
  __nv_bfloat16* em = act + TILE_POINTS * LDA;                    // TILE_POINTS x LDEM
  uint64_t* full = reinterpret_cast<uint64_t*>(em + TILE_POINTS * LDEM);
  uint64_t* empty = full + N_SLOTS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  const int tiles = (n + TILE_POINTS - 1) / TILE_POINTS;
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  PanelRing ring{W, slots, full, empty, 0, mine * N_PANELS};
  if (threadIdx.x == 0) ring.init(8);  // one lane of each warp reads each panel
  __syncthreads();
  // warpgroup 1 reads every panel after warpgroup 0 (the turns below), so one
  // of its threads keeps the ring full: the first panels now, the rest as
  // slots free. (Without turns that thread may wait for warpgroup 0.)
  const bool feeder = threadIdx.x == 128;
  if (feeder) ring.prime();

  // the two warpgroups take turns at the tensor cores, layer by layer: while
  // one multiplies, the other runs its epilogue. Barrier 1 + wg is "wg's turn".
  const int wg = warp >> 2;
  int layers_left = mine * 8;
  auto take_turn = [&]() {
    if (WGMMA) mma_tile::named_sync(1 + wg, MMA_THREADS);
  };
  auto give_turn = [&]() {  // the other's, unless this was the kernel's last layer
    --layers_left;
    if (WGMMA && (wg == 0 || layers_left > 0)) mma_tile::named_arrive(2 - wg, MMA_THREADS);
  };
  if (WGMMA && wg == 1) mma_tile::named_arrive(1, MMA_THREADS);  // warpgroup 0 goes first

  __nv_bfloat16* A = act + warp * mma_tile::WARP_ROWS * LDA;  // this warp's strips
  __nv_bfloat16* E = em + warp * mma_tile::WARP_ROWS * LDEM;
  const float c = rnd<__nv_bfloat16>(INV_SQRT2);

  float acc[32][4];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * TILE_POINTS + warp * mma_tile::WARP_ROWS;
    // the strip's embedding rows, zero past column 39 and past row n
    for (int i = lane; i < mma_tile::WARP_ROWS * LDEM; i += 32) {
      const int r = i / LDEM, j = i % LDEM;
      E[i] = (row0 + r < n && j < 39) ? emb[(row0 + r) * 39 + j] : __float2bfloat16_rn(0.f);
    }
    __syncwarp();

    // layer 0: 39 (48) -> 256 from the embedding strip
    take_turn();
    layer_products<WGMMA, 1, K0_STEPS, LDEM>(acc, E, ring, feeder);
    give_turn();
    store_hidden<EXACT>(acc, B, A);
    __syncwarp();
#pragma unroll 1
    for (int l = 1; l <= 2; ++l) {
      take_turn();
      layer_products<WGMMA, 4, 4, LDA>(acc, A, ring, feeder);
      give_turn();
      __syncwarp();  // the strip is read: it may be overwritten
      store_hidden<EXACT>(acc, B + 256 * l, A);
      __syncwarp();
    }
    // layer 3 and the skip concat: [h3 (217), emb (39)] * rnd(1/sqrt 2), rounded
    take_turn();
    layer_products<WGMMA, 4, 4, LDA>(acc, A, ring, feeder);
    give_turn();
    __syncwarp();
    store_skip<EXACT>(acc, B + 256 * 3, A, c);
    for (int i = lane; i < mma_tile::WARP_ROWS * 39; i += 32) {
      const int r = i / 39, j = i % 39;
      A[r * LDA + N_SKIP + j] = __float2bfloat16_rn(__bfloat162float(E[r * LDEM + j]) * c);
    }
    __syncwarp();
#pragma unroll 1
    for (int l = 4; l <= 6; ++l) {
      take_turn();
      layer_products<WGMMA, 4, 4, LDA>(acc, A, ring, feeder);
      give_turn();
      __syncwarp();
      store_hidden<EXACT>(acc, B + 256 * l, A);
      __syncwarp();
    }
    // layer 7, and the last layer's sdf column as a dot product over its output
    take_turn();
    layer_products<WGMMA, 4, 4, LDA>(acc, A, ring, feeder);
    give_turn();
    float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(B + 256 * 7 + col));
      const float2 w8 = mma_tile::unpack_bf16x2(__ldg(reinterpret_cast<const uint32_t*>(W + W8_OFF + col)));
      const float2 lo = mma_tile::unpack_bf16x2(mma_tile::pack_bf16x2(
          softplus100_mma<EXACT>(acc[j][0] + bb.x), softplus100_mma<EXACT>(acc[j][1] + bb.y)));
      const float2 hi = mma_tile::unpack_bf16x2(mma_tile::pack_bf16x2(
          softplus100_mma<EXACT>(acc[j][2] + bb.x), softplus100_mma<EXACT>(acc[j][3] + bb.y)));
      s_lo = fmaf(lo.x, w8.x, s_lo);
      s_lo = fmaf(lo.y, w8.y, s_lo);
      s_hi = fmaf(hi.x, w8.x, s_hi);
      s_hi = fmaf(hi.y, w8.y, s_hi);
    }
    s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 1);
    s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 1);
    s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 2);
    s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 2);
    if (t == 0) {
      const float b8 = __ldg(B + B8_OFF);
      if (row0 + g < n) out[row0 + g] = s_lo + b8;
      if (row0 + g + 8 < n) out[row0 + g + 8] = s_hi + b8;
    }
  }
}

template <bool WGMMA, bool EXACT>
static int launch_mma(const void* emb, const void* w, const void* b, void* out, int n,
                      void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fused_sdf_mma<WGMMA, EXACT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MMA);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  const int tiles = (n + TILE_POINTS - 1) / TILE_POINTS;
  fused_sdf_mma<WGMMA, EXACT>
      <<<tiles < sms ? tiles : sms, MMA_THREADS, SMEM_MMA, (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)emb, (const __nv_bfloat16*)w, (const float*)b, (float*)out, n);
  return (int)cudaGetLastError();
}

// the bf16 kernel of the sampler: packed operands (pack_sdf_weights)
extern "C" int fused_sdf_fwd_bf16(const void* emb, const void* w, const void* b, void* out,
                                  int n, void* stream) {
  return launch_mma<true, false>(emb, w, b, out, n, stream);
}

// the same with the scalar kernel's softplus (expf, log1pf)
extern "C" int fused_sdf_fwd_bf16_exact(const void* emb, const void* w, const void* b, void* out,
                                        int n, void* stream) {
  return launch_mma<true, true>(emb, w, b, out, n, stream);
}

// the same with the products by mma.sync, one warp at a time
extern "C" int fused_sdf_fwd_bf16_mma_sync(const void* emb, const void* w, const void* b,
                                           void* out, int n, void* stream) {
  return launch_mma<false, false>(emb, w, b, out, n, stream);
}

// the scalar kernels: weights and biases of the nine layers, concatenated
extern "C" int fused_sdf_fwd_bf16_scalar(const void* emb, const void* w, const void* b, void* out,
                                         int n, void* stream) {
  return launch<__nv_bfloat16>(emb, w, b, out, n, stream);
}

extern "C" int fused_sdf_fwd_f32(const void* emb, const void* w, const void* b, void* out,
                                 int n, void* stream) {
  return launch<float>(emb, w, b, out, n, stream);
}
