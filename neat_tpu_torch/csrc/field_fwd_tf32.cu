// K3-fwd in f32 on the tensor cores, as 3xTF32 products (replaces
// neat_tpu/ops/fused_field.py:_fwd_kernel for the no-grad f32 evaluations
// of finalize and render eval; the bf16 forward is field_fwd_mma.cu). The
// math is field_math of ops/fused_field.py: the 9-layer implicit chain
// (softplus 100, the skip at layer 4), the sphere clamp with balanced tie
// multipliers, the spatial gradient by a sweep back through the eight
// implicit layers (dX = dY W^T times sigma' = 1 - exp(-100 h) of each
// post-activation h), the rendering head ([x, PE4(d), grads, feats] -> 4 x
// 256 relu -> 3, sigmoid) and the attraction head ([x, d, grads, feats] ->
// 4 x 256 relu -> 6).
//
// What bounds it: operations. 3.04 MFLOP a point of f32 products; as three
// TF32 products at 495 TFLOP/s 18.4 ns a point (3.70 ms at 200,704 points),
// against 45.4 on the CUDA cores' 67 TFLOP/s. Beside them the exact
// softplus and sigma' (an expf each), and the weights, split in two and read
// through L2 by every 128-point tile (12.5 MB a tile).
//
// The design is K1's (fused_sdf_tf32.cu) carried to the field, as
// field_fwd_mma.cu carries the bf16 K1: persistent blocks of two
// warpgroups, 128 points a tile, each warp owning 16 rows through every
// layer; 391 pairs of hi/lo panels a tile in the order it reads them (K1's
// 115, layer 8's features, the sweep's transposed panels from layer 7 down
// to 0, each head's leading rows, feature rows and hidden layers:
// ops/tf32.py:pack_field_weights_tf32), two in a ring of 32 KB slots from
// which both warpgroups multiply without taking turns, each pair summed by
// the tensor core from zero and added into an f32 running sum
// (tf32_tile.cuh). The output layers (8's sdf column, 13 and 18) are f32
// dot products a row in the epilogues.
//
// Shared memory: 2 x 32 KB of pairs, the 128 x 264 f32 activations, a
// per-warp union of the f32 embedding (layer 0's and the skip's input,
// later a head's leading inputs) and the embedding's cotangent (16 x 40
// f32), 16 floats a row (x, d, grads, the clamp's multipliers, |x|):
// 230,432 bytes with the barriers and the alignment. The eight implicit
// post-activations and layer 8's features do not fit: each warp writes them
// to a per-block scratch in device memory straight from its accumulator
// fragments, 16 bytes a lane in fragment order (coalesced), and reads back
// its own fragments where the sweep needs sigma' and the heads their
// features: no shared memory and no barrier on the way.
//
// Functions are the scalar kernel's: softplus100 (expf, log1pf), the exact
// expf of sigma', sinf and cosf; f32 rounding points (rnd is the identity in f32;
// the skip concat times 1/sqrt 2, its cotangent too).
#include "tf32_tile.cuh"

// The packed operands; ops/tf32.py:pack_field_weights_tf32 writes them and
// exports the same numbers.
constexpr int TILE_POINTS = 128;     // points a block works on at a time
constexpr int TF32_THREADS = 256;    // 8 warps x 16 rows: two warpgroups
constexpr int N_SDF_PAIRS = 115;     // K1's pairs, first in the buffer
constexpr int N_FIELD_PAIRS = 391;   // the pairs a tile reads, in order
constexpr int SDF_W_TOTAL = 942336;  // K1's buffer: its pairs and W_8's sdf column
constexpr int SDF_W8_OFF = 942080;   // W_8's sdf column, 256 f32
constexpr int W13_OFF = 3203328;     // W_13^T (3 x 256)
constexpr int W18_OFF = 3204096;     // W_18^T (6 x 256)
constexpr int FIELD_W_TOTAL = 3205632;
constexpr int B8_OFF = 2048;   // biases: layer l < 8 at 256 * l, b_8's sdf entry,
constexpr int B8F_OFF = 2304;  // b_8's features,
constexpr int B9_OFF = 2560;   // b_9 .. b_12 256 apart, b_13,
constexpr int B13_OFF = 3584;
constexpr int B14_OFF = 3840;  // b_14 .. b_17, b_18
constexpr int B18_OFF = 4864;
static_assert(SDF_W_TOTAL == N_SDF_PAIRS * tf32_tile::PAIR_ELEMS + 256 && SDF_W8_OFF == SDF_W_TOTAL - 256,
              "K1's buffer leads");
static_assert(W13_OFF == SDF_W_TOTAL + (N_FIELD_PAIRS - N_SDF_PAIRS) * tf32_tile::PAIR_ELEMS &&
                  W18_OFF == W13_OFF + 3 * 256 && FIELD_W_TOTAL == W18_OFF + 6 * 256,
              "packed weight layout");

constexpr int N_SKIP = 217;  // h3's columns in the skip concat
constexpr int LDR = 16;      // floats a row: x 0..2, d 4..6, grads 8..10, m_raw, m_sph, |x| 12..14
constexpr int N_SLOTS = 2;   // pairs in shared memory at a time
constexpr int SMEM_TF32 = N_SLOTS * tf32_tile::PAIR_ELEMS * 4 + 4 * TILE_POINTS * (tf32_tile::LDA + LDE + LDR) +
                          2 * N_SLOTS * 8 + 1024;
static_assert(SMEM_TF32 <= 232448, "shared memory of one block");
// the per-block scratch, in float4: for each warp nine fragments of 16 x 256
// (h_0 .. h_7, layer 8's features), each [32 column tiles][32 lanes]
constexpr int FRAG4 = 32 * 32;
constexpr long SCRATCH_F4 = 8L * 9 * FRAG4;

__device__ __forceinline__ float sigma_prime(float h) { return 1.f - expf(-100.f * h); }

// the pairs of the tile, K1's first, then the rest after K1's buffer
struct FieldPairs {
  static constexpr int COUNT = N_FIELD_PAIRS;
  __device__ static long at(int p) {
    return tf32_tile::ring_offset(p < N_SDF_PAIRS ? (long)p * tf32_tile::PAIR_ELEMS
                                                  : SDF_W_TOTAL + (long)(p - N_SDF_PAIRS) * tf32_tile::PAIR_ELEMS);
  }
};
using Ring = mma_tile::PanelRing<N_SLOTS, FieldPairs>;

// the warp's fragment of slot s in the scratch: float4 j of this lane
__device__ __forceinline__ float4* frag(float4* S, int s) { return S + (long)s * FRAG4 + (threadIdx.x & 31); }

// A[g or g+8][8j + 2t ..] <- act(acc + b) (RELU: relu, else softplus 100),
// and the values out to fragment F when it is given
template <bool RELU>
__device__ __forceinline__ void store_act(const float (&acc)[32][4], const float* __restrict__ b, float* A,
                                          float4* F) {
  constexpr int LD = tf32_tile::LDA;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b + col));
    float v[4] = {acc[j][0] + bb.x, acc[j][1] + bb.y, acc[j][2] + bb.x, acc[j][3] + bb.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = RELU ? fmaxf(v[i], 0.f) : softplus100(v[i]);
    *reinterpret_cast<float2*>(A + g * LD + col) = make_float2(v[0], v[1]);
    *reinterpret_cast<float2*>(A + (g + 8) * LD + col) = make_float2(v[2], v[3]);
    if (F != nullptr) F[32 * j] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// out[o] (rows g and g+8, summed over the warp's 4 lanes of the row) =
// A[row][:] . M[o][:] over the 256 columns of the strip (M: NOUT rows of 256 f32)
template <int NOUT>
__device__ __forceinline__ void row_dots(const float* A, const float* __restrict__ M, float (&lo)[NOUT],
                                         float (&hi)[NOUT]) {
  constexpr int LD = tf32_tile::LDA;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int o = 0; o < NOUT; ++o) lo[o] = hi[o] = 0.f;
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 a = *reinterpret_cast<const float2*>(A + g * LD + col);
    const float2 c = *reinterpret_cast<const float2*>(A + (g + 8) * LD + col);
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      const float2 w = __ldg(reinterpret_cast<const float2*>(M + o * 256 + col));
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

// One step of the gradient sweep, on u = V_L W_L^T in acc: the cotangent of
// layer L-1's pre-activation, V_{L-1} = u sigma'(h_{L-1}), into A; h_{L-1}
// from fragment H. Layer 4 (skip): u / sqrt 2, and its columns >= N_SKIP are
// the embedding's share, CE = u / sqrt 2, V = 0 there.
__device__ __forceinline__ void sweep_epilogue(const float (&acc)[32][4], float* A, float* CE, bool skip,
                                               const float4* H) {
  constexpr int LD = tf32_tile::LDA;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float cs = skip ? INV_SQRT2 : 1.f;
#pragma unroll
  for (int j0 = 0; j0 < 32; j0 += 4) {
    float4 h[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) h[jj] = H[32 * (j0 + jj)];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + jj, col = 8 * j + 2 * t;
      const float u[4] = {acc[j][0] * cs, acc[j][1] * cs, acc[j][2] * cs, acc[j][3] * cs};
      float v[4] = {u[0] * sigma_prime(h[jj].x), u[1] * sigma_prime(h[jj].y), u[2] * sigma_prime(h[jj].z),
                    u[3] * sigma_prime(h[jj].w)};
      if (skip && 8 * j + 8 > N_SKIP) {  // the tile of columns that reaches the embedding's share
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = col + (i & 1), r = g + 8 * (i >> 1);
          if (c >= N_SKIP) {
            CE[r * LDE + c - N_SKIP] = u[i];
            v[i] = 0.f;
          }
        }
      }
      *reinterpret_cast<float2*>(A + g * LD + col) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(A + (g + 8) * LD + col) = make_float2(v[2], v[3]);
    }
  }
}

__global__ void __launch_bounds__(TF32_THREADS, 1)
    field_fwd_tf32_kernel(const float* __restrict__ x, const float* __restrict__ d, const float* __restrict__ W,
                          const float* __restrict__ B, float* __restrict__ o_sdf, float* __restrict__ o_grads,
                          float* __restrict__ o_rgb, float* __restrict__ o_att, float4* scratch, int n,
                          float radius, float scale) {
  constexpr int R = mma_tile::WARP_ROWS, LD = tf32_tile::LDA;
  using tf32_tile::products;
  extern __shared__ unsigned char smem_raw[];
  float* slots = reinterpret_cast<float*>(smem_raw + ((1024u - (mma_tile::smem_u32(smem_raw) & 1023u)) & 1023u));
  float* act = slots + N_SLOTS * tf32_tile::PAIR_ELEMS;  // TILE_POINTS x LDA
  float* ec = act + TILE_POINTS * LD;                    // TILE_POINTS x LDE
  float* rowf = ec + TILE_POINTS * LDE;                  // TILE_POINTS x LDR
  uint64_t* full = reinterpret_cast<uint64_t*>(rowf + TILE_POINTS * LDR);
  uint64_t* empty = full + N_SLOTS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  const int tiles = (n + TILE_POINTS - 1) / TILE_POINTS;
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  Ring ring{reinterpret_cast<const __nv_bfloat16*>(W), reinterpret_cast<__nv_bfloat16*>(slots), full, empty, 0,
            mine * N_FIELD_PAIRS};
  if (threadIdx.x == 0) ring.init(8);  // one lane of each warp reads each pair
  __syncthreads();
  const bool feeder = threadIdx.x == 128;  // warpgroup 1 reads every pair last
  if (feeder) ring.prime();

  float* A = act + warp * R * LD;  // this warp's strips
  float* E = ec + warp * R * LDE;  // the embedding, later a head's leading inputs ...
  float* CE = E;                   // ... and between them the embedding's cotangent
  float* RF = rowf + warp * R * LDR;
  float4* S = scratch + (long)blockIdx.x * SCRATCH_F4 + (long)warp * 9 * FRAG4;

  float acc[32][4];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * TILE_POINTS + warp * R;  // the strip's first row
    const int rows = n - row0 >= R ? R : (n - row0 > 0 ? (int)(n - row0) : 0);

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
    for (int i = lane; i < R * LDE; i += 32) {
      const int r = i / LDE, j = i % LDE;
      E[i] = j < 39 ? pe_val(RF + r * LDR, j) : 0.f;
    }
    __syncwarp();

    // ---- the implicit chain, each post-activation out to the scratch ----
    products<3, 1, LDE>(acc, E, ring, feeder, false);
    __syncwarp();
    store_act<false>(acc, B, A, frag(S, 0));
    __syncwarp();
#pragma unroll 1
    for (int l = 1; l <= 6; ++l) {
      products<16, 2, LD>(acc, A, ring, feeder, false);
      __syncwarp();  // the strip is read: it may be overwritten
      store_act<false>(acc, B + 256 * l, A, frag(S, l));
      if (l == 3) {  // the skip concat: [h3 (217), emb (39)] / sqrt 2
        __syncwarp();
        for (int i = lane; i < R * 256; i += 32) {
          const int r = i >> 8, j = i & 255;
          A[r * LD + j] = (j < N_SKIP ? A[r * LD + j] : E[r * LDE + j - N_SKIP]) * INV_SQRT2;
        }
      }
      __syncwarp();
    }
    // layer 7: h7, and the last layer's sdf column as an f32 dot product over it
    products<16, 2, LD>(acc, A, ring, feeder, false);
    __syncwarp();
    store_act<false>(acc, B + 256 * 7, A, frag(S, 7));
    float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 w8 = __ldg(reinterpret_cast<const float2*>(W + SDF_W8_OFF + col));
      const float2 hl = *reinterpret_cast<const float2*>(A + g * LD + col);
      const float2 hh = *reinterpret_cast<const float2*>(A + (g + 8) * LD + col);
      s_lo = fmaf(hl.x, w8.x, s_lo);
      s_lo = fmaf(hl.y, w8.y, s_lo);
      s_hi = fmaf(hh.x, w8.x, s_hi);
      s_hi = fmaf(hh.y, w8.y, s_hi);
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
        if (r < rows) o_sdf[row0 + r] = fminf(raw, sph);
      }
    }
    __syncwarp();

    // ---- layer 8's features, out to the scratch; the sweep's seed over h7 ----
    products<16, 2, LD>(acc, A, ring, feeder, false);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(B + B8F_OFF + col));
      frag(S, 8)[32 * j] = make_float4(acc[j][0] + bb.x, acc[j][1] + bb.y, acc[j][2] + bb.x, acc[j][3] + bb.y);
      // the seed is one-hot on the sdf channel: u = W_8's sdf column, V7 = u sigma'_7
      const float2 w8 = __ldg(reinterpret_cast<const float2*>(W + SDF_W8_OFF + col));
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float2* p = reinterpret_cast<float2*>(A + (g + 8 * hf) * LD + col);
        const float2 h = *p;
        *p = make_float2(w8.x * sigma_prime(h.x), w8.y * sigma_prime(h.y));
      }
    }
    __syncwarp();

    // ---- the spatial-gradient sweep over the transposed panels ----
#pragma unroll 1
    for (int L = 7; L >= 1; --L) {
      products<16, 2, LD>(acc, A, ring, feeder, false);
      __syncwarp();
      sweep_epilogue(acc, A, CE, L == 4, frag(S, L - 1));
      __syncwarp();
    }
    products<16, 2, LD>(acc, A, ring, feeder, false);
#pragma unroll
    for (int j = 0; j < 5; ++j) {  // layer 0: the embedding's columns 0..38
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = g + 8 * hf;
        if (col < 39) CE[r * LDE + col] += acc[j][2 * hf];
        if (col + 1 < 39) CE[r * LDE + col + 1] += acc[j][2 * hf + 1];
      }
    }
    __syncwarp();
    // grads = m_raw J_PE(x)^T CE + m_sph (-scale x / |x|)
    if (lane < R) {
      float* rf = RF + lane * LDR;
      const float* ce = CE + lane * LDE;
      float gm[3] = {ce[0], ce[1], ce[2]};
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float f = (float)(1 << k);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float a = f * rf[q];
          gm[q] = gm[q] + f * (ce[3 + 6 * k + q] * cosf(a) - ce[6 + 6 * k + q] * sinf(a));
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
      // leading inputs: [x, PE4(d), grads] (33) or [x, d, grads] (9); the features
      const int nd = head == 0 ? 27 : 3;
      for (int i = lane; i < R * LDE; i += 32) {
        const int r = i / LDE, j = i % LDE;
        const float* rf = RF + r * LDR;
        float v = 0.f;
        if (j < 3) v = rf[j];
        else if (j < 3 + nd) v = pe_val(rf + 4, j - 3);
        else if (j < 6 + nd) v = rf[8 + j - 3 - nd];
        E[i] = v;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * j + 2 * t;
        const float4 z = frag(S, 8)[32 * j];
        *reinterpret_cast<float2*>(A + g * LD + col) = make_float2(z.x, z.y);
        *reinterpret_cast<float2*>(A + (g + 8) * LD + col) = make_float2(z.z, z.w);
      }
      __syncwarp();
      // the first layer: the leading pairs, then the features'
      if (head == 0) products<3, 1, LDE>(acc, E, ring, feeder, false);
      else products<1, 2, LDE>(acc, E, ring, feeder, false);
      products<16, 2, LD>(acc, A, ring, feeder, true);
      const float* bh = B + (head == 0 ? B9_OFF : B14_OFF);
#pragma unroll 1
      for (int l = 0; l < 4; ++l) {
        if (l > 0) products<16, 2, LD>(acc, A, ring, feeder, false);
        __syncwarp();
        store_act<true>(acc, bh + 256 * l, A, nullptr);
        __syncwarp();
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

// the per-block scratch of f32 values, and the blocks, for n points
extern "C" void field_fwd_tf32_layout(int n, int max_blocks, int* n_blocks, long long* scratch_f32) {
  const int tiles = (n + TILE_POINTS - 1) / TILE_POINTS;
  *n_blocks = tiles < max_blocks ? tiles : max_blocks;
  *scratch_f32 = 4 * SCRATCH_F4;
}

// outputs only; packed operands (ops/tf32.py:pack_field_weights_tf32);
// scratch as field_fwd_tf32_layout sizes it
extern "C" int field_fwd_tf32(const void* x, const void* d, const void* w, const void* b, void* sdf, void* grads,
                              void* rgb, void* att, void* scratch, int n, int max_blocks, float radius, float scale,
                              void* stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(field_fwd_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_TF32);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int tiles = (n + TILE_POINTS - 1) / TILE_POINTS;
  field_fwd_tf32_kernel<<<tiles < max_blocks ? tiles : max_blocks, TF32_THREADS, SMEM_TF32,
                          (cudaStream_t)stream>>>((const float*)x, (const float*)d, (const float*)w, (const float*)b,
                                                  (float*)sdf, (float*)grads, (float*)rgb, (float*)att,
                                                  (float4*)scratch, n, radius, scale);
  return (int)cudaGetLastError();
}
