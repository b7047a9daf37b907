// K1 in f32 on the tensor cores, as 3xTF32 products (replaces
// neat_tpu/ops/fused_sdf.py:_kernel for the f32 evaluations of finalize,
// render eval and the mesh grid; the bf16 sampler's kernel is fused_sdf.cu).
//
// emb (N, 39) f32 -> sdf_raw (N,) f32 through the canonical 9-layer
// softplus-100 MLP with the skip concat at layer 4; the last layer sliced to
// the sdf channel.
//
// What bounds it: operations. 0.918 MFLOP a point of f32 products against
// 160 bytes; as three TF32 products at 495 TFLOP/s, 5.6 ns a point (1.46 ms
// at 262,144 points), against 13.7 on the CUDA cores' 67 TFLOP/s. Beside the
// products: the exact softplus (expf, log1pf, a division), 2,009 a point,
// and the weights, which every tile reads through L2 split in two (3.7 MB a
// 128-point tile).
//
// The design is the bf16 kernel's (fused_sdf.cu: fused_sdf_mma) with f32
// operands (tf32_tile.cuh): persistent blocks of 256 threads, two
// warpgroups, 128 points a tile, each warp owning 16 rows through every
// layer with no block barrier between layers; the activations f32 in one
// 128 x 264 buffer that each warp overwrites in place; the weights the
// shared-memory image of 115 pairs of hi/lo panels (ops/tf32.py:
// pack_sdf_weights_tf32), a ring of two 32 KB slots filled by cp.async.bulk
// with an mbarrier a slot, from which both warpgroups multiply without
// taking turns. The tensor core sums each pair from zero, a quarter of the
// columns at a time, and the pairs' sums go into an f32 running sum
// rounded to nearest (its accumulator rounds toward zero: tf32_tile.cuh).
// The last layer (256 -> 1) is an f32 dot product in layer 7's epilogue.
//
// Shared memory: 2 x 32 KB of pairs + 135,168 bytes of activations (128 x
// 264 f32) + 20,480 of embedding (128 x 40 f32) + the barriers = 222,240
// bytes with the alignment: one block an SM. A 128-point tile of f32
// activations alone takes 135 KB, so the ring holds two pairs (one k16 step
// of a layer each), not the bf16 kernel's four 64-k panels. Registers: the
// running sum (128), a quarter's accumulator (32), the split A fragments
// (16): ptxas reports 217 and no spill.
//
// Functions are the scalar kernel's: softplus100 (expf, log1pf), f32
// rounding points (rnd is the identity in f32; the skip concat times
// 1/sqrt 2).
#include "tf32_tile.cuh"

// The packed operands; ops/tf32.py:pack_sdf_weights_tf32 writes them and
// exports the same numbers.
constexpr int TILE_POINTS = 128;  // points a block works on at a time
constexpr int TF32_THREADS = 256;  // 8 warps x 16 rows: two warpgroups
constexpr int N_SDF_PAIRS = 115;   // layer 0: three (k 39 -> 48, the last one k8 step); layers 1..7: 16 each
constexpr int SDF_W8_OFF = 942080;  // W_8's sdf column, 256 f32
constexpr int SDF_W_TOTAL = 942336;
constexpr int B8_OFF = 2048;       // biases: layer l < 8 at 256 * l (zero-padded), then b8
constexpr int N_SKIP = 217;        // h3's columns in the skip concat
constexpr int N_SLOTS = 2;         // pairs in shared memory at a time
static_assert(SDF_W8_OFF == N_SDF_PAIRS * tf32_tile::PAIR_ELEMS && SDF_W_TOTAL == SDF_W8_OFF + 256,
              "packed weight layout");
constexpr int SMEM_TF32 = N_SLOTS * tf32_tile::PAIR_ELEMS * 4 + 4 * TILE_POINTS * (tf32_tile::LDA + LDE) +
                          2 * N_SLOTS * 8 + 1024;
static_assert(SMEM_TF32 <= 232448, "shared memory of one block");

struct SdfPairs {
  static constexpr int COUNT = N_SDF_PAIRS;
  __device__ static long at(int p) { return tf32_tile::ring_offset((long)p * tf32_tile::PAIR_ELEMS); }
};
using Ring = mma_tile::PanelRing<N_SLOTS, SdfPairs>;

// A[g or g+8][8j + 2t ..] <- softplus100(acc + b), columns < width
__device__ __forceinline__ void store_hidden(const float (&acc)[32][4], const float* __restrict__ b, float* A,
                                             int width, float c) {
  constexpr int LD = tf32_tile::LDA;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= width) break;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b + col));
    const float2 lo = make_float2(softplus100(acc[j][0] + bb.x) * c, softplus100(acc[j][1] + bb.y) * c);
    const float2 hi = make_float2(softplus100(acc[j][2] + bb.x) * c, softplus100(acc[j][3] + bb.y) * c);
    if (col + 1 < width) {
      *reinterpret_cast<float2*>(A + g * LD + col) = lo;
      *reinterpret_cast<float2*>(A + (g + 8) * LD + col) = hi;
    } else {
      A[g * LD + col] = lo.x;
      A[(g + 8) * LD + col] = hi.x;
    }
  }
}

__global__ void __launch_bounds__(TF32_THREADS, 1)
    fused_sdf_tf32_kernel(const float* __restrict__ emb, const float* __restrict__ W, const float* __restrict__ B,
                          float* __restrict__ out, int n) {
  constexpr int R = mma_tile::WARP_ROWS, LD = tf32_tile::LDA;
  extern __shared__ unsigned char smem_raw[];
  // the slots first, on 1024 bytes
  float* slots = reinterpret_cast<float*>(smem_raw + ((1024u - (mma_tile::smem_u32(smem_raw) & 1023u)) & 1023u));
  float* act = slots + N_SLOTS * tf32_tile::PAIR_ELEMS;  // TILE_POINTS x LDA
  float* em = act + TILE_POINTS * LD;                    // TILE_POINTS x LDE
  uint64_t* full = reinterpret_cast<uint64_t*>(em + TILE_POINTS * LDE);
  uint64_t* empty = full + N_SLOTS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  const int tiles = (n + TILE_POINTS - 1) / TILE_POINTS;
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  Ring ring{reinterpret_cast<const __nv_bfloat16*>(W), reinterpret_cast<__nv_bfloat16*>(slots), full, empty, 0,
            mine * N_SDF_PAIRS};
  if (threadIdx.x == 0) ring.init(8);  // one lane of each warp reads each pair
  __syncthreads();
  const bool feeder = threadIdx.x == 128;  // warpgroup 1 reads every pair last
  if (feeder) ring.prime();

  float* A = act + warp * R * LD;  // this warp's strips
  float* E = em + warp * R * LDE;
  float acc[32][4];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * TILE_POINTS + warp * R;
    // the strip's embedding rows, zero past column 39 and past row n
    for (int i = lane; i < R * LDE; i += 32) {
      const int r = i / LDE, j = i % LDE;
      E[i] = (row0 + r < n && j < 39) ? emb[(row0 + r) * 39 + j] : 0.f;
    }
    __syncwarp();
    // layer 0: 39 (40) -> 256 from the embedding strip, five k8 steps
    tf32_tile::products<3, 1, LDE>(acc, E, ring, feeder, false);
    __syncwarp();
    store_hidden(acc, B, A, 256, 1.f);
    __syncwarp();
#pragma unroll 1
    for (int l = 1; l <= 6; ++l) {
      tf32_tile::products<16, 2, LD>(acc, A, ring, feeder, false);
      __syncwarp();  // the strip is read: it may be overwritten
      if (l == 3) {  // the skip concat: [h3 (217), emb (39)] / sqrt 2
        store_hidden(acc, B + 256 * 3, A, N_SKIP, INV_SQRT2);
        for (int i = lane; i < R * 39; i += 32) {
          const int r = i / 39, j = i % 39;
          A[r * LD + N_SKIP + j] = E[r * LDE + j] * INV_SQRT2;
        }
      } else {
        store_hidden(acc, B + 256 * l, A, 256, 1.f);
      }
      __syncwarp();
    }
    // layer 7, and the last layer's sdf column as an f32 dot product over its output
    tf32_tile::products<16, 2, LD>(acc, A, ring, feeder, false);
    __syncwarp();
    float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(B + 256 * 7 + col));
      const float2 w8 = __ldg(reinterpret_cast<const float2*>(W + SDF_W8_OFF + col));
      s_lo = fmaf(softplus100(acc[j][0] + bb.x), w8.x, s_lo);
      s_lo = fmaf(softplus100(acc[j][1] + bb.y), w8.y, s_lo);
      s_hi = fmaf(softplus100(acc[j][2] + bb.x), w8.x, s_hi);
      s_hi = fmaf(softplus100(acc[j][3] + bb.y), w8.y, s_hi);
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

// packed operands (ops/tf32.py:pack_sdf_weights_tf32)
extern "C" int fused_sdf_fwd_tf32(const void* emb, const void* w, const void* b, void* out, int n, void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fused_sdf_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_TF32);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  const int tiles = (n + TILE_POINTS - 1) / TILE_POINTS;
  fused_sdf_tf32_kernel<<<tiles < sms ? tiles : sms, TF32_THREADS, SMEM_TF32, (cudaStream_t)stream>>>(
      (const float*)emb, (const float*)w, (const float*)b, (float*)out, n);
  return (int)cudaGetLastError();
}
