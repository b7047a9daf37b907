// The weight gradients of the split field backward (K2-bwd, bf16): per layer
// dW_l = A_l Y_l^T over the points, from the workspace that the row-local
// pass (fused_field_stash.cu, field_bwd_split_bf16) writes. Replaces the
// parameter-gradient sums of neat_tpu/ops/fused_field_stash.py:
// _bwd_stash_kernel, which the TPU accumulated tile by tile in one revisited
// VMEM block. The layout and the schedule are ops/field_dw.py's, which also
// holds the plain versions (field_dw_plain, dw_schedule_plain).
//
// The workspace is a (rows, np) bf16 matrix: one row per feature of each
// operand, the points contiguous (K-major for both operands of every
// product). A work unit is a run of 64-point k chunks of one 128 x 256
// output tile; chunk c of a unit reads term c / chunks (an implicit layer's
// primal or tangent term) at point (c % chunks) * 64.
//
// What bounds it: bytes at the main path's size (25.7 KB of workspace a
// point against 1.52 M MACs). The design: two warpgroups, 64 rows each of
// the tile, wgmma m64n256k16 with both operands in 128-byte-swizzled shared
// memory; TMA (cp.async.bulk.tensor.2d) brings each chunk's A (128 x 64) and
// Y (256 x 64) boxes into a ring of four stages with mbarriers (the tensor
// map applies the swizzle wgmma reads; rows past the end come back as
// zeros). Each unit writes its f32 partial tile; dw_reduce sums the partials
// of a tile in the schedule's order and adds them into the gradients:
// deterministic, no atomics. Units of the m tiles of one run are neighbours
// in the grid, so they read the same Y boxes at the same time, mostly from L2.
#include <cuda.h>
#include <cudaTypedefs.h>

#include "mma_tile.cuh"

namespace {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int THREADS = 256;                    // two warpgroups
constexpr int A_BYTES = BM * BK * 2;            // 16 KB
constexpr int B_BYTES = BN * BK * 2;            // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // 48 KB
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
constexpr int UNIT_INTS = 8, TILE_INTS = 8;

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :
      : "r"(mma_tile::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(static_cast<const void*>(map))),
        "r"(x), "r"(y),
        "r"(mma_tile::smem_u32(bar))
      : "memory");
}

// one unit: its partial 128 x 256 tile, f32, row-major
__global__ void __launch_bounds__(THREADS, 1)
    dw_gemm(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_y,
            const int* __restrict__ units, float* __restrict__ partials) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (mma_tile::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int* u = units + (long)blockIdx.x * UNIT_INTS;
  const int a0 = u[0], y0 = u[1], a1 = u[2], y1 = u[3], chunks = u[4], c0 = u[5];
  const int nk = u[6] - c0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mma_tile::mbar_init(full + s, 1);          // the thread that asks for the copies
      mma_tile::mbar_init(empty + s, THREADS);  // every thread, when it has read the stage
    }
    mma_tile::mbar_init_fence();
  }
  __syncthreads();
  // chunk k of the unit into stage k % STAGES (one thread)
  const CUtensorMap* ma = &map_a;
  const CUtensorMap* my = &map_y;
  auto issue = [&](int k) {
    const int c = c0 + k, s = k % STAGES;
    const bool second = c >= chunks;
    const int p = (second ? c - chunks : c) * BK;
    unsigned char* st = base + s * STAGE_BYTES;
    mma_tile::mbar_arrive_expect_tx(full + s, STAGE_BYTES);
    tma_load_2d(st, ma, p, second ? a1 : a0, full + s);
    tma_load_2d(st + A_BYTES, my, p, second ? y1 : y0, full + s);
  };
  if (threadIdx.x == 0)
    for (int k = 0; k < STAGES && k < nk; ++k) issue(k);

  float acc[32][4];
  mma_tile::zero_acc(acc);
  const int wg = threadIdx.x >> 7;
  for (int k = 0; k < nk; ++k) {
    const int s = k % STAGES;
    mma_tile::mbar_wait(full + s, (k / STAGES) & 1);
    const uint32_t a_addr = mma_tile::smem_u32(base + s * STAGE_BYTES + wg * (A_BYTES / 2));
    const uint32_t y_addr = mma_tile::smem_u32(base + s * STAGE_BYTES + A_BYTES);
    mma_tile::fence_acc(acc);
    mma_tile::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      mma_tile::wgmma_m64n256k16_ss(acc, mma_tile::panel_desc(a_addr) + 2 * ks,
                                    mma_tile::panel_desc(y_addr) + 2 * ks, 1);
    mma_tile::wgmma_commit();
    mma_tile::wgmma_wait<0>();
    mma_tile::fence_acc(acc);
    mma_tile::mbar_arrive(empty + s);
    if (threadIdx.x == 0 && k + STAGES < nk) {
      mma_tile::mbar_wait(empty + s, (k / STAGES) & 1);
      issue(k + STAGES);
    }
  }
  // the accumulator fragments (mma_tile.cuh): warp w of the warpgroup holds
  // rows 16w .. 16w + 15, n8 tile j in acc[j]
  float* P = partials + (long)blockIdx.x * BM * BN;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + g;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(P + r * BN + c) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(P + (r + 8) * BN + c) = make_float2(acc[j][2], acc[j][3]);
  }
}

// grid (BM * BN / 256, tiles): dparams[entry] += the tile's partials in
// schedule order; a tile: [M, N, gradient offset, row stride, first unit,
// unit stride, units, 0]
__global__ void dw_reduce(const float* __restrict__ partials, const int* __restrict__ tiles,
                          float* __restrict__ dparams) {
  const int* tl = tiles + (long)blockIdx.y * TILE_INTS;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = i / BN, n = i % BN;
  if (m >= tl[0] || n >= tl[1]) return;
  float s = 0.f;
  for (int k = 0; k < tl[6]; ++k) s += partials[(long)(tl[4] + k * tl[5]) * BM * BN + i];
  dparams[tl[2] + (long)m * tl[3] + n] += s;
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&fn), 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                                  reinterpret_cast<void**>(&fn), cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) fn = nullptr;
  }
  return fn;
}

// a tensor map of the (rows, np) bf16 workspace with boxes of 64 points x
// box_rows rows, swizzled as wgmma reads a K-major panel
int workspace_map(CUtensorMap* map, const void* ws, int rows, int np, int box_rows) {
  const auto encode = encode_fn();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)np, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)np * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ws), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// ws: (rows, np) bf16, np a multiple of 64; units (n_units x 8) and tiles
// (n_tiles x 8) int32 as dw_schedule gives them; partials: n_units x BM x BN
// f32; dparams: the flat f32 gradients, added into
extern "C" int field_dw_mma(const void* ws, const void* units, const void* tiles, void* partials,
                            void* dparams, int n_units, int n_tiles, int rows, int np,
                            void* stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(dw_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  CUtensorMap map_a, map_y;
  int err = workspace_map(&map_a, ws, rows, np, BM);
  if (err == 0) err = workspace_map(&map_y, ws, rows, np, BN);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  dw_gemm<<<n_units, THREADS, SMEM, s>>>(map_a, map_y, (const int*)units, (float*)partials);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dw_reduce<<<dim3(BM * BN / 256, n_tiles), 256, 0, s>>>((const float*)partials,
                                                         (const int*)tiles, (float*)dparams);
  return (int)cudaGetLastError();
}
