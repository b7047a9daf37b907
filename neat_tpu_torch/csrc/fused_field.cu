// K3: the field pass that keeps no residuals (K3-fwd) and the backward that
// re-runs the forward (K3-bwd). Replaces
// neat_tpu/ops/fused_field.py:_fwd_kernel and _bwd_kernel; the math is
// field_math of ops/fused_field.py and its autograd, and that module holds
// the design note. The per-tile bodies are in field_tile.cuh, shared with K2.
//
// Both kernels are persistent (one block per SM walks the tiles) and keep a
// tile's residuals in a per-block scratch in the stash's column layout, which
// every tile rewrites: device memory never holds an (N, 4057) array.
#include "field_tile.cuh"

constexpr long FWD_SCRATCH_CD = (long)TT * W_CD;  // the tile's post-activations
// the backward's f32 scratch of one block: embedding and z8, rgb, grads, and
// the tangent chain's pre-activations
constexpr long BWD_SF32 = 0;
constexpr long BWD_RGB = BWD_SF32 + (long)TT * W_F32;
constexpr long BWD_GRADS = BWD_RGB + TT * 3;
constexpr long BWD_ZD = BWD_GRADS + TT * 3;
constexpr long BWD_SCRATCH_F32 = BWD_ZD + S_ROWS;

template <typename CD>
__global__ void __launch_bounds__(NT)
    field_fwd_kernel(const float* __restrict__ x, const float* __restrict__ d,
                     const CD* __restrict__ W, const CD* __restrict__ WT,
                     const float* __restrict__ B, float* __restrict__ sdf_out,
                     float* __restrict__ grads_out, float* __restrict__ rgb_out,
                     float* __restrict__ att_out, CD* scratch, int n, float radius,
                     float scale) {
  extern __shared__ float4 smem4[];
  CD* scd = scratch + (long)blockIdx.x * FWD_SCRATCH_CD;
  const int n_tiles = (n + TT - 1) / TT;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = (long)tile * TT;
    const int valid = min(TT, (int)(n - row0));
    field_fwd_tile<CD, false>(x, d, W, WT, B, sdf_out + row0, grads_out + row0 * 3,
                              rgb_out + row0 * 3, att_out + row0 * 6, scd, nullptr, row0, valid,
                              radius, scale, reinterpret_cast<float*>(smem4));
    __syncthreads();  // the next tile reuses the shared buffers and the scratch
  }
}

template <typename CD>
__global__ void __launch_bounds__(NT)
    field_bwd_kernel(const float* __restrict__ x, const float* __restrict__ d,
                     const float* __restrict__ c_sdf, const float* __restrict__ c_g,
                     const float* __restrict__ c_rgb, const float* __restrict__ c_att,
                     const CD* __restrict__ W, const CD* __restrict__ WT,
                     const float* __restrict__ B, float* __restrict__ dx_out,
                     float* __restrict__ dd_out, float* __restrict__ partials, CD* scratch_cd,
                     float* scratch_f32, int n, float radius, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Gp = partials + (long)blockIdx.x * N_PARAMS;  // this block's parameter gradients
  CD* scd = scratch_cd + (long)blockIdx.x * FWD_SCRATCH_CD;
  float* sf = scratch_f32 + (long)blockIdx.x * BWD_SCRATCH_F32;
  for (long i = threadIdx.x; i < N_PARAMS; i += NT) Gp[i] = 0.f;
  __syncthreads();
  const int n_tiles = (n + TT - 1) / TT;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = (long)tile * TT;
    const int valid = min(TT, (int)(n - row0));
    // the forward again, its residuals into this block's scratch
    field_fwd_tile<CD, true>(x, d, W, WT, B, nullptr, sf + BWD_GRADS, sf + BWD_RGB, nullptr, scd,
                             sf + BWD_SF32, row0, valid, radius, scale, smem);
    __syncthreads();  // the residuals are written; the shared buffers change hands
    field_bwd_tile<CD>(x, d, scd, sf + BWD_SF32, sf + BWD_RGB, sf + BWD_GRADS, c_sdf, c_g, c_rgb,
                       c_att, W, WT, dx_out, dd_out, Gp, sf + BWD_ZD, row0, valid, radius, scale,
                       smem);
  }
}

// the buffers the callers allocate, per block: the forward's scratch in CD
// values, the backward's in CD and in f32 values; n_blocks x n_params f32
// partials and n_params gradients. The tile size and the layer table stay
// decided here alone.
extern "C" void field_layout(int n, int max_blocks, int* n_blocks, long long* n_params,
                             long long* fwd_scratch_cd, long long* bwd_scratch_cd,
                             long long* bwd_scratch_f32) {
  *n_blocks = persistent_blocks(n, max_blocks);
  *n_params = N_PARAMS;
  *fwd_scratch_cd = FWD_SCRATCH_CD;
  *bwd_scratch_cd = FWD_SCRATCH_CD;
  *bwd_scratch_f32 = BWD_SCRATCH_F32;
}

template <typename CD>
static int fwd(const void* x, const void* d, const void* w, const void* wt, const void* b,
               void* sdf, void* grads, void* rgb, void* att, void* scratch, int n, int max_blocks,
               float radius, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      field_fwd_kernel<CD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  field_fwd_kernel<CD>
      <<<persistent_blocks(n, max_blocks), NT, FWD_SMEM, (cudaStream_t)stream>>>(
          (const float*)x, (const float*)d, (const CD*)w, (const CD*)wt, (const float*)b,
          (float*)sdf, (float*)grads, (float*)rgb, (float*)att, (CD*)scratch, n, radius, scale);
  return (int)cudaGetLastError();
}

template <typename CD>
static int bwd(const void* x, const void* d, const void* c_sdf, const void* c_g,
               const void* c_rgb, const void* c_att, const void* w, const void* wt, const void* b,
               void* dx, void* dd, void* dparams, void* partials, void* scratch_cd,
               void* scratch_f32, int n, int max_blocks, float radius, float scale,
               void* stream) {
  const int n_blocks = persistent_blocks(n, max_blocks);
  constexpr size_t smem = BWD_SMEM > FWD_SMEM ? BWD_SMEM : FWD_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      field_bwd_kernel<CD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  field_bwd_kernel<CD><<<n_blocks, NT, smem, s>>>(
      (const float*)x, (const float*)d, (const float*)c_sdf, (const float*)c_g,
      (const float*)c_rgb, (const float*)c_att, (const CD*)w, (const CD*)wt, (const float*)b,
      (float*)dx, (float*)dd, (float*)partials, (CD*)scratch_cd, (float*)scratch_f32, n, radius,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<(int)((N_PARAMS + 255) / 256), 256, 0, s>>>((const float*)partials,
                                                             (float*)dparams, n_blocks);
  return (int)cudaGetLastError();
}

#define FWD_ARGS                                                                         \
  const void *x, const void *d, const void *w, const void *wt, const void *b, void *sdf, \
      void *grads, void *rgb, void *att, void *scratch, int n, int max_blocks,           \
      float radius, float scale, void *stream
#define BWD_ARGS                                                                          \
  const void *x, const void *d, const void *c_sdf, const void *c_g, const void *c_rgb,    \
      const void *c_att, const void *w, const void *wt, const void *b, void *dx, void *dd, \
      void *dparams, void *partials, void *scratch_cd, void *scratch_f32, int n,          \
      int max_blocks, float radius, float scale, void *stream

extern "C" int field_fwd_bf16(FWD_ARGS) {
  return fwd<__nv_bfloat16>(x, d, w, wt, b, sdf, grads, rgb, att, scratch, n, max_blocks, radius,
                            scale, stream);
}
extern "C" int field_fwd_f32(FWD_ARGS) {
  return fwd<float>(x, d, w, wt, b, sdf, grads, rgb, att, scratch, n, max_blocks, radius, scale,
                    stream);
}
extern "C" int field_bwd_bf16(BWD_ARGS) {
  return bwd<__nv_bfloat16>(x, d, c_sdf, c_g, c_rgb, c_att, w, wt, b, dx, dd, dparams, partials,
                            scratch_cd, scratch_f32, n, max_blocks, radius, scale, stream);
}
extern "C" int field_bwd_f32(BWD_ARGS) {
  return bwd<float>(x, d, c_sdf, c_g, c_rgb, c_att, w, wt, b, dx, dd, dparams, partials,
                    scratch_cd, scratch_f32, n, max_blocks, radius, scale, stream);
}
