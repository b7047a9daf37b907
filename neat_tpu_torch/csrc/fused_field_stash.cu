// K2: the main field pass with its residual stash (K2-fwd) and the backward
// that replays the stash (K2-bwd). Replaces
// neat_tpu/ops/fused_field_stash.py:_fwd_stash_kernel and _bwd_stash_kernel;
// the math is field_fwd_res / field_bwd_stashed of ops/fused_field_stash.py,
// which also holds the design note. The per-tile bodies are in field_tile.cuh.
#include "field_tile.cuh"

// one block per tile; the stash rows of the tile are the residuals
template <typename CD>
__global__ void __launch_bounds__(NT)
    field_fwd_stash_kernel(const float* __restrict__ x, const float* __restrict__ d,
                           const CD* __restrict__ W, const CD* __restrict__ WT,
                           const float* __restrict__ B, float* __restrict__ sdf_out,
                           float* __restrict__ grads_out, float* __restrict__ rgb_out,
                           float* __restrict__ att_out, CD* scd,  // written, then re-read
                           float* __restrict__ sf32, int n, float radius, float scale) {
  extern __shared__ float4 smem4[];
  const long row0 = (long)blockIdx.x * TT;
  const int valid = min(TT, (int)(n - row0));
  field_fwd_tile<CD, true>(x, d, W, WT, B, sdf_out + row0, grads_out + row0 * 3,
                           rgb_out + row0 * 3, att_out + row0 * 6, scd + row0 * W_CD,
                           sf32 + row0 * W_F32, row0, valid, radius, scale,
                           reinterpret_cast<float*>(smem4));
}

// persistent: each block walks tiles and adds into its own partial gradients.
// EMIT (the split backward, bf16): the tiles store their weight-gradient
// operands into the workspace instead, and the partials take only the bias
// gradients and layer 8's tangent column (the rest stays 0); the GEMM in
// field_dw_mma.cu adds the weight gradients afterwards.
template <typename CD, bool EMIT>
__global__ void __launch_bounds__(NT)
    field_bwd_stash_kernel(const float* __restrict__ x, const float* __restrict__ d,
                           const CD* __restrict__ scd, const float* __restrict__ sf32,
                           const float* __restrict__ rgb, const float* __restrict__ grads,
                           const float* __restrict__ c_sdf, const float* __restrict__ c_g,
                           const float* __restrict__ c_rgb, const float* __restrict__ c_att,
                           const CD* __restrict__ W, const CD* __restrict__ WT,
                           float* __restrict__ dx_out, float* __restrict__ dd_out,
                           float* __restrict__ partials, float* __restrict__ scratch, int n,
                           float radius, float scale, WsOut ws) {
  extern __shared__ float4 smem4[];
  float* Gp = partials + (long)blockIdx.x * N_PARAMS;  // this block's parameter gradients
  float* ZD = scratch + (long)blockIdx.x * S_ROWS;
  for (long i = threadIdx.x; i < N_PARAMS; i += NT) Gp[i] = 0.f;
  __syncthreads();
  const int n_tiles = (n + TT - 1) / TT;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = (long)tile * TT;
    const int valid = min(TT, (int)(n - row0));
    field_bwd_tile<CD, EMIT>(x, d, scd + row0 * W_CD, sf32 + row0 * W_F32, rgb + row0 * 3,
                             grads + row0 * 3, c_sdf, c_g, c_rgb, c_att, W, WT, dx_out, dd_out, Gp,
                             ZD, row0, valid, radius, scale, reinterpret_cast<float*>(smem4), ws);
  }
}

template <typename CD>
static int fwd(const void* x, const void* d, const void* w, const void* wt, const void* b,
               void* sdf, void* grads, void* rgb, void* att, void* scd, void* sf32, int n,
               float radius, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(field_fwd_stash_kernel<CD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  field_fwd_stash_kernel<CD><<<(n + TT - 1) / TT, NT, FWD_SMEM, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)d, (const CD*)w, (const CD*)wt, (const float*)b,
      (float*)sdf, (float*)grads, (float*)rgb, (float*)att, (CD*)scd, (float*)sf32, n, radius,
      scale);
  return (int)cudaGetLastError();
}

// the buffers the backward's caller allocates: n_blocks x n_params f32
// partials, n_blocks x scratch_per_block f32 scratch, n_params gradients.
// The tile size and the layer table stay decided here alone.
extern "C" void field_bwd_layout(int n, int max_blocks, int* n_blocks, long long* n_params,
                                 long long* scratch_per_block) {
  *n_blocks = persistent_blocks(n, max_blocks);
  *n_params = N_PARAMS;
  *scratch_per_block = S_ROWS;
}

template <typename CD, bool EMIT = false>
static int bwd(const void* x, const void* d, const void* scd, const void* sf32, const void* rgb,
               const void* grads, const void* c_sdf, const void* c_g, const void* c_rgb,
               const void* c_att, const void* w, const void* wt, void* dx, void* dd,
               void* dparams, void* partials, void* scratch, int n, int max_blocks, float radius,
               float scale, void* stream, WsOut ws = WsOut{}) {
  const int n_blocks = persistent_blocks(n, max_blocks);
  cudaError_t err = cudaFuncSetAttribute(field_bwd_stash_kernel<CD, EMIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  field_bwd_stash_kernel<CD, EMIT><<<n_blocks, NT, BWD_SMEM, s>>>(
      (const float*)x, (const float*)d, (const CD*)scd, (const float*)sf32, (const float*)rgb,
      (const float*)grads, (const float*)c_sdf, (const float*)c_g, (const float*)c_rgb,
      (const float*)c_att, (const CD*)w, (const CD*)wt, (float*)dx, (float*)dd,
      (float*)partials, (float*)scratch, n, radius, scale, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<(int)((N_PARAMS + 255) / 256), 256, 0, s>>>((const float*)partials,
                                                             (float*)dparams, n_blocks);
  return (int)cudaGetLastError();
}

#define FWD_ARGS                                                                           \
  const void *x, const void *d, const void *w, const void *wt, const void *b, void *sdf,   \
      void *grads, void *rgb, void *att, void *scd, void *sf32, int n, float radius,       \
      float scale, void *stream
#define BWD_ARGS                                                                           \
  const void *x, const void *d, const void *scd, const void *sf32, const void *rgb,        \
      const void *grads, const void *c_sdf, const void *c_g, const void *c_rgb,            \
      const void *c_att, const void *w, const void *wt, void *dx, void *dd, void *dparams, \
      void *partials, void *scratch, int n, int max_blocks, float radius, float scale,     \
      void *stream

extern "C" int field_fwd_stash_bf16(FWD_ARGS) {
  return fwd<__nv_bfloat16>(x, d, w, wt, b, sdf, grads, rgb, att, scd, sf32, n, radius, scale,
                            stream);
}
extern "C" int field_fwd_stash_f32(FWD_ARGS) {
  return fwd<float>(x, d, w, wt, b, sdf, grads, rgb, att, scd, sf32, n, radius, scale, stream);
}
extern "C" int field_bwd_stash_bf16(BWD_ARGS) {
  return bwd<__nv_bfloat16>(x, d, scd, sf32, rgb, grads, c_sdf, c_g, c_rgb, c_att, w, wt, dx,
                            dd, dparams, partials, scratch, n, max_blocks, radius, scale, stream);
}
extern "C" int field_bwd_stash_f32(BWD_ARGS) {
  return bwd<float>(x, d, scd, sf32, rgb, grads, c_sdf, c_g, c_rgb, c_att, w, wt, dx, dd,
                    dparams, partials, scratch, n, max_blocks, radius, scale, stream);
}

// the split backward's row-local pass (bf16): as field_bwd_stash_bf16, and
// the weight-gradient operands into the workspace ws (ws_np points a row;
// ws_np a multiple of 64, the columns past the tiles zeroed by the caller),
// whose GEMM then adds dW into dparams. ws_rows: the first row of each
// operand, as WsOut orders them (ops/field_dw.py:ws_row_table).
extern "C" int field_bwd_split_bf16(const void* x, const void* d, const void* scd, const void* sf32,
                                    const void* rgb, const void* grads, const void* c_sdf,
                                    const void* c_g, const void* c_rgb, const void* c_att,
                                    const void* w, const void* wt, void* dx, void* dd,
                                    void* dparams, void* partials, void* scratch, void* ws,
                                    const int* ws_rows, int n, int max_blocks, int ws_np,
                                    float radius, float scale, void* stream) {
  WsOut out{(__nv_bfloat16*)ws, (long)ws_np};
  int* rows[] = {out.in, out.tin, out.cot, out.tcot};
  const int counts[] = {19, 8, 19, 8};
  for (int k = 0, at = 0; k < 4; at += counts[k++])
    for (int i = 0; i < counts[k]; ++i) rows[k][i] = ws_rows[at + i];
  return bwd<__nv_bfloat16, true>(x, d, scd, sf32, rgb, grads, c_sdf, c_g, c_rgb, c_att, w, wt,
                                  dx, dd, dparams, partials, scratch, n, max_blocks, radius, scale,
                                  stream, out);
}
