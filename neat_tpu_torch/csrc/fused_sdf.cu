// K1: the sampler's fused SDF MLP (replaces neat_tpu/ops/fused_sdf.py:_kernel).
//
// emb (N, 39) in CD -> sdf_raw (N,) f32 through the canonical 9-layer
// softplus-100 MLP with the skip concat at layer 4; the final layer is
// sliced to the sdf channel. One block per 32-point tile; all nine layers
// run out of shared memory. See ops/fused_sdf.py for the design note.
#include "common.cuh"

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

extern "C" int fused_sdf_fwd_bf16(const void* emb, const void* w, const void* b, void* out,
                                  int n, void* stream) {
  return launch<__nv_bfloat16>(emb, w, b, out, n, stream);
}

extern "C" int fused_sdf_fwd_f32(const void* emb, const void* w, const void* b, void* out,
                                 int n, void* stream) {
  return launch<float>(emb, w, b, out, n, stream);
}
