// Building blocks shared by the fused SDF (K1) and fused field (K2) kernels.
//
// A block of NT = 256 threads owns a tile of TT = 32 points. Activations
// and cotangents of the tile live in shared memory as float, already
// rounded to the compute dtype CD where the JAX math casts to it, so every
// product is an exact CD x CD product summed in f32.
//
// tile_mm:    out[t][n] = sum_k A[t][k] * M[k][n]; one output column per
//             thread, the tile's 32 sums in registers, A read as float4
//             broadcasts from shared memory, M (CD, row-major) from global
//             memory (L2-resident weights).
// tile_wgrad: G[k][n] += sum_t A1[t][k] D1[t][n] (+ A2 D2), the parameter
//             gradient of one tile, added into a per-block f32 partial.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int NT = 256;   // threads per block
constexpr int TT = 32;    // points per tile
constexpr int LDH = 292;  // row stride of the wide buffers (>= 289, multiple of 4)
constexpr int LDE = 40;   // row stride of the 39-wide embedding buffers
constexpr float INV_SQRT2 = 0.70710678118654752f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// round an f32 value to the compute dtype and back
template <typename CD> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<CD>(v)); }

// softplus(100 z) / 100 as JAX writes softplus: logaddexp(100 z, 0)
__device__ __forceinline__ float softplus100(float z) {
  const float s = 100.f * z;
  return (fmaxf(s, 0.f) + log1pf(expf(-fabsf(s)))) / 100.f;
}

// column j of the positional encoding [x, sin(2^0 x), cos(2^0 x), ...]
__device__ __forceinline__ float pe_val(const float* x, int j) {
  if (j < 3) return x[j];
  const int k = (j - 3) / 6, r = (j - 3) % 6, c = r % 3;
  const float a = (float)(1 << k) * x[c];
  return r < 3 ? sinf(a) : cosf(a);
}

// ---------------------------------------------------------------------------
// the 19 canonical layers: implicit 0..8, rendering 9..13, attraction 14..18
// ---------------------------------------------------------------------------
struct LayerTable {
  int in[19];
  int out[19];
};
constexpr LayerTable LT = {
    {39, 256, 256, 256, 256, 256, 256, 256, 256, 289, 256, 256, 256, 256, 265, 256, 256, 256, 256},
    {256, 256, 256, 217, 256, 256, 256, 256, 257, 256, 256, 256, 256, 3, 256, 256, 256, 256, 6}};

__host__ __device__ constexpr long w_off(int l) {  // offset of W_l (in, out) in the packed weights
  long o = 0;
  for (int i = 0; i < l; ++i) o += (long)LT.in[i] * LT.out[i];
  return o;
}
__host__ __device__ constexpr long b_off(int l) {  // offset of b_l in the packed biases
  long o = 0;
  for (int i = 0; i < l; ++i) o += LT.out[i];
  return o;
}
__host__ __device__ constexpr long g_off(int l) {  // offset of dW_l (then db_l) in the packed gradients
  long o = 0;
  for (int i = 0; i < l; ++i) o += (long)LT.in[i] * LT.out[i] + LT.out[i];
  return o;
}
constexpr long N_PARAMS = g_off(19);

template <int L> struct Lyr {
  static constexpr int in = LT.in[L];
  static constexpr int out = LT.out[L];
  static constexpr long w = w_off(L);
  static constexpr long b = b_off(L);
  static constexpr long g = g_off(L);
  static constexpr long db = g_off(L) + (long)LT.in[L] * LT.out[L];
};

// stash_cd column of the post-activation of implicit layer l (0..7)
__host__ __device__ constexpr int soff(int l) { return l <= 3 ? 256 * l : 256 * l - 39; }
constexpr int W_CD = 4057;   // stash_cd width
constexpr int W_F32 = 296;   // stash_f32 width: embedding (39) + z8 (257)
constexpr int S_RENDER = 2009;
constexpr int S_ATTR = 3033;

// ---------------------------------------------------------------------------
// block-wide tile products (no barrier inside; callers sync around them)
// ---------------------------------------------------------------------------

// epi(t, n, sum) for t < TT, n < N with sum = sum_k A[t*lda+k] * M[k*ldm+n].
// A: shared, 16-byte aligned rows (lda % 4 == 0). M: global, CD.
template <typename CD, typename Epi>
__device__ __forceinline__ void tile_mm(const float* __restrict__ A, int lda,
                                        const CD* __restrict__ M, int ldm, int K, int N,
                                        Epi epi) {
  for (int n = threadIdx.x; n < N; n += NT) {
    float acc[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = 0.f;
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      const float w0 = to_f(M[(long)(k + 0) * ldm + n]);
      const float w1 = to_f(M[(long)(k + 1) * ldm + n]);
      const float w2 = to_f(M[(long)(k + 2) * ldm + n]);
      const float w3 = to_f(M[(long)(k + 3) * ldm + n]);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const float4 a = *reinterpret_cast<const float4*>(A + t * lda + k);
        acc[t] = fmaf(a.x, w0, acc[t]);
        acc[t] = fmaf(a.y, w1, acc[t]);
        acc[t] = fmaf(a.z, w2, acc[t]);
        acc[t] = fmaf(a.w, w3, acc[t]);
      }
    }
    for (; k < K; ++k) {
      const float w = to_f(M[(long)k * ldm + n]);
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] = fmaf(A[t * lda + k], w, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < TT; ++t) epi(t, n, acc[t]);
  }
}

// two products against the same matrix in one pass over it:
// epi(t, n, sum_k A[t][k] M[k][n], sum_k B[t][k] M[k][n]); A and B share lda
template <typename CD, typename Epi>
__device__ __forceinline__ void tile_mm2(const float* __restrict__ A, const float* __restrict__ B,
                                         int lda, const CD* __restrict__ M, int ldm, int K, int N,
                                         Epi epi) {
  for (int n = threadIdx.x; n < N; n += NT) {
    float acc[TT], bcc[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = bcc[t] = 0.f;
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      const float w0 = to_f(M[(long)(k + 0) * ldm + n]);
      const float w1 = to_f(M[(long)(k + 1) * ldm + n]);
      const float w2 = to_f(M[(long)(k + 2) * ldm + n]);
      const float w3 = to_f(M[(long)(k + 3) * ldm + n]);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const float4 a = *reinterpret_cast<const float4*>(A + t * lda + k);
        const float4 b = *reinterpret_cast<const float4*>(B + t * lda + k);
        acc[t] = fmaf(a.x, w0, acc[t]);
        acc[t] = fmaf(a.y, w1, acc[t]);
        acc[t] = fmaf(a.z, w2, acc[t]);
        acc[t] = fmaf(a.w, w3, acc[t]);
        bcc[t] = fmaf(b.x, w0, bcc[t]);
        bcc[t] = fmaf(b.y, w1, bcc[t]);
        bcc[t] = fmaf(b.z, w2, bcc[t]);
        bcc[t] = fmaf(b.w, w3, bcc[t]);
      }
    }
    for (; k < K; ++k) {
      const float w = to_f(M[(long)k * ldm + n]);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        acc[t] = fmaf(A[t * lda + k], w, acc[t]);
        bcc[t] = fmaf(B[t * lda + k], w, bcc[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < TT; ++t) epi(t, n, acc[t], bcc[t]);
  }
}

// D[t][n] <- rnd(D[t][n]) for n < N (row stride LDH), adding the column sums
// taken before rounding into db[n] when db is given (a bias gradient)
template <typename CD>
__device__ __forceinline__ void round_rows(float* D, int N, float* db) {
  for (int n = threadIdx.x; n < N; n += NT) {
    float s = 0.f;
    for (int t = 0; t < TT; ++t) {
      const float v = D[t * LDH + n];
      s += v;
      D[t * LDH + n] = rnd<CD>(v);
    }
    if (db != nullptr) db[n] += s;
  }
  __syncthreads();
}

// J_PE(x)^T cot from the encoding's own sin/cos columns e (multires m)
__device__ __forceinline__ void pe_transpose(const float* cot, const float* e, int m, float* out) {
  for (int c = 0; c < 3; ++c) out[c] = cot[c];
  for (int k = 0; k < m; ++k) {
    const float f = (float)(1 << k);
    for (int c = 0; c < 3; ++c) {
      const float sn = e[3 + 6 * k + c], cs = e[6 + 6 * k + c];
      out[c] = out[c] + f * (cot[3 + 6 * k + c] * cs - cot[6 + 6 * k + c] * sn);
    }
  }
}

// G[k*N + n] += sum_t A1[t*lda1+k] * D1[t*ldd1+n] + A2[t*lda2+k] * D2[t*ldd2+n]
// for k < K, n < N (A2 may be null). Threads walk (8-row group of k, n)
// pairs with n fastest, so the D loads and the G updates are coalesced.
__device__ __forceinline__ void tile_wgrad(float* __restrict__ G, int K, int N,
                                           const float* A1, int lda1, const float* D1, int ldd1,
                                           const float* A2, int lda2, const float* D2, int ldd2) {
  const int nkg = (K + 7) / 8;
  for (int p = threadIdx.x; p < nkg * N; p += NT) {
    const int n = p % N, k0 = (p / N) * 8;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    if (k0 + 8 <= K) {
#pragma unroll 4
      for (int t = 0; t < TT; ++t) {
        const float d = D1[t * ldd1 + n];
        const float4 a0 = *reinterpret_cast<const float4*>(A1 + t * lda1 + k0);
        const float4 a1 = *reinterpret_cast<const float4*>(A1 + t * lda1 + k0 + 4);
        acc[0] = fmaf(a0.x, d, acc[0]); acc[1] = fmaf(a0.y, d, acc[1]);
        acc[2] = fmaf(a0.z, d, acc[2]); acc[3] = fmaf(a0.w, d, acc[3]);
        acc[4] = fmaf(a1.x, d, acc[4]); acc[5] = fmaf(a1.y, d, acc[5]);
        acc[6] = fmaf(a1.z, d, acc[6]); acc[7] = fmaf(a1.w, d, acc[7]);
        if (A2 != nullptr) {
          const float e = D2[t * ldd2 + n];
          const float4 b0 = *reinterpret_cast<const float4*>(A2 + t * lda2 + k0);
          const float4 b1 = *reinterpret_cast<const float4*>(A2 + t * lda2 + k0 + 4);
          acc[0] = fmaf(b0.x, e, acc[0]); acc[1] = fmaf(b0.y, e, acc[1]);
          acc[2] = fmaf(b0.z, e, acc[2]); acc[3] = fmaf(b0.w, e, acc[3]);
          acc[4] = fmaf(b1.x, e, acc[4]); acc[5] = fmaf(b1.y, e, acc[5]);
          acc[6] = fmaf(b1.z, e, acc[6]); acc[7] = fmaf(b1.w, e, acc[7]);
        }
      }
    } else {
      for (int t = 0; t < TT; ++t) {
        const float d = D1[t * ldd1 + n];
        const float e = A2 != nullptr ? D2[t * ldd2 + n] : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (k0 + j < K) {
            acc[j] = fmaf(A1[t * lda1 + k0 + j], d, acc[j]);
            if (A2 != nullptr) acc[j] = fmaf(A2[t * lda2 + k0 + j], e, acc[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (k0 + j < K) G[(long)(k0 + j) * N + n] += acc[j];
  }
}

// one hidden implicit layer: dst = rnd(softplus100(src W_l + b_l)), and the
// post-activation into stash_cd when a stash is given
template <int L, typename CD>
__device__ __forceinline__ void implicit_hidden(const float* src, int lds, float* dst,
                                                const CD* W, const float* B, CD* scd,
                                                long row0, int valid) {
  tile_mm<CD>(src, lds, W + Lyr<L>::w, Lyr<L>::out, Lyr<L>::in, Lyr<L>::out,
              [&](int t, int j, float v) {
                const float h = rnd<CD>(softplus100(v + B[Lyr<L>::b + j]));
                dst[t * LDH + j] = h;
                if (scd != nullptr && t < valid)
                  scd[(row0 + t) * W_CD + soff(L) + j] = from_f<CD>(h);
              });
  __syncthreads();
}

// the skip input of implicit layer 4: [h3 (217), e_cd (39)] * 1/sqrt(2), in CD
// (the JAX code multiplies a CD array by a Python float: the constant is CD too)
template <typename CD>
__device__ __forceinline__ void skip_concat(const float* h3, const float* ecd, float* dst) {
  const float c = rnd<CD>(INV_SQRT2);
  for (int i = threadIdx.x; i < TT * 256; i += NT) {
    const int t = i / 256, j = i % 256;
    dst[t * LDH + j] = j < 217 ? rnd<CD>(h3[t * LDH + j] * c) : rnd<CD>(ecd[t * LDE + j - 217] * c);
  }
  __syncthreads();
}
