// K4: one refinement round of the error-bounded sampler for all rays.
// Replaces neat_tpu/ops/fused_round.py:_round_kernel; the math is
// fused_round_plain of ops/fused_round.py, which also holds the design note.
//
// What bounds it on the H100: its instructions, not its bytes. Per sample,
// each evaluation of the error bound takes 4 expf and 4 IEEE divisions (one
// MUFU operation each, EX2 or RCP) among some hundred other instructions:
// expf's range reduction, each division's Newton steps and its check for the
// slow path. A round needs 11 evaluations on a ray whose beta0 check fails
// (beta0, then 10 bisection steps) and 1 on a ray whose check passes, since
// every step after it keeps beta0; the weights add 3 expf and 2 divisions a
// sample, the refinement pdf 2 expf and 3 divisions, d* one sqrtf and one
// division: 95 special-function operations a sample without refine and 100
// with it when every check fails. At 16 a clock on each of 132 SMs at 1.98
// GHz that is about 15 us at 1024 x 640, five times the time the round's
// four (R, S) f32 arrays take to cross device memory.
//
// One 128-thread block per ray. Thread t owns the ITEMS = S / 128 consecutive
// samples t * ITEMS ... of its ray and keeps their dists, sdf and d* in
// registers through the convergence check, the bisection and the final
// weights; every error-bound evaluation is two prefix sums (scanned together)
// and a row maximum over the block. A ray whose beta0 check passes skips the
// bisection. One warp a ray, with no block barrier, was measured slower at
// every width the sampler uses (PERF.md): 1024 rays give it 8 warps an SM,
// too few to hide the latency of the instruction chains around each special
// function, where this layout gives 32.
//
// All f32. The file is compiled without fused multiply-adds (ops/_build.py),
// so each product and sum rounds as the plain version's separate operations
// do, and no fast-math intrinsic stands in for expf, a division or sqrtf.
#include <cuda_runtime.h>

constexpr int NT4 = 128;      // threads per ray
constexpr int MAX_ITEMS = 8;  // S <= 1024
constexpr float INF_DIST = 1e10f;

// max that hands a NaN on, as a tensor library's row maximum does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// alpha (0.5 + 0.5 sign(s) expm1(-|s| / beta)), alpha = 1 / beta, without
// expm1: 0.5 exp(-s / beta) for s >= 0, 1 - 0.5 exp(-|s| / beta) below
__device__ __forceinline__ float laplace_density(float s, float beta) {
  const float e = expf(-fabsf(s) / beta);
  return (s >= 0.f ? 0.5f * e : 1.f - 0.5f * e) / beta;
}

// min(exp(v), 1e6) - 1, the clip before the subtraction; a NaN passes
__device__ __forceinline__ float clipped_expm1(float v) {
  const float e = expf(v);
  return (e > 1e6f ? 1e6f : e) - 1.f;
}

// Exclusive prefixes, over the block's threads in order, of each thread's
// totals (a, b). ws: 8 floats of shared memory. One barrier; the caller's next
// barrier comes before ws is written again.
__device__ __forceinline__ void block_scan2(float& a, float& b, float* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float ya = __shfl_up_sync(0xffffffffu, ia, o);
    const float yb = __shfl_up_sync(0xffffffffu, ib, o);
    if (lane >= o) {
      ia = ia + ya;
      ib = ib + yb;
    }
  }
  if (lane == 31) {
    ws[warp] = ia;
    ws[4 + warp] = ib;
  }
  float ea = __shfl_up_sync(0xffffffffu, ia, 1);
  float eb = __shfl_up_sync(0xffffffffu, ib, 1);
  if (lane == 0) ea = eb = 0.f;
  __syncthreads();
  float oa = 0.f, ob = 0.f;
  for (int w = 0; w < warp; ++w) {
    oa = oa + ws[w];
    ob = ob + ws[4 + w];
  }
  a = oa + ea;
  b = ob + eb;
}

// the block's maximum (MAX) or sum of v, for every thread. wm: 4 floats.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* wm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? nan_max(v, y) : v + y;
  }
  if ((threadIdx.x & 31) == 0) wm[threadIdx.x >> 5] = v;
  __syncthreads();
  const float a = MAX ? nan_max(wm[0], wm[1]) : wm[0] + wm[1];
  const float b = MAX ? nan_max(wm[2], wm[3]) : wm[2] + wm[3];
  return MAX ? nan_max(a, b) : a + b;
}

template <int ITEMS>
struct Ray {
  float dist[ITEMS], sdf[ITEMS], dstar[ITEMS];
  bool interval[ITEMS];  // lanes 0 .. S-2

  // err_sec of lane k: exp(-d* / beta) dists^2 / (4 beta^2) on intervals
  __device__ __forceinline__ float err_sec(int k, float beta) const {
    return interval[k] ? expf(-dstar[k] / beta) * (dist[k] * dist[k]) / (4.f * beta * beta) : 0.f;
  }

  // the ray's largest Lemma-2 opacity-error bound at beta
  __device__ __forceinline__ float error_bound(float beta, float* ws, float* wm) const {
    float fe[ITEMS], es[ITEMS], ta = 0.f, tb = 0.f;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      fe[k] = interval[k] ? dist[k] * laplace_density(sdf[k], beta) : 0.f;
      es[k] = err_sec(k, beta);
      ta = ta + fe[k];
      tb = tb + es[k];
    }
    block_scan2(ta, tb, ws);  // now the exclusive prefixes of this thread's first lane
    float m = 0.f;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      tb = tb + es[k];  // inclusive
      const float bound = interval[k] ? clipped_expm1(tb) * expf(-ta) : 0.f;
      m = nan_max(m, bound);
      ta = ta + fe[k];  // exclusive for the next lane
    }
    return block_reduce<true>(m, wm);
  }
};

template <int ITEMS>
__global__ void __launch_bounds__(NT4)
    round_kernel(const float* __restrict__ z, const float* __restrict__ sdf,
                 const float* __restrict__ beta_in, const float* __restrict__ beta0_p,
                 float* __restrict__ beta_out, float* __restrict__ weights,
                 float* __restrict__ pdf, float eps, int beta_iters, float add_tiny,
                 int refine) {
  constexpr int S = ITEMS * NT4;
  __shared__ float sz[S + 1], ss[S + 1], ws[8], wm[4];
  const int tid = threadIdx.x, base = tid * ITEMS;
  const long row = (long)blockIdx.x * S;
  for (int i = tid; i < S; i += NT4) {
    sz[i] = z[row + i];
    ss[i] = sdf[row + i];
  }
  if (tid == 0) sz[S] = ss[S] = 0.f;  // what the shift past the last lane reads
  __syncthreads();

  Ray<ITEMS> ray;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = base + k;
    const float s0 = ss[j], s1 = ss[j + 1];
    const bool iv = j < S - 1;
    const float a = iv ? sz[j + 1] - sz[j] : 0.f;
    const float b = fabsf(s0), c = fabsf(s1);
    // d*: the triangle bound on the distance to the surface inside the interval
    const bool first = a * a + b * b <= c * c;
    const bool second = a * a + c * c <= b * b;
    const float s = (a + b + c) * 0.5f;
    const float area = s * (s - a) * (s - b) * (s - c);
    const float heron = 2.f * sqrtf(fmaxf(area, 0.f)) / fmaxf(a, 1e-12f);
    float ds = first ? b : 0.f;
    ds = second ? c : ds;
    ds = (!first && !second && (b + c - a > 0.f)) ? heron : ds;
    const bool same_sign = (s0 > 0.f && s1 > 0.f) || (s0 < 0.f && s1 < 0.f);
    ray.interval[k] = iv;
    ray.dist[k] = a;
    ray.sdf[k] = s0;
    ray.dstar[k] = (same_sign && iv) ? ds : 0.f;
  }

  // convergence check at beta0, then the bisection line search. Once the
  // check has passed, hi = lo = beta0, and every step's midpoint is
  // 0.5 (beta0 + beta0) = beta0 exactly (any finite beta0 below 2^127), whose
  // bound passed: each step keeps beta0, so the block skips them. curr is the
  // block's maximum, the same in every thread, so the whole block does.
  const float beta0 = beta0_p[0];
  const float curr = ray.error_bound(beta0, ws, wm);
  float hi = curr <= eps ? beta0 : beta_in[blockIdx.x];
  float lo = beta0;
  for (int it = curr <= eps ? beta_iters : 0; it < beta_iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    const bool ok = ray.error_bound(mid, ws, wm) <= eps;
    hi = ok ? mid : hi;
    lo = ok ? lo : mid;
  }
  if (tid == 0) beta_out[blockIdx.x] = hi;

  // volume-rendering weights at the chosen beta; the last lane is an interval
  // of length 1e10 here, and only here
  float fe[ITEMS], es[ITEMS], ta = 0.f, tb = 0.f;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    fe[k] = (ray.interval[k] ? ray.dist[k] : INF_DIST) * laplace_density(ray.sdf[k], hi);
    es[k] = refine ? ray.err_sec(k, hi) : 0.f;
    ta = ta + fe[k];
    tb = tb + es[k];
  }
  block_scan2(ta, tb, ws);
  float p[ITEMS], total = 0.f;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const float transmittance = expf(-ta);
    tb = tb + es[k];
    sz[base + k] = (1.f - expf(-fe[k])) * transmittance;  // z is in registers by now
    // the refinement pdf over intervals: bound_opacity * transmittance (+ add_tiny)
    p[k] = (refine && ray.interval[k]) ? clipped_expm1(tb) * transmittance + add_tiny : 0.f;
    total = total + p[k];
    ta = ta + fe[k];
  }
  if (refine) total = block_reduce<false>(total, wm);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) ss[base + k] = refine ? p[k] / total : 0.f;
  __syncthreads();
  for (int i = tid; i < S; i += NT4) {
    weights[row + i] = sz[i];
    pdf[row + i] = ss[i];
  }
}

template <int ITEMS>
static int launch(const void* z, const void* sdf, const void* beta, const void* beta0,
                  void* beta_out, void* weights, void* pdf, int n_rays, float eps,
                  int beta_iters, float add_tiny, int refine, void* stream) {
  round_kernel<ITEMS><<<n_rays, NT4, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)sdf, (const float*)beta, (const float*)beta0,
      (float*)beta_out, (float*)weights, (float*)pdf, eps, beta_iters, add_tiny, refine);
  return (int)cudaGetLastError();
}

// the widest row the kernel takes, for the wrapper's check
extern "C" int fused_round_max_samples() { return MAX_ITEMS * NT4; }

// z, sdf (n_rays, n_samples) f32 sorted along the row, beta (n_rays,), beta0
// (1,) -> beta_out (n_rays,), weights, pdf (n_rays, n_samples); n_samples a
// multiple of 128 up to fused_round_max_samples()
extern "C" int fused_round(const void* z, const void* sdf, const void* beta, const void* beta0,
                           void* beta_out, void* weights, void* pdf, int n_rays, int n_samples,
                           float eps, int beta_iters, float add_tiny, int refine, void* stream) {
  if (n_samples % NT4 != 0) return (int)cudaErrorInvalidValue;
#define ROUND_CASE(I)                                                                        \
  case I:                                                                                    \
    return launch<I>(z, sdf, beta, beta0, beta_out, weights, pdf, n_rays, eps, beta_iters,   \
                     add_tiny, refine, stream)
  switch (n_samples / NT4) {
    ROUND_CASE(1);
    ROUND_CASE(2);
    ROUND_CASE(3);
    ROUND_CASE(4);
    ROUND_CASE(5);
    ROUND_CASE(6);
    ROUND_CASE(7);
    ROUND_CASE(8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ROUND_CASE
}
