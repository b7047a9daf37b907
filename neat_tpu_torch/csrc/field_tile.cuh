// The per-tile bodies of the fused field kernels, shared by the stashing
// pair (K2, fused_field_stash.cu) and the recompute pair (K3, fused_field.cu):
// field_fwd_tile is the forward of one 32-point tile, field_bwd_tile its
// backward from the tile's residuals. The math is field_fwd_res /
// field_bwd_stashed of ops/fused_field_stash.py.
//
// Layers 0..8 are the implicit net, 9..13 the rendering head, 14..18 the
// attraction head (common.cuh: LT). W holds each layer's (in, out) matrix,
// WT its transpose, both in CD; B the f32 biases.
#pragma once

#include "common.cuh"

constexpr int S_ROWS = 8 * TT * 256;  // per-block scratch: the tangent pre-activations

// The split backward's workspace: bf16 rows of np points each, one row per
// feature of each weight-gradient operand. ops/field_dw.py defines its layout
// (ws_row_table) and passes the first row of every operand with the launch:
// layer l's input (in), tangent input (tin, implicit layers 0..7), output
// cotangent (cot) and tangent cotangent (tcot). With EMIT, the backward tile
// stores these operands at its 32 point columns instead of adding its dW into
// the partials.
struct WsOut {
  __nv_bfloat16* p;  // the workspace (in field_bwd_tile: at the tile's first point column)
  long np;           // its row length: the points rounded up to a multiple of 64
  int in[19], tin[8], cot[19], tcot[8];
};

// workspace rows [row, row + w) at the tile's point columns <- src[t][j]
// (row stride ld), already bf16 values; points past the end get zeros
__device__ __forceinline__ void emit_rows(const WsOut& ws, int row, int w, const float* src, int ld,
                                          int valid) {
  for (int i = threadIdx.x; i < w * (TT / 8); i += NT) {  // 8 points (16 bytes) a thread
    const int j = i / (TT / 8), t0 = 8 * (i % (TT / 8));
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = t0 + 2 * q;
      const float a = t < valid ? src[t * ld + j] : 0.f;
      const float b = t + 1 < valid ? src[(t + 1) * ld + j] : 0.f;
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      v[q] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(ws.p + (long)(row + j) * ws.np + t0) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <typename CD>
__device__ __forceinline__ float stash(const CD* scd, long row, int col) {
  return to_f(scd[row * W_CD + col]);
}

// 1 - sigma'(z) = exp(-100 i) for a stashed softplus-100 post-activation i
template <typename CD>
__device__ __forceinline__ float em100(const CD* scd, long row, int col) {
  return expf(-100.f * stash(scd, row, col));
}

// dst[t][0:w] <- the stash columns [col, col + w) of the tile's rows (0 past the end)
template <typename CD>
__device__ __forceinline__ void load_stash(float* dst, const CD* scd, long row0, int valid, int col,
                                           int w) {
  for (int i = threadIdx.x; i < TT * w; i += NT) {
    const int t = i / w, j = i % w;
    dst[t * LDH + j] = t < valid ? stash(scd, row0 + t, col + j) : 0.f;
  }
}

// a head's input row [x, PE_mv(d) (d itself when mv = 0), grads, feats] in CD
template <typename CD>
__device__ __forceinline__ void head_input(float* dst, int mv, const float* X, const float* Dv,
                                           const float* Gr, const float* F, long ldf, int valid) {
  const int nd = 3 * (1 + 2 * mv);
  const int w = 6 + nd + 256;
  for (int i = threadIdx.x; i < TT * w; i += NT) {
    const int t = i / w, j = i % w;
    float v;
    if (j < 3) v = X[t * 4 + j];
    else if (j < 3 + nd) v = pe_val(Dv + t * 4, j - 3);
    else if (j < 6 + nd) v = Gr[t * 4 + j - 3 - nd];
    else v = t < valid ? F[t * ldf + j - 6 - nd] : 0.f;
    dst[t * LDH + j] = rnd<CD>(v);
  }
  __syncthreads();
}

// one relu layer of a head: dst = rnd(relu(src W_L + b_L)), stashed at col
// when STASH
template <int L, typename CD, bool STASH>
__device__ __forceinline__ void head_hidden(const float* src, float* dst, const CD* W,
                                            const float* B, CD* scd, int col, long row0,
                                            int valid) {
  tile_mm<CD>(src, LDH, W + Lyr<L>::w, Lyr<L>::out, Lyr<L>::in, Lyr<L>::out,
              [&](int t, int j, float v) {
                const float h = rnd<CD>(fmaxf(v + B[Lyr<L>::b + j], 0.f));
                dst[t * LDH + j] = h;
                if (STASH && t < valid) scd[(row0 + t) * W_CD + col + j] = from_f<CD>(h);
              });
  __syncthreads();
}

// the forward's spatial-gradient sweep starts from a seed that is one-hot on
// the sdf channel, so its first u is W_8's sdf column, read directly, and
// Vn = rnd(u sigma'_7)
template <typename CD>
__device__ __forceinline__ void grad_seed(float* Vn, const CD* W, const CD* scd, long row0,
                                          int valid) {
  for (int i = threadIdx.x; i < TT * 256; i += NT) {
    const int t = i / 256, j = i % 256;
    const float u = to_f(W[Lyr<8>::w + (long)j * Lyr<8>::out]);
    const float s = t < valid ? 1.f - em100(scd, row0 + t, soff(7) + j) : 0.f;
    Vn[t * LDH + j] = rnd<CD>(u * s);
  }
  __syncthreads();
}

// one later step of the sweep: u = V W_L^T, then the cotangent of layer
// L-1's pre-activation rnd(u sigma'), or (L = 4, L = 0) the embedding's
// share into CE
template <int L, typename CD>
__device__ __forceinline__ void grad_sweep(const float* V, float* Vn, float* CE, const CD* WT,
                                           const CD* scd, long row0, int valid) {
  tile_mm<CD>(V, LDH, WT + Lyr<L>::w, Lyr<L>::in, Lyr<L>::out, Lyr<L>::in,
              [&](int t, int j, float u) {
                if constexpr (L == 0) {
                  CE[t * LDE + j] += u;
                } else {
                  float a = u;
                  if constexpr (L == 4) {
                    if (j >= 217) {
                      CE[t * LDE + j - 217] += u * INV_SQRT2;
                      return;
                    }
                    a = u * INV_SQRT2;
                  }
                  const float s = t < valid ? 1.f - em100(scd, row0 + t, soff(L - 1) + j) : 0.f;
                  Vn[t * LDH + j] = rnd<CD>(a * s);
                }
              });
  __syncthreads();
}

// The forward of one tile: the implicit chain, the sphere clamp, the spatial
// gradient by a reverse sweep over the post-activations just written to scd,
// and the two heads. x and d are the whole arrays (rows row0 .. row0 + valid);
// o_* (o_sdf and o_att may be null: not stored), scd and sf32 start at the
// tile's first row. scd always takes the eight implicit post-activations,
// which the sweep re-reads; FULL also stashes the heads' activations, the f32
// embedding and z8. smem: FWD_SMEM bytes. Ends without a barrier.
template <typename CD, bool FULL>
__device__ __forceinline__ void field_fwd_tile(const float* __restrict__ x,
                                               const float* __restrict__ d,
                                               const CD* __restrict__ W,
                                               const CD* __restrict__ WT,
                                               const float* __restrict__ B, float* o_sdf,
                                               float* o_grads, float* o_rgb, float* o_att,
                                               CD* scd, float* sf32, long row0, int valid,
                                               float radius, float scale, float* smem) {
  float* X = smem;                             // TT x 4 points
  float* Dv = X + TT * 4;                      // TT x 4 directions
  float* G = Dv + TT * 4;                      // TT x 4 spatial gradients
  float* PT = G + TT * 4;                      // TT x 4: m_raw, m_sph, |x|
  float* E = PT + TT * 4;                      // TT x LDE embedding (f32)
  float* Ec = E + TT * LDE;                    // TT x LDE embedding (CD)
  float* CE = Ec + TT * LDE;                   // TT x LDE its cotangent
  float* H0 = CE + TT * LDE;                   // TT x LDH
  float* H1 = H0 + TT * LDH;                   // TT x LDH
  float* Z = H1 + TT * LDH;                    // TT x LDH: z8 = [sdf_raw, feats]
  const int tid = threadIdx.x;
  constexpr long s0 = 0;  // scd and sf32 start at the tile's first row

  // rows past the end carry x = 1, d = 0 and are never stored
  for (int i = tid; i < TT * 4; i += NT) {
    const int t = i / 4, c = i % 4;
    const bool ok = t < valid && c < 3;
    X[i] = ok ? x[(row0 + t) * 3 + c] : 1.f;
    Dv[i] = ok ? d[(row0 + t) * 3 + c] : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < TT * LDE; i += NT) {
    const int t = i / LDE, j = i % LDE;
    const float v = j < 39 ? pe_val(X + t * 4, j) : 0.f;
    E[i] = v;
    Ec[i] = rnd<CD>(v);
    CE[i] = 0.f;
    if (FULL && j < 39 && t < valid) sf32[t * W_F32 + j] = v;
  }
  __syncthreads();

  // ---- implicit chain, stashing every post-activation ----
  implicit_hidden<0, CD>(Ec, LDE, H0, W, B, scd, s0, valid);
  implicit_hidden<1, CD>(H0, LDH, H1, W, B, scd, s0, valid);
  implicit_hidden<2, CD>(H1, LDH, H0, W, B, scd, s0, valid);
  implicit_hidden<3, CD>(H0, LDH, H1, W, B, scd, s0, valid);
  skip_concat<CD>(H1, Ec, H0);
  implicit_hidden<4, CD>(H0, LDH, H1, W, B, scd, s0, valid);
  implicit_hidden<5, CD>(H1, LDH, H0, W, B, scd, s0, valid);
  implicit_hidden<6, CD>(H0, LDH, H1, W, B, scd, s0, valid);
  implicit_hidden<7, CD>(H1, LDH, H0, W, B, scd, s0, valid);
  tile_mm<CD>(H0, LDH, W + Lyr<8>::w, 257, 256, 257, [&](int t, int j, float v) {
    const float z = v + B[Lyr<8>::b + j];
    Z[t * LDH + j] = z;
    if (FULL && t < valid) sf32[t * W_F32 + 39 + j] = z;
  });
  __syncthreads();

  // ---- sphere clamp with balanced tie multipliers ----
  if (tid < TT) {
    const float* xt = X + tid * 4;
    const float nx = sqrtf(xt[0] * xt[0] + xt[1] * xt[1] + xt[2] * xt[2]);
    const float sph = scale * (radius - nx);
    const float raw = Z[tid * LDH];
    PT[tid * 4 + 0] = raw < sph ? 1.f : (raw == sph ? 0.5f : 0.f);
    PT[tid * 4 + 1] = sph < raw ? 1.f : (raw == sph ? 0.5f : 0.f);
    PT[tid * 4 + 2] = nx;
    if (o_sdf != nullptr && tid < valid) o_sdf[tid] = fminf(raw, sph);
  }
  // ---- spatial gradient: sdf-seeded reverse sweep over the stash ----
  grad_seed<CD>(H0, W, scd, s0, valid);
  grad_sweep<7, CD>(H0, H1, CE, WT, scd, s0, valid);
  grad_sweep<6, CD>(H1, H0, CE, WT, scd, s0, valid);
  grad_sweep<5, CD>(H0, H1, CE, WT, scd, s0, valid);
  grad_sweep<4, CD>(H1, H0, CE, WT, scd, s0, valid);
  grad_sweep<3, CD>(H0, H1, CE, WT, scd, s0, valid);
  grad_sweep<2, CD>(H1, H0, CE, WT, scd, s0, valid);
  grad_sweep<1, CD>(H0, H1, CE, WT, scd, s0, valid);
  grad_sweep<0, CD>(H1, H0, CE, WT, scd, s0, valid);
  if (tid < TT) {
    float g[3];
    pe_transpose(CE + tid * LDE, E + tid * LDE, 6, g);
    const float nx = PT[tid * 4 + 2];
    for (int c = 0; c < 3; ++c) {
      const float gs = -scale * X[tid * 4 + c] / nx;
      const float gc = PT[tid * 4] * g[c] + PT[tid * 4 + 1] * gs;
      G[tid * 4 + c] = gc;
      if (tid < valid) o_grads[tid * 3 + c] = gc;
    }
  }
  __syncthreads();

  // ---- rendering head: (x, PE4(d), grads, feats) -> 4 x relu -> 3, sigmoid ----
  head_input<CD>(H0, 4, X, Dv, G, Z + 1, LDH, TT);
  head_hidden<9, CD, FULL>(H0, H1, W, B, scd, S_RENDER, s0, valid);
  head_hidden<10, CD, FULL>(H1, H0, W, B, scd, S_RENDER + 256, s0, valid);
  head_hidden<11, CD, FULL>(H0, H1, W, B, scd, S_RENDER + 512, s0, valid);
  head_hidden<12, CD, FULL>(H1, H0, W, B, scd, S_RENDER + 768, s0, valid);
  tile_mm<CD>(H0, LDH, W + Lyr<13>::w, 3, 256, 3, [&](int t, int j, float v) {
    if (t < valid) o_rgb[t * 3 + j] = 1.f / (1.f + expf(-(v + B[Lyr<13>::b + j])));
  });
  __syncthreads();
  // ---- attraction head: (x, d, grads, feats) -> 4 x relu -> 6 offsets ----
  head_input<CD>(H1, 0, X, Dv, G, Z + 1, LDH, TT);
  head_hidden<14, CD, FULL>(H1, H0, W, B, scd, S_ATTR, s0, valid);
  head_hidden<15, CD, FULL>(H0, H1, W, B, scd, S_ATTR + 256, s0, valid);
  head_hidden<16, CD, FULL>(H1, H0, W, B, scd, S_ATTR + 512, s0, valid);
  head_hidden<17, CD, FULL>(H0, H1, W, B, scd, S_ATTR + 768, s0, valid);
  tile_mm<CD>(H1, LDH, W + Lyr<18>::w, 6, 256, 6, [&](int t, int j, float v) {
    if (o_att != nullptr && t < valid) o_att[t * 6 + j] = v + B[Lyr<18>::b + j];
  });
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// a head's hidden layer L going down: dW_L += post_{L-1}^T delta_L, then
// delta_{L-1} = (delta_L W_L^T) * (post_{L-1} > 0), with its bias gradient
template <int L, typename CD, bool EMIT = false>
__device__ __forceinline__ void head_bwd_step(float*& Dr, float* BA, float*& Dn, const CD* WT,
                                              float* Gp, const CD* scd, int col, long row0,
                                              int valid, const WsOut& ws) {
  load_stash<CD>(BA, scd, row0, valid, col, 256);
  __syncthreads();
  if constexpr (EMIT) {
    emit_rows(ws, ws.in[L], 256, BA, LDH, valid);
    emit_rows(ws, ws.cot[L], Lyr<L>::out, Dr, LDH, valid);
  } else {
    tile_wgrad(Gp + Lyr<L>::g, 256, Lyr<L>::out, BA, LDH, Dr, LDH, nullptr, 0, nullptr, 0);
  }
  tile_mm<CD>(Dr, LDH, WT + Lyr<L>::w, 256, Lyr<L>::out, 256, [&](int t, int j, float v) {
    Dn[t * LDH + j] = BA[t * LDH + j] > 0.f ? v : 0.f;
  });
  __syncthreads();
  round_rows<CD>(Dn, 256, Gp + Lyr<L - 1>::db);
  float* tmp = Dr;
  Dr = Dn;
  Dn = tmp;
}

// the whole head backward; Dr holds the output layer's rounded delta on entry.
// Returns the buffer holding the f32 cotangent of the head input.
template <int L0, typename CD, bool EMIT = false>
__device__ __forceinline__ float* head_bwd(float* Dr, float* BA, float* Dn, int mv, int col,
                                           const CD* WT, float* Gp, const CD* scd, long row0,
                                           int valid, const float* X, const float* Dv,
                                           const float* Gr, const float* F, const WsOut& ws) {
  head_bwd_step<L0 + 4, CD, EMIT>(Dr, BA, Dn, WT, Gp, scd, col + 768, row0, valid, ws);
  head_bwd_step<L0 + 3, CD, EMIT>(Dr, BA, Dn, WT, Gp, scd, col + 512, row0, valid, ws);
  head_bwd_step<L0 + 2, CD, EMIT>(Dr, BA, Dn, WT, Gp, scd, col + 256, row0, valid, ws);
  head_bwd_step<L0 + 1, CD, EMIT>(Dr, BA, Dn, WT, Gp, scd, col, row0, valid, ws);
  head_input<CD>(BA, mv, X, Dv, Gr, F, W_F32, valid);
  if constexpr (EMIT) {
    emit_rows(ws, ws.in[L0], Lyr<L0>::in, BA, LDH, valid);
    emit_rows(ws, ws.cot[L0], 256, Dr, LDH, valid);
  } else {
    tile_wgrad(Gp + Lyr<L0>::g, Lyr<L0>::in, 256, BA, LDH, Dr, LDH, nullptr, 0, nullptr, 0);
  }
  tile_mm<CD>(Dr, LDH, WT + Lyr<L0>::w, Lyr<L0>::in, 256, Lyr<L0>::in,
              [&](int t, int j, float v) { Dn[t * LDH + j] = v; });
  __syncthreads();
  return Dn;
}

// one tangent-forward layer: zdot_L = hdot_L W_L (kept in the scratch),
// hdot_{L+1} = rnd(sigma'_L zdot_L)
template <int L, typename CD>
__device__ __forceinline__ void tangent_layer(const float* src, int lds, float* dst, const CD* W,
                                              float* ZD, const CD* scd, long row0, int valid) {
  tile_mm<CD>(src, lds, W + Lyr<L>::w, Lyr<L>::out, Lyr<L>::in, Lyr<L>::out,
              [&](int t, int j, float z) {
                ZD[L * TT * 256 + t * 256 + j] = z;
                const float s = t < valid ? 1.f - em100(scd, row0 + t, soff(L) + j) : 0.f;
                dst[t * LDH + j] = rnd<CD>(s * z);
              });
  __syncthreads();
}

// one layer of the combined primal + tangent reverse sweep. On entry Vr, VDr
// hold layer L's rounded output cotangents and A1, A2 its primal and tangent
// inputs; on exit (L > 0) the same roles for layer L - 1.
template <int L, typename CD, bool EMIT = false>
__device__ __forceinline__ void sweep_layer(float*& Vr, float*& VDr, float*& A1, float*& A2,
                                            const float* Ec, const float* EDc, float* CE,
                                            float* CED, const CD* WT, float* Gp, const float* ZD,
                                            const CD* scd, long row0, int valid, const WsOut& ws) {
  constexpr int in = Lyr<L>::in, out = Lyr<L>::out;
  if constexpr (EMIT && L < 8) {
    emit_rows(ws, ws.in[L], in, L == 0 ? Ec : A1, L == 0 ? LDE : LDH, valid);
    emit_rows(ws, ws.tin[L], in, L == 0 ? EDc : A2, L == 0 ? LDE : LDH, valid);
    emit_rows(ws, ws.cot[L], out, Vr, LDH, valid);
    emit_rows(ws, ws.tcot[L], out, VDr, LDH, valid);
  }
  if constexpr (L == 0) {
    if constexpr (!EMIT) tile_wgrad(Gp + Lyr<0>::g, in, out, Ec, LDE, Vr, LDH, EDc, LDE, VDr, LDH);
    tile_mm2<CD>(Vr, VDr, LDH, WT + Lyr<0>::w, in, out, in, [&](int t, int j, float u, float ud) {
      CE[t * LDE + j] += u;
      CED[t * LDE + j] += ud;
    });
    __syncthreads();
  } else {
    if constexpr (L == 8) {
      // the tangent seed is one-hot on the sdf channel (valid rows only):
      // its dW is column 0 alone
      if constexpr (EMIT) {
        emit_rows(ws, ws.in[8], in, A1, LDH, valid);
        emit_rows(ws, ws.cot[8], out, Vr, LDH, valid);
      } else {
        tile_wgrad(Gp + Lyr<8>::g, in, out, A1, LDH, Vr, LDH, nullptr, 0, nullptr, 0);
      }
      __syncthreads();
      for (int k = threadIdx.x; k < in; k += NT) {
        float s = 0.f;
        for (int t = 0; t < TT; ++t) s = fmaf(A2[t * LDH + k], VDr[t * LDH], s);
        Gp[Lyr<8>::g + (long)k * out] += s;
      }
    } else if constexpr (!EMIT) {
      tile_wgrad(Gp + Lyr<L>::g, in, out, A1, LDH, Vr, LDH, A2, LDH, VDr, LDH);
    }
    __syncthreads();
    float* nv = A1;
    float* nvd = A2;
    auto epi = [&](int t, int j, float u, float ud) {
      float uh = u, udh = ud;
      if constexpr (L == 4) {
        if (j >= 217) {
          CE[t * LDE + j - 217] += u * INV_SQRT2;
          CED[t * LDE + j - 217] += ud * INV_SQRT2;
          return;
        }
        uh = u * INV_SQRT2;
        udh = ud * INV_SQRT2;
      }
      float v = 0.f, vd = 0.f;
      if (t < valid) {
        const float em = em100(scd, row0 + t, soff(L - 1) + j);
        const float s = 1.f - em;
        const float spp = 100.f * s * em;
        const float zd = ZD[(L - 1) * TT * 256 + t * 256 + j];
        v = uh * s + udh * spp * zd;
        vd = udh * s;
      }
      nv[t * LDH + j] = v;
      nvd[t * LDH + j] = vd;
    };
    if constexpr (L == 8) {
      // ... and its transposed product is W_8's sdf column
      tile_mm<CD>(Vr, LDH, WT + Lyr<8>::w, in, out, in, [&](int t, int j, float u) {
        epi(t, j, u, VDr[t * LDH] * to_f(WT[Lyr<8>::w + j]));
      });
    } else {
      tile_mm2<CD>(Vr, VDr, LDH, WT + Lyr<L>::w, in, out, in, epi);
    }
    __syncthreads();
    constexpr int wv = L == 4 ? 217 : in;
    round_rows<CD>(nv, wv, Gp + Lyr<L - 1>::db);
    round_rows<CD>(nvd, wv, nullptr);
    if constexpr (L > 1) {
      // inputs of layer L - 1: the primal post-activation and rnd(sigma' zdot)
      constexpr int P = L - 2;  // the layer whose output feeds layer L - 1
      for (int i = threadIdx.x; i < TT * 256; i += NT) {
        const int t = i / 256, j = i % 256;
        float a = 0.f, b = 0.f;
        if constexpr (L - 1 == 4) {
          const float c = rnd<CD>(INV_SQRT2);
          if (j < 217) {
            if (t < valid) {
              const float h = stash(scd, row0 + t, soff(3) + j);
              const float s = 1.f - em100(scd, row0 + t, soff(3) + j);
              a = rnd<CD>(h * c);
              b = rnd<CD>(rnd<CD>(s * ZD[3 * TT * 256 + t * 256 + j]) * c);
            }
          } else {
            a = rnd<CD>(Ec[t * LDE + j - 217] * c);
            b = rnd<CD>(EDc[t * LDE + j - 217] * c);
          }
        } else {
          if (t < valid) {
            const float h = stash(scd, row0 + t, soff(P) + j);
            const float s = 1.f - em100(scd, row0 + t, soff(P) + j);
            a = h;
            b = rnd<CD>(s * ZD[P * TT * 256 + t * 256 + j]);
          }
        }
        Vr[t * LDH + j] = a;
        VDr[t * LDH + j] = b;
      }
      __syncthreads();
    }
    A1 = Vr;
    A2 = VDr;
    Vr = nv;
    VDr = nvd;
  }
}

// The backward of one tile from its residuals. x, d, the cotangents c_* and
// the outputs dx_out, dd_out are the whole arrays (rows row0 .. row0 + valid);
// scd, sf32, rgb and grads start at the tile's first row. They carry no
// __restrict__: the recompute kernel rewrites them between tiles. Gp is this
// block's partial of the parameter gradients, ZD its S_ROWS floats of scratch.
// smem: BWD_SMEM bytes. Ends with a barrier.
template <typename CD, bool EMIT = false>
__device__ __forceinline__ void field_bwd_tile(
    const float* __restrict__ x, const float* __restrict__ d, const CD* scd, const float* sf32,
    const float* rgb, const float* grads, const float* __restrict__ c_sdf,
    const float* __restrict__ c_g, const float* __restrict__ c_rgb,
    const float* __restrict__ c_att, const CD* __restrict__ W, const CD* __restrict__ WT,
    float* __restrict__ dx_out, float* __restrict__ dd_out, float* Gp, float* ZD, long row0,
    int valid, float radius, float scale, float* smem, WsOut ws = WsOut{}) {
  if constexpr (EMIT) ws.p += row0;  // the tile's point columns
  float* X = smem;                             // TT x 4 points
  float* Dv = X + TT * 4;                      // TT x 4 directions
  float* Gr = Dv + TT * 4;                     // TT x 4 forward spatial gradients
  float* CG = Gr + TT * 4;                     // TT x 4 total cotangent on grads (C_g)
  float* CGM = CG + TT * 4;                    // TT x 4 its implicit-branch share
  float* DXa = CGM + TT * 4;                   // TT x 4 head terms of dx
  float* PT = DXa + TT * 4;                    // TT x 4: m_raw, m_sph, |x|, c_sdf
  float* RG = PT + TT * 4;                     // TT x 4 rgb
  float* CR = RG + TT * 4;                     // TT x 4 c_rgb
  float* CA = CR + TT * 4;                     // TT x 8 c_att
  float* E = CA + TT * 8;                      // TT x LDE embedding (f32)
  float* Ec = E + TT * LDE;                    // TT x LDE embedding (CD)
  float* EDc = Ec + TT * LDE;                  // TT x LDE tangent embedding (CD)
  float* CE = EDc + TT * LDE;                  // TT x LDE cotangent of the embedding
  float* CED = CE + TT * LDE;                  // ... and of the tangent embedding
  float* B0 = CED + TT * LDE;                  // 4 x (TT x LDH) rotating buffers
  float* B1 = B0 + TT * LDH;
  float* B2 = B1 + TT * LDH;
  float* B3 = B2 + TT * LDH;
  const int tid = threadIdx.x;
  constexpr long s0 = 0;  // scd, sf32, rgb and grads start at the tile's first row
  // rows past the end: x = 1, everything else 0, so they add nothing
  for (int i = tid; i < TT * 4; i += NT) {
    const int t = i / 4, c = i % 4;
    const bool ok = t < valid && c < 3;
    const long r = (row0 + t) * 3 + c;
    X[i] = ok ? x[r] : 1.f;
    Dv[i] = ok ? d[r] : 0.f;
    Gr[i] = ok ? grads[t * 3 + c] : 0.f;
    CG[i] = ok ? c_g[r] : 0.f;
    RG[i] = ok ? rgb[t * 3 + c] : 0.f;
    CR[i] = ok ? c_rgb[r] : 0.f;
  }
  for (int i = tid; i < TT * 8; i += NT) {
    const int t = i / 8, c = i % 8;
    CA[i] = (t < valid && c < 6) ? c_att[(row0 + t) * 6 + c] : 0.f;
  }
  for (int i = tid; i < TT * LDE; i += NT) {
    const int t = i / LDE, j = i % LDE;
    const float v = (t < valid && j < 39) ? sf32[t * W_F32 + j] : 0.f;
    E[i] = v;
    Ec[i] = rnd<CD>(v);
    CE[i] = 0.f;
    CED[i] = 0.f;
  }
  __syncthreads();
  if (tid < TT) {
    const float* xt = X + tid * 4;
    const float nx = sqrtf(xt[0] * xt[0] + xt[1] * xt[1] + xt[2] * xt[2]);
    const float sph = scale * (radius - nx);
    const float raw = tid < valid ? sf32[tid * W_F32 + 39] : 0.f;
    PT[tid * 4 + 0] = raw < sph ? 1.f : (raw == sph ? 0.5f : 0.f);
    PT[tid * 4 + 1] = sph < raw ? 1.f : (raw == sph ? 0.5f : 0.f);
    PT[tid * 4 + 2] = nx;
    PT[tid * 4 + 3] = tid < valid ? c_sdf[row0 + tid] : 0.f;
  }
  const float* F = sf32 + 40;  // the tile's feats (z8[1:])

  // ---- heads backward ----
  for (int i = tid; i < TT * 3; i += NT) {
    const int t = i / 3, j = i % 3;
    const float r = RG[t * 4 + j];
    B0[t * LDH + j] = CR[t * 4 + j] * r * (1.f - r);
  }
  __syncthreads();
  round_rows<CD>(B0, 3, Gp + Lyr<13>::db);
  float* cot_r =
      head_bwd<9, CD, EMIT>(B0, B1, B2, 4, S_RENDER, WT, Gp, scd, s0, valid, X, Dv, Gr, F, ws);
  float* free_r = cot_r == B2 ? B0 : B2;
  for (int i = tid; i < TT * 6; i += NT) {
    const int t = i / 6, j = i % 6;
    free_r[t * LDH + j] = CA[t * 8 + j];
  }
  __syncthreads();
  round_rows<CD>(free_r, 6, Gp + Lyr<18>::db);
  float* cot_a =
      head_bwd<14, CD, EMIT>(free_r, B1, B3, 0, S_ATTR, WT, Gp, scd, s0, valid, X, Dv, Gr, F, ws);

  // cot_r: [x 3, PE4(d) 27, grads 3, feats 256]; cot_a: [x 3, d 3, grads 3, feats 256]
  if (tid < TT) {
    const int t = tid;
    const float* cr = cot_r + t * LDH;
    const float* ca = cot_a + t * LDH;
    float ed[27], pd[3];
    for (int j = 0; j < 27; ++j) ed[j] = pe_val(Dv + t * 4, j);
    pe_transpose(cr + 3, ed, 4, pd);
    for (int c = 0; c < 3; ++c) {
      if (t < valid) dd_out[(row0 + t) * 3 + c] = ca[3 + c] + pd[c];
      const float cg = CG[t * 4 + c] + cr[30 + c] + ca[6 + c];
      CG[t * 4 + c] = cg;
      CGM[t * 4 + c] = cg * PT[t * 4];
      DXa[t * 4 + c] = cr[c] + ca[c];
    }
  }
  __syncthreads();
  // seeds of the implicit sweep: v = [c_sdf m_raw, C_f], vdot = e_0; and the
  // tangent embedding edot = J_PE(x) Cg_mlp, in CD
  float* seed_v = cot_r == B0 ? B1 : B0;  // neither head cotangent
  for (int i = tid; i < TT * 257; i += NT) {
    const int t = i / 257, j = i % 257;
    seed_v[t * LDH + j] = j == 0 ? PT[t * 4 + 3] * PT[t * 4]
                                 : cot_r[t * LDH + 32 + j] + cot_a[t * LDH + 8 + j];
  }
  for (int i = tid; i < TT * LDE; i += NT) {
    const int t = i / LDE, j = i % LDE;
    float v = 0.f;
    if (j < 3) {
      v = CGM[t * 4 + j];
    } else if (j < 39) {
      const int k = (j - 3) / 6, r = (j - 3) % 6, c = r % 3;
      const float f = (float)(1 << k);
      const float xd = CGM[t * 4 + c];
      // f cos(f x) xdot and -f sin(f x) xdot from the stashed sin/cos columns
      v = r < 3 ? f * E[t * LDE + j + 3] * xd : -f * E[t * LDE + j - 3] * xd;
    }
    EDc[i] = rnd<CD>(v);
  }
  __syncthreads();
  round_rows<CD>(seed_v, 257, Gp + Lyr<8>::db);
  // the other three buffers: vdot seed and the tangent chain's ping-pong
  float* rest[3];
  {
    int k = 0;
    float* all[4] = {B0, B1, B2, B3};
    for (int b = 0; b < 4; ++b)
      if (all[b] != seed_v) rest[k++] = all[b];
  }
  float* seed_vd = rest[0];
  float* T0 = rest[1];
  float* T1 = rest[2];

  // ---- tangent forward over the stashed activations (xdot = Cg_mlp) ----
  tangent_layer<0, CD>(EDc, LDE, T0, W, ZD, scd, s0, valid);
  tangent_layer<1, CD>(T0, LDH, T1, W, ZD, scd, s0, valid);
  tangent_layer<2, CD>(T1, LDH, T0, W, ZD, scd, s0, valid);
  tangent_layer<3, CD>(T0, LDH, T1, W, ZD, scd, s0, valid);
  skip_concat<CD>(T1, EDc, T0);
  tangent_layer<4, CD>(T0, LDH, T1, W, ZD, scd, s0, valid);
  tangent_layer<5, CD>(T1, LDH, T0, W, ZD, scd, s0, valid);
  tangent_layer<6, CD>(T0, LDH, T1, W, ZD, scd, s0, valid);
  tangent_layer<7, CD>(T1, LDH, T0, W, ZD, scd, s0, valid);  // T0 = tangent input of layer 8
  for (int i = tid; i < TT * LDH; i += NT) {
    const int t = i / LDH, j = i % LDH;
    seed_vd[i] = (j == 0 && t < valid) ? 1.f : 0.f;
  }
  load_stash<CD>(T1, scd, s0, valid, soff(7), 256);  // primal input of layer 8
  __syncthreads();

  // ---- combined primal + tangent reverse sweep ----
  float* Vr = seed_v;
  float* VDr = seed_vd;
  float* A1 = T1;
  float* A2 = T0;
  sweep_layer<8, CD, EMIT>(Vr, VDr, A1, A2, Ec, EDc, CE, CED, WT, Gp, ZD, scd, s0, valid, ws);
  sweep_layer<7, CD, EMIT>(Vr, VDr, A1, A2, Ec, EDc, CE, CED, WT, Gp, ZD, scd, s0, valid, ws);
  sweep_layer<6, CD, EMIT>(Vr, VDr, A1, A2, Ec, EDc, CE, CED, WT, Gp, ZD, scd, s0, valid, ws);
  sweep_layer<5, CD, EMIT>(Vr, VDr, A1, A2, Ec, EDc, CE, CED, WT, Gp, ZD, scd, s0, valid, ws);
  sweep_layer<4, CD, EMIT>(Vr, VDr, A1, A2, Ec, EDc, CE, CED, WT, Gp, ZD, scd, s0, valid, ws);
  sweep_layer<3, CD, EMIT>(Vr, VDr, A1, A2, Ec, EDc, CE, CED, WT, Gp, ZD, scd, s0, valid, ws);
  sweep_layer<2, CD, EMIT>(Vr, VDr, A1, A2, Ec, EDc, CE, CED, WT, Gp, ZD, scd, s0, valid, ws);
  sweep_layer<1, CD, EMIT>(Vr, VDr, A1, A2, Ec, EDc, CE, CED, WT, Gp, ZD, scd, s0, valid, ws);
  sweep_layer<0, CD, EMIT>(Vr, VDr, A1, A2, Ec, EDc, CE, CED, WT, Gp, ZD, scd, s0, valid, ws);

  // ---- dx: PE transposes and the sphere branch ----
  if (tid < valid) {
    const int t = tid;
    const float* e = E + t * LDE;
    const float* xt = X + t * 4;
    float p[3];
    pe_transpose(CE + t * LDE, e, 6, p);
    float q[3] = {0.f, 0.f, 0.f};
    for (int k = 0; k < 6; ++k) {
      const float f = (float)(1 << k);
      for (int c = 0; c < 3; ++c) {
        const float cs = CED[t * LDE + 3 + 6 * k + c], cc = CED[t * LDE + 6 + 6 * k + c];
        q[c] = q[c] + f * f * (-cs * e[3 + 6 * k + c] - cc * e[6 + 6 * k + c]) * CGM[t * 4 + c];
      }
    }
    const float m_sph = PT[t * 4 + 1], nx = PT[t * 4 + 2], csdf = PT[t * 4 + 3];
    const float* cg = CG + t * 4;
    const float xdotc = xt[0] * cg[0] + xt[1] * cg[1] + xt[2] * cg[2];
    for (int c = 0; c < 3; ++c) {
      float v = DXa[t * 4 + c] + p[c];
      v = v + q[c];
      v = v + csdf * m_sph * (-scale) * xt[c] / nx;
      v = v + m_sph * (-scale) * (cg[c] / nx - xt[c] * xdotc / (nx * nx * nx));
      dx_out[(row0 + t) * 3 + c] = v;
    }
  }
  __syncthreads();
}

// out[i] = sum of the blocks' partials, in block order (deterministic)
__global__ void sum_partials(const float* __restrict__ partials, float* __restrict__ out,
                             int n_blocks) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N_PARAMS) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partials[(long)b * N_PARAMS + i];
  out[i] = s;
}

constexpr size_t FWD_SMEM = sizeof(float) * (TT * 4 * 4 + 3 * TT * LDE + 3 * TT * LDH);
constexpr size_t BWD_SMEM = sizeof(float) * (TT * 4 * 9 + TT * 8 + 5 * TT * LDE + 4 * TT * LDH);

// blocks of a persistent kernel for n points: one per SM at most, none idle
static int persistent_blocks(int n, int max_blocks) {
  return max(1, min(max_blocks, (n + TT - 1) / TT));
}
