"""K2: the main field pass with a residual stash (K2-fwd) and the backward
that replays it (K2-bwd).

Replaces ``neat_tpu/ops/fused_field_stash.py:_fwd_stash_kernel`` (launched
by ``_fwd_stash_pallas``) and ``_bwd_stash_kernel`` (``_bwd_stash_pallas``)
with the two CUDA kernels in ``csrc/fused_field_stash.cu``. The math is
``field_fwd_res`` and ``field_bwd_stashed`` below, the plain PyTorch
versions of the same functions, line for line with the JAX ones.

Forward, per point: the 9-layer implicit chain (skip at layer 4), the
bounding-sphere min-clamp with balanced tie multipliers, the spatial
gradient by an explicit reverse sweep with sigma' = 1 - exp(-100 i), the
rendering head (x, PE4(d), grad, feats -> 4 x 256 relu -> 3, sigmoid) and
the attraction head (x, d, grad, feats -> 4 x 256 relu -> 6). It stashes
the 16 x 256 post-activations in the compute dtype (``stash_cd``, N x
4057) and the embedding and z8 in f32 (``stash_f32``, N x 296), in the
JAX package's column layout (``_pack_res``).

Backward, per point: the heads' backward, a tangent forward with xdot =
C_g * m_raw over the stashed activations, then one combined primal +
tangent reverse sweep (the second-order term through the inner gradient,
by the JVP identity C_g . grad sdf = d/dt sdf(x + t C_g)), then the PE
transposes and the sphere-branch terms. No forward matmul is recomputed.

What bounds it on the H100: operations. The forward does 3.04 MFLOP per
point and writes 9.3 KB of stash (bf16 activations, f32 embedding and z8);
the backward 7.00 MFLOP per point and reads the stash back. Both count the
last implicit layer's sdf column alone wherever a sweep is seeded on the
sdf channel. At the bf16 tensor-core rate both are operation-bound (0.31
and 0.71 ms at 100,352 points, `chip_smoke.py`); this first kernel runs
scalar f32 FMAs on the CUDA cores, so its ceiling is the 67 TFLOP/s f32
rate.

What the design does about it: one 256-thread block per 32-point tile,
activations and cotangents in shared memory (129 KB forward, 181 KB
backward: one block per SM), one output column per thread with the tile's
32 sums in registers, weights (and their transposes) read from global
memory where they stay L2-resident. The forward re-reads the
post-activations it just stashed for its reverse sweep instead of holding
all eight layers in shared memory. The backward keeps the tangent chain's
eight pre-activations in a per-block f32 scratch in global memory (256 KB
a block, L2-resident) and rebuilds the tangent layer inputs from them.

The one redesign is the parameter gradient. On the TPU the grid runs in
order and the backward adds each tile's dW into one revisited VMEM block.
CUDA blocks run in no order, so the backward kernel is persistent: a fixed
grid of blocks walks the tiles, each block adding into its own f32 partial
of all 38 gradients (~4.25 MB), and a second kernel sums the partials in
block order. That is deterministic run to run and needs no atomics, at
the cost of one partial per block. Padded rows of the last tile carry x = 1, d = 0
and zero cotangents and are masked out of every sum.
"""

from __future__ import annotations

import ctypes
import math
from typing import List

import torch

from ..fields.mlp import ImplicitNetConfig, RenderNetConfig, _skip_concat, _softplus100
from . import _build
from .fused_field import (
    N_HEAD_LAYERS,
    N_IMPLICIT_LAYERS,
    _flatten_eff,
    _pe,
    _unflatten_eff,
    supports_fused_field,
)

INV_SQRT2 = 1.0 / math.sqrt(2.0)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64}


def _balanced(a, b):
    """min(a, b)'s subgradient multiplier for ``a``: 1 where a < b, 0.5 at
    ties, 0 otherwise."""
    one = torch.ones_like(a)
    return torch.where(a < b, one, torch.where(a == b, 0.5 * one, 0.0 * one))


def _mm(h, w, cd, el):
    """dot(h.astype(cd), w.astype(cd)) with el accumulation."""
    return h.to(cd).to(el) @ w.to(cd).to(el)


def _sphere_terms(x, sdf_raw, icfg):
    if icfg.sdf_bounding_sphere > 0.0:
        norm_x = torch.linalg.norm(x, dim=-1, keepdim=True)
        sphere = icfg.sphere_scale * (icfg.sdf_bounding_sphere - norm_x)
        return norm_x, sphere, _balanced(sdf_raw, sphere), _balanced(sphere, sdf_raw)
    return None, None, torch.ones_like(sdf_raw), torch.zeros_like(sdf_raw)


def field_fwd_res(flat_eff, x, d, icfg: ImplicitNetConfig, rcfg: RenderNetConfig, compute_dtype):
    """Forward pass returning ((sdf, grads, rgb, att), residuals); the
    residuals are what ``field_bwd_stashed`` consumes."""
    iw, rw, aw = _unflatten_eff(flat_eff)
    cd = compute_dtype
    el = torch.promote_types(torch.float32, cd)

    e = _pe(x, icfg.multires)
    e_cd = e.to(cd)

    i_post: List[torch.Tensor] = []
    h = e_cd
    for l in range(N_IMPLICIT_LAYERS):
        if l == 4:
            h = _skip_concat(h, e_cd)
        w, b = iw[l]
        z = _mm(h, w, cd, el) + b
        if l < N_IMPLICIT_LAYERS - 1:
            h = _softplus100(z).to(cd)
            i_post.append(h)
    z8 = z
    sdf_raw = z8[..., :1]
    feats = z8[..., 1:]

    norm_x, sphere, m_raw, m_sph = _sphere_terms(x, sdf_raw, icfg)
    sdf = torch.minimum(sdf_raw, sphere) if sphere is not None else sdf_raw

    # inner spatial gradient: ones-seeded reverse sweep; the min-clamp
    # multiplier is applied once, at the grads assembly
    s = [1.0 - torch.exp(-100.0 * ip.to(el)) for ip in i_post]
    v = torch.cat([torch.ones_like(sdf_raw), torch.zeros_like(feats)], dim=-1)
    cot_e = torch.zeros_like(e)
    ne = e.shape[-1]
    for l in range(N_IMPLICIT_LAYERS - 1, -1, -1):
        w, _ = iw[l]
        u = _mm(v, w.T, cd, el)
        if l == 0:
            cot_e = cot_e + u
        elif l == 4:
            u_h = u[..., :-ne] * INV_SQRT2
            cot_e = cot_e + u[..., -ne:] * INV_SQRT2
            v = u_h * s[l - 1]
        else:
            v = u * s[l - 1]
    g_mlp = _pe_transpose(cot_e, e, x, icfg.multires)
    if norm_x is not None:
        g_sphere = -icfg.sphere_scale * x / norm_x
        grads = m_raw * g_mlp + m_sph * g_sphere
    else:
        grads = g_mlp

    d_enc = _pe(d, rcfg.multires_view) if rcfg.multires_view > 0 else d
    r_in = torch.cat([x, d_enc, grads, feats], dim=-1)
    a_in = torch.cat([x, d, grads, feats], dim=-1)

    def head_fwd(weights, inp):
        posts = []
        h = inp.to(cd)
        for l in range(N_HEAD_LAYERS):
            w, b = weights[l]
            h = _mm(h, w, cd, el) + b
            if l < N_HEAD_LAYERS - 1:
                h = torch.clamp(h, min=0.0).to(cd)
                posts.append(h)
        return h, posts

    zr, i_r = head_fwd(rw, r_in)
    rgb = torch.sigmoid(zr)
    att, i_a = head_fwd(aw, a_in)

    res = (e, tuple(i_post), tuple(i_r), tuple(i_a), z8, rgb, grads)
    return (sdf, grads, rgb, att), res


def _pe_transpose(cot_e, e, x, multires):
    """J_PE(x)^T @ cot_e from the stashed sin/cos columns of e."""
    out = cot_e[..., : x.shape[-1]]
    for k in range(multires):
        f = float(2.0**k)
        sin_k = e[..., 3 + 6 * k : 6 + 6 * k]
        cos_k = e[..., 6 + 6 * k : 9 + 6 * k]
        c_sin = cot_e[..., 3 + 6 * k : 6 + 6 * k]
        c_cos = cot_e[..., 6 + 6 * k : 9 + 6 * k]
        out = out + f * (c_sin * cos_k - c_cos * sin_k)
    return out


def _pe_tangent(e, x, xdot, multires):
    """J_PE(x) @ xdot from the stashed sin/cos columns of e."""
    outs = [xdot]
    for k in range(multires):
        f = float(2.0**k)
        sin_k = e[..., 3 + 6 * k : 6 + 6 * k]
        cos_k = e[..., 6 + 6 * k : 9 + 6 * k]
        outs.append(f * cos_k * xdot)
        outs.append(-f * sin_k * xdot)
    return torch.cat(outs, dim=-1)


def _pe_tangent_x_transpose(cot_edot, e, x, xdot, multires):
    """d/dx of (cot_edot . J_PE(x) xdot) with xdot held: -f^2 sin/cos terms."""
    out = torch.zeros_like(x)
    for k in range(multires):
        f = float(2.0**k)
        sin_k = e[..., 3 + 6 * k : 6 + 6 * k]
        cos_k = e[..., 6 + 6 * k : 9 + 6 * k]
        c_sin = cot_edot[..., 3 + 6 * k : 6 + 6 * k]
        c_cos = cot_edot[..., 6 + 6 * k : 9 + 6 * k]
        out = out + f * f * (-c_sin * sin_k - c_cos * cos_k) * xdot
    return out


def field_bwd_stashed(flat_eff, x, d, res, cots, icfg, rcfg, compute_dtype):
    """Backward from residuals: (deff, dx, dd), the cotangent application
    of the forward above."""
    iw, rw, aw = _unflatten_eff(flat_eff)
    cd = compute_dtype
    el = torch.promote_types(torch.float32, cd)
    c_sdf, c_g, c_rgb, c_att = (c.to(el) for c in cots)
    e, i_post, i_r, i_a, z8, rgb, grads = res
    e_cd = e.to(cd)

    sdf_raw = z8[..., :1]
    feats = z8[..., 1:]
    norm_x, _, m_raw, m_sph = _sphere_terms(x, sdf_raw, icfg)

    em = [torch.exp(-100.0 * ip.to(el)) for ip in i_post]
    s = [1.0 - emi for emi in em]
    spp = [100.0 * si * emi for si, emi in zip(s, em)]

    d_enc = _pe(d, rcfg.multires_view) if rcfg.multires_view > 0 else d
    r_in = torch.cat([x, d_enc, grads, feats], dim=-1)
    a_in = torch.cat([x, d, grads, feats], dim=-1)

    def head_bwd(weights, posts, inp0, delta):
        dws = [None] * N_HEAD_LAYERS
        for l in range(N_HEAD_LAYERS - 1, -1, -1):
            i_l = inp0.to(cd) if l == 0 else posts[l - 1]
            w, _ = weights[l]
            dws[l] = (_mm(i_l.T, delta, cd, el), torch.sum(delta, dim=0, keepdim=True))
            t = _mm(delta, w.T, cd, el)
            if l > 0:
                delta = t * (posts[l - 1].to(el) > 0)
        return dws, t

    delta_r = c_rgb * rgb * (1.0 - rgb)
    dws_r, cot_rin = head_bwd(rw, i_r, r_in, delta_r)
    dws_a, cot_ain = head_bwd(aw, i_a, a_in, c_att)

    n_enc = d_enc.shape[-1]
    cx_r = cot_rin[..., :3]
    c_denc = cot_rin[..., 3 : 3 + n_enc]
    cg_r = cot_rin[..., 3 + n_enc : 6 + n_enc]
    cf_r = cot_rin[..., 6 + n_enc :]
    cx_a = cot_ain[..., :3]
    cd_a = cot_ain[..., 3:6]
    cg_a = cot_ain[..., 6:9]
    cf_a = cot_ain[..., 9:]

    if rcfg.multires_view > 0:
        dd = cd_a + _pe_transpose(c_denc, d_enc, d, rcfg.multires_view)
    else:
        dd = cd_a + c_denc
    C_g = c_g + cg_r + cg_a
    C_f = cf_r + cf_a
    dx = cx_r + cx_a
    Cg_mlp = C_g * m_raw

    # tangent forward (xdot = Cg_mlp) over the stored activations
    edot = _pe_tangent(e, x, Cg_mlp, icfg.multires)
    edot_cd = edot.to(cd)
    hdot = edot_cd
    tinp, zdots = [], []
    for l in range(N_IMPLICIT_LAYERS):
        if l == 4:
            hdot = _skip_concat(hdot, edot_cd)
        tinp.append(hdot)
        w, _ = iw[l]
        zdot = _mm(hdot, w, cd, el)
        zdots.append(zdot)
        if l < N_IMPLICIT_LAYERS - 1:
            hdot = (s[l] * zdot).to(cd)

    # combined reverse sweep (primal + tangent chains)
    v = torch.cat([c_sdf * m_raw, C_f], dim=-1)
    vdot = torch.cat([torch.ones_like(sdf_raw), torch.zeros_like(feats)], dim=-1)
    cot_e = torch.zeros_like(e)
    cot_edot = torch.zeros_like(e)
    ne = e.shape[-1]
    d_iw = [None] * N_IMPLICIT_LAYERS
    for l in range(N_IMPLICIT_LAYERS - 1, -1, -1):
        w, _ = iw[l]
        if l == 0:
            inp_l = e_cd
        elif l == 4:
            inp_l = _skip_concat(i_post[3], e_cd)
        else:
            inp_l = i_post[l - 1]
        dw = _mm(inp_l.T, v, cd, el) + _mm(tinp[l].T, vdot, cd, el)
        d_iw[l] = (dw, torch.sum(v, dim=0, keepdim=True))
        u = _mm(v, w.T, cd, el)
        udot = _mm(vdot, w.T, cd, el)
        if l == 0:
            cot_e = cot_e + u
            cot_edot = cot_edot + udot
        elif l == 4:
            cot_e = cot_e + u[..., -ne:] * INV_SQRT2
            cot_edot = cot_edot + udot[..., -ne:] * INV_SQRT2
            u_h = u[..., :-ne] * INV_SQRT2
            ud_h = udot[..., :-ne] * INV_SQRT2
            v = u_h * s[l - 1] + ud_h * spp[l - 1] * zdots[l - 1]
            vdot = ud_h * s[l - 1]
        else:
            v = u * s[l - 1] + udot * spp[l - 1] * zdots[l - 1]
            vdot = udot * s[l - 1]

    dx = dx + _pe_transpose(cot_e, e, x, icfg.multires)
    dx = dx + _pe_tangent_x_transpose(cot_edot, e, x, Cg_mlp, icfg.multires)

    if norm_x is not None:
        dx = dx + c_sdf * m_sph * (-icfg.sphere_scale) * x / norm_x
        xdotC = torch.sum(x * C_g, dim=-1, keepdim=True)
        dx = dx + m_sph * (-icfg.sphere_scale) * (C_g / norm_x - x * xdotC / norm_x**3)

    deff = []
    for dw, db in d_iw + dws_r + dws_a:
        deff.append(dw)
        deff.append(db)
    return tuple(deff), dx, dd


# ---------------------------------------------------------------------------
# residual packing: the kernels' stash layout
# ---------------------------------------------------------------------------


def _stash_widths(icfg: ImplicitNetConfig, rcfg: RenderNetConfig):
    dims = icfg.layer_dims()
    i_widths = [
        dims[l + 1] - dims[0] if (l + 1) in icfg.skip_in else dims[l + 1]
        for l in range(N_IMPLICIT_LAYERS - 1)
    ]
    head_w = 2 * sum(rcfg.dims)
    return i_widths, sum(i_widths) + head_w


def _pack_res(res):
    e, i_post, i_r, i_a, z8, rgb, grads = res
    stash_cd = torch.cat(list(i_post) + list(i_r) + list(i_a), dim=-1)
    stash_f32 = torch.cat([e, z8], dim=-1)
    return stash_cd, stash_f32


def _unpack_res(stash_cd, stash_f32, rgb, grads, icfg, rcfg):
    i_widths, _ = _stash_widths(icfg, rcfg)
    cols = torch.split(stash_cd, list(i_widths) + list(rcfg.dims) * 2, dim=-1)
    n_i = len(i_widths)
    i_post, i_r, i_a = cols[:n_i], cols[n_i : n_i + 4], cols[n_i + 4 :]
    ne = icfg.layer_dims()[0]
    e, z8 = stash_f32[..., :ne], stash_f32[..., ne:]
    return (e, tuple(i_post), tuple(i_r), tuple(i_a), z8, rgb, grads)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

W_CD = 4057  # 7 x 256 + 217 implicit post-activations + 2 x 4 x 256 head ones
W_F32 = 296  # embedding (39) + z8 (257)
# canonical (in, out) widths of the 19 layers: implicit, rendering, attraction
CANONICAL_SHAPES = (
    ((39, 256), (256, 256), (256, 256), (256, 217)) + ((256, 256),) * 4 + ((256, 257),)
    + ((289, 256),) + ((256, 256),) * 3 + ((256, 3),)
    + ((265, 256),) + ((256, 256),) * 3 + ((256, 6),)
)


def _check_operands(flat_eff, x, d, cd, tensors=()):
    """Raise on anything the kernels do not take."""
    if cd not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused field kernels take bf16 or f32 compute, got {cd}")
    if tuple(tuple(w.shape) for w in flat_eff[0::2]) != CANONICAL_SHAPES:
        raise ValueError("fused field kernels take the canonical 8x256 / 4x256 architecture only")
    for t in (x, d):
        if t.dim() != 2 or t.shape[1] != 3 or t.dtype != torch.float32:
            raise ValueError("fused field kernels take (N, 3) f32 points and directions")
    if not x.is_cuda:
        raise ValueError("fused field kernels take CUDA tensors")
    for t in (*flat_eff, d, *tensors):
        if t.device != x.device:
            raise ValueError("fused field kernel operands must share one CUDA device")
    for t in (x, d, *tensors):
        if not t.is_contiguous():
            raise ValueError("fused field kernels take contiguous tensors")


def _pack_weights(flat_eff, cd):
    """W (in, out) and W^T (out, in) of the 19 layers in ``cd``, biases in f32."""
    ws, bs = flat_eff[0::2], flat_eff[1::2]
    w_all = torch.cat([w.detach().to(cd).reshape(-1) for w in ws])
    wt_all = torch.cat([w.detach().T.to(cd).reshape(-1) for w in ws])
    b_all = torch.cat([b.detach().to(torch.float32).reshape(-1) for b in bs])
    return w_all, wt_all, b_all


def _fn(name, cd, n_ptr, n_int):
    """The C entry ``name`` for ``cd``: n_ptr pointers, n_int ints, the
    sphere radius and scale, the stream."""
    lib = _build.load("fused_field_stash")
    fn = getattr(lib, f"{name}_{'bf16' if cd == torch.bfloat16 else 'f32'}")
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def field_fwd_stash_kernel(flat_eff, x, d, icfg: ImplicitNetConfig, cd):
    """Launch K2-fwd: -> sdf (N,1), grads (N,3), rgb (N,3), att (N,6) f32,
    stash_cd (N, 4057) in ``cd``, stash_f32 (N, 296)."""
    _check_operands(flat_eff, x, d, cd)
    n = x.shape[0]
    kw = dict(device=x.device)
    sdf = torch.empty((n, 1), dtype=torch.float32, **kw)
    grads = torch.empty((n, 3), dtype=torch.float32, **kw)
    rgb = torch.empty((n, 3), dtype=torch.float32, **kw)
    att = torch.empty((n, 6), dtype=torch.float32, **kw)
    scd = torch.empty((n, W_CD), dtype=cd, **kw)
    sf32 = torch.empty((n, W_F32), dtype=torch.float32, **kw)
    if n == 0:
        return sdf, grads, rgb, att, scd, sf32
    w_all, wt_all, b_all = _pack_weights(flat_eff, cd)
    P = _build.ptr
    err = _fn("field_fwd_stash", cd, 11, 1)(
        P(x), P(d), P(w_all), P(wt_all), P(b_all),
        P(sdf), P(grads), P(rgb), P(att), P(scd), P(sf32), n,
        icfg.sdf_bounding_sphere, icfg.sphere_scale, _build.stream_ptr(x),
    )
    _build.check(err, "fused field forward kernel launch")
    field_fwd_stash_kernel.launches += 1
    return sdf, grads, rgb, att, scd, sf32


field_fwd_stash_kernel.launches = 0


def _n_param_grads() -> int:
    return sum(i * o + o for i, o in CANONICAL_SHAPES)


def _bwd_layout(n: int, max_blocks: int):
    """(blocks, f32 gradients, f32 scratch per block) of the backward for n
    points, as the C side decides them."""
    lib = _build.load("fused_field_stash")
    fn = lib.field_bwd_layout
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = None
    blocks, n_params, scratch = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_longlong()
    fn(n, max_blocks, ctypes.byref(blocks), ctypes.byref(n_params), ctypes.byref(scratch))
    return blocks.value, n_params.value, scratch.value


def field_bwd_stash_kernel(flat_eff, x, d, scd, sf32, rgb, grads, cots, icfg: ImplicitNetConfig, cd):
    """Launch K2-bwd and the sum of its per-block partial gradients:
    -> (deff (38 f32 tensors shaped like flat_eff), dx (N,3), dd (N,3)).
    ``cots`` are the contiguous f32 cotangents (N,1), (N,3), (N,3), (N,6)."""
    n = x.shape[0]
    for c, w in zip(cots, (1, 3, 3, 6)):
        if c.shape != (n, w) or c.dtype != torch.float32:
            raise ValueError("fused field backward takes f32 cotangents shaped like its outputs")
    if scd.shape != (n, W_CD) or scd.dtype != cd or sf32.shape != (n, W_F32):
        raise ValueError("stash shapes do not match the fused field kernel's layout")
    _check_operands(flat_eff, x, d, cd, (scd, sf32, rgb, grads, *cots))
    kw = dict(device=x.device)
    dx = torch.empty((n, 3), dtype=torch.float32, **kw)
    dd = torch.empty((n, 3), dtype=torch.float32, **kw)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_blocks, n_p, n_scratch = _bwd_layout(n, n_sm)
    if n_p != sum(w.numel() for w in flat_eff):
        raise ValueError("the fused field backward's layer table does not match the weights")
    dparams = torch.empty((n_p,), dtype=torch.float32, **kw)
    w_all, wt_all, _ = _pack_weights(flat_eff, cd)
    partials = torch.empty((n_blocks, n_p), dtype=torch.float32, **kw)
    scratch = torch.empty((n_blocks, n_scratch), dtype=torch.float32, **kw)
    P = _build.ptr
    err = _fn("field_bwd_stash", cd, 17, 2)(
        P(x), P(d), P(scd), P(sf32), P(rgb), P(grads), *(P(c) for c in cots),
        P(w_all), P(wt_all), P(dx), P(dd), P(dparams), P(partials), P(scratch),
        n, n_sm, icfg.sdf_bounding_sphere, icfg.sphere_scale, _build.stream_ptr(x),
    )
    _build.check(err, "fused field backward kernel launch")
    field_bwd_stash_kernel.launches += 1
    deff, o = [], 0
    for w in flat_eff:
        deff.append(dparams[o : o + w.numel()].view(w.shape))
        o += w.numel()
    return tuple(deff), dx, dd


field_bwd_stash_kernel.launches = 0


# ---------------------------------------------------------------------------
# autograd op
# ---------------------------------------------------------------------------


class _FusedFieldStash(torch.autograd.Function):
    """The stashing forward and its replaying backward as one autograd op.
    CUDA tensors launch K2-fwd / K2-bwd; CPU tensors run the plain math."""

    @staticmethod
    def forward(ctx, icfg, rcfg, cd, x, d, *flat_eff):
        if x.is_cuda:
            sdf, grads, rgb, att, scd, sf32 = field_fwd_stash_kernel(flat_eff, x, d, icfg, cd)
        else:
            (sdf, grads, rgb, att), res = field_fwd_res(flat_eff, x, d, icfg, rcfg, cd)
            scd, sf32 = _pack_res(res)
        ctx.cfg = (icfg, rcfg, cd)
        ctx.save_for_backward(x, d, scd, sf32, rgb, grads, *flat_eff)
        return sdf, grads, rgb, att

    @staticmethod
    def backward(ctx, c_sdf, c_g, c_rgb, c_att):
        icfg, rcfg, cd = ctx.cfg
        x, d, scd, sf32, rgb, grads, *flat_eff = ctx.saved_tensors
        outs = (c_sdf, c_g, c_rgb, c_att)
        shapes = ((1,), (3,), (3,), (6,))
        cots = tuple(
            torch.zeros((x.shape[0], *s), dtype=x.dtype, device=x.device)
            if c is None else c.contiguous()
            for c, s in zip(outs, shapes)
        )
        if x.is_cuda:
            deff, dx, dd = field_bwd_stash_kernel(
                flat_eff, x, d, scd, sf32, rgb, grads, cots, icfg, cd
            )
        else:
            res = _unpack_res(scd, sf32, rgb, grads, icfg, rcfg)
            deff, dx, dd = field_bwd_stashed(flat_eff, x, d, res, cots, icfg, rcfg, cd)
        return (None, None, None, dx, dd, *deff)


def fused_field_eval_stash(
    model,
    points: torch.Tensor,
    dirs: torch.Tensor,
    icfg: ImplicitNetConfig,
    rcfg: RenderNetConfig,
    compute_dtype: str = "bfloat16",
    acfg: RenderNetConfig = RenderNetConfig(d_out=6, multires_view=0),
):
    """Main-pass field evaluation through K2: (sdf (N,1), grads (N,3),
    rgb (N,3), lines3d (N,2,3)), differentiable w.r.t. the model's weights,
    the points and the directions. ``model`` holds the ``implicit``,
    ``rendering`` and ``attraction`` layer stacks."""
    cd = _DTYPES[compute_dtype]
    flat_eff = _flatten_eff(model)
    if points.is_cuda and not supports_fused_field(icfg, rcfg, acfg):
        raise ValueError("fused field kernels take the canonical 8x256 / 4x256 architecture only")
    sdf, grads, rgb, att = _FusedFieldStash.apply(icfg, rcfg, cd, points, dirs, *flat_eff)
    lines3d = points[..., None, :] + att.reshape(*points.shape[:-1], 2, 3)
    return sdf, grads, rgb, lines3d
