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

The bodies of both kernels for one tile are device functions in
``csrc/field_tile.cuh``: the recompute pair (``fused_field``, K3) runs the
same two bodies on a per-block scratch in place of the stash.

bf16 K2-bwd is split (``field_bwd_split_plain`` is its plain version): a
row-local pass stores every weight-gradient operand, rounded to bf16, into
a feature-major workspace instead of adding dW into partials (which keep
the bias gradients), and a GEMM on the tensor cores sums them
(``field_dw``, ``csrc/field_dw_mma.cu``). The model's row-local pass is on
the tensor cores (``csrc/field_bwd_mma.cu``, weights packed by
``pack_field_bwd_weights``). The scalar tile with its
``tile_wgrad`` calls replaced by those stores stays as the "split" variant:
it equals the fused scalar kernel in dx, dd and every bias gradient bit for
bit. f32 keeps the fused scalar kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..fields.mlp import ImplicitNetConfig, RenderNetConfig, _skip_concat, _softplus100
from . import _build
from . import field_dw as DW
from . import fused_sdf as K1
from .fused_field import (
    _DTYPES,
    FWD_VARIANTS,
    N_HEAD_LAYERS,
    N_IMPLICIT_LAYERS,
    _check_cotangents,
    _check_operands,
    _cotangents,
    _differentiated,
    _entry,
    _flatten_eff,
    _head,
    _implicit_chain,
    _mm,
    _n_sm,
    _pack_weights,
    _pe,
    _sphere,
    _split_param_grads,
    _unflatten_eff,
    field_primal,
    resolved_operands,
    supports_fused_field,
)

INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _balanced(a, b):
    """min(a, b)'s subgradient multiplier for ``a``: 1 where a < b, 0.5 at
    ties, 0 otherwise."""
    one = torch.ones_like(a)
    return torch.where(a < b, one, torch.where(a == b, 0.5 * one, 0.0 * one))


def _sphere_terms(x, sdf_raw, icfg):
    norm_x, sphere = _sphere(x, icfg)
    if sphere is not None:
        return norm_x, sphere, _balanced(sdf_raw, sphere), _balanced(sphere, sdf_raw)
    return None, None, torch.ones_like(sdf_raw), torch.zeros_like(sdf_raw)


def field_fwd_res(flat_eff, x, d, icfg: ImplicitNetConfig, rcfg: RenderNetConfig, compute_dtype):
    """Forward pass returning ((sdf, grads, rgb, att), residuals); the
    residuals are what ``field_bwd_stashed`` consumes."""
    iw, rw, aw = _unflatten_eff(flat_eff)
    cd = compute_dtype
    el = torch.promote_types(torch.float32, cd)

    e = _pe(x, icfg.multires)
    z8, i_post = _implicit_chain(iw, e.to(cd), cd, el)
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

    zr, i_r = _head(rw, r_in, cd, el)
    rgb = torch.sigmoid(zr)
    att, i_a = _head(aw, a_in, cd, el)

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


def _bwd_rowlocal(flat_eff, x, d, res, cots, icfg, rcfg, compute_dtype, mats=None):
    """The row-local part of ``field_bwd_stashed``: (prods, dbs, dx, dd).
    ``prods[l]`` lists the (input, cotangent) pairs whose products
    input^T cotangent, summed over the points, are dW_l: the implicit layers
    a primal and a tangent pair, the heads one. ``dbs[l]`` is db_l.
    ``mats`` = (fwd, tr): the (in, out) matrices of the tangent forward's
    products (layers 0..7) and of the transposed products (all 19 layers,
    multiplied as their transposes); by default both are flat_eff's."""
    if mats is None:
        mats = (flat_eff[0::2], flat_eff[0::2])
    fwd, tr = mats
    rw = [(tr[l], None) for l in range(N_IMPLICIT_LAYERS, N_IMPLICIT_LAYERS + N_HEAD_LAYERS)]
    aw = [(tr[l], None) for l in range(N_IMPLICIT_LAYERS + N_HEAD_LAYERS, len(tr))]
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
        prods, dbs = [None] * N_HEAD_LAYERS, [None] * N_HEAD_LAYERS
        for l in range(N_HEAD_LAYERS - 1, -1, -1):
            i_l = inp0.to(cd) if l == 0 else posts[l - 1]
            w, _ = weights[l]
            prods[l] = [(i_l, delta)]
            dbs[l] = torch.sum(delta, dim=0, keepdim=True)
            t = _mm(delta, w.T, cd, el)
            if l > 0:
                delta = t * (posts[l - 1].to(el) > 0)
        return prods, dbs, t

    delta_r = c_rgb * rgb * (1.0 - rgb)
    prods_r, dbs_r, cot_rin = head_bwd(rw, i_r, r_in, delta_r)
    prods_a, dbs_a, cot_ain = head_bwd(aw, i_a, a_in, c_att)

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
    for l in range(N_IMPLICIT_LAYERS - 1):
        if l == 4:
            hdot = _skip_concat(hdot, edot_cd)
        tinp.append(hdot)
        zdot = _mm(hdot, fwd[l], cd, el)
        zdots.append(zdot)
        hdot = (s[l] * zdot).to(cd)
    tinp.append(hdot)  # layer 8's tangent input: its dW is a column sum (one-hot seed)

    # combined reverse sweep (primal + tangent chains)
    v = torch.cat([c_sdf * m_raw, C_f], dim=-1)
    vdot = torch.cat([torch.ones_like(sdf_raw), torch.zeros_like(feats)], dim=-1)
    cot_e = torch.zeros_like(e)
    cot_edot = torch.zeros_like(e)
    ne = e.shape[-1]
    prods_i, dbs_i = [None] * N_IMPLICIT_LAYERS, [None] * N_IMPLICIT_LAYERS
    for l in range(N_IMPLICIT_LAYERS - 1, -1, -1):
        w = tr[l]
        if l == 0:
            inp_l = e_cd
        elif l == 4:
            inp_l = _skip_concat(i_post[3], e_cd)
        else:
            inp_l = i_post[l - 1]
        prods_i[l] = [(inp_l, v), (tinp[l], vdot)]
        dbs_i[l] = torch.sum(v, dim=0, keepdim=True)
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
    return prods_i + prods_r + prods_a, dbs_i + dbs_r + dbs_a, dx, dd


def field_bwd_stashed(flat_eff, x, d, res, cots, icfg, rcfg, compute_dtype):
    """Backward from residuals: (deff, dx, dd), the cotangent application
    of the forward above."""
    cd = compute_dtype
    el = torch.promote_types(torch.float32, cd)
    prods, dbs, dx, dd = _bwd_rowlocal(flat_eff, x, d, res, cots, icfg, rcfg, cd)
    deff = []
    for pairs, db in zip(prods, dbs):
        dw = _mm(pairs[0][0].T, pairs[0][1], cd, el)
        for a, y in pairs[1:]:
            dw = dw + _mm(a.T, y, cd, el)
        deff += [dw, db]
    return tuple(deff), dx, dd


def field_bwd_rowlocal_plain(flat_eff, x, d, res, cots, icfg, rcfg, compute_dtype):
    """The split backward's row-local pass, as the producer kernel computes
    it: (workspace, dbs, col8, dx, dd). The workspace (``field_dw``) holds
    every dW operand of ``field_bwd_stashed`` rounded to the compute dtype;
    dbs are the 19 bias gradients, dx and dd the point cotangents (all three
    ``field_bwd_stashed``'s own); col8 is layer 8's tangent term, the f32
    column sum of its tangent input (its cotangent is the one-hot sdf seed),
    which belongs to dW_8's column 0."""
    prods, dbs, dx, dd = _bwd_rowlocal(flat_eff, x, d, res, cots, icfg, rcfg, compute_dtype)
    shapes = tuple(tuple(w.shape) for w in flat_eff[0::2])
    return _rowlocal_outputs(prods, dbs, dx, dd, x.shape[0], compute_dtype, shapes)


def _rowlocal_outputs(prods, dbs, dx, dd, n, cd, shapes):
    """_bwd_rowlocal's products as the row-local pass's outputs: (workspace,
    dbs, col8, dx, dd)."""
    el = torch.promote_types(torch.float32, cd)
    ops = {}
    for l, pairs in enumerate(prods):
        for (a, y), (kin, kcot) in zip(pairs, (("in", "cot"), ("tin", "tcot"))):
            if l == N_IMPLICIT_LAYERS - 1 and kin == "tin":
                continue
            ops[kin, l], ops[kcot, l] = a, y
    ws = DW.pack_workspace(ops, n, cd, shapes)
    col8 = torch.sum(prods[N_IMPLICIT_LAYERS - 1][1][0].to(cd).to(el), dim=0)
    return ws, dbs, col8, dx, dd


def field_bwd_split_plain(flat_eff, x, d, res, cots, icfg, rcfg, compute_dtype):
    """``field_bwd_stashed`` organised as the split kernels compute it: the
    row-local pass (``field_bwd_rowlocal_plain``), then every dW_l as one f32
    sum over the workspace (``field_dw.field_dw_plain``; an implicit layer's
    primal and tangent terms in one sum over twice the points), layer 8's
    tangent column added. dx, dd and db are ``field_bwd_stashed``'s; dW
    differs from it by the order of the f32 sums only."""
    ws, dbs, col8, dx, dd = field_bwd_rowlocal_plain(flat_eff, x, d, res, cots, icfg, rcfg, compute_dtype)
    shapes = tuple(tuple(w.shape) for w in flat_eff[0::2])
    dws = DW.field_dw_plain(ws, shapes)
    dws[N_IMPLICIT_LAYERS - 1][:, 0] += col8
    deff = []
    for dw, db in zip(dws, dbs):
        deff += [dw, db]
    return tuple(deff), dx, dd


def field_bwd_recompute_split_plain(flat_eff, x, d, cots, icfg, rcfg, compute_dtype, chunk=None):
    """The plain version of the bf16 K3-bwd, chunk by chunk as the kernels
    run it (``fused_field.recompute_chunks``): the forward with its
    residuals (``field_fwd_res``), packed into the stash layout and read back
    (``_pack_res``), the row-local pass (``field_bwd_rowlocal_plain``), every
    dW_l as one sum over the chunk's workspace (``field_dw.field_dw_plain``)
    with layer 8's tangent column added; each chunk's gradients summed into
    the total in chunk order. -> (deff, dx, dd). A point's dx and dd do not
    depend on the chunking; the gradients differ from
    ``field_bwd_split_plain``'s by the order of their f32 sums only."""
    from .fused_field import RECOMPUTE_CHUNK, recompute_chunks

    cd = compute_dtype
    shapes = tuple(tuple(w.shape) for w in flat_eff[0::2])
    el = torch.promote_types(torch.float32, cd)
    total = [torch.zeros(w.shape, dtype=el, device=x.device) for w in flat_eff]
    dxs, dds = [x.new_zeros((0, 3))], [x.new_zeros((0, 3))]
    for c0, c1 in recompute_chunks(x.shape[0], chunk or RECOMPUTE_CHUNK):
        xc, dc, cc = x[c0:c1], d[c0:c1], [c[c0:c1] for c in cots]
        (_, grads, rgb, _), res = field_fwd_res(flat_eff, xc, dc, icfg, rcfg, cd)
        res = _unpack_res(*_pack_res(res), rgb, grads, icfg, rcfg)
        ws, dbs, col8, dx, dd = field_bwd_rowlocal_plain(flat_eff, xc, dc, res, cc, icfg, rcfg, cd)
        dws = DW.field_dw_plain(ws, shapes)
        dws[N_IMPLICIT_LAYERS - 1][:, 0] += col8
        for l, (dw, db) in enumerate(zip(dws, dbs)):
            total[2 * l] += dw
            total[2 * l + 1] += db
        dxs.append(dx)
        dds.append(dd)
    return tuple(total), torch.cat(dxs), torch.cat(dds)


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
# the packed operands of the bf16 tensor-core forward (csrc/field_fwd_mma.cu)
# ---------------------------------------------------------------------------

# csrc/field_fwd_mma.cu hard-codes the same numbers under the same names.
# Panels are K1's (256 rows x 64 k, swizzled, zero-padded; ops/fused_sdf.py).
# (part, layer, first k row) of each panel, in the order a tile consumes them:
# "fwd" panels hold W_l[k0 + k, n] at row n (K1's), "feat" panels layer 8's
# feature columns W_8[k0 + k, 1 + n], "sweep" panels the transposed product's
# W_l[n, k0 + k] at row n, "lead" and "hfeat" panels a head's first layer
# split at its 256 feature rows: the leading inputs W_l[k, n] (k < 33 or 9)
# and the feature rows W_l[n_lead + k0 + k, n].
_K4 = (0, 64, 128, 192)
FIELD_PANELS = (
    tuple(("fwd", l, k0) for l, k0 in K1.PANELS)
    + tuple(("feat", 8, k0) for k0 in _K4)
    + tuple(("sweep", l, k0) for l in range(7, -1, -1) for k0 in _K4)
    + tuple(
        p
        for l0 in (9, 14)
        for p in (("lead", l0, 0),) + tuple(("hfeat", l0, k0) for k0 in _K4)
        + tuple(("fwd", l, k0) for l in range(l0 + 1, l0 + 4) for k0 in _K4)
    )
)
N_FIELD_PANELS = len(FIELD_PANELS)  # 99
# leading inputs of a head's first layer: [x, PE4(d), grads] and [x, d, grads]
N_LEAD = {9: 33, 14: 9}
# the weights: pack_sdf_weights' buffer (K1's 29 panels and W_8's sdf
# column), the 70 further panels, then W_13 and W_18 as rows of 256
SDF_W_TOTAL = K1.W_TOTAL
W13_OFF = SDF_W_TOTAL + (N_FIELD_PANELS - K1.N_PANELS) * K1.PANEL_ELEMS
W18_OFF = W13_OFF + 3 * 256
FIELD_W_TOTAL = W18_OFF + 6 * 256
# the f32 biases, 256 a slot: layer l < 8 in slot l and b_8's sdf entry at
# 2048 (pack_sdf_weights' buffer), then b_8's features, b_9 .. b_13, b_14 .. b_18
B8F_OFF = 9 * 256
B_SLOT = {9: 10, 10: 11, 11: 12, 12: 13, 13: 14, 14: 15, 15: 16, 16: 17, 17: 18, 18: 19}
FIELD_B_TOTAL = 20 * 256


def _field_panel(ws, part, l, k0):
    """One panel (256 rows x 64 k, not yet swizzled) of the (in, out) matrices ws."""
    w = ws[l]
    p = w.new_zeros((K1.PANEL_ROWS, K1.PANEL_K))
    if part == "feat":
        blk = w[k0 : k0 + 64, 1:].T
    elif part == "sweep":
        blk = w[:, k0 : k0 + 64]
    elif part == "lead":
        blk = w[: N_LEAD[l]].T
    elif part == "hfeat":
        blk = w[N_LEAD[l] + k0 : N_LEAD[l] + k0 + 64].T
    else:
        blk = w[k0 : k0 + 64].T
    p[: blk.shape[0], : blk.shape[1]] = blk
    return p


def pack_field_weights(flat_eff):
    """The 19 (in, out) matrices and biases of ``flat_eff`` as the tensor-core
    forward reads them: (FIELD_W_TOTAL,) in the matrices' dtype and
    (FIELD_B_TOTAL,) in the biases' (the kernel takes bf16 and f32). The weights are the shared-memory image of every
    panel of FIELD_PANELS in order (the first 29 and W_8's sdf column are
    ``pack_sdf_weights``' own buffer), then W_13 and W_18 transposed."""
    ws = [w.detach() for w in flat_eff[0::2]]
    bs = [b.detach().reshape(-1) for b in flat_eff[1::2]]
    w_sdf, _ = K1.pack_sdf_weights(ws[:8] + [ws[8][:, :1]], bs[:8] + [bs[8][:1]])
    rest = torch.stack([_field_panel(ws, *p) for p in FIELD_PANELS[K1.N_PANELS :]])
    w = torch.cat([w_sdf, K1._swizzle(rest).reshape(-1), ws[13].T.reshape(-1), ws[18].T.reshape(-1)])
    return w, pack_field_biases(bs)


def pack_field_biases(bs):
    """The 19 biases (flat) as the tensor-core forwards read them:
    (FIELD_B_TOTAL,), ``pack_sdf_biases``' buffer, then b_8's features and
    the heads' biases in their slots."""
    b = torch.zeros((FIELD_B_TOTAL,), dtype=bs[0].dtype, device=bs[0].device)
    b[: K1.B_TOTAL] = K1.pack_sdf_biases(bs[:8] + [bs[8][:1]])
    b[B8F_OFF : B8F_OFF + 256] = bs[8][1:]
    for l, slot in B_SLOT.items():
        b[256 * slot : 256 * slot + bs[l].shape[0]] = bs[l]
    return b


_FIELD_GATHER = {}  # device -> (weight positions, bias positions), built once


def pack_field_weights_gather(flat_eff, cd):
    """``pack_field_weights`` in two gathers, as the wrapper runs it on every
    launch, the matrices cast to ``cd`` (``pack_sdf_weights_gather``'s method:
    the layout applied once to matrices that hold their own position in the
    concatenated operands)."""
    from .fused_field import CANONICAL_SHAPES

    dev = flat_eff[0].device
    if dev not in _FIELD_GATHER:
        w_sizes = [i * o for i, o in CANONICAL_SHAPES]
        b_sizes = [o for _, o in CANONICAL_SHAPES]
        w_pos = torch.arange(1, 1 + sum(w_sizes)).split(w_sizes)
        b_pos = torch.arange(1, 1 + sum(b_sizes)).split(b_sizes)
        pos = []
        for wp, bp, sh in zip(w_pos, b_pos, CANONICAL_SHAPES):
            pos += [wp.reshape(sh), bp[None, :]]
        w_at, b_at = pack_field_weights(pos)
        _FIELD_GATHER[dev] = (w_at.to(dev), b_at.to(dev))
    w_at, b_at = _FIELD_GATHER[dev]
    ws, bs = flat_eff[0::2], flat_eff[1::2]
    w = torch.cat([ws[0].new_zeros(1, dtype=cd), *(x.detach().to(cd).reshape(-1) for x in ws)])[w_at]
    b = torch.cat([bs[0].new_zeros(1, dtype=torch.float32), *(x.detach().float().reshape(-1) for x in bs)])[b_at]
    return w, b


def unpack_field_weights(w, b, keep_pads: bool = False):
    """The inverse of ``pack_field_weights``: (flat, sweep). ``flat`` is the
    38 operands (W_l (in, out), b_l (1, out)) read from the forward panels;
    ``sweep[l]`` (l < 8) is the (out, in) matrix W_l^T read from the
    transposed panels. With ``keep_pads`` the matrices keep the widths the
    kernel multiplies: K 39 -> 64 (layer 0), N 217 -> 256 (layer 3), the
    heads' first layers as [leading rows padded to 64, 256 feature rows], and
    every sweep matrix 256 x 256."""
    from .fused_field import CANONICAL_SHAPES

    pe = K1.PANEL_ELEMS
    sdf_ws, sdf_bs = K1.unpack_sdf_weights(w[:SDF_W_TOTAL], b[: K1.B_TOTAL], keep_pads=True)
    rest = K1._swizzle(w[SDF_W_TOTAL:W13_OFF].reshape(-1, K1.PANEL_ROWS, K1.PANEL_K))
    by = {}  # (part, layer) -> [panels in k0 order]
    for i, (part, l, _) in enumerate(FIELD_PANELS[K1.N_PANELS :]):
        by.setdefault((part, l), []).append(rest[i])
    cols = lambda ps: torch.cat([p.T for p in ps], dim=0)  # (64 * len, 256): k rows
    ws = sdf_ws[:8] + [torch.cat([sdf_ws[8], cols(by["feat", 8])], dim=1)]
    bs = sdf_bs[:8] + [torch.cat([sdf_bs[8], b[B8F_OFF : B8F_OFF + 256]])]
    for l0 in (9, 14):
        ws.append(torch.cat([cols(by["lead", l0]), cols(by["hfeat", l0])], dim=0))  # (320, 256)
        ws += [cols(by["fwd", l]) for l in range(l0 + 1, l0 + 4)]
        out = w[W13_OFF:W18_OFF].reshape(3, 256) if l0 == 9 else w[W18_OFF:FIELD_W_TOTAL].reshape(6, 256)
        ws.append(out.T.contiguous())
    for l in range(9, 19):
        n_out = CANONICAL_SHAPES[l][1]
        bs.append(b[256 * B_SLOT[l] : 256 * B_SLOT[l] + (256 if n_out == 256 else n_out)])
    # (out 256, in 256), laid out as the transpose of an (in, out) matrix
    sweep = [cols(by["sweep", l]).T.contiguous().T for l in range(8)]
    if not keep_pads:
        for l0 in (9, 14):
            ws[l0] = torch.cat([ws[l0][: N_LEAD[l0]], ws[l0][64:]])
        ws = [x[:i, :o] for x, (i, o) in zip(ws, CANONICAL_SHAPES)]
        bs = [x[:o] for x, (_, o) in zip(bs, CANONICAL_SHAPES)]
        sweep = [x[:o, :i] for x, (i, o) in zip(sweep, CANONICAL_SHAPES)]
    flat = []
    for wl, bl in zip(ws, bs):
        flat += [wl, bl[None, :]]
    return tuple(flat), sweep


def field_fwd_plain_packed(x, d, w, b, icfg: ImplicitNetConfig, cd):
    """``field_fwd_res`` on the tensor-core forward's own operands: the
    padded matrices read back from the packed buffers, the embedding
    zero-padded to a panel's 64 columns, layer 3's pad columns dropped at the
    skip, the gradient sweep through the transposed panels (zero-padded
    cotangents), each head's first layer on [leading inputs padded to 64,
    features]. The pads are zeros, so this returns ``field_fwd_res``'s
    outputs and residuals (canonical widths, PE4 view encoding)."""
    flat, sweep = unpack_field_weights(w, b, keep_pads=True)
    iw, rw, aw = _unflatten_eff(flat)
    el = torch.promote_types(torch.float32, cd)
    pad = lambda t, width: torch.nn.functional.pad(t, (0, width - t.shape[-1]))

    e = _pe(x, icfg.multires)
    ne = e.shape[-1]
    e_cd = e.to(cd)
    h, i_post = pad(e_cd, K1.PANEL_K), []
    for l in range(N_IMPLICIT_LAYERS - 1):
        if l == 4:
            h = _skip_concat(h, e_cd)
        z = _mm(h, iw[l][0], cd, el) + iw[l][1]
        # layer 3's pad columns go before the activation: on the CPU an
        # elementwise op's last bits depend on where a row sits in memory
        h = _softplus100(z[..., : 256 - ne].contiguous() if l == 3 else z).to(cd)
        i_post.append(h)
    z8 = _mm(h, iw[8][0], cd, el) + iw[8][1]
    sdf_raw, feats = z8[..., :1], z8[..., 1:]
    norm_x, sphere, m_raw, m_sph = _sphere_terms(x, sdf_raw, icfg)
    sdf = torch.minimum(sdf_raw, sphere) if sphere is not None else sdf_raw

    s = [1.0 - torch.exp(-100.0 * ip.to(el)) for ip in i_post]
    v = iw[8][0][:, 0].to(el) * s[7]  # the one-hot seed's transposed product is W_8's sdf column
    cot_e = torch.zeros_like(e)
    for l in range(N_IMPLICIT_LAYERS - 2, -1, -1):
        u = _mm(pad(v, 256), sweep[l], cd, el)
        if l == 0:
            cot_e = cot_e + u[..., :ne]
        elif l == 4:
            cot_e = cot_e + u[..., -ne:] * INV_SQRT2
            v = u[..., :-ne] * INV_SQRT2 * s[l - 1]
        else:
            v = u * s[l - 1]
    g_mlp = _pe_transpose(cot_e, e, x, icfg.multires)
    grads = m_raw * g_mlp + m_sph * (-icfg.sphere_scale * x / norm_x) if norm_x is not None else g_mlp

    lead_r = torch.cat([x, _pe(d, 4), grads], dim=-1)
    lead_a = torch.cat([x, d, grads], dim=-1)
    zr, i_r = _head(rw, torch.cat([pad(lead_r, K1.PANEL_K), feats], dim=-1), cd, el)
    att, i_a = _head(aw, torch.cat([pad(lead_a, K1.PANEL_K), feats], dim=-1), cd, el)
    rgb = torch.sigmoid(zr)
    res = (e, tuple(i_post), tuple(i_r), tuple(i_a), z8, rgb, grads)
    return (sdf, grads, rgb, att), res


# ---------------------------------------------------------------------------
# the packed weights of the tensor-core row-local pass (csrc/field_bwd_mma.cu)
# ---------------------------------------------------------------------------

# csrc/field_bwd_mma.cu hard-codes the same numbers. (part, layer, first k
# row) of each panel (K1's 256 rows x 64 k, swizzled), in the order a tile
# consumes them: each head's backward (its hidden layers, then its first
# layer's leading rows and its feature rows), the tangent forward, the
# combined sweep. "tr" panels hold the transposed product's W_l[n, k0 + k] at
# row n (the forward's "sweep" panels); "trlead" and "trfeat" a head's first
# layer split at its 256 feature rows: W_l[n, k0 + k] for the leading rows
# n < 33 or 9 and W_l[n_lead + n, k0 + k]; "tr8" layer 8's feature columns
# W_8[n, 1 + k0 + k]; "fwd" K1's panels, W_l[k0 + k, n] at row n.
BWD_PANELS = (
    tuple(
        p
        for l0 in (9, 14)
        for p in tuple(("tr", l, k0) for l in (l0 + 3, l0 + 2, l0 + 1) for k0 in _K4)
        + tuple(("trlead", l0, k0) for k0 in _K4) + tuple(("trfeat", l0, k0) for k0 in _K4)
    )
    + tuple(("fwd", l, k0) for l, k0 in K1.PANELS)
    + tuple(("tr8", 8, k0) for k0 in _K4)
    + tuple(("tr", l, k0) for l in range(7, -1, -1) for k0 in _K4)
)
N_BWD_PANELS = len(BWD_PANELS)  # 105
# after the panels: W_13^T (3 x 256) and W_18^T (6 x 256), the output
# layers' transposed products of depth 3 and 6, and W_8's sdf column (256)
BWD_W13_OFF = N_BWD_PANELS * K1.PANEL_ELEMS
BWD_W18_OFF = BWD_W13_OFF + 3 * 256
BWD_W8_OFF = BWD_W18_OFF + 6 * 256
BWD_W_TOTAL = BWD_W8_OFF + 256


def _bwd_panel(ws, part, l, k0):
    """One panel (256 rows x 64 k, not yet swizzled) of the (in, out) matrices ws."""
    w = ws[l]
    p = w.new_zeros((K1.PANEL_ROWS, K1.PANEL_K))
    if part == "tr":
        blk = w[:, k0 : k0 + 64]
    elif part == "trlead":
        blk = w[: N_LEAD[l], k0 : k0 + 64]
    elif part == "trfeat":
        blk = w[N_LEAD[l] : N_LEAD[l] + 256, k0 : k0 + 64]
    elif part == "tr8":
        blk = w[:, 1 + k0 : 1 + k0 + 64]
    else:
        blk = w[k0 : k0 + 64].T
    p[: blk.shape[0], : blk.shape[1]] = blk
    return p


def pack_field_bwd_weights(flat_eff):
    """The 19 (in, out) matrices of ``flat_eff`` as the tensor-core row-local
    pass reads them: (BWD_W_TOTAL,) in the matrices' dtype, the
    shared-memory image of every panel of BWD_PANELS in order, then W_13^T,
    W_18^T and W_8's sdf column. The pass needs no bias."""
    ws = [w.detach() for w in flat_eff[0::2]]
    panels = torch.stack([_bwd_panel(ws, *p) for p in BWD_PANELS])
    return torch.cat([K1._swizzle(panels).reshape(-1), ws[13].T.reshape(-1), ws[18].T.reshape(-1),
                      ws[8][:, 0]])


_BWD_GATHER = {}  # device -> weight positions, built once


def pack_field_bwd_weights_gather(flat_eff, cd):
    """``pack_field_bwd_weights`` in one gather, as the wrapper runs it on
    every launch, the matrices cast to ``cd`` (``pack_field_weights_gather``'s
    method)."""
    from .fused_field import CANONICAL_SHAPES

    dev = flat_eff[0].device
    if dev not in _BWD_GATHER:
        sizes = [i * o for i, o in CANONICAL_SHAPES]
        pos = torch.arange(1, 1 + sum(sizes)).split(sizes)
        flat = []
        for wp, sh in zip(pos, CANONICAL_SHAPES):
            flat += [wp.reshape(sh), None]
        _BWD_GATHER[dev] = pack_field_bwd_weights(flat).to(dev)
    ws = flat_eff[0::2]
    return torch.cat([ws[0].new_zeros(1, dtype=cd), *(x.detach().to(cd).reshape(-1) for x in ws)])[_BWD_GATHER[dev]]


def unpack_field_bwd_weights(w):
    """The inverse of ``pack_field_bwd_weights``: (fwd, tr), the canonical
    (in, out) matrices read back from the panels the pass multiplies: fwd[l]
    (layers 0..7) from the tangent forward's panels, tr[l] (all 19 layers)
    from the transposed products' panels and, for layers 8, 13 and 18, the
    rows after them. Each is contiguous, as the operands are."""
    from .fused_field import CANONICAL_SHAPES

    panels = K1._swizzle(w[:BWD_W13_OFF].reshape(N_BWD_PANELS, K1.PANEL_ROWS, K1.PANEL_K))
    by = {}  # (part, layer) -> [panels in k0 order]
    for i, (part, l, _) in enumerate(BWD_PANELS):
        by.setdefault((part, l), []).append(panels[i])
    ks = lambda ps: torch.cat(list(ps), dim=1)  # (256 rows n, 64 * len k)
    fwd = [ks(by["fwd", l]).T[: i, : o].contiguous() for l, (i, o) in enumerate(CANONICAL_SHAPES[:8])]
    tr = []
    for l, (i, o) in enumerate(CANONICAL_SHAPES):
        if l == 8:
            m = torch.cat([w[BWD_W8_OFF:BWD_W_TOTAL, None], ks(by["tr8", 8])], dim=1)
        elif l in (9, 14):
            m = torch.cat([ks(by["trlead", l])[: N_LEAD[l]], ks(by["trfeat", l])], dim=0)
        elif l in (13, 18):
            m = (w[BWD_W13_OFF:BWD_W18_OFF] if l == 13 else w[BWD_W18_OFF:BWD_W8_OFF]).reshape(o, 256).T
        else:
            m = ks(by["tr", l])
        tr.append(m[:i, :o].contiguous())
    return fwd, tr


def field_bwd_plain_packed(flat_eff, x, d, res, cots, w, icfg, rcfg, compute_dtype):
    """``field_bwd_rowlocal_plain`` with every product's matrix read from the
    tensor-core row-local pass's packed buffer ``w``
    (``unpack_field_bwd_weights``): the tangent forward's from its forward
    panels, the transposed products' from theirs. flat_eff gives the shapes
    alone. Equal to ``field_bwd_rowlocal_plain`` bit for bit: the proof on
    the CPU that the packing holds every operand where the kernel reads it."""
    shapes = tuple(tuple(m.shape) for m in flat_eff[0::2])
    prods, dbs, dx, dd = _bwd_rowlocal(flat_eff, x, d, res, cots, icfg, rcfg, compute_dtype,
                                       mats=unpack_field_bwd_weights(w))
    return _rowlocal_outputs(prods, dbs, dx, dd, x.shape[0], compute_dtype, shapes)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

W_CD = 4057  # 7 x 256 + 217 implicit post-activations + 2 x 4 x 256 head ones
W_F32 = 296  # embedding (39) + z8 (257)


def _fwd_stash_launch(flat_eff, x, d, icfg: ImplicitNetConfig, cd, variant: str, packed=None):
    """K2-fwd by ``variant``; ``packed``: the "mma" kernel's weights as
    ``pack_field_weights_gather`` gives them, packed here when None."""
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
    P = _build.ptr
    if variant == "mma":
        w, b = pack_field_weights_gather(flat_eff, cd) if packed is None else packed
        err = _mma_entry("field_fwd_mma_stash")(
            P(x), P(d), P(w), P(b), P(sdf), P(grads), P(rgb), P(att), P(scd), P(sf32), n, _n_sm(x),
            icfg.sdf_bounding_sphere, icfg.sphere_scale, _build.stream_ptr(x),
        )
    else:
        w_all, wt_all, b_all = _pack_weights(flat_eff, cd)
        err = _entry("fused_field_stash", "field_fwd_stash", cd, 11, 1)(
            P(x), P(d), P(w_all), P(wt_all), P(b_all),
            P(sdf), P(grads), P(rgb), P(att), P(scd), P(sf32), n,
            icfg.sdf_bounding_sphere, icfg.sphere_scale, _build.stream_ptr(x),
        )
    _build.check(err, f"fused field forward kernel launch ({variant})")
    return sdf, grads, rgb, att, scd, sf32


def field_fwd_stash_kernel(flat_eff, x, d, icfg: ImplicitNetConfig, cd):
    """Launch K2-fwd: -> sdf (N,1), grads (N,3), rgb (N,3), att (N,6) f32,
    stash_cd (N, 4057) in ``cd``, stash_f32 (N, 296). bf16 runs the
    tensor-core kernel (``csrc/field_fwd_mma.cu``), f32 the scalar one."""
    out = _fwd_stash_launch(flat_eff, x, d, icfg, cd, "mma" if cd == torch.bfloat16 else "scalar")
    if x.shape[0]:
        field_fwd_stash_kernel.launches += 1
    return out


field_fwd_stash_kernel.launches = 0


def field_fwd_stash_kernel_variant(flat_eff, x, d, icfg: ImplicitNetConfig, cd, variant: str):
    """K2-fwd by one of ``FWD_VARIANTS`` on bf16 CUDA tensors, for holding the
    kernels against each other on the card; nothing on the model's path
    calls it and it is not counted."""
    if cd != torch.bfloat16:
        raise TypeError("the forward variants are bf16")
    if variant not in FWD_VARIANTS:
        raise ValueError(f"no forward variant {variant!r}")
    return _fwd_stash_launch(flat_eff, x, d, icfg, cd, variant)


def _mma_entry(name: str):
    """The C entry ``name`` of ``csrc/field_fwd_mma.cu``: ten pointers, n,
    the block cap, the sphere radius and scale, the stream."""
    fn = getattr(_build.load("field_fwd_mma"), name)
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


# the row-local passes that write the workspace: "mma", the tensor-core pass
# (``csrc/field_bwd_mma.cu``) that bf16 K2-bwd and, chunk by chunk, K3-bwd
# run; "split", the scalar tile with EMIT, which it is held against
ROWLOCAL_VARIANTS = ("mma", "split")
# the bf16 K2-bwds beside the model's (the "mma" row-local pass, then the
# GEMM of ``field_dw``): "split", the same with the scalar row-local pass;
# "scalar", the fused scalar kernel, which f32 runs and which the scalar
# K3-bwd is held against
BWD_VARIANTS = ("split", "scalar")
_WS_ROW_TABLE = (ctypes.c_int * len(DW.ws_row_table()))(*DW.ws_row_table())  # the producer's WsOut rows


def bwd_mma_table():
    """The tensor-core row-local pass's int table (its ``Tables``): the
    workspace rows (``ws_row_table``), each bias's offset in a block's
    partials and in the gradient vector (b_l after dW_l), then the gradient
    offset of dW_8 and its row length (layer 8's tangent column goes to
    dW_8[k][0])."""
    from .fused_field import CANONICAL_SHAPES

    outs = [o for _, o in CANONICAL_SHAPES]
    offs = DW.param_offsets()
    boff = [sum(outs[:l]) for l in range(len(outs) + 1)]
    gbias = [offs[l] + i * o for l, (i, o) in enumerate(CANONICAL_SHAPES)]
    return DW.ws_row_table() + boff + gbias + [offs[8], outs[8]]


_BWD_MMA_TABLE = (ctypes.c_int * len(bwd_mma_table()))(*bwd_mma_table())
# a block's bias partials: every bias, then layer 8's tangent column
_BWD_MMA_NB = _BWD_MMA_TABLE[len(DW.ws_row_table()) + N_IMPLICIT_LAYERS + 2 * N_HEAD_LAYERS] + 256


@functools.lru_cache(maxsize=None)
def _bwd_mma_layout(n: int, max_blocks: int):
    """(blocks, bias partial floats a block, scratch floats a block) of the
    tensor-core row-local pass for n points, as the C side decides them."""
    fn = _build.load("field_bwd_mma").field_bwd_mma_layout
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = None
    blocks, n_bias, scratch = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_longlong()
    fn(n, max_blocks, ctypes.byref(blocks), ctypes.byref(n_bias), ctypes.byref(scratch))
    return blocks.value, n_bias.value, scratch.value


def _bwd_rowlocal_launch(flat_eff, x, d, scd, sf32, rgb, grads, cots, icfg, cd, variant: str,
                         w_bwd=None):
    """K2-bwd's tile kernel and the sum of its per-block partials: (dparams,
    dx, dd, workspace). "scalar" (fused): dparams holds every gradient,
    workspace is None. "split" and "mma": dparams holds the bias gradients
    and layer 8's tangent column, its other dW entries 0; the workspace
    (``field_dw``) holds the weight-gradient operands. ``w_bwd``: the "mma"
    pass's weights as ``pack_field_bwd_weights_gather`` gives them, packed
    here when None."""
    n = x.shape[0]
    _check_cotangents(cots, n)
    if scd.shape != (n, W_CD) or scd.dtype != cd or sf32.shape != (n, W_F32):
        raise ValueError("stash shapes do not match the fused field kernel's layout")
    _check_operands(flat_eff, x, d, cd, (scd, sf32, rgb, grads, *cots))
    kw = dict(device=x.device)
    dx = torch.empty((n, 3), dtype=torch.float32, **kw)
    dd = torch.empty((n, 3), dtype=torch.float32, **kw)
    n_sm = _n_sm(x)
    P = _build.ptr
    ins = (P(x), P(d), P(scd), P(sf32), P(rgb), P(grads), *(P(c) for c in cots))
    ws = None
    if variant in ROWLOCAL_VARIANTS:
        width = DW.ws_points(n)
        ws = torch.empty((DW.WS_ROWS, width), dtype=torch.bfloat16, **kw)
        rows = ctypes.cast(_WS_ROW_TABLE, ctypes.c_void_p)
    if variant == "mma":
        n_blocks, n_bias, n_scratch = _bwd_mma_layout(n, n_sm)
        dparams = torch.zeros((sum(w.numel() for w in flat_eff),), dtype=torch.float32, **kw)
        partials = torch.empty((n_blocks, n_bias), dtype=torch.float32, **kw)
        scratch = torch.empty((n_blocks, n_scratch), dtype=torch.float32, **kw)
        fn = _build.load("field_bwd_mma").field_bwd_mma_rowlocal
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if n_bias != _BWD_MMA_NB:
            raise ValueError("the tensor-core row-local pass's bias partials do not match the layer table")
        if w_bwd is None:
            w_bwd = pack_field_bwd_weights_gather(flat_eff, cd)
        err = fn(*ins, P(w_bwd), P(dx), P(dd), P(dparams), P(partials),
                 P(scratch), P(ws), ctypes.cast(_BWD_MMA_TABLE, ctypes.c_void_p), n, n_sm, width,
                 icfg.sdf_bounding_sphere, icfg.sphere_scale, _build.stream_ptr(x))
        _build.check(err, "tensor-core row-local pass launch")
        return dparams, dx, dd, ws
    n_blocks, n_p, n_scratch = _bwd_layout(n, n_sm)
    if n_p != sum(w.numel() for w in flat_eff):
        raise ValueError("the fused field backward's layer table does not match the weights")
    dparams = torch.empty((n_p,), dtype=torch.float32, **kw)
    w_all, wt_all, _ = _pack_weights(flat_eff, cd)
    partials = torch.empty((n_blocks, n_p), dtype=torch.float32, **kw)
    scratch = torch.empty((n_blocks, n_scratch), dtype=torch.float32, **kw)
    args = (*ins, P(w_all), P(wt_all), P(dx), P(dd), P(dparams), P(partials), P(scratch))
    if variant == "split":
        covered = -(-n // 32) * 32  # the 32-point tiles write every column before this
        if covered < width:
            ws[:, covered:].zero_()
        err = _entry("fused_field_stash", "field_bwd_split", cd, 19, 3)(
            *args, P(ws), rows, n, n_sm, width, icfg.sdf_bounding_sphere, icfg.sphere_scale,
            _build.stream_ptr(x),
        )
    else:
        err = _entry("fused_field_stash", "field_bwd_stash", cd, 17, 2)(
            *args, n, n_sm, icfg.sdf_bounding_sphere, icfg.sphere_scale, _build.stream_ptr(x),
        )
    _build.check(err, f"fused field backward kernel launch ({variant})")
    return dparams, dx, dd, ws


def field_bwd_rowlocal_kernel(flat_eff, x, d, scd, sf32, rgb, grads, cots, icfg: ImplicitNetConfig,
                              variant: str = "mma"):
    """Launch the split K2-bwd's row-local pass (bf16; ``variant`` of
    ``ROWLOCAL_VARIANTS``, the model's by default): -> (dparams, dx, dd,
    workspace), as ``_bwd_rowlocal_launch`` describes them; its plain
    version is ``field_bwd_rowlocal_plain``."""
    out = _bwd_rowlocal_launch(flat_eff, x, d, scd, sf32, rgb, grads, cots, icfg, torch.bfloat16, variant)
    field_bwd_rowlocal_kernel.launches += 1
    return out


field_bwd_rowlocal_kernel.launches = 0


def _bwd_launch(flat_eff, x, d, scd, sf32, rgb, grads, cots, icfg, cd, variant: str):
    """K2-bwd whose row-local pass is ``variant``: "mma" or "split" (then the
    GEMM), or "scalar", the fused scalar kernel."""
    if variant in ROWLOCAL_VARIANTS:
        dparams, dx, dd, ws = field_bwd_rowlocal_kernel(flat_eff, x, d, scd, sf32, rgb, grads, cots, icfg,
                                                        variant)
        DW.field_dw_kernel(ws, x.shape[0], dparams)
    else:
        dparams, dx, dd, _ = _bwd_rowlocal_launch(flat_eff, x, d, scd, sf32, rgb, grads, cots, icfg, cd, variant)
    return _split_param_grads(dparams, flat_eff), dx, dd


def field_bwd_stash_kernel(flat_eff, x, d, scd, sf32, rgb, grads, cots, icfg: ImplicitNetConfig, cd):
    """Launch K2-bwd: -> (deff (38 f32 tensors shaped like flat_eff), dx (N,3),
    dd (N,3)). ``cots`` are the contiguous f32 cotangents (N,1), (N,3), (N,3),
    (N,6). bf16 runs the split backward (the tensor-core row-local pass,
    then the weight-gradient GEMM of ``field_dw``), f32 the fused scalar
    kernel."""
    out = _bwd_launch(flat_eff, x, d, scd, sf32, rgb, grads, cots, icfg, cd,
                      "mma" if cd == torch.bfloat16 else "scalar")
    field_bwd_stash_kernel.launches += 1
    return out


field_bwd_stash_kernel.launches = 0


def field_bwd_stash_kernel_variant(flat_eff, x, d, scd, sf32, rgb, grads, cots, icfg: ImplicitNetConfig,
                                   cd, variant: str):
    """K2-bwd by one of ``BWD_VARIANTS`` on bf16 CUDA tensors, for holding the
    kernels against each other on the card; nothing on the model's path
    calls it, and only the "split" variant's own kernels count their launches."""
    if cd != torch.bfloat16:
        raise TypeError("the backward variants are bf16")
    if variant not in BWD_VARIANTS:
        raise ValueError(f"no backward variant {variant!r}")
    return _bwd_launch(flat_eff, x, d, scd, sf32, rgb, grads, cots, icfg, cd, variant)


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
    def backward(ctx, *grads_out):
        icfg, rcfg, cd = ctx.cfg
        x, d, scd, sf32, rgb, grads, *flat_eff = ctx.saved_tensors
        cots = _cotangents(x, grads_out)
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
    ``rendering`` and ``attraction`` layer stacks.

    When nothing is differentiated (grad mode off, or no operand requires
    a gradient) it runs the forward that keeps no residuals instead, K3-fwd
    (``fused_field.field_primal``): no stash is written, no autograd node
    built, as the JAX op's primal does."""
    cd = _DTYPES[compute_dtype]
    if points.is_cuda and not supports_fused_field(icfg, rcfg, acfg):
        raise ValueError("fused field kernels take the canonical 8x256 / 4x256 architecture only")
    if _differentiated(model, points, dirs):
        sdf, grads, rgb, att = _FusedFieldStash.apply(icfg, rcfg, cd, points, dirs, *_flatten_eff(model))
    else:
        flat_eff = resolved_operands(model, points, cd)
        sdf, grads, rgb, att = field_primal(flat_eff, points, dirs, icfg, rcfg, cd)
    lines3d = points[..., None, :] + att.reshape(*points.shape[:-1], 2, 3)
    return sdf, grads, rgb, lines3d
