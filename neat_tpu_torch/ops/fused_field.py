"""K3: the fused field evaluation that keeps no residuals (K3-fwd) and the
backward that re-runs the forward (K3-bwd); and the helpers both field
kernel pairs share.

Replaces ``neat_tpu/ops/fused_field.py:_fwd_kernel`` (launched by
``_fwd_pallas``) and ``_bwd_kernel`` (``_bwd_pallas``). The math is
``field_math`` below, the JAX package's ``_field_math`` in plain PyTorch:
the 9-layer implicit chain with the sphere clamp, the spatial gradient of
the clamped sdf by autograd, and the two heads. ``torch.autograd`` of
``field_math`` is the plain version of the scalar K3-bwd, as
``jax.vjp(_field_math)`` is the body of the TPU kernel.

What bounds them on the H100: operations. K3-fwd does the stashing
forward's 3.04 MFLOP per point and moves 76 bytes per point instead of
9.3 KB; K3-bwd does forward plus backward, 10.04 MFLOP per point, and
moves 100 bytes per point plus the gradients.

What the design does about it. bf16 K3-fwd is the tensor-core forward
(``csrc/field_fwd_mma.cu``, shared with K2-fwd). bf16 K3-bwd is the split
backward of K2 run chunk by chunk (``RECOMPUTE_CHUNK`` points): the same
tensor-core forward recomputes the chunk's stash, the row-local pass
(``fused_field_stash``) writes the chunk's weight-gradient operands into a
workspace, and the GEMM of ``field_dw`` adds them into one f32 gradient
vector, the chunks' bias gradients summed in chunk order. So the backward
differentiates the activations K3-fwd returned, no stash outlives a chunk,
and a chunk's stash and workspace (0.57 GB) stay well below the 3.5 GB the
stashing path keeps at the main path's size. Its plain version is
``fused_field_stash.field_bwd_recompute_split_plain``, in the same chunks.

f32 K3-fwd, on the no-grad route of finalize and render eval
(``field_primal``), is the bf16 forward's design with f32 operands as
3xTF32 products (``csrc/field_fwd_tf32.cu``; ``tf32.py`` holds the split,
the 391 packed pairs of hi/lo panels a tile reads and the CPU model). One
TF32 product puts the spatial gradient 8e-3 of its scale off f64 (plain
f32: 7e-6); three, each pair's sum taken by the tensor core from zero and
added in f32, are within 1.5x plain f32's error on every output
(tests/test_torch_tf32_field_design.py prints them). The post-activations the sweep
needs go to a per-block scratch straight from the accumulator fragments.
The recompute pair under autograd (``_FusedField``) keeps the scalar
forward in f32: its backward re-runs the scalar tile and differentiates
the activations its forward returned.

The f32 K3-bwd keeps the first, scalar kernels (``csrc/fused_field.cu``),
and bf16 has them as the "scalar" variants, as f32 K3-fwd does. Both are
persistent: one 256-thread block per SM walks the 32-point tiles; the forward's reverse sweep needs the
eight post-activations of the tile, which go to a per-block scratch in the
stash's column layout (32 x 4057 compute-dtype values, L2-resident,
rewritten by every tile) instead of an (N, 4057) array. The scalar K3-bwd
runs the same forward tile into that scratch, with the f32 embedding, z8,
rgb and grads beside it, and then the stash-replaying backward's tile body
on the scratch: one forward body and one backward body serve K2 and K3
(``csrc/field_tile.cuh``). Parameter gradients are per-block f32 partials
summed in block order, as in K2-bwd. In f32 the result is
``torch.autograd`` of ``field_math`` up to summation order. In bf16 the
backward rounds each product's operands to bf16 (the stash backward's
choice), where autograd rounds the activation cotangents only.

How it can be checked: on the same inputs K3-bwd equals K2-fwd followed by
K2-bwd: the split one, in dx and dd entry for entry and in the gradients up
to the order of their sums (bf16); the scalar ones entry for entry (f32,
and the bf16 "scalar" variants). Against autograd of ``field_math`` only
the forward agrees entry for entry: the backward re-runs the forward, and a
relu whose pre-activation two summation orders put on different sides of 0
changes that point's whole backward, so among thousands of points a few
differ, in f32 too. That comparison is held in relative L2 norm
(``chip_smoke.py`` states the limits and prints autograd's difference from
itself beside it).

The TPU package's ceiling on differentiated points
(``MAX_FUSED_FIELD_BWD_POINTS``) guarded a fault of that machine and has no
counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from ..fields.mlp import (
    ImplicitNetConfig,
    LayerStack,
    RenderNetConfig,
    _input_grad,
    _skip_concat,
    _softplus100,
)
from . import _build, tf32

N_IMPLICIT_LAYERS = 9
N_HEAD_LAYERS = 5  # rendering / attraction MLPs: 4 hidden + 1 out
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64}
# canonical (in, out) widths of the 19 layers: implicit, rendering, attraction
CANONICAL_SHAPES = (
    ((39, 256), (256, 256), (256, 256), (256, 217)) + ((256, 256),) * 4 + ((256, 257),)
    + ((289, 256),) + ((256, 256),) * 3 + ((256, 3),)
    + ((265, 256),) + ((256, 256),) * 3 + ((256, 6),)
)
OUT_WIDTHS = (1, 3, 3, 6)  # sdf, grads, rgb, att


def supports_fused_field(
    icfg: ImplicitNetConfig, rcfg: RenderNetConfig, acfg: RenderNetConfig
) -> bool:
    """The canonical architecture the CUDA field kernels are written for."""
    return (
        tuple(icfg.dims) == (256,) * 8
        and tuple(icfg.skip_in) == (4,)
        and icfg.multires == 6
        and icfg.d_in == 3
        and icfg.d_out == 1
        and icfg.feature_vector_size == 256
        and not icfg.inside_out
        and icfg.sdf_bounding_sphere > 0.0
        and rcfg.mode == "idr"
        and tuple(rcfg.dims) == (256,) * 4
        and rcfg.d_out == 3
        and rcfg.multires_view == 4
        and acfg.mode == "idr"
        and tuple(acfg.dims) == (256,) * 4
        and acfg.d_out == 6
        and acfg.multires_view == 0
    )


def supports_field_math(icfg: ImplicitNetConfig, rcfg: RenderNetConfig, acfg: RenderNetConfig) -> bool:
    """The layer structure the plain field math assumes at any width: 9
    implicit layers with the skip at 4 and 5-layer idr heads."""
    return (
        len(icfg.dims) == 8
        and tuple(icfg.skip_in) == (4,)
        and icfg.multires > 0
        and icfg.d_out == 1
        and not icfg.inside_out
        and rcfg.mode == acfg.mode == "idr"
        and len(rcfg.dims) == len(acfg.dims) == 4
        and acfg.multires_view == 0
    )


def _resolve_weights(net: LayerStack, n_layers: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Weight-norm resolution -> [(W (in, out), b (out,)), ...]; differentiable."""
    return [(net[l].weight().T, net[l].b) for l in range(n_layers)]


def _flatten_eff(model) -> Tuple[torch.Tensor, ...]:
    """The three nets resolved into the 38 kernel operands W0, b0, W1, ...
    (biases as (1, out) rows, as in the JAX package)."""
    flat = []
    for net, n in (
        (model.implicit, N_IMPLICIT_LAYERS),
        (model.rendering, N_HEAD_LAYERS),
        (model.attraction, N_HEAD_LAYERS),
    ):
        for w, b in _resolve_weights(net, n):
            flat.append(w)
            flat.append(b[None, :])
    return tuple(flat)


def _unflatten_eff(flat: Sequence[torch.Tensor]):
    pairs = [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
    iw = pairs[:N_IMPLICIT_LAYERS]
    rw = pairs[N_IMPLICIT_LAYERS : N_IMPLICIT_LAYERS + N_HEAD_LAYERS]
    aw = pairs[N_IMPLICIT_LAYERS + N_HEAD_LAYERS :]
    return iw, rw, aw


def _pe(x: torch.Tensor, multires: int) -> torch.Tensor:
    """Positional encoding [x, sin f0 x, cos f0 x, ...] as a flat concat."""
    if multires <= 0:
        return x
    outs = [x]
    for k in range(multires):
        f = float(2.0**k)
        outs.append(torch.sin(f * x))
        outs.append(torch.cos(f * x))
    return torch.cat(outs, dim=-1)


def _mm(h, w, cd, el):
    """dot(h.astype(cd), w.astype(cd)) with el accumulation."""
    return h.to(cd).to(el) @ w.to(cd).to(el)


def _sphere(x, icfg: ImplicitNetConfig):
    """(|x|, scale * (R - |x|)), the bounding-sphere branch of the sdf
    clamp; (None, None) when the clamp is off."""
    if icfg.sdf_bounding_sphere > 0.0:
        norm_x = torch.linalg.norm(x, dim=-1, keepdim=True)
        return norm_x, icfg.sphere_scale * (icfg.sdf_bounding_sphere - norm_x)
    return None, None


def _implicit_chain(iw, e_cd, cd, el, mm=None):
    """The 9 implicit layers on the compute-dtype embedding: (z8 in el, the
    eight post-activations in cd). ``mm``: the product in ``_mm``'s place."""
    mm = mm or _mm
    posts = []
    h = e_cd
    for l in range(N_IMPLICIT_LAYERS):
        if l == 4:
            h = _skip_concat(h, e_cd)
        w, b = iw[l]
        z = mm(h, w, cd, el) + b
        if l < N_IMPLICIT_LAYERS - 1:
            h = _softplus100(z).to(cd)
            posts.append(h)
    return z, posts


def _head(weights, inp, cd, el, mm=None):
    """A 5-layer relu head: (output in el, the four post-activations in cd)."""
    mm = mm or _mm
    posts = []
    h = inp.to(cd)
    for l in range(N_HEAD_LAYERS):
        w, b = weights[l]
        h = mm(h, w, cd, el) + b
        if l < N_HEAD_LAYERS - 1:
            h = torch.clamp(h, min=0.0).to(cd)
            posts.append(h)
    return h, posts


def field_math(flat_eff, x, d, icfg: ImplicitNetConfig, rcfg: RenderNetConfig, compute_dtype, mm=None):
    """The per-point field math: (sdf (N,1), grads (N,3), rgb (N,3),
    att (N,6)) from the 38 resolved operands, points x and directions d.

    ``att`` is the raw offset head; the caller assembles the endpoints. The
    spatial gradient is autograd's, of the clamped sdf; when the caller
    records a graph it is recorded through the gradient too, so the
    outputs differentiate to second order. ``mm(h, w, cd, el)``: every
    product in ``_mm``'s place (``tf32`` models the tensor cores' f32
    products with it)."""
    iw, rw, aw = _unflatten_eff(flat_eff)
    cd = compute_dtype
    el = torch.promote_types(torch.float32, cd)

    def implicit_with_clamp(pts):
        z8, _ = _implicit_chain(iw, _pe(pts, icfg.multires).to(cd), cd, el, mm)
        sdf_raw, feats = z8[..., :1], z8[..., 1:]
        _, sphere = _sphere(pts, icfg)
        return (torch.minimum(sdf_raw, sphere) if sphere is not None else sdf_raw), feats

    (sdf, feats), grads = _input_grad(implicit_with_clamp, x)
    d_enc = _pe(d, rcfg.multires_view) if rcfg.multires_view > 0 else d
    zr, _ = _head(rw, torch.cat([x, d_enc, grads, feats], dim=-1), cd, el, mm)
    att, _ = _head(aw, torch.cat([x, d, grads, feats], dim=-1), cd, el, mm)
    return sdf, grads, torch.sigmoid(zr), att


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------


def _check_operands(flat_eff, x, d, cd, tensors=()):
    """Raise on anything the field kernels do not take."""
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


def _check_cotangents(cots, n):
    for c, w in zip(cots, OUT_WIDTHS):
        if c.shape != (n, w) or c.dtype != torch.float32:
            raise ValueError("fused field backward takes f32 cotangents shaped like its outputs")


def _pack_weights(flat_eff, cd):
    """W (in, out) and W^T (out, in) of the 19 layers in ``cd``, biases in f32."""
    ws, bs = flat_eff[0::2], flat_eff[1::2]
    w_all = torch.cat([w.detach().to(cd).reshape(-1) for w in ws])
    wt_all = torch.cat([w.detach().T.to(cd).reshape(-1) for w in ws])
    b_all = torch.cat([b.detach().to(torch.float32).reshape(-1) for b in bs])
    return w_all, wt_all, b_all


def _n_param_grads() -> int:
    return sum(i * o + o for i, o in CANONICAL_SHAPES)


def _entry(lib: str, name: str, cd, n_ptr: int, n_int: int):
    """The C entry ``name`` of ``csrc/<lib>.cu`` for ``cd``: n_ptr pointers,
    n_int ints, the sphere radius and scale, the stream."""
    fn = getattr(_build.load(lib), f"{name}_{'bf16' if cd == torch.bfloat16 else 'f32'}")
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _split_param_grads(dparams, flat_eff):
    """The packed f32 gradient vector as 38 views shaped like the operands."""
    deff, o = [], 0
    for w in flat_eff:
        deff.append(dparams[o : o + w.numel()].view(w.shape))
        o += w.numel()
    return tuple(deff)


def _layout(n: int, max_blocks: int):
    """(blocks, f32 gradients, per-block scratch of the forward in cd values,
    of the backward in cd values, of the backward in f32 values) for n points,
    as the C side decides them."""
    fn = _build.load("fused_field").field_layout
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = None
    blocks = ctypes.c_int()
    sizes = [ctypes.c_longlong() for _ in range(4)]
    fn(n, max_blocks, ctypes.byref(blocks), *(ctypes.byref(s) for s in sizes))
    return (blocks.value, *(s.value for s in sizes))


def _n_sm(t) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _fwd_launch(flat_eff, x, d, icfg: ImplicitNetConfig, cd, variant: str):
    _check_operands(flat_eff, x, d, cd)
    n = x.shape[0]
    kw = dict(dtype=torch.float32, device=x.device)
    outs = tuple(torch.empty((n, w), **kw) for w in OUT_WIDTHS)
    if n == 0:
        return outs
    n_sm = _n_sm(x)
    P = _build.ptr
    if variant == "tf32":
        n_blocks, s_f32 = _tf32_layout(n, n_sm)
        scratch = torch.empty((n_blocks, s_f32), **kw)
        w, b = _TF32_PACKED.get(flat_eff, lambda: tf32.pack_field_weights_tf32(flat_eff))
        fn = _build.load("field_fwd_tf32").field_fwd_tf32
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(
            P(x), P(d), P(w), P(b), *(P(o) for o in outs), P(scratch),
            n, n_sm, icfg.sdf_bounding_sphere, icfg.sphere_scale, _build.stream_ptr(x),
        )
    elif variant == "mma":
        from .fused_field_stash import _mma_entry, pack_field_weights_gather

        n_blocks, s_cd, s_f32 = _mma_layout(n, n_sm)
        scratch_cd = torch.empty((n_blocks, s_cd), dtype=cd, device=x.device)
        scratch_f32 = torch.empty((n_blocks, s_f32), **kw)
        w, b = pack_field_weights_gather(flat_eff, cd)
        err = _mma_entry("field_fwd_mma_primal")(
            P(x), P(d), P(w), P(b), *(P(o) for o in outs), P(scratch_cd), P(scratch_f32),
            n, n_sm, icfg.sdf_bounding_sphere, icfg.sphere_scale, _build.stream_ptr(x),
        )
    else:
        n_blocks, _, fwd_cd, _, _ = _layout(n, n_sm)
        scratch = torch.empty((n_blocks, fwd_cd), dtype=cd, device=x.device)
        w_all, wt_all, b_all = _pack_weights(flat_eff, cd)
        err = _entry("fused_field", "field_fwd", cd, 10, 2)(
            P(x), P(d), P(w_all), P(wt_all), P(b_all), *(P(o) for o in outs), P(scratch),
            n, n_sm, icfg.sdf_bounding_sphere, icfg.sphere_scale, _build.stream_ptr(x),
        )
    _build.check(err, f"fused field recompute forward kernel launch ({variant})")
    return outs


@functools.lru_cache(maxsize=None)
def _mma_layout(n: int, max_blocks: int):
    """(blocks, per-block scratch in cd values, in f32 values) of the
    tensor-core forward for n points, as the C side decides them."""
    fn = _build.load("field_fwd_mma").field_fwd_mma_layout
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = None
    blocks, s_cd, s_f32 = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_longlong()
    fn(n, max_blocks, ctypes.byref(blocks), ctypes.byref(s_cd), ctypes.byref(s_f32))
    return blocks.value, s_cd.value, s_f32.value


@functools.lru_cache(maxsize=None)
def _tf32_layout(n: int, max_blocks: int):
    """(blocks, per-block scratch in f32 values) of the f32 tensor-core
    forward for n points, as the C side decides them."""
    fn = _build.load("field_fwd_tf32").field_fwd_tf32_layout
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2
    fn.restype = None
    blocks, s_f32 = ctypes.c_int(), ctypes.c_longlong()
    fn(n, max_blocks, ctypes.byref(blocks), ctypes.byref(s_f32))
    return blocks.value, s_f32.value


_TF32_PACKED = tf32.TensorCache()  # the last weights the tf32 forward was handed, split and packed


def fwd_variant(cd, pair: bool = False) -> str:
    """The K3-fwd kernel for compute dtype ``cd``: bf16 the tensor-core
    kernel ("mma"); f32 the 3xTF32 one ("tf32"), but the recompute pair's
    forward under autograd (``pair``) the scalar tile ("scalar"), which the
    f32 K3-bwd re-runs: its backward differentiates the activations its
    forward returned."""
    if cd == torch.bfloat16:
        return "mma"
    return "scalar" if pair else "tf32"


def field_fwd_kernel(flat_eff, x, d, icfg: ImplicitNetConfig, cd, pair: bool = False):
    """Launch K3-fwd: -> sdf (N,1), grads (N,3), rgb (N,3), att (N,6) f32.
    Nothing else reaches device memory but a per-block scratch. The kernel
    is ``fwd_variant(cd, pair)``'s: bf16 ``csrc/field_fwd_mma.cu``, f32
    ``csrc/field_fwd_tf32.cu``, and the recompute pair's f32 forward the
    scalar ``csrc/fused_field.cu``; each is counted here."""
    outs = _fwd_launch(flat_eff, x, d, icfg, cd, fwd_variant(cd, pair))
    if x.shape[0]:
        field_fwd_kernel.launches += 1
    return outs


field_fwd_kernel.launches = 0


# the bf16 forwards: the tensor-core kernel the model runs, the scalar one
# of the first port (K2-fwd's too)
FWD_VARIANTS = ("mma", "scalar")
# the f32 ones: the 3xTF32 kernel, the scalar one of the first port
F32_FWD_VARIANTS = ("tf32", "scalar")


def field_fwd_kernel_variant(flat_eff, x, d, icfg: ImplicitNetConfig, cd, variant: str):
    """K3-fwd by one of ``FWD_VARIANTS`` on bf16 CUDA tensors or of
    ``F32_FWD_VARIANTS`` on f32 ones, for holding the kernels against each
    other on the card; nothing on the model's path calls it and it is not
    counted. A bf16 kernel's name with f32 compute raises TypeError."""
    if cd == torch.float32 and variant in F32_FWD_VARIANTS:
        return _fwd_launch(flat_eff, x, d, icfg, cd, variant)
    if cd != torch.bfloat16:
        raise TypeError(f"{variant!r} is not a forward variant for {cd}")
    if variant not in FWD_VARIANTS:
        raise ValueError(f"no forward variant {variant!r}")
    return _fwd_launch(flat_eff, x, d, icfg, cd, variant)


def _bwd_scalar_launch(flat_eff, x, d, cots, icfg: ImplicitNetConfig, cd):
    """The fused scalar K3-bwd (``csrc/fused_field.cu``) and the sum of its
    per-block partial gradients: (dparams, dx, dd)."""
    n = x.shape[0]
    kw = dict(dtype=torch.float32, device=x.device)
    dx, dd = torch.empty((n, 3), **kw), torch.empty((n, 3), **kw)
    n_sm = _n_sm(x)
    n_blocks, n_p, _, bwd_cd, bwd_f32 = _layout(n, n_sm)
    if n_p != sum(w.numel() for w in flat_eff):
        raise ValueError("the fused field backward's layer table does not match the weights")
    dparams = torch.empty((n_p,), **kw)
    partials = torch.empty((n_blocks, n_p), **kw)
    scratch_cd = torch.empty((n_blocks, bwd_cd), dtype=cd, device=x.device)
    scratch_f32 = torch.empty((n_blocks, bwd_f32), **kw)
    w_all, wt_all, b_all = _pack_weights(flat_eff, cd)
    P = _build.ptr
    err = _entry("fused_field", "field_bwd", cd, 15, 2)(
        P(x), P(d), *(P(c) for c in cots), P(w_all), P(wt_all), P(b_all),
        P(dx), P(dd), P(dparams), P(partials), P(scratch_cd), P(scratch_f32),
        n, n_sm, icfg.sdf_bounding_sphere, icfg.sphere_scale, _build.stream_ptr(x),
    )
    _build.check(err, "fused field recompute backward kernel launch")
    return dparams, dx, dd


# K3-bwd in bf16 runs the split backward over chunks of this many points (a
# multiple of the tensor-core forward's 128-point tile and of the workspace's
# 64-point chunk): a chunk's stash is 152 MB and its workspace 421 MB (9,298
# and 25,704 bytes a point), where K2 keeps 0.93 + 2.58 GB at the main path's
# 100,352 points
RECOMPUTE_CHUNK = 16_384


def recompute_chunks(n: int, chunk: int = RECOMPUTE_CHUNK) -> List[Tuple[int, int]]:
    """[start, end) of each chunk of n points, in order."""
    return [(c0, min(c0 + chunk, n)) for c0 in range(0, n, chunk)]


def field_bwd_chunk_fwd(flat_eff, x, d, icfg: ImplicitNetConfig, packed=None):
    """K3-bwd's recompute of one chunk: K2-fwd's tensor-core entry with its
    stash (``field_fwd_mma_stash``), counted here and not by K2-fwd: ->
    sdf, grads, rgb, att, stash_cd, stash_f32. ``packed``: its weights
    (``pack_field_weights_gather``), packed here when None."""
    from .fused_field_stash import _fwd_stash_launch

    out = _fwd_stash_launch(flat_eff, x, d, icfg, torch.bfloat16, "mma", packed)
    field_bwd_chunk_fwd.launches += 1
    return out


def field_bwd_chunk_rowlocal(flat_eff, x, d, scd, sf32, rgb, grads, cots, icfg: ImplicitNetConfig,
                             w_bwd=None):
    """The split backward's tensor-core row-local pass on one chunk's stash:
    -> (dparams, dx, dd, workspace), as
    ``fused_field_stash._bwd_rowlocal_launch`` returns them. ``w_bwd``: its
    weights (``pack_field_bwd_weights_gather``), packed here when None."""
    from .fused_field_stash import _bwd_rowlocal_launch

    out = _bwd_rowlocal_launch(flat_eff, x, d, scd, sf32, rgb, grads, cots, icfg, torch.bfloat16, "mma", w_bwd)
    field_bwd_chunk_rowlocal.launches += 1
    return out


def field_bwd_chunk_dw(ws, n: int, dparams) -> None:
    """The weight-gradient GEMM on one chunk's workspace, added into dparams."""
    from .field_dw import dw_launch

    dw_launch(ws, n, dparams)
    field_bwd_chunk_dw.launches += 1


for _fn in (field_bwd_chunk_fwd, field_bwd_chunk_rowlocal, field_bwd_chunk_dw):
    _fn.launches = 0


def _bwd_split_launch(flat_eff, x, d, cots, icfg: ImplicitNetConfig):
    """bf16 K3-bwd as the split backward, chunk by chunk: the tensor-core
    forward with its stash, the row-local pass on it, the GEMM on its
    workspace. So the activations it differentiates are K3-fwd's own. Both
    kernels' weights are packed once for all chunks. Each chunk's gradients
    (bias partials, then the GEMM's dW added in place) are summed into one
    f32 vector in chunk order: (dparams, dx, dd)."""
    from .fused_field_stash import pack_field_bwd_weights_gather, pack_field_weights_gather

    n = x.shape[0]
    kw = dict(dtype=torch.float32, device=x.device)
    dx, dd = torch.empty((n, 3), **kw), torch.empty((n, 3), **kw)
    dparams = torch.zeros((_n_param_grads(),), **kw)
    packed = pack_field_weights_gather(flat_eff, torch.bfloat16)
    w_bwd = pack_field_bwd_weights_gather(flat_eff, torch.bfloat16)
    for c0, c1 in recompute_chunks(n):
        xc, dc, cc = x[c0:c1], d[c0:c1], tuple(c[c0:c1] for c in cots)
        _, grads, rgb, _, scd, sf32 = field_bwd_chunk_fwd(flat_eff, xc, dc, icfg, packed)
        part, dx[c0:c1], dd[c0:c1], ws = field_bwd_chunk_rowlocal(
            flat_eff, xc, dc, scd, sf32, rgb, grads, cc, icfg, w_bwd)
        del scd, sf32  # the stash is spent: the GEMM reads the workspace
        field_bwd_chunk_dw(ws, c1 - c0, part)
        dparams += part
    return dparams, dx, dd


# the bf16 K3-bwd beside the model's (the split backward over chunks):
# "scalar", the fused scalar kernel that re-runs the scalar forward tile,
# which f32 runs
BWD_VARIANTS = ("scalar",)


def _bwd_launch(flat_eff, x, d, cots, icfg: ImplicitNetConfig, cd, variant: str):
    _check_cotangents(cots, x.shape[0])
    _check_operands(flat_eff, x, d, cd, cots)
    if variant == "scalar":
        dparams, dx, dd = _bwd_scalar_launch(flat_eff, x, d, cots, icfg, cd)
    else:
        dparams, dx, dd = _bwd_split_launch(flat_eff, x, d, cots, icfg)
    return _split_param_grads(dparams, flat_eff), dx, dd


def field_bwd_kernel(flat_eff, x, d, cots, icfg: ImplicitNetConfig, cd):
    """Launch K3-bwd: -> (deff (38 f32 tensors shaped like flat_eff), dx (N,3),
    dd (N,3)). ``cots`` are the contiguous f32 cotangents (N,1), (N,3), (N,3),
    (N,6). bf16 runs the split backward over chunks of ``RECOMPUTE_CHUNK``
    points, f32 the fused scalar kernel."""
    out = _bwd_launch(flat_eff, x, d, cots, icfg, cd, "split" if cd == torch.bfloat16 else "scalar")
    field_bwd_kernel.launches += 1
    return out


field_bwd_kernel.launches = 0


def field_bwd_kernel_variant(flat_eff, x, d, cots, icfg: ImplicitNetConfig, cd, variant: str):
    """K3-bwd by one of ``BWD_VARIANTS`` on bf16 CUDA tensors, for holding
    the kernels against each other on the card; nothing on the model's path
    calls it and it is not counted."""
    if cd != torch.bfloat16:
        raise TypeError("the backward variants are bf16")
    if variant not in BWD_VARIANTS:
        raise ValueError(f"no backward variant {variant!r}")
    return _bwd_launch(flat_eff, x, d, cots, icfg, cd, variant)


# ---------------------------------------------------------------------------
# autograd op
# ---------------------------------------------------------------------------


def _cotangents(x, grads_out):
    """Contiguous f32 cotangents, zeros where autograd passed None."""
    return tuple(
        torch.zeros((x.shape[0], w), dtype=x.dtype, device=x.device)
        if c is None else c.contiguous()
        for c, w in zip(grads_out, OUT_WIDTHS)
    )


def field_primal(flat_eff, x, d, icfg, rcfg, cd, pair: bool = False):
    """The four outputs with no autograd node and no residuals: K3-fwd on
    CUDA tensors (``pair``: the recompute pair's forward, ``fwd_variant``),
    ``field_math`` on CPU tensors."""
    with torch.no_grad():
        if x.is_cuda:
            return field_fwd_kernel(flat_eff, x, d, icfg, cd, pair)
        return field_math(flat_eff, x, d, icfg, rcfg, cd)


_RESOLVED = tf32.TensorCache()  # the last model's f32 operands, resolved for the tf32 forward


def resolved_operands(model, x, cd):
    """``_flatten_eff(model)`` for a forward that nothing differentiates.
    For the f32 kernel the same tensors come back while the model's
    parameters stand, so the kernel splits and packs them once."""
    if not (x.is_cuda and cd == torch.float32):
        return _flatten_eff(model)
    params = [*model.implicit.parameters(), *model.rendering.parameters(), *model.attraction.parameters()]
    with torch.no_grad():
        return _RESOLVED.get(params, lambda: _flatten_eff(model))


class _FusedField(torch.autograd.Function):
    """The recompute pair as one autograd op: the forward saves only its
    inputs, the backward re-runs the forward. CUDA tensors launch K3-fwd /
    K3-bwd; CPU tensors run ``field_math`` and its autograd."""

    @staticmethod
    def forward(ctx, icfg, rcfg, cd, x, d, *flat_eff):
        ctx.cfg = (icfg, rcfg, cd)
        ctx.save_for_backward(x, d, *flat_eff)
        return field_primal(flat_eff, x, d, icfg, rcfg, cd, pair=True)

    @staticmethod
    def backward(ctx, *grads_out):
        icfg, rcfg, cd = ctx.cfg
        x, d, *flat_eff = ctx.saved_tensors
        cots = _cotangents(x, grads_out)
        if x.is_cuda:
            deff, dx, dd = field_bwd_kernel(flat_eff, x, d, cots, icfg, cd)
        else:
            leaves = [t.detach().requires_grad_(True) for t in (*flat_eff, x, d)]
            with torch.enable_grad():
                outs = field_math(leaves[:-2], leaves[-2], leaves[-1], icfg, rcfg, cd)
            *deff, dx, dd = torch.autograd.grad(outs, leaves, cots)
        return (None, None, None, dx, dd, *deff)


def _differentiated(model, points, dirs) -> bool:
    """Whether a graph is recorded through the field: grad mode is on and
    the points, the directions or a parameter of the three nets require a
    gradient."""
    nets = (model.implicit, model.rendering, model.attraction)
    return torch.is_grad_enabled() and (
        points.requires_grad or dirs.requires_grad
        or any(p.requires_grad for net in nets for p in net.parameters())
    )


def fused_field_eval(
    model,
    points: torch.Tensor,
    dirs: torch.Tensor,
    icfg: ImplicitNetConfig,
    rcfg: RenderNetConfig,
    compute_dtype: str = "bfloat16",
    acfg: RenderNetConfig = RenderNetConfig(d_out=6, multires_view=0),
):
    """Main-pass field evaluation through K3: (sdf (N,1), grads (N,3),
    rgb (N,3), lines3d (N,2,3)), differentiable w.r.t. the model's weights,
    the points and the directions. ``model`` holds the ``implicit``,
    ``rendering`` and ``attraction`` layer stacks.

    When nothing is differentiated (grad mode off, or no operand requires
    a gradient) it runs ``field_primal`` alone, no autograd node: in f32 the
    3xTF32 kernel, where the pair under autograd runs the scalar forward
    its backward re-runs."""
    cd = _DTYPES[compute_dtype]
    if points.is_cuda and not supports_fused_field(icfg, rcfg, acfg):
        raise ValueError("fused field kernels take the canonical 8x256 / 4x256 architecture only")
    if _differentiated(model, points, dirs):
        flat_eff = _flatten_eff(model)
        sdf, grads, rgb, att = _FusedField.apply(icfg, rcfg, cd, points, dirs, *flat_eff)
    else:
        flat_eff = resolved_operands(model, points, cd)
        sdf, grads, rgb, att = field_primal(flat_eff, points, dirs, icfg, rcfg, cd)
    lines3d = points[..., None, :] + att.reshape(*points.shape[:-1], 2, 3)
    return sdf, grads, rgb, lines3d
