"""K1: the fused SDF-MLP evaluation of the ray sampler.

Replaces ``neat_tpu/ops/fused_sdf.py:_kernel`` (launched by
``_fused_sdf_impl``, public ``fused_sdf_eval``) with the CUDA kernel in
``csrc/fused_sdf.cu``.

What it computes: the 9-layer SDF MLP, sdf channel only, on the sampler's
proposal points (up to 5 x 128 per ray, ~6.5e5 per training step): four
layers of [matmul + softplus(100x)/100], the skip concat with the input
times 1/sqrt(2), four more layers, then the final 256 -> 1 layer. The
positional encoding, the weight-norm resolution, the final-layer slice and
the sphere clamp stay outside the kernel in plain torch, as they stay in
XLA in the JAX package. No gradient: the proposals are constants.

What bounds it on the H100: operations, and the softplus epilogue. 0.918
MFLOP per point against 78 input bytes (bf16) and 4 output bytes, so even at
the tensor-core rate (989 TFLOP/s) it sits far above the ridge point. With
the products on the tensor cores, the 2,009 softplus evaluations a point (an
exponential and a logarithm each, on the CUDA cores and the special-function
unit) cost as much as the products.

What the design does about it (bf16; ``csrc/fused_sdf.cu``,
``csrc/mma_tile.cuh``): products are ``wgmma.mma_async.m64n256k16`` (bf16 x
bf16 summed in f32): four warps multiply 64 rows together, A from registers
(each warp's ``ldmatrix`` of its own 16 rows), B from shared memory, read
once per warpgroup. A block of two warpgroups owns 128 points; one block per
SM walks the tiles. The two warpgroups take turns at the tensor cores layer
by layer, so one's epilogue runs under the other's products. The
activations stay in one 128 x 256 bf16 buffer in shared memory for all nine
layers, each warp overwriting its own strip in place, so device memory sees
only the embedding and one float per point. The weights are staged through
shared memory once a tile: ``pack_sdf_weights`` lays them out as the
shared-memory image of 29 panels of 256 x 64 (transposed, rows swizzled as
``wgmma`` reads them, the odd widths 39 and 217 zero-padded), and bulk copies
(``cp.async.bulk`` reporting to an ``mbarrier``) keep a ring of four panels
full. Bias, softplus (``ex2.approx`` / ``lg2.approx``) and the rounding to
bf16 run on the accumulator registers; the last layer (256 -> 1) is a dot
product in layer 7's epilogue.

f32 (finalize, render eval and the mesh grid) runs the same design with f32
operands as 3xTF32 products (``csrc/fused_sdf_tf32.cu``,
``csrc/tf32_tile.cuh``; the split, the packed pairs of hi/lo panels and the
CPU model of the products in ``tf32.py``). One TF32 product would not hold
the 1e-3 tolerance: through ``fused_sdf_plain`` it puts the sdf 7.2e-4 of
its scale off f64, where plain f32 is 4.9e-7. Three products, each pair of
k16 summed by the tensor core, the pairs' sums added in f32 and the
expected loss of the tensor core's truncations given back (``tf32.give_back``),
are 2.6e-7 off (tests/test_torch_tf32_k1_design.py prints them; one accumulator for a whole layer, which rounds toward zero on every
wgmma, would be 5.8e-6). The weights are split and packed once per weight
set (``tf32.TensorCache``; ``fused_sdf_eval`` keeps the resolved weights of
a net while its parameters stand). The scalar kernel of the first port (one
thread per output column, 32-point tiles, f32 FMAs) stays as the f32
"scalar" variant.

Compute dtype: the kernels round where the JAX kernel rounds (each
activation, the skip concat, the embedding and the weights), with f32
accumulation, so they match ``fused_sdf_plain`` in both dtypes up to
summation order (and, in bf16, the approximate softplus).
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from ..core.embedder import positional_encoding
from ..fields.mlp import ImplicitNetConfig, LayerStack, _skip_concat, _softplus100
from . import _build, tf32

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def supports_fused_sdf(cfg: ImplicitNetConfig) -> bool:
    return (
        tuple(cfg.dims) == (256,) * 8
        and tuple(cfg.skip_in) == (4,)
        and cfg.multires == 6
        and cfg.d_in == 3
        and not cfg.inside_out
    )


def _effective_weights(net: LayerStack, cfg: ImplicitNetConfig, dtype=torch.bfloat16):
    """Resolve weight norm -> (in, out) matrices cast to ``dtype`` and f32
    biases, with the final layer sliced to the sdf channel."""
    ws, bs = [], []
    n_layers = len(cfg.layer_dims())
    for l in range(n_layers - 1):
        w, b = net[l].weight(), net[l].b
        if l == n_layers - 2:
            w, b = w[:1], b[:1]
        ws.append(w.T.to(dtype))
        bs.append(b.to(torch.float32))
    return ws, bs


def fused_sdf_plain(emb: torch.Tensor, ws: List[torch.Tensor], bs: List[torch.Tensor], mm=None) -> torch.Tensor:
    """The kernel's math in plain torch: emb (N, 39) in the compute dtype
    -> sdf_raw (N,) f32. Products are exact in f32 and summed in f32.
    ``mm(h, l)``: layer l's product h @ W_l in its place (``tf32`` models
    the tensor cores' f32 products with it)."""
    cd = emb.dtype
    el = torch.promote_types(torch.float32, cd)
    if mm is None:
        mm = lambda h, l: h.to(el) @ ws[l].to(el)

    h = emb
    for l in range(4):
        h = _softplus100(mm(h, l) + bs[l].to(el)).to(cd)
    h = _skip_concat(h, emb)
    for l in range(4, 8):
        h = _softplus100(mm(h, l) + bs[l].to(el)).to(cd)
    return (mm(h, 8) + bs[8].to(el))[:, 0]


# canonical (in, out) widths of the nine layers the kernel hard-codes
CANONICAL_SHAPES = ((39, 256), (256, 256), (256, 256), (256, 217)) + ((256, 256),) * 4 + ((256, 1),)

# The packed operands of the bf16 tensor-core kernel. csrc/fused_sdf.cu and
# csrc/mma_tile.cuh hard-code the same numbers under the same names.
TILE_POINTS = 128  # points a block works on at a time
PANEL_K = 64  # k columns of one weight panel
PANEL_ROWS = 256  # its rows: a layer's output columns (217 zero-padded)
PANEL_ELEMS = PANEL_ROWS * PANEL_K
# (layer, first k row) of each panel, in the order a tile consumes them
PANELS = ((0, 0),) + tuple((l, k0) for l in range(1, 8) for k0 in range(0, 256, PANEL_K))
N_PANELS = len(PANELS)
W8_OFF = N_PANELS * PANEL_ELEMS  # the last layer's sdf column, 256 values
W_TOTAL = W8_OFF + 256
B8_OFF = 8 * 256  # biases: layer l < 8 at 256 * l (zero-padded), then b8
B_TOTAL = B8_OFF + 1


def _swizzle(panels: torch.Tensor) -> torch.Tensor:
    """(P, PANEL_ROWS, PANEL_K) -> the same with the eight 8-element pieces of
    row n permuted: piece c moves to position c ^ (n % 8) (the 128-byte
    swizzle of a bf16 row). Its own inverse."""
    n = torch.arange(PANEL_ROWS, device=panels.device)[:, None]
    c = torch.arange(PANEL_K // 8, device=panels.device)[None, :]
    pieces = panels.reshape(-1, PANEL_ROWS, PANEL_K // 8, 8)
    return pieces[:, n, c ^ (n % 8)].reshape(panels.shape)


def pack_sdf_weights(ws: List[torch.Tensor], bs: List[torch.Tensor]):
    """The nine (in, out) matrices and biases as the tensor-core kernel reads
    them: (W_TOTAL,) in the matrices' dtype and (B_TOTAL,) in the biases'
    (the kernel takes bf16 and f32).

    The weights are the shared-memory image of N_PANELS panels: panel i holds
    ``W_l[k0:k0 + 64, n]`` at row n, column k - k0 (the transpose: k
    contiguous), zero where the layer has fewer rows or columns, each row's
    16-byte pieces swizzled as ``wgmma`` reads them."""
    dev = ws[0].device
    panels = torch.zeros((N_PANELS, PANEL_ROWS, PANEL_K), dtype=ws[0].dtype, device=dev)
    panels[0, :, :39] = ws[0].T
    for l in range(1, 8):
        n_out = ws[l].shape[1]
        panels[4 * l - 3 : 4 * l + 1, :n_out] = ws[l].T.reshape(n_out, 4, PANEL_K).permute(1, 0, 2)
    w = torch.cat([_swizzle(panels).reshape(-1), ws[8][:, 0]])
    return w, pack_sdf_biases(bs)


def pack_sdf_biases(bs: List[torch.Tensor]) -> torch.Tensor:
    """The nine biases as the tensor-core kernels read them: (B_TOTAL,),
    layer l < 8 at 256 * l (zero-padded), then b_8's sdf entry."""
    b = torch.zeros((B_TOTAL,), dtype=bs[0].dtype, device=bs[0].device)
    for l in range(8):
        b[256 * l : 256 * l + bs[l].shape[0]] = bs[l]
    b[B8_OFF:] = bs[8]
    return b


_GATHER = {}  # device -> (weight positions, bias positions), built once


def pack_sdf_weights_gather(ws: List[torch.Tensor], bs: List[torch.Tensor]):
    """``pack_sdf_weights`` in two gathers, as the wrapper runs it on every
    launch: the layout above applied once to matrices that hold their own
    position in ``cat([0, w_0.flatten(), ..., w_8.flatten()])`` gives, for each
    packed element, where to read it (position 0 for the zeros)."""
    dev = ws[0].device
    if dev not in _GATHER:
        w_sizes = [i * o for i, o in CANONICAL_SHAPES]
        b_sizes = [o for _, o in CANONICAL_SHAPES]
        w_pos = torch.arange(1, 1 + sum(w_sizes)).split(w_sizes)
        b_pos = torch.arange(1, 1 + sum(b_sizes)).split(b_sizes)
        w_at, b_at = pack_sdf_weights([p.reshape(sh) for p, sh in zip(w_pos, CANONICAL_SHAPES)], list(b_pos))
        _GATHER[dev] = (w_at.to(dev), b_at.to(dev))
    w_at, b_at = _GATHER[dev]
    w = torch.cat([ws[0].new_zeros(1), *(x.reshape(-1) for x in ws)])[w_at]
    b = torch.cat([bs[0].new_zeros(1), *(x.reshape(-1) for x in bs)])[b_at]
    return w, b


def unpack_sdf_weights(w: torch.Tensor, b: torch.Tensor, keep_pads: bool = False):
    """The inverse of ``pack_sdf_weights``: nine (in, out) matrices and
    biases. With ``keep_pads`` layer 0 keeps its panel's 64 rows and layer 3
    its 256 columns (zeros), as the kernel multiplies them."""
    panels = _swizzle(w[:W8_OFF].reshape(N_PANELS, PANEL_ROWS, PANEL_K))
    ws = [panels[0].T]  # (64, 256)
    for l in range(1, 8):
        ws.append(panels[4 * l - 3 : 4 * l + 1].permute(0, 2, 1).reshape(256, PANEL_ROWS))
    ws.append(w[W8_OFF:].reshape(256, 1))
    bs = [b[256 * l : 256 * (l + 1)] for l in range(8)] + [b[B8_OFF:]]
    if not keep_pads:
        ws = [x[:k, :n_out] for x, (k, n_out) in zip(ws, CANONICAL_SHAPES)]
        bs = [x[:n_out] for x, (_, n_out) in zip(bs, CANONICAL_SHAPES)]
    return ws, bs


def fused_sdf_plain_packed(emb: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``fused_sdf_plain`` on the tensor-core kernel's own operands: the
    padded matrices read back from the packed buffers, the embedding
    zero-padded to a panel's 64 columns, h3's pad columns dropped at the
    skip. The pads are zeros, so this is ``fused_sdf_plain`` on the originals."""
    ws, bs = unpack_sdf_weights(w, b, keep_pads=True)
    cd = emb.dtype
    el = torch.promote_types(torch.float32, cd)

    def mm(h, wl, bl):
        return h.to(el) @ wl.to(cd).to(el) + bl.to(el)

    h = torch.nn.functional.pad(emb, (0, PANEL_K - emb.shape[1]))
    for l in range(4):
        h = _softplus100(mm(h, ws[l], bs[l])).to(cd)
    h = _skip_concat(h[:, : 256 - emb.shape[1]], emb)
    for l in range(4, 8):
        h = _softplus100(mm(h, ws[l], bs[l])).to(cd)
    return mm(h, ws[8], bs[8])[:, 0]


# C entry points of csrc/fused_sdf.cu by variant: (bf16 name, takes packed operands)
_VARIANTS = {
    "wgmma": ("fused_sdf_fwd_bf16", True),  # what fused_sdf_kernel launches in bf16
    "wgmma_exact": ("fused_sdf_fwd_bf16_exact", True),  # the same with expf / log1pf
    "mma_sync": ("fused_sdf_fwd_bf16_mma_sync", True),  # the same, products by mma.sync
    "scalar": ("fused_sdf_fwd_bf16_scalar", False),  # the CUDA-core kernel of the first port
}
# the f32 kernels: "tf32", what fused_sdf_kernel launches (3xTF32 on the
# tensor cores, csrc/fused_sdf_tf32.cu); "scalar", the first port's
F32_VARIANTS = ("tf32", "scalar")
_TF32_PACKED = tf32.TensorCache()  # the last weights the tf32 kernel was handed, split and packed


def _launch(emb: torch.Tensor, ws: List[torch.Tensor], bs: List[torch.Tensor], variant: str) -> torch.Tensor:
    cd = emb.dtype
    if cd not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_sdf kernel takes bf16 or f32 embeddings, got {cd}")
    if not emb.is_cuda:
        raise ValueError("fused_sdf kernel takes CUDA tensors")
    if emb.dim() != 2 or emb.shape[1] != 39 or not emb.is_contiguous():
        raise ValueError(f"fused_sdf kernel needs a contiguous (N, 39) embedding, got {tuple(emb.shape)}")
    if tuple(tuple(w.shape) for w in ws) != CANONICAL_SHAPES:
        raise ValueError("fused_sdf kernel takes the canonical 8x256 skip-4 architecture only")
    for t in (*ws, *bs):
        if t.device != emb.device:
            raise ValueError("fused_sdf kernel operands must share one CUDA device")
    n = emb.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=emb.device)
    if n == 0:
        return out
    if cd == torch.float32 and variant == "tf32":
        lib, name = "fused_sdf_tf32", "fused_sdf_fwd_tf32"
        w_all, b_all = _TF32_PACKED.get((*ws, *bs), lambda: tf32.pack_sdf_weights_tf32(ws, bs))
    else:
        lib = "fused_sdf"
        name, packed = _VARIANTS[variant] if cd == torch.bfloat16 else ("fused_sdf_fwd_f32", False)
        if packed:
            w_all, b_all = pack_sdf_weights_gather([w.to(cd) for w in ws], [b.to(torch.float32) for b in bs])
        else:
            w_all = torch.cat([w.to(cd).reshape(-1) for w in ws])
            b_all = torch.cat([b.to(torch.float32).reshape(-1) for b in bs])
    fn = getattr(_build.load(lib), name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_build.ptr(emb), _build.ptr(w_all), _build.ptr(b_all), _build.ptr(out), n, _build.stream_ptr(emb))
    _build.check(err, f"fused_sdf kernel launch ({name})")
    return out


def fused_sdf_kernel(emb: torch.Tensor, ws: List[torch.Tensor], bs: List[torch.Tensor]) -> torch.Tensor:
    """Launch K1 on CUDA tensors: emb (N, 39) bf16/f32 -> sdf_raw (N,) f32.
    bf16 runs the bf16 tensor-core kernel, f32 the 3xTF32 one."""
    out = _launch(emb, ws, bs, "wgmma" if emb.dtype == torch.bfloat16 else "tf32")
    if emb.shape[0]:
        fused_sdf_kernel.launches += 1
    return out


fused_sdf_kernel.launches = 0


def fused_sdf_kernel_variant(emb, ws, bs, variant: str) -> torch.Tensor:
    """One of ``_VARIANTS`` on bf16 CUDA tensors or of ``F32_VARIANTS`` on
    f32 ones, for holding the kernels against each other on the card;
    nothing on the model's path calls it and it is not counted. A bf16
    kernel's name with f32 operands raises TypeError."""
    if emb.dtype == torch.float32 and variant in F32_VARIANTS:
        return _launch(emb, ws, bs, variant)
    if emb.dtype != torch.bfloat16:
        raise TypeError(f"{variant!r} is not a K1 variant for {emb.dtype}")
    if variant not in _VARIANTS:
        raise ValueError(f"no K1 variant {variant!r}")
    return _launch(emb, ws, bs, variant)


_RESOLVED = tf32.TensorCache()  # the last net's f32 weights, resolved for the tf32 kernel


@torch.no_grad()
def fused_sdf_eval(
    net: LayerStack, points: torch.Tensor, cfg: ImplicitNetConfig, compute_dtype: str = "bfloat16"
) -> torch.Tensor:
    """Clamped SDF values (N,) for (N, 3) points through K1 (no gradient).

    A CUDA tensor launches the kernel; a CPU tensor runs ``fused_sdf_plain``.
    ``compute_dtype`` is the kernel's precision; the JAX kernel is always
    bf16, which is also this default."""
    cd = _DTYPES[compute_dtype]
    emb = positional_encoding(points, cfg.multires).to(cd).contiguous()
    if points.is_cuda and cd == torch.float32:
        # the same tensors while the net's parameters stand, so the tf32
        # kernel splits and packs them once
        ws, bs = _RESOLVED.get(list(net.parameters()), lambda: _effective_weights(net, cfg, cd))
    else:
        ws, bs = _effective_weights(net, cfg, cd)
    if points.is_cuda:
        if not supports_fused_sdf(cfg):
            raise ValueError("fused_sdf kernel takes the canonical 8x256 skip-4 multires-6 SDF only")
        sdf = fused_sdf_kernel(emb, ws, bs)
    else:
        sdf = fused_sdf_plain(emb, ws, bs)
    if cfg.sdf_bounding_sphere > 0.0:
        sphere = cfg.sphere_scale * (cfg.sdf_bounding_sphere - torch.linalg.norm(points, dim=-1))
        sdf = torch.minimum(sdf, sphere)
    return sdf

