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

What bounds it on the H100: operations. 0.918 MFLOP per point against 78
input bytes (bf16) and 4 output bytes, so even at the tensor-core rate
(989 TFLOP/s) it sits far above the ridge point. This first kernel runs
scalar FMAs on the CUDA cores (f32 accumulation), so its ceiling is the
67 TFLOP/s f32 rate, not the tensor cores.

What the design does about it: one 256-thread block per 32-point tile (80 KB
of shared memory, two blocks per SM); the tile's activations stay in shared
memory for all nine layers, so device
memory sees only the embedding and one float per point. Each thread owns
one output column and keeps the 32 points' sums in registers; activations
are read as float4 broadcasts, weights (bf16, ~1 MB, L2-resident) straight
from global memory. Tensor cores (wgmma) are later work.

Compute dtype: the kernel is templated on float / bf16 and rounds where
the JAX kernel rounds (each activation, the skip concat, the embedding and
the weights), with f32 accumulation, so it matches ``fused_sdf_plain`` in
both dtypes up to summation order.
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from ..core.embedder import positional_encoding
from ..fields.mlp import ImplicitNetConfig, LayerStack, _skip_concat, _softplus100
from . import _build

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


def fused_sdf_plain(emb: torch.Tensor, ws: List[torch.Tensor], bs: List[torch.Tensor]) -> torch.Tensor:
    """The kernel's math in plain torch: emb (N, 39) in the compute dtype
    -> sdf_raw (N,) f32. Products are exact in f32 and summed in f32."""
    cd = emb.dtype
    el = torch.promote_types(torch.float32, cd)

    def mm(h, w, b):
        return h.to(el) @ w.to(el) + b.to(el)

    h = emb
    for l in range(4):
        h = _softplus100(mm(h, ws[l], bs[l])).to(cd)
    h = _skip_concat(h, emb)
    for l in range(4, 8):
        h = _softplus100(mm(h, ws[l], bs[l])).to(cd)
    return mm(h, ws[8], bs[8])[:, 0]


# canonical (in, out) widths of the nine layers the kernel hard-codes
CANONICAL_SHAPES = ((39, 256), (256, 256), (256, 256), (256, 217)) + ((256, 256),) * 4 + ((256, 1),)


def fused_sdf_kernel(emb: torch.Tensor, ws: List[torch.Tensor], bs: List[torch.Tensor]) -> torch.Tensor:
    """Launch K1 on CUDA tensors: emb (N, 39) bf16/f32 -> sdf_raw (N,) f32."""
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
    w_all = torch.cat([w.to(cd).reshape(-1) for w in ws])
    b_all = torch.cat([b.to(torch.float32).reshape(-1) for b in bs])
    out = torch.empty((n,), dtype=torch.float32, device=emb.device)
    if n == 0:
        return out
    lib = _build.load("fused_sdf")
    fn = lib.fused_sdf_fwd_bf16 if cd == torch.bfloat16 else lib.fused_sdf_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_build.ptr(emb), _build.ptr(w_all), _build.ptr(b_all), _build.ptr(out), n, _build.stream_ptr(emb))
    _build.check(err, "fused_sdf kernel launch")
    fused_sdf_kernel.launches += 1
    return out


fused_sdf_kernel.launches = 0


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

