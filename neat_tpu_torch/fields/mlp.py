"""Coordinate MLP fields: SDF, radiance, attraction, global junctions
(port of neat_tpu/fields/mlp.py).

Every linear layer is an ``nn.Module`` holding the JAX parameter leaves
under the same names: weight-normed layers hold ``v`` (out, in), ``g``
(out,) and ``b`` (out,), with effective weight ``g * v / ||v||_row``; plain
layers hold ``w`` (out, in) and ``b``. ``interop.params_from_jax`` maps a
``neat_tpu`` parameter tree onto these names one to one.

The spatial gradient of the SDF comes from
``torch.autograd.grad(create_graph=True)``, so a loss on the gradient
(eikonal, the IDR heads' normal input) differentiates through it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.embedder import encoding_dim, positional_encoding


# ---------------------------------------------------------------------------
# linear layers
# ---------------------------------------------------------------------------


class WeightNormLinear(nn.Module):
    """Weight-normalized linear: effective weight g * v / ||v||_row."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.v = nn.Parameter(w.clone())
        self.g = nn.Parameter(torch.linalg.norm(w, dim=1))
        self.b = nn.Parameter(b.clone())

    def weight(self) -> torch.Tensor:
        return self.g[:, None] * self.v / torch.linalg.norm(self.v, dim=1, keepdim=True)


class PlainLinear(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w.clone())
        self.b = nn.Parameter(b.clone())

    def weight(self) -> torch.Tensor:
        return self.w


class LayerStack(nn.Module):
    """Numbered layers ``lin0 .. lin{n-1}`` (the JAX dict keys)."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        for i, lin in enumerate(layers):
            self.add_module(f"lin{i}", lin)
        self.n = len(layers)

    def __getitem__(self, i: int) -> nn.Module:
        return getattr(self, f"lin{i}")


def _make_linear(w, b, weight_norm: bool) -> nn.Module:
    return WeightNormLinear(w, b) if weight_norm else PlainLinear(w, b)


def _torch_default_linear(gen: torch.Generator, d_in: int, d_out: int):
    """torch.nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(d_in)
    w = (torch.rand((d_out, d_in), generator=gen) * 2 - 1) * bound
    b = (torch.rand((d_out,), generator=gen) * 2 - 1) * bound
    return w, b


def linear_apply(lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T + b with the weight resolved in f32 and cast to x's dtype."""
    return x @ lin.weight().T.to(x.dtype) + lin.b.to(x.dtype)


def _softplus100(x: torch.Tensor) -> torch.Tensor:
    """softplus(100 x) / 100, as JAX writes it (``logaddexp(100 x, 0) / 100``).

    The threshold is 40 on the scaled input, where log1p(exp(-z)) falls
    below half an ulp of z even in f64, so the value is JAX's to the last
    bit of a float32. (``nn.Softplus(beta=100)`` switches to the identity
    at 100 x > 20.) ``F.softplus`` rather than ``torch.logaddexp``: the
    latter's double backward overflows to NaN for z < -88 in f32, and the
    eikonal and normal terms differentiate through the gradient."""
    return F.softplus(100.0 * x, beta=1.0, threshold=40.0) / 100.0


def _skip_concat(h: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    """[h, inp] * (1/sqrt(2)) in the activations' dtype, as the fused JAX
    kernels round it: a Python float meets a bf16 array as a bf16 constant,
    so the constant is rounded to the dtype first (torch would keep it in
    f32)."""
    return torch.cat([h, inp], dim=-1) * torch.tensor(
        1.0 / math.sqrt(2.0), dtype=h.dtype, device=h.device
    )


# ---------------------------------------------------------------------------
# implicit (SDF) network
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ImplicitNetConfig:
    feature_vector_size: int = 256
    sdf_bounding_sphere: float = 3.0  # 0.0 disables the clamp
    d_in: int = 3
    d_out: int = 1
    dims: Sequence[int] = (256,) * 8
    geometric_init: bool = True
    bias: float = 0.6
    skip_in: Sequence[int] = (4,)
    weight_norm: bool = True
    multires: int = 6
    sphere_scale: float = 20.0
    inside_out: bool = False

    def layer_dims(self) -> Tuple[int, ...]:
        d0 = encoding_dim(self.multires, self.d_in) if self.multires > 0 else self.d_in
        return (d0, *self.dims, self.d_out + self.feature_vector_size)


def init_implicit_net(gen: torch.Generator, cfg: ImplicitNetConfig) -> LayerStack:
    """Geometric (sphere) init as in the JAX package, drawn from ``gen``."""
    dims = cfg.layer_dims()
    n_layers = len(dims)
    layers = []
    for l in range(n_layers - 1):
        out_dim = dims[l + 1] - dims[0] if (l + 1) in cfg.skip_in else dims[l + 1]
        d_in = dims[l]
        if cfg.geometric_init:
            std = math.sqrt(2) / math.sqrt(out_dim)
            b = torch.zeros((out_dim,))
            if l == n_layers - 2:
                w = torch.randn((out_dim, d_in), generator=gen) * 1e-4 + math.sqrt(
                    math.pi
                ) / math.sqrt(d_in)
                b = torch.full((out_dim,), -cfg.bias)
            elif cfg.multires > 0 and l == 0:
                w = torch.zeros((out_dim, d_in))
                w[:, :3] = torch.randn((out_dim, 3), generator=gen) * std
            elif cfg.multires > 0 and l in cfg.skip_in:
                w = torch.randn((out_dim, d_in), generator=gen) * std
                w[:, -(dims[0] - 3):] = 0.0
            else:
                w = torch.randn((out_dim, d_in), generator=gen) * std
        else:
            w, b = _torch_default_linear(gen, d_in, out_dim)
        layers.append(_make_linear(w, b, cfg.weight_norm))
    return LayerStack(layers)


def implicit_forward(net: LayerStack, x, cfg: ImplicitNetConfig, compute_dtype=None):
    """Raw network output (..., 1 + feature_size), no sphere clamp. With
    ``compute_dtype`` the layer chain runs at that precision after an f32
    positional encoding; the result is cast back."""
    inp = positional_encoding(x, cfg.multires) if cfg.multires > 0 else x
    out_dtype = inp.dtype
    if compute_dtype is not None:
        inp = inp.to(compute_dtype)
    h = inp
    n_layers = len(cfg.layer_dims())
    for l in range(n_layers - 1):
        if l in cfg.skip_in:
            # a bf16 constant, as JAX rounds a Python float against bf16
            h = torch.cat([h, inp], dim=-1) / torch.tensor(
                math.sqrt(2), dtype=h.dtype, device=h.device
            )
        h = linear_apply(net[l], h)
        if l < n_layers - 2:
            h = _softplus100(h)
    if cfg.inside_out:
        h = torch.cat([-h[..., :1], h[..., 1:]], dim=-1)
    return h.to(out_dtype)


def _clamp_sdf(sdf, x, cfg: ImplicitNetConfig):
    """Bounding-sphere clamp min(sdf, scale * (R - |x|))."""
    if cfg.sdf_bounding_sphere > 0.0:
        sphere = cfg.sphere_scale * (
            cfg.sdf_bounding_sphere - torch.linalg.norm(x, dim=-1, keepdim=True)
        )
        sdf = torch.minimum(sdf, sphere)
    return sdf


def implicit_sdf(net, x, cfg: ImplicitNetConfig, compute_dtype=None):
    """Clamped SDF values (..., 1)."""
    sdf = implicit_forward(net, x, cfg, compute_dtype=compute_dtype)[..., :1]
    return _clamp_sdf(sdf, x, cfg)


def _input_grad(fn, x):
    """(outputs of fn(x), d out[0] / d x) with a graph through the gradient
    when the caller records one."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x if x.requires_grad else x.detach().requires_grad_(True)
        outs = fn(xg)
        (g,) = torch.autograd.grad(
            outs[0], xg, torch.ones_like(outs[0]), create_graph=create
        )
    if not create:
        outs = tuple(o.detach() for o in outs)
    return outs, g


def _input_grad_recorded(fn, x):
    """``_input_grad`` for a caller that records a graph: the gradient by
    forward-mode AD, so that every node of the graph through it is made on
    the calling thread. A reverse-mode gradient with ``create_graph`` runs,
    for CUDA tensors, on the autograd engine's device thread, and the nodes
    it makes are numbered by that thread's own counter; the training step's
    backward orders its ready nodes by those numbers, so it summed the
    contributions to a weight in an order that depended on how far each
    thread's counter had run: a process's first training step came out
    other than its later ones in the last bits. One pass takes x repeated
    once per coordinate, each copy with that coordinate's unit tangent; the
    outputs are the first copy's. Without a graph, ``_input_grad``."""
    import torch.autograd.forward_ad as fwAD

    if not torch.is_grad_enabled():
        return _input_grad(fn, x)
    d = x.shape[-1]
    flat = x.reshape(-1, d)
    n = flat.shape[0]
    tangent = torch.eye(d, dtype=x.dtype, device=x.device).repeat_interleave(n, dim=0)
    with fwAD.dual_level():
        unpacked = [fwAD.unpack_dual(o) for o in fn(fwAD.make_dual(flat.repeat(d, 1), tangent))]
    outs = tuple(u.primal[:n].reshape(*x.shape[:-1], *u.primal.shape[1:]) for u in unpacked)
    grads = unpacked[0].tangent.reshape(d, n).T.reshape(*x.shape[:-1], d)
    return outs, grads


def implicit_sdf_feat_grad(net, x, cfg: ImplicitNetConfig, compute_dtype=None):
    """(sdf, features, d sdf / d x) with the sphere clamp applied before
    differentiation. x: (N, 3)."""

    def f(pts):
        out = implicit_forward(net, pts, cfg, compute_dtype=compute_dtype)
        return _clamp_sdf(out[..., :1], pts, cfg), out[..., 1:]

    (sdf, feats), grads = _input_grad_recorded(f, x)
    return sdf, feats, grads


def implicit_gradient(net, x, cfg: ImplicitNetConfig):
    """d sdf_raw / d x without the sphere clamp (the eikonal term)."""
    _, grads = _input_grad_recorded(lambda pts: (implicit_forward(net, pts, cfg)[..., :1],), x)
    return grads


# ---------------------------------------------------------------------------
# rendering / attraction networks (IDR-style conditioned MLPs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RenderNetConfig:
    feature_vector_size: int = 256
    mode: str = "idr"  # 'idr' | 'nerf' | 'no_view'
    d_in: int = 9
    d_out: int = 3
    dims: Sequence[int] = (256,) * 4
    weight_norm: bool = True
    multires_view: int = 0

    def layer_dims(self) -> Tuple[int, ...]:
        d0 = self.d_in + self.feature_vector_size
        if self.multires_view > 0 and self.mode != "no_view":
            d0 += encoding_dim(self.multires_view, 3) - 3
        return (d0, *self.dims, self.d_out)


def _init_idr_mlp(gen, dims: Sequence[int], weight_norm: bool) -> LayerStack:
    return LayerStack(
        [
            _make_linear(*_torch_default_linear(gen, dims[l], dims[l + 1]), weight_norm)
            for l in range(len(dims) - 1)
        ]
    )


def init_render_net(gen, cfg: RenderNetConfig) -> LayerStack:
    return _init_idr_mlp(gen, cfg.layer_dims(), cfg.weight_norm)


init_attraction_net = init_render_net


def _idr_inputs(points, normals, view_dirs, feature_vectors, cfg: RenderNetConfig):
    if cfg.mode == "no_view":
        return torch.cat([points, normals, feature_vectors], dim=-1)
    if cfg.multires_view > 0:
        view_dirs = positional_encoding(view_dirs, cfg.multires_view)
    if cfg.mode == "idr":
        return torch.cat([points, view_dirs, normals, feature_vectors], dim=-1)
    if cfg.mode == "nerf":
        return torch.cat([view_dirs, feature_vectors], dim=-1)
    raise ValueError(f"unknown mode {cfg.mode}")


def _idr_mlp_forward(net: LayerStack, x):
    h = x
    for l in range(net.n):
        h = linear_apply(net[l], h)
        if l < net.n - 1:
            h = torch.relu(h)
    return h


def render_forward(net, points, normals, view_dirs, feature_vectors, cfg, compute_dtype=None):
    """RGB in [0, 1] (..., 3)."""
    x = _idr_inputs(points, normals, view_dirs, feature_vectors, cfg)
    out_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    return torch.sigmoid(_idr_mlp_forward(net, x).to(out_dtype))


def attraction_forward(net, points, normals, view_dirs, feature_vectors, cfg, compute_dtype=None):
    """Two 3D endpoints per query point: (..., 2, 3) = point + offsets."""
    x = _idr_inputs(points, normals, view_dirs, feature_vectors, cfg)
    out_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    h = _idr_mlp_forward(net, x)
    offsets = h.to(out_dtype).reshape(*points.shape[:-1], 2, 3)
    return points[..., None, :] + offsets


# ---------------------------------------------------------------------------
# global junctions: latent table + feed-forward decoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GlobalJunctionsConfig:
    num_junctions: int = 1024
    num_layers: int = 2
    dim_hidden: int = 256
    dim_out: int = 3


class GlobalJunctions(nn.Module):
    def __init__(self, latents: torch.Tensor, ffn: LayerStack):
        super().__init__()
        self.latents = nn.Parameter(latents.clone())
        self.ffn = ffn


def init_global_junctions(gen, cfg: GlobalJunctionsConfig) -> GlobalJunctions:
    latents = torch.randn((cfg.num_junctions, cfg.dim_hidden), generator=gen)
    layers = []
    for i in range(cfg.num_layers + 1):
        d_out = cfg.dim_hidden if i != cfg.num_layers else cfg.dim_out
        layers.append(PlainLinear(*_torch_default_linear(gen, cfg.dim_hidden, d_out)))
    return GlobalJunctions(latents, LayerStack(layers))


def global_junctions_forward(net: GlobalJunctions, cfg: GlobalJunctionsConfig):
    """Decode the latent table -> (num_junctions, 3) points."""
    h = net.latents
    for i in range(cfg.num_layers + 1):
        h = linear_apply(net.ffn[i], h)
        if i != cfg.num_layers:
            h = torch.relu(h)
    return h
