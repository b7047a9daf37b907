"""Helpers shared by the fused field kernels (port of the helper half of
neat_tpu/ops/fused_field.py).

The recompute kernels of that module (K3-fwd, K3-bwd) are not ported yet;
this file holds what the stashed field kernel (``fused_field_stash``)
needs: the architecture guard, weight-norm resolution into the kernel's
operand list, and the kernel-layout positional encoding.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..fields.mlp import ImplicitNetConfig, LayerStack, RenderNetConfig

N_IMPLICIT_LAYERS = 9
N_HEAD_LAYERS = 5  # rendering / attraction MLPs: 4 hidden + 1 out


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
