"""Line lifting on the vanilla VolSDF network (port of
neat_tpu/model/line_lift.py; reference code/model/network.py:189-454).

Two forwards of ``model.network.VolSDFNetwork`` lift detected 2D segments
into 3D by volume-rendering the expected surface point of pixels along
each segment:

  * ``minstance_loss`` (forward_minstance): per line, [0, u, 1] along the
    segment with one uniform interior u, all three lifted; a weighted L1
    between the interior point and its clamped per-axis projection onto the
    lifted chord. The projection is the reference's elementwise
    ``t = -(x1 - x0) * (x2 - x1) / |x2 - x1|^2``, kept as it is, and the
    whole target is detached: the gradient reaches the implicit network
    through the interior point only.
  * ``two_view_lift`` (forward_two_view): ``n_points`` evenly spaced
    samples a line, lifted detached (as the reference does), scored by the
    mean |cos - 1| of each sub-segment against the chord. Returns the score
    and the lifted geometry.

Random draws are injected (``u``, ``noise``) or drawn from ``gen``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .neat import NeatConfig, NeatModel, neat_forward


def lift_line_points(
    model: NeatModel,
    cfg: NeatConfig,
    points2d: torch.Tensor,
    pose: torch.Tensor,
    intrinsics: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    training: bool = True,
    noise: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """The expected 3D surface point of each pixel (reference ``render``):
    the volsdf forward's ``xyz``. points2d (..., 2) -> (..., 3)."""
    vcfg = dataclasses.replace(cfg, model_variant="volsdf")
    uv = points2d.reshape(-1, 2)
    out = neat_forward(model, {"uv": uv, "pose": pose, "intrinsics": intrinsics}, vcfg, gen,
                       training=training, noise=noise)
    return out["xyz"].reshape(*points2d.shape[:-1], 3)


def _segment_points(juncs2d: torch.Tensor, edges: torch.Tensor, lambdas: torch.Tensor) -> torch.Tensor:
    """(V, 2) junctions, (L, 2) edges, (L or 1, P, 1) lambdas -> (L, P, 2)."""
    lines2d = juncs2d[edges.long()]
    a, b = lines2d[:, :1], lines2d[:, 1:]
    return a + lambdas * (b - a)


def minstance_loss(
    model: NeatModel,
    cfg: NeatConfig,
    inputs: Dict[str, torch.Tensor],
    gen: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
    noise: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """forward_minstance. inputs: juncs2d (V, 2), edges (L, 2), weights (L,),
    pose, intrinsics; ``u`` (L, 1, 1) the interior draw. -> scalar loss."""
    edges = inputs["edges"]
    juncs2d = inputs["juncs2d"]
    if u is None:
        u = torch.rand((edges.shape[0], 1, 1), generator=gen, device=juncs2d.device, dtype=juncs2d.dtype)
    lambdas = torch.cat([u * 0.0, u, u * 0.0 + 1.0], dim=1)
    pts2d = _segment_points(juncs2d, edges, lambdas)
    lines3d = lift_line_points(model, cfg, pts2d, inputs["pose"], inputs["intrinsics"], gen, noise=noise)
    x1, x2, x0 = lines3d[:, :1], lines3d[:, -1:], lines3d[:, 1:-1]
    norm2 = torch.sum((x2 - x1) ** 2, dim=-1, keepdim=True)
    t = torch.clamp(-(x1 - x0) * (x2 - x1) / norm2, 0.0, 1.0)
    xp = (x1 + (x2 - x1) * t).detach()
    per_line = torch.sum(torch.abs(x0 - xp), dim=(-1, -2))
    return torch.mean(per_line * inputs["weights"])


def two_view_lift(
    model: NeatModel,
    cfg: NeatConfig,
    inputs: Dict[str, torch.Tensor],
    gen: Optional[torch.Generator] = None,
    n_points: int = 16,
    training: bool = True,
    noise: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """forward_two_view -> (alignment loss, lines3d (L, P, 3), the pixels
    (L, P, 2)). The lifted points are detached, so the loss carries no
    gradient, as in the reference."""
    juncs2d = inputs["juncs2d"]
    lambdas = torch.linspace(0.0, 1.0, n_points, dtype=juncs2d.dtype, device=juncs2d.device).reshape(1, n_points, 1)
    pts2d = _segment_points(juncs2d, inputs["edges"], lambdas)
    lines3d = lift_line_points(model, cfg, pts2d, inputs["pose"], inputs["intrinsics"], gen, training=training,
                               noise=noise).detach()
    chord = lines3d[:, -1:] - lines3d[:, :1]
    chord = chord / torch.sqrt(torch.sum(chord**2, dim=-1, keepdim=True) + 1e-10)
    sub = lines3d[:, 1:] - lines3d[:, :-1]
    sub = sub / torch.sqrt(torch.sum(sub**2, dim=-1, keepdim=True) + 1e-10)
    cos = torch.sum(sub * chord, dim=-1)
    loss = torch.mean(torch.abs(cos - 1.0), dim=-1)
    return torch.mean(loss * inputs["weights"]), lines3d, pts2d
