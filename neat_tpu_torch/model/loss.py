"""NEAT training loss (port of neat_tpu/model/loss.py).

Bidirectional-endpoint-min line L1 gated at 100 px with the gate reused on
the calibrated branch, L1 RGB, eikonal (|grad| - 1)^2, and the junction
terms over an auction assignment of local to global junctions. All
reductions are mask-aware because junction tensors are padded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..assignment.matching import masked_assignment


@dataclasses.dataclass(frozen=True)
class LossConfig:
    rgb_loss: str = "l1"  # 'l1' | 'mse'
    eikonal_weight: float = 0.1
    line_weight: float = 0.01
    junction_3d_weight: float = 0.1
    junction_2d_weight: float = 0.01
    line_gate_px: float = 100.0
    calibrated_branch: bool = True
    junction_cost_2d_scale: float = 0.1
    junction_mode: str = "wfr"  # 'wfr' | 'jc'
    junction_stat_gated: bool = False
    depth_weight: float = 0.0  # the depth terms are not ported yet
    depth_loss_kind: str = "l1"
    depth_mask_zeros: bool = False
    assignment_method: str = "auction"


def _line_l1(lines2d, lines2d_gt, lines_weight, threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Endpoint-order-min gated line loss. lines2d, lines2d_gt: (R, 4);
    lines_weight: (R,). Returns (scalar loss, per-ray detached L1)."""
    swapped = lines2d_gt[:, [2, 3, 0, 1]]
    d1 = torch.sum((lines2d - lines2d_gt) ** 2, dim=-1, keepdim=True).detach()
    d2 = torch.sum((lines2d - swapped) ** 2, dim=-1, keepdim=True).detach()
    target = torch.where(d1 < d2, lines2d_gt, swapped)
    per_ray = torch.mean(torch.abs(lines2d - target), dim=-1)
    labels = (per_ray.detach() < threshold).to(lines2d.dtype)
    denom = torch.clamp(torch.sum(labels), min=1.0)
    total = torch.sum(per_ray * lines_weight * labels) / denom
    return total, per_ray.detach()


def neat_loss(outputs: Dict[str, torch.Tensor], ground_truth: Dict[str, torch.Tensor], cfg: LossConfig):
    """Total loss and its components. ground_truth: rgb (R, 3), lines2d
    (R, 5) [x1 y1 x2 y2 score]."""
    if cfg.depth_weight > 0.0:
        raise NotImplementedError("the depth loss terms are not ported yet (ROADMAP.md §1 item 13)")
    stats: Dict[str, torch.Tensor] = {}
    ref = outputs["rgb_values"]
    zero = torch.zeros((), dtype=ref.dtype, device=ref.device)

    rgb_gt = ground_truth["rgb"].reshape(-1, 3)
    if cfg.rgb_loss == "l1":
        rgb_loss = torch.mean(torch.abs(ref - rgb_gt))
    else:
        rgb_loss = torch.mean((ref - rgb_gt) ** 2)

    if "grad_theta" in outputs:
        g = outputs["grad_theta"]
        eikonal_loss = torch.mean((torch.linalg.norm(g, dim=-1) - 1.0) ** 2)
    else:
        eikonal_loss = zero

    loss = rgb_loss + cfg.eikonal_weight * eikonal_loss

    if "lines2d" in outputs:
        gt5 = ground_truth["lines2d"]
        lines2d_gt, lines_weight = gt5[:, :4], gt5[:, 4]
        lines2d = outputs["lines2d"].reshape(-1, 4)
        l2d_uncalib, per_ray = _line_l1(lines2d, lines2d_gt, lines_weight, cfg.line_gate_px)
        gate = (per_ray < cfg.line_gate_px).to(lines2d.dtype)
        stats["count"] = torch.sum(gate)
        if cfg.calibrated_branch:
            k_inv = torch.linalg.inv(outputs["K"])
            pts = lines2d_gt.reshape(-1, 2)
            pts_h = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=-1)
            calib = (k_inv @ pts_h.T).T
            calib = calib[:, :2] / calib[:, 2:]
            line_loss, _ = _line_l1(
                outputs["lines2d_calib"].reshape(-1, 4), calib.reshape(-1, 4),
                lines_weight * gate, cfg.line_gate_px,
            )
        else:
            line_loss = l2d_uncalib
        loss = loss + cfg.line_weight * line_loss
        stats["line_loss"] = line_loss
        stats["l2d_loss"] = l2d_uncalib

    j3d_loss = j2d_loss = j2d_stat = jcount = zero
    if "j3d_local" in outputs:
        j3d_local = outputs["j3d_local"]
        j3d_global = outputs["j3d_global"]
        j2d_local = outputs["j2d_local"].detach()
        j2d_global = outputs["j2d_global"].detach()
        j2d_local_calib = outputs["j2d_local_calib"]
        j2d_global_calib = outputs["j2d_global_calib"]
        local_mask = outputs["j_local_mask"]

        if cfg.junction_mode == "jc":
            cost = torch.sqrt(
                torch.sum((j3d_local[:, None] - j3d_global[None]) ** 2, dim=-1) + 1e-12
            )
        else:
            cost = torch.sum(torch.abs(j3d_local[:, None] - j3d_global[None]), dim=-1) + (
                cfg.junction_cost_2d_scale
                * torch.sum(torch.abs(j2d_local_calib[:, None] - j2d_global_calib[None]), dim=-1)
            )
        cost = torch.nan_to_num(cost.detach(), nan=1e5)
        col_idx, valid = masked_assignment(cost, local_mask, method=cfg.assignment_method)
        col_idx = col_idx.long()
        n_valid = torch.sum(valid).to(ref.dtype).clamp(min=1.0)

        if cfg.junction_mode == "jc":
            pair_l3d = torch.sum((j3d_local - j3d_global[col_idx]) ** 2, dim=-1)
        else:
            pair_l3d = torch.sum(torch.abs(j3d_local - j3d_global[col_idx]), dim=-1)
        j3d_loss = torch.sum(torch.where(valid, pair_l3d, 0.0)) / n_valid
        pair_l2d = torch.sum(torch.abs(j2d_local_calib - j2d_global_calib[col_idx]), dim=-1)
        j2d_loss = torch.sum(torch.where(valid, pair_l2d, 0.0)) / n_valid
        pair_l2d_u = torch.sum(torch.abs(j2d_local - j2d_global[col_idx]), dim=-1)
        if cfg.junction_stat_gated:
            stat_mask = valid & (pair_l2d_u < 10.0)
            n_stat = torch.sum(stat_mask).to(ref.dtype).clamp(min=1.0)
            j2d_stat = torch.sum(torch.where(stat_mask, pair_l2d_u, 0.0)) / n_stat
            jcount = torch.sum(stat_mask).to(ref.dtype)
        else:
            j2d_stat = torch.sum(torch.where(valid, pair_l2d_u, 0.0)) / n_valid
            assign_cost = torch.gather(cost, 1, col_idx[:, None])[:, 0]
            jcount = torch.sum(valid & (assign_cost < 10.0)).to(ref.dtype)
        loss = loss + cfg.junction_3d_weight * j3d_loss + cfg.junction_2d_weight * j2d_loss

    out = {
        "loss": loss,
        "rgb_loss": rgb_loss,
        "eikonal_loss": eikonal_loss,
        "j3d_loss": j3d_loss,
        "j2d_loss": j2d_loss,
        "j2d_stat": j2d_stat,
        "jcount": jcount,
    }
    out.update(stats)
    if "median" in outputs:
        out["median"] = outputs["median"]
    return out
