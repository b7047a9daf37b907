"""The training step: ray batch -> forward -> loss -> grads -> Adam
(port of neat_tpu/train/step.py, single device).

Adam is optax's: b1 0.9, b2 0.999, eps 1e-8, bias correction with the
update count, and the learning rate ``lr * decay_rate ** (count /
decay_steps)`` with count 0 at the first update. Unlike the functional JAX
step, the port updates the model's parameters and the moments in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..core.camera import psnr as psnr_fn
from ..model.loss import LossConfig, neat_loss
from ..model.neat import NeatConfig, NeatModel, neat_forward

B1, B2, EPS = 0.9, 0.999, 1e-8


def lr_schedule(lr: float, decay_rate: float, decay_steps: int, count: int) -> float:
    """lr0 * decay_rate ** (count / decay_steps), stepped every update."""
    return lr * decay_rate ** (count / max(decay_steps, 1))


@dataclasses.dataclass
class TrainState:
    model: NeatModel
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    step: int = 0


def init_train_state(model: NeatModel) -> TrainState:
    params = list(model.parameters())
    return TrainState(
        model=model,
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params],
    )


@torch.no_grad()
def adam_update(state: TrainState, grads, lr_t: float) -> None:
    """One optax-style Adam update, in place; ``state.step`` is the count
    before this update."""
    count = state.step + 1
    c1 = 1.0 - B1**count
    c2 = 1.0 - B2**count
    for p, g, mu, nu in zip(state.model.parameters(), grads, state.mu, state.nu):
        mu.mul_(B1).add_((1.0 - B1) * g)
        nu.mul_(B2).add_((1.0 - B2) * g * g)
        upd = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
        p.add_(-lr_t * upd)


def sample_batch(gen: torch.Generator, scene: Dict[str, torch.Tensor], n_rays: int, img_width: int):
    """One random view and ``n_rays`` support pixels drawn with replacement."""
    dev = scene["rgb"].device
    n_views = scene["rgb"].shape[0]
    v = int(torch.randint(0, n_views, (), generator=gen, device=dev))
    count = scene["support_count"][v]
    draw = torch.floor(torch.rand((n_rays,), generator=gen, device=dev) * count).long()
    draw = torch.minimum(draw, count.long() - 1)
    pix = scene["support_idx"][v, draw].long()
    uv = torch.stack([(pix % img_width).float(), (pix // img_width).float()], dim=-1)
    labels = scene["labels"][v, pix].long()
    inputs = {
        "uv": uv,
        "uv_proj": scene["uv_proj"][v, pix],
        "intrinsics": scene["intrinsics"][v],
        "pose": scene["pose"][v],
        "verts2d": scene["verts2d"][v],
        "verts_mask": scene["verts_mask"][v],
    }
    ground_truth = {"rgb": scene["rgb"][v, pix], "lines2d": scene["lines"][v, labels]}
    return inputs, ground_truth


def make_train_step(
    model_cfg: NeatConfig,
    loss_cfg: LossConfig,
    lr: float,
    decay_rate: float,
    decay_steps: int,
    n_rays: int,
    img_width: int,
):
    """step(state, scene, gen, batch=None, noise=None) -> (state, metrics).

    ``batch`` = (inputs, ground_truth) and ``noise`` (draw_forward_noise's
    dict) may be injected, as the parity tests do with the JAX step's own
    draws; otherwise both are drawn from ``gen``."""

    def step(
        state: TrainState,
        scene: Optional[Dict[str, torch.Tensor]],
        gen: Optional[torch.Generator] = None,
        batch: Optional[Tuple[Dict, Dict]] = None,
        noise: Optional[Dict[str, torch.Tensor]] = None,
    ):
        if batch is None:
            inputs, ground_truth = sample_batch(gen, scene, n_rays, img_width)
        else:
            inputs, ground_truth = batch
        out = neat_forward(state.model, inputs, model_cfg, gen, training=True, noise=noise)
        losses = neat_loss(out, ground_truth, loss_cfg)
        params = list(state.model.parameters())
        grads = torch.autograd.grad(losses["loss"], params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        adam_update(state, grads, lr_schedule(lr, decay_rate, decay_steps, state.step))
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["psnr"] = psnr_fn(out["rgb_values"].detach(), ground_truth["rgb"])
        return state, metrics

    return step
