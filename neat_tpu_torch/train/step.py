"""The training step: ray batch -> forward -> loss -> grads -> Adam
(port of neat_tpu/train/step.py, single device).

Adam is optax's: b1 0.9, b2 0.999, eps 1e-8, bias correction with the
update count, and the learning rate ``lr * decay_rate ** (count /
decay_steps)`` with count 0 at the first update. Unlike the functional JAX
step, the port updates the model's parameters and the moments in place.

A step's random draws come from the generator it is handed; the runner
seeds one per step with ``step_generator``. ``scene_to_device`` moves a
packed scene to the device once. ``make_train_multi_step`` runs K steps in
one call (the runner's ``--epoch_scan``). With NaN debugging on
(``utils/profiling.py``), a step checks its loss and gradients before the
update and raises ``FloatingPointError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.camera import psnr as psnr_fn
from ..model.loss import LossConfig, neat_loss
from ..model.neat import NeatConfig, NeatModel, neat_forward
from ..utils.profiling import check_finite, nan_debugging_enabled

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


def step_generator(seed: int, epoch_index: int, step: int, device) -> torch.Generator:
    """The generator of one training step's draws, a function of the run's
    seed, the epoch's place in this process's stream of epochs (0 for the
    first epoch a process runs, resumed or not) and the state's step count:
    the counterpart of the JAX runner's ``split(PRNGKey(seed))`` per epoch
    and the step's ``fold_in(rng, state.step)``."""
    words = np.random.SeedSequence([seed, epoch_index, step]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(words[0]) << 31) ^ int(words[1]))


# the packed scene's arrays that a step reads (SceneData attribute names)
SCENE_KEYS = ("rgb", "intrinsics", "pose", "mask", "labels", "uv_proj", "lines", "verts2d", "verts_mask",
              "support_idx", "support_count")


def scene_to_device(scene, device) -> Dict[str, torch.Tensor]:
    """The arrays of a packed ``data.datasets.SceneData`` that ``sample_batch``
    reads, as tensors on ``device`` (the keys ``utils/benchscene.py``
    builds, and ``depth`` where the scene has depth cues)."""
    missing = [k for k in SCENE_KEYS if getattr(scene, k) is None]
    if missing:
        raise ValueError(f"the scene has no {missing}: load it with its wireframes or as blender_plain")
    keys = SCENE_KEYS + (("depth",) if scene.depth is not None else ())
    return {k: torch.as_tensor(getattr(scene, k)).to(device) for k in keys}


def sample_batch(gen: torch.Generator, scene: Dict[str, torch.Tensor], n_rays: int, img_width: int,
                 view: Optional[int] = None):
    """One random view (or ``view``) and ``n_rays`` support pixels drawn
    with replacement; the ground truth carries their depth cues where the
    scene has them."""
    dev = scene["rgb"].device
    n_views = scene["rgb"].shape[0]
    v = int(torch.randint(0, n_views, (), generator=gen, device=dev)) if view is None else view
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
    if "depth" in scene:
        ground_truth["depth"] = scene["depth"][v, pix]
    return inputs, ground_truth


def sample_uniform_batch(gen: torch.Generator, scene: Dict[str, torch.Tensor], n_rays: int, img_width: int,
                         view: int):
    """``n_rays`` pixels of ``view`` drawn uniformly with replacement from
    the whole image: the dual-batch variant's RGB pass. Its junctions are
    all masked out."""
    dev = scene["rgb"].device
    hw = scene["rgb"].shape[1]
    pix = torch.clamp(torch.floor(torch.rand((n_rays,), generator=gen, device=dev) * hw).long(), max=hw - 1)
    uv = torch.stack([(pix % img_width).float(), (pix // img_width).float()], dim=-1)
    inputs = {
        "uv": uv,
        "uv_proj": uv,
        "intrinsics": scene["intrinsics"][view],
        "pose": scene["pose"][view],
        "verts2d": scene["verts2d"][view],
        "verts_mask": torch.zeros_like(scene["verts_mask"][view]),
    }
    return inputs, {"rgb": scene["rgb"][view, pix]}


def _draw_batch(gen, scene, n_rays: int, img_width: int, dual: bool):
    """The step's batch: a view's support pixels and, for the dual-batch
    variant, uniform pixels of the same view, carried in the ground truth
    as ``_uniform_inputs`` and ``_uniform_rgb`` (the JAX step's layout)."""
    n_views = scene["rgb"].shape[0]
    v = int(torch.randint(0, n_views, (), generator=gen, device=scene["rgb"].device))
    inputs, ground_truth = sample_batch(gen, scene, n_rays, img_width, view=v)
    if dual:
        uni_inputs, uni_gt = sample_uniform_batch(gen, scene, n_rays, img_width, v)
        ground_truth = dict(ground_truth, _uniform_inputs=uni_inputs, _uniform_rgb=uni_gt["rgb"])
    return inputs, ground_truth


def forward_and_loss(model, inputs, ground_truth, model_cfg: NeatConfig, loss_cfg: LossConfig, gen, noise):
    """(outputs, losses). The dual-batch variant runs two forwards (the
    JAX step's ``loss_fn``): rgb and grad_theta from the uniform pass on
    ``ground_truth['_uniform_inputs']``, every other output from the
    support pass; ``noise`` is then the pair (uniform pass, support pass)."""
    if not model_cfg.dual_batch:
        out = neat_forward(model, inputs, model_cfg, gen, training=True, noise=noise)
        return out, neat_loss(out, ground_truth, loss_cfg)
    noise0, noise1 = (None, None) if noise is None else noise
    out0 = neat_forward(model, ground_truth["_uniform_inputs"], model_cfg, gen, training=True, noise=noise0)
    out1 = neat_forward(model, inputs, model_cfg, gen, training=True, noise=noise1)
    out = dict(out1, rgb_values=out0["rgb_values"], grad_theta=out0["grad_theta"])
    gt = {k: v for k, v in ground_truth.items() if k not in ("_uniform_inputs", "_uniform_rgb")}
    gt["rgb"] = ground_truth["_uniform_rgb"]
    return out, neat_loss(out, gt, loss_cfg)


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
    dict; for the dual-batch variant a pair of them) may be injected, as
    the parity tests do with the JAX step's own draws; otherwise both are
    drawn from ``gen``. With NaN debugging on, a
    non-finite loss or gradient raises ``FloatingPointError`` before the
    parameters move (one host sync a step)."""

    def step(
        state: TrainState,
        scene: Optional[Dict[str, torch.Tensor]],
        gen: Optional[torch.Generator] = None,
        batch: Optional[Tuple[Dict, Dict]] = None,
        noise: Optional[Dict[str, torch.Tensor]] = None,
    ):
        if batch is None:
            inputs, ground_truth = _draw_batch(gen, scene, n_rays, img_width, model_cfg.dual_batch)
        else:
            inputs, ground_truth = batch
        out, losses = forward_and_loss(state.model, inputs, ground_truth, model_cfg, loss_cfg, gen, noise)
        params = list(state.model.parameters())
        grads = torch.autograd.grad(losses["loss"], params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if nan_debugging_enabled():
            names = [f"the gradient of {name}" for name, _ in state.model.named_parameters()]
            check_finite(state.step, ["the loss", *names], [losses["loss"], *grads])
        adam_update(state, grads, lr_schedule(lr, decay_rate, decay_steps, state.step))
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        rgb_gt = ground_truth["_uniform_rgb"] if model_cfg.dual_batch else ground_truth["rgb"]
        metrics["psnr"] = psnr_fn(out["rgb_values"].detach(), rgb_gt)
        return state, metrics

    return step


def make_train_multi_step(
    model_cfg: NeatConfig,
    loss_cfg: LossConfig,
    lr: float,
    decay_rate: float,
    decay_steps: int,
    n_rays: int,
    img_width: int,
):
    """multi(state, scene, gens, batches=None, noises=None) -> (state,
    metrics stacked on a leading K axis): K steps of ``make_train_step``'s
    body, the i-th drawing from ``gens[i]`` (or handed ``batches[i]`` and
    ``noises[i]``), so K sequential steps on the same generators give the
    same bits. The counterpart of the JAX package's ``lax.scan`` over the
    step, as a plain loop."""
    step = make_train_step(model_cfg, loss_cfg, lr, decay_rate, decay_steps, n_rays, img_width)

    def multi(
        state: TrainState,
        scene: Optional[Dict[str, torch.Tensor]],
        gens: Optional[Sequence[torch.Generator]] = None,
        batches: Optional[Sequence[Tuple[Dict, Dict]]] = None,
        noises: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
    ):
        k = len(gens) if gens is not None else len(batches)
        metrics = []
        for i in range(k):
            state, m = step(
                state,
                scene,
                None if gens is None else gens[i],
                None if batches is None else batches[i],
                None if noises is None else noises[i],
            )
            metrics.append(m)
        return state, {key: torch.stack([m[key] for m in metrics]) for key in metrics[0]}

    return multi
