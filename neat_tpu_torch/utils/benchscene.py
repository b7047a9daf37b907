"""The flagship training-step setup (port of neat_tpu/utils/benchscene.py).

abc-neat-a (``NeatConfig.for_abc``) at the reference batch of 1024 rays
on an ABC-toy-shaped synthetic scene: 512 x 512, 4 views, ``BENCH_L_MAX``
40 lines, ``max_verts`` 512. The scene is the same numpy draw
(RandomState(0)) as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

BENCH_IMG_RES = (512, 512)
BENCH_N_VIEWS = 4
BENCH_N_RAYS = 1024
BENCH_L_MAX = 40


def bench_config(
    dtype: str = "bfloat16",
    field: Optional[str] = None,
    beta_search: str = "bisect",
    fused_rounds: str = "off",
    device="cuda",
):
    """The benchmarked NeatConfig, with the JAX package's arguments.

    On a CUDA device the sampler's proposal SDF goes through K1. ``field``:
    None = the default, the stashed K2 field pass on a CUDA device in bf16
    and the plain PyTorch path elsewhere; ``'xla'`` forces the plain path
    (the name is the JAX package's, kept so the counterpart is found),
    ``'recompute'`` K3, ``'stash'`` K2. ``beta_search`` is ``'bisect'`` or
    ``'grid'``. ``fused_rounds='on'`` runs the sampler's rounds through K4;
    it stays off by default, as in the JAX package."""
    from ..model.neat import NeatConfig
    from ..ops.fused_sdf import supports_fused_sdf

    if field not in (None, "xla", "recompute", "stash"):
        raise ValueError(f"field is None, 'xla', 'recompute' or 'stash', got {field!r}")
    cfg = dataclasses.replace(NeatConfig.for_abc(), field_compute_dtype=dtype)
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda and supports_fused_sdf(cfg.implicit):
        cfg = dataclasses.replace(cfg, use_pallas_sampler=True)
    if field is None:
        field = "stash" if (on_cuda and dtype == "bfloat16") else "xla"
    if field != "xla":
        cfg = dataclasses.replace(cfg, use_pallas_field=True, pallas_field_backward=field)
    sampler = dataclasses.replace(cfg.sampler, beta_search=beta_search, fused_rounds=fused_rounds)
    return dataclasses.replace(cfg, sampler=sampler)


def bench_scene(cfg, device="cuda"):
    """ABC-toy-shaped synthetic scene (deterministic) as tensors on ``device``."""
    hw = BENCH_IMG_RES[0] * BENCH_IMG_RES[1]
    n_views, l_max = BENCH_N_VIEWS, BENCH_L_MAX
    rng = np.random.RandomState(0)
    k = np.eye(4, dtype=np.float32)
    k[0, 0] = k[1, 1] = 560.0
    k[0, 2] = k[1, 2] = 256.0
    poses = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    poses[:, 2, 3] = -2.0
    scene = {
        "rgb": rng.rand(n_views, hw, 3).astype(np.float32),
        "intrinsics": np.tile(k, (n_views, 1, 1)),
        "pose": poses,
        "mask": np.ones((n_views, hw), dtype=bool),
        "labels": rng.randint(0, l_max, (n_views, hw)).astype(np.int32),
        "uv_proj": rng.rand(n_views, hw, 2).astype(np.float32) * 512,
        "lines": rng.rand(n_views, l_max, 5).astype(np.float32) * 512,
        "verts2d": rng.rand(n_views, cfg.max_verts, 2).astype(np.float32) * 512,
        "verts_mask": np.concatenate(
            [np.ones((n_views, 32), bool), np.zeros((n_views, cfg.max_verts - 32), bool)], axis=1
        ),
        "support_idx": np.tile(np.arange(hw, dtype=np.int32), (n_views, 1)),
        "support_count": np.full((n_views,), hw, dtype=np.int32),
    }
    return {k_: torch.as_tensor(v).to(device) for k_, v in scene.items()}


def bench_step(cfg, device="cuda", n_rays: int = BENCH_N_RAYS, seed: int = 0):
    """(step_fn, initial state) for the benchmarked configuration."""
    from ..model.loss import LossConfig
    from ..model.neat import init_neat
    from ..train.step import init_train_state, make_train_step

    state = init_train_state(init_neat(cfg, seed=seed, device=device))
    step = make_train_step(cfg, LossConfig(), 5e-4, 0.1, 200000, n_rays, BENCH_IMG_RES[1])
    return step, state
