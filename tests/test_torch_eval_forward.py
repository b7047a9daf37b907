"""The eval-mode forward, neat_forward(training=False), of the port against
neat_tpu, whole output dict; and render_rgb.

32 rays at narrow widths in f32 on the same weights. JAX runs its
offline_eval_config (XLA paths, f32); the port runs with its kernel flags on
(K1 and K3-fwd in f32, what eval_kernel_config selects on the card), so the
wrappers are exercised and take their plain versions on CPU tensors, and
also with them off. The eval sampler draws nothing, so no noise is passed.
Tolerance: 1e-4 of each output's largest entry, as the training-mode test
(tests/test_torch_model.py): f32 sums in another order, carried through the
sampler's inverse CDF and the 2D projections.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import neat_tpu.model.neat as jneat
import neat_tpu_torch.model.neat as tneat
from _torch_helpers import configs, n, port_model, small_scene, t, to_numpy

TOL = 1e-4
KERNEL_FLAGS = dict(use_pallas_sampler=True, use_pallas_field=True, pallas_field_backward="recompute")


def _inputs(scene, view, r, seed=0):
    rs = np.random.RandomState(seed)
    w = int(round(np.sqrt(scene["rgb"].shape[1])))
    pix = rs.randint(0, scene["rgb"].shape[1], r)
    return {
        "uv": np.stack([pix % w, pix // w], -1).astype(np.float32),
        "uv_proj": scene["uv_proj"][view, pix],
        "intrinsics": scene["intrinsics"][view],
        "pose": scene["pose"][view],
    }


@pytest.mark.parametrize("kernels", [True, False], ids=["kernel_flags", "plain"])
def test_eval_forward_matches_jax(kernels):
    cfg_j, cfg_t = configs()
    cfg_j = jneat.offline_eval_config(cfg_j)
    cfg_t = tneat.offline_eval_config(cfg_t)
    if kernels:
        cfg_t = dataclasses.replace(cfg_t, **KERNEL_FLAGS)
    params = jneat.init_neat(jax.random.PRNGKey(0), cfg_j)
    model = port_model(params, cfg_t)
    inputs = _inputs(small_scene(cfg_j), view=1, r=32)
    jin = dict(inputs, verts2d=np.zeros((1, 2), np.float32), verts_mask=np.zeros((1,), bool))

    out_j = to_numpy(jax.jit(lambda p, i: jneat.neat_forward(p, i, cfg_j, jax.random.PRNGKey(0), training=False))(
        params, jin))
    with torch.no_grad():
        out_t = tneat.neat_forward(model, {k: t(v) for k, v in inputs.items()}, cfg_t, training=False)

    assert set(out_t) == set(out_j)
    for k in ("normal_map", "lines3d", "lines2d", "l3d"):
        assert k in out_t
    for k in sorted(out_j):
        a, b = n(out_t[k]), out_j[k]
        assert a.shape == b.shape, k
        err = np.abs(a.astype(np.float64) - b).max() / max(np.abs(b).max(), 1e-6)
        assert err < TOL, (k, err)


def test_render_rgb_is_the_eval_forwards_rgb():
    cfg_j, cfg_t = configs()
    cfg_j, cfg_t = jneat.offline_eval_config(cfg_j), tneat.offline_eval_config(cfg_t)
    params = jneat.init_neat(jax.random.PRNGKey(1), cfg_j)
    model = port_model(params, cfg_t)
    inputs = _inputs(small_scene(cfg_j), view=0, r=16, seed=1)
    jin = dict(inputs, verts2d=np.zeros((1, 2), np.float32), verts_mask=np.zeros((1,), bool))
    want = np.asarray(jneat.render_rgb(params, jin, cfg_j, jax.random.PRNGKey(0)))
    with torch.no_grad():
        got = n(tneat.render_rgb(model, {k: t(v) for k, v in inputs.items()}, cfg_t))
    assert np.abs(got - want).max() / np.abs(want).max() < TOL


def test_offline_and_kernel_eval_configs():
    cfg_j, cfg_t = configs(use_pallas_sampler=True, use_pallas_field=True, field_compute_dtype="bfloat16")
    off_j, off_t = jneat.offline_eval_config(cfg_j), tneat.offline_eval_config(cfg_t)
    for f in ("sampler_compute_dtype", "field_compute_dtype", "use_pallas_sampler", "use_pallas_field"):
        assert getattr(off_t, f) == getattr(off_j, f), f
    # on the CPU the kernel config is the offline one; narrow widths never take the kernels
    assert tneat.eval_kernel_config(cfg_t, "cpu") == off_t
    assert tneat.eval_kernel_config(cfg_t, "cuda") == dataclasses.replace(off_t, pallas_field_backward="recompute")
    full = tneat.eval_kernel_config(tneat.NeatConfig.for_abc(), "cuda")
    assert (full.use_pallas_sampler, full.use_pallas_field, full.sampler_compute_dtype, full.field_compute_dtype) == (
        True, True, "float32", "float32")
