"""neat_forward + neat_loss of the port against neat_tpu, whole output dict.

16 rays at narrow widths in f32, same weights and the same noise (drawn by
the JAX package's draw_forward_noise). JAX runs its XLA paths
(use_pallas_* off); the port runs with its kernel flags on, so the K1 and
K2 wrappers are exercised and take their plain versions on CPU tensors.
Tolerance: 1e-4 of each output's largest entry — f32 sums in another
order, carried through the sampler's inverse CDF and the 2D projections.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import neat_tpu.model.loss as jloss
import neat_tpu.model.neat as jneat
import neat_tpu_torch.model.loss as tloss
import neat_tpu_torch.model.neat as tneat
from _torch_helpers import configs, n, port_model, small_scene, t, to_numpy

KERNEL_FLAGS = dict(use_pallas_sampler=True, use_pallas_field=True, pallas_field_backward="stash")


def model_configs():
    cfg_j, cfg_t = configs(sampler_compute_dtype="float32")
    return cfg_j, dataclasses.replace(cfg_t, **KERNEL_FLAGS)


def test_neat_forward_and_loss_match_jax():
    cfg_j, cfg_t = model_configs()
    params = jneat.init_neat(jax.random.PRNGKey(0), cfg_j)
    model = port_model(params, cfg_t)
    scene = small_scene(cfg_j)
    rs = np.random.RandomState(0)
    r = 16
    view = 1
    pix = rs.randint(0, scene["rgb"].shape[1], r)
    w = 32
    inputs = {
        "uv": np.stack([pix % w, pix // w], -1).astype(np.float32),
        "uv_proj": scene["uv_proj"][view, pix],
        "intrinsics": scene["intrinsics"][view],
        "pose": scene["pose"][view],
        "verts2d": scene["verts2d"][view],
        "verts_mask": scene["verts_mask"][view],
    }
    gt = {"rgb": scene["rgb"][view, pix], "lines2d": scene["lines"][view, scene["labels"][view, pix]]}
    key = jax.random.PRNGKey(7)
    noise = to_numpy(jneat.draw_forward_noise(key, r, cfg_j))

    @jax.jit
    def run_j(params, inputs, gt, noise):
        out = jneat.neat_forward(params, inputs, cfg_j, key, training=True, noise=noise)
        return out, jloss.neat_loss(out, gt, jloss.LossConfig())

    out_j, loss_j = to_numpy(run_j(params, inputs, gt, noise))
    out_t = tneat.neat_forward(
        model, {k: t(v) for k, v in inputs.items()}, cfg_t, noise={k: t(v) for k, v in noise.items()}
    )
    loss_t = tloss.neat_loss(out_t, {k: t(v) for k, v in gt.items()}, tloss.LossConfig())

    assert set(out_t) == set(out_j)
    for k in sorted(out_j):
        a, b = n(out_t[k]), out_j[k]
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        err = np.abs(a.astype(np.float64) - b).max() / max(np.abs(b).max(), 1e-6)
        assert err < 1e-4, (k, err)
    assert set(loss_t) == set(loss_j)
    for k in sorted(loss_j):
        np.testing.assert_allclose(float(loss_t[k].detach()), float(loss_j[k]), rtol=1e-4, atol=1e-5, err_msg=k)


def test_masked_median_and_unported_variants():
    vals = torch.tensor([5.0, 1.0, 4.0, 2.0, 3.0, 9.0])
    mask = torch.tensor([True, True, True, True, False, False])
    ref = jneat._masked_median(jnp.asarray(n(vals)), jnp.asarray(n(mask)))
    assert float(tneat._masked_median(vals, mask)) == float(ref) == 2.0  # lower median
    assert float(tneat._masked_median(vals, torch.zeros(6, dtype=torch.bool))) == 10.0
    cfg = dataclasses.replace(tneat.NeatConfig.for_abc(), dual_batch=True)
    try:
        tneat.check_ported(cfg)
    except NotImplementedError as e:
        assert "ROADMAP.md" in str(e)
    else:
        raise AssertionError("an unported variant flag must raise")
