"""The along-ray family (neat_along_ray, neat_along_ray_v2) against
neat_tpu: one f64 step each, the eval-mode forward (``score``), and
along_ray_v2's second SDF network's gradient. Tolerances and set-up:
tests/test_torch_variants.py."""

import dataclasses as dc

import jax
import numpy as np
import pytest
import torch

import _variants as V
from _torch_helpers import n, one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module", params=["along_ray", "along_ray_v2"])
def stepped(request):
    return V.stepped(request.param)


def test_class_maps_to_its_flags(stepped):
    V.check_class_flags(stepped)


def test_one_train_step_matches_jax(stepped):
    V.check_one_train_step(stepped)


@pytest.mark.parametrize("key", ["along_ray", "along_ray_v2"])
def test_eval_forward_matches_jax(key):
    V.check_eval_forward(key)


def test_neat_sdf_trains_only_through_the_endpoint_term():
    """along_ray_v2's second SDF network: its gradient in f64 equals JAX's,
    is not zero, and comes from the endpoint rendering alone (the same
    model with the weighted line integral gives it none)."""
    ej, et = V.class_configs("along_ray_v2")
    cfg_j, cfg_t = ej.model, et.model
    params = V.to_numpy(V.jneat.init_neat(jax.random.PRNGKey(3), cfg_j))
    scene = V._scene(cfg_j, "along_ray_v2")
    inputs, gt, noise = V._draws(cfg_j, scene, "along_ray_v2")
    with jax.enable_x64(True):
        from neat_tpu.model.loss import neat_loss

        def loss_j(p):
            out = V.jneat.neat_forward(p, V._f64(inputs), cfg_j, jax.random.PRNGKey(0), training=True, noise=V._f64(noise))
            return neat_loss(out, V._f64(gt), ej.loss)["loss"]

        g_j = V.params_from_jax(V.to_numpy(jax.jit(jax.grad(loss_j))(V._f64(params))))
    grads = {}
    for aggregation in ("endpoint_render", "weighted"):
        model = V.port_model(params, cfg_t).double()
        cfg = dc.replace(cfg_t, attraction_aggregation=aggregation)
        out = V.tneat.neat_forward(model, V._tensors(inputs), cfg, training=True, noise=V._tensors(noise))
        loss = V.tstep.neat_loss(out, V._tensors(gt), et.loss)["loss"]
        names = [k for k, _ in model.named_parameters() if k.startswith("neat_sdf.")]
        params_t = [p for k, p in model.named_parameters() if k.startswith("neat_sdf.")]
        grads[aggregation] = dict(zip(names, torch.autograd.grad(loss, params_t, allow_unused=True)))
    assert all(g is None for g in grads["weighted"].values())
    for k, g in grads["endpoint_render"].items():
        ref = g_j[k].numpy()
        assert np.abs(ref).max() > 0, k
        assert np.abs(n(g) - ref).max() <= 1e-6 * np.abs(ref).max(), k


