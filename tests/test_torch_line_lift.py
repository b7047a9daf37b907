"""The line lifting of the vanilla VolSDF network (``model/line_lift.py``)
against neat_tpu's: ``minstance_loss`` (its value and its gradient in every
implicit and rendering parameter) and ``two_view_lift`` in training and in
eval mode (the score and the lifted points), on the same weights and draws
(the interior draw u and the lifting forward's noise from the JAX keys'
splits), at narrow widths in f32; the eval-mode lift, which draws
nothing, in f64 in both packages.

Tolerances: the losses to 1e-4 relative; the lifted points to 1e-4 of
their largest entry (the eval-forward test's); the gradient of each leaf
to 1e-4 of the leaf's largest entry (f32 sums in another order through
the sampler, the volume rendering and the weight norm).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import neat_tpu.model.line_lift as jlift
import neat_tpu.model.neat as jneat
import neat_tpu_torch.model.line_lift as tlift
from _torch_helpers import configs, n, one_thread, port_model, small_scene, t, to_numpy
from neat_tpu_torch.interop import params_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = (dataclasses.replace(c, model_variant="volsdf", sampler_compute_dtype="float32")
                    for c in configs())
    params = jneat.init_neat(jax.random.PRNGKey(2), cfg_j)
    scene = small_scene(cfg_j)
    rs = np.random.RandomState(4)
    inputs = {
        "juncs2d": (rs.rand(10, 2) * 24 + 4).astype(np.float32),
        "edges": np.array([[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [1, 4]], np.int32),
        "weights": rs.rand(6).astype(np.float32),
        "pose": scene["pose"][0],
        "intrinsics": scene["intrinsics"][0],
    }
    return cfg_j, cfg_t, params, inputs


def _close(a, b, what):
    err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / max(np.abs(b).max(), 1e-12)
    assert err <= 1e-4, (what, err)


def test_minstance_loss_and_gradient_match_jax(setup):
    cfg_j, cfg_t, params, inputs = setup
    model = port_model(params, cfg_t)
    rng = jax.random.PRNGKey(9)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: jlift.minstance_loss(p, cfg_j, inputs, rng)))(params)
    r_lam, r_lift = jax.random.split(rng)
    n_lines = inputs["edges"].shape[0]
    u = t(jax.random.uniform(r_lam, (n_lines, 1, 1)))
    vcfg = dataclasses.replace(cfg_j, model_variant="volsdf")
    noise = {k: t(v) for k, v in to_numpy(jneat.draw_forward_noise(r_lift, 3 * n_lines, vcfg)).items()}
    loss_t = tlift.minstance_loss(model, cfg_t, {k: t(v) for k, v in inputs.items()}, u=u, noise=noise)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-4)
    names = [k for k, _ in model.named_parameters()]
    grads_t = torch.autograd.grad(loss_t, list(model.parameters()), allow_unused=True)
    ref = params_from_jax(to_numpy(grads_j))
    assert set(names) == set(ref)
    for name, g in zip(names, grads_t):
        g = np.zeros(ref[name].shape, np.float32) if g is None else n(g)
        _close(g, ref[name].numpy(), f"gradient of {name}")
    assert np.abs(ref["implicit.lin0.v"].numpy()).max() > 0  # the gradient reaches the implicit net


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else np.asarray(a), tree)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_two_view_lift_matches_jax(setup, training):
    """Training mode in f32 on the JAX draws; eval mode (no draws) in f64 in
    both packages, where f32 moves one of the 96 rays across a sampler
    decision (4e-4 of the largest point)."""
    cfg_j, cfg_t, params, inputs = setup
    model = port_model(params, cfg_t)
    rng = jax.random.PRNGKey(10)
    n_points = 16
    noise = None
    if training:
        loss_j, lines_j, pts_j = to_numpy(jax.jit(lambda p: jlift.two_view_lift(p, cfg_j, inputs, rng))(params))
        vcfg = dataclasses.replace(cfg_j, model_variant="volsdf")
        noise = {k: t(v) for k, v in to_numpy(
            jneat.draw_forward_noise(rng, inputs["edges"].shape[0] * n_points, vcfg)).items()}
        inputs_t = {k: t(v) for k, v in inputs.items()}
    else:
        with jax.enable_x64(True):
            inputs64 = _f64(inputs)
            loss_j, lines_j, pts_j = to_numpy(jax.jit(
                lambda p: jlift.two_view_lift(p, cfg_j, inputs64, rng, training=False))(_f64(to_numpy(params))))
        model = model.double()
        inputs_t = {k: t(v) for k, v in _f64(inputs).items()}
    with torch.no_grad():
        loss_t, lines_t, pts_t = tlift.two_view_lift(model, cfg_t, inputs_t, n_points=n_points, training=training,
                                                      noise=noise)
    np.testing.assert_allclose(n(pts_t), pts_j, rtol=1e-6, atol=1e-5)
    _close(n(lines_t), lines_j, "lines3d")
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
