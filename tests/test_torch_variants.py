"""The reference's ablation model classes in the port against neat_tpu.

Each class string goes through both packages' conf pipelines (class ->
variant flags -> NeatConfig), the nets are narrowed as in
tests/test_torch_step.py (9-layer skip-4 SDF of width 64, heads of width 64,
a small sampler), every flag the class map set kept. Both packages start
from the same JAX init (the port's modules must take it strictly: a
variant without attraction and junctions, a second SDF for along_ray_v2),
widened to f64, and take one f64 training step (``jax.enable_x64``, the
port's model, batch and noise in f64), with both junction assignments
(the model's against the HAWP junctions and the loss's) by the
``callback`` method, scipy's Hungarian: the auction stops at an
eps-optimal assignment, and the two packages' auctions, handed costs that
differ in the last bits (f32, or f64 after another summation order), part
in their bidding on rend_a as on every class, where the optimum is unique
(a row's two cheapest costs at least 5.7e-4 apart). The batch
and noise are the JAX step's from key 11 (``make_train_step``'s key
splits; for the dual-batch class the uniform batch of the same view by the
step's replay of its view draw, and one noise dict for each of its two
forwards), handed to JAX's loss_fn and Adam and to the port's step.
rend_c trains with ``dbscan_enabled`` on a scene whose support is three
pixels, so rays repeat and DBSCAN finds clusters;
junction_eikonal is rend_a with ``model.junction_eikonal = true``.

Tolerances, those of tests/test_torch_step.py: every entry of the loss
dict to 1e-4 relative (1e-6 absolute for the entries that are 0), every
parameter entry after the Adam step to 1e-5. The eval-mode forward of the
wfr and along-ray classes (``eval_attraction_at_l3d``, ``score``): every
output to 1e-4 of its largest entry, as tests/test_torch_eval_forward.py.

This file: rend_c, junction_eikonal, neat_uni and VolSDF; the along-ray
sort on tied distances; the checkpoint and weight bridge of the variant
modules. The wfr family and the dual class: test_torch_variants_wfr.py;
the along-ray family: test_torch_variants_along_ray.py.
"""

import jax
import numpy as np
import pytest
import torch

import _variants as V
from _torch_helpers import n, one_thread, t


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module", params=["rend_c", "junction_eikonal", "uni", "volsdf"])
def stepped(request):
    return V.stepped(request.param)


def test_class_maps_to_its_flags(stepped):
    V.check_class_flags(stepped)


def test_one_train_step_matches_jax(stepped):
    V.check_one_train_step(stepped)


def test_endpoint_render_keeps_the_order_of_tied_distances():
    """The along-ray endpoint rendering on tracks whose camera distances tie
    exactly (endpoints at (3, 4, 0), (0, 3, 4), (4, 0, 3), (0, 0, 5) ... from
    a camera at the origin, scaled by 1/4: all exactly 1.25 away): the port's stable sort keeps the
    tied samples in their order, as jnp.argsort does, so the weights and
    the rendered endpoints equal the JAX package's formula on the same
    sdf values (neat_tpu/model/neat.py, the endpoint_render branch)."""
    import jax.numpy as jnp

    import neat_tpu.core.render as jrender
    import neat_tpu.fields.mlp as jmlp

    ej, et = V.class_configs("along_ray")
    cfg_j, cfg_t = ej.model, et.model
    params = V.jneat.init_neat(jax.random.PRNGKey(7), cfg_j)
    model = V.port_model(params, cfg_t)
    ties = np.array([[3, 4, 0], [0, 3, 4], [4, 0, 3], [0, 0, 5], [0, 4, 3], [3, 0, 4]], np.float32) * 0.25
    rs = np.random.RandomState(0)
    n_rays, n_samples = 3, 8
    lines = np.empty((n_rays, n_samples, 2, 3), np.float32)
    for r in range(n_rays):
        for e in range(2):
            lines[r, :, e] = np.concatenate([ties[rs.permutation(6)], rs.rand(2, 3).astype(np.float32)])
    cam = np.zeros((n_rays, 3), np.float32)
    got_lines, got_score = V.tneat._endpoint_render(model, cfg_t, t(lines), t(cam))

    ek = jnp.asarray(lines).transpose(0, 2, 1, 3).reshape(2 * n_rays, n_samples, 3)
    sdf_e = jmlp.implicit_sdf(params["implicit"], ek.reshape(-1, 3), cfg_j.implicit)[..., 0].reshape(
        2 * n_rays, n_samples)
    z_e = jnp.linalg.norm(ek - jnp.repeat(jnp.asarray(cam), 2, axis=0)[:, None, :], axis=-1)
    assert int(np.sum(np.asarray(z_e) == np.float32(1.25))) == 2 * n_rays * 6  # the ties are exact
    order = jnp.argsort(z_e, axis=-1)
    w_e = jrender.volume_rendering_weights(jnp.take_along_axis(z_e, order, axis=-1),
                                           jnp.take_along_axis(sdf_e, order, axis=-1), params["density"],
                                           beta_min=cfg_j.density_beta_min)
    want_lines = jnp.sum(w_e[..., None] * jnp.take_along_axis(ek, order[..., None], axis=1), axis=1).reshape(
        n_rays, 2, 3)
    want_score = jnp.mean(jnp.max(w_e, axis=-1).reshape(n_rays, 2), axis=-1)
    assert np.array_equal(n(torch.argsort(t(np.asarray(z_e)), dim=-1, stable=True)), np.asarray(order))
    np.testing.assert_allclose(n(got_lines), np.asarray(want_lines), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(got_score), np.asarray(want_score), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key", ["volsdf", "along_ray_v2"])
def test_checkpoint_and_weight_bridge_carry_the_variant_modules(key, tmp_path):
    """A model without attraction and junctions (VolSDF) and one with a
    second SDF (along_ray_v2): JAX's tree through ``V.params_from_jax`` into
    the port's model (strict), saved and loaded back bit for bit, and its
    JAX export keys (``ModelParameters``) those of the JAX tree."""
    from neat_tpu_torch.train.checkpoint import load_model, save_checkpoint

    ej, et = V.class_configs(key)
    params = V.jneat.init_neat(jax.random.PRNGKey(1), ej.model)
    model = V.port_model(params, et.model)
    assert ("neat_sdf" in params) == (model.neat_sdf is not None) == (key == "along_ray_v2")
    assert ("attraction" in params) == (model.attraction is not None) == (key != "volsdf")
    save_checkpoint(str(tmp_path), V.tstep.init_train_state(model), 3)
    loaded, epoch = load_model(str(tmp_path), "latest", et.model, "cpu")
    assert epoch == 3
    want, got = model.state_dict(), loaded.state_dict()
    assert set(want) == set(got) and all(torch.equal(want[k], got[k]) for k in want)
    with np.load(tmp_path / "ModelParameters" / "3.npz") as z:
        assert len(z.files) == len(jax.tree_util.tree_leaves(params))


def test_volsdf_finalize_fails_as_in_jax():
    """Finalize on a VolSDF model: its eval forward (equal to JAX's, every
    output) has no attraction outputs, so both packages' view_field_lines
    stop with KeyError 'lines3d'."""
    import types

    import neat_tpu.wireframe.finalize as jfin
    import neat_tpu_torch.wireframe.finalize as tfin

    V.check_eval_forward("volsdf")
    ej, et = V.class_configs("volsdf")
    params = V.jneat.init_neat(jax.random.PRNGKey(5), ej.model)
    model = V.port_model(params, et.model).requires_grad_(False)
    packed = V.small_scene(ej.model)
    scene = types.SimpleNamespace(
        mask=packed["mask"], labels=packed["labels"], img_res=(V.RES, V.RES), uv_proj=packed["uv_proj"],
        intrinsics=packed["intrinsics"], pose=packed["pose"])
    mask = np.zeros(V.RES * V.RES, bool)
    mask[:8] = True
    for call in (lambda: jfin.view_field_lines(params, ej.model, scene, 0, 8, mask_override=mask),
                 lambda: tfin.view_field_lines(model, et.model, scene, 0, 8, mask_override=mask)):
        with pytest.raises(KeyError, match="lines3d"):
            call()
