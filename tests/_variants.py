"""The classes, the conf pipelines and the one-step comparison the
variant tests share (tests/test_torch_variants*.py); the tolerances and
what each test holds: tests/test_torch_variants.py's docstring."""

import dataclasses as dc
import textwrap

import jax
import numpy as np
import torch

import neat_tpu.model.neat as jneat
import neat_tpu.train.config as jconf
import neat_tpu.train.step as jstep
import neat_tpu_torch.model.neat as tneat
import neat_tpu_torch.train.config as tconf
import neat_tpu_torch.train.step as tstep
from _torch_helpers import n, port_model, small_scene, t, to_numpy
from neat_tpu_torch.interop import params_from_jax



LR, DECAY, DECAY_STEPS = 5e-4, 0.1, 1000
N_RAYS, RES = 12, 32

# id: (train.model_class, the conf's model block)
CLASSES = {
    "rend_c": ("model.networks.neat_wfr_rend_c.VolSDFNetwork", "dbscan_enabled = true"),
    "junction_eikonal": ("model.networks.neat_wfr_rend_a.VolSDFNetwork", "junction_eikonal = true"),
    "uni": ("model.networks.neat_uni.VolSDFNetwork", ""),
    "volsdf": ("model.network.VolSDFNetwork", ""),
    "wfr": ("model.networks.neat_wfr.VolSDFNetwork", ""),
    "wfr_a": ("model.networks.neat_wfr_a.VolSDFNetwork", ""),
    "simple": ("model.networks.neat_simple.VolSDFNetwork", ""),
    "dual": ("model.networks.neat_wfr_dual.VolSDFNetwork", ""),
    "along_ray": ("model.neat_along_ray.VolSDFNetwork", ""),
    "along_ray_v2": ("model.networks.neat_along_ray_v2.VolSDFNetwork", ""),
}
# the flags each class must come out with
FLAGS = {
    "rend_c": dict(dbscan_enabled=True, dbscan_include_global=True),
    "junction_eikonal": dict(junction_eikonal=True),
    "uni": dict(sampler_kind="uniform"),
    "volsdf": dict(model_variant="volsdf"),
    "wfr": dict(attraction_at_surface=True, eval_attraction_at_l3d=True),
    "wfr_a": dict(attraction_at_surface=True, detach_lines2d=False),
    "simple": dict(attraction_at_surface=True, eval_attraction_at_l3d=True, detach_lines2d=False),
    "dual": dict(dual_batch=True, attraction_at_surface=True),
    "along_ray": dict(attraction_aggregation="endpoint_render", endpoint_sdf_separate=False),
    "along_ray_v2": dict(attraction_aggregation="endpoint_render", endpoint_sdf_separate=True),
}


def _conf(model_class, model_block):
    return textwrap.dedent(f"""
        train {{
            expname = v
            dataset_class = datasets.blender_hawp_dataset.BlenderDataset
            model_class = {model_class}
            loss_class = model.networks.loss_wfr.VolSDFLoss
            num_pixels = {N_RAYS}
        }}
        loss {{
            eikonal_weight = 0.1
            line_weight = 0.01
            junction_3d_weight = 0.1
            junction_2d_weight = 0.01
        }}
        dataset {{
            data_dir = toy
            img_res = [{RES}, {RES}]
        }}
        model {{
            scene_bounding_sphere = 3.0
            dbscan_enabled = false
            {model_block}
        }}
    """)


def _narrow(m):
    """Narrow nets and sampler; every variant flag and head mode kept."""
    return dc.replace(
        m,
        feature_vector_size=32,
        implicit=dc.replace(m.implicit, dims=(64,) * 8, skip_in=(4,), multires=6, feature_vector_size=32),
        rendering=dc.replace(m.rendering, dims=(64,) * 4, feature_vector_size=32),
        attraction=dc.replace(m.attraction, dims=(64,) * 4, feature_vector_size=32),
        junctions=dc.replace(m.junctions, num_junctions=16, dim_hidden=32),
        sampler=dc.replace(m.sampler, n_samples=16, n_samples_eval=32, n_samples_extra=8, max_total_iters=3),
        max_verts=16,
        sampler_compute_dtype="float32",
        assignment_method="callback",
    )


def class_configs(key):
    """(JAX ExperimentConfig, port ExperimentConfig) of a class, the models narrowed."""
    model_class, block = CLASSES[key]
    cfgs = []
    for pkg in (jconf, tconf):
        cfg = pkg.build_experiment_config(pkg.parse_hocon(_conf(model_class, block)))
        cfgs.append(dc.replace(cfg, model=_narrow(cfg.model), loss=dc.replace(cfg.loss, assignment_method="callback")))
    return tuple(cfgs)


def _f64(tree):
    """float32 leaves of a numpy tree -> float64 jax arrays (under enable_x64)."""
    import jax.numpy as jnp

    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else np.asarray(a)), tree)


def _tensors(tree):
    """A numpy tree -> tensors, float32 leaves widened to float64."""
    return {k: _tensors(v) if isinstance(v, dict) else (t(v).double() if np.asarray(v).dtype == np.float32 else t(v))
            for k, v in tree.items()}


def _scene(cfg_j, key):
    scene = small_scene(cfg_j)
    if key == "rend_c":  # three support pixels: rays repeat, DBSCAN clusters their endpoints
        scene["support_idx"][:] = np.resize(np.array([300, 301, 333], np.int32), scene["support_idx"].shape[1])
        scene["support_count"][:] = 3
    return scene


def _draws(cfg_j, scene, key):
    """The batch and noise of the JAX step's first step from key 11 (f32
    numpy): its sample_batch under make_train_step's key splits; for the
    dual-batch class the uniform batch of the same view by the step's replay
    of its view draw, and one noise dict for each of the two forwards."""
    rng = jax.random.PRNGKey(11)
    r_batch, r_fwd = jax.random.split(jax.random.fold_in(rng, 0))
    inputs, gt = to_numpy(jstep.sample_batch(r_batch, scene, N_RAYS, RES))
    if not cfg_j.dual_batch:
        return inputs, gt, to_numpy(jneat.draw_forward_noise(r_fwd, N_RAYS, cfg_j))
    view = jax.random.randint(jax.random.split(r_batch)[0], (), 0, scene["rgb"].shape[0])
    uni_inputs, uni_gt = to_numpy(jstep.sample_uniform_batch(jax.random.fold_in(r_batch, 1), scene, N_RAYS, RES, view))
    gt = dict(gt, _uniform_inputs=uni_inputs, _uniform_rgb=uni_gt["rgb"])
    return inputs, gt, tuple(to_numpy(jneat.draw_forward_noise(r, N_RAYS, cfg_j)) for r in jax.random.split(r_fwd))


def _jax_step(cfg_j, loss_cfg):
    """The JAX step's loss_fn (train/step.py, the dual-batch branch too) and
    Adam, with the noise injected."""
    import optax

    from neat_tpu.core.camera import psnr
    from neat_tpu.model.loss import neat_loss

    opt = jstep.make_optimizer(LR, DECAY, DECAY_STEPS)
    key = jax.random.PRNGKey(0)

    def loss_fn(p, inputs, gt, noise):
        if cfg_j.dual_batch:
            out0 = jneat.neat_forward(p, gt["_uniform_inputs"], cfg_j, key, training=True, noise=noise[0])
            out = dict(jneat.neat_forward(p, inputs, cfg_j, key, training=True, noise=noise[1]))
            out["rgb_values"], out["grad_theta"] = out0["rgb_values"], out0["grad_theta"]
            gt = {k: v for k, v in gt.items() if not k.startswith("_uniform")} | {"rgb": gt["_uniform_rgb"]}
        else:
            out = jneat.neat_forward(p, inputs, cfg_j, key, training=True, noise=noise)
        aux = dict(neat_loss(out, gt, loss_cfg))
        aux["psnr"] = psnr(out["rgb_values"], gt["rgb"])
        return aux["loss"], aux

    @jax.jit
    def step(p, opt_state, inputs, gt, noise):
        (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, inputs, gt, noise)
        updates, opt_state = opt.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), aux

    return step, opt


def one_step(key):
    """One f64 step of the class in both packages -> (JAX metrics, port
    metrics, JAX params after, port state after, configs)."""
    ej, et = class_configs(key)
    cfg_j, cfg_t = ej.model, et.model
    params = to_numpy(jneat.init_neat(jax.random.PRNGKey(3), cfg_j))
    model = port_model(params, cfg_t).double()
    scene = _scene(cfg_j, key)
    inputs, gt, noise = _draws(cfg_j, scene, key)
    with jax.enable_x64(True):
        step_j, opt = _jax_step(cfg_j, ej.loss)
        p64 = _f64(params)
        p_j, m_j = step_j(p64, opt.init(p64), _f64(inputs), _f64(gt), _f64(noise))
        m_j, p_j = to_numpy(m_j), to_numpy(p_j)
    state_t = tstep.init_train_state(model)
    step_t = tstep.make_train_step(cfg_t, et.loss, LR, DECAY, DECAY_STEPS, N_RAYS, RES)
    noise_t = tuple(map(_tensors, noise)) if cfg_t.dual_batch else _tensors(noise)
    state_t, m_t = step_t(state_t, None, batch=(_tensors(inputs), _tensors(gt)), noise=noise_t)
    return m_j, m_t, p_j, state_t, (cfg_j, cfg_t)


def stepped(key):
    """one_step of the class, with the sizes of DBSCAN's inputs and its
    valid proposals recorded."""
    seen = []
    orig = tneat.dbscan_cluster_means

    def recorded(*a, **k):
        means, valid = orig(*a, **k)
        seen.append((a[0].shape[0], int(valid.sum())))
        return means, valid

    tneat.dbscan_cluster_means = recorded
    try:
        return key, one_step(key), seen
    finally:
        tneat.dbscan_cluster_means = orig


def check_class_flags(stepped):
    key, (_, _, _, _, (cfg_j, cfg_t)), _ = stepped
    for name, value in FLAGS[key].items():
        assert getattr(cfg_j, name) == getattr(cfg_t, name) == value, name
    assert dc.asdict(cfg_j) == dc.asdict(cfg_t)


def check_one_train_step(stepped):
    """The loss dict and every parameter after Adam, both packages."""
    key, (m_j, m_t, p_j, state_t, (cfg_j, _)), seen = stepped
    assert set(m_j) == set(m_t), (set(m_j) ^ set(m_t))
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4, atol=1e-6, err_msg=f"{key}: {k}")
    p_j = params_from_jax(p_j)
    p_t = state_t.model.state_dict()
    assert set(p_t) == set(p_j)
    worst = {k: float(np.abs(n(p_t[k]) - p_j[k].numpy()).max()) for k in p_j}
    bad = {k: v for k, v in worst.items() if v > 1e-5}
    assert not bad, f"{key}: parameters off after one step: {bad}"
    if key == "rend_c":  # the global junctions joined the cloud, and clusters formed
        assert seen and seen[0][0] == 2 * N_RAYS + cfg_j.junctions.num_junctions and seen[0][1] > 0
    if key == "volsdf":
        assert not any(k.startswith(("attraction", "junctions", "neat_sdf")) for k in p_t)
        assert "line_loss" not in m_t and float(m_t["j3d_loss"]) == 0.0  # the wireframe terms are absent
    if key == "along_ray_v2":
        assert any(k.startswith("neat_sdf.") for k in p_t)


def check_eval_forward(key):
    """The eval-mode forward of the wfr and along-ray classes: every output
    (the l3d re-evaluation of wfr / simple, along-ray's ``score``)."""
    ej, et = class_configs(key)
    cfg_j, cfg_t = jneat.offline_eval_config(ej.model), tneat.offline_eval_config(et.model)
    params = jneat.init_neat(jax.random.PRNGKey(5), cfg_j)
    model = port_model(params, cfg_t)
    scene = small_scene(cfg_j)
    rs = np.random.RandomState(1)
    pix = rs.randint(0, RES * RES, 32)
    inputs = {"uv": np.stack([pix % RES, pix // RES], -1).astype(np.float32), "uv_proj": scene["uv_proj"][0, pix],
              "intrinsics": scene["intrinsics"][0], "pose": scene["pose"][0]}
    fwd = jax.jit(lambda p, i: jneat.neat_forward(p, i, cfg_j, jax.random.PRNGKey(0), training=False))
    out_j = to_numpy(fwd(params, inputs))
    with torch.no_grad():
        out_t = tneat.neat_forward(model, {k: t(v) for k, v in inputs.items()}, cfg_t, training=False)
    assert set(out_j) == set(out_t)
    if key.startswith("along_ray"):
        assert out_t["score"].shape == (32,)
    for k, v in out_j.items():
        ref = np.asarray(v, np.float64)
        err = np.abs(n(out_t[k]).astype(np.float64) - ref).max() / max(np.abs(ref).max(), 1e-12)
        assert err <= 1e-4, (key, k, err)


