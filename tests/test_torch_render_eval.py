"""Render eval of the port (neat_tpu_torch/evaluation/render_eval.py)
against neat_tpu.evaluation.render_eval, on a generated 32 x 32, 2-view
scene and the same narrow f32 weights.

- render_view on every pixel of a view, in chunks that leave the last one
  padded, in float64 in both packages (``jax.enable_x64``; the f32 weights
  and the scene's cameras widened): rgb, normal and depth within F64_TOL =
  1e-9 of each output's largest entry. In f32 the packages differ by f32
  sums in another order, within 2e-5 on all rays but one of 1024, whose
  normal moved by 1e-4 (a sampler decision on its knife edge), so the
  render is held in f64.
- render_views_psnr: the PSNRs within PSNR_TOL = 1e-3 dB, psnr.csv's rows
  (view ids) the same; the PNGs the port writes read back through its own
  read_png equal the rendered images quantized as the JAX package does,
  and equal the JAX package's PNGs (written by imageio) to within one
  8-bit level, where f32 rounding lands a pixel on the other side of a
  level.
- export_scene_mesh: the port's mesh pipeline (sdf_to_mesh ->
  marching_tetrahedra, largest_component, save_ply, load_ply) equals the
  JAX package's bit for bit on the same SDF grid, and the grid the port
  evaluates equals the JAX package's SDF within TOL.
"""

import dataclasses
import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neat_tpu.evaluation.render_eval as jre
import neat_tpu.model.neat as jneat
import neat_tpu.viz.mesh as jmesh
from neat_tpu.fields.mlp import implicit_sdf
import neat_tpu_torch.evaluation.render_eval as tre
import neat_tpu_torch.viz.mesh as tmesh
from _torch_helpers import configs, disk_scenes, port_model
from neat_tpu_torch.data.png import read_png

TOL = 1e-4
F64_TOL = 1e-9
PSNR_TOL = 1e-3
RES = (32, 32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from neat_tpu_torch.data.synthetic import generate_scene

    root = str(tmp_path_factory.mktemp("render"))
    generate_scene(osp.join(root, "toy"), n_views=2, res=RES, seed=1)
    scene_j, scene_t = disk_scenes(root, "toy", RES, distance_threshold=10.0)
    cfg_j, cfg_t = configs()
    params = jneat.init_neat(jax.random.PRNGKey(2), cfg_j)
    return cfg_j, params, cfg_t, port_model(params, cfg_t), scene_j, scene_t


def _rel(a, b):
    return np.abs(np.asarray(a, np.float64) - b).max() / max(np.abs(b).max(), 1e-6)


def test_uv_full_matches_jax(setup):
    *_, scene_j, scene_t = setup
    np.testing.assert_array_equal(scene_t.uv_full(), scene_j.uv_full())
    assert scene_t.uv_full().dtype == np.float32


@pytest.mark.parametrize("chunksize", [256, 300])
def test_render_view_matches_jax(setup, chunksize):
    cfg_j, params, cfg_t, model, scene_j, scene_t = setup
    f64 = lambda s: dataclasses.replace(s, intrinsics=s.intrinsics.astype(np.float64), pose=s.pose.astype(np.float64))
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), params)
        want = jre.render_view(p64, cfg_j, f64(scene_j), 1, chunksize=chunksize)
    got = tre.render_view(model.to(torch.float64), cfg_t, f64(scene_t), 1, chunksize=chunksize)
    model.to(torch.float32)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype == np.float64, k
        assert _rel(got[k], want[k]) < F64_TOL, (k, _rel(got[k], want[k]))


def test_render_views_psnr_and_pngs(setup, tmp_path):
    cfg_j, params, cfg_t, model, scene_j, scene_t = setup
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jre.render_views_psnr(params, cfg_j, scene_j, dj, views=[1, 0], chunksize=512)
    got = tre.render_views_psnr(model, cfg_t, scene_t, dt, views=[1, 0], chunksize=512)
    for k in want:
        assert abs(got[k] - want[k]) < PSNR_TOL, k
    rows = lambda d: [line.split(",")[0] for line in open(osp.join(d, "psnr.csv"))]
    assert rows(dt) == rows(dj) == ["1", "0", "mean", "std"]
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj))
    out = tre.render_view(model, cfg_t, scene_t, 0, chunksize=512)
    np.testing.assert_array_equal(read_png(osp.join(dt, "eval_000.png")),
                                  (np.clip(out["rgb"], 0, 1) * 255).astype(np.uint8))
    np.testing.assert_array_equal(read_png(osp.join(dt, "normal_000.png")),
                                  (np.clip((out["normal"] + 1) / 2, 0, 1) * 255).astype(np.uint8))
    for name in os.listdir(dj):
        if name.endswith(".png"):
            a, b = read_png(osp.join(dt, name)), read_png(osp.join(dj, name))
            assert a.shape == b.shape and np.abs(a.astype(int) - b).max() <= 1, name


def _blob_sdf(pts):
    """Two spheres, one large and one small, apart: a grid SDF with two
    components."""
    pts = np.asarray(pts, np.float64)
    a = np.linalg.norm(pts - [0.3, 0.0, 0.1], axis=-1) - 0.8
    b = np.linalg.norm(pts - [-1.1, 0.9, -0.8], axis=-1) - 0.25
    return np.minimum(a, b).astype(np.float32)


@pytest.mark.parametrize("resolution", [17, 40])
def test_mesh_pipeline_bit_equal_to_jax(resolution, tmp_path):
    want = jmesh.sdf_to_mesh(_blob_sdf, resolution=resolution, chunk=1000)
    got = tmesh.sdf_to_mesh(_blob_sdf, resolution=resolution, chunk=1000)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    big_j, big_t = jmesh.largest_component(*want), tmesh.largest_component(*got)
    for a, b in zip(big_t, big_j):
        np.testing.assert_array_equal(a, b)
    assert big_t[1].shape[0] < got[1].shape[0]  # the small sphere went
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jmesh.save_ply(pj, *big_j)
    tmesh.save_ply(pt, *big_t)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    for a, b in zip(tmesh.load_ply(pj), jmesh.load_ply(pj)):
        np.testing.assert_array_equal(a, b)
    values = _blob_sdf(np.random.RandomState(0).rand(9, 10, 11, 3) * 3 - 1.5)
    for a, b in zip(tmesh.marching_tetrahedra(values, (-1, 0, 1), (0.1, 0.2, 0.3)),
                    jmesh.marching_tetrahedra(values, (-1, 0, 1), (0.1, 0.2, 0.3))):
        np.testing.assert_array_equal(a, b)


def test_export_scene_mesh_matches_jax(setup, tmp_path):
    cfg_j, params, cfg_t, model, *_ = setup
    grid = np.random.RandomState(4).uniform(-1.5, 1.5, (5000, 3)).astype(np.float32)
    want = np.asarray(implicit_sdf(params["implicit"], jnp.asarray(grid), cfg_j.implicit)[..., 0])
    assert _rel(tre.grid_sdf_fn(model, cfg_t)(grid), want) < TOL
    # the port's export against the JAX package's mesh code on the port's own grid function
    sm = np.diag([2.0, 2.0, 2.0, 1.0])
    sm[:3, 3] = [0.5, -0.25, 1.0]
    for kw in (dict(), dict(scale_mat=sm, keep_largest_component=True)):
        path = str(tmp_path / "port.ply")
        verts, faces = tre.export_scene_mesh(model, cfg_t, path, resolution=24, chunk=4096, **kw)
        wv, wf = jmesh.sdf_to_mesh(tre.grid_sdf_fn(model, cfg_t), resolution=24, chunk=4096)
        if "scale_mat" in kw:
            wv = wv @ sm[:3, :3].T + sm[:3, 3]
            wv, wf = jmesh.largest_component(wv, wf)
        np.testing.assert_array_equal(verts, wv)
        np.testing.assert_array_equal(faces, wf)
        assert len(faces) > 100
        lv, lf = tmesh.load_ply(path)
        np.testing.assert_array_equal(lf, wf)
        np.testing.assert_allclose(lv, wv, atol=1e-6)


def test_main_renders_and_exports_on_the_cpu(setup, tmp_path):
    """The CLI on a rundir with the port's checkpoint: psnr.csv, the PNGs
    and surface_{epoch}.ply; --mesh raises."""
    from test_torch_finalize import CONF

    from neat_tpu_torch.train.checkpoint import save_checkpoint
    from neat_tpu_torch.train.config import load_experiment_config
    from neat_tpu_torch.train.step import init_train_state
    from neat_tpu_torch.data.synthetic import generate_scene

    root = str(tmp_path / "data")
    generate_scene(osp.join(root, "toy"), n_views=2, res=(48, 48), seed=1)
    rundir = tmp_path / "run"
    rundir.mkdir()
    (rundir / "runconf.conf").write_text(CONF)
    conf = str(rundir / "runconf.conf")
    model = port_model(jneat.init_neat(jax.random.PRNGKey(2), configs()[0]), load_experiment_config(conf).model)
    save_checkpoint(str(rundir / "checkpoints"), init_train_state(model), 5)
    stats = tre.main(["--conf", conf, "--data_root", root, "--views", "1", "--resolution", "20",
                      "--chunksize", "1024", "--device", "cpu"])
    ev = rundir / "evaluation"
    assert sorted(os.listdir(ev)) == ["eval_001.png", "normal_001.png", "psnr.csv", "surface_5.ply"]
    assert np.isfinite(stats["psnr_mean"]) and stats["epoch"] == 5
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tre.main(["--conf", conf, "--mesh", "2"])
