"""The alternate distillation tools of the port
(neat_tpu_torch/wireframe/distill.py) against neat_tpu.wireframe.distill, on
the cases tests/test_pipeline.py runs in JAX (cross-view fusion of GT lines
plus garbage; refinement with an impossible sdf gate, with a score gate
and with permissive gates; dgrid at resolution 16), and on the others'
own inputs, on a generated 48 x 48, 3-view scene at distance_threshold 3.

The tools that evaluate the field (simple_recon, refinement_recon,
dgrid_recon, refine_lines_sdf) run in float64 in both packages
(``jax.enable_x64``; the f32 weights and the scene's cameras widened), so
their decisions cannot flip on f32 rounding: every kept set equal, every
array within F64_TOL = 1e-9. The numpy-only tools (fuse_lines, nms_lines,
merge_wireframes, grid_distill, greedy_suppress_lines) give the JAX
package's arrays exactly.
"""

import dataclasses
import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neat_tpu.model.neat as jneat
import neat_tpu.wireframe.distill as jd
import neat_tpu_torch.wireframe.distill as td
from _torch_helpers import configs, disk_scenes, one_thread, port_model, spread_attraction


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


F64_TOL = 1e-9
RES = (48, 48)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from neat_tpu_torch.data.synthetic import generate_scene

    root = str(tmp_path_factory.mktemp("distill"))
    generate_scene(osp.join(root, "toy"), n_views=3, res=RES, seed=0)
    scene_j, scene_t = disk_scenes(root, "toy", RES, distance_threshold=3.0)
    with open(osp.join(root, "toy", "lines.json")) as f:
        gt = json.load(f)
    j = np.asarray(gt["junctions"], dtype=np.float32)
    cfg_j, cfg_t = configs()
    params = spread_attraction(jneat.init_neat(jax.random.PRNGKey(0), cfg_j))
    return dict(root=root, scene_j=scene_j, scene_t=scene_t, gt_lines=j[np.asarray(gt["lines"])],
                cfg_j=cfg_j, cfg_t=cfg_t, params=params, model=port_model(params, cfg_t, torch.float64))


def _f64(scene):
    return dataclasses.replace(scene, intrinsics=scene.intrinsics.astype(np.float64),
                               pose=scene.pose.astype(np.float64))


def _both(env, jfn, tfn, *args, **kwargs):
    """jfn(params, cfg_j, scene_j, ...) under x64 and tfn(model, cfg_t,
    scene_t, ...), both in f64."""
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), env["params"])
        want = jfn(p64, env["cfg_j"], _f64(env["scene_j"]), *args, **kwargs)
    return tfn(env["model"], env["cfg_t"], _f64(env["scene_t"]), *args, **kwargs), want


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size:
        assert np.abs(a.astype(np.float64) - b).max() <= F64_TOL


@pytest.mark.parametrize("dis_threshold", [10.0, 1e8])
def test_simple_recon_matches_jax(env, dis_threshold):
    got, want = _both(env, jd.simple_recon, td.simple_recon, chunksize=256, dis_threshold=dis_threshold)
    _close(got, want)
    if dis_threshold > 1e3:
        assert want.shape[0] > 0


@pytest.mark.parametrize("reference_scoring", [False, True])
def test_fuse_lines_matches_jax(env, reference_scoring):
    lines = env["gt_lines"]
    garbage = lines + np.asarray([5.0, 5.0, 5.0], np.float32)[None, None]
    both = np.concatenate([lines, garbage])
    for keep in (0.5, 0.0):
        want = jd.fuse_lines(env["scene_j"], both, keep_score=keep, reference_scoring=reference_scoring)
        got = td.fuse_lines(env["scene_t"], both, keep_score=keep, reference_scoring=reference_scoring)
        np.testing.assert_array_equal(got, want)
    assert td.fuse_lines(env["scene_t"], both).shape[0] == lines.shape[0]


@pytest.mark.parametrize("case", ["impossible_sdf_gate", "score_gate", "permissive"])
def test_refinement_recon_matches_jax(env, case):
    lines = env["gt_lines"]
    rng = np.random.RandomState(0)
    dup = np.repeat(lines, 3, axis=0) + rng.randn(3 * len(lines), 2, 3).astype(np.float32) * 0.005
    kw = {
        "impossible_sdf_gate": dict(sdf_threshold=1e-12),
        "score_gate": dict(sdf_threshold=1e9, scores=np.full(len(dup), 1.0), score_threshold=0.01),
        "permissive": dict(sdf_threshold=1e9, match_threshold=1e9),
    }[case]
    got, want = _both(env, lambda p, c, s, *a, **k: jd.refinement_recon(p, c, s, dup, **k),
                      lambda m, c, s, *a, **k: td.refinement_recon(m, c, s, dup, **k), **kw)
    _close(got, want)
    if case == "permissive":
        assert 0 < want.shape[0] < dup.shape[0]
    else:
        assert want.shape[0] == 0


def test_dgrid_recon_matches_jax(env):
    kw = dict(resolution=16, sdf_eps=0.1, grid_bounds=((-1, -1, -1), (1, 1, 1)), chunksize=256)
    got, want = _both(env, jd.dgrid_recon, td.dgrid_recon, **kw)
    assert want.ndim == 3 and want.shape[1:] == (2, 3)
    _close(got, want)
    # gates loose enough that the untrained field produces clustered lines
    loose = dict(kw, orth_threshold=1e8, overlap_threshold=-1e8)
    got, want = _both(env, jd.dgrid_recon, td.dgrid_recon, **loose)
    assert want.shape[0] > 0
    _close(got, want)


def test_refine_lines_sdf_matches_jax(env):
    lines = env["gt_lines"] * 0.5
    for n_steps, keep in ((1, 0.05), (3, 10.0)):
        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), env["params"])
            want = jd.refine_lines_sdf(p64, env["cfg_j"], lines.astype(np.float64), n_steps, keep)
        got = td.refine_lines_sdf(env["model"], env["cfg_t"], lines.astype(np.float64), n_steps, keep)
        _close(got, want)
    assert want.shape[0] == lines.shape[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_tools_equal_jax(env, seed):
    rs = np.random.RandomState(seed)
    lines = np.concatenate([env["gt_lines"], env["gt_lines"] + rs.normal(0, 0.01, env["gt_lines"].shape),
                            rs.rand(6, 2, 3)]).astype(np.float32)
    np.testing.assert_array_equal(td.nms_lines(lines, resolution=64), jd.nms_lines(lines, resolution=64))
    np.testing.assert_array_equal(td.merge_wireframes([lines[:20], lines[10:], lines[:5]]),
                                  jd.merge_wireframes([lines[:20], lines[10:], lines[:5]]))
    np.testing.assert_array_equal(td.grid_distill(lines, cell_size=0.1, min_votes=1),
                                  jd.grid_distill(lines, cell_size=0.1, min_votes=1))
    scores = rs.rand(len(lines))
    np.testing.assert_array_equal(td.greedy_suppress_lines(lines, scores, 0.05),
                                  jd.greedy_suppress_lines(lines, scores, 0.05))
    np.testing.assert_array_equal(td.line_pair_distance(lines[:7], lines), jd.line_pair_distance(lines[:7], lines))


def test_cli_merge_and_nms(env, tmp_path):
    lines = env["gt_lines"]
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    np.savez(a, lines3d=lines)
    per_view = np.empty(2, dtype=object)  # the reference's layout: one (L, 2, 3) array a view
    per_view[0], per_view[1] = lines[:3], lines[3:] + 0.3
    np.savez(b, lines3d=per_view)
    for cmd in (["merge", a, b, "--out", str(tmp_path / "m.npz")], ["nms", "--data", a, "--out", str(tmp_path / "n.npz"),
                                                                    "--resolution", "32"]):
        out = cmd[cmd.index("--out") + 1]
        jd.main(cmd)
        want = np.load(out)["lines3d"]
        td.main(cmd)
        np.testing.assert_array_equal(np.load(out)["lines3d"], want)
