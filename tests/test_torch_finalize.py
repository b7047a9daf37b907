"""Wireframe finalization of the port (neat_tpu_torch/wireframe/finalize.py)
against neat_tpu.wireframe.finalize, on a generated 48 x 48, 3-view scene
loaded by each package's own loader at distance_threshold 1.

- distill_views + assemble_wireframe + visibility_checking in float64 in
  both packages (``jax.enable_x64``; the port's model and scene in f64, its
  eval forward on the CPU's plain route). The gates are permissive, as in
  tests/test_finalize_parity.py (LINE_DIS = LINE_SCORE = JUNC_MATCH = 1e8),
  so every stage has content. The decisions must be the same: equal vote
  indices, equal graph, equal shapes. Arrays agree within F64_TOL = 1e-9
  (absolute; the scene spans a few units).
- wireframe_recon end to end through each package's CLI (``main``) from a
  runconf.conf and a checkpoint on disk, in f32 (each package's own
  checkpoint of the same weights): the same file names; the same
  decisions; the arrays within F32_TOL = 1e-4 of each array's largest
  entry (f32 sums in another order). The one exception is the support
  score of the distillation cache, ``scores_raw``, within SCORE_TOL = 1e-2
  of its largest entry: it averages the l3d points, and l3d divides by the
  tangent plane's d . n, near 0 on a grazing ray, which amplifies f32
  rounding (one ray's l3d of 1 in 200 moved by 0.15 between the packages
  in f32); the f64 tests above hold it at 1e-9. The untrained field's
  scores (about 0.5) are far above the 0.01 score gate, which
  wireframe_recon does not expose, so its lines come out empty in both
  packages here; the f64 tests hold those stages with content, and
  tests/test_torch_finalize_trained.py holds the CLI's lines with content
  on trained weights. Each package reads the other's -neat.pkl, and
  eval_abc gives the same numbers on both.
- make_hash_sha256 on the same knob dicts: the same string.
"""

import dataclasses
import os
import os.path as osp
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neat_tpu.model.neat as jneat
import neat_tpu.wireframe.finalize as jfin
import neat_tpu_torch.wireframe.finalize as tfin
from _torch_helpers import configs, disk_scenes, jax_numpy_encodels, port_model, spread_attraction

F64_TOL = 1e-9
F32_TOL = 1e-4
SCORE_TOL = 1e-2
RES = (48, 48)
N_VIEWS = 3
CHUNK = 128
PERMISSIVE = 1e8
ASSEMBLY = {
    "reference": dict(),
    "calibrated": dict(junction_merge_eps=0.2, merge_before_vote=True, junction_coords="vote_mean"),
    "post_merge_max": dict(junction_merge_eps=0.2, merge_mode="max", junction_coords="vote_median"),
    "sdf_filter": dict(sdf_filter_threshold=0.5),
}


def _f64_scene(scene):
    return dataclasses.replace(
        scene, **{f: getattr(scene, f).astype(np.float64) for f in ("intrinsics", "pose", "uv_proj", "lines", "lines_lo")}
    )


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    from neat_tpu_torch.data.synthetic import generate_scene

    root = str(tmp_path_factory.mktemp("finalize"))
    generate_scene(osp.join(root, "toy"), n_views=N_VIEWS, res=RES, seed=0)
    return root


@pytest.fixture(scope="module")
def f64_run(scene_root):
    """Both packages' distillation in f64: (cfg_j, params, cfg_t, model,
    scene_j, scene_t, distilled_j, distilled_t)."""
    cfg_j, cfg_t = configs()
    scene_j, scene_t = (_f64_scene(s) for s in disk_scenes(scene_root, "toy", RES))
    kw = dict(chunksize=CHUNK, line_dis_threshold=PERMISSIVE, junc_match_threshold=PERMISSIVE, verbose=False)
    params = spread_attraction(jneat.init_neat(jax.random.PRNGKey(0), cfg_j))  # f32 weights, drawn outside x64
    model = port_model(params, cfg_t, torch.float64)
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), params)
        dj = jfin.distill_views(params, cfg_j, scene_j, **kw)
    dt = tfin.distill_views(model, cfg_t, scene_t, **kw)
    return cfg_j, params, cfg_t, model, scene_j, scene_t, dj, dt


def _close(a, b, tol, key):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (key, a.shape, b.shape)
    if a.size:
        assert np.abs(a.astype(np.float64) - b).max() <= tol, (key, np.abs(a.astype(np.float64) - b).max())


def test_newton_refine_junctions_matches_jax(f64_run):
    cfg_j, params, cfg_t, model, *_ = f64_run
    with jax.enable_x64(True):
        pj, vj = jfin.newton_refine_junctions(params, cfg_j, sdf_threshold=0.3)
    pt, vt = tfin.newton_refine_junctions(model, cfg_t, sdf_threshold=0.3)
    _close(pt, pj, F64_TOL, "junctions")
    np.testing.assert_array_equal(vt, vj)


def test_view_field_lines_matches_jax(f64_run):
    cfg_j, params, cfg_t, model, scene_j, scene_t, *_ = f64_run
    with jax.enable_x64(True):
        want = jfin.view_field_lines(params, cfg_j, scene_j, 1, chunksize=CHUNK)
    got = tfin.view_field_lines(model, cfg_t, scene_t, 1, chunksize=CHUNK)
    assert want[0].shape[0] > CHUNK  # more than one chunk, the last one padded
    for key, a, b in zip(("lines3d", "lines2d", "l3d"), got, want):
        _close(a, b, F64_TOL * max(1.0, np.abs(b).max()), key)
    np.testing.assert_array_equal(got[3], want[3])


def test_distill_views_matches_jax(f64_run):
    *_, dj, dt = f64_run
    assert set(dt) == set(dj)
    assert dj["lines3d_raw"].shape[0] > 0 and dj["votes_idx"].size > 0
    np.testing.assert_array_equal(dt["votes_idx"], dj["votes_idx"])
    for key in ("global_junctions", "lines3d_raw", "scores_raw", "votes_pts"):
        _close(dt[key], dj[key], F64_TOL, key)


@pytest.mark.parametrize("knobs", list(ASSEMBLY), ids=list(ASSEMBLY))
def test_assemble_and_visibility_match_jax(f64_run, knobs):
    cfg_j, params, cfg_t, model, scene_j, scene_t, dj, dt = f64_run
    kw = dict(line_score_threshold=PERMISSIVE, **ASSEMBLY[knobs])
    with jax.enable_x64(True):
        rj = jfin.assemble_wireframe(dj, params, cfg_j, **kw)
        checked_j = [jfin.visibility_checking(rj["lines3d_wfi"], scene_j, mindis_th=m, min_visible_views=v)
                     for m, v in ((PERMISSIVE, 1), (400.0, 2))]
    rt = tfin.assemble_wireframe(dt, model, cfg_t, **kw)
    checked_t = [tfin.visibility_checking(rt["lines3d_wfi"], scene_t, mindis_th=m, min_visible_views=v)
                 for m, v in ((PERMISSIVE, 1), (400.0, 2))]
    assert set(rt) == set(rj)
    assert rj["lines3d_wfi"].shape[0] > 0, "the permissive gates must leave graph edges"
    np.testing.assert_array_equal(rt["graph_initial"], rj["graph_initial"])
    np.testing.assert_array_equal(rt["junction_votes"], rj["junction_votes"])
    for key in ("junctions3d_initial", "lines3d_all", "lines3d_wfi", "global_junctions"):
        _close(rt[key], rj[key], F64_TOL, key)
    for a, b in zip(checked_t, checked_j):
        _close(a, b, F64_TOL, "lines3d_wfi_checked")


def test_graph_helpers_match_jax():
    rs = np.random.RandomState(3)
    lines = rs.rand(40, 2, 3).astype(np.float32)
    junctions = rs.rand(12, 3).astype(np.float32)
    for kw in (dict(), dict(rel_matching_distance_threshold=0.3, edge_vote_threshold=2),
               dict(drop_self_edges=False)):
        for a, b in zip(tfin.wireframe_from_lines_and_junctions(lines, junctions, **kw),
                        jfin.wireframe_from_lines_and_junctions(lines, junctions, **kw)):
            np.testing.assert_array_equal(a, b)
    votes = rs.randint(1, 9, 12).astype(np.int32)
    for mode in ("mean", "max"):
        for a, b in zip(tfin.merge_voted_junctions(junctions, votes, 0.3, mode),
                        jfin.merge_voted_junctions(junctions, votes, 0.3, mode)):
            np.testing.assert_array_equal(a, b)
    for args in ((1, 0.0, 8), (1, 0.2, 8), (3, 0.1, 100)):
        assert tfin.effective_vote_threshold(*args) == jfin.effective_vote_threshold(*args)
        assert tfin.effective_check_views(*args) == jfin.effective_check_views(*args)
    assert tfin.CALIBRATED_RECIPE == jfin.CALIBRATED_RECIPE


@pytest.mark.parametrize("knobs", [
    {"conf": "/a/runconf.conf", "checkpoint": "latest", "epoch": 3, "distance": 10.0, "sdf_junction_refine": True},
    {"vote_threshold": 2, "junction_merge_eps": 0.02, "merge_before_vote": True, "ckdist": 100.0, "ckview": 5},
    {"nested": [1, 2.5, ("x", None)], "set": {3, 1, 2}, "d": {"b": 1, "a": -0.0}},
])
def test_make_hash_sha256_matches_jax(knobs):
    assert tfin.make_hash_sha256(knobs) == jfin.make_hash_sha256(knobs)


# the narrow model as a conf: 9-layer skip-4 SDF, 5-layer idr heads
CONF = """
train {
    expname = fin
    dataset_class = datasets.blender_hawp_dataset.BlenderDataset
    model_class = model.networks.neat_wfr_rend_a.VolSDFNetwork
    loss_class = model.networks.loss_wfr.VolSDFLoss
    num_pixels = 64
}
dataset {
    data_dir = toy
    img_res = [48, 48]
}
model {
    feature_vector_size = 32
    scene_bounding_sphere = 3.0
    dbscan_enabled = False
    use_median = True
    global_junctions {
        num_junctions = 16
        num_layers = 2
        dim_out = 3
        dim_hidden = 32
    }
    implicit_network {
        d_in = 3
        d_out = 1
        dims = [64, 64, 64, 64, 64, 64, 64, 64]
        geometric_init = True
        bias = 0.6
        skip_in = [4]
        weight_norm = True
        multires = 6
        sphere_scale = 20.0
    }
    attraction_network {
        d_in = 9
        d_out = 6
        dims = [64, 64, 64, 64]
        mode = idr
        weight_norm = True
    }
    rendering_network {
        mode = idr
        d_in = 9
        d_out = 3
        dims = [64, 64, 64, 64]
        weight_norm = True
        multires_view = 4
    }
    density {
        params_init { beta = 0.1 }
        beta_min = 0.0001
    }
    ray_sampler {
        near = 0.0
        N_samples = 16
        N_samples_eval = 32
        N_samples_extra = 8
        eps = 0.1
        beta_iters = 10
        max_total_iters = 3
    }
}
"""
CLI = ["--reproj-dis", "1e8", "--junc_match_threshold", "1e8", "--ckdist", "1e8", "--ckview", "1", "--chunksize", "256"]


def _rundir(tmp_path):
    rundir = tmp_path / "exps" / "fin" / "2026_01_01_00_00_00"
    (rundir / "checkpoints").mkdir(parents=True)
    (rundir / "runconf.conf").write_text(CONF)
    return str(rundir)


def _outputs(rundir):
    """{file name: its arrays / the pickle} of a rundir's wireframes/."""
    out = {}
    wdir = osp.join(rundir, "wireframes")
    for name in sorted(os.listdir(wdir)):
        path = osp.join(wdir, name)
        if name.endswith(".npz"):
            with np.load(path) as z:
                out[name] = {k: z[k] for k in z.files}
        else:
            with open(path, "rb") as f:
                out[name] = pickle.load(f)
    return out


def _numpy_only(obj):
    if isinstance(obj, dict):
        return all(isinstance(k, str) and _numpy_only(v) for k, v in obj.items())
    return obj is None or isinstance(obj, (np.ndarray, str, bool, int, float))


def test_wireframe_recon_cli_matches_jax(scene_root, tmp_path):
    """Both packages' CLIs on one rundir (so the conf path in the hash is
    the same), the reference recipe then the calibrated one, which reuses
    the distillation cache; JAX first with its checkpoint, then the port
    with its own checkpoint of the same weights."""
    import neat_tpu.train.checkpoint as jckpt
    import neat_tpu.train.step as jstep
    from neat_tpu.evaluation.eval_abc import eval_abc as jeval_abc
    from neat_tpu.train.config import load_experiment_config as jload
    from neat_tpu_torch.evaluation.eval_abc import eval_abc as teval_abc
    from neat_tpu_torch.train.checkpoint import save_checkpoint
    from neat_tpu_torch.train.config import load_experiment_config as tload
    from neat_tpu_torch.train.step import init_train_state

    rundir = _rundir(tmp_path)
    conf = osp.join(rundir, "runconf.conf")
    ckpt = osp.join(rundir, "checkpoints")
    cfg_j, cfg_t = jload(conf).model, tload(conf).model
    params = spread_attraction(jneat.init_neat(jax.random.PRNGKey(1), cfg_j))
    base = CLI + ["--conf", conf, "--data_root", scene_root]

    jckpt.save_checkpoint(ckpt, jstep.init_train_state(params, 5e-4, 0.1, 100), 3)
    with jax_numpy_encodels():
        for recipe in ("reference", "calibrated"):
            jfin.main(base + ["--recipe", recipe])
    want = _outputs(rundir)

    for name in os.listdir(ckpt):
        if name.endswith(".ckpt"):
            os.remove(osp.join(ckpt, name))
    os.rename(osp.join(rundir, "wireframes"), osp.join(rundir, "wireframes_jax"))
    save_checkpoint(ckpt, init_train_state(port_model(params, cfg_t)), 3)
    for recipe in ("reference", "calibrated"):
        tfin.main(base + ["--recipe", recipe, "--device", "cpu"])
    got = _outputs(rundir)

    assert sorted(got) == sorted(want)
    assert sum(name.endswith("-distill.pkl") for name in got) == 1
    assert sum(name.endswith("-neat.pkl") for name in got) == 2
    for name in want:
        a, b = got[name], want[name]
        if name.endswith(".pkl"):
            assert _numpy_only(a) and _numpy_only(b), name
        assert set(a) == set(b), name
        for k in b:
            if k == "kwargs":
                assert a[k] == b[k]
            elif k in ("votes_idx", "graph_initial", "junction_votes"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")
            else:
                tol = SCORE_TOL if k == "scores_raw" else F32_TOL
                _close(a[k], b[k], tol * max(1.0, float(np.abs(b[k]).max(initial=0.0))), f"{name}:{k}")
        if name.endswith("-neat.pkl"):
            assert b["junctions3d_initial"].shape[0] > 0
            scan = osp.join(scene_root, "toy")
            pj, pt = osp.join(rundir, "wireframes_jax", name), osp.join(rundir, "wireframes", name)
            assert teval_abc(pj, scan, verbose=False) == jeval_abc(pt, scan, verbose=False)


def test_mesh_flag_and_missing_card_raise(tmp_path):
    # a mesh of more GPUs than are visible is refused before anything loads
    visible = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested a {visible + 1}-device mesh but only {visible} devices"):
        tfin.main(["--conf", "x/runconf.conf", "--mesh", str(visible + 1)])
    if not torch.cuda.is_available():
        rundir = _rundir(tmp_path)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfin.wireframe_recon(osp.join(rundir, "runconf.conf"))
