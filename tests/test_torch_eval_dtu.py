"""The port's DTU / BMVS / ScanNet evaluators and the ABC detectability
analysis against neat_tpu's, on the same files.

eval_dtu and eval_lsr are numpy and scipy in both packages: every number
within 1e-9 (f64). abc_analysis projects and ray-casts in torch on the CPU
here (JAX in f64 under ``jax.enable_x64``): hit counts equal, rates within
1e-9. The ground truth is what ``data.synthetic.write_dtu_groundtruth``
writes for a synthetic scene: surface samples of its geometry in a scaled
frame, an ObsMask grid and a ground plane.
"""

import os.path as osp

import jax
import numpy as np
import pytest

import neat_tpu.data.datasets as jdata
import neat_tpu.evaluation.abc_analysis as jabc
import neat_tpu.evaluation.eval_dtu as jdtu
import neat_tpu.evaluation.eval_lsr as jlsr
import neat_tpu_torch.data.synthetic as tsyn
import neat_tpu_torch.evaluation.abc_analysis as tabc
import neat_tpu_torch.evaluation.eval_dtu as tdtu
import neat_tpu_torch.evaluation.eval_lsr as tlsr
from neat_tpu_torch.viz.mesh import save_ply

SCAN = 65
SCALE = np.asarray([[12.0, 0, 0, 10.0], [0, 12.0, 0, -20.0], [0, 0, 12.0, 500.0], [0, 0, 0, 1]])
KEYS = ("accuracy_d2s", "completeness_s2d", "overall")


def _close(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-9, atol=1e-9, err_msg=k)


@pytest.fixture(scope="module")
def gt_dir(tmp_path_factory):
    """Ground truth in the scaled frame, a predicted mesh near it, a wireframe
    near the cuboid's edges (normalized frame) and the cameras.npz holding
    the scale."""
    d = tmp_path_factory.mktemp("dtu_eval")
    tsyn.write_dtu_groundtruth(str(d / "eval"), SCAN, SCALE, n_points=3000)
    rs = np.random.RandomState(0)
    verts, edges, faces, _ = tsyn.cuboid_wireframe()
    pred = verts * 1.02 + rs.normal(0, 0.005, verts.shape)
    save_ply(str(d / "mesh.ply"), pred @ SCALE[:3, :3].T + SCALE[:3, 3], faces)
    lines = verts[edges] + rs.normal(0, 0.01, (len(edges), 2, 3))
    lines = np.concatenate([lines, rs.uniform(-0.6, 0.6, (5, 2, 3))])  # some far from the surface
    np.savez(d / "wfi_checked.npz", lines3d=lines.astype(np.float32))
    np.savez(d / "cameras.npz", scale_mat_0=SCALE, world_mat_0=np.eye(4))
    # ScanNet layout: <dataset_dir>/<scan>/gt.obj
    (d / "scannet" / "0084_00").mkdir(parents=True)
    with open(d / "scannet" / "0084_00" / "gt.obj", "w") as f:
        for v in rs.uniform(0, 3, (400, 3)):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
    return d


@pytest.mark.parametrize("radius", [0.0, 0.2, 3.0])
def test_downsample_points_matches_jax(radius):
    pts = np.random.RandomState(1).uniform(0, 20, (500, 3))
    assert np.array_equal(tdtu.downsample_points(pts, radius), jdtu.downsample_points(pts, radius))


@pytest.mark.parametrize("grid_cast_f32", [False, True])
def test_eval_dtu_points_matches_jax(grid_cast_f32):
    rs = np.random.RandomState(2)
    stl = rs.uniform(0, 100, (800, 3))
    data = stl[:300] + rs.normal(0, 2, (300, 3))
    mask = rs.rand(14, 14, 14) > 0.2
    kw = dict(obs_mask=mask, bb=np.asarray([[-10.0, -10, -10], [120, 120, 120]]), res=10.0,
              ground_plane=np.asarray([0.0, 0, 1, -20]), grid_cast_f32=grid_cast_f32)
    _close(tdtu.eval_dtu_points(data, stl, **kw), jdtu.eval_dtu_points(data, stl, **kw))
    _close(tdtu.eval_dtu_points(data, stl), jdtu.eval_dtu_points(data, stl))


def test_eval_dtu_mesh_cli_matches_jax(gt_dir):
    ref = jdtu.eval_dtu_mesh(str(gt_dir / "mesh.ply"), str(gt_dir / "eval"), SCAN)
    got = tdtu.main(["--data", str(gt_dir / "mesh.ply"), "--scan", str(SCAN), "--dataset_dir", str(gt_dir / "eval")])
    _close(got, ref)
    assert 0 < got["accuracy_d2s"] < 20 and 0 < got["completeness_s2d"] < 20


@pytest.mark.parametrize("mode", ["junctions", "lines"])
@pytest.mark.parametrize("protocol", ["dtu", "bmvs"])
def test_eval_lsr_cli_matches_jax(gt_dir, mode, protocol):
    """The CLI against the JAX functions it calls, with the masks (dtu) and
    without them, all points scored (bmvs)."""
    from scipy.io import loadmat

    from neat_tpu.viz.mesh import load_ply

    data, ev = str(gt_dir / "wfi_checked.npz"), str(gt_dir / "eval")
    got = tlsr.main(["--mode", mode, "--protocol", protocol, "--data", data, "--scan", str(SCAN),
                     "--dataset_dir", ev, "--cameras", str(gt_dir / "cameras.npz")])
    stl = load_ply(f"{ev}/Points/stl/stl{SCAN:03}_total.ply")[0].astype(np.float64)
    kw = {"scale_mat": SCALE}
    if protocol == "dtu":
        mat = loadmat(f"{ev}/ObsMask/ObsMask{SCAN}_10.mat")
        kw.update(obs_mask=mat["ObsMask"], bb=mat["BB"], res=float(np.asarray(mat["Res"]).item()),
                  ground_plane=loadmat(f"{ev}/ObsMask/Plane{SCAN}.mat")["P"].reshape(-1))
    elif mode == "lines":
        kw["downsample_radius"] = 0.0
    fn = jlsr.eval_wfr_junctions if mode == "junctions" else jlsr.eval_lsr_lines
    _close(got, fn(data, stl, **kw))
    assert np.isfinite([got[k] for k in KEYS]).all()


def test_eval_lsr_scannet_matches_jax(gt_dir):
    data = str(gt_dir / "wfi_checked.npz")
    got = tlsr.main(["--protocol", "scannet", "--data", data, "--scan", "0084_00",
                     "--dataset_dir", str(gt_dir / "scannet")])
    scale, offset = jlsr.SCANNET_SCALE_OFFSET["0084_00"]
    gt = jlsr.load_obj_vertices(str(gt_dir / "scannet" / "0084_00" / "gt.obj"))
    _close(got, jlsr.eval_scannet_lines(data, gt, scale, offset))
    assert np.array_equal(tlsr.load_obj_vertices(str(gt_dir / "scannet" / "0084_00" / "gt.obj")), gt)


@pytest.mark.parametrize("voxel", [0.0, 0.02, 0.3])
def test_voxel_downsample_and_resample_match_jax(voxel):
    rs = np.random.RandomState(3)
    pts = rs.uniform(0, 1, (700, 3))
    assert np.array_equal(tlsr.voxel_downsample(pts, voxel), jlsr.voxel_downsample(pts, voxel))
    lines = rs.uniform(-1, 1, (9, 2, 3))
    assert np.array_equal(tlsr.resample_lines(lines, 32), jlsr.resample_lines(lines, 32))


# ---------------------------------------------------------------------------
# abc_analysis
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def abc_scan(tmp_path_factory):
    root = tmp_path_factory.mktemp("abc")
    scan = root / "abc" / "00000001"
    tsyn.generate_scene(str(scan), n_views=4, res=(64, 64), geometry="stacked")
    verts, _, faces, _ = tsyn.stacked_wireframe()
    with open(scan / "mesh.obj", "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
    return scan


@pytest.mark.parametrize("mesh", [False, True], ids=["frustum", "ray_cast"])
def test_abc_analysis_matches_jax(abc_scan, mesh):
    scene = jdata.load_blender_scene("abc/00000001", (64, 64), data_root=str(abc_scan.parent.parent),
                                     distance_threshold=1.0)
    mesh_path = str(abc_scan / "mesh.obj") if mesh else None
    with jax.enable_x64(True):
        ref = jabc.analyze_detectability(scene, str(abc_scan), mesh_path=mesh_path, verbose=False)
    got = tabc.analyze_detectability(scene, str(abc_scan), mesh_path=mesh_path, verbose=False, device="cpu")
    for k in ("junction_hits", "line_hits", "junctions_covered", "lines_covered"):
        assert np.array_equal(got[k], ref[k]), k
    for k in ("junction_hit_rate_per_view", "line_hit_rate_per_view", "junctions3d", "lines3d"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-9, atol=1e-9, err_msg=k)
    assert got["junctions_covered"] > 0


def test_ray_cast_first_hit_matches_jax():
    import torch

    rs = np.random.RandomState(4)
    verts, _, faces, _ = tsyn.stacked_wireframe()
    origins = rs.uniform(-2, 2, (300, 3))
    dirs = -origins + rs.normal(0, 0.2, (300, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ref = jabc.ray_cast_first_hit(origins, dirs, verts, faces, chunk=128)
    got = tabc.ray_cast_first_hit(*(torch.from_numpy(a) for a in (origins, dirs, verts, faces)), chunk=128)
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(ref)) and np.isfinite(ref).sum() > 100
    np.testing.assert_allclose(got.numpy()[np.isfinite(ref)], ref[np.isfinite(ref)], rtol=1e-9, atol=1e-9)


def test_abc_analysis_cli(abc_scan, tmp_path):
    out = str(tmp_path / "det.npz")
    res = tabc.main(["--scan", str(abc_scan), "--img-res", "64", "64", "--mesh", str(abc_scan / "mesh.obj"),
                     "--out", out, "--device", "cpu"])
    with np.load(out) as z:
        assert np.array_equal(z["junction_hits"], res["junction_hits"])
        assert np.array_equal(z["lines3d"], res["lines3d"])


# ---------------------------------------------------------------------------
# the DTU pipeline through the port's CLIs
# ---------------------------------------------------------------------------

TINY_DTU_CONF = """
train {
    expname = tiny_dtu
    dataset_class = datasets.scene_hawp_dataset.SceneDataset
    model_class = model.networks.neat_wfr_rend_a.VolSDFNetwork
    loss_class = model.networks.loss_wfr_rpd.VolSDFLoss
    num_pixels = 32
    checkpoint_freq = 1
}
plot { resolution = 32 }
dataset {
    data_dir = DTU
    img_res = [40, 48]
    scan_id = 65
    depth_dir = depth
}
model {
    feature_vector_size = 16
    scene_bounding_sphere = 3.0
    dbscan_enabled = True
    use_median = False
    global_junctions {
        num_junctions = 32
        dim_hidden = 16
    }
    implicit_network {
        dims = [32, 32, 32, 32]
        skip_in = [2]
        multires = 4
        bias = 0.6
        sphere_scale = 20.0
    }
    attraction_network {
        dims = [16, 16]
        d_out = 6
    }
    rendering_network {
        dims = [16, 16]
        multires_view = 2
    }
    ray_sampler {
        N_samples = 8
        N_samples_eval = 16
        N_samples_extra = 4
        beta_iters = 4
        max_total_iters = 2
    }
}
"""


def test_dtu_pipeline_through_the_clis(tmp_path):
    """scripts/eval-neat-dtu.sh's order through the port's CLIs on the CPU:
    a DTU-layout scene with a scale_mat and depth cues, the runner (DBSCAN
    proposals, the SSI depth term), finalize, eval_lsr in both modes,
    render eval (its mesh in the scaled frame) and eval_dtu on that mesh."""
    import glob

    import neat_tpu_torch.evaluation.render_eval as RE
    import neat_tpu_torch.wireframe.finalize as F
    from neat_tpu_torch.train import runner as R
    from neat_tpu_torch.viz.mesh import load_ply

    data, ev = tmp_path / "data", tmp_path / "eval"
    tsyn.generate_scene(str(data / "DTU" / "scan65"), n_views=3, res=(40, 48), convention="dtu",
                        scale_mat=SCALE, depth_dir="depth")
    tsyn.write_dtu_groundtruth(str(ev), SCAN, SCALE, n_points=2000)
    (tmp_path / "tiny.conf").write_text(TINY_DTU_CONF)
    r = R.main(["--conf", str(tmp_path / "tiny.conf"), "--data_root", str(data), "--exps_folder",
                str(tmp_path / "exps"), "--nepoch", "1", "--device", "cpu"])
    assert r.expname == "tiny_dtu/65" and r.cfg.loss.depth_loss_kind == "ssi"
    assert r.scene.depth is not None and "depth" in r.scene_dev
    conf = osp.join(r.rundir, "runconf.conf")
    F.main(["--conf", conf, "--data_root", str(data), "--ckview", "1", "--ckdist", "100", "--device", "cpu"])
    wfc = glob.glob(osp.join(r.rundir, "wireframes", "*-wfi_checked.npz"))
    assert len(wfc) == 1
    cams = str(data / "DTU" / "scan65" / "cameras.npz")
    for mode in ("junctions", "lines"):
        out = tlsr.main(["--mode", mode, "--data", wfc[0], "--scan", str(SCAN), "--dataset_dir", str(ev),
                         "--cameras", cams])
        assert set(KEYS) <= set(out)
    stats = RE.main(["--conf", conf, "--data_root", str(data), "--views", "0", "--resolution", "32",
                     "--device", "cpu"])
    verts, _ = load_ply(stats["mesh"])
    assert len(verts) and np.isfinite(verts).all() and np.isfinite(stats["psnr_mean"])
    # the mesh is in the scaled frame: its centre near the scale's offset
    assert np.abs(verts.mean(0) - SCALE[:3, 3]).max() < 3 * SCALE[0, 0]
    got = tdtu.main(["--data", stats["mesh"], "--scan", str(SCAN), "--dataset_dir", str(ev)])
    assert np.isfinite([got[k] for k in KEYS]).all()
