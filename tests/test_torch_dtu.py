"""The port's DTU path (neat_tpu_torch) against neat_tpu's.

DBSCAN junction proposals: the same points through both packages, ``valid``
equal and the means within 1e-6 (the sums are taken in another order), and
against sklearn's DBSCAN where it is installed. The inputs keep every pair
of points either at distance 0 or more than a relative 1e-4 away from eps,
so that no f32 rounding can put a pair on the other side of the threshold.

The DTU loader, the camera decomposition and the COLMAP depth files: bit
for bit. The depth terms of the loss: within 1e-6.

Training steps of the DBSCAN configurations (NeatConfig.for_dtu and the
abc-1776 conf's translation, both at narrow widths): the JAX step is
neat_forward with injected noise, neat_loss and the package's own optax
Adam, the port's is make_train_step handed the same batch and noise. The
batch draws its 12 pixels from 5 support pixels with the same noise for the
same pixel, so rays repeat exactly and DBSCAN finds clusters across rays
as well as within them. Tolerances are tests/test_torch_step.py's: losses
to 1e-4 relative, every parameter entry to 1e-5. Both packages run these
steps in f64 (``jax.enable_x64``, the port's model and batch in f64): on
this batch some 250 entries of implicit.lin6.v have a gradient below 1e-7,
near Adam's eps of 1e-8, where a first update moves by 1e4 times the
gradient's difference, so f32 noise of 1e-9 in such an entry already moves
it by 1e-5 (in f64 the worst update differs by 3e-14).
"""

import dataclasses
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import neat_tpu.assignment.clustering as jclust
import neat_tpu.colmap_tools.depth as jdepth
import neat_tpu.core.camera as jcam
import neat_tpu.data.datasets as jdata
import neat_tpu.data.encodels as jenc
import neat_tpu.model.loss as jloss
import neat_tpu.model.neat as jneat
import neat_tpu.train.config as jconf
import neat_tpu.train.step as jstep
import neat_tpu_torch.assignment.clustering as tclust
import neat_tpu_torch.colmap_tools.depth as tdepth
import neat_tpu_torch.core.camera as tcam
import neat_tpu_torch.data.datasets as tdata
import neat_tpu_torch.data.synthetic as tsyn
import neat_tpu_torch.model.loss as tloss
import neat_tpu_torch.model.neat as tneat
import neat_tpu_torch.train.config as tconf
import neat_tpu_torch.train.step as tstep
from _torch_helpers import n, one_thread, port_model, small_scene, t, to_numpy
from neat_tpu_torch.interop import params_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
EPS = 0.01


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# DBSCAN
# ---------------------------------------------------------------------------


def _clumps(rs, n_clumps, size_lo, size_hi, spread=0.002):
    """Clumps of points within ``spread`` of a centre, centres far apart,
    some points repeated exactly (rays through one pixel)."""
    centres = rs.uniform(-1.5, 1.5, (n_clumps, 3))
    pts = []
    for c in centres:
        k = rs.randint(size_lo, size_hi + 1)
        p = c + rs.uniform(-spread, spread, (k, 3))
        p[rs.rand(k) < 0.3] = p[0]
        pts.append(p)
    return np.concatenate(pts)


def _noise(rs, k):
    return rs.uniform(-3.0, 3.0, (k, 3))


def _chain(k, start=(2.5, -2.5, -2.5), step=0.009):
    """An eps-chain of k links in index order, as tests/test_sampling.py's:
    a diameter past the 64-iteration cap that pointer jumping collapses in
    about log2(k) iterations. (In a random index order it does not: min
    labels then reach a link's label pointer no faster than its
    neighbours, and the chain splits at the cap in JAX as here.)"""
    p = np.zeros((k, 3)) + np.asarray(start)
    p[:, 0] += np.arange(k) * step
    return p


def _dbscan_input(kind):
    """Clumps and noise in a random order, a chain's links in index order
    in the middle."""
    rs = np.random.RandomState({"clumps": 0, "noise": 1, "chain": 2, "mixed": 3}[kind])
    chain = np.zeros((0, 3))
    if kind == "clumps":
        pts = _clumps(rs, 40, 2, 9)
    elif kind == "noise":
        pts = np.concatenate([_noise(rs, 60), _clumps(rs, 3, 2, 3)])
    elif kind == "chain":
        pts, chain = _noise(rs, 10), _chain(150)
    else:  # the step's 2048 endpoints: clumps, noise and a long chain
        pts, chain = _clumps(rs, 150, 2, 10), _chain(130)
        pts = np.concatenate([pts, _noise(rs, 2048 - len(pts) - len(chain))])
    pts = pts[rs.permutation(len(pts))]
    pts = np.concatenate([pts[: len(pts) // 2], chain, pts[len(pts) // 2:]]).astype(np.float32)
    d = np.sqrt(((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1))
    near = (d > 0) & (np.abs(d - EPS) < 1e-4 * EPS)
    assert not near.any(), "a pair of points sits on the eps threshold"
    return pts


@pytest.mark.parametrize("kind", ["clumps", "noise", "chain", "mixed"])
def test_dbscan_matches_jax(kind):
    pts = _dbscan_input(kind)
    m_j, v_j = jclust.dbscan_cluster_means(jnp.asarray(pts), eps=EPS, min_samples=2)
    tclust.dbscan_cluster_means.iterations = tclust.dbscan_cluster_means.syncs = 0
    m_t, v_t = tclust.dbscan_cluster_means(torch.from_numpy(pts), eps=EPS, min_samples=2)
    v_j, v_t = np.asarray(v_j), n(v_t)
    assert v_j.sum() > 0 and np.array_equal(v_t, v_j)
    np.testing.assert_allclose(n(m_t)[v_t], np.asarray(m_j)[v_j], rtol=0, atol=1e-6)
    if kind in ("chain", "mixed"):
        # one cluster for the whole chain, in fewer iterations than links
        assert tclust.dbscan_cluster_means.iterations < 64
    assert tclust.dbscan_cluster_means.syncs * tclust.CHECK_EVERY >= tclust.dbscan_cluster_means.iterations


@pytest.mark.parametrize("check_every", [1, 3, 64])
def test_dbscan_checks_do_not_change_labels(check_every):
    """The host check's period moves where the loop stops, not its labels;
    the iteration cap holds whatever the period: a chain cut off after 2
    iterations (its row 0 the mean of its first 4 links alone) comes out
    as JAX's does."""
    pts = torch.from_numpy(_dbscan_input("mixed"))
    m_ref, v_ref = tclust.dbscan_cluster_means(pts)
    tclust.dbscan_cluster_means.iterations = 0
    m, v = tclust.dbscan_cluster_means(pts, check_every=check_every)
    assert torch.equal(v, v_ref) and torch.equal(m, m_ref)
    assert tclust.dbscan_cluster_means.iterations <= 64
    chain = _chain(300).astype(np.float32)
    m_j, v_j = jclust.dbscan_cluster_means(jnp.asarray(chain), max_prop_iters=2)
    tclust.dbscan_cluster_means.iterations = 0
    m_t, v_t = tclust.dbscan_cluster_means(torch.from_numpy(chain), max_prop_iters=2, check_every=check_every)
    assert tclust.dbscan_cluster_means.iterations == 2
    assert np.array_equal(n(v_t), np.asarray(v_j))
    np.testing.assert_allclose(n(m_t)[0], chain[:4].mean(0), atol=1e-6)
    np.testing.assert_allclose(n(m_t)[n(v_t)], np.asarray(m_j)[np.asarray(v_j)], atol=1e-6)


def test_dbscan_matches_sklearn():
    sk = pytest.importorskip("sklearn.cluster")
    pts = _dbscan_input("mixed")
    means, valid = tclust.dbscan_cluster_means(torch.from_numpy(pts), eps=EPS, min_samples=2)
    labels = sk.DBSCAN(eps=EPS, min_samples=2).fit(pts).labels_
    reps = sorted(int(np.flatnonzero(labels == lab).min()) for lab in range(labels.max() + 1))
    assert np.flatnonzero(n(valid)).tolist() == reps
    for lab in range(labels.max() + 1):
        members = np.flatnonzero(labels == lab)
        np.testing.assert_allclose(n(means)[members.min()], pts[members].mean(0), atol=1e-6)


def test_dbscan_point_mask():
    pts = _dbscan_input("clumps")
    mask = np.random.RandomState(5).rand(len(pts)) < 0.7
    m_j, v_j = jclust.dbscan_cluster_means(jnp.asarray(pts), jnp.asarray(mask))
    m_t, v_t = tclust.dbscan_cluster_means(torch.from_numpy(pts), torch.from_numpy(mask))
    assert np.array_equal(n(v_t), np.asarray(v_j))
    np.testing.assert_allclose(n(m_t)[n(v_t)], np.asarray(m_j)[np.asarray(v_j)], atol=1e-6)


# ---------------------------------------------------------------------------
# cameras, depth files, nearest resize
# ---------------------------------------------------------------------------


def _random_p(rs):
    k = np.eye(3)
    k[0, 0], k[1, 1] = rs.uniform(200, 3000, 2)
    k[0, 1] = rs.uniform(-5, 5)
    k[:2, 2] = rs.uniform(100, 1600, 2)
    q, _ = np.linalg.qr(rs.randn(3, 3))
    r = q * np.sign(np.linalg.det(q))
    p = k @ np.concatenate([r, rs.randn(3, 1) * 3], axis=1)
    # P is known up to a scale: negative ones take the sign-fix paths
    return p * rs.choice([-1, 1]) * rs.uniform(0.01, 100)


@pytest.mark.parametrize("seed", range(6))
def test_load_k_rt_from_p_bit_equal(seed):
    p = _random_p(np.random.RandomState(seed))
    for a, b in zip(tcam.load_k_rt_from_p(p), jcam.load_k_rt_from_p(p)):
        assert _bits_equal(a, b)
    intr, pose = tcam.load_k_rt_from_p(p)
    # K [R | t] reproduces P up to its scale
    w2c = np.linalg.inv(pose.astype(np.float64))
    rebuilt = intr[:3, :3].astype(np.float64) @ w2c[:3]
    np.testing.assert_allclose(rebuilt / rebuilt[2, 3], p / p[2, 3], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "src_h,src_w,h,w,rows,cols",
    [
        (2, 4, 4, 8, [0, 0, 1, 1], [0, 0, 1, 1, 2, 2, 3, 3]),  # upsample by 2
        (4, 6, 2, 3, [0, 2], [0, 2, 4]),  # downsample by 2
        (3, 7, 5, 5, [0, 0, 1, 1, 2], [0, 1, 2, 4, 5]),
        # H = 6 to h = 34: row 17 reads 17 * (1 / (34 / 6)) = 2.99999..., row 2
        (6, 1, 34, 1, [0] * 6 + [1] * 6 + [2] * 6 + [3] * 5 + [4] * 6 + [5] * 5, [0]),
    ],
)
def test_resize_nearest_hand_computed(src_h, src_w, h, w, rows, cols):
    img = np.arange(src_h * src_w, dtype=np.float32).reshape(src_h, src_w)
    got = tdata.resize_nearest(img, h, w)
    assert np.array_equal(got, img[np.asarray(rows)[:, None], np.asarray(cols)[None, :]])
    if src_h == 6:
        assert rows[17] == 2
    cv2 = pytest.importorskip("cv2")
    assert np.array_equal(got, cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST).reshape(h, w))


def test_colmap_array_round_trip(tmp_path):
    rs = np.random.RandomState(0)
    for shape in ((7, 5), (4, 6, 3)):
        a = rs.rand(*shape).astype(np.float32)
        tdepth.write_array(str(tmp_path / "t.bin"), a)
        jdepth.write_array(str(tmp_path / "j.bin"), a)
        assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
        assert _bits_equal(tdepth.read_array(str(tmp_path / "t.bin")), a)
        assert _bits_equal(tdepth.read_array(str(tmp_path / "j.bin")), jdepth.read_array(str(tmp_path / "j.bin")))


# ---------------------------------------------------------------------------
# the DTU loader
# ---------------------------------------------------------------------------

SCALE = np.asarray([[120.0, 0, 0, 5.0], [0, 120.0, 0, -7.0], [0, 0, 120.0, 600.0], [0, 0, 0, 1]])
RES = 48
TINY = """
model { dbscan_enabled = True }
dataset {
    data_dir = DTU
    img_res = [48, 48]
    scan_id = 65
    DEPTH
}
train { dataset_class = DATASET }
"""


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtu")
    scan = root / "DTU" / "scan65"
    tsyn.generate_scene(str(scan), n_views=5, res=(RES, RES), convention="dtu", geometry="stacked",
                        scale_mat=SCALE, depth_dir="depth")
    # a view with no wireframe file is dropped
    (scan / "hawp" / "image_0003.json").unlink()
    # cues at other sizes and in COLMAP's format, resized by the loader
    rs = np.random.RandomState(0)
    mixed = scan / "depth_mixed"
    mixed.mkdir()
    for i, shape in ((0, (24, 32)), (1, (60, 40)), (2, (RES, RES)), (4, (13, 17))):
        cue = rs.rand(*shape).astype(np.float32) * (rs.rand(*shape) > 0.3)
        if i == 4:
            tdepth.write_array(str(mixed / f"image_{i:04d}.png.geometric.bin"), cue)
        else:
            np.save(mixed / f"image_{i:04d}.npy", cue)
    return root


@pytest.mark.parametrize(
    "dataset,depth",
    [("datasets.scene_hawp_dataset.SceneDataset", None),
     ("datasets.scene_hawp_dataset.SceneDataset", "depth"),
     ("datasets.scene_hawp_dataset.SceneDataset", "depth_mixed"),
     ("datasets.scene_dataset.SceneDataset", None)],
    ids=["dtu", "dtu_depth", "dtu_depth_resized", "dtu_plain"],
)
def test_dtu_scene_bit_equal_to_jax(dtu_root, dataset, depth, monkeypatch):
    text = TINY.replace("DATASET", dataset).replace("DEPTH", f"depth_dir = {depth}" if depth else "")
    conf = jconf.parse_hocon(text)
    cfg_j = jconf.build_experiment_config(conf, max_verts=64)
    cfg_t = tconf.build_experiment_config(conf, max_verts=64)
    monkeypatch.setattr(jenc, "_build_native", lambda: None)  # JAX's auto backend -> its numpy version
    ref = jdata.load_scene_for_config(cfg_j, str(dtu_root))
    got = tdata.load_scene_for_config(cfg_t, str(dtu_root))
    for name in ref.__dataclass_fields__:
        a, b = getattr(ref, name), getattr(got, name)
        if a is None or isinstance(a, tuple):
            assert a == b, name
        else:
            assert _bits_equal(a, b), name
    assert _bits_equal(got.scale_mat, SCALE.astype(np.float32))
    if dataset.endswith("scene_hawp_dataset.SceneDataset"):
        assert got.view_ids.tolist() == [0, 1, 2, 4]
        assert (got.depth is not None) == (depth is not None)
    if depth == "depth":
        # the cues are ray distances: where the surface was hit, positive
        assert (got.depth > 0).any() and (got.depth >= 0).all()


def test_dtu_cameras_match_the_generator(dtu_root):
    """P = world_mat @ scale_mat decomposes into the cameras the scene was
    rendered with: intrinsics and cam2world in the normalized frame."""
    scene = tdata.load_dtu_scene("DTU", (RES, RES), scan_id=65, data_root=str(dtu_root), with_wireframes=False)
    cams = np.load(dtu_root / "DTU" / "scan65" / "cameras.npz")
    for v in range(scene.n_images):
        p = (cams[f"world_mat_{v}"] @ cams[f"scale_mat_{v}"])[:3]
        w2c = np.linalg.inv(scene.pose[v].astype(np.float64))
        np.testing.assert_allclose(scene.intrinsics[v][:3, :3] @ w2c[:3], p, rtol=1e-5, atol=1e-4)


def test_sample_batch_carries_depth(dtu_root):
    scene = tdata.load_dtu_scene("DTU", (RES, RES), scan_id=65, data_root=str(dtu_root), depth_dir="depth")
    dev = tstep.scene_to_device(scene, "cpu")
    assert set(dev) == set(tstep.SCENE_KEYS) | {"depth"}
    gen = torch.Generator().manual_seed(0)
    inputs, gt = tstep.sample_batch(gen, dev, 64, RES)
    pix = (inputs["uv"][:, 1] * RES + inputs["uv"][:, 0]).long()
    views = [v for v in range(scene.n_images) if torch.equal(gt["rgb"], dev["rgb"][v, pix])]
    assert len(views) >= 1 and torch.equal(gt["depth"], dev["depth"][views[0], pix])
    scene.depth = None
    assert "depth" not in tstep.sample_batch(gen, tstep.scene_to_device(scene, "cpu"), 8, RES)[1]


# ---------------------------------------------------------------------------
# the depth terms of the loss
# ---------------------------------------------------------------------------


def _loss_inputs(n_rays, seed=0):
    rs = np.random.RandomState(seed)
    out = {
        "rgb_values": rs.rand(n_rays, 3).astype(np.float32),
        "depth": rs.uniform(0.5, 3.0, n_rays).astype(np.float32),
    }
    depth = (rs.uniform(0.5, 3.0, n_rays) * (rs.rand(n_rays) > 0.25)).astype(np.float32)
    gt = {"rgb": rs.rand(n_rays, 3).astype(np.float32), "depth": depth}
    return out, gt


@pytest.mark.parametrize("kind,mask_zeros,n_rays", [("l1", False, 64), ("ssi", False, 64), ("ssi", True, 64),
                                                     ("ssi", False, 50), ("ssi", True, 50)])
def test_depth_terms_match_jax(kind, mask_zeros, n_rays):
    """The L1 term over the pixels with a cue, the SSI term over all pixels
    or those with a cue, on a square batch and on a row."""
    out, gt = _loss_inputs(n_rays)
    kw = dict(depth_weight=0.1, depth_loss_kind=kind, depth_mask_zeros=mask_zeros)
    ref = jloss.neat_loss({k: jnp.asarray(v) for k, v in out.items()}, {k: jnp.asarray(v) for k, v in gt.items()},
                          jloss.LossConfig(**kw))
    got = tloss.neat_loss({k: t(v) for k, v in out.items()}, {k: t(v) for k, v in gt.items()}, tloss.LossConfig(**kw))
    for key in ("depth_loss", "loss"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=0, atol=1e-6, err_msg=key)
    assert float(got["depth_loss"]) > 0
    # no cue at all: the L1 term is 0, the loss without it
    gt0 = dict(gt, depth=np.zeros_like(gt["depth"]))
    got0 = tloss.neat_loss({k: t(v) for k, v in out.items()}, {k: t(v) for k, v in gt0.items()},
                           tloss.LossConfig(**kw))
    if kind == "l1":
        assert float(got0["depth_loss"]) == 0.0


# ---------------------------------------------------------------------------
# training steps with DBSCAN proposals
# ---------------------------------------------------------------------------

LR, DECAY, DECAY_STEPS = 5e-4, 0.1, 1000
N_RAYS, SRES, N_SUPPORT = 12, 32, 5
NARROW_NETS = dict(feature_vector_size=32, implicit=dict(dims=(64,) * 8, feature_vector_size=32),
                   rendering=dict(dims=(64,) * 4, feature_vector_size=32),
                   attraction=dict(dims=(64,) * 4, feature_vector_size=32), junctions=dict(dim_hidden=32),
                   sampler=dict(n_samples=16, n_samples_eval=32, n_samples_extra=8, max_total_iters=2, beta_iters=4))


def _narrow(cfg):
    """A full-width NeatConfig at the narrow widths of the parity tests and
    a sampler of 2 rounds of 4 bisection steps (JAX's compile of the step
    grows with both), everything else (bias, sphere_scale, junction count,
    gates) kept."""
    kw = {k: (dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict) else v) for k, v in NARROW_NETS.items()}
    return dataclasses.replace(cfg, **kw, max_verts=16, sampler_compute_dtype="float32",
                               field_compute_dtype="float32")


def _dbscan_configs(which):
    if which == "for_dtu":
        return _narrow(jneat.NeatConfig.for_dtu()), _narrow(tneat.NeatConfig.for_dtu())
    conf = jconf.parse_hocon(open(osp.join(REPO, "confs", "abc", "abc-1776.conf")).read())
    return (_narrow(jconf.build_experiment_config(conf).model), _narrow(tconf.build_experiment_config(conf).model))


def _batch_and_noise(scene, cfg_t, step):
    """Rays through N_SUPPORT pixels of one view, each pixel's rays with one
    row of noise, so that they repeat exactly."""
    rs = np.random.RandomState(100 + step)
    v = step % scene["rgb"].shape[0]
    support = rs.choice(SRES * SRES, N_SUPPORT, replace=False)
    which = rs.randint(0, N_SUPPORT, N_RAYS)
    which[:N_SUPPORT] = np.arange(N_SUPPORT)
    pix = support[which]
    inputs = {"uv": np.stack([pix % SRES, pix // SRES], -1).astype(np.float32), "uv_proj": scene["uv_proj"][v, pix],
              "intrinsics": scene["intrinsics"][v], "pose": scene["pose"][v], "verts2d": scene["verts2d"][v],
              "verts_mask": scene["verts_mask"][v]}
    gt = {"rgb": scene["rgb"][v, pix], "lines2d": scene["lines"][v, scene["labels"][v, pix]]}
    per_pixel = {k: n(v) for k, v in tneat.draw_forward_noise(torch.Generator().manual_seed(step), N_SUPPORT, cfg_t,
                                                                 device="cpu").items()}
    noise = {k: (val if k == "z_extra_idx" else val[which]) for k, val in per_pixel.items()}
    noise["eik_uniform"] = rs.uniform(-3, 3, (N_RAYS, 3)).astype(np.float32)
    return inputs, gt, noise


@pytest.fixture(scope="module")
def dtu_init():
    """for_dtu's JAX weights (its init is the slow part of a fixture)."""
    cfg_j, _ = _dbscan_configs("for_dtu")
    return jneat.init_neat(jax.random.PRNGKey(4), cfg_j)


def _f64(tree):
    """float32 leaves of a numpy tree -> float64 jax arrays (call under
    enable_x64)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else np.asarray(a)), tree)


def _t64(a):
    return t(a).double() if np.asarray(a).dtype == np.float32 else t(a)


def _dbscan_steps(cfg_j, cfg_t, params, n_steps, loss_kw=None):
    """n_steps f64 training steps in both packages from ``params`` on
    _batch_and_noise's batches: (loss JAX, loss port, params JAX, params
    port) after each, and the valid DBSCAN proposals of each port step."""
    model = port_model(params, cfg_t).double()
    scene = small_scene(cfg_j, res=SRES)
    opt = jstep.make_optimizer(LR, DECAY, DECAY_STEPS)
    loss_cfg_j, loss_cfg_t = jloss.LossConfig(**(loss_kw or {})), tloss.LossConfig(**(loss_kw or {}))

    def loss_fn(p, inputs, gt, noise):
        out = jneat.neat_forward(p, inputs, cfg_j, jax.random.PRNGKey(0), training=True, noise=noise)
        losses = jloss.neat_loss(out, gt, loss_cfg_j)
        return losses["loss"], losses

    @jax.jit
    def step_j(p, opt_state, inputs, gt, noise):
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, inputs, gt, noise)
        updates, opt_state = opt.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, losses

    state_t = tstep.init_train_state(model)
    step_t = tstep.make_train_step(cfg_t, loss_cfg_t, LR, DECAY, DECAY_STEPS, N_RAYS, SRES)
    seen = []
    orig = tneat.dbscan_cluster_means

    def recorded(*a, **k):
        means, valid = orig(*a, **k)
        seen.append(int(valid.sum()))
        return means, valid

    out = []
    tneat.dbscan_cluster_means = recorded
    try:
        with jax.enable_x64(True):
            p_j = _f64(to_numpy(params))
            opt_state = opt.init(p_j)
            for s in range(n_steps):
                inputs, gt, noise = _batch_and_noise(scene, cfg_t, s)
                p_j, opt_state, m_j = step_j(p_j, opt_state, _f64(inputs), _f64(gt), _f64(noise))
                batch = ({k: _t64(v) for k, v in inputs.items()}, {k: _t64(v) for k, v in gt.items()})
                state_t, m_t = step_t(state_t, None, batch=batch, noise={k: _t64(v) for k, v in noise.items()})
                out.append((float(m_j["loss"]), float(m_t["loss"]), params_from_jax(to_numpy(p_j)),
                            {k: v.detach().clone() for k, v in state_t.model.state_dict().items()}))
    finally:
        tneat.dbscan_cluster_means = orig
    return out, seen


def _dbscan_params(dtu_init, cfg_j):
    """for_dtu's weights with cfg_j's junction count of their latents: the
    abc-1776 conf differs from for_dtu in that count alone (64 of 1024)"""
    params = dict(dtu_init)
    params["junctions"] = dict(dtu_init["junctions"], latents=dtu_init["junctions"]["latents"][
        : cfg_j.junctions.num_junctions])
    return params


@pytest.fixture(scope="module", params=["for_dtu", "abc_1776"])
def dbscan_trajectory(request, dtu_init):
    cfg_j, cfg_t = _dbscan_configs(request.param)
    assert cfg_t.dbscan_enabled and not cfg_t.use_median
    tneat.check_ported(cfg_t)
    params = _dbscan_params(dtu_init, cfg_j)
    out, seen = _dbscan_steps(cfg_j, cfg_t, params, 3)
    return request.param, cfg_j, cfg_t, params, out, seen


def _worst_entries(p_t, p_j):
    assert set(p_t) == set(p_j)
    return {k: float(np.abs(n(p_t[k]) - p_j[k].numpy()).max()) for k in p_j}


def test_callback_train_step_matches_jax(dtu_init):
    """One f64 step of abc-1776's configuration with the ``callback``
    assignment in the model's junction match and in the loss (scipy's
    Hungarian on the host in both packages), at the tolerances above."""
    cfg_j, cfg_t = (dataclasses.replace(c, assignment_method="callback") for c in _dbscan_configs("abc_1776"))
    tneat.check_ported(cfg_t)
    [(loss_j, loss_t, p_j, p_t)], seen = _dbscan_steps(
        cfg_j, cfg_t, _dbscan_params(dtu_init, cfg_j), 1, loss_kw=dict(assignment_method="callback"))
    assert seen[0] > 0
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)
    bad = {k: v for k, v in _worst_entries(p_t, p_j).items() if v > 1e-5}
    assert not bad, f"parameters off after the callback step: {bad}"


@pytest.mark.parametrize("n_steps", [1, 3])
def test_dbscan_train_steps_match_jax(dbscan_trajectory, n_steps):
    which, _, _, _, traj, seen = dbscan_trajectory
    assert len(seen) == 3 and min(seen[:n_steps]) > 0, f"valid DBSCAN proposals per step {seen}"
    # rays through one pixel repeat: fewer clusters than endpoints
    assert max(seen) < 2 * N_RAYS
    for s in range(n_steps):
        loss_j, loss_t, _, _ = traj[s]
        np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4, err_msg=f"{which}: loss after step {s + 1}")
    _, _, p_j, p_t = traj[n_steps - 1]
    bad = {k: v for k, v in _worst_entries(p_t, p_j).items() if v > 1e-5}
    assert not bad, f"{which}: parameters off after {n_steps} steps: {bad}"


def test_params_from_jax_covers_the_dbscan_configs(dbscan_trajectory):
    """The weight bridge carries every leaf of the DBSCAN configurations:
    for_dtu's 1024 junction latents and its geometric init with bias 0.6
    (sphere_scale 20), and the abc-1776 conf's 64 latents."""
    which, cfg_j, cfg_t, params, _, _ = dbscan_trajectory
    state = params_from_jax(to_numpy(params))
    fresh = tneat.init_neat(cfg_t, device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(v.shape) for k, v in fresh.items()}
    n_lat = 1024 if which == "for_dtu" else cfg_t.junctions.num_junctions
    assert state["junctions.latents"].shape[0] == n_lat == cfg_j.junctions.num_junctions
    last = f"implicit.lin{len(cfg_t.implicit.layer_dims()) - 2}.b"
    assert float(state[last][0]) == float(fresh[last][0]) == np.float32(-cfg_t.implicit.bias)
    if which == "for_dtu":
        assert (cfg_t.implicit.bias, cfg_t.implicit.sphere_scale) == (0.6, 20.0)
