"""The port's ScanNet and scene_line loaders and the image formats of its
``_load_rgb`` against neat_tpu's, bit for bit.

ScanNet: a generated ScanNet-layout scene (pose/*.txt, a shared
intrinsic.txt, hawp/*.json) with a view that has no wireframe file, sparse
depth_colmap cues on some views (one above the 2 m clip), under each of
the three intrinsic file names the loaders look for, loaded through
``load_scene_for_config`` from a conf in both packages. scene_line: a
generated DTU-layout scene with depth cues from a ``lines3d`` npz of the
generator's own edges (a plain array and an object array), alone and over
file depth; ``attach_line_depth_cues`` on its own, and the conf's
scene_line branch (the whole image as support). JAX's loaders run on its
numpy encodels, which the port's native one equals.

Images: palette PNGs (1-, 2-, 4- and 8-bit indices, with and without
transparency) and uncompressed 24- and 32-bit BMPs (bottom-up and
top-down rows, the three info headers) as JAX's imageio reads them. An
.npy image raises in both packages; gray with alpha raises in the port,
where JAX returns 2 channels its loaders cannot pack; a baseline JPEG reads
as JAX's, a progressive one raises in the port, naming its ROADMAP item.
"""

import dataclasses
import json
import os
import shutil
import struct
import warnings

import numpy as np
import PIL.Image
import pytest

import neat_tpu.data.datasets as jdata
import neat_tpu.train.config as jconf
import neat_tpu_torch.data.datasets as tdata
import neat_tpu_torch.data.synthetic as tsyn
import neat_tpu_torch.train.config as tconf
from _torch_helpers import jax_numpy_encodels

RES = (40, 48)
CONF = """
dataset {
    data_dir = DATA_DIR
    img_res = [40, 48]
    EXTRA
}
train { dataset_class = DATASET }
"""
SCANNET = "datasets.scannet_hawp_dataset.SceneDataset"
SCENE_LINE = "datasets.scene_line_dataset.SceneDataset"


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _same_scene(ref, got):
    for name in ref.__dataclass_fields__:
        a, b = getattr(ref, name), getattr(got, name)
        if a is None or isinstance(a, tuple):
            assert a == b, name
        else:
            assert _bits_equal(a, b), name


def _both(text, data_root):
    conf = jconf.parse_hocon(text)
    cfg_j = jconf.build_experiment_config(conf, max_verts=32)
    cfg_t = tconf.build_experiment_config(conf, max_verts=32)
    with jax_numpy_encodels():
        ref = jdata.load_scene_for_config(cfg_j, str(data_root))
    return ref, tdata.load_scene_for_config(cfg_t, str(data_root)), cfg_t


# ---------------------------------------------------------------------------
# ScanNet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scannet_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet")
    scan = root / "scannet" / "scene0000_00"
    tsyn.generate_scene(str(scan), n_views=5, res=RES, convention="scannet", geometry="stacked")
    (scan / "hawp" / "image_0002.json").unlink()  # dropped
    rs = np.random.RandomState(0)
    cues = scan / "depth_colmap"
    cues.mkdir()
    for i in (0, 3):
        d = (rs.uniform(0.5, 3.0, RES) * (rs.rand(*RES) < 0.2)).astype(np.float32)  # some above 2 m
        np.save(cues / f"image_{i:04d}.npy", d)
    return root


@pytest.mark.parametrize("intrinsic", ["intrinsic.txt", "intrinsic/intrinsic_color.txt", "intrinsics.txt"])
@pytest.mark.parametrize("cues", [True, False])
def test_scannet_scene_bit_equal_to_jax(scannet_root, tmp_path, intrinsic, cues):
    root = tmp_path / "root"
    shutil.copytree(scannet_root, root)
    scan = root / "scannet" / "scene0000_00"
    if intrinsic != "intrinsic.txt":
        os.makedirs(os.path.dirname(scan / intrinsic), exist_ok=True)
        os.rename(scan / "intrinsic.txt", scan / intrinsic)
    if not cues:
        shutil.rmtree(scan / "depth_colmap")
    text = CONF.replace("DATA_DIR", "scannet").replace("EXTRA", "scan_id = scene0000_00").replace("DATASET", SCANNET)
    ref, got, cfg = _both(text, root)
    assert cfg.dataset_kind == "scannet" and cfg.scan_id == "scene0000_00"
    _same_scene(ref, got)
    assert got.view_ids.tolist() == [0, 1, 3, 4]
    assert _bits_equal(got.scale_mat, np.eye(4, dtype=np.float32))
    assert all(_bits_equal(k, got.intrinsics[0]) for k in got.intrinsics)
    if cues:
        raw = np.load(scan / "depth_colmap" / "image_0003.npy").reshape(-1)
        assert (raw > 2.0).any() and _bits_equal(got.depth[2], np.where(raw > 2.0, 0.0, raw).astype(np.float32))
        assert not got.depth[1].any()  # no cue file: no cues
    else:
        assert got.depth is None


def test_scannet_default_scan_and_alternate_folders(tmp_path):
    """The conf's default ScanNet scan id is directory 0; images may sit in
    color/; a view without a pose file fails in both packages."""
    scan = tmp_path / "scannet" / "0"
    tsyn.generate_scene(str(scan), n_views=2, res=RES, convention="scannet")
    os.rename(scan / "images", scan / "color")
    text = CONF.replace("DATA_DIR", "scannet").replace("EXTRA", "").replace("DATASET", SCANNET)
    ref, got, cfg = _both(text, tmp_path)
    assert cfg.scan_id == 0 and got.n_images == 2 and got.depth is None
    _same_scene(ref, got)
    (scan / "pose" / "image_0001.txt").unlink()
    with pytest.raises(FileNotFoundError):
        tdata.load_scene_for_config(cfg, str(tmp_path))


# ---------------------------------------------------------------------------
# scene_line
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene_line")
    scan = root / "DTU" / "scan7"
    tsyn.generate_scene(str(scan), n_views=4, res=RES, convention="dtu", geometry="stacked", depth_dir="depth")
    with open(scan / "lines.json") as f:
        gt = json.load(f)
    lines3d = np.asarray(gt["junctions"], np.float32)[np.asarray(gt["lines"], np.int64)]
    np.savez(root / "lines3d.npz", lines3d=lines3d)
    split = np.empty(2, dtype=object)
    split[0], split[1] = lines3d[:5], lines3d[5:]
    np.savez(root / "lines3d_parts.npz", lines3d=split)
    return root


@pytest.mark.parametrize("npz", ["lines3d.npz", "lines3d_parts.npz"])
@pytest.mark.parametrize("depth_dir", [None, "depth"])
def test_scene_line_conf_bit_equal_to_jax(dtu_root, npz, depth_dir):
    extra = f"scan_id = 7\n    lines_npz = {dtu_root / npz}" + (f"\n    depth_dir = {depth_dir}" if depth_dir else "")
    text = CONF.replace("DATA_DIR", "DTU").replace("EXTRA", extra).replace("DATASET", SCENE_LINE)
    ref, got, cfg = _both(text, dtu_root)
    assert cfg.dataset_kind == "scene_line"
    _same_scene(ref, got)
    # line tables kept, pixels drawn from the whole image, the cues there
    hw = RES[0] * RES[1]
    assert got.support_count.tolist() == [hw] * got.n_images and got.n_lines.max() > 0
    assert (got.depth > 0).sum() > 20


def test_attach_line_depth_cues_bit_equal_to_jax(dtu_root):
    """On its own, over a scene loaded with file depth: the nearest cue
    wins, the cues override the file where they fall, at other sample
    counts and match thresholds too."""
    kw = dict(data_dir="DTU", img_res=RES, scan_id=7, data_root=str(dtu_root), distance_threshold=5.0,
              max_verts=32, depth_dir="depth")
    with jax_numpy_encodels():
        base_j = jdata.load_dtu_scene(**kw)
    base_t = tdata.load_dtu_scene(**kw)
    _same_scene(base_j, base_t)
    file_depth = base_t.depth.copy()
    for n_points, threshold in ((32, 10.0), (200, 10.0), (16, 0.5)):
        ref = jdata.attach_line_depth_cues(dataclasses.replace(base_j, depth=base_j.depth.copy()), str(dtu_root / "lines3d.npz"), n_points, threshold)
        got = tdata.attach_line_depth_cues(dataclasses.replace(base_t, depth=base_t.depth.copy()), str(dtu_root / "lines3d.npz"), n_points, threshold)
        assert _bits_equal(got.depth, ref.depth)
    assert (got.depth != file_depth).any() and (got.depth == file_depth).any()


def test_scene_line_requires_lines_npz():
    for mod in (jdata, tdata):
        with pytest.raises(ValueError, match="lines_npz"):
            mod.load_scene("scene_line", lines_npz=None, data_dir="DTU", img_res=RES, scan_id=7,
                           data_root="/nonexistent")


# ---------------------------------------------------------------------------
# image formats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transparency", [False, True])
@pytest.mark.parametrize("bits,colors", [(1, 2), (2, 4), (4, 16), (8, 256)])
def test_palette_png_equals_jax(tmp_path, bits, colors, transparency):
    rs = np.random.RandomState(bits)
    img = PIL.Image.fromarray(rs.randint(0, 256, (13, 11, 3)).astype(np.uint8)).quantize(colors=colors)
    path = str(tmp_path / "p.png")
    extra = {"transparency": bytes(rs.randint(0, 256, colors).astype(np.uint8))} if transparency else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # Pillow's advice to store such files as RGBA
        img.save(path, bits=bits, **extra)
        ref = jdata._load_rgb(path)
    with open(path, "rb") as f:
        head = f.read(26)
    assert (head[24], head[25]) == (bits, 3)  # the file is a palette PNG of that depth
    got = tdata._load_rgb(path)
    assert _bits_equal(got, ref) and got.shape == (13, 11, 3)


def _write_bmp(path, rgb, bits, top_down, header, rs):
    h, w, _ = rgb.shape
    bpp = bits // 8
    stride = (w * bpp + 3) // 4 * 4
    px = np.zeros((h, w, bpp), np.uint8)
    px[..., :3] = rgb[..., ::-1]
    if bpp == 4:
        px[..., 3] = rs.randint(0, 256, (h, w))  # ignored, as Pillow ignores it
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * bpp] = px.reshape(h, -1)
    if not top_down:
        rows = rows[::-1]
    dib = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, 0, rows.size, 2835, 2835, 0, 0)
    dib += bytes(header - 40)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", 14 + header + rows.size, 0, 0, 14 + header) + dib + rows.tobytes())


@pytest.mark.parametrize("header", [40, 108, 124])
@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("bits", [24, 32])
def test_bmp_equals_jax(tmp_path, bits, top_down, header):
    rs = np.random.RandomState(bits + header)
    rgb = rs.randint(0, 256, (7, 13, 3)).astype(np.uint8)  # rows padded to 4 bytes at 24 bits
    path = str(tmp_path / "x.bmp")
    _write_bmp(path, rgb, bits, top_down, header, rs)
    got = tdata._load_rgb(path)
    assert _bits_equal(got, jdata._load_rgb(path))
    assert _bits_equal(got, rgb.astype(np.float32) / 255.0)


def test_pillow_bmps_and_a_bmp_scene_equal_jax(tmp_path):
    """Pillow's own 24- and 32-bit BMPs, and an ABC-layout scene whose views
    are BMP and palette PNG files, pack as in JAX."""
    tsyn.generate_scene(str(tmp_path / "toy"), n_views=3, res=RES)
    images = tmp_path / "toy" / "images"
    for i, mode in enumerate(("RGB", "RGBA", "P")):
        src = images / f"image_{i:04d}.png"
        img = PIL.Image.open(src).convert("RGB")
        src.unlink()
        if mode == "P":
            img.quantize(colors=64).save(images / f"image_{i:04d}.png")
        else:
            img.convert(mode).save(images / f"image_{i:04d}.bmp")
            assert _bits_equal(tdata._load_rgb(str(images / f"image_{i:04d}.bmp")),
                               jdata._load_rgb(str(images / f"image_{i:04d}.bmp")))
    text = CONF.replace("DATA_DIR", "toy").replace("EXTRA", "").replace(
        "DATASET", "datasets.blender_hawp_dataset.BlenderDataset")
    ref, got, _ = _both(text, tmp_path)
    _same_scene(ref, got)
    assert got.n_images == 3


def test_npy_gray_alpha_and_jpeg_raise(tmp_path):
    rs = np.random.RandomState(0)
    npy = str(tmp_path / "image_0000.npy")
    np.save(npy, rs.rand(8, 8, 3).astype(np.float32))
    with pytest.raises(ValueError):
        jdata._load_rgb(npy)  # imageio has no backend for .npy
    with pytest.raises(ValueError, match="cannot read either"):
        tdata._load_rgb(npy)

    gray_alpha = str(tmp_path / "la.png")
    PIL.Image.fromarray(rs.randint(0, 256, (8, 8, 2)).astype(np.uint8), "LA").save(gray_alpha)
    assert jdata._load_rgb(gray_alpha).shape == (8, 8, 2)  # which no JAX loader can pack
    with pytest.raises(ValueError, match="gray with alpha"):
        tdata._load_rgb(gray_alpha)

    # a baseline JPEG reads as JAX's; a progressive one raises, naming its ROADMAP item
    img = rs.randint(0, 256, (8, 8, 3)).astype(np.uint8)
    jpeg = str(tmp_path / "image_0001.jpg")
    PIL.Image.fromarray(img).save(jpeg)
    assert _bits_equal(tdata._load_rgb(jpeg), jdata._load_rgb(jpeg))
    progressive = str(tmp_path / "image_0002.jpg")
    PIL.Image.fromarray(img).save(progressive, progressive=True)
    assert jdata._load_rgb(progressive).shape == (8, 8, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1, data"):
        tdata._load_rgb(progressive)
