"""The port's scene data (neat_tpu_torch/data) against neat_tpu's.

Everything here is exact: the wireframe graph, the encodels maps (native
and numpy) against JAX's numpy version, the PNG reader against imageio's
readers, the synthetic scene files against the JAX generator's, and every
packed SceneData array against JAX's loader, bit for bit.

JAX's own native encodels library (``csrc/libencodels.so``) is built with
``-march=native`` and lets g++ fuse multiply-adds, so on a CPU with FMA it
differs from JAX's numpy version by up to 1e-4 px; the port builds its
copy with ``-ffp-contract=off`` and equals the numpy version. The packed
scenes are therefore compared with JAX's loader on its numpy encodels.
"""

import dataclasses
import json
import os
import os.path as osp
import struct
import zlib

import cv2
import imageio.v2 as imageio
import imageio.v3 as iio3
import numpy as np
import pytest

import neat_tpu.data.datasets as jdata
import neat_tpu.data.encodels as jenc
import neat_tpu.data.synthetic as jsyn
import neat_tpu.data.wireframe as jwf
import neat_tpu.train.config as jconf
import neat_tpu_torch.data.datasets as tdata
import neat_tpu_torch.data.encodels as tenc
import neat_tpu_torch.data.synthetic as tsyn
import neat_tpu_torch.data.wireframe as twf
import neat_tpu_torch.train.config as tconf
from neat_tpu_torch.data.png import read_png, write_png

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# wireframe graph
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hawp_jsons(tmp_path_factory):
    d = tmp_path_factory.mktemp("wf")
    jsyn.generate_scene(str(d), n_views=3, res=(64, 48), geometry="grid")
    rs = np.random.RandomState(0)
    # one with random weights, so the thresholds cut
    wf = json.load(open(d / "hawp" / "image_0000.json"))
    wf["edges-weights"] = rs.rand(len(wf["edges"])).tolist()
    with open(d / "hawp" / "random.json", "w") as f:
        json.dump(wf, f)
    return sorted(str(p) for p in (d / "hawp").glob("*.json"))


def test_wireframe_graph_matches_jax(hawp_jsons):
    for path in hawp_jsons:
        a, b = jwf.WireframeGraph.load_json(path), twf.WireframeGraph.load_json(path)
        for field in ("vertices", "v_confidences", "edges", "weights"):
            assert _bits_equal(getattr(a, field), getattr(b, field)), field
        assert (a.frame_width, a.frame_height, a.num_vertices, a.num_edges) == (
            b.frame_width, b.frame_height, b.num_vertices, b.num_edges)
        for thr in (0.01, 0.05, 0.5):
            assert _bits_equal(a.line_segments(thr), b.line_segments(thr)), thr


# ---------------------------------------------------------------------------
# encodels
# ---------------------------------------------------------------------------


def _lines(n, h, w, seed):
    rs = np.random.RandomState(seed)
    lines = (rs.rand(n, 4) * [w, h, w, h]).astype(np.float32)
    lines[0, 2:] = lines[0, :2]  # one degenerate segment
    return lines


@pytest.fixture(scope="module")
def view_512_lines(tmp_path_factory):
    d = tmp_path_factory.mktemp("enc512")
    tsyn.generate_scene(str(d), n_views=1, res=(512, 512), geometry="stacked")
    return twf.WireframeGraph.load_json(str(d / "hawp" / "image_0000.json")).line_segments(0.05)


@pytest.mark.parametrize("backend", ["native", "numpy"])
@pytest.mark.parametrize("size", ["64x64", "512x512_view"])
def test_encodels_bit_equal_to_jax_numpy(backend, size, view_512_lines):
    if size == "64x64":
        h = w = 64
        lines = _lines(9, h, w, seed=1)
    else:
        h = w = 512
        lines = view_512_lines
    ref = jenc._encodels_numpy(np.ascontiguousarray(lines[:, :4], np.float32), h, w)
    got = tenc.encode_line_attraction(lines, h, w, backend=backend)
    for r, g in zip(ref, got):
        assert _bits_equal(r, g)
    ref_s = jenc.attraction_support(lines, h, w, distance_threshold=5.0, backend="numpy")
    got_s = tenc.attraction_support(lines, h, w, distance_threshold=5.0, backend=backend)
    for r, g in zip(ref_s, got_s):
        assert _bits_equal(r, g)


def test_encodels_backend_is_explicit():
    with pytest.raises(ValueError, match="'native' or 'numpy'"):
        tenc.encode_line_attraction(_lines(2, 8, 8, 0), 8, 8, backend="auto")
    with pytest.raises(ValueError, match="at least one line"):
        tenc.encode_line_attraction(np.zeros((0, 4), np.float32), 8, 8, backend="numpy")


def test_native_encodels_build_failure_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises; nothing falls back to numpy."""
    bad = tmp_path / "encodels.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tenc, "_lib", None)
    monkeypatch.setattr(tenc, "_SRC", bad)
    monkeypatch.setattr(tenc, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tenc, "_LIB_PATH", tmp_path / "build" / "libencodels.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tenc.encode_line_attraction(_lines(2, 8, 8, 0), 8, 8, backend="native")
    assert not (tmp_path / "build" / "libencodels.so").exists()


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

FILTERS = {
    "none": cv2.IMWRITE_PNG_FILTER_NONE, "sub": cv2.IMWRITE_PNG_FILTER_SUB, "up": cv2.IMWRITE_PNG_FILTER_UP,
    "avg": cv2.IMWRITE_PNG_FILTER_AVG, "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
}


def _png_filters(path):
    """The set of filter types of a PNG's rows, read from the file."""
    data = open(path, "rb").read()
    pos, idat, head = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
    w, h, depth, color = head[:4]
    stride = w * {0: 1, 2: 3, 6: 4}[color] * depth // 8 + 1
    raw = zlib.decompress(idat)
    return {raw[i * stride] for i in range(h)}


@pytest.mark.parametrize("filt", sorted(FILTERS))
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("depth", [8, 16])
def test_png_reader_matches_imageio(tmp_path, depth, channels, filt):
    """imageio writes every filter type (its OpenCV plugin); the reader gives
    the samples written, as imageio reads them. For 16-bit RGB and RGBA
    imageio's default (Pillow) read keeps the high byte of each sample: the
    reader keeps all 16 bits, as imageio's OpenCV read does."""
    rs = np.random.RandomState(depth * 100 + channels * 10 + len(filt))
    dtype = np.uint8 if depth == 8 else np.uint16
    shape = (13, 11) if channels == 1 else (13, 11, channels)
    arr = rs.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "x.png")
    iio3.imwrite(path, arr, plugin="opencv", params=[cv2.IMWRITE_PNG_FILTER, FILTERS[filt]])
    assert _png_filters(path) == {list(FILTERS).index(filt)}
    got = read_png(path)
    assert _bits_equal(got, arr)
    if depth == 16 and channels > 1:
        assert _bits_equal(got, iio3.imread(path, plugin="opencv", flags=cv2.IMREAD_UNCHANGED))
        assert _bits_equal(imageio.imread(path), (got >> 8).astype(np.uint8))
    else:
        assert _bits_equal(got, imageio.imread(path))


@pytest.mark.parametrize("shape", [(40, 37), (40, 37, 3), (40, 37, 4)])
def test_png_reader_reads_pillow_files(tmp_path, shape):
    """imageio's default (Pillow) writer picks each row's filter."""
    rs = np.random.RandomState(len(shape))
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    smooth = ((xx * 3 + yy * 5) % 256).astype(np.uint8)
    arr = rs.randint(0, 256, shape).astype(np.uint8)
    arr[:20] = smooth[:20, :, None] if len(shape) == 3 else smooth[:20]  # rows that filter well
    path = str(tmp_path / "pil.png")
    imageio.imwrite(path, arr)
    assert _bits_equal(read_png(path), imageio.imread(path))


def test_png_writer_round_trips_through_imageio(tmp_path):
    arr = np.random.RandomState(0).randint(0, 256, (40, 37, 3)).astype(np.uint8)
    mine = str(tmp_path / "mine.png")
    write_png(mine, arr)
    assert _png_filters(mine) == {0}
    assert _bits_equal(imageio.imread(mine), arr)
    for bad in (arr[..., 0], arr.astype(np.uint16), np.dstack([arr, arr[..., :1]])):
        with pytest.raises(ValueError, match="uint8"):
            write_png(str(tmp_path / "bad.png"), bad)


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    rs = np.random.RandomState(0)
    bilevel = str(tmp_path / "bilevel.png")
    import PIL.Image

    PIL.Image.fromarray(rs.randint(0, 2, (8, 8)).astype(bool)).save(bilevel)  # gray, 1 bit a sample
    with pytest.raises(ValueError, match="bit depth 1 is not read for color type 0"):
        read_png(bilevel)
    good = str(tmp_path / "good.png")
    write_png(good, rs.randint(0, 256, (8, 8, 3)).astype(np.uint8))
    data = bytearray(open(good, "rb").read())
    data[40] ^= 0xFF  # inside the IDAT chunk
    bad = tmp_path / "bad.png"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(str(bad))
    (tmp_path / "short.png").write_bytes(bytes(data[:30]))
    with pytest.raises(ValueError):
        read_png(str(tmp_path / "short.png"))
    jpeg = str(tmp_path / "image.jpg")
    PIL.Image.fromarray(rs.randint(0, 256, (8, 8, 3)).astype(np.uint8)).save(jpeg, progressive=True)
    with pytest.raises(NotImplementedError, match="progressive"):
        tdata._load_rgb(jpeg)


@pytest.mark.parametrize("depth,channels", [(8, 1), (8, 3), (8, 4), (16, 1)])
def test_load_rgb_matches_jax(tmp_path, depth, channels):
    """The port's _load_rgb against JAX's on files imageio's default writer
    writes: the same scaling and channel handling. (It writes no 16-bit RGB
    or RGBA, which JAX would read through Pillow's high byte: the reader
    test covers those.)"""
    rs = np.random.RandomState(channels)
    dtype = np.uint8 if depth == 8 else np.uint16
    shape = (9, 10) if channels == 1 else (9, 10, channels)
    path = str(tmp_path / "img.png")
    imageio.imwrite(path, rs.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype))
    assert _bits_equal(tdata._load_rgb(path), jdata._load_rgb(path))


# ---------------------------------------------------------------------------
# synthetic scenes
# ---------------------------------------------------------------------------


def _tree(d):
    return sorted(osp.relpath(osp.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("geometry", sorted(jsyn.GEOMETRIES))
@pytest.mark.parametrize("convention", ["blender", "dtu", "scannet"])
def test_generate_scene_matches_jax(tmp_path, convention, geometry):
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    kw = dict(n_views=3, res=(48, 48), seed=5, convention=convention, geometry=geometry)
    jsyn.generate_scene(a, **kw)
    tsyn.generate_scene(b, **kw)
    assert _tree(a) == _tree(b)
    for rel in _tree(a):
        pa, pb = osp.join(a, rel), osp.join(b, rel)
        if rel.endswith(".png"):
            assert _bits_equal(imageio.imread(pa), imageio.imread(pb)), rel
            assert _bits_equal(imageio.imread(pa), read_png(pb)), rel
        elif rel.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert _bits_equal(za[k], zb[k]), (rel, k)
        elif rel.endswith(".json"):
            assert json.load(open(pa)) == json.load(open(pb)), rel
        else:
            assert open(pa).read() == open(pb).read(), rel


# ---------------------------------------------------------------------------
# packed scenes
# ---------------------------------------------------------------------------

TINY = """
train {
    expname = tiny
    dataset_class = DATASET
}
dataset {
    data_dir = toy
    img_res = [RES, RES]
}
"""
CLASSES = {
    "blender": "datasets.blender_hawp_dataset.BlenderDataset",
    "blender_plain": "datasets.blender_dataset.BlenderDataset",
}


@pytest.fixture(scope="module")
def scene_roots(tmp_path_factory):
    roots = {}
    for res, views in ((48, 6), (512, 3)):
        d = tmp_path_factory.mktemp(f"scene{res}")
        tsyn.generate_scene(str(d / "toy"), n_views=views, res=(res, res), geometry="stacked")
        roots[res] = d
    return roots


@pytest.mark.parametrize("kind", sorted(CLASSES))
@pytest.mark.parametrize("res", [48, 512])
def test_packed_scene_bit_equal_to_jax(scene_roots, kind, res, monkeypatch):
    root = scene_roots[res]
    conf = jconf.parse_hocon(TINY.replace("DATASET", CLASSES[kind]).replace("RES", str(res)))
    cfg_j = jconf.build_experiment_config(conf, max_verts=64)
    cfg_t = tconf.build_experiment_config(conf, max_verts=64)
    assert cfg_t.dataset_kind == kind
    monkeypatch.setattr(jenc, "_build_native", lambda: None)  # JAX's auto backend -> its numpy version
    ref = jdata.load_scene_for_config(cfg_j, str(root))
    got = tdata.load_scene_for_config(cfg_t, str(root))
    assert [f.name for f in ref.__dataclass_fields__.values()] == [f.name for f in got.__dataclass_fields__.values()]
    for name in ref.__dataclass_fields__:
        a, b = getattr(ref, name), getattr(got, name)
        if a is None or isinstance(a, tuple):
            assert a == b, name
        else:
            assert _bits_equal(a, b), name
    if kind == "blender":
        assert (got.mask.sum(axis=1) > 0).all() and (got.support_count > 0).all()


@pytest.mark.parametrize("conf,res", [("dtu.conf", (60, 80)), ("bmvs.conf", (48, 64))])
def test_dtu_and_bmvs_confs_load_as_in_jax(conf, res, tmp_path, monkeypatch):
    """dtu.conf and bmvs.conf load a DTU-layout scene (their data_dir and
    scan_id, the 5 px default band, the conf's aspect ratio at a small
    size) bit for bit as JAX's loader does. A missing scene directory
    raises."""
    cfg_j = jconf.load_experiment_config(osp.join(REPO, "confs", conf))
    cfg_t = tconf.load_experiment_config(osp.join(REPO, "confs", conf))
    assert cfg_t.dataset_kind == "dtu" and cfg_t.distance_threshold == 5.0
    assert tuple(cfg_t.img_res) == tuple(int(20 * r) if conf == "dtu.conf" else int(12 * r) for r in res)
    cfg_j, cfg_t = (dataclasses.replace(c, img_res=res) for c in (cfg_j, cfg_t))
    scan = tmp_path / cfg_t.data_dir / f"scan{cfg_t.scan_id}"
    tsyn.generate_scene(str(scan), n_views=3, res=res, convention="dtu", geometry="cuboid")
    monkeypatch.setattr(jenc, "_build_native", lambda: None)  # JAX's auto backend -> its numpy version
    ref = jdata.load_scene_for_config(cfg_j, str(tmp_path))
    got = tdata.load_scene_for_config(cfg_t, str(tmp_path))
    for name in ref.__dataclass_fields__:
        a, b = getattr(ref, name), getattr(got, name)
        if a is None or isinstance(a, tuple):
            assert a == b, name
        else:
            assert _bits_equal(a, b), name
    assert got.n_images == 3 and (got.support_count > 0).all()
    with pytest.raises(FileNotFoundError, match="is empty"):
        tdata.load_scene("scannet", data_dir="x", img_res=(8, 8), data_root=str(tmp_path))


def test_port_imports_no_image_plot_or_conf_library():
    """The card machine has none of these: no module of the port, nor
    chip_smoke.py, imports them."""
    import ast
    import pathlib

    root = pathlib.Path(REPO)
    files = [*sorted((root / "neat_tpu_torch").rglob("*.py")), root / "chip_smoke.py"]
    banned = ("imageio", "PIL", "matplotlib", "tensorboard", "pyhocon", "cv2", "skimage")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in banned, (path, mod)
