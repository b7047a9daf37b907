"""The port's JPEG decoder (``neat_tpu_torch/data/jpeg.py``,
``csrc/jpeg.cpp``) against neat_tpu's ``_load_rgb`` (imageio -> Pillow ->
libjpeg-turbo), bit for bit: the float arrays ``_load_rgb`` returns are
compared with ``tobytes``, no tolerance.

Files written by Pillow: 4:4:4, 4:2:2, 4:2:0 and gray at qualities 50, 90
and 100 and sizes 1 x 1, 7 x 5, 37 x 53, 250 x 333 and 480 x 640
(ScanNet's); restart markers every 1 and every 3 blocks and every MCU row
(intervals that do not divide the MCU count); optimized Huffman tables;
an EXIF orientation tag (imageio does not apply it, nor does the port);
RGB without a transform (Adobe marker, component ids R, G, B); 16-bit
quantization tables (libjpeg then writes SOF1); a baseline file relabelled
SOF1; fill bytes (FF FF ...) before markers. And a file this test encodes
itself with one scan per component (non-interleaved, 4:2:0), a restart
interval and fill bytes, which Pillow does not write. The kinds the
decoder does not take (progressive, arithmetic-coded, lossless, 12-bit
samples, CMYK) raise NotImplementedError naming the file, the kind and
"ROADMAP.md §1, data". A generated ScanNet scene whose colour frames are
JPEG loads equal through both packages' scene loaders.
"""

import io
import os
import struct

import numpy as np
import PIL.Image
import pytest

import neat_tpu.data.datasets as jdata
import neat_tpu_torch.data.datasets as tdata
import neat_tpu_torch.data.synthetic as tsyn

SUBSAMPLING = {"444": 0, "422": 1, "420": 2, "gray": None}
SIZES = [(1, 1), (7, 5), (37, 53), (250, 333), (480, 640)]


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _image(h, w, gray=False, seed=0):
    """Smooth colour ramps, edges and noise: every kind of block."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([(7 * x + 3 * y) % 256, (x * y) % 256, 128 + 100 * np.sin(x / 5.0) * np.cos(y / 7.0)], -1)
    a = np.clip(a + rs.randn(h, w, 3) * 12, 0, 255).astype(np.uint8)
    return a[..., 0] if gray else a


def _save(tmp_path, arr, name="image_0000.jpg", **kw):
    path = str(tmp_path / name)
    PIL.Image.fromarray(arr).save(path, "JPEG", **kw)
    return path


def _same(path):
    got, ref = tdata._load_rgb(path), jdata._load_rgb(path)
    assert _bits_equal(got, ref), (path, got.shape, ref.shape)
    return got


def _pillow_kw(sub, **kw):
    return kw if SUBSAMPLING[sub] is None else dict(kw, subsampling=SUBSAMPLING[sub])


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
def test_baseline_equals_reference(tmp_path, sub, quality, size):
    _same(_save(tmp_path, _image(*size, gray=sub == "gray"), **_pillow_kw(sub, quality=quality)))


@pytest.mark.parametrize("restart", [dict(restart_marker_blocks=1), dict(restart_marker_blocks=3),
                                     dict(restart_marker_rows=1)], ids=["blocks1", "blocks3", "rows1"])
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
def test_restart_markers_equal_reference(tmp_path, sub, restart):
    path = _save(tmp_path, _image(37, 53, gray=sub == "gray"), **_pillow_kw(sub, quality=90, **restart))
    data = open(path, "rb").read()
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _same(path)


@pytest.mark.parametrize("sub", list(SUBSAMPLING))
def test_optimized_huffman_tables_equal_reference(tmp_path, sub):
    _same(_save(tmp_path, _image(250, 333, gray=sub == "gray"), **_pillow_kw(sub, quality=75, optimize=True)))


def test_exif_orientation_is_not_applied(tmp_path):
    exif = PIL.Image.Exif()
    exif[0x0112] = 6  # rotate 90 when shown
    got = _same(_save(tmp_path, _image(7, 5), exif=exif.tobytes()))
    assert got.shape == (7, 5, 3)


def test_rgb_without_transform_equals_reference(tmp_path):
    path = _save(tmp_path, _image(37, 53), keep_rgb=True)
    assert b"Adobe" in open(path, "rb").read()
    _same(path)


def test_16_bit_tables_and_sof1_equal_reference(tmp_path):
    path = _save(tmp_path, _image(37, 53), qtables=[[300] * 64, [2] * 64])
    data = open(path, "rb").read()
    assert b"\xff\xc1" in data and data[data.find(b"\xff\xdb") + 4] >> 4 == 1  # SOF1, 16-bit DQT
    _same(path)
    base = open(_save(tmp_path, _image(37, 53), "base.jpg", quality=90), "rb").read()
    relabelled = tmp_path / "sof1.jpg"
    relabelled.write_bytes(base.replace(b"\xff\xc0", b"\xff\xc1", 1))
    _same(str(relabelled))


def test_fill_bytes_before_markers_equal_reference(tmp_path):
    data = open(_save(tmp_path, _image(37, 53), quality=90), "rb").read()
    for marker in (b"\xff\xdb", b"\xff\xc0", b"\xff\xc4", b"\xff\xda"):
        i = data.find(marker)
        data = data[:i] + b"\xff\xff" + data[i:]
    path = tmp_path / "fill.jpg"
    path.write_bytes(data)
    _same(str(path))


# ---------------------------------------------------------------------------
# a baseline file with one scan per component, which Pillow does not write
# ---------------------------------------------------------------------------

ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
                   6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
                   38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def _dct_matrix():
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        out, self.out = bytes(self.out), bytearray()
        return out


def _category(v):
    return 0 if v == 0 else int(abs(v)).bit_length()


def _magnitude(v, s):
    return v if v >= 0 else v + (1 << s) - 1


def _encode_noninterleaved(img, quality_table, restart=5):
    """A 4:2:0 YCbCr file with three scans, one per component; Huffman
    tables of fixed length codes (DC: 4 bits, AC: 8 bits); a restart every
    ``restart`` blocks; fill bytes before some markers."""
    h, w, _ = img.shape
    rgb = img.astype(np.float64)
    ycc = np.stack([0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2],
                    128 - 0.168736 * rgb[..., 0] - 0.331264 * rgb[..., 1] + 0.5 * rgb[..., 2],
                    128 + 0.5 * rgb[..., 0] - 0.418688 * rgb[..., 1] - 0.081312 * rgb[..., 2]], -1)
    c = _dct_matrix()
    q = np.asarray(quality_table, np.float64).reshape(8, 8)
    planes = [ycc[..., 0]]
    ch, cw = (h + 1) // 2, (w + 1) // 2
    for i in (1, 2):  # 2 x 2 means over the edge-replicated plane
        p = np.pad(ycc[..., i], ((0, 2 * ch - h), (0, 2 * cw - w)), mode="edge")
        planes.append(p.reshape(ch, 2, cw, 2).mean(axis=(1, 3)))
    dc_vals, ac_vals = list(range(12)), sorted({(r << 4) | s for r in range(16) for s in range(1, 11)} | {0, 0xF0})
    dc_code = {v: (i, 4) for i, v in enumerate(dc_vals)}
    ac_code = {v: (i, 8) for i, v in enumerate(ac_vals)}
    seg = lambda m, body: b"\xff" + bytes([m]) + struct.pack(">H", len(body) + 2) + body
    out = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += b"\xff\xff" + seg(0xDB, b"\x00" + bytes(int(v) for v in np.asarray(quality_table)[ZIGZAG]))
    out += seg(0xC0, struct.pack(">BHHB", 8, h, w, 3) + b"\x01\x22\x00\x02\x11\x00\x03\x11\x00")
    out += seg(0xC4, b"\x00" + bytes([0, 0, 0, 12] + [0] * 12) + bytes(dc_vals))
    out += seg(0xC4, b"\x10" + bytes([0] * 7 + [len(ac_vals)] + [0] * 8) + bytes(ac_vals))
    out += seg(0xDD, struct.pack(">H", restart))
    for comp, plane in enumerate(planes):
        ph, pw = plane.shape
        bh, bw = (ph + 7) // 8, (pw + 7) // 8
        padded = np.pad(plane, ((0, 8 * bh - ph), (0, 8 * bw - pw)), mode="edge") - 128
        bits, pred, data, n = _Bits(), 0, b"", 0
        for by in range(bh):
            for bx in range(bw):
                if n and n % restart == 0:
                    data += bits.flush() + b"\xff" + bytes([0xD0 + (n // restart - 1) % 8])
                    pred = 0
                block = c @ padded[8 * by:8 * by + 8, 8 * bx:8 * bx + 8] @ c.T
                coef = np.round(block / q).astype(int).reshape(-1)[ZIGZAG]
                diff = coef[0] - pred
                pred = coef[0]
                s = _category(diff)
                bits.put(*dc_code[s])
                bits.put(_magnitude(diff, s), s)
                run = 0
                last = max([k for k in range(1, 64) if coef[k]], default=0)
                for k in range(1, last + 1):
                    if coef[k] == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits.put(*ac_code[0xF0])
                        run -= 16
                    s = _category(coef[k])
                    bits.put(*ac_code[(run << 4) | s])
                    bits.put(_magnitude(coef[k], s), s)
                    run = 0
                if last < 63:
                    bits.put(*ac_code[0])
                n += 1
        data += bits.flush()
        out += b"\xff\xff" + seg(0xDA, bytes([1, comp + 1, 0x00, 0, 63, 0])) + data
    return out + b"\xff\xd9"


@pytest.mark.parametrize("size", [(37, 53), (16, 16)], ids=["37x53", "16x16"])
def test_one_scan_per_component_equals_reference(tmp_path, size):
    table = np.clip(np.arange(64) // 3 + 2, 1, 255)
    path = tmp_path / "noninterleaved.jpg"
    path.write_bytes(_encode_noninterleaved(_image(*size), table))
    got = _same(str(path))
    assert got.shape == (*size, 3) and np.ptp(got) > 0.5


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------


def _patched(tmp_path, name, edit):
    data = open(_save(tmp_path, _image(8, 8), "base.jpg", quality=90), "rb").read()
    path = tmp_path / name
    path.write_bytes(edit(data))
    return str(path)


@pytest.mark.parametrize("kind", ["progressive", "arithmetic-coded", "lossless", "12-bit", "CMYK"])
def test_kinds_not_decoded_raise(tmp_path, kind):
    sof = lambda data, marker: data.replace(b"\xff\xc0", b"\xff" + bytes([marker]), 1)
    if kind == "progressive":
        path = _save(tmp_path, _image(8, 8), "image_0007.jpg", progressive=True)
    elif kind == "arithmetic-coded":
        path = _patched(tmp_path, "image_0007.jpg", lambda d: sof(d, 0xC9))
    elif kind == "lossless":
        path = _patched(tmp_path, "image_0007.jpg", lambda d: sof(d, 0xC3))
    elif kind == "12-bit":
        path = _patched(tmp_path, "image_0007.jpg",
                        lambda d: d[:d.find(b"\xff\xc0") + 4] + b"\x0c" + d[d.find(b"\xff\xc0") + 5:])
    else:
        path = str(tmp_path / "image_0007.jpg")
        PIL.Image.fromarray(_image(8, 8)).convert("CMYK").save(path, "JPEG")
    with pytest.raises(NotImplementedError) as err:
        tdata._load_rgb(path)
    msg = str(err.value)
    assert path in msg and "ROADMAP.md §1, data" in msg and kind in msg, msg


def test_malformed_jpeg_raises_value_error(tmp_path):
    """A file cut in its headers or inside its scan data raises ValueError
    naming it (Pillow: "image file is truncated")."""
    data = open(_save(tmp_path, _image(64, 64), quality=90), "rb").read()
    for name, cut in (("cut.jpg", 100), ("cut_in_scan.jpg", len(data) - 400)):
        path = tmp_path / name
        path.write_bytes(data[:cut])
        with pytest.raises(OSError):
            jdata._load_rgb(str(path))
        with pytest.raises(ValueError, match=name):
            tdata._load_rgb(str(path))
    with pytest.raises(ValueError, match="truncated"):
        tdata._load_rgb(str(tmp_path / "cut_in_scan.jpg"))


def test_scannet_scene_of_jpeg_frames_equals_reference(tmp_path):
    """A generated ScanNet scene whose colour frames are JPEG (quality 90,
    4:2:0, as exported frames are), through both packages' loaders."""
    import neat_tpu.train.config as jconf
    import neat_tpu_torch.train.config as tconf
    from _torch_helpers import jax_numpy_encodels

    scan = tmp_path / "scannet" / "scene0000_00"
    tsyn.generate_scene(str(scan), n_views=3, res=(48, 64), convention="scannet")
    for name in sorted(os.listdir(scan / "images")):
        png = scan / "images" / name
        PIL.Image.open(png).convert("RGB").save(str(png)[:-4] + ".jpg", "JPEG", quality=90)
        png.unlink()
    text = ("dataset {\n data_dir = scannet\n img_res = [48, 64]\n scan_id = scene0000_00\n}\n"
            "train { dataset_class = datasets.scannet_hawp_dataset.SceneDataset }\n")
    conf = jconf.parse_hocon(text)
    with jax_numpy_encodels():
        ref = jdata.load_scene_for_config(jconf.build_experiment_config(conf, max_verts=32), str(tmp_path))
    got = tdata.load_scene_for_config(tconf.build_experiment_config(conf, max_verts=32), str(tmp_path))
    assert got.n_images == 3
    for name in ref.__dataclass_fields__:
        a, b = getattr(ref, name), getattr(got, name)
        assert a == b if a is None or isinstance(a, tuple) else _bits_equal(a, b), name


def test_decode_bytes_gives_pillows_samples():
    """``decode_jpeg`` on bytes gives the uint8 samples Pillow gives."""
    from neat_tpu_torch.data.jpeg import decode_jpeg

    buf = io.BytesIO()
    PIL.Image.fromarray(_image(37, 53)).save(buf, "JPEG", quality=90, subsampling=2)
    got = decode_jpeg(buf.getvalue())
    assert got.dtype == np.uint8 and _bits_equal(got, np.asarray(PIL.Image.open(io.BytesIO(buf.getvalue()))))


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")


def test_committed_fixtures_match_their_digests():
    """The fixtures chip_smoke.py decodes on the card: the SHA-256 committed
    beside them is that of the reference's uint8 samples, and the port's."""
    import hashlib
    import json

    import imageio.v2 as imageio

    from neat_tpu_torch.data.jpeg import read_jpeg

    with open(os.path.join(FIXTURES, "sha256.json")) as f:
        digests = json.load(f)
    assert len(digests) == 10
    for name, want in digests.items():
        path = os.path.join(FIXTURES, name)
        ref, got = np.asarray(imageio.imread(path)), read_jpeg(path)
        assert list(ref.shape) == want["shape"] and hashlib.sha256(ref.tobytes()).hexdigest() == want["sha256"], name
        assert _bits_equal(got, ref), name
