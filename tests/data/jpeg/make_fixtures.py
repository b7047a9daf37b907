"""Write the JPEG fixtures of this directory and their digests.

Run from the repository root on a machine with Pillow and imageio:

    python3 tests/data/jpeg/make_fixtures.py

Writes, with Pillow: 4:4:4, 4:2:2 and 4:2:0 colour and gray 37 x 53
images (quality 90), a 4:2:0 one with a restart marker every 3 blocks,
one 968 x 1296 frame (ScanNet's raw colour size: a view of a generated
ScanNet-layout scene), and the four 480 x 640 views of the generated
ScanNet-layout scene ``generate_scene(convention="scannet", n_views=4,
res=(480, 640), seed=0)`` under scannet_480x640/. ``sha256.json`` holds
the SHA-256 of the uint8 samples the JAX package's reader (imageio ->
Pillow -> libjpeg-turbo) gives for each file, and their shape.
"""

import hashlib
import json
import os
import sys
import tempfile

import imageio.v2 as imageio
import numpy as np
import PIL.Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from neat_tpu_torch.data.synthetic import generate_scene  # noqa: E402

SCENE = dict(convention="scannet", n_views=4, res=(480, 640), seed=0)


def pattern(h, w, gray=False):
    rs = np.random.RandomState(0)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([(7 * x + 3 * y) % 256, (x * y) % 256, 128 + 100 * np.sin(x / 5.0) * np.cos(y / 7.0)], -1)
    a = np.clip(a + rs.randn(h, w, 3) * 12, 0, 255).astype(np.uint8)
    return a[..., 0] if gray else a


def main():
    files = {
        "f444.jpg": (pattern(37, 53), dict(quality=90, subsampling=0)),
        "f422.jpg": (pattern(37, 53), dict(quality=90, subsampling=1)),
        "f420.jpg": (pattern(37, 53), dict(quality=90, subsampling=2)),
        "gray.jpg": (pattern(37, 53, gray=True), dict(quality=90)),
        "restart.jpg": (pattern(37, 53), dict(quality=90, subsampling=2, restart_marker_blocks=3)),
    }
    with tempfile.TemporaryDirectory() as tmp:
        generate_scene(os.path.join(tmp, "frame"), convention="scannet", n_views=1, res=(968, 1296), seed=0)
        files["frame_968x1296.jpg"] = (imageio.imread(os.path.join(tmp, "frame", "images", "image_0000.png")),
                                       dict(quality=90, subsampling=2))
        generate_scene(os.path.join(tmp, "scene"), **SCENE)
        for i in range(SCENE["n_views"]):
            png = os.path.join(tmp, "scene", "images", f"image_{i:04d}.png")
            files[f"scannet_480x640/image_{i:04d}.jpg"] = (imageio.imread(png), dict(quality=90, subsampling=2))
    digests = {}
    for name, (arr, kw) in files.items():
        path = os.path.join(HERE, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        PIL.Image.fromarray(np.ascontiguousarray(arr[..., :3] if arr.ndim == 3 else arr)).save(path, "JPEG", **kw)
        ref = np.asarray(imageio.imread(path))
        digests[name] = {"sha256": hashlib.sha256(ref.tobytes()).hexdigest(), "shape": list(ref.shape)}
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
