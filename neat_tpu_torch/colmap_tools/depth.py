"""COLMAP MVS depth and normal maps (port of read_array / write_array of
neat_tpu/colmap_tools/depth.py, numpy only).

The format: an ASCII header ``width&height&channels&`` followed by the
float32 payload in column-major order over (width, height, channels).
"""

from __future__ import annotations

import numpy as np


def read_array(path: str) -> np.ndarray:
    """Read a COLMAP .bin depth or normal array as (H, W[, C]) float32."""
    with open(path, "rb") as f:
        header = b""
        n_amp = 0
        while n_amp < 3:
            c = f.read(1)
            if not c:
                raise ValueError(f"truncated COLMAP array {path}")
            header += c
            if c == b"&":
                n_amp += 1
        width, height, channels = (int(x) for x in header[:-1].split(b"&"))
        data = np.fromfile(f, np.float32)
    arr = data.reshape((width, height, channels), order="F")
    return np.transpose(arr, (1, 0, 2)).squeeze()


def write_array(path: str, array: np.ndarray) -> None:
    """Write an (H, W[, C]) array in the format ``read_array`` reads."""
    arr = np.atleast_3d(np.asarray(array, np.float32))
    h, w, c = arr.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode())
        np.transpose(arr, (1, 0, 2)).astype(np.float32).ravel(order="F").tofile(f)
