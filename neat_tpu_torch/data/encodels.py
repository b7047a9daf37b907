"""Attraction-field encoding of 2D line segments (port of
neat_tpu/data/encodels.py, host code, numpy only).

Per pixel: the closest line segment and its perpendicular-foot offset. The
pixels within ``distance_threshold`` of their segment form the attraction
support region that training draws rays from; their foot points become
``uv_proj``.

Two implementations with the same outputs, bit for bit:
  * ``"native"``: this package's ``csrc/encodels.cpp``, compiled by ``g++``
    on first use into ``build/host/`` at the root of the checkout and
    loaded through ``ctypes``. A failed build raises.
  * ``"numpy"``: the vectorised plain version the tests hold it against.
The caller names one; neither falls back to the other.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "encodels.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
_LIB_PATH = _BUILD_DIR / "libencodels.so"
# -ffp-contract=off: g++ fuses a * b + c into one multiply-add by default
# where the target has one, which rounds once where numpy rounds twice. No
# -march=native: the library may be loaded on another machine than the one
# that built it.
_GXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")
_lib: Optional[ctypes.CDLL] = None  # loaded once per process


def build_native() -> ctypes.CDLL:
    """Compile ``csrc/encodels.cpp`` when its library is missing or older
    than the source, load it and return it. Raises with g++'s output when
    the build fails: there is no fallback."""
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = _BUILD_DIR / f".libencodels.{os.getpid()}.so"
        errors = []
        for openmp in (("-fopenmp",), ()):  # OpenMP where the compiler has it
            cmd = ["g++", *_GXX_FLAGS, *openmp, str(_SRC), "-o", str(tmp)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(f"native encodels: no g++ to build {_SRC} ({e})") from e
            if proc.returncode == 0:
                break
            errors.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        else:
            raise RuntimeError("native encodels: g++ failed\n" + "\n".join(errors))
        os.replace(tmp, _LIB_PATH)  # atomic: another process may load it at once
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.encodels.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.encodels.restype = None
    _lib = lib
    return lib


def encode_line_attraction(
    lines: np.ndarray, height: int, width: int, backend: str = "native"
) -> Tuple[np.ndarray, np.ndarray]:
    """Closest-line map for every pixel.

    lines: (N, 4) [x1 y1 x2 y2] (x, y) pixel coordinates. ``backend`` is
    ``"native"`` or ``"numpy"``. Returns (lmap (6, H, W) float32, labels
    (H, W) int32); csrc/encodels.cpp gives the channel layout.
    """
    lines = np.ascontiguousarray(lines[:, :4], dtype=np.float32)
    n = lines.shape[0]
    if n == 0:
        raise ValueError("encode_line_attraction needs at least one line")
    if backend == "numpy":
        return _encodels_numpy(lines, height, width)
    if backend != "native":
        raise ValueError(f"backend is 'native' or 'numpy', got {backend!r}")
    lib = build_native()
    lmap = np.empty((6, height, width), dtype=np.float32)
    labels = np.empty((height, width), dtype=np.int32)
    lib.encodels(
        lines.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        height,
        width,
        lmap.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return lmap, labels


def _encodels_numpy(
    lines: np.ndarray, height: int, width: int, row_chunk: int = 32
) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version; chunked over rows to bound the (N, chunk*W)
    distance matrix."""
    x1, y1, x2, y2 = lines[:, 0], lines[:, 1], lines[:, 2], lines[:, 3]
    dx, dy = x2 - x1, y2 - y1
    len2 = np.maximum(dx * dx + dy * dy, 1e-12)

    lmap = np.empty((6, height, width), dtype=np.float32)
    labels = np.empty((height, width), dtype=np.int32)
    xs = np.arange(width, dtype=np.float32)
    for r0 in range(0, height, row_chunk):
        r1 = min(r0 + row_chunk, height)
        ys = np.arange(r0, r1, dtype=np.float32)
        bx = np.broadcast_to(xs[None, :], (r1 - r0, width)).reshape(-1)  # (P,)
        by = np.broadcast_to(ys[:, None], (r1 - r0, width)).reshape(-1)
        # (N, P) projection parameter
        t = ((bx[None] - x1[:, None]) * dx[:, None] + (by[None] - y1[:, None]) * dy[:, None]) / len2[:, None]
        tc = np.clip(t, 0.0, 1.0)
        qx = x1[:, None] + tc * dx[:, None]
        qy = y1[:, None] + tc * dy[:, None]
        d2 = (bx[None] - qx) ** 2 + (by[None] - qy) ** 2
        best = np.argmin(d2, axis=0)  # (P,)
        pidx = np.arange(bx.shape[0])
        tb = tc[best, pidx]
        fx = x1[best] + tb * dx[best]
        fy = y1[best] + tb * dy[best]
        sh = (r1 - r0, width)
        lmap[0, r0:r1] = (fx - bx).reshape(sh)
        lmap[1, r0:r1] = (fy - by).reshape(sh)
        lmap[2, r0:r1] = (x1[best] - bx).reshape(sh)
        lmap[3, r0:r1] = (y1[best] - by).reshape(sh)
        lmap[4, r0:r1] = (x2[best] - bx).reshape(sh)
        lmap[5, r0:r1] = (y2[best] - by).reshape(sh)
        labels[r0:r1] = best.reshape(sh).astype(np.int32)
    return lmap, labels


def attraction_support(
    lines: np.ndarray,
    height: int,
    width: int,
    distance_threshold: float = 10.0,
    backend: str = "native",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Support mask, closest-line labels and projection points: a pixel
    supports its closest segment iff its point-to-segment distance is
    within ``distance_threshold``.

    Returns (mask (H*W,) bool, labels (H*W,) int32, proj_points (H*W, 2)
    float32, zeros outside the mask).
    """
    lmap, labels = encode_line_attraction(lines, height, width, backend=backend)

    dismap = np.sqrt(lmap[0] ** 2 + lmap[1] ** 2)  # point-to-segment distance
    mask = dismap <= distance_threshold

    offsets = np.moveaxis(lmap[:2], 0, -1)  # (H, W, 2) (x, y)
    ys, xs = np.nonzero(mask)
    proj = np.zeros((height, width, 2), dtype=np.float32)
    proj[ys, xs] = offsets[ys, xs] + np.stack([xs, ys], axis=-1).astype(np.float32)

    return (
        mask.reshape(-1),
        labels.reshape(-1).astype(np.int32),
        proj.reshape(-1, 2),
    )
