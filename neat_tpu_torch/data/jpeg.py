"""JPEG views: a baseline decoder on the host (``csrc/jpeg.cpp``).

Its 8-bit samples equal what the JAX package's loader gets from imageio
-> Pillow -> libjpeg-turbo (islow IDCT, fancy upsampling, integer YCbCr
to RGB), bit for bit: sequential Huffman files (SOF0, SOF1 with 8-bit
samples), 8- and 16-bit quantization tables, restart intervals, gray or
three components, interleaved or one scan per component. EXIF orientation
is not applied, as imageio does not apply it either. Progressive,
arithmetic-coded, lossless and hierarchical files, 12-bit samples and
4-component (CMYK/YCCK) files raise ``NotImplementedError``; there is no
other decoder to hand them to.

The source is compiled by ``g++`` on first use into ``build/host/`` at the
root of the checkout and loaded through ``ctypes``; a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "jpeg.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
_LIB_PATH = _BUILD_DIR / "libjpegdec.so"
_GXX_FLAGS = ("-O2", "-shared", "-fPIC")
_lib: Optional[ctypes.CDLL] = None  # loaded once per process

UNSUPPORTED, MALFORMED = 1, 2


def build_native() -> ctypes.CDLL:
    """Compile ``csrc/jpeg.cpp`` when its library is missing or older than
    the source, load it and return it. Raises with g++'s output when the
    build fails."""
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = _BUILD_DIR / f".libjpegdec.{os.getpid()}.so"
        cmd = ["g++", *_GXX_FLAGS, str(_SRC), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"jpeg decoder: no g++ to build {_SRC} ({e})") from e
        if proc.returncode != 0:
            raise RuntimeError(f"jpeg decoder: g++ failed\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, _LIB_PATH)  # atomic: another process may load it at once
    lib = ctypes.CDLL(str(_LIB_PATH))
    args = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_header.argtypes = args
    lib.jpeg_decode.argtypes = args
    lib.jpeg_header.restype = lib.jpeg_decode.restype = ctypes.c_int
    _lib = lib
    return lib


def _check(rc: int, msg, path: str) -> None:
    text = msg.value.decode(errors="replace")
    if rc == UNSUPPORTED:
        raise NotImplementedError(
            f"{path}: a JPEG of a kind this package does not decode: {text} (ROADMAP.md §1, data); "
            "it reads sequential Huffman files with 8-bit samples and 1 or 3 components"
        )
    if rc != 0:
        raise ValueError(f"{path}: not a JPEG file this decoder can read: {text}")


def decode_jpeg(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """uint8 samples of a JPEG file's bytes: (H, W) gray or (H, W, 3) RGB."""
    lib = build_native()
    msg = ctypes.create_string_buffer(256)
    dims = np.zeros(3, np.int32)
    _check(lib.jpeg_header(data, len(data), dims.ctypes.data, msg, len(msg)), msg, path)
    h, w, c = (int(v) for v in dims)
    out = np.empty((h, w, c) if c > 1 else (h, w), np.uint8)
    _check(lib.jpeg_decode(data, len(data), out.ctypes.data, msg, len(msg)), msg, path)
    return out


def read_jpeg(path: str) -> np.ndarray:
    """The samples of a JPEG file, as the JAX package's imageio read returns them."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
