"""Uncompressed BMP reading on numpy alone.

The JAX package reads scene images through imageio, whose Pillow backend
returns a 24- or 32-bit uncompressed (``BI_RGB``) BMP as RGB uint8: the
blue-green-red byte order swapped, the fourth byte of a 32-bit pixel
dropped, the rows put top first whether the file stores them bottom-up
(positive height) or top-down (negative height). ``read_bmp`` does the
same for the info headers of 40, 108 and 124 bytes. Every other BMP
(palette, 16-bit, bit fields, run-length or embedded JPEG/PNG
compression, the 12-byte OS/2 header) raises ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

_INFO_HEADERS = (40, 108, 124)  # BITMAPINFOHEADER, BITMAPV4HEADER, BITMAPV5HEADER
_BI_RGB = 0


def read_bmp(path) -> np.ndarray:
    """The pixels of a 24- or 32-bit BI_RGB BMP file as (H, W, 3) uint8 RGB,
    the top row first."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 18 or data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    (header,) = struct.unpack("<I", data[14:18])
    if header not in _INFO_HEADERS or len(data) < 14 + header:
        raise ValueError(f"{path}: a BMP info header of {header} bytes is not read ({_INFO_HEADERS} are)")
    width, height, _planes, bits, compression = struct.unpack("<iiHHI", data[18:34])
    if bits not in (24, 32) or compression != _BI_RGB:
        raise ValueError(
            f"{path}: a {bits}-bit BMP with compression {compression} is not read "
            "(24- and 32-bit uncompressed ones are)"
        )
    if width <= 0 or height == 0:
        raise ValueError(f"{path}: a BMP of {width} x {height} pixels")
    rows, bpp = abs(height), bits // 8
    stride = (width * bpp + 3) // 4 * 4  # rows are padded to 4 bytes
    if offset + rows * stride > len(data):
        raise ValueError(f"{path}: pixel data holds {len(data) - offset} bytes, expected {rows * stride}")
    px = np.frombuffer(data, dtype=np.uint8, count=rows * stride, offset=offset).reshape(rows, stride)
    img = px[:, : width * bpp].reshape(rows, width, bpp)[..., 2::-1]  # BGR(X) -> RGB
    if height > 0:  # bottom-up
        img = img[::-1]
    return np.ascontiguousarray(img)
