"""PNG reading and writing on ``zlib`` and numpy alone.

The JAX package reads and writes scene images through imageio; the port
needs no image library. ``read_png`` decodes non-interlaced PNGs of 8- or
16-bit samples in gray, gray with alpha, RGB or RGBA, with any of the five
scanline filters, and returns the samples as stored: uint8, or uint16 for
16-bit files. (For 16-bit RGB or RGBA, imageio's Pillow backend keeps only
the high byte of each sample; this reader keeps all 16 bits.) Palette PNGs
(1-, 2-, 4- or 8-bit indices) come back as imageio gives them: each index
looked up in ``PLTE``, RGB uint8, any ``tRNS`` transparency dropped. Every
other PNG (gray below 8 bits, interlaced) and every damaged file raises
``ValueError``. ``write_png`` writes 8-bit RGB with filter 0 on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples per pixel
_PALETTE = 3


def _chunks(data: bytes, path):
    """(type, body) of every chunk, each one's CRC checked."""
    pos = len(_SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated chunk header at byte {pos}")
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: CRC mismatch in the {kind!r} chunk")
        yield kind, body
        pos += 12 + length


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, path) -> np.ndarray:
    """Undo the per-row filters; returns (height, stride) uint8."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, expected {height * (stride + 1)}")
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:  # None
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum, mod 256, of each of the bpp byte lanes
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind == 3:  # Average: floor((left + up) / 2), left already decoded
            buf = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                left = buf[i - bpp] if i >= bpp else 0
                buf[i] = (buf[i] + ((left + up[i]) >> 1)) & 0xFF
            cur = np.frombuffer(bytes(buf), dtype=np.uint8)
        elif kind == 4:  # Paeth
            buf = bytearray(line.tobytes())
            _paeth_row(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), dtype=np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}, PNG defines 0-4")
        out[y] = cur
        prev = out[y]
    return out


def _palette_indices(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """(H, stride) packed rows of ``depth``-bit indices -> (H, W) indices,
    the most significant bits first, as PNG packs them."""
    if depth == 8:
        return rows[:, :width]
    per_byte = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # e.g. 6, 4, 2, 0 for 2-bit
    unpacked = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return unpacked.reshape(rows.shape[0], rows.shape[1] * per_byte)[:, :width]


def read_png(path) -> np.ndarray:
    """The samples of a PNG file: (H, W) for gray, (H, W, 2|3|4) for gray
    with alpha|RGB|RGBA; uint8 for 8-bit files, uint16 for 16-bit ones; a
    palette file as its colors, (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat, palette = None, [], None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3:
                raise ValueError(f"{path}: a PLTE chunk of {len(body)} bytes")
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    width, height, depth, color, compression, filtering, interlace = header
    if color not in _CHANNELS:
        raise ValueError(
            f"{path}: PNG color type {color} is not read (gray 0, RGB 2, palette 3, gray-alpha 4, RGBA 6 are)"
        )
    depths = (1, 2, 4, 8) if color == _PALETTE else (8, 16)
    if depth not in depths:
        raise ValueError(f"{path}: bit depth {depth} is not read for color type {color} ({depths} are)")
    if compression != 0 or filtering != 0 or interlace != 0:
        raise ValueError(
            f"{path}: compression {compression}, filter method {filtering}, interlace {interlace}: "
            "only 0, 0, 0 is read"
        )
    if color == _PALETTE and palette is None:
        raise ValueError(f"{path}: a palette image with no PLTE chunk")
    channels = _CHANNELS[color]
    bpp = max(channels * depth // 8, 1)  # filters work on whole bytes
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: image data does not inflate ({e})") from e
    rows = _unfilter(raw, height, (width * channels * depth + 7) // 8, bpp, path)
    if color == _PALETTE:
        idx = _palette_indices(rows, width, depth)
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: an index {int(idx.max())} past the {len(palette)}-color palette")
        return palette[idx]
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16)
    else:
        img = rows
    img = img.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path, img: np.ndarray) -> None:
    """Write uint8 (H, W, 3) as an 8-bit RGB PNG, every row with filter 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"write_png writes uint8 (H, W, 3), got {img.dtype} {img.shape}")
    height, width = img.shape[:2]
    rows = np.zeros((height, 1 + width * 3), dtype=np.uint8)  # filter byte 0
    rows[:, 1:] = img.reshape(height, -1)
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
