"""Input chunking for full-image evaluation (port of
neat_tpu/utils/chunking.py, numpy only).

Parity target: reference code/utils/general.py:23-52 (split_input /
merge_output) — split the per-pixel arrays of a model-input dict into
fixed-size chunks and merge the per-chunk outputs back. The last chunk is
edge-padded, as in the JAX package, so every chunk has one shape and a
render's chunks equal the JAX package's chunk for chunk.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def split_input(
    model_input: Dict[str, np.ndarray],
    total_pixels: int,
    n_pixels: int = 10000,
    keys: Sequence[str] = ("uv", "uv_proj"),
    pad: bool = True,
) -> List[Dict[str, np.ndarray]]:
    """Split per-pixel entries of ``model_input`` into chunks of n_pixels.

    Entries not in ``keys`` are carried through unchanged. With ``pad``,
    the last chunk is edge-padded to n_pixels and carries '_valid' with
    the real count.
    """
    out = []
    for c0 in range(0, total_pixels, n_pixels):
        c1 = min(c0 + n_pixels, total_pixels)
        data = {}
        for k, v in model_input.items():
            if k in keys and hasattr(v, "shape") and v.shape[0] >= total_pixels:
                chunk = v[c0:c1]
                if pad and c1 - c0 < n_pixels:
                    width = [(0, n_pixels - (c1 - c0))] + [(0, 0)] * (chunk.ndim - 1)
                    chunk = np.pad(chunk, width, mode="edge")
                data[k] = chunk
            else:
                data[k] = v
        data["_valid"] = c1 - c0
        out.append(data)
    return out


def merge_output(res: List[Dict[str, np.ndarray]], total_pixels: int) -> Dict[str, np.ndarray]:
    """Concatenate per-chunk output dicts, trimming any padding."""
    merged: Dict[str, np.ndarray] = {}
    for key in res[0]:
        if key == "_valid":
            continue
        parts = []
        for chunk in res:
            v = np.asarray(chunk[key])
            parts.append(v[: chunk.get("_valid", v.shape[0])])
        merged[key] = np.concatenate(parts, axis=0)[:total_pixels]
    return merged
