"""The weight bridge from ``neat_tpu`` to this package.

``params_from_jax`` turns a ``neat_tpu`` parameter tree, given as numpy
arrays (nested dicts; the density as ``{"beta": ...}`` or any object with
``_asdict``), into a ``state_dict`` for ``model.neat.NeatModel``: the
module and parameter names are the tree's keys joined with dots, e.g.
``implicit.lin0.v`` or ``junctions.ffn.lin2.w``. It works from numpy only
and imports nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_jax(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a nested parameter tree into a ``state_dict``."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out: Dict[str, torch.Tensor] = {}
        for k, v in tree.items():
            out.update(params_from_jax(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: torch.as_tensor(np.array(tree))}
