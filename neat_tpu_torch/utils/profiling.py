"""NaN debugging (port of ``enable_nan_debugging`` of
neat_tpu/utils/profiling.py).

The JAX package turns on ``jax_debug_nans``: a NaN made inside a jitted
function raises ``FloatingPointError``. The port's counterpart is a check
in the training step: with NaN debugging on, the step tests its loss and
every gradient before the update and raises ``FloatingPointError`` naming
the step and the first tensor that is not finite. The test costs one host
sync a step, so it runs only while the switch is on; like
``jax_debug_nans``, the switch holds for the whole process.
"""

from __future__ import annotations

from typing import Sequence

import torch

_debug_nans = False


def enable_nan_debugging(enabled: bool = True) -> bool:
    """Turn the training step's finite check on (or off); returns the
    previous setting, for a caller that restores it."""
    global _debug_nans
    previous, _debug_nans = _debug_nans, bool(enabled)
    return previous


def nan_debugging_enabled() -> bool:
    return _debug_nans


def check_finite(step: int, names: Sequence[str], tensors: Sequence[torch.Tensor]) -> None:
    """Raise ``FloatingPointError`` naming ``step`` and the first of
    ``tensors`` that holds a NaN or an infinity. One host sync when all are
    finite."""
    finite = torch.stack([torch.isfinite(t).all() for t in tensors])
    if bool(finite.all()):
        return
    first = int(torch.nonzero(~finite)[0, 0])
    raise FloatingPointError(f"step {step}: {names[first]} is not finite (NaN debugging is on)")
