"""Checkpointing: full train-state snapshots with epoch tags (port of
neat_tpu/train/checkpoint.py).

One snapshot carries the parameters, Adam's moments and the step, so a
resume continues exactly. The payload is a pickle of host numpy arrays and
Python ints only, no torch object, so a tool can read it without torch or a
card::

    {"epoch": int, "state": {"params": {name: array}, "mu": {name: array},
                             "nu": {name: array}, "step": int}}

``name`` is the model's ``state_dict`` key (``implicit.lin0.v``). One file
per tag under ``checkpoints/`` (``{epoch}.ckpt`` and ``latest.ckpt``), and
a params-only ``ModelParameters/{tag}.npz`` whose keys are the JAX
package's export keys (``['implicit']['lin0']['v']``, ``['density'].beta``),
so a tool reads the export of either package.

Every file is written atomically (a temporary file in the same directory,
then ``os.replace``), so a kill mid-save leaves the earlier snapshot whole.
``load_checkpoint`` falls back from a truncated or missing ``latest.ckpt``
to the newest epoch tag that loads. ``load_model`` gives the snapshot's
model for finalize and the evaluations, through the runner's restore path.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import pickle
import re
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _atomic_write(path: str, write_fn) -> None:
    """Write via a same-directory tmp file + os.replace (atomic on POSIX)."""
    d = osp.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=osp.basename(path) + ".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def jax_key(name: str) -> str:
    """The JAX package's export key of a ``state_dict`` name: its parameter
    tree is nested dicts (``['implicit']['lin0']['v']``) except the density,
    a named tuple (``['density'].beta``)."""
    parts = name.split(".")
    if parts[0] == "density":
        return "['density']" + "".join(f".{p}" for p in parts[1:])
    return "".join(f"['{p}']" for p in parts)


def host_state(state) -> Dict[str, Any]:
    """The train state as host numpy arrays and ints (the payload's
    ``state``)."""
    names = [n for n, _ in state.model.named_parameters()]

    def host(t):
        return t.detach().cpu().numpy().copy()

    return {
        "params": {k: host(v) for k, v in state.model.state_dict().items()},
        "mu": {n: host(m) for n, m in zip(names, state.mu)},
        "nu": {n: host(v) for n, v in zip(names, state.nu)},
        "step": int(state.step),
    }


@torch.no_grad()
def restore_state(state, host: Dict[str, Any]) -> None:
    """Copy a payload's ``state`` into ``state`` in place, on its device."""
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in host["params"].items()}, strict=True)
    names = [n for n, _ in state.model.named_parameters()]
    if set(names) != set(host["mu"]) or set(names) != set(host["nu"]):
        raise ValueError("checkpoint moments do not name the model's parameters")
    for n, mu, nu in zip(names, state.mu, state.nu):
        mu.copy_(torch.from_numpy(host["mu"][n]))
        nu.copy_(torch.from_numpy(host["nu"][n]))
    state.step = int(host["step"])


def save_checkpoint(ckpt_dir: str, state, epoch: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    host = host_state(state)
    blob = pickle.dumps({"epoch": epoch, "state": host})
    for tag in (str(epoch), "latest"):
        _atomic_write(osp.join(ckpt_dir, f"{tag}.ckpt"), lambda f: f.write(blob))

    # params-only export under the JAX package's keys
    mp_dir = osp.join(ckpt_dir, "ModelParameters")
    os.makedirs(mp_dir, exist_ok=True)
    arrays = {jax_key(k): v for k, v in host["params"].items()}
    for tag in (str(epoch), "latest"):
        _atomic_write(osp.join(mp_dir, f"{tag}.npz"), lambda f: np.savez(f, **arrays))


def _read_ckpt(path: str) -> Tuple[Dict[str, Any], int]:
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return payload["state"], payload["epoch"]


def load_checkpoint(ckpt_dir: str, tag: str = "latest") -> Tuple[Dict[str, Any], int]:
    """Load a snapshot's (state, epoch); on a corrupt, truncated or missing
    file, fall back to the newest epoch tag that loads (a resume loses at
    most one save interval)."""
    path = osp.join(ckpt_dir, f"{tag}.ckpt")
    try:
        return _read_ckpt(path)
    except (
        FileNotFoundError,
        pickle.UnpicklingError,
        EOFError,
        ValueError,
        MemoryError,
    ) as e:
        # FileNotFoundError: a kill between the epoch-tag write and the
        # latest-tag write leaves the numeric tag as the newest snapshot
        first_err = e
    epochs = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"(\d+)\.ckpt", name)
        if m:
            epochs.append(int(m.group(1)))
    for ep in sorted(epochs, reverse=True):
        cand = osp.join(ckpt_dir, f"{ep}.ckpt")
        if osp.abspath(cand) == osp.abspath(path):
            continue
        try:
            state, epoch = _read_ckpt(cand)
        except (pickle.UnpicklingError, EOFError, ValueError, MemoryError):
            continue
        logger.warning("checkpoint %s is corrupt (%s); resumed from %s instead", path, first_err, cand)
        return state, epoch
    raise RuntimeError(
        f"checkpoint {path} is corrupt ({first_err}) and no earlier "
        f"epoch tag in {ckpt_dir} loads cleanly"
    )


def load_model(ckpt_dir: str, tag: str, cfg, device="cuda"):
    """(model, epoch) of a snapshot for the tools that read a trained run
    (finalize, render eval): ``init_neat`` of the model config ``cfg`` on
    ``device``, the snapshot restored into it as the runner restores a
    resume (``restore_state``), its parameters frozen. A CUDA device that
    is not there raises, as the runner does."""
    from ..model.neat import init_neat
    from .step import init_train_state

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (device='cpu') for the CPU")
    host, epoch = load_checkpoint(ckpt_dir, tag)
    state = init_train_state(init_neat(cfg, device=device))
    restore_state(state, host)
    return state.model.requires_grad_(False), epoch


def sweep_checkpoint(expdir: str, checkpoint: str = "latest") -> Optional[str]:
    """The timestamp directory under ``expdir`` that holds the requested
    checkpoint; None when none does, and an error when several do."""
    candidates = sorted(Path(expdir).glob(f"*/checkpoints/{checkpoint}.ckpt"))
    if len(candidates) > 1:
        raise RuntimeError(
            "multiple timestamps contain checkpoint "
            f"{checkpoint}: {[c.parts[-3] for c in candidates]}"
        )
    if not candidates:
        return None
    return str(candidates[0].parent.parent.name)
