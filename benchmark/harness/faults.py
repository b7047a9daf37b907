"""Faults planted in the program, to show that the check catches them
(the calibration tool and the CPU tests; no benchmark run plants one).
Each is a context manager that patches a name of ``train/step.py`` and
puts it back:

* ``unchanged``: the step returns its state unchanged (no Adam update);
* ``half_batch``: the forward and the loss see the first half of the
  batch's rays only, the means taken over them;
* ``altered``: one gradient comes out altered where the backward makes
  it: the first colour layer's weight direction, doubled;
* ``gathered``: the matched local junctions come out of the forward each
  taking the next junction's proposal (a gather off by one row);
* ``means``: DBSCAN's cluster means come out rounded to bfloat16 (only
  where the configuration clusters).
"""

from __future__ import annotations

import contextlib

import torch

ALTERED_LEAF = "rendering.lin0.v"


@contextlib.contextmanager
def _patched(name: str, make):
    import neat_tpu_torch.train.step as S

    original = getattr(S, name)
    setattr(S, name, make(original))
    try:
        yield
    finally:
        setattr(S, name, original)


def unchanged():
    return _patched("adam_update", lambda orig: (lambda state, grads, lr_t: None))


def half_batch():
    ray_keys = ("uv", "uv_proj")
    truth_keys = ("rgb", "lines2d", "depth")

    def make(orig):
        def forward_and_loss(model, inputs, ground_truth, *args, **kwargs):
            # in place: the step's own metrics read the same halves
            half = inputs["uv"].shape[0] // 2
            inputs.update({k: v[:half] for k, v in inputs.items() if k in ray_keys})
            ground_truth.update({k: v[:half] for k, v in ground_truth.items() if k in truth_keys})
            return orig(model, inputs, ground_truth, *args, **kwargs)
        return forward_and_loss

    return _patched("forward_and_loss", make)


def altered():
    def make(orig):
        def loss_and_grads(model, *args, **kwargs):
            out, losses, grads = orig(model, *args, **kwargs)
            names = [n for n, _ in model.named_parameters()]
            i = names.index(ALTERED_LEAF)
            return out, losses, [g * 2.0 if j == i else g for j, g in enumerate(grads)]
        return loss_and_grads

    return _patched("loss_and_grads", make)


def gathered():
    keys = ("j3d_local", "j2d_local", "j2d_local_calib")

    def make(orig):
        def forward(*args, **kwargs):
            out = orig(*args, **kwargs)
            out.update({k: torch.roll(out[k], 1, 0) for k in keys if k in out})
            return out
        return forward

    return _patched("neat_forward", make)


@contextlib.contextmanager
def means():
    import neat_tpu_torch.model.neat as N

    orig = N.dbscan_cluster_means

    def rounded(*args, **kwargs):
        m, valid = orig(*args, **kwargs)
        return m.to(torch.bfloat16).to(m.dtype), valid

    N.dbscan_cluster_means = rounded
    try:
        yield
    finally:
        N.dbscan_cluster_means = orig


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered, "gathered": gathered,
          "means": means}
