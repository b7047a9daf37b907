"""The whole step's model FLOPs (``work.step_flops``: the sampler's
proposals, the field pass forward and backward, the eikonal and surface
points, the junction decoder; no recomputation) over the host's seconds a
step in the window and the dense bf16 peak, in percent."""

LAYER = "whole step (train/step.py)"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_rays_per_sec"


def read(ctx):
    if not ctx["host_step_s"] or ctx["trace"] is None or not ctx["trace"]["kernels"]:  # no device ran: nothing to read
        return None
    w = ctx["work"]
    flops = sum(w.step_flops(ctx["model"], ctx["n_rays"]).values())
    return 100.0 * flops / (ctx["host_step_s"] * w.PEAK_FLOPS)
