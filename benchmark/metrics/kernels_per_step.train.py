"""The device's kernels a step in the traced slice."""

LAYER = "device (H100)"
UNIT = "count"
SOURCE = "device_trace"
MOVES = "train_rays_per_sec"


def read(ctx):
    t = ctx["trace"]
    return t["kernels"] / ctx["trace_steps"] if t is not None and t["kernels"] else None
