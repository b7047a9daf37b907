"""The device's ms a step in the kernels launched inside the program's
``junction_match`` scope (the assignment of the 2D junctions)."""

LAYER = "junction assignment (assignment/matching.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_rays_per_sec"


def read(ctx):
    if ctx["trace"] is None:
        return None
    s = ctx["trace"]["scope_device_s"].get("junction_match")
    return None if not s else 1e3 * s / ctx["trace_steps"]
