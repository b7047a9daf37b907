"""The host's ms a step (the window's untraced steps) less the device's
busy ms a step (the traced slice): the time the host adds to the step."""

LAYER = "step driver (train/step.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_rays_per_sec"


def read(ctx):
    t = ctx["trace"]
    if not ctx["host_step_s"] or t is None or not t["kernels"]:
        return None
    return 1e3 * (ctx["host_step_s"] - t["busy_s"] / ctx["trace_steps"])
