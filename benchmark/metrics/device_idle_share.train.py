"""The share of the traced slice's wall time in which the device ran no
kernel, copy or set, in percent."""

LAYER = "device (H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_rays_per_sec"


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["kernels"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
