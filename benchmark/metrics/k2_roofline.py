"""K2, the main field pass forward and backward as one function: the least
time of its calls (``work.k2_macs`` / ``k2_bytes`` at ``rays x (n_samples
+ n_samples_extra + 2)`` points a call) over the summed device time of
its kernels by function name: the forward; the backward's row-local pass
with the reduction of its bias partials, and its weight GEMM with the
reduction of its split partials. In percent."""

LAYER = "kernels (ops/, csrc/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_rays_per_sec"
FORWARD = "field_fwd_mma"
KERNELS = (FORWARD, "field_bwd_mma", "bias_reduce", "dw_gemm", "dw_reduce")


def read(ctx):
    if ctx["trace"] is None:
        return None
    w, model = ctx["work"], ctx["model"]
    by = ctx["trace"]["by_function"]
    calls = by.get(FORWARD, (0.0, 0))[1]
    seconds = sum(by.get(k, (0.0, 0))[0] for k in KERNELS)
    if not calls or seconds <= 0:
        return None
    s = model["sampler"]
    points = ctx["n_rays"] * (s["n_samples"] + s["n_samples_extra"] + 2)
    fwd, bwd = w.k2_macs(model)
    bound, _ = w.bound_s(2.0 * (fwd + bwd) * points, w.k2_bytes(model, points))
    return 100.0 * calls * bound / seconds
