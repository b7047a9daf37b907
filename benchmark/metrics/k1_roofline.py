"""K1, the sampler's proposal SDF: the least time its launches could take
(``work.k1_macs`` / ``k1_bytes`` at ``rays x n_samples_eval`` points a
launch, against the bf16 peak and the memory rate) over their device
time by the kernel's function name, in percent."""

LAYER = "kernels (ops/, csrc/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_rays_per_sec"
KERNEL = "fused_sdf_mma"


def read(ctx):
    w, model = ctx["work"], ctx["model"]
    if ctx["trace"] is None:
        return None
    seconds, launches = ctx["trace"]["by_function"].get(KERNEL, (0.0, 0))
    if not launches or seconds <= 0:
        return None
    points = ctx["n_rays"] * model["sampler"]["n_samples_eval"]
    bound, _ = w.bound_s(2.0 * w.k1_macs(model) * points, w.k1_bytes(model, points))
    return 100.0 * launches * bound / seconds
