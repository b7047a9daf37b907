"""The host's ms a step inside the program's ``sampler`` scope, in the
traced slice (the profiler's own cost included)."""

LAYER = "sampler (sampling/samplers.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_rays_per_sec"


def read(ctx):
    s = ctx["host_spans_s"].get("sampler")
    return None if s is None else 1e3 * s / ctx["trace_steps"]
