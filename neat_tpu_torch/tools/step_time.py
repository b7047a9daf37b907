"""Time the main path's bench step (``utils/benchscene.py``: abc-neat-a at
full width, bf16, K1 x5 and the split K2) in the checkout it runs from:
25 steps, the median and quartiles of the last 20 by the host clock (each
step ends in a sync), then the device kernels and device ms a step by
``torch.profiler`` over 2 steps. Two checkouts are compared by running it
in each, in turns, in one call on one card.

Run from a checkout's root on a machine with a CUDA card and nvcc:

    python3 -m neat_tpu_torch.tools.step_time [label]
"""

from __future__ import annotations

import statistics
import sys
import time

import torch


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("step_time: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from neat_tpu_torch.ops import _build
    from neat_tpu_torch.utils.benchscene import bench_config, bench_scene, bench_step

    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    _build.build_all(("fused_sdf", "field_fwd_mma", "fused_field_stash", "field_dw_mma", "field_bwd_mma"))
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = bench_config("bfloat16", device="cuda")
    scene = bench_scene(cfg, device="cuda")
    step, state = bench_step(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms = []
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, scene, gen)
        float(m["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            state, m = step(state, scene, gen)
        torch.cuda.synchronize()
    cuda = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernels = sum(e.count for e in cuda) / 2
    busy = sum(e.self_device_time_total for e in cuda) / 2e3
    q = statistics.quantiles(ms[5:], n=4)
    print(f"{label}: median {statistics.median(ms[5:]):.2f} ms/step (quartiles {q[0]:.2f} .. {q[2]:.2f}); "
          f"{kernels:.0f} device kernels and {busy:.2f} device ms a step", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
