"""The traced slice: ``torch.profiler`` over a few steps of the window,
its Chrome trace read back into device and host time.

* busy: the union of the device's kernel, copy and set intervals (a
  scope's range on the device's timeline, ``gpu_user_annotation``, spans
  its kernels and is left out);
* by kernel: each kernel name's device seconds and launches; by
  function, the same by the kernel's own function name
  (``kernel_function``);
* by scope: the host seconds inside each program scope
  (``user_annotation``), and the device seconds of the kernels whose
  launch (``cuda_runtime``, matched by ``correlation``) falls inside it;
* idle gaps: each stretch with no device work, charged to what the host
  was doing when it ended: the scope and host operator that launched the
  next kernel (``backward`` on the autograd engine's thread).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(events: List[dict], times: List[float]) -> List[str]:
    """For each query time (sorted), the name of the innermost of the
    (properly nested) events that contains it, or ""."""
    evs = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(evs) and evs[i]["ts"] <= t:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= evs[i]["ts"]:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
            stack.pop()
        out.append(stack[-1]["name"] if stack else "")
    return out


def kernel_function(name: str) -> str:
    """A trace's kernel name without its return type, namespaces, template
    arguments and parameters: ``void ns::f<4>(int)`` -> ``f``."""
    name = name.replace("(anonymous namespace)::", "").split("(", 1)[0].split("<", 1)[0]
    return name.split()[-1].split("::")[-1] if name.strip() else ""


def summarise(events: List[dict]) -> dict:
    """What the metric readers read from one trace's events."""
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in device if e["cat"] == "kernel"]
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    by_kernel: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    by_function: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        for d, k in ((by_kernel, e["name"]), (by_function, kernel_function(e["name"]))):
            d[k][0] += e["dur"] / 1e6
            d[k][1] += 1

    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    scopes = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    scope_host: Dict[str, float] = defaultdict(float)
    for e in scopes:
        scope_host[e["name"]] += e["dur"] / 1e6
    main_tid = max({e["tid"] for e in scopes}, key=lambda t: sum(1 for e in scopes if e["tid"] == t)) \
        if scopes else None

    # each kernel's launch: (host time, thread), in kernel order
    launches = [(runtime[e["args"]["correlation"]]["ts"], runtime[e["args"]["correlation"]]["tid"])
                if e.get("args", {}).get("correlation") in runtime else (None, None) for e in kernels]
    by_tid: Dict[object, List[Tuple[float, int]]] = defaultdict(list)
    for i, (ts, tid) in enumerate(launches):
        if ts is not None:
            by_tid[tid].append((ts, i))
    scope_of = [""] * len(kernels)
    op_of = [""] * len(kernels)
    for tid, pts in by_tid.items():
        pts.sort()
        times = [t for t, _ in pts]
        sc = _innermost([e for e in scopes if e["tid"] == tid], times)
        op = _innermost([e for e in ops if e["tid"] == tid], times)
        for (_, i), s, o in zip(pts, sc, op):
            scope_of[i] = s if tid == main_tid else "backward"
            op_of[i] = o
    scope_device: Dict[str, float] = defaultdict(float)
    for e, s in zip(kernels, scope_of):
        scope_device[s] += e["dur"] / 1e6

    # idle gaps, charged to the launch that ended them
    order = sorted(range(len(kernels)), key=lambda i: kernels[i]["ts"])
    starts = [kernels[i]["ts"] for i in order]
    gaps: Dict[str, float] = defaultdict(float)
    for (s0, e0), (s1, _) in zip(busy, busy[1:]):
        j = bisect.bisect_left(starts, s1)
        i = order[j] if j < len(order) else None
        name = "unknown" if i is None else f"{scope_of[i] or 'no scope'}/{op_of[i] or 'no op'}"
        gaps[name] += (s1 - e0) / 1e6
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "kernels": len(kernels),
        "by_kernel": {k: (v[0], v[1]) for k, v in by_kernel.items()},
        "by_function": {k: (v[0], v[1]) for k, v in by_function.items()},
        "scope_host_s": dict(scope_host),
        "scope_device_s": dict(scope_device),
        "idle_gaps_s": dict(gaps),
    }


def trace_steps(run_steps, device, tmp_dir: str = None) -> dict:
    """Profile ``run_steps()`` and summarise its trace, with ``window_s``,
    the host seconds from the profiler's start to the device's last work;
    the trace file lives in the temporary directory until it is read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else []))
    sync()
    prof.start()
    t0 = time.perf_counter()
    try:
        run_steps()
    finally:
        sync()
        window_s = time.perf_counter() - t0
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmp_dir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return dict(summarise(events), window_s=window_s)


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
