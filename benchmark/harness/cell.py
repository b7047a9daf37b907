"""One run of one cell: set-up, the first three steps that the check
follows, the measured window, the traced slice, the check, the result.

Set-up (``setup_s``, from the process's start to the first timed step):
the conf and the kernels as the runner takes them, the weights and the
scene from the seed on the device, then steps 0-2 through the window's
own call on the runner's per-step generators. Those steps warm every
shape the window uses (one batch size, one scene) and are the steps the
reference follows. The window then runs steps back to back, closed loop,
for ``--seconds``: a step is timed from its start to the start of the
next, the last one to the closing ``torch.cuda.synchronize()``.

With ``--trace 1`` the profiler takes ``TRACE_STEPS`` steps from the
window's middle, and the per-layer metrics are read from them and from the
window; the window's other steps give the host's time a step.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import sys
import time
import traceback
from typing import Dict, List, Optional

import torch

from . import check, imports, inputs, manifest, program, trace, work

CHECKED_STEPS = 3
TRACE_STEPS = 3
TRACE_ATTEMPTS = 3
# the kernel wrappers' launch counters (ops/work.py) -> the function each
# kernel has in a trace
TRACED_KERNELS = {"fused_sdf": "fused_sdf_mma", "field_fwd_stash": "field_fwd_mma",
                  "field_bwd_rowlocal": "field_bwd_mma", "field_dw": "dw_gemm"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Window:
    step_s: List[float]  # each step's seconds
    traced: List[bool]  # whether the profiler ran over the step
    wall_s: float
    failed: int
    losses: List[torch.Tensor]


def run_window(step, state, scene, seed: int, seconds: float, device, on_trace=None) -> Window:
    """Closed-loop steps for ``seconds``. With ``on_trace``, once half the
    window has passed (or at its end, if no step started after that),
    ``on_trace(one_step)`` runs some steps under the profiler and returns
    how many; they are timed together."""
    times, traced, losses = [], [], []
    failed = 0

    def one():
        nonlocal failed, state
        try:
            state, metrics = step(state, scene, program.step_generator(seed, state.step, device))
            losses.append(metrics["loss"])
        except Exception:  # a failing step counts as failed; the window goes on
            failed += 1
            log(traceback.format_exc())
            state.step += 1

    t_start = time.perf_counter()
    t = t_start
    while t - t_start < seconds or on_trace is not None:
        if on_trace is not None and t - t_start >= seconds / 2:
            n = on_trace(one)
            on_trace = None
            t_next = time.perf_counter()
            times += [(t_next - t) / n] * n
            traced += [True] * n
            t = t_next
            continue
        one()
        t_next = time.perf_counter()
        times.append(t_next - t)
        traced.append(False)
        t = t_next
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    times[-1] += t_end - t
    return Window(step_s=times, traced=traced, wall_s=t_end - t_start, failed=failed, losses=losses)


def p90(values: List[float]) -> float:
    """The 90th percentile (``statistics.quantiles``, exclusive method)."""
    return statistics.quantiles(values, n=10)[-1] if len(values) > 1 else values[0]


def process_age_s() -> Optional[float]:
    """Seconds since this process started, by the kernel's clock."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def card_line(device) -> dict:
    """The card's name, the device count and the power limit."""
    import subprocess

    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             check=True, capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
        limit = out[device.index or 0].strip() if out else None
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"name": name, "count": torch.cuda.device_count(), "power_limit": limit}


@dataclasses.dataclass
class Prepared:
    """A cell's program and inputs for one seed."""

    n_rays: int
    exp: object  # the conf as the runner loads it
    step: object
    model_cfg: object
    weights: Dict[str, torch.Tensor]
    scene: Dict[str, torch.Tensor]
    state: object
    config: dict


def prepare(root: str, cell, seed: int, device, step=None) -> Prepared:
    """The conf and the step as the runner builds them (``step``: one built
    already, for another seed), the weights and the scene from ``seed``,
    and the program's state holding the weights."""
    cfg = cell.config
    scene_cfg = cfg["scene"]
    n_rays = int(cell.mix["rays_per_step"])
    exp = program.load_experiment(cfg, n_rays, root)
    built, model_cfg = program.build_step(exp, scene_cfg["views"], device)
    weights = inputs.make_weights(cfg["model"], seed, device)
    scene = inputs.make_scene(scene_cfg, scene_cfg["img_res"], cfg["model"]["max_verts"], seed, device)
    state = program.build_state(model_cfg, weights, device)
    return Prepared(n_rays, exp, step or built, model_cfg, weights, scene, state, cfg)


def first_steps(run: Prepared, seed: int, device):
    """Steps 0-2 through the window's own call on the runner's generators,
    their junction stages recorded. -> (the state, (each step's loss terms,
    the first moment after step 0, the parameters after step 2), the
    records)."""
    state, losses, moment1, records, took = run.state, [], None, [], []
    with program.recording(records):
        for i in range(CHECKED_STEPS):
            t = time.perf_counter()
            state, metrics = run.step(state, run.scene, program.step_generator(seed, state.step, device))
            losses.append(metrics)
            if i == 0:
                moment1 = program.first_moment(state)
            took.append(time.perf_counter() - t)
    log(f"the checked steps (recorded) took {', '.join(f'{t:.3f}' for t in took)} s")
    params3 = program.params_of(state)
    return state, ([{k: float(v) for k, v in m.items()} for m in losses], moment1, params3), records


def reference_steps(run: Prepared, seed: int, follow=None, prec=None, record=None, stages=None):
    """The reference's three steps from the same weights and draws, taking
    the depths and junction decisions of ``follow`` (records); ``record``
    and ``stages`` as ``neat_ref.run_steps``. -> (loss terms, first
    gradients, parameters after step 2)."""
    from reference import neat_ref

    scene_cfg = run.config["scene"]
    dev = run.scene["rgb"].device
    if follow is not None:
        follow = [{k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in r.items()} for r in follow]
    return neat_ref.run_steps(run.weights, run.scene, scene_cfg["img_res"][1],
                              neat_ref.RefConfig.from_file(run.config), run.n_rays, seed, CHECKED_STEPS,
                              run.exp.nepochs * scene_cfg["views"], prec or neat_ref.F32, follow, record, stages)


def checked_numbers(run: Prepared, seed: int, prog, records) -> dict:
    """``check.compare`` of a run's first three steps against the reference
    following its depths and junction decisions, with the stage checks;
    every number infinite where the reference cannot follow."""
    from reference import neat_ref

    stages, ref_records = {}, []
    try:
        ref = reference_steps(run, seed, records, record=ref_records, stages=stages)
    except neat_ref.CannotFollow as e:
        log(f"the reference cannot follow the program: {e}")
        return check.unfollowable()
    dev = run.scene["rgb"].device
    numbers = check.compare(*prog, *ref, run.weights)
    numbers["junctions"] = check.junction_mismatches(records, run.config, dev)
    numbers["proposals"] = check.proposal_gap(records, ref_records)
    numbers.update(check.stage_numbers(records, stages, run.weights, run.config, dev))
    return numbers


def run_cell(root: str, name: str, seed: int, seconds: float, traced: bool, device="cuda", t0: float = None,
             require_card: bool = True) -> dict:
    """One run; returns the result line's object. ``require_card=False``
    (the CPU tests) skips the look for a card."""
    device = torch.device(device)
    cell = manifest.load_cell(root, name)
    if require_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{name} needs {cell.chips} CUDA device(s); "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    bad = imports.reference_violations(os.path.join(os.path.dirname(os.path.dirname(__file__)), "reference"))
    if bad:
        raise SystemExit(f"the reference imports what it may not: {bad}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the program's own default, held

    clock = (lambda: process_age_s()) if t0 is None else (lambda: time.perf_counter() - t0)
    marks = [("start", clock())]
    if device.type == "cuda":
        torch.empty(1, device=device)
    marks.append(("context", clock()))
    run = prepare(root, cell, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("inputs", clock()))
    state, prog, records = first_steps(run, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = clock()
    marks.append(("first steps", setup_s))
    log(f"set-up {setup_s:.3f} s ({', '.join(f'{k} by {v:.3f}' for k, v in marks)}); the window starts")
    cfg, scene_cfg, n_rays, step, scene = cell.config, cell.config["scene"], run.n_rays, run.step, run.scene

    counters0 = program.counters()
    slices = []

    def on_trace(one):
        # a slice whose hand-kernel launches the trace does not all show is
        # taken again, up to TRACE_ATTEMPTS slices in all
        for attempt in range(TRACE_ATTEMPTS):
            before = program.kernel_launches()
            summary = trace.trace_steps(lambda: [one() for _ in range(TRACE_STEPS)], device,
                                       os.environ.get("TMPDIR"))
            after = program.kernel_launches()
            counted = {k: after[k] - before[k] for k in TRACED_KERNELS}
            seen = {k: summary["by_function"].get(v, (0.0, 0))[1] for k, v in TRACED_KERNELS.items()}
            summary["complete"] = counted == seen
            slices.append(summary)
            if summary["complete"]:
                break
            log(f"the trace dropped launches ({seen} traced, {counted} counted)"
                + (": the slice is taken again" if attempt + 1 < TRACE_ATTEMPTS else ""))
        return TRACE_STEPS * len(slices)

    win = run_window(step, state, scene, seed, seconds, device, on_trace if traced else None)
    window_counts = {k: v - counters0[k] for k, v in program.counters().items()}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    found = imports.forbidden_loaded()
    if found:
        raise SystemExit(f"loaded once the window closed: {found}")
    if device.type == "cuda":  # read after the window: nvidia-smi is no part of set-up
        log(f"card: {card_line(device)}")

    # a step whose loss is not finite has failed; read once the window has closed
    n_bad = win.failed + (int((~torch.isfinite(torch.stack(win.losses))).sum()) if win.losses else 0)
    attempted = len(win.step_s)

    # the program's state goes before the reference runs
    del state, step, run.state, run.step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = checked_numbers(run, seed, prog, records)
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    checks = check.judge(numbers, cell.limits)
    correct = check.holds(checks) and n_bad == 0

    steps = win.step_s
    untraced = [s for s, tr in zip(steps, win.traced) if not tr]
    q = statistics.quantiles(steps, n=10) if len(steps) > 1 else steps * 9
    log(f"window {win.wall_s:.3f} s, {attempted} steps: ms min {min(steps) * 1e3:.1f}, p10 {q[0] * 1e3:.1f}, "
        f"median {statistics.median(steps) * 1e3:.1f}, p90 {q[-1] * 1e3:.1f}, max {max(steps) * 1e3:.1f}")
    result = {"correct": correct, "attempted": attempted, "failed": n_bad}
    if not traced:
        e2e = {
            "train_rays_per_sec": attempted * n_rays / win.wall_s,
            "step_ms_p90": p90(steps) * 1e3,
            "peak_mem_gb": peak / 1e9,
            "setup_s": setup_s,
        }
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    else:
        if not slices[-1]["complete"]:
            log(f"no slice of {TRACE_ATTEMPTS} showed every launch: the device-trace metrics are not read")
        ctx = {
            "cell": cell, "n_rays": n_rays, "model": cfg["model"], "work": work,
            # the device's side only from a slice that shows every launch
            "trace": slices[-1] if slices[-1]["complete"] else None,
            "host_spans_s": slices[-1]["scope_host_s"], "trace_steps": TRACE_STEPS,
            "host_step_s": statistics.mean(untraced) if untraced else None,
            "window_steps": attempted, **window_counts,
        }
        result["metrics"] = {}
        for m in cell.per_layer:
            value = manifest.read_metric(manifest.load_reader(root, m), ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    if traced:
        s = slices[-1]
        result["device"]["busy_s"] = s["busy_s"]
        result["device"]["window_s"] = s["window_s"]
        result["breakdown"] = {
            "device_ops": trace.top({k: v[0] for k, v in s["by_kernel"].items()}),
            "idle_gaps": trace.top(s["idle_gaps_s"]),
        }
    log(f"compared: {numbers}")
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    result["checks"] = checks
    return result
