#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (neat_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py           # the whole check (one card)
    python3 chip_smoke.py --quick   # build + kernel checks at small shapes only

Phases, in order; any failure ends the run with a non-zero exit code:

1. print the card (nvidia-smi name and power limit);
2. build the CUDA kernels from neat_tpu_torch/csrc with nvcc, timed;
3. hold each kernel against its plain PyTorch version on the same inputs
   and time both, beside one PyTorch library route to the same function:
   K1 (fused SDF) at the sampler's per-launch shape and at 1024 x 640
   points, in bf16 and f32; K2-fwd (every output and the stash) and K2-bwd
   (dx, dd, all 38 parameter gradients) at 4096 points in f32 and bf16 and
   at the main path's 100,352 points in bf16;
4. five full-width bf16 training steps of abc-neat-a (bench_step: 8 x 256
   SDF, 4 x 256 heads, 1024 rays x 98 samples, the 512^2 x 4-view bench
   scene) with every kernel launch counter set to 0 just before and read
   just after; each loss must be finite and each kernel must have launched
   on every step;
5. one step of the kernel path against the plain PyTorch path from the same
   weights, batch and noise.

It prints ms/step and rays/s, the card line and one ``kernels`` JSON line,
and last ``{"ok": true, "device": {...}}``. Details go to
build/chip_smoke/chip_smoke.json (gitignored).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")  # reports too long for the console

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, f32 rate outside
# the tensor cores, HBM3 bandwidth
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# max |kernel - plain| over max |plain|, each output on its own scale (a
# kernel that wrote zeros or flipped a sign would score 1 or 2): f32 differs
# by summation order only; bf16 also by the rare activation whose f32 sum
# lands on the other side of a bf16 rounding step (one bf16 ulp is 2^-8
# relative)
TOL = {"float32": 1e-3, "bfloat16": 3e-2}
# end to end: one bf16 step, kernel path against plain path
STEP_RTOL = 0.05


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    scale = max(1e-12, float(b.abs().max()))
    return float((a - b).abs().max()) / scale


def bound_ms(macs: float, nbytes: float, dtype: str):
    ops_ms = 2.0 * macs / PEAK_OPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# ---------------------------------------------------------------------------
# work counts of the three kernels, from the layer shapes
# ---------------------------------------------------------------------------


def k1_macs_per_point() -> int:
    from neat_tpu_torch.ops.fused_sdf import CANONICAL_SHAPES

    return sum(i * o for i, o in CANONICAL_SHAPES)


def k2_macs_per_point():
    from neat_tpu_torch.ops.fused_field_stash import CANONICAL_SHAPES

    imp = sum(i * o for i, o in CANONICAL_SHAPES[:9])
    heads = sum(i * o for i, o in CANONICAL_SHAPES[9:])
    last = CANONICAL_SHAPES[8][0] * CANONICAL_SHAPES[8][1]
    # a sweep seeded one-hot on the sdf channel needs only the last layer's
    # sdf column: the forward's gradient sweep and the tangent half of the
    # backward's combined sweep
    seeded = imp - last + CANONICAL_SHAPES[8][0]
    # forward: chain + gradient sweep + heads; backward: heads (dW and the
    # transposed product), tangent chain (no last layer), and the combined
    # sweep (a dW and a transposed product per layer for each half)
    return imp + seeded + heads, 2 * heads + (imp - last) + 2 * imp + 2 * seeded


def weight_bytes(shapes, cd_bytes: int) -> int:
    return sum(i * o * cd_bytes + o * 4 for i, o in shapes)


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------


def check_k1(model, cfg, n_points, dtype, gen, reps, library=False):
    import torch
    import torch.nn.functional as F

    from neat_tpu_torch.core.embedder import positional_encoding
    from neat_tpu_torch.fields.mlp import _softplus100
    from neat_tpu_torch.ops.fused_sdf import (
        CANONICAL_SHAPES, _effective_weights, fused_sdf_kernel, fused_sdf_plain,
    )

    cd = getattr(torch, dtype)
    pts = (torch.rand((n_points, 3), generator=gen, device="cuda") * 2 - 1) * 3.0
    with torch.no_grad():
        emb = positional_encoding(pts, cfg.implicit.multires).to(cd).contiguous()
        ws, bs = _effective_weights(model.implicit, cfg.implicit, cd)
        ws = [w.contiguous() for w in ws]
        got = fused_sdf_kernel(emb, ws, bs)
        ref = fused_sdf_plain(emb, ws, bs)
        torch.cuda.synchronize()
        rec = {
            "n": n_points, "dtype": dtype, "err": rel_err(got, ref),
            "max_abs_err": float((got - ref).abs().max()),
            "finite": bool(torch.isfinite(got).all()),
        }
        if reps:
            rec["ms"] = time_ms(lambda: fused_sdf_kernel(emb, ws, bs), reps)
            rec["plain_ms"] = time_ms(lambda: fused_sdf_plain(emb, ws, bs), reps)
            if library:
                wl = [w.T.contiguous() for w in ws]  # (out, in) for F.linear
                bl = [b.to(cd) for b in bs]

                def lib():
                    h = emb
                    for l in range(4):
                        h = _softplus100(F.linear(h, wl[l], bl[l]))
                    h = torch.cat([h, emb], dim=-1) * (1.0 / math.sqrt(2.0))
                    for l in range(4, 8):
                        h = _softplus100(F.linear(h, wl[l], bl[l]))
                    return F.linear(h, wl[8], bl[8])

                rec["library_ms"] = time_ms(lib, reps)
            macs = k1_macs_per_point() * n_points
            nbytes = n_points * (39 * emb.element_size() + 4) + weight_bytes(
                CANONICAL_SHAPES, emb.element_size()
            )
            rec["bound_ms"], rec["bound_by"] = bound_ms(macs, nbytes, dtype)
    require(rec["finite"], f"K1 {dtype} n={n_points}: non-finite output")
    require(rec["err"] <= TOL[dtype], f"K1 {dtype} n={n_points}: err {rec['err']:.3g} > {TOL[dtype]}")
    return rec


def _field_inputs(n, gen):
    import torch

    x = (torch.rand((n, 3), generator=gen, device="cuda") * 2 - 1) * 1.5
    far = n // 8  # past the bounding sphere: the clamp's sphere branch
    x[:far] = x[:far] * (3.2 / torch.linalg.norm(x[:far], dim=-1, keepdim=True))
    d = torch.randn((n, 3), generator=gen, device="cuda")
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    cots = tuple(
        torch.randn((n, w), generator=gen, device="cuda") for w in (1, 3, 3, 6)
    )
    return x.contiguous(), d.contiguous(), cots


def check_k2(model, cfg, n, dtype, gen, reps, library=False):
    import torch

    from neat_tpu_torch.fields.mlp import (
        attraction_forward, implicit_sdf_feat_grad, render_forward,
    )
    from neat_tpu_torch.ops import fused_field_stash as K
    from neat_tpu_torch.ops.fused_field import _flatten_eff

    cd = getattr(torch, dtype)
    icfg, rcfg = cfg.implicit, cfg.rendering
    x, d, cots = _field_inputs(n, gen)
    with torch.no_grad():
        flat = tuple(t.detach().contiguous() for t in _flatten_eff(model))
        got = K.field_fwd_stash_kernel(flat, x, d, icfg, cd)
        out_p, res = K.field_fwd_res(flat, x, d, icfg, rcfg, cd)
        scd_p, sf32_p = (t.contiguous() for t in K._pack_res(res))
        ref = (*out_p, scd_p, sf32_p)
        fwd_err = {
            name: rel_err(a, b)
            for name, a, b in zip(("sdf", "grads", "rgb", "att", "stash_cd", "stash_f32"), got, ref)
        }
        fwd_abs = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
        finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
        # the backward on the same inputs: the plain forward's stash and outputs
        rgb_p, grads_p = out_p[2].contiguous(), out_p[1].contiguous()
        bgot = K.field_bwd_stash_kernel(flat, x, d, scd_p, sf32_p, rgb_p, grads_p, cots, icfg, cd)
        res_p = K._unpack_res(scd_p, sf32_p, rgb_p, grads_p, icfg, rcfg)
        bref = K.field_bwd_stashed(flat, x, d, res_p, cots, icfg, rcfg, cd)
        torch.cuda.synchronize()
        bwd_err = {
            "dx": rel_err(bgot[1], bref[1]), "dd": rel_err(bgot[2], bref[2]),
            "dparams": max(rel_err(a, b) for a, b in zip(bgot[0], bref[0])),
        }
        bwd_abs = max(
            float((a - b).abs().max())
            for a, b in zip((*bgot[0], bgot[1], bgot[2]), (*bref[0], bref[1], bref[2]))
        )
        finite = finite and all(bool(torch.isfinite(t).all()) for t in (*bgot[0], bgot[1], bgot[2]))
    rec = {
        "n": n, "dtype": dtype, "fwd_err": fwd_err, "bwd_err": bwd_err,
        "fwd_max_abs_err": fwd_abs, "bwd_max_abs_err": bwd_abs, "finite": finite,
    }
    if reps:
        with torch.no_grad():
            rec["fwd_ms"] = time_ms(lambda: K.field_fwd_stash_kernel(flat, x, d, icfg, cd), reps)
            rec["fwd_plain_ms"] = time_ms(lambda: K.field_fwd_res(flat, x, d, icfg, rcfg, cd), reps)
            rec["bwd_ms"] = time_ms(
                lambda: K.field_bwd_stash_kernel(
                    flat, x, d, scd_p, sf32_p, rgb_p, grads_p, cots, icfg, cd
                ), reps,
            )
            rec["bwd_plain_ms"] = time_ms(
                lambda: K.field_bwd_stashed(flat, x, d, res_p, cots, icfg, rcfg, cd), reps
            )
        if library:
            # the unfused PyTorch route to the same function: autograd's
            # spatial gradient and the two heads at cd, cuBLAS products
            params = [p for n_, p in model.named_parameters()
                      if n_.split(".")[0] in ("implicit", "rendering", "attraction")]
            xg = x.clone().requires_grad_(True)
            dg = d.clone().requires_grad_(True)

            def lib_fwd():
                sdf, feats, grads = implicit_sdf_feat_grad(model.implicit, xg, icfg, compute_dtype=cd)
                rgb = render_forward(model.rendering, xg, grads, dg, feats, rcfg, compute_dtype=cd)
                lines = attraction_forward(
                    model.attraction, xg, grads, dg, feats, cfg.attraction, compute_dtype=cd
                )
                return sdf, grads, rgb, lines

            rec["fwd_library_ms"] = time_ms(lib_fwd, reps)
            outs = lib_fwd()
            lib_cots = (cots[0], cots[1], cots[2], cots[3].reshape(n, 2, 3))

            def lib_bwd():
                return torch.autograd.grad(outs, [*params, xg, dg], lib_cots, retain_graph=True)

            rec["bwd_library_ms"] = time_ms(lib_bwd, reps)
            del outs
        fwd_macs, bwd_macs = k2_macs_per_point()
        cdb = 2 if dtype == "bfloat16" else 4
        wb = weight_bytes(K.CANONICAL_SHAPES, cdb)
        stash = K.W_CD * cdb + K.W_F32 * 4
        fwd_bytes = n * (24 + 52 + stash) + 2 * wb
        bwd_bytes = n * (24 + 24 + stash + 52 + 24) + 2 * wb + 4 * K._n_param_grads()
        rec["fwd_bound_ms"], rec["fwd_bound_by"] = bound_ms(fwd_macs * n, fwd_bytes, dtype)
        rec["bwd_bound_ms"], rec["bwd_bound_by"] = bound_ms(bwd_macs * n, bwd_bytes, dtype)
    tol = TOL[dtype]
    require(finite, f"K2 {dtype} n={n}: non-finite output")
    for k, v in {**fwd_err, **bwd_err}.items():
        require(v <= tol, f"K2 {dtype} n={n}: {k} err {v:.3g} > {tol}")
    return rec


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------


def counters():
    from neat_tpu_torch.ops.fused_field_stash import field_bwd_stash_kernel, field_fwd_stash_kernel
    from neat_tpu_torch.ops.fused_sdf import fused_sdf_kernel

    return {
        "fused_sdf": fused_sdf_kernel,
        "field_fwd_stash": field_fwd_stash_kernel,
        "field_bwd_stash": field_bwd_stash_kernel,
    }


def train_steps(n_steps):
    import torch

    from neat_tpu_torch.utils.benchscene import BENCH_N_RAYS, bench_config, bench_scene, bench_step

    cfg = bench_config("bfloat16", device="cuda")
    require(cfg.use_pallas_sampler and cfg.use_pallas_field, "bench_config took no kernel path")
    scene = bench_scene(cfg, device="cuda")
    step, state = bench_step(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    fns = counters()
    for f in fns.values():
        f.launches = 0
    times, losses, per_step = [], [], []
    for _ in range(n_steps):
        before = {k: f.launches for k, f in fns.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, scene, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        loss = float(metrics["loss"])
        losses.append(loss)
        grew = {k: f.launches - before[k] for k, f in fns.items()}
        per_step.append(grew)
        require(math.isfinite(loss), f"non-finite loss {loss}")
        require(all(v > 0 for v in grew.values()), f"a kernel did not launch in a step: {grew}")
    launches = {k: f.launches for k, f in fns.items()}
    ms = statistics.median(times[1:]) if len(times) > 1 else times[0]
    return {
        "step_ms": times, "median_ms": ms, "rays_per_sec": BENCH_N_RAYS / (ms / 1e3),
        "losses": losses, "launches": launches, "launches_per_step": per_step,
    }


def profile_steps(n_steps: int, out_path: str):
    """Device time by kernel over n_steps bf16 training steps (torch.profiler)
    and the device's busy share of the wall time; the table goes to out_path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neat_tpu_torch.utils.benchscene import bench_config, bench_scene, bench_step

    cfg = bench_config("bfloat16", device="cuda")
    scene = bench_scene(cfg, device="cuda")
    step, state = bench_step(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    state, _ = step(state, scene, gen)  # warm-up outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, _ = step(state, scene, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only: a CPU op's own entry repeats its kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n_steps, e.count // n_steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    with open(out_path, "w") as f:
        f.write(f"{n_steps} steps, wall {wall_ms / n_steps:.2f} ms/step, device busy "
                f"{busy:.2f} ms/step\nms/step  launches/step  kernel\n")
        for ms, cnt, key in rows:
            f.write(f"{ms:9.3f} {cnt:6d}  {key[:150]}\n")
    return {"wall_ms_per_step": wall_ms / n_steps, "device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / (wall_ms / n_steps), "top": rows[:12]}


def compare_paths():
    """One step of the kernel path and of the plain PyTorch path (same dtype)
    from the same weights, batch and noise; and the plain step's time."""
    import torch

    from neat_tpu_torch.model.neat import draw_forward_noise
    from neat_tpu_torch.train.step import sample_batch
    from neat_tpu_torch.utils.benchscene import (
        BENCH_IMG_RES, BENCH_N_RAYS, bench_config, bench_scene, bench_step,
    )

    cfg_k = bench_config("bfloat16", device="cuda")
    cfg_p = dataclasses.replace(cfg_k, use_pallas_sampler=False, use_pallas_field=False)
    scene = bench_scene(cfg_k, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = sample_batch(gen, scene, BENCH_N_RAYS, BENCH_IMG_RES[1])
    noise = draw_forward_noise(gen, BENCH_N_RAYS, cfg_k, device="cuda")
    out = {}
    for name, cfg in (("kernel", cfg_k), ("plain", cfg_p)):
        step, state = bench_step(cfg, device="cuda")
        _, m = step(state, scene, batch=batch, noise=noise)
        out[name] = {k: float(v) for k, v in m.items()}
    step, state = bench_step(cfg_p, device="cuda")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, scene, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["plain_step_ms"] = times
    for key in ("loss", "rgb_loss", "eikonal_loss"):
        a, b = out["kernel"][key], out["plain"][key]
        require(
            abs(a - b) <= STEP_RTOL * max(abs(b), 1e-6),
            f"kernel path {key} {a:.6g} vs plain path {b:.6g}",
        )
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="build + small kernel checks only")
    ap.add_argument("--profile", action="store_true",
                    help="also trace 3 steps with torch.profiler (build/chip_smoke/profile.txt)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from neat_tpu_torch.model.neat import init_neat
    from neat_tpu_torch.ops import _build
    from neat_tpu_torch.utils.benchscene import bench_config

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    logs = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = logs
    print(f"build: {report['build_s']:.1f} s ({', '.join(sorted(logs)) or 'cached'})", flush=True)
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    cfg = bench_config("bfloat16", device="cuda")
    model = init_neat(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1, k2 = [], []
    if args.quick:
        for dt in ("float32", "bfloat16"):
            k1.append(check_k1(model, cfg, 1000, dt, gen, reps=0))
            k2.append(check_k2(model, cfg, 1000, dt, gen, reps=0))
    else:
        k1_launch = 1024 * cfg.sampler.n_samples_eval  # one sampler round
        for dt in ("bfloat16", "float32"):
            k1.append(check_k1(model, cfg, k1_launch, dt, gen, reps=5, library=dt == "bfloat16"))
            k1.append(check_k1(model, cfg, 1024 * 640, dt, gen, reps=0))
        for dt in ("float32", "bfloat16"):
            k2.append(check_k2(model, cfg, 4096, dt, gen, reps=0))
        n_main = 1024 * (cfg.sampler.n_samples + cfg.sampler.n_samples_extra + 2)
        k2.append(check_k2(model, cfg, n_main, "bfloat16", gen, reps=3, library=True))
    for r in k1:
        print(f"K1 {r['dtype']} n={r['n']}: err {r['err']:.3g}"
              + (f", {r['ms']:.3f} ms (plain {r['plain_ms']:.3f})" if "ms" in r else ""), flush=True)
    for r in k2:
        print(f"K2 {r['dtype']} n={r['n']}: fwd {json.dumps(r['fwd_err'])} bwd {json.dumps(r['bwd_err'])}"
              + (f", fwd {r['fwd_ms']:.3f} ms, bwd {r['bwd_ms']:.3f} ms" if "fwd_ms" in r else ""),
              flush=True)
    report["k1"], report["k2"] = k1, k2
    os.makedirs(OUT_DIR, exist_ok=True)
    out_path = os.path.join(OUT_DIR, "chip_smoke.json")

    if not args.quick:
        train = train_steps(5)
        report["train"] = train
        print(f"train: losses {train['losses']}", flush=True)
        print(f"ms/step: {train['median_ms']:.2f}", flush=True)
        print(f"rays/s: {train['rays_per_sec']:.1f}", flush=True)
        if args.profile:
            prof = profile_steps(3, os.path.join(OUT_DIR, "profile.txt"))
            report["profile"] = prof
            print(f"profile: wall {prof['wall_ms_per_step']:.2f} ms/step, device busy "
                  f"{prof['device_busy_ms_per_step']:.2f} ms/step, idle share "
                  f"{prof['idle_share']:.3f}", flush=True)
            for ms, cnt, key in prof["top"]:
                print(f"  {ms:9.3f} ms/step {cnt:5d}x  {key[:100]}", flush=True)
        paths = compare_paths()
        report["paths"] = paths
        print(f"kernel vs plain step: loss {paths['kernel']['loss']:.6g} vs {paths['plain']['loss']:.6g}; "
              f"plain step ms {paths['plain_step_ms']}", flush=True)
        t1, t2 = k1[0], k2[-1]
        main = train["launches"]
        kernels = [
            dict(name="fused_sdf", route="cuda", source="neat_tpu_torch/csrc/fused_sdf.cu",
                 replaces="neat_tpu/ops/fused_sdf.py:66", launches=main["fused_sdf"],
                 max_abs_err=t1["max_abs_err"], ms=t1["ms"], plain_ms=t1["plain_ms"],
                 bound_ms=t1["bound_ms"], bound_by=t1["bound_by"], library_ms=t1["library_ms"]),
            dict(name="field_fwd_stash", route="cuda",
                 source="neat_tpu_torch/csrc/fused_field_stash.cu",
                 replaces="neat_tpu/ops/fused_field_stash.py:448",
                 launches=main["field_fwd_stash"], max_abs_err=t2["fwd_max_abs_err"],
                 ms=t2["fwd_ms"], plain_ms=t2["fwd_plain_ms"], bound_ms=t2["fwd_bound_ms"],
                 bound_by=t2["fwd_bound_by"], library_ms=t2["fwd_library_ms"]),
            dict(name="field_bwd_stash", route="cuda",
                 source="neat_tpu_torch/csrc/fused_field_stash.cu",
                 replaces="neat_tpu/ops/fused_field_stash.py:465",
                 launches=main["field_bwd_stash"], max_abs_err=t2["bwd_max_abs_err"],
                 ms=t2["bwd_ms"], plain_ms=t2["bwd_plain_ms"], bound_ms=t2["bwd_bound_ms"],
                 bound_by=t2["bwd_bound_by"], library_ms=t2["bwd_library_ms"]),
        ]
        report["kernels"] = kernels
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(card, flush=True)  # nvidia-smi's own name, power.limit line
    if not args.quick:
        print(json.dumps({"kernels": report["kernels"]}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
