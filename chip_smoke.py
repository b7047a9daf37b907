#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (neat_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py           # the whole check (one card)
    python3 chip_smoke.py --quick   # build + kernel checks at small shapes only
    python3 chip_smoke.py --only k1 # build fused_sdf.cu and fused_sdf_tf32.cu; K1's checks and timings
    python3 chip_smoke.py --only k2 # build field_fwd_mma.cu (+ the scalar K2); K2-fwd's checks and timings
    python3 chip_smoke.py --only k3 # the same for K3-fwd (+ the scalar K3), and the f32 K3-fwd (field_fwd_tf32.cu)
    python3 chip_smoke.py --only k2b # build field_bwd_mma.cu, field_dw_mma.cu, fused_field_stash.cu; the split K2-bwd's checks and timings
    python3 chip_smoke.py --only k3b # build K3-bwd's sources (+ the scalar K3); the bf16 K3-bwd's checks and timings
    python3 chip_smoke.py --only runner # build the main path's sources; the runner phase (7. below) alone
    python3 chip_smoke.py --only k4 # build fused_round.cu (+ K1 for the sampler run); K4's checks and timings
    python3 chip_smoke.py --only toy # build the main path's and the f32 sources; 8. below alone: the toy training, then finalize
    python3 chip_smoke.py --only toy --toy_seeds 42 1 # 8. below for each runner seed, the trainings at once
    python3 chip_smoke.py --only finalize # the same as --only toy: finalize needs the trained toy rundir
    python3 chip_smoke.py --only dtu # build the main path's and the f32 sources; 9. below alone
    python3 chip_smoke.py --only cli # build the main path's sources; 10. below alone
    python3 chip_smoke.py --only variants # build the main path's sources and the f32 K1's; 11. below alone
    python3 chip_smoke.py --only multigpu # build the main path's, K3's and the f32 sources; 12. below alone
    python3 chip_smoke.py --only periphery # build the main path's and the f32 sources; 13. below alone
    python3 chip_smoke.py --profile --turns 40   # + profiler tables, + step times in turns

Phases, in order; any failure ends the run with a non-zero exit code:

1. print the card (nvidia-smi name and power limit);
2. build the CUDA kernels from neat_tpu_torch/csrc with nvcc, timed;
3. hold each kernel against its plain PyTorch version on the same inputs
   and time both, beside one PyTorch library route to the same function:
   K1 (fused SDF) in bf16 at the sampler's per-launch shape, at 1024 x 640
   points and at 1, 127, 129 and 1000 points, beside the scalar kernel it
   replaced, its exact-softplus variant and its mma.sync variant; K1 in
   f32 (the 3xTF32 kernel of finalize, render eval and the mesh) at 1, 127,
   129, 1000, a finalize chunk's 262,144 and 1024 x 640 points beside the
   scalar kernel of the first port, each of them against the plain version
   and, with it, against the plain version in f64 (the f64 criterion: the
   kernel's max |err| at most 1.5x plain f32's, or 2^-20 of the largest
   entry), timed in turns at 262,144 with both bounds (3xTF32 on the
   tensor cores, f32 on the CUDA cores); the bf16 field forwards on the tensor cores,
   K2-fwd (every output and the stash; stash entries more than one bf16
   step off are counted) and K3-fwd (also against K2-fwd), beside the
   scalar kernels they replaced, at 1, 127, 129 and 1000 points and, timed
   in turns with the library route, at the main path's 100,352; the f32
   K3-fwd of the no-grad route (3xTF32) beside its scalar variant at the
   same sizes, against field_math in f32 and in f64 (the f64 criterion),
   timed in turns at 100,352 with both bounds; the split
   bf16 K2-bwd (its row-local pass writes a workspace of weight-gradient
   operands, a tensor-core GEMM sums them) at 1, 127, 129, 1000, 4096,
   100,352 and 168,093 points (a workspace past 2^31 elements): with the
   scalar row-local pass ("split"), dx, dd and the
   bias gradients equal to the fused scalar K2-bwd's; with the tensor-core
   one ("mma", the model's), its workspace against the plain row-local
   pass's, its dx, dd and biases against the scalar pass's; every output
   against the plain version, the GEMM against its plain version on the
   same workspace and against itself; timed in turns with both row-local
   passes, the fused scalar kernel, the plain version and the library
   route, each stage timed and profiled; K2-fwd and K2-bwd
   (dx, dd, all 38 parameter gradients) at 4096 points in f32 and bf16 and
   at the main path's 100,352 points in bf16; K3-fwd and K3-bwd (the
   recompute pair) at the same sizes, against field_math and its autograd
   and against the K2 pair (in f32 the pair's forward is the scalar tile
   K3-bwd re-runs, held to 1e-5 of field_math and to K2-fwd; the no-grad
   route's 3xTF32 kernel beside it to TOL and the f64 criterion): in bf16
   the split K3-bwd (chunks of 16,384
   points) against the model's K2-fwd + K2-bwd (dx and dd exactly,
   the gradients within 1e-4, the forward its chunks recomputed exactly
   K2-fwd's), its "scalar" variant against the scalar K2 pair, timed in
   turns with the scalar kernel and its plain versions; the three kernels
   it runs on each chunk at a chunk's shape, each against its plain
   version, timed; K4 (the sampler round) on the inputs a sampler run of
   the bench model hands it, 1024 rays at each of its five widths (128 ...
   640 samples) with the refine the sampler runs it with, and at 128 and
   640 the other way too; it and the first port (every bisection step, also
   once the beta0 check has passed; built from the tree's source by
   neat_tpu_torch/tools/fused_round_variants.py) each against the plain
   version; timed at the five widths by the profiler's device-side events,
   the two kernels in turns, beside the wrapper's events-timed calls, the
   plain version and the bound by the special-function operations the
   inputs need;
4. five full-width bf16 training steps of abc-neat-a (bench_step: 8 x 256
   SDF, 4 x 256 heads, 1024 rays x 98 samples, the 512^2 x 4-view bench
   scene) with every kernel launch counter set to 0 just before and read
   just after; each loss must be finite and each step must launch exactly
   the kernels of its path (K1 x5, K2-fwd, K2-bwd: its row-local pass and
   its GEMM);
5. three steps each of the two further configurations of the same entry
   point, counted the same way: bench_config(field='recompute') (K1 x5,
   K3-fwd, K3-bwd: its forward, row-local pass and GEMM x7 chunks) and
   bench_config(fused_rounds='on') (K4 x5, K1 x5, K2-fwd, K2-bwd); and one
   no-grad neat_forward(training=False) on 1024 rays (K3-fwd, no K2); the
   peak device memory of a step of each path (the recompute step's must be
   below the main step's);
6. one step of each of the three kernel paths against the plain PyTorch path
   from the same weights, batch and noise, and the sampler's z values with
   and without K4 on the same noise.
7. the training CLI, neat_tpu_torch.train.runner.main, in this process:
   the port's generate_scene writes an ABC-layout scene (abc/00075213,
   512 x 512, 8 views) under build/chip_smoke/runner; abc-neat-a trains on
   it with --nepoch 1 (2 epochs x 8 steps) and again with --is_continue
   --nepoch 2. Every step's loss must be finite and every step must launch
   exactly the main path's kernels (K1 x5, K2-fwd, the row-local pass, the
   GEMM); train.log must hold one line per epoch; checkpoints/{0,1,latest}
   and their ModelParameters exports must exist; the resumed runner's state
   just after its checkpoint load must equal the saved one bit for bit;
   every packed view must have support pixels. It prints the scene's
   generation and load seconds, the native encodels build and run time,
   and the median ms/step and rays/s of the steps after each run's first.
8. the toy recipe (--only toy alone), scripts/run-abc-toy.sh's order:
   abc-neat-a at full width trained through the training CLI on a
   generated cuboid (abc/00075213, 8 junctions and 12 lines, 512 x 512,
   TOY_VIEWS = 24 views, seed 0) for N = (TOY_EPOCHS + 1) x 24 = 3,240
   steps, every step counted (K1 x5, K2-fwd, the split K2-bwd), every loss
   finite; N and the seconds printed. The training runs in a process of
   its own (--toy_seeds: one a runner seed, at once, each model held by
   what follows); in the whole run beside phases 9-13, which hold launches
   and bits, and whose printed times say "contended" (the report lists
   them under "contended"), and what follows after phase 13. Then,
   on its rundir, through the port's CLIs in this process:
   neat_tpu_torch.wireframe.finalize.main (--vote-ratio 0.2, all 24 views,
   the support pixels in chunks of 2048 rays), evaluation.eval_abc.main on
   its -neat.pkl, evaluation.render_eval.main --views 0 (262,144 rays in
   256 chunks, the mesh at resolution 100). Every CLI's launches counted:
   each chunk's eval forward runs the f32 K1 5 times and the f32 K3-fwd
   once and nothing else, the mesh grid the f32 K1 once a 65,536-point
   chunk. Every output file exists and every array in it is finite. Then
   view_field_lines of views 0 and 1 on the kernels, on the plain versions
   in f32 and in f64: the two f32 routes against each other (rays whose z
   values moved, the error on the rest: printed) and each against its f64
   shadow, the model in f64 sampling as that route did: its decisions, its
   f32 bookkeeping (SamplerTape): on z, lines3d, lines2d and l3d, on each
   view, the
   kernels' rays more than 1e-4 off are at most the plain f32 route's plus
   0.5% of the view's rays, and the median ray is within 1e-4
   (FIN_OUTPUTS' comment); the f64 route on its own decisions is printed
   beside them; rays/s of each route); the
   whole distillation once more on the
   plain f32 route, assembled and checked with the CLI's gates: its
   junction and line counts and eval_abc numbers must equal the CLI's, or,
   where they differ, the kernels' may be no farther from the plain f64
   route's than plain f32's (compare_decisions); the mesh grid's SDF on both
   routes (K1 f32 within TOL, the vertex counts of both), and the f32 K1
   and K3-fwd (the 3xTF32 kernels) on the inputs the pipeline handed them,
   each against its plain version in f32 and, beside its scalar variant,
   in f64 (the f64 criterion), and timed by the profiler's device-side
   events in turns with the scalar variant, beside the plain version, the
   library route and both bounds. It prints the
   seconds of finalize (the distillation and the rest), of the rendered
   view and of the mesh, and the junction, line and eval_abc numbers,
   which it holds to floors (TOY_MIN_*): at least 4 junctions and 4
   visibility-checked lines, junction and line recall at 5% at least 0.5,
   and view 0's PSNR.
9. the DTU path (--only dtu alone): DBSCAN (assignment/clustering.py) on
   the card against its run on the CPU, on 2048 seeded points (clumps,
   noise, an eps-chain past the 64-iteration cap) and on the endpoints of
   the DTU model's first step: the valid rows exactly, the means within
   1e-6; a call's device ms and launches (profiler), host syncs, label
   iterations and host ms at each host-check period. Then, through the
   training CLI in this process, confs/abc/abc-1776.conf on a generated
   ABC-layout scene (abc/00001776, 512 x 512, 8 views) and confs/dtu.conf
   on a generated DTU-layout scene (DTU/scan65, the conf's 1200 x 1600, 16
   views, every scale_mat a scale of 20 and an offset), --nepoch 1 each:
   every loss finite, every step the main path's kernels; per step the
   valid DBSCAN proposals, the junctions the 10 px gate kept, the
   auctions' rounds, the host syncs; the median ms/step and rays/s; the
   DTU scene's generation, load and encodels seconds and its bytes on the
   device. 3 steps each with the l1 and the ssi depth term (the
   generator's z-buffer as .npy cues, confs derived from dtu.conf under
   build/chip_smoke/dtu). Then scripts/eval-neat-dtu.sh's order on the
   dtu rundir: finalize --ckview 5 --ckdist 100, eval_lsr --mode
   junctions and lines against a ground truth written from the
   generator's geometry (an stl .ply, ObsMask and Plane .mat), render eval
   --views 0 --chunksize 8192 (235 chunks, each the f32 K1 x5 and K3-fwd x1;
   the mesh in the ground-truth frame), eval_dtu on that mesh: every
   launch counted, every output there and finite, each CLI's seconds.
10. the rest of the trainer (--only cli alone), through the training CLI
   in this process, 5 epochs a run: abc-neat-a on the runner phase's scene
   (generated with --only cli) without and with --epoch_scan from the
   same seed, whose parameters must be equal bit for bit (the run without
   the flag is the process's first training run with --only cli); --debug_nans
   --batch_size 1, then one clean step and one after a parameter is set to
   NaN, which must raise FloatingPointError; abc-1776 (a generated
   abc/00001776) with the auction and with --assignment callback (two
   scipy calls a step, no auction); then 3 steps each of a ScanNet conf
   (abc-neat-a's model, a generated 480 x 640 x 8-view ScanNet-layout
   scene with sparse depth_colmap cues, the l1 depth term above 0) and a
   scene_line conf (dtu.conf's, a generated 1200 x 1600 x 4-view DTU-layout
   scene, the generator's edges as lines3d). Every step launches the main
   path's kernels; per run ms/step by the runner's epoch clock, the host
   syncs of the callback, DBSCAN and the auction a step, scipy's host ms;
   the scenes' generation and load seconds and bytes on the device; the
   phase's seconds.
11. the reference's model variants and JPEG views (--only variants
   alone), through the training CLI in this process: each ablation class
   (rend_c on abc-1776's conf with its DBSCAN, rend_a with
   model.junction_eikonal, neat_uni, the vanilla VolSDF network, neat_wfr,
   neat_wfr_a, neat_simple, neat_wfr_dual, neat_along_ray, neat_along_ray_v2)
   swapped into the conf and trained one epoch of a generated 4-view scene
   at abc-neat-a's full width, every step counted: K1 5 times (10 for the
   dual class, 0 for neat_uni and VolSDF), the split K2 once for rend_c,
   junction_eikonal and neat_uni and not at all for the others, every loss
   finite; ms/step by the host clock. Finalize on the neat_wfr checkpoint
   (its eval forward re-evaluates the attraction at l3d; the f32 K1 only),
   render eval of view 0 on the VolSDF one. Then JPEG: every fixture of
   tests/data/jpeg (baseline, progressive with and without restarts and
   with block smoothing, arithmetic-coded sequential and progressive,
   lossless with predictors 1-7, CMYK and YCCK) decoded and held to the
   SHA-256 of the reference's samples, and each file the reference refuses
   (12-bit, hierarchical, lossless arithmetic-coded, truncated, an
   arithmetic-coded scan past Pillow's first 64 KiB block) refused; the
   decode seconds per megapixel of the 968 x 1296 frame as a baseline, a
   progressive and an arithmetic-coded progressive file; and 3 steps on a
   generated ScanNet-layout scene whose views are the committed progressive
   JPEG files, K1 x5 and the split K2 counted every step.
12. multi-GPU (--only multigpu alone), at world size 1 through a real NCCL
   group (the card machine has one GPU; two ranks are held on the CPU by
   tests/test_torch_parallel.py): abc-neat-a through the training CLI on
   the runner phase's scene, plain and with --mesh --distributed
   --coordinator 127.0.0.1:<port> --num_processes 1 --process_id 0, in
   turns (plain, mesh, mesh, plain, 2 epochs each), every step counted
   (K1 x5, the split K2); every mesh run trains on the scene split over
   its group by shard_scene (each batch draw gathered by the sharded
   gather's NCCL all-reduces), its parameters bit for bit the plain runs';
   the same pair with --field_path recompute (K3's launches counted); each
   path's data-parallel step profiled (torch.profiler's device events of
   K1's and the field kernels against the launch counters, the NCCL
   kernels' time), the sharded gather's device time a step timed by CUDA
   events around each gather and around its all-reduces alone, the bytes
   of per-pixel tables the rank holds, and one NCCL all-reduce of its
   gradients' size timed by CUDA events (the step at world size 1 makes
   none); neat_wfr_dual and junction_eikonal (the variants JAX's
   shard_map step refuses) one epoch each, plain and with --mesh (the
   split scene), every step's K1 and K2 launches as on one device, bit
   for bit; finalize and render eval (view 0 in chunks of 8192 rays, the
   mesh at 40^3) with
   --mesh 1 on a plain run's rundir, their outputs equal to the runs
   without it; --mesh 2 and --device cpu --mesh 1 of both, which must
   raise ValueError. It prints ms/step of the single-device and the
   data-parallel runner.
13. the periphery (--only periphery alone): abc-neat-a with plot_freq and
   checkpoint_freq 1 through the training CLI on the runner phase's
   scene, with --do_vis --use_tb --gitexp (in a git repository the phase
   makes under build/), between two plain runs of the same conf, every
   step counted and every preview chunk with it (the f32 K1 x5 and K3-fwd
   x1 a chunk); plots/ holds cameras.png, rendering_{e}_{view}.png and
   junctions_{e}.png, each decoding; the render panel of each preview
   whose checkpoint the exit save leaves equals render_view of that
   checkpoint bit for bit; 4 preview chunks profiled, the f32 kernels by
   name; an event file or the tensorboard warning; an expbot commit or the
   gitexp warning. Then debug_tools recon / softmax / show (launches per
   chunk), the checkpoint exported to a reference .pth and imported back
   bit for bit, converted into a new rundir and finalized; two training
   steps under utils/profiling.py:trace, whose Chrome trace names
   fused_sdf_mma, field_fwd_mma, field_bwd_mma and dw_gemm; the viewer's
   record and replay on the run's junctions; colmap_tools.convert on a
   text model of the scene's cameras (the world mats K [R | t]);
   monodepth's exit where no backend is present. It prints ms/step with
   and without --do_vis and the seconds of a preview.

It prints ms/step and rays/s, its seconds, the card line and one
``kernels`` JSON line, and last ``{"ok": true, "device": {...}}``. Details go to
build/chip_smoke/chip_smoke.json (gitignored).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")  # reports too long for the console

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, f32 rate outside
# the tensor cores, dense TF32 tensor-core rate, HBM3 bandwidth
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
# special-function operations a second (expf, IEEE division, sqrtf: one MUFU
# each): 16 a clock on each SM (Hopper white paper: 4 SFUs in each of the
# SM's four partitions) x 132 SMs x 1.98 GHz, the H100 SXM's boost clock
PEAK_SFU = 16 * 132 * 1.98e9
# max |kernel - plain| over max |plain|, each output on its own scale (a
# kernel that wrote zeros or flipped a sign would score 1 or 2): f32 differs
# by summation order only; bf16 also by the rare activation whose f32 sum
# lands on the other side of a bf16 rounding step (one bf16 ulp is 2^-8
# relative)
TOL = {"float32": 1e-3, "bfloat16": 3e-2}
# K1's tensor-core kernel against the scalar kernel it replaced, both scored
# against the plain version on the same inputs: no more than this factor, or
# one bf16 step of the largest entry where a handful of points makes both
# errors a matter of chance
K1_VS_SCALAR, K1_ERR_FLOOR = 1.5, 2.0 ** -8
# sizes that leave a 128-point tile ragged
K1_RAGGED = (1, 127, 129, 1000)
# the kernels held and timed beside the one the sampler runs (bf16) and the
# one finalize, render eval and the mesh run (f32: 3xTF32)
K1_VARIANTS = {"bfloat16": {"scalar": "scalar kernel", "wgmma_exact": "exact softplus", "mma_sync": "mma.sync"},
               "float32": {"scalar": "scalar kernel"}}
# K3 against field_math: the forward on the scale above, f32 held tighter.
# In f32 it holds the recompute pair's forward (the scalar tile, which the
# f32 K3-bwd re-runs); the 3xTF32 kernel of the no-grad route sums in
# another order, and on these weights no second f32 order stays within
# 1e-5 of the plain version (PERF.md §6): it is held to TOL and to
# the f64 criterion below.
K3_FWD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# The f32 kernels against the plain version in f64: each output's max |err|
# at most F64_FACTOR x the plain f32 version's against the same f64, or
# F64_FLOOR of the largest f64 entry (tests/test_torch_tf32_*_design.py hold the
# design to the same on the CPU). A single point's f32 error is a matter of
# chance at that floor's scale (plain f32 was 3e-8 off on one point where
# the kernel was 5.6e-7 and the floor 3.7e-7), so it is held on 1,000
# points or more: each size of at least F64_MIN_POINTS, and the ragged
# sizes below it together (the union of their points: the largest error
# and entry of any of them)
F64_FACTOR, F64_FLOOR, F64_MIN_POINTS = 1.5, 2.0 ** -20, 1000
# K3-bwd against autograd of field_math, as ||kernel - plain|| / ||plain|| of
# each output and each of the 38 gradients. The backward re-runs the forward,
# and a relu whose pre-activation an f32 sum in another order moves across 0
# changes that point's whole backward: the plain version differs from itself
# by as much when its products are summed in two halves (printed beside it as
# "self"), so no entrywise limit can hold. What is exact is K3-bwd against
# K2-fwd + K2-bwd on the same inputs (one tile body): held to 1e-6.
K3_BWD_L2 = {"float32": 5e-3, "bfloat16": 0.15}
K3_VS_K2 = 1e-6
# K4 against fused_round_plain: rays whose beta differs by more than this
# (one err <= eps decision of the bisection flipped) are counted and bounded;
# on every other ray weights and pdf agree within the rtol / atol below
K4_BETA_RTOL, K4_RTOL, K4_ATOL, K4_MAX_FLIPPED = 2e-4, 2e-4, 2e-5, 0.005
# the bf16 eval forward, kernel path against plain path, on the scale above
EVAL_TOL = 3e-2
# sampler z values with K4 against without, on the same noise
Z_MEDIAN, Z_MEAN = 1e-4, 0.02
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


def f32_bounds(macs: float, nbytes: float, rec: dict) -> None:
    """The two bounds of an f32 kernel into rec: work of f32 accuracy as three
    TF32 products on the tensor cores ("bound_ms", the lesser, which the
    kernels line takes) or as f32 FMAs on the CUDA cores
    ("cuda_core_bound_ms"), each against the bytes."""
    ops, by = bound_ms(3 * macs, nbytes, "tf32")
    rec["bound_ms"], rec["bound_by"] = ops, by
    rec["cuda_core_bound_ms"], rec["cuda_core_bound_by"] = bound_ms(macs, nbytes, "float32")


def f64_scores(routes: dict, ref64) -> dict:
    """The f64 criterion on one output: max |route - f64| of each route (the
    kernels and "plain", the plain f32 version) and the limit, F64_FACTOR x
    plain f32's or F64_FLOOR of the largest f64 entry."""
    err = {k: float((v.double() - ref64).abs().max()) for k, v in routes.items()}
    scale = float(ref64.abs().max())
    return {"err": err, "scale": scale, "limit": max(F64_FACTOR * err["plain"], F64_FLOOR * scale)}


def f64_union(scores: list) -> dict:
    """f64_scores of one output over the union of several calls' points."""
    err = {k: max(f["err"][k] for f in scores) for k in scores[0]["err"]}
    scale = max(f["scale"] for f in scores)
    return {"err": err, "scale": scale, "limit": max(F64_FACTOR * err["plain"], F64_FLOOR * scale)}


def require_f64(f: dict, what: str) -> None:
    require(f["err"]["kernel"] <= f["limit"], f"{what}: {f['err']['kernel']:.3g} off f64, above the f64 "
            f"criterion's {f['limit']:.3g} (plain f32 {f['err']['plain']:.3g})")


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
    from neat_tpu_torch.ops.fused_field import CANONICAL_SHAPES

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


def _k1_inputs(model, cfg, n_points, dtype, gen):
    import torch

    from neat_tpu_torch.core.embedder import positional_encoding
    from neat_tpu_torch.ops.fused_sdf import _effective_weights

    cd = getattr(torch, dtype)
    pts = (torch.rand((n_points, 3), generator=gen, device="cuda") * 2 - 1) * 3.0
    emb = positional_encoding(pts, cfg.implicit.multires).to(cd).contiguous()
    ws, bs = _effective_weights(model.implicit, cfg.implicit, cd)
    return emb, [w.contiguous() for w in ws], bs


def check_k1(model, cfg, n_points, dtype, gen, reps, library=False, variants=False):
    """K1 against fused_sdf_plain. ``variants``: also, on the same inputs,
    the scalar kernel it replaced and (bf16) the tensor-core kernel with the
    exact softplus and the one with its products by mma.sync, each against
    plain; with ``reps`` they are timed in turns beside the plain version and
    the library route. f32 (the 3xTF32 kernel): both kernels and plain f32
    also against the plain version in f64 (the f64 criterion), and both
    bounds."""
    import torch
    import torch.nn.functional as F

    from neat_tpu_torch.fields.mlp import _softplus100
    from neat_tpu_torch.ops.fused_sdf import (
        CANONICAL_SHAPES, fused_sdf_kernel, fused_sdf_kernel_variant, fused_sdf_plain,
    )

    with torch.no_grad():
        emb, ws, bs = _k1_inputs(model, cfg, n_points, dtype, gen)
        cd = emb.dtype
        got = fused_sdf_kernel(emb, ws, bs)
        ref = fused_sdf_plain(emb, ws, bs)
        torch.cuda.synchronize()
        rec = {
            "n": n_points, "dtype": dtype, "err": rel_err(got, ref),
            "max_abs_err": float((got - ref).abs().max()),
            "finite": bool(torch.isfinite(got).all()),
        }
        timed = {"ms": lambda: fused_sdf_kernel(emb, ws, bs),
                 "plain_ms": lambda: fused_sdf_plain(emb, ws, bs)}
        outs = {}
        if variants:
            for v in K1_VARIANTS[dtype]:
                outs[v] = fused_sdf_kernel_variant(emb, ws, bs, v)
                rec[f"{v}_err"] = rel_err(outs[v], ref)
                timed[f"{v}_ms"] = lambda v=v: fused_sdf_kernel_variant(emb, ws, bs, v)
        if dtype == "float32":
            ref64 = fused_sdf_plain(emb.double(), [w.double() for w in ws], [b.double() for b in bs])
            rec["f64"] = f64_scores({"kernel": got, **outs, "plain": ref}, ref64)
            del ref64
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

            timed["library_ms"] = lib
        if reps:
            # in turns: every route once per round, two rounds, the mean of both
            for _ in range(2):
                for key, fn in timed.items():
                    rec[key] = rec.get(key, 0.0) + time_ms(fn, reps // 2) / 2
            macs = k1_macs_per_point() * n_points
            nbytes = n_points * (39 * emb.element_size() + 4) + weight_bytes(
                CANONICAL_SHAPES, emb.element_size()
            )
            if dtype == "float32":
                f32_bounds(macs, nbytes, rec)
            else:
                rec["bound_ms"], rec["bound_by"] = bound_ms(macs, nbytes, dtype)
    what = f"K1 {dtype} n={n_points}"
    require(rec["finite"], f"{what}: non-finite output")
    require(rec["err"] <= TOL[dtype], f"{what}: err {rec['err']:.3g} > {TOL[dtype]}")
    if variants:
        for v in K1_VARIANTS[dtype]:
            require(rec[f"{v}_err"] <= TOL[dtype], f"{what}: {v} kernel err {rec[v + '_err']:.3g} > {TOL[dtype]}")
    if variants and dtype == "bfloat16":
        require(rec["err"] <= max(K1_VS_SCALAR * rec["scalar_err"], K1_ERR_FLOOR),
                f"{what}: err {rec['err']:.3g} > {K1_VS_SCALAR} x the scalar kernel's {rec['scalar_err']:.3g}")
    if "f64" in rec and n_points >= F64_MIN_POINTS:
        require_f64(rec["f64"], what)
    return rec


def f64_text(f) -> str:
    """The f64 criterion's scores of one output as a printed phrase."""
    return ("off f64 " + ", ".join(f"{k} {v:.3g}" for k, v in f["err"].items()) + f" (limit {f['limit']:.3g})")


def print_k1(r):
    variants = K1_VARIANTS[r["dtype"]]
    line = f"K1 {r['dtype']} n={r['n']}: err {r['err']:.3g}"
    if "scalar_err" in r:
        line += " (" + ", ".join(f"{name} {r[v + '_err']:.3g}" for v, name in variants.items()) + ")"
    if "f64" in r:
        line += "; " + f64_text(r["f64"])
    if "ms" in r:
        line += f", {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}"
        for key, name in (*((v + "_ms", name) for v, name in variants.items()), ("library_ms", "library")):
            if key in r:
                line += f", {name} {r[key]:.3f}"
        line += f"; bound {r['bound_ms']:.3f} by {r['bound_by']}"
        if "cuda_core_bound_ms" in r:
            line += f", on the CUDA cores {r['cuda_core_bound_ms']:.3f}"
        line += ")"
    print(line, flush=True)


def k1_phase(model, cfg, gen, quick):
    """Every K1 check: ragged sizes around the 128-point tile, the sampler's
    per-launch shape (timed, >= 20 launches a route) and 1024 x 640 points."""
    recs = []
    if quick:
        for dt in ("float32", "bfloat16"):
            recs.append(check_k1(model, cfg, 1000, dt, gen, reps=0, variants=True))
        return recs
    k1_launch = 1024 * cfg.sampler.n_samples_eval  # one sampler round
    recs.append(check_k1(model, cfg, k1_launch, "bfloat16", gen, reps=40, library=True, variants=True))
    for n in K1_RAGGED:
        recs.append(check_k1(model, cfg, n, "bfloat16", gen, reps=0, variants=True))
    recs.append(check_k1(model, cfg, 1024 * 640, "bfloat16", gen, reps=0, variants=True))
    # f32, the 3xTF32 kernel beside the scalar one: the ragged sizes, then
    # a finalize chunk's 2,048 x 128 points, timed in turns
    ragged = [check_k1(model, cfg, n, "float32", gen, reps=0, variants=True) for n in K1_RAGGED]
    require_f64(f64_union([r["f64"] for r in ragged]), f"K1 float32 n={'+'.join(map(str, K1_RAGGED))}")
    recs += ragged
    recs.append(check_k1(model, cfg, 2048 * cfg.sampler.n_samples_eval, "float32", gen, reps=6, library=True,
                         variants=True))
    recs.append(check_k1(model, cfg, 1024 * 640, "float32", gen, reps=0, variants=True))
    return recs


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


def library_fwd(model, cfg, xg, dg, cd):
    """The unfused PyTorch route to the field forward: autograd's spatial
    gradient in reverse mode (``fields/mlp.py:_input_grad``, one backward
    with a graph) and the two heads at cd, cuBLAS products (xg, dg require
    grad)."""
    from neat_tpu_torch.fields.mlp import _clamp_sdf, _input_grad, attraction_forward, implicit_forward, render_forward

    icfg, rcfg = cfg.implicit, cfg.rendering

    def implicit(pts):
        out = implicit_forward(model.implicit, pts, icfg, compute_dtype=cd)
        return _clamp_sdf(out[..., :1], pts, icfg), out[..., 1:]

    def lib_fwd():
        (sdf, feats), grads = _input_grad(implicit, xg)
        rgb = render_forward(model.rendering, xg, grads, dg, feats, rcfg, compute_dtype=cd)
        lines = attraction_forward(model.attraction, xg, grads, dg, feats, cfg.attraction, compute_dtype=cd)
        return sdf, grads, rgb, lines

    return lib_fwd


def fwd_bytes(n, kind, cdb):
    """Bytes the field forward must move: x, d and the outputs, the weights
    (and their transposes), and for K2 the stash."""
    from neat_tpu_torch.ops import fused_field_stash as K
    from neat_tpu_torch.ops.fused_field import CANONICAL_SHAPES

    stash = K.W_CD * cdb + K.W_F32 * 4 if kind == "k2" else 0
    return n * (24 + 52 + stash) + 2 * weight_bytes(CANONICAL_SHAPES, cdb)


def bf16_steps_off(a, b) -> int:
    """Entries of a that are more than one bf16 step (at b's magnitude) from b."""
    import torch

    a, b = a.float(), b.float()
    step = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(2.0 ** -126))) - 7)
    return int(((a - b).abs() > step).sum())


def check_fwd(kind, model, cfg, n, gen, reps, library=False):
    """The bf16 field forward, K2-fwd (kind "k2") or K3-fwd ("k3"): the
    tensor-core kernel and the scalar one against the plain version
    (field_fwd_res and its stash, or field_math) on the same inputs, each
    output on its own scale; K3-fwd also against K2-fwd, which runs the same
    code. With ``reps`` every route is timed in turns beside the library
    route, and the bound."""
    import torch

    from neat_tpu_torch.ops import fused_field as F
    from neat_tpu_torch.ops import fused_field_stash as K

    cd = torch.bfloat16
    icfg, rcfg = cfg.implicit, cfg.rendering
    x, d, _ = _field_inputs(n, gen)
    names = ("sdf", "grads", "rgb", "att") + (("stash_cd", "stash_f32") if kind == "k2" else ())
    with torch.no_grad():
        flat = tuple(t.detach().contiguous() for t in F._flatten_eff(model))
        if kind == "k2":
            run = lambda: K.field_fwd_stash_kernel(flat, x, d, icfg, cd)
            scalar = lambda: K.field_fwd_stash_kernel_variant(flat, x, d, icfg, cd, "scalar")

            def plain():
                out, res = K.field_fwd_res(flat, x, d, icfg, rcfg, cd)
                return (*out, *K._pack_res(res))
        else:
            run = lambda: F.field_fwd_kernel(flat, x, d, icfg, cd)
            scalar = lambda: F.field_fwd_kernel_variant(flat, x, d, icfg, cd, "scalar")
            plain = lambda: F.field_math(flat, x, d, icfg, rcfg, cd)
        got, sc, ref = run(), scalar(), plain()
        k2 = K.field_fwd_stash_kernel(flat, x, d, icfg, cd)[:4] if kind == "k3" else None
        torch.cuda.synchronize()
        rec = {
            "kind": kind, "n": n,
            "err": {k: rel_err(a, b) for k, a, b in zip(names, got, ref)},
            "scalar_err": {k: rel_err(a, b) for k, a, b in zip(names, sc, ref)},
            "max_abs_err": max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref)),
            "finite": all(bool(torch.isfinite(t.float()).all()) for t in got),
        }
        if kind == "k2":
            rec["stash_steps_off"] = {k: bf16_steps_off(a, b) for k, a, b in zip(names[4:], got[4:], ref[4:])}
            rec["scalar_stash_steps_off"] = {k: bf16_steps_off(a, b) for k, a, b in zip(names[4:], sc[4:], ref[4:])}
            rec["stash_entries"] = {k: b.numel() for k, b in zip(names[4:], ref[4:])}
        else:
            rec["vs_k2"] = max(rel_err(a, b) for a, b in zip(got, k2))
        if reps:
            timed = {"ms": run, "scalar_ms": scalar, "plain_ms": plain}
            if library:
                with torch.enable_grad():
                    timed["library_ms"] = library_fwd(
                        model, cfg, x.clone().requires_grad_(True), d.clone().requires_grad_(True), cd)
            for _ in range(2):  # in turns: every route once per round, two rounds
                for key, fn in timed.items():
                    if key == "library_ms":
                        with torch.enable_grad():
                            rec[key] = rec.get(key, 0.0) + time_ms(fn, reps // 2) / 2
                    else:
                        rec[key] = rec.get(key, 0.0) + time_ms(fn, reps // 2) / 2
            rec["bound_ms"], rec["bound_by"] = bound_ms(k2_macs_per_point()[0] * n, fwd_bytes(n, kind, 2), "bfloat16")
    what = f"{kind.upper()}-fwd bf16 n={n}"
    tol = TOL["bfloat16"]
    require(rec["finite"], f"{what}: non-finite output")
    for k in names:
        require(rec["err"][k] <= tol, f"{what}: {k} err {rec['err'][k]:.3g} > {tol}")
        require(rec["scalar_err"][k] <= tol, f"{what}: scalar kernel's {k} err {rec['scalar_err'][k]:.3g} > {tol}")
    if kind == "k3":
        require(rec["vs_k2"] <= K3_VS_K2, f"{what}: differs from K2-fwd by {rec['vs_k2']:.3g}")
    return rec


def print_fwd(r):
    if r.get("dtype") == "float32":
        print_fwd_f32(r)
        return
    line = (f"{r['kind'].upper()}-fwd bf16 n={r['n']}: err {json.dumps({k: float(f'{v:.3g}') for k, v in r['err'].items()})}"
            f" (scalar kernel {json.dumps({k: float(f'{v:.3g}') for k, v in r['scalar_err'].items()})})")
    if "stash_steps_off" in r:
        line += (f"; stash entries more than one bf16 step off {r['stash_steps_off']} (scalar kernel "
                 f"{r['scalar_stash_steps_off']}) of {r['stash_entries']}")
    if "vs_k2" in r:
        line += f"; against K2-fwd {r['vs_k2']:.3g}"
    if "ms" in r:
        line += (f"; {r['ms']:.3f} ms (scalar {r['scalar_ms']:.3f}, plain {r['plain_ms']:.3f}"
                 + (f", library {r['library_ms']:.3f}" if "library_ms" in r else "")
                 + f"; bound {r['bound_ms']:.3f} by {r['bound_by']})")
    print(line, flush=True)


# sizes that leave a 128-point tile ragged
FWD_RAGGED = (1, 127, 129, 1000)


def check_fwd_f32(model, cfg, n, gen, reps, library=False):
    """The f32 K3-fwd of the no-grad route (finalize, render eval), the
    3xTF32 kernel, and its "scalar" variant (the recompute pair's forward)
    against field_math in f32 (TOL, each output on its own scale) and in f64
    (the f64 criterion, each output). With ``reps`` both kernels are timed
    in turns beside the plain version and the library route, with both
    bounds."""
    import torch

    from neat_tpu_torch.ops import fused_field as F

    cd = torch.float32
    icfg, rcfg = cfg.implicit, cfg.rendering
    x, d, _ = _field_inputs(n, gen)
    names = ("sdf", "grads", "rgb", "att")
    with torch.no_grad():
        flat = tuple(t.detach().contiguous() for t in F._flatten_eff(model))
        run = lambda: F.field_fwd_kernel(flat, x, d, icfg, cd)
        scalar = lambda: F.field_fwd_kernel_variant(flat, x, d, icfg, cd, "scalar")
        plain = lambda: F.field_math(flat, x, d, icfg, rcfg, cd)
        got, sc, ref = run(), scalar(), plain()
        ref64 = F.field_math(tuple(t.double() for t in flat), x.double(), d.double(), icfg, rcfg, torch.float64)
        torch.cuda.synchronize()
        rec = {
            "kind": "k3", "dtype": "float32", "n": n,
            "err": {k: rel_err(a, b) for k, a, b in zip(names, got, ref)},
            "scalar_err": {k: rel_err(a, b) for k, a, b in zip(names, sc, ref)},
            "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
            "finite": all(bool(torch.isfinite(t).all()) for t in got),
            "f64": {k: f64_scores({"kernel": a, "scalar": c, "plain": b}, r)
                    for k, a, c, b, r in zip(names, got, sc, ref, ref64)},
        }
        del ref64
        if reps:
            timed = {"ms": run, "scalar_ms": scalar, "plain_ms": plain}
            if library:
                with torch.enable_grad():
                    timed["library_ms"] = library_fwd(
                        model, cfg, x.clone().requires_grad_(True), d.clone().requires_grad_(True), None)
            for _ in range(2):  # in turns: every route once per round, two rounds
                for key, fn in timed.items():
                    with torch.enable_grad() if key == "library_ms" else torch.no_grad():
                        rec[key] = rec.get(key, 0.0) + time_ms(fn, reps // 2) / 2
            f32_bounds(k2_macs_per_point()[0] * n, fwd_bytes(n, "k3", 4), rec)
    what = f"K3-fwd f32 n={n}"
    tol = TOL["float32"]
    require(rec["finite"], f"{what}: non-finite output")
    for k in names:
        require(rec["err"][k] <= tol, f"{what}: {k} err {rec['err'][k]:.3g} > {tol}")
        require(rec["scalar_err"][k] <= tol, f"{what}: scalar kernel's {k} err {rec['scalar_err'][k]:.3g} > {tol}")
        if n >= F64_MIN_POINTS:
            require_f64(rec["f64"][k], f"{what}: {k}")
    return rec


def print_fwd_f32(r):
    line = (f"K3-fwd f32 n={r['n']}: err {json.dumps({k: float(f'{v:.3g}') for k, v in r['err'].items()})} "
            f"(scalar kernel {json.dumps({k: float(f'{v:.3g}') for k, v in r['scalar_err'].items()})}); "
            + "; ".join(f"{k} {f64_text(f)}" for k, f in r["f64"].items()))
    if "ms" in r:
        line += (f"; {r['ms']:.3f} ms (scalar {r['scalar_ms']:.3f}, plain {r['plain_ms']:.3f}"
                 + (f", library {r['library_ms']:.3f}" if "library_ms" in r else "")
                 + f"; bound {r['bound_ms']:.3f} by {r['bound_by']}, on the CUDA cores "
                 f"{r['cuda_core_bound_ms']:.3f})")
    print(line, flush=True)


def fwd_phase(kind, model, cfg, gen, quick, n_main):
    """Every check of one bf16 field forward: the ragged sizes, and (not
    quick) the main path's size, timed in turns. K3-fwd also in f32 (the
    3xTF32 kernel beside the scalar one) at the same sizes."""
    recs = [check_fwd(kind, model, cfg, n, gen, reps=0) for n in FWD_RAGGED]
    if not quick:
        recs.append(check_fwd(kind, model, cfg, n_main, gen, reps=20, library=True))
    if kind == "k3":
        ragged = [check_fwd_f32(model, cfg, n, gen, reps=0) for n in FWD_RAGGED]
        for k in ragged[0]["f64"]:
            require_f64(f64_union([r["f64"][k] for r in ragged]), f"K3-fwd f32 n={'+'.join(map(str, FWD_RAGGED))}: {k}")
        recs += ragged
        if not quick:
            recs.append(check_fwd_f32(model, cfg, n_main, gen, reps=6, library=True))
    return recs


def check_k2(model, cfg, n, dtype, gen, reps, library=False):
    import torch

    from neat_tpu_torch.ops import fused_field_stash as K
    from neat_tpu_torch.ops.fused_field import CANONICAL_SHAPES, _flatten_eff, _n_param_grads

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
        # (the forward is timed in turns by check_fwd)
        with torch.no_grad():
            rec["bwd_ms"] = time_ms(
                lambda: K.field_bwd_stash_kernel(
                    flat, x, d, scd_p, sf32_p, rgb_p, grads_p, cots, icfg, cd
                ), reps,
            )
            rec["bwd_plain_ms"] = time_ms(
                lambda: K.field_bwd_stashed(flat, x, d, res_p, cots, icfg, rcfg, cd), reps
            )
        if library:
            params = [p for n_, p in model.named_parameters()
                      if n_.split(".")[0] in ("implicit", "rendering", "attraction")]
            xg = x.clone().requires_grad_(True)
            dg = d.clone().requires_grad_(True)
            lib_fwd = library_fwd(model, cfg, xg, dg, cd)
            rec["fwd_library_ms"] = time_ms(lib_fwd, reps)
            outs = lib_fwd()
            lib_cots = (cots[0], cots[1], cots[2], cots[3].reshape(n, 2, 3))

            def lib_bwd():
                return torch.autograd.grad(outs, [*params, xg, dg], lib_cots, retain_graph=True)

            rec["bwd_library_ms"] = time_ms(lib_bwd, reps)
            del outs
        _, bwd_macs = k2_macs_per_point()
        cdb = 2 if dtype == "bfloat16" else 4
        wb = weight_bytes(CANONICAL_SHAPES, cdb)
        stash = K.W_CD * cdb + K.W_F32 * 4
        bwd_bytes = n * (24 + 24 + stash + 52 + 24) + 2 * wb + 4 * _n_param_grads()
        rec["bwd_bound_ms"], rec["bwd_bound_by"] = bound_ms(bwd_macs * n, bwd_bytes, dtype)
    tol = TOL[dtype]
    require(finite, f"K2 {dtype} n={n}: non-finite output")
    for k, v in {**fwd_err, **bwd_err}.items():
        require(v <= tol, f"K2 {dtype} n={n}: {k} err {v:.3g} > {tol}")
    return rec


# the split K2-bwd (bf16): its dx, dd and bias gradients against the fused
# scalar kernel's (the same tile code: exactly), the GEMM against field_dw_plain
# on the producer's own workspace (f32 sums of the same bf16 products in
# another order), and two GEMM calls on one workspace against each other
# (a fixed order of sums: exactly)
K2B_VS_SCALAR = 0.0
DW_VS_PLAIN = 1e-4
# sizes of its checks: shorter than one 64-point chunk, ragged against the
# 32-point tile and the chunk, and larger (the main path's size is added)
K2B_SIZES = (1, 127, 129, 1000, 4096)


def dw_work(n):
    """(MACs, bytes) of the weight-gradient GEMM alone for n points: every
    term's products over the points; the workspace read once, dW written once."""
    from neat_tpu_torch.ops import field_dw as DW

    prods = DW.dw_products()
    macs = sum(m * o * len(terms) for m, o, terms in prods) * n
    return macs, DW.WS_ROWS * 2 * n + 4 * sum(m * o for m, o, _ in prods)


def dw_library(ws, prods):
    """The weight-gradient sums by cuBLAS on the same bf16 workspace: one
    call a term, accumulating and writing in f32 (torch.mm's out_dtype), a
    layer's two terms added. No single call computes every layer's sum."""
    import torch

    out = []
    for m, o, terms in prods:
        parts = [torch.mm(ws[ra : ra + m], ws[ry : ry + o].T, out_dtype=torch.float32) for ra, ry in terms]
        out.append(parts[0] if len(parts) == 1 else parts[0] + parts[1])
    return out


def k2b_bytes(n):
    """Bytes K2-bwd must move for n points: x, d, grads, rgb, the four
    cotangents and the stash read, dx and dd written, the weights and their
    transposes read, the gradients written."""
    from neat_tpu_torch.ops import fused_field_stash as K
    from neat_tpu_torch.ops.fused_field import CANONICAL_SHAPES, _n_param_grads

    stash = K.W_CD * 2 + K.W_F32 * 4
    return n * (24 + 24 + stash + 52 + 24) + 2 * weight_bytes(CANONICAL_SHAPES, 2) + 4 * _n_param_grads()


def check_k2b(model, cfg, n, gen, reps, library=False):
    """The split bf16 K2-bwd on the plain forward's stash: against the fused
    scalar K2-bwd (dx, dd, every bias gradient: equal), against the plain
    version (every output within TOL), its row-local pass's workspace
    against the plain row-local pass's (within TOL), its GEMM against
    field_dw_plain on the producer's workspace (and against a second call:
    equal); the tensor-core row-local pass ("mma") and K2-bwd with it: its
    workspace against the plain row-local pass's, its dx, dd and bias
    gradients against the scalar pass's, every output of K2-bwd against the
    plain version (each within TOL). With ``reps``: the model's K2-bwd (the
    "mma" row-local pass), its "split" variant, the fused scalar one, the
    plain version and the library route timed in turns, then the row-local
    passes, the GEMM and their plain versions, and each kernel's device time
    from the profiler."""
    import torch

    from neat_tpu_torch.ops import field_dw as DW
    from neat_tpu_torch.ops import fused_field_stash as K
    from neat_tpu_torch.ops.fused_field import _flatten_eff, _n_param_grads

    cd = torch.bfloat16
    icfg, rcfg = cfg.implicit, cfg.rendering
    x, d, cots = _field_inputs(n, gen)
    with torch.no_grad():
        flat = tuple(t.detach().contiguous() for t in _flatten_eff(model))
        out_p, res = K.field_fwd_res(flat, x, d, icfg, rcfg, cd)
        scd, sf32 = (t.contiguous() for t in K._pack_res(res))
        rgb, grads = out_p[2].contiguous(), out_p[1].contiguous()
        args = (flat, x, d, scd, sf32, rgb, grads, cots, icfg)
        split = K.field_bwd_stash_kernel_variant(*args, cd, "split")
        scalar = K.field_bwd_stash_kernel_variant(*args, cd, "scalar")
        ref = K.field_bwd_stashed(flat, x, d, res, cots, icfg, rcfg, cd)
        _, _, _, ws = K.field_bwd_rowlocal_kernel(*args, variant="split")
        # the tensor-core row-local pass, alone and as the model's K2-bwd's with the GEMM
        rl_mma = K.field_bwd_rowlocal_kernel(*args, variant="mma")
        mma = K.field_bwd_stash_kernel(*args, cd)
        gemm = [torch.zeros(_n_param_grads(), device="cuda") for _ in range(2)]
        for g in gemm:
            DW.field_dw_kernel(ws, n, g)
        dw_p = DW.field_dw_plain(ws)
        ws_p = K.field_bwd_rowlocal_plain(flat, x, d, res, cots, icfg, rcfg, cd)[0]
        torch.cuda.synchronize()
    flat_out = lambda r: (*r[0], r[1], r[2])
    # what the row-local pass alone computes: the 19 bias gradients, dx, dd
    rowlocal = lambda r: flat_out(r)[1:38:2] + flat_out(r)[38:]
    gemm_w = K._split_param_grads(gemm[0], flat)[0::2]
    ops, ops_p, ops_m = (DW.unpack_workspace(w_, n) for w_ in (ws, ws_p, rl_mma[3]))
    rl_out = lambda r: (*K._split_param_grads(r[0], flat)[1::2], r[1], r[2])  # biases, dx, dd
    rec = {
        "n": n,
        "vs_scalar": max(float((a - b).abs().max()) for a, b in zip(rowlocal(split), rowlocal(scalar))),
        "l2_vs_scalar": max(l2_err(a, b) for a, b in zip(flat_out(split), flat_out(scalar))),
        "err": {"dx": rel_err(split[1], ref[1]), "dd": rel_err(split[2], ref[2]),
                "dparams": max(rel_err(a, b) for a, b in zip(split[0], ref[0]))},
        "scalar_err": {"dx": rel_err(scalar[1], ref[1]), "dd": rel_err(scalar[2], ref[2]),
                       "dparams": max(rel_err(a, b) for a, b in zip(scalar[0], ref[0]))},
        "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(flat_out(split), flat_out(ref))),
        "rowlocal_max_abs_err": max(float((a - b).abs().max()) for a, b in zip(rowlocal(split), rowlocal(ref))),
        "gemm_err": max(rel_err(a, b) for a, b in zip(gemm_w, dw_p)),
        "gemm_max_abs_err": max(float((a - b).abs().max()) for a, b in zip(gemm_w, dw_p)),
        "gemm_repeat_equal": bool(torch.equal(gemm[0], gemm[1])),
        "ws_err": max(rel_err(ops[k], ops_p[k]) for k in ops),
        "ws_pad_zero": not bool(ws[:, n:].any()),
        "finite": all(bool(torch.isfinite(t).all()) for t in (*flat_out(split), *flat_out(mma))),
        "mma_ws_err": max(rel_err(ops_m[k], ops_p[k]) for k in ops_p),
        "mma_ws_pad_zero": not bool(rl_mma[3][:, n:].any()),
        "mma_vs_split": max(rel_err(a, b) for a, b in zip(rl_out(rl_mma), rowlocal(split))),
        "mma_err": {"dx": rel_err(mma[1], ref[1]), "dd": rel_err(mma[2], ref[2]),
                    "dparams": max(rel_err(a, b) for a, b in zip(mma[0], ref[0]))},
        "mma_max_abs_err": max(float((a - b).abs().max()) for a, b in zip(flat_out(mma), flat_out(ref))),
        "mma_rowlocal_max_abs_err": max(float((a - b).abs().max()) for a, b in zip(rl_out(rl_mma), rowlocal(ref))),
    }
    del ops, ops_p, ops_m, ws_p, rl_mma, mma
    if reps:
        with torch.no_grad():
            timed = {
                "ms": lambda: K.field_bwd_stash_kernel(*args, cd),
                "split_ms": lambda: K.field_bwd_stash_kernel_variant(*args, cd, "split"),
                "scalar_ms": lambda: K.field_bwd_stash_kernel_variant(*args, cd, "scalar"),
                "plain_ms": lambda: K.field_bwd_stashed(flat, x, d, res, cots, icfg, rcfg, cd),
            }
        if library:
            params = [p for n_, p in model.named_parameters()
                      if n_.split(".")[0] in ("implicit", "rendering", "attraction")]
            xg, dg = x.clone().requires_grad_(True), d.clone().requires_grad_(True)
            outs = library_fwd(model, cfg, xg, dg, cd)()
            lib_cots = (cots[0], cots[1], cots[2], cots[3].reshape(n, 2, 3))
            timed["library_ms"] = lambda: torch.autograd.grad(outs, [*params, xg, dg], lib_cots, retain_graph=True)
        for _ in range(2):  # in turns: every route once per round, two rounds
            for key, fn in timed.items():
                with torch.no_grad() if key != "library_ms" else torch.enable_grad():
                    rec[key] = rec.get(key, 0.0) + time_ms(fn, reps // 2) / 2
        g = torch.zeros(_n_param_grads(), device="cuda")
        prods = DW.dw_products()
        with torch.no_grad():
            stages = {
                "producer_ms": lambda: K.field_bwd_rowlocal_kernel(*args),
                "producer_split_ms": lambda: K.field_bwd_rowlocal_kernel(*args, variant="split"),
                "producer_plain_ms": lambda: K.field_bwd_rowlocal_plain(flat, x, d, res, cots, icfg, rcfg, cd),
                "gemm_plain_ms": lambda: DW.field_dw_plain(ws),
                # the yardstick: cuBLAS's bf16 products of the same operands (bf16 out), one call a term
                "gemm_cublas_ms": lambda: [ws[ra : ra + m] @ ws[ry : ry + o].T
                                           for m, o, terms in prods for ra, ry in terms],
            }
            for key, fn in stages.items():
                rec[key] = time_ms(fn, max(2, reps // 4))
            # the GEMM beside the library's: in turns, two rounds
            gemm = {"gemm_ms": lambda: DW.field_dw_kernel(ws, n, g), "gemm_library_ms": lambda: dw_library(ws, prods)}
            for _ in range(2):
                for key, fn in gemm.items():
                    rec[key] = rec.get(key, 0.0) + time_ms(fn, max(2, reps // 4)) / 2
            rec["gemm_library_err"] = max(rel_err(a, b) for a, b in zip(dw_library(ws, prods), DW.field_dw_plain(ws)))
            prof = profile_calls("k2b", lambda: K.field_bwd_stash_kernel(*args, cd), 3,
                                 os.path.join(OUT_DIR, "profile_k2b.txt"))
        rec["kernels_ms"] = [(key, ms) for ms, _, key in prof["top"][:6]]
        fwd_macs, bwd_macs = k2_macs_per_point()
        dw_macs, dw_bytes = dw_work(n)
        rec["bound_ms"], rec["bound_by"] = bound_ms(bwd_macs * n, k2b_bytes(n), "bfloat16")
        rec["gemm_bound_ms"], rec["gemm_bound_by"] = bound_ms(dw_macs, dw_bytes, "bfloat16")
        rec["producer_bound_ms"], rec["producer_bound_by"] = bound_ms(
            bwd_macs * n - dw_macs, k2b_bytes(n) + DW.WS_ROWS * 2 * n, "bfloat16")
    what = f"K2-bwd split bf16 n={n}"
    require(rec["finite"], f"{what}: non-finite output")
    require(rec["vs_scalar"] <= K2B_VS_SCALAR,
            f"{what}: dx, dd or a bias gradient differs from the fused scalar kernel's by {rec['vs_scalar']:.3g}")
    for k, v in rec["err"].items():
        require(v <= TOL["bfloat16"], f"{what}: {k} err {v:.3g} > {TOL['bfloat16']}")
    require(rec["ws_err"] <= TOL["bfloat16"],
            f"{what}: the row-local pass's workspace differs from the plain one's by {rec['ws_err']:.3g}")
    require(rec["gemm_err"] <= DW_VS_PLAIN, f"{what}: GEMM err {rec['gemm_err']:.3g} > {DW_VS_PLAIN}")
    require(rec["gemm_repeat_equal"], f"{what}: two GEMM calls on one workspace differ")
    require(rec["ws_pad_zero"], f"{what}: the workspace's padded points are not zero")
    # the tensor-core row-local pass ("mma"): its workspace against the plain
    # row-local pass's, its dx, dd and bias gradients against the scalar
    # pass's, and K2-bwd with it against the plain version
    require(rec["mma_ws_err"] <= TOL["bfloat16"],
            f"{what}: the mma row-local pass's workspace differs from the plain one's by {rec['mma_ws_err']:.3g}")
    require(rec["mma_ws_pad_zero"], f"{what}: the mma workspace's padded points are not zero")
    require(rec["mma_vs_split"] <= TOL["bfloat16"],
            f"{what}: the mma row-local pass's dx, dd or biases differ from the split one's by {rec['mma_vs_split']:.3g}")
    for k, v in rec["mma_err"].items():
        require(v <= TOL["bfloat16"], f"{what}: mma {k} err {v:.3g} > {TOL['bfloat16']}")
    return rec


def print_k2b(r):
    line = (f"K2-bwd split bf16 n={r['n']}: against the fused scalar kernel: dx, dd, db max |diff| "
            f"{r['vs_scalar']:.3g}, all outputs rel L2 {r['l2_vs_scalar']:.3g}; err {json.dumps({k: float(f'{v:.3g}') for k, v in r['err'].items()})}"
            f" (scalar {json.dumps({k: float(f'{v:.3g}') for k, v in r['scalar_err'].items()})}); GEMM against "
            f"field_dw_plain {r['gemm_err']:.3g}, repeat equal {r['gemm_repeat_equal']}; workspace against the plain "
            f"row-local pass's {r['ws_err']:.3g}; mma row-local pass: workspace {r['mma_ws_err']:.3g}, dx dd db "
            f"against split {r['mma_vs_split']:.3g}, K2-bwd with it err "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in r['mma_err'].items()})}")
    if "ms" in r:
        line += (f"; {r['ms']:.3f} ms (split {r['split_ms']:.3f}, scalar "
                 f"{r['scalar_ms']:.3f}, plain {r['plain_ms']:.3f}"
                 + (f", library {r['library_ms']:.3f}" if "library_ms" in r else "")
                 + f"; bound {r['bound_ms']:.3f} by {r['bound_by']}); mma row-local pass {r['producer_ms']:.3f} ms "
                 f"(split {r['producer_split_ms']:.3f}) "
                 f"(plain {r['producer_plain_ms']:.3f}; bound {r['producer_bound_ms']:.3f} by {r['producer_bound_by']}), "
                 f"GEMM {r['gemm_ms']:.3f} ms (plain {r['gemm_plain_ms']:.3f}, cuBLAS bf16 products "
                 f"{r['gemm_cublas_ms']:.3f}, in turns with the GEMM cuBLAS with f32 accumulation and output "
                 f"{r['gemm_library_ms']:.3f} (err against the plain version {r['gemm_library_err']:.3g}); bound "
                 f"{r['gemm_bound_ms']:.3f} by {r['gemm_bound_by']}); by kernel "
                 + ", ".join(f"{k[:40]} {ms:.3f}" for k, ms in r["kernels_ms"]))
    print(line, flush=True)


def k2b_phase(model, cfg, gen, quick, n_main):
    """Every check of the split K2-bwd; (not quick) a workspace past 2^31
    elements (its last rows beyond a 32-bit offset), and the main path's
    size, timed."""
    from neat_tpu_torch.ops.field_dw import WS_ROWS

    recs = [check_k2b(model, cfg, n, gen, reps=0) for n in K2B_SIZES]
    if not quick:
        recs.append(check_k2b(model, cfg, 2**31 // WS_ROWS + 1000, gen, reps=0))
        recs.append(check_k2b(model, cfg, n_main, gen, reps=6, library=True))
    return recs


def l2_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm()) / max(1e-30, float(b.norm()))


def _plain_k3_bwd(flat, x, d, cots, icfg, rcfg, cd):
    """The plain version of K3-bwd: field_math recorded, then autograd."""
    import torch

    from neat_tpu_torch.ops.fused_field import field_math

    leaves = [t.detach().clone().requires_grad_(True) for t in (*flat, x, d)]
    with torch.enable_grad():
        outs = field_math(leaves[:-2], leaves[-2], leaves[-1], icfg, rcfg, cd)
        return torch.autograd.grad(outs, leaves, cots)


# bf16 K3-bwd (the split backward over chunks) against the model's K2 on the
# same inputs, K2-fwd on the tensor cores then the split K2-bwd on its stash:
# dx and dd exactly (the same kernels on the same rows), the gradients
# within the limit the GEMM meets against field_dw_plain (the same bf16
# products, their f32 sums in chunks); its recomputed forward equal to
# K2-fwd's exactly (the same entry)
K3_SPLIT_VS_K2 = 0.0
K3_SPLIT_DW_VS_K2 = 1e-4


def recorded_k3_bwd(flat, x, d, cots, icfg, cd):
    """K3-bwd and the forward outputs its chunks recomputed (sdf, grads,
    rgb, att), concatenated in chunk order (None in f32: no chunks)."""
    import torch

    from neat_tpu_torch.ops import fused_field as F

    seen, inner = [], F.field_bwd_chunk_fwd

    def record(*args):
        out = inner(*args)
        seen.append([t.clone() for t in out[:4]])
        return out

    record.launches = 0  # the wrapper counts on its module-level name
    F.field_bwd_chunk_fwd = record
    try:
        out = F.field_bwd_kernel(flat, x, d, cots, icfg, cd)
    finally:
        F.field_bwd_chunk_fwd = inner
    return out, [torch.cat(ts) for ts in zip(*seen)] if seen else None


def check_k3(model, cfg, n, dtype, gen, reps, library=None, self_noise=False):
    """K3-fwd against field_math, K3-bwd against its autograd and against
    K2-fwd + K2-bwd: in bf16 the split K3-bwd against the model's K2 (and
    its recomputed forward against K2-fwd and K3-fwd), the "scalar" variant
    against the scalar K2 pair; in f32 against the f32 K2 pair. ``library``
    = (forward ms, backward ms) of the unfused PyTorch route at this size,
    as check_k2 timed it."""
    import torch

    from neat_tpu_torch.ops import fused_field as F
    from neat_tpu_torch.ops import fused_field_stash as K

    cd = getattr(torch, dtype)
    icfg, rcfg = cfg.implicit, cfg.rendering
    x, d, cots = _field_inputs(n, gen)
    names = ("sdf", "grads", "rgb", "att")
    bf16 = dtype == "bfloat16"
    flat_out = lambda r: (*r[0], r[1], r[2])
    with torch.no_grad():
        flat = tuple(t.detach().contiguous() for t in F._flatten_eff(model))
        got = F.field_fwd_kernel(flat, x, d, icfg, cd)
        ref = F.field_math(flat, x, d, icfg, rcfg, cd)
        # the forward K3_FWD_TOL and the K2 pair hold: in f32 the recompute
        # pair's (the scalar tile, which K3-bwd re-runs), not the no-grad
        # route's 3xTF32 kernel, held below to TOL and the f64 criterion
        pair = got if bf16 else F.field_fwd_kernel_variant(flat, x, d, icfg, cd, "scalar")
        if not bf16:
            ref64 = F.field_math(tuple(t.double() for t in flat), x.double(), d.double(), icfg, rcfg, torch.float64)
            tf32 = {"err": {k: rel_err(a, b) for k, a, b in zip(names, got, ref)},
                    "f64": {k: f64_scores({"kernel": a, "scalar": c, "plain": b}, r)
                            for k, a, c, b, r in zip(names, got, pair, ref, ref64)}}
            del ref64
        k2 = K.field_fwd_stash_kernel(flat, x, d, icfg, cd)
        bgot, refwd = recorded_k3_bwd(flat, x, d, cots, icfg, cd)
        # the model's K2: K2-fwd, then K2-bwd on its stash (bf16: the split one)
        bk2 = K.field_bwd_stash_kernel(flat, x, d, k2[4], k2[5], k2[2], k2[1], cots, icfg, cd)
        if bf16:
            # the scalar variants: K3's fused kernel re-runs the scalar forward
            # tile, so the fused scalar K2-bwd replays the scalar K2-fwd's stash
            k2s = K.field_fwd_stash_kernel_variant(flat, x, d, icfg, cd, "scalar")
            bk2s = K.field_bwd_stash_kernel_variant(
                flat, x, d, k2s[4], k2s[5], k2s[2], k2s[1], cots, icfg, cd, "scalar")
            bsc = F.field_bwd_kernel_variant(flat, x, d, cots, icfg, cd, "scalar")
        torch.cuda.synchronize()
    fwd_err = {k: rel_err(a, b) for k, a, b in zip(names, pair, ref)}
    fwd_abs = max(float((a - b).abs().max()) for a, b in zip(pair, ref))
    fwd_vs_k2 = max(rel_err(a, b) for a, b in zip(pair, k2[:4]))
    kernel = flat_out(bgot)
    rec = {"n": n, "dtype": dtype, "fwd_err": fwd_err, "fwd_max_abs_err": fwd_abs, "fwd_vs_k2": fwd_vs_k2}
    if not bf16:
        rec["tf32"] = tf32
    if bf16:
        rec["bwd_vs_k2_dxdd"] = max(float((a - b).abs().max()) for a, b in zip(kernel[-2:], flat_out(bk2)[-2:]))
        rec["bwd_vs_k2_dparams"] = max(rel_err(a, b) for a, b in zip(bgot[0], bk2[0]))
        rec["scalar_vs_k2"] = max(rel_err(a, b) for a, b in zip(flat_out(bsc), flat_out(bk2s)))
        rec["scalar_l2"] = max(l2_err(a, b) for a, b in zip(kernel, flat_out(bsc)))
        rec["refwd_vs_k2"] = max(float((a - b).abs().max()) for a, b in zip(refwd, k2[:4]))
        rec["refwd_vs_k3"] = max(rel_err(a, b) for a, b in zip(refwd, got))
        del k2s, bk2s, bsc
    else:
        rec["bwd_vs_k2"] = max(rel_err(a, b) for a, b in zip(kernel, flat_out(bk2)))
    del k2, bk2
    plain = _plain_k3_bwd(flat, x, d, cots, icfg, rcfg, cd)
    torch.cuda.synchronize()
    rec["bwd_l2"] = {"dx": l2_err(kernel[-2], plain[-2]), "dd": l2_err(kernel[-1], plain[-1]),
                     "dparams": max(l2_err(a, b) for a, b in zip(kernel[:-2], plain[:-2]))}
    rec["bwd_max"] = {"dx": rel_err(kernel[-2], plain[-2]), "dd": rel_err(kernel[-1], plain[-1]),
                      "dparams": max(rel_err(a, b) for a, b in zip(kernel[:-2], plain[:-2]))}
    rec["bwd_max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(kernel, plain))
    if bf16:
        # the bf16 route's own plain version: the same chunks, field_fwd_res's
        # forward (sums in another order than the tensor cores': held like
        # autograd, in relative L2)
        with torch.no_grad():
            ref_split = K.field_bwd_recompute_split_plain(flat, x, d, cots, icfg, rcfg, cd)
        rec["bwd_split_plain_l2"] = max(l2_err(a, b) for a, b in zip(kernel, flat_out(ref_split)))
        rec["bwd_split_plain_max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(kernel, flat_out(ref_split)))
        del ref_split
    # the points whose own dx or dd is off by more than 10x the forward's limit
    off = sum(
        (a - b).abs().amax(dim=-1) > 10 * K3_FWD_TOL[dtype] * b.abs().max()
        for a, b in zip(kernel[-2:], plain[-2:])
    )
    rec["bwd_points_off"] = int((off > 0).sum())
    rec["finite"] = all(bool(torch.isfinite(t).all()) for t in (*got, *kernel))
    if self_noise:
        # the plain version against itself with every product summed in two halves
        def split_k(h, w, cd_, el):
            a, b = h.to(cd_).to(el), w.to(cd_).to(el)
            k = a.shape[-1] // 2
            return a[..., k:] @ b[k:] + a[..., :k] @ b[:k]

        whole = F._mm
        F._mm = split_k
        try:
            halves = _plain_k3_bwd(flat, x, d, cots, icfg, rcfg, cd)
        finally:
            F._mm = whole
        rec["plain_self_l2"] = max(l2_err(a, b) for a, b in zip(halves, plain))
        rec["plain_self_max"] = max(rel_err(a, b) for a, b in zip(halves, plain))
    del plain
    if reps:
        # (the forward is timed in turns by check_fwd) in turns: the model's
        # K3-bwd, the scalar kernel (bf16), its plain versions: the chunked
        # split one (bf16) and autograd of field_math
        with torch.no_grad():
            timed = {"bwd_ms": lambda: F.field_bwd_kernel(flat, x, d, cots, icfg, cd)}
            if bf16:
                timed["bwd_scalar_ms"] = lambda: F.field_bwd_kernel_variant(flat, x, d, cots, icfg, cd, "scalar")
                timed["bwd_split_plain_ms"] = lambda: K.field_bwd_recompute_split_plain(
                    flat, x, d, cots, icfg, rcfg, cd)
        timed["bwd_autograd_ms"] = lambda: _plain_k3_bwd(flat, x, d, cots, icfg, rcfg, cd)
        for _ in range(2):
            for key, fn in timed.items():
                with torch.no_grad() if key != "bwd_autograd_ms" else torch.enable_grad():
                    rec[key] = rec.get(key, 0.0) + time_ms(fn, max(1, reps // 2)) / 2
        rec["bwd_plain_ms"] = rec["bwd_split_plain_ms" if bf16 else "bwd_autograd_ms"]
        if library is not None:
            # K3-bwd is handed no residuals, so its route runs the forward too
            rec["bwd_library_ms"] = library[0] + library[1]
        fwd_macs, bwd_macs = k2_macs_per_point()
        cdb = 2 if bf16 else 4
        wb = weight_bytes(F.CANONICAL_SHAPES, cdb)
        bwd_bytes = n * (24 + 52 + 24) + 2 * wb + 4 * F._n_param_grads()
        rec["bwd_bound_ms"], rec["bwd_bound_by"] = bound_ms((fwd_macs + bwd_macs) * n, bwd_bytes, dtype)
    what = f"K3 {dtype} n={n}"
    require(rec["finite"], f"{what}: non-finite output")
    for k, v in fwd_err.items():
        require(v <= K3_FWD_TOL[dtype], f"{what}: forward {k} err {v:.3g} > {K3_FWD_TOL[dtype]}")
    require(fwd_vs_k2 <= K3_VS_K2, f"{what}: forward differs from K2-fwd by {fwd_vs_k2:.3g}")
    if not bf16:
        for k, f in tf32["f64"].items():
            require(tf32["err"][k] <= TOL[dtype], f"{what}: 3xTF32 forward {k} err {tf32['err'][k]:.3g} > {TOL[dtype]}")
            if n >= F64_MIN_POINTS:
                require_f64(f, f"{what}: 3xTF32 forward {k}")
    if bf16:
        require(rec["bwd_vs_k2_dxdd"] <= K3_SPLIT_VS_K2,
                f"{what}: dx or dd differs from K2-fwd + split K2-bwd by {rec['bwd_vs_k2_dxdd']:.3g}")
        require(rec["bwd_vs_k2_dparams"] <= K3_SPLIT_DW_VS_K2,
                f"{what}: a gradient differs from K2-fwd + split K2-bwd by {rec['bwd_vs_k2_dparams']:.3g}")
        require(rec["refwd_vs_k2"] == 0.0,
                f"{what}: the recomputed forward differs from K2-fwd by {rec['refwd_vs_k2']:.3g}")
        require(rec["refwd_vs_k3"] <= K3_VS_K2,
                f"{what}: the recomputed forward differs from K3-fwd by {rec['refwd_vs_k3']:.3g}")
        require(rec["scalar_vs_k2"] <= K3_VS_K2,
                f"{what}: the scalar K3-bwd differs from the scalar K2 pair by {rec['scalar_vs_k2']:.3g}")
        require(rec["bwd_split_plain_l2"] <= K3_BWD_L2[dtype],
                f"{what}: backward L2 err against its chunked plain version {rec['bwd_split_plain_l2']:.3g}")
    else:
        require(rec["bwd_vs_k2"] <= K3_VS_K2, f"{what}: backward differs from K2-fwd + K2-bwd by {rec['bwd_vs_k2']:.3g}")
    for k, v in rec["bwd_l2"].items():
        require(v <= K3_BWD_L2[dtype], f"{what}: backward {k} L2 err {v:.3g} > {K3_BWD_L2[dtype]}")
    return rec


def print_k3(r):
    if r["dtype"] == "bfloat16":
        line = (f"against the model's K2 (K2-fwd, K2-bwd): dx, dd max |diff| {r['bwd_vs_k2_dxdd']:.3g}, "
                f"gradients {r['bwd_vs_k2_dparams']:.3g}; recomputed forward against K2-fwd max |diff| "
                f"{r['refwd_vs_k2']:.3g}, against K3-fwd {r['refwd_vs_k3']:.3g}; scalar K3-bwd against the scalar K2 "
                f"pair {r['scalar_vs_k2']:.3g} (the model's against the scalar, rel L2 {r['scalar_l2']:.3g}); "
                f"against its chunked plain version, rel L2 {r['bwd_split_plain_l2']:.3g}")
    else:
        line = f"against K2: bwd {r['bwd_vs_k2']:.3g}; the 3xTF32 forward: err " + json.dumps(
            {k: float(f"{v:.3g}") for k, v in r["tf32"]["err"].items()}) + "; " + "; ".join(
            f"{k} {f64_text(f)}" for k, f in r["tf32"]["f64"].items())
    print(f"K3 {r['dtype']} n={r['n']}: fwd {json.dumps(r['fwd_err'])}; against K2: fwd {r['fwd_vs_k2']:.3g}; "
          + line + f"; bwd against autograd: L2 {json.dumps(r['bwd_l2'])}, max {json.dumps(r['bwd_max'])}, "
          f"{r['bwd_points_off']} points off in dx or dd"
          + (f"; autograd against itself, products in two halves: L2 {r['plain_self_l2']:.3g}, "
             f"max {r['plain_self_max']:.3g}" if "plain_self_l2" in r else "")
          + (f"; bwd {r['bwd_ms']:.3f} ms (" + (f"scalar {r['bwd_scalar_ms']:.3f}, chunked plain {r['bwd_split_plain_ms']:.3f}, "
             if "bwd_scalar_ms" in r else "")
             + f"autograd {r['bwd_autograd_ms']:.3f}"
             + (f", library {r['bwd_library_ms']:.3f}" if "bwd_library_ms" in r else "")
             + f"; bound {r['bwd_bound_ms']:.3f} by {r['bwd_bound_by']})" if "bwd_ms" in r else ""),
          flush=True)


def check_k3_chunk(model, cfg, gen, reps):
    """The three kernels bf16 K3-bwd runs on each chunk, through their own
    wrappers at one chunk's shape (RECOMPUTE_CHUNK points), given the
    weights packed once as K3-bwd gives them: the forward with
    its stash against field_fwd_res, the row-local pass on that stash
    against field_bwd_rowlocal_plain on the same stash, the GEMM on that
    workspace against field_dw_plain; each timed beside its plain version,
    with its bound, and the GEMM beside its library route (cuBLAS on the
    same workspace, f32 accumulation: dw_library)."""
    import torch

    from neat_tpu_torch.ops import field_dw as DW
    from neat_tpu_torch.ops import fused_field as F
    from neat_tpu_torch.ops import fused_field_stash as K

    cd, n = torch.bfloat16, F.RECOMPUTE_CHUNK
    icfg, rcfg = cfg.implicit, cfg.rendering
    prods = DW.dw_products()
    x, d, cots = _field_inputs(n, gen)
    with torch.no_grad():
        flat = tuple(t.detach().contiguous() for t in F._flatten_eff(model))
        packed, w_bwd = K.pack_field_weights_gather(flat, cd), K.pack_field_bwd_weights_gather(flat, cd)
        fwd = F.field_bwd_chunk_fwd(flat, x, d, icfg, packed)
        out_p, res_p = K.field_fwd_res(flat, x, d, icfg, rcfg, cd)
        fwd_p = (*out_p, *K._pack_res(res_p))
        del res_p
        sdf, grads, rgb, att, scd, sf32 = fwd
        args = (flat, x, d, scd, sf32, rgb, grads, cots, icfg)
        dp, dx, dd, ws = F.field_bwd_chunk_rowlocal(*args, w_bwd)
        res = K._unpack_res(scd, sf32, rgb, grads, icfg, rcfg)
        ws_p, dbs_p, col8_p, dx_p, dd_p = K.field_bwd_rowlocal_plain(flat, x, d, res, cots, icfg, rcfg, cd)
        g = torch.zeros_like(dp)
        F.field_bwd_chunk_dw(ws, n, g)
        dw_p = DW.field_dw_plain(ws)
        torch.cuda.synchronize()
    dbs = K._split_param_grads(dp, flat)[1::2]
    ops, ops_p = DW.unpack_workspace(ws, n), DW.unpack_workspace(ws_p, n)
    gw = K._split_param_grads(g, flat)[0::2]
    rec = {
        "n": n,
        "fwd_err": max(rel_err(a, b) for a, b in zip(fwd, fwd_p)),
        "fwd_max_abs_err": max(float((a.float() - b.float()).abs().max()) for a, b in zip(fwd, fwd_p)),
        "rowlocal_err": max([rel_err(ops[k], ops_p[k]) for k in ops]
                            + [rel_err(a, b) for a, b in zip((dx, dd, *dbs), (dx_p, dd_p, *dbs_p))]),
        "rowlocal_max_abs_err": max(float((a - b).abs().max()) for a, b in zip((dx, dd, *dbs), (dx_p, dd_p, *dbs_p))),
        "dw_err": max(rel_err(a, b) for a, b in zip(gw, dw_p)),
        "dw_max_abs_err": max(float((a - b).abs().max()) for a, b in zip(gw, dw_p)),
    }
    del ops, ops_p, ws_p, fwd_p
    if reps:
        with torch.no_grad():
            timed = {
                "fwd_ms": lambda: F.field_bwd_chunk_fwd(flat, x, d, icfg, packed),
                "fwd_plain_ms": lambda: K._pack_res(K.field_fwd_res(flat, x, d, icfg, rcfg, cd)[1]),
                "rowlocal_ms": lambda: F.field_bwd_chunk_rowlocal(*args, w_bwd),
                "rowlocal_plain_ms": lambda: K.field_bwd_rowlocal_plain(flat, x, d, res, cots, icfg, rcfg, cd),
                "dw_ms": lambda: F.field_bwd_chunk_dw(ws, n, g),
                "dw_plain_ms": lambda: DW.field_dw_plain(ws),
                "dw_library_ms": lambda: dw_library(ws, prods),
            }
            for key, fn in timed.items():
                rec[key] = time_ms(fn, reps)
            rec["dw_library_err"] = max(rel_err(a, b) for a, b in zip(dw_library(ws, prods), dw_p))
        fwd_macs, bwd_macs = k2_macs_per_point()
        dw_macs, dw_bytes = dw_work(n)
        rec["fwd_bound_ms"], rec["fwd_bound_by"] = bound_ms(fwd_macs * n, fwd_bytes(n, "k2", 2), "bfloat16")
        rec["rowlocal_bound_ms"], rec["rowlocal_bound_by"] = bound_ms(
            bwd_macs * n - dw_macs, k2b_bytes(n) + DW.WS_ROWS * 2 * n, "bfloat16")
        rec["dw_bound_ms"], rec["dw_bound_by"] = bound_ms(dw_macs, dw_bytes, "bfloat16")
    what = f"K3-bwd chunk kernels n={n}"
    tol = TOL["bfloat16"]
    require(rec["fwd_err"] <= tol, f"{what}: forward err {rec['fwd_err']:.3g} > {tol}")
    require(rec["rowlocal_err"] <= tol, f"{what}: row-local pass err {rec['rowlocal_err']:.3g} > {tol}")
    require(rec["dw_err"] <= DW_VS_PLAIN, f"{what}: GEMM err {rec['dw_err']:.3g} > {DW_VS_PLAIN}")
    return rec


def print_k3_chunk(r):
    line = (f"K3-bwd chunk kernels n={r['n']}: forward err {r['fwd_err']:.3g}, row-local pass err "
            f"{r['rowlocal_err']:.3g}, GEMM err {r['dw_err']:.3g}")
    if "fwd_ms" in r:
        line += "".join(f"; {k} {r[k + '_ms']:.3f} ms (plain {r[k + '_plain_ms']:.3f}; bound "
                        f"{r[k + '_bound_ms']:.3f} by {r[k + '_bound_by']})" for k in ("fwd", "rowlocal", "dw"))
        line += f"; GEMM library {r['dw_library_ms']:.3f} ms (err against the plain version {r['dw_library_err']:.3g})"
    print(line, flush=True)


# sizes of the bf16 K3 checks of --only k3b: one chunk (ragged against the
# forward's 128-point tile and the workspace's 64-point chunk), two chunks
# whose second holds one point, two ragged chunks (the main path's size is
# added)
K3B_SIZES = (1, 127, 129, 1000, 16_385, 40_000)


def k3b_phase(model, cfg, gen, quick, n_main):
    """Every check of the bf16 K3-bwd: the sizes above; (not quick) the main
    path's size timed, and the chunk kernels at a chunk's shape, timed."""
    recs = [check_k3(model, cfg, n, "bfloat16", gen, reps=0) for n in K3B_SIZES]
    chunk = check_k3_chunk(model, cfg, gen, reps=0 if quick else 10)
    if not quick:
        recs.append(check_k3(model, cfg, n_main, "bfloat16", gen, reps=4))
    return recs, chunk


def sampler_rounds(model, cfg, n_rays, gen):
    """The (z, sdf, beta, beta0) that each refinement round of the bench
    model's sampler hands the round kernel, for rays of the bench camera."""
    import torch

    from neat_tpu_torch.core.camera import get_camera_params
    from neat_tpu_torch.model.neat import _sample_z, draw_forward_noise
    from neat_tpu_torch.ops import fused_round as R
    from neat_tpu_torch.utils.benchscene import bench_scene

    scene = bench_scene(cfg, device="cuda")
    uv = torch.rand((n_rays, 2), generator=gen, device="cuda") * 512
    dirs, loc = get_camera_params(uv[None], scene["pose"][:1], scene["intrinsics"][:1])
    fused = dataclasses.replace(cfg, sampler=dataclasses.replace(cfg.sampler, fused_rounds="on"))
    noise = draw_forward_noise(gen, n_rays, cfg, device="cuda")
    seen, kernel = [], R.fused_round_kernel

    def record(z, sdf, beta, beta0, *a):
        seen.append((z.clone(), sdf.clone(), beta.clone(), beta0.clone()))
        return kernel(z, sdf, beta, beta0, *a)

    record.launches = 0  # the wrapper counts on its module-level name
    R.fused_round_kernel = record
    try:
        _sample_z(dirs[0], loc.expand(n_rays, 3), model, fused, True, noise)
    finally:
        R.fused_round_kernel = kernel
    return seen


def _k4_agreement(got, want):
    """Rays whose beta differs (one flipped err <= eps decision) and the
    worst disagreement of weights and pdf on every other ray."""
    import torch

    (bk, wk, pk), (bp, wp, pp) = got, want
    flipped = (bk - bp).abs() > K4_BETA_RTOL * bp.abs()
    keep = ~flipped
    close = lambda a, b: torch.isclose(a, b, rtol=K4_RTOL, atol=K4_ATOL, equal_nan=True)
    return {
        "flipped_rays": int(flipped.sum()),
        "weights_ok": bool(close(wk[keep], wp[keep]).all()),
        "pdf_ok": bool(close(pk[keep], pp[keep]).all()),
        "max_abs_err": float(torch.maximum(
            torch.nan_to_num((wk - wp)[keep]).abs().max(),
            torch.nan_to_num((pk - pp)[keep]).abs().max())),
    }


def check_k4(data, scfg, refine, first_port):
    """K4 (the wrapper) and the first port's kernel (first_port: its
    library) against fused_round_plain on one round's inputs."""
    import torch

    from neat_tpu_torch.ops import fused_round as R
    from neat_tpu_torch.tools import fused_round_variants as V

    z, sdf, beta, beta0 = data
    args = (scfg.eps, scfg.beta_iters, scfg.add_tiny, refine)
    n_rays, lanes = z.shape
    what = f"K4 S={lanes} refine={refine}"
    with torch.no_grad():
        got = R.fused_round_kernel(z, sdf, beta, beta0, *args)
        old = V.launch(first_port, z, sdf, beta, beta0, *args)
        want = R.fused_round_plain(z, sdf, beta, beta0[0], *args)
        torch.cuda.synchronize()
        _, _, pk = got
        rec = {
            "rays": n_rays, "samples": lanes, "refine": refine, **_k4_agreement(got, want),
            "pdf_last_zero": bool((pk[:, -1] == 0).all()),
            "pdf_all_zero": bool((pk == 0).all()),
            "nan_rows": int(torch.isnan(pk).any(dim=-1).sum()),
            "passed_share": float(R.passed_check(z, sdf, beta0[0], scfg.eps).float().mean()),
            "first_port": _k4_agreement(old, want),
            # the exit skips only steps that keep beta0: the first port's
            # values, NaN where it has NaN
            "first_port_same_bits": all(bool((a == b).logical_or(a.isnan() & b.isnan()).all())
                                        for a, b in zip(got, old)),
        }
    for name, r in (("kernel", rec), ("first port", rec["first_port"])):
        require(r["flipped_rays"] <= K4_MAX_FLIPPED * n_rays,
                f"{what} ({name}): beta differs on {r['flipped_rays']} of {n_rays} rays")
        require(r["weights_ok"] and r["pdf_ok"], f"{what} ({name}): weights or pdf differ on a ray whose beta agrees")
    require(rec["first_port_same_bits"], f"{what}: the kernel's outputs are not the first port's bits")
    require(rec["pdf_last_zero"], f"{what}: pdf's last column is not 0")
    require(refine or rec["pdf_all_zero"], f"{what}: pdf is not all 0 without refine")
    return rec


# the first windows device_ms_in_turns found short, and took again
PROFILER_RETRIES = []


def device_ms_in_turns(calls, reps: int):
    """Mean device time a launch of each kernel, from torch.profiler's
    device-side events by kernel name: calls maps a label to (fn, the
    kernel's name); each fn runs once in the profiler's warm-up step, whose
    events are dropped, then reps times in the recorded step, the labels in
    turns, their order reversed after every round. -> {label: (ms, the
    launches the profiler held)}. It has been seen to hold 19 of 20, and
    once none of K4's 20 in a window, cause unknown: the mean is over those
    it holds, the caller prints the count, and at least half of the reps
    must be there, in the first window or, where not, in a second one. A
    first window that fell short is printed and kept in PROFILER_RETRIES,
    which the report records (``profiler_retries``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    def window():
        order = list(calls)
        torch.cuda.synchronize()
        # one cycle; its events stay until the next profiler starts
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for fn, _ in calls.values():
                fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                for label in order:
                    calls[label][0]()
                order.reverse()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        return {label: [e for e in events if kernel in e.key] for label, (_, kernel) in calls.items()}

    held = window()
    counts = {label: sum(e.count for e in hits) for label, hits in held.items()}
    if not all(reps / 2 <= c <= reps for c in counts.values()):
        print(f"the profiler held {counts} of {reps} launches each; a second window", flush=True)
        PROFILER_RETRIES.append({"kernels": {label: kernel for label, (_, kernel) in calls.items()},
                                 "held": counts, "reps": reps})
        held = window()
    out = {}
    for label, (_, kernel) in calls.items():
        hits = held[label]
        count = sum(e.count for e in hits)
        require(reps / 2 <= count <= reps, f"the profiler saw {count} launches of {kernel}, expected {reps}")
        us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
                 for e in hits)
        out[label] = (us / 1e3 / count, count)
    return out


def time_k4(data, scfg, refine, reps, first_port):
    """K4 at one round's shape: the device time of the kernel and of the
    first port (first_port: its library) from the profiler, taken in turns;
    the wrapper's time (CUDA events around reps calls of
    fused_round_kernel, host work included); the plain version's; and the
    bound, by the special-function operations the round needs or by its
    bytes, whichever is longer."""
    from neat_tpu_torch.ops import fused_round as R
    from neat_tpu_torch.tools import fused_round_variants as V

    z, sdf, beta, beta0 = data
    args = (scfg.eps, scfg.beta_iters, scfg.add_tiny, refine)
    n_rays, lanes = z.shape
    items = lanes // 128
    dev = device_ms_in_turns({
        "kernel": (lambda: R.fused_round_kernel(z, sdf, beta, beta0, *args), f"round_kernel<{items}>"),
        "first_port": (lambda: V.launch(first_port, z, sdf, beta, beta0, *args), f"round_kernel_first_port<{items}>"),
    }, reps)
    # what this run's data needs: one evaluation of the bound on a ray whose
    # beta0 check passes; beside it the count with every step on every ray
    n_passed = int(R.passed_check(z, sdf, beta0[0], scfg.eps).sum())
    sfu = R.sfu_ops(n_rays, lanes, scfg.beta_iters, refine, n_passed)
    nbytes = 4 * (4 * n_rays * lanes + 2 * n_rays + 1)  # z, sdf in; weights, pdf out; beta in and out; beta0
    ops_ms, bytes_ms = sfu / PEAK_SFU * 1e3, nbytes / PEAK_BYTES * 1e3
    bound, by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
    every_step_ms = max(R.sfu_ops(n_rays, lanes, scfg.beta_iters, refine) / PEAK_SFU * 1e3, bytes_ms)
    ms = dev["kernel"][0]
    return {
        "passed_rays": n_passed, "every_step_bound_ms": every_step_ms, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
        "rays": n_rays, "samples": lanes, "refine": refine, "ms": ms, "first_port_ms": dev["first_port"][0],
        "seen": {label: n for label, (_, n) in dev.items()}, "reps": reps,
        "wrapper_ms": time_ms(lambda: R.fused_round_kernel(z, sdf, beta, beta0, *args), reps),
        "plain_ms": time_ms(lambda: R.fused_round_plain(z, sdf, beta, beta0[0], *args), 5),
        "sfu_ops": sfu, "bytes": nbytes, "bound_ms": bound, "bound_by": by, "share": bound / ms,
    }


def k4_phase(model, cfg, gen, quick):
    """K4 on the round inputs of a sampler run of the bench model: each of
    the five widths with the refine the sampler runs it with (True but for
    the last round), and 128 and 640 the other way too, the kernel and the
    first port; timed at the five, unless quick."""
    from neat_tpu_torch.tools import fused_round_variants as V

    scfg = cfg.sampler
    first_port = V.build(["first_port"])["first_port"]
    rounds = sampler_rounds(model, cfg, 128 if quick else 1024, gen)
    require([r[0].shape[1] for r in rounds] == [128 * (i + 1) for i in range(scfg.max_total_iters)],
            "the sampler's rounds did not reach the round kernel at 128 ... 640 samples")
    last = len(rounds) - 1
    checks, times = [], []
    for i, data in enumerate(rounds):
        refine = i < last
        checks.append(check_k4(data, scfg, refine, first_port))
        if i in (0, last):
            checks.append(check_k4(data, scfg, not refine, first_port))
        if not quick:
            times.append(time_k4(data, scfg, refine, 20, first_port))
    return {"checks": checks, "times": times}


def print_k4(k4) -> None:
    checks, times = k4["checks"], k4["times"]
    for r in checks:
        f = r["first_port"]
        print(f"K4 {r['rays']} x {r['samples']} refine={r['refine']}: beta differs on {r['flipped_rays']} rays, "
              f"max |err| elsewhere {r['max_abs_err']:.3g}, {r['nan_rows']} rows with a NaN pdf, beta0 on "
              f"{r['passed_share']:.3f} of the rays; the first port {f['flipped_rays']} rays / "
              f"{f['max_abs_err']:.3g}, {'its bits' if r['first_port_same_bits'] else 'OTHER BITS'}", flush=True)
    for r in times:
        seen = r["seen"]
        print(f"K4 {r['rays']} x {r['samples']} refine={r['refine']}: device {r['ms']:.4f} ms, the first "
              f"port {r['first_port_ms']:.4f} in turns (the profiler saw {seen['kernel']} and "
              f"{seen['first_port']} of {r['reps']} launches); "
              f"wrapper {r['wrapper_ms']:.4f} ms (events, host work included); plain {r['plain_ms']:.3f} ms; "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({r['passed_rays']} rays pass the beta0 check; "
              f"{r['sfu_ops'] / (r['rays'] * r['samples']):.2f} special-function ops a sample), "
              f"{100 * r['share']:.1f}% of it; with every step on every ray {r['every_step_bound_ms']:.4f} ms",
              flush=True)
    if times:
        step = {k: sum(r[k] for r in times)
                for k in ("ms", "first_port_ms", "wrapper_ms", "plain_ms", "bound_ms", "every_step_bound_ms")}
        print(f"K4 over the step's {len(times)} rounds: device {step['ms']:.4f} ms (the first port "
              f"{step['first_port_ms']:.4f}), wrapper {step['wrapper_ms']:.4f}, plain {step['plain_ms']:.3f}, bound "
              f"{step['bound_ms']:.4f} ms (every step on every ray {step['every_step_bound_ms']:.4f})", flush=True)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------


def counters():
    from neat_tpu_torch.ops.fused_field import (
        field_bwd_chunk_dw, field_bwd_chunk_fwd, field_bwd_chunk_rowlocal, field_bwd_kernel, field_fwd_kernel,
    )
    from neat_tpu_torch.ops.field_dw import field_dw_kernel
    from neat_tpu_torch.ops.fused_field_stash import (
        field_bwd_rowlocal_kernel, field_bwd_stash_kernel, field_fwd_stash_kernel,
    )
    from neat_tpu_torch.ops.fused_round import fused_round_kernel
    from neat_tpu_torch.ops.fused_sdf import fused_sdf_kernel

    return {
        "fused_sdf": fused_sdf_kernel,
        "field_fwd_stash": field_fwd_stash_kernel,
        "field_bwd_stash": field_bwd_stash_kernel,
        "field_bwd_rowlocal": field_bwd_rowlocal_kernel,
        "field_dw": field_dw_kernel,
        "field_fwd": field_fwd_kernel,
        "field_bwd": field_bwd_kernel,
        "field_bwd_chunk_fwd": field_bwd_chunk_fwd,
        "field_bwd_chunk_rowlocal": field_bwd_chunk_rowlocal,
        "field_bwd_chunk_dw": field_bwd_chunk_dw,
        "fused_round": fused_round_kernel,
    }


# launches per step of each path through bench_config -> bench_step; a kernel
# not named launches 0 times. The bf16 K2-bwd (field_bwd_stash) is the split
# backward: its row-local pass and its weight-gradient GEMM count their own.
# The bf16 K3-bwd (field_bwd) runs the split backward on each of the main
# field pass's K3_CHUNKS chunks: the forward with its stash, the row-local
# pass and the GEMM, each counted under its own name.
K2_BWD = dict(field_bwd_stash=1, field_bwd_rowlocal=1, field_dw=1)
K3_CHUNKS = 7  # 100,352 points in chunks of RECOMPUTE_CHUNK = 16,384
K3_BWD = dict(field_bwd=1, field_bwd_chunk_fwd=K3_CHUNKS, field_bwd_chunk_rowlocal=K3_CHUNKS,
              field_bwd_chunk_dw=K3_CHUNKS)
PATHS = {
    "main": (dict(), dict(fused_sdf=5, field_fwd_stash=1, **K2_BWD)),
    "recompute": (dict(field="recompute"), dict(fused_sdf=5, field_fwd=1, **K3_BWD)),
    "fused_rounds": (dict(fused_rounds="on"),
                     dict(fused_round=5, fused_sdf=5, field_fwd_stash=1, **K2_BWD)),
}


def path_config(path):
    from neat_tpu_torch.utils.benchscene import bench_config

    return bench_config("bfloat16", device="cuda", **PATHS[path][0])


def train_steps(path, n_steps):
    """n_steps full-width bf16 steps of one path, the launch counters set to 0
    just before and read just after; every step must launch exactly the
    path's kernels."""
    import torch

    from neat_tpu_torch.utils.benchscene import BENCH_N_RAYS, bench_scene, bench_step

    cfg = path_config(path)
    fns = counters()
    expected = {k: PATHS[path][1].get(k, 0) for k in fns}
    scene = bench_scene(cfg, device="cuda")
    step, state = bench_step(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for f in fns.values():
        f.launches = 0
    times, losses, per_step, peaks = [], [], [], []
    for _ in range(n_steps):
        before = {k: f.launches for k, f in fns.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, scene, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated())
        loss = float(metrics["loss"])
        losses.append(loss)
        grew = {k: f.launches - before[k] for k, f in fns.items()}
        per_step.append(grew)
        require(math.isfinite(loss), f"{path}: non-finite loss {loss}")
        require(grew == expected, f"{path}: a step launched {grew}, expected {expected}")
    launches = {k: f.launches for k, f in fns.items()}
    ms = statistics.median(times[1:]) if len(times) > 1 else times[0]
    return {
        "step_ms": times, "median_ms": ms, "rays_per_sec": BENCH_N_RAYS / (ms / 1e3),
        "losses": losses, "launches": launches, "launches_per_step": per_step,
        "peak_bytes": max(peaks),
    }


def time_paths_in_turns(n_steps: int, block: int = 5):
    """Step times of the three paths taken in turns on one card: blocks of
    ``block`` steps, the order of the paths reversed after every round, until
    each path has n_steps. Returns the median and quartiles per path."""
    import torch

    from neat_tpu_torch.utils.benchscene import bench_scene, bench_step

    runs, times = {}, {path: [] for path in PATHS}
    for path in PATHS:
        cfg = path_config(path)
        step, state = bench_step(cfg, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        scene = bench_scene(cfg, device="cuda")
        state, _ = step(state, scene, gen)  # warm-up
        runs[path] = [step, state, scene, gen]
    order = list(PATHS)
    while len(times[order[0]]) < n_steps:
        for path in order:
            step, state, scene, gen = runs[path]
            for _ in range(block):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = step(state, scene, gen)
                torch.cuda.synchronize()
                times[path].append((time.perf_counter() - t0) * 1e3)
            runs[path][1] = state
        order.reverse()
    out = {}
    for path, ts in times.items():
        q1, med, q3 = statistics.quantiles(ts, n=4)
        out[path] = {"n": len(ts), "median_ms": med, "q1_ms": q1, "q3_ms": q3, "min_ms": min(ts)}
    return out


def profile_steps(path, n_steps: int, out_path: str):
    """Device time by kernel over n_steps bf16 training steps of one path
    (torch.profiler), the launches per step and the device's busy share of
    the wall time; the table goes to out_path."""
    import torch

    from neat_tpu_torch.utils.benchscene import bench_scene, bench_step

    cfg = path_config(path)
    scene = bench_scene(cfg, device="cuda")
    step, state = bench_step(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    run = {"state": step(state, scene, gen)[0]}  # warm-up outside the window

    def one():
        run["state"], _ = step(run["state"], scene, gen)

    return profile_calls(path, one, n_steps, out_path)


def profile_calls(name, fn, n_calls: int, out_path: str):
    """Device time by kernel over n_calls of fn() (torch.profiler), the
    launches per call and the device's busy share of the wall time; the
    table goes to out_path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
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
            rows.append((dev_us / 1e3 / n_calls, e.count / n_calls, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    with open(out_path, "w") as f:
        f.write(f"{name}: {n_calls} calls, wall {wall_ms / n_calls:.2f} ms/call, device busy "
                f"{busy:.2f} ms/call in {launches:.0f} launches/call\n"
                "ms/call  launches/call  kernel\n")
        for ms, cnt, key in rows:
            f.write(f"{ms:9.3f} {cnt:8.1f}  {key[:150]}\n")
    return {"wall_ms_per_step": wall_ms / n_calls, "device_busy_ms_per_step": busy,
            "launches_per_step": launches, "idle_share": 1.0 - busy / (wall_ms / n_calls),
            "top": rows[:12], "rows": rows}


def compare_paths():
    """One step of each kernel path and of the plain PyTorch path (same
    dtype) from the same weights, batch and noise; the sampler's z values with
    and without K4 on that noise; and the plain step's time."""
    import torch

    from neat_tpu_torch.core.camera import get_camera_params
    from neat_tpu_torch.model.neat import _sample_z, draw_forward_noise, init_neat
    from neat_tpu_torch.train.step import sample_batch
    from neat_tpu_torch.utils.benchscene import BENCH_IMG_RES, BENCH_N_RAYS, bench_scene, bench_step

    cfgs = {path: path_config(path) for path in PATHS}
    cfgs["plain"] = dataclasses.replace(cfgs["main"], use_pallas_sampler=False, use_pallas_field=False)
    scene = bench_scene(cfgs["main"], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = sample_batch(gen, scene, BENCH_N_RAYS, BENCH_IMG_RES[1])
    noise = draw_forward_noise(gen, BENCH_N_RAYS, cfgs["main"], device="cuda")
    out = {}
    for name, cfg in cfgs.items():
        step, state = bench_step(cfg, device="cuda")
        _, m = step(state, scene, batch=batch, noise=noise)
        out[name] = {k: float(v) for k, v in m.items()}
    for name in PATHS:
        for key in ("loss", "rgb_loss", "eikonal_loss"):
            a, b = out[name][key], out["plain"][key]
            require(
                abs(a - b) <= STEP_RTOL * max(abs(b), 1e-6),
                f"{name} path {key} {a:.6g} vs plain path {b:.6g}",
            )
    # the sampler alone, rounds on against rounds off, same rays and noise
    model = init_neat(cfgs["main"], seed=0, device="cuda")
    inputs = batch[0]
    dirs, loc = get_camera_params(inputs["uv"][None], inputs["pose"][None], inputs["intrinsics"][None])
    z = {
        name: _sample_z(dirs[0], loc.expand(BENCH_N_RAYS, 3), model, cfgs[name], True, noise)[0]
        for name in ("main", "fused_rounds")
    }
    diff = (z["fused_rounds"] - z["main"]).abs()
    out["z_median_diff"], out["z_mean_diff"] = float(diff.median()), float(diff.mean())
    require(out["z_median_diff"] < Z_MEDIAN and out["z_mean_diff"] < Z_MEAN,
            f"z values with K4: median |diff| {out['z_median_diff']:.3g}, mean {out['z_mean_diff']:.3g}")
    step, state = bench_step(cfgs["plain"], device="cuda")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, scene, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["plain_step_ms"] = times
    return out


def _eval_setup(n_rays):
    """(kernel config, model, inputs) of a no-grad forward on n_rays rays of the bench scene."""
    import torch

    from neat_tpu_torch.model.neat import init_neat
    from neat_tpu_torch.utils.benchscene import bench_scene

    cfg_k = path_config("main")
    scene = bench_scene(cfg_k, device="cuda")
    model = init_neat(cfg_k, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    inputs = {
        "uv": torch.rand((n_rays, 2), generator=gen, device="cuda") * 512,
        "uv_proj": torch.rand((n_rays, 2), generator=gen, device="cuda") * 512,
        "intrinsics": scene["intrinsics"][0], "pose": scene["pose"][0],
    }
    return cfg_k, model, inputs


def profile_eval_forward(n_rays, n_calls, out_path):
    """profile_calls of the no-grad forward (K1 x5, K3-fwd) on n_rays rays."""
    import torch

    from neat_tpu_torch.model.neat import neat_forward

    cfg, model, inputs = _eval_setup(n_rays)

    def one():
        with torch.no_grad():
            neat_forward(model, inputs, cfg, training=False)

    one()  # warm-up outside the window
    return profile_calls("eval_forward", one, n_calls, out_path)


def eval_forward(n_rays):
    """neat_forward(training=False) under no_grad on n_rays of the bench
    scene: the kernel configuration (K1, and K3-fwd through the stash op's
    no-grad dispatch) against the same configuration with the plain field
    path (K1 stays, so both render the same sample points)."""
    import torch

    from neat_tpu_torch.model.neat import neat_forward

    cfg_k, model, inputs = _eval_setup(n_rays)
    cfg_p = dataclasses.replace(cfg_k, use_pallas_field=False)
    fns = counters()
    for f in fns.values():
        f.launches = 0
    with torch.no_grad():
        got = neat_forward(model, inputs, cfg_k, training=False)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in fns.items()}
        ref = neat_forward(model, inputs, cfg_p, training=False)
    expected = dict.fromkeys(fns, 0) | dict(fused_sdf=cfg_k.sampler.max_total_iters, field_fwd=1)
    require(launches == expected, f"eval forward launched {launches}, expected {expected}")
    rec = {"launches": launches, "err": {}}
    for key in ("rgb_values", "depth", "normal_map"):
        require(bool(torch.isfinite(got[key]).all()), f"eval forward: non-finite {key}")
        rec["err"][key] = rel_err(got[key], ref[key])
        require(rec["err"][key] <= EVAL_TOL, f"eval forward {key} err {rec['err'][key]:.3g} > {EVAL_TOL}")
    return rec


# the runner phase: the training CLI on a scene generated on disk, at the
# resolution of confs/abc-neat-a.conf
RUNNER_CONF = os.path.join("confs", "abc-neat-a.conf")
RUNNER_SCENE, RUNNER_VIEWS = os.path.join("abc", "00075213"), 8


def _same_state(a, b) -> bool:
    """Two host train states (checkpoint payloads) equal bit for bit."""
    if a["step"] != b["step"]:
        return False
    for part in ("params", "mu", "nu"):
        if set(a[part]) != set(b[part]):
            return False
        for k, v in a[part].items():
            w = b[part][k]
            if v.dtype != w.dtype or v.shape != w.shape or v.tobytes() != w.tobytes():
                return False
    return True


def runner_phase(profile_path=None):
    """neat_tpu_torch.train.runner.main in this process on a scene that the
    port's generate_scene writes into build/chip_smoke/runner: abc-neat-a at
    full width, --nepoch 1 (epochs 0 and 1: 2 x 8 steps), then resumed with
    --is_continue --nepoch 2. Each step's loss must be finite and each step
    must launch exactly the main path's kernels; train.log holds one epoch
    line per epoch; the checkpoints and the ModelParameters exports exist;
    the resumed runner's state just after it loaded the checkpoint equals
    the saved state bit for bit; every view of the packed scene has support
    pixels. With ``profile_path``, also profile_calls of 3 more runner steps
    on the same scene."""
    import shutil

    import numpy as np
    import torch

    from neat_tpu_torch.data.datasets import load_scene_for_config
    from neat_tpu_torch.data.encodels import build_native, encode_line_attraction
    from neat_tpu_torch.data.synthetic import generate_scene
    from neat_tpu_torch.train import runner as R
    from neat_tpu_torch.train.checkpoint import host_state, jax_key, load_checkpoint
    from neat_tpu_torch.train.config import load_experiment_config

    work = os.path.join(OUT_DIR, "runner")
    shutil.rmtree(work, ignore_errors=True)
    data_root, exps = os.path.join(work, "data"), os.path.join(work, "exps")
    conf = os.path.join(REPO, RUNNER_CONF)
    cfg = load_experiment_config(conf)
    require(cfg.data_dir == RUNNER_SCENE, f"runner: {RUNNER_CONF} names {cfg.data_dir}, not {RUNNER_SCENE}")
    rec = {"res": list(cfg.img_res), "views": RUNNER_VIEWS}
    t0 = time.perf_counter()
    generate_scene(os.path.join(data_root, RUNNER_SCENE), n_views=RUNNER_VIEWS, res=tuple(cfg.img_res), seed=0)
    rec["generate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_native()
    rec["encodels_build_s"] = time.perf_counter() - t0

    fns = counters()
    expected = {k: PATHS["main"][1].get(k, 0) for k in fns}
    runs = []
    orig_run = R.TrainRunner.run

    def run(self):
        """Record the state just after __init__ (and its checkpoint load),
        then count, time and check every step."""
        r = {"rundir": self.rundir, "start_epoch": self.start_epoch, "load_s": self.load_seconds,
             "n_views": self.n_views, "support": [int(c) for c in self.scene.mask.sum(axis=1)],
             "state": host_state(self.state), "steps": []}
        runs.append(r)
        step_fn = self.step_fn

        def counted(state, scene, gen):
            before = {k: f.launches for k, f in fns.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, aux = step_fn(state, scene, gen)
            loss = float(aux["loss"])
            r["steps"].append({"ms": (time.perf_counter() - t) * 1e3, "loss": loss,
                               "launches": {k: f.launches - before[k] for k, f in fns.items()}})
            require(math.isfinite(loss), f"runner: non-finite loss {loss} at step {state.step}")
            require(r["steps"][-1]["launches"] == expected,
                    f"runner: a step launched {r['steps'][-1]['launches']}, expected {expected}")
            return state, aux

        self.step_fn = counted
        return orig_run(self)

    args = ["--conf", conf, "--data_root", data_root, "--exps_folder", exps]
    R.TrainRunner.run = run
    try:
        for f in fns.values():
            f.launches = 0
        R.main(args + ["--nepoch", "1"])
        R.main(args + ["--nepoch", "2", "--is_continue"])
    finally:
        R.TrainRunner.run = orig_run
    first, resumed = runs
    for r, epochs in ((first, (0, 1)), (resumed, (1, 2))):
        require(r["n_views"] == RUNNER_VIEWS, f"runner: {r['n_views']} views packed, expected {RUNNER_VIEWS}")
        require(min(r["support"]) > 0, f"runner: a view has no support pixels: {r['support']}")
        require(len(r["steps"]) == len(epochs) * RUNNER_VIEWS, f"runner: {len(r['steps'])} steps")
        with open(os.path.join(r["rundir"], "train.log")) as f:
            lines = [l for l in f if "rays/s)" in l]
        require([l.split("[")[1].split("/")[0] for l in lines] == [str(e) for e in epochs],
                 f"runner: train.log epoch lines {lines}")
        for sub in ("runconf.conf", *(f"junctions/{e}.npy" for e in epochs)):
            require(os.path.exists(os.path.join(r["rundir"], sub)), f"runner: no {sub}")
    ckpt = os.path.join(first["rundir"], "checkpoints")
    for tag in ("0", "1", "latest"):
        for sub in (f"{tag}.ckpt", f"ModelParameters/{tag}.npz"):
            require(os.path.exists(os.path.join(ckpt, sub)), f"runner: no checkpoints/{sub}")
    saved, epoch = load_checkpoint(ckpt, "latest")
    require(resumed["start_epoch"] == epoch == 1, f"runner: resumed at epoch {resumed['start_epoch']}, saved {epoch}")
    require(saved["step"] == 2 * RUNNER_VIEWS, f"runner: saved step {saved['step']}")
    require(_same_state(resumed["state"], saved), "runner: the resumed state differs from the saved one")
    with np.load(os.path.join(ckpt, "ModelParameters", "latest.npz")) as z:
        export = {k: z[k] for k in z.files}
    require(export.keys() == {jax_key(k) for k in saved["params"]}
            and all(np.array_equal(export[jax_key(k)], v) for k, v in saved["params"].items()),
            "runner: the ModelParameters export differs from the checkpoint's params")

    # the native encodels alone on this scene's lines, per view
    scene = load_scene_for_config(cfg, data_root)
    t0 = time.perf_counter()
    for v in range(scene.n_images):
        encode_line_attraction(scene.lines[v, : scene.n_lines[v]], *scene.img_res, backend="native")
    rec["encodels_run_s"] = time.perf_counter() - t0
    steps = first["steps"] + resumed["steps"]
    ms = [s["ms"] for s in first["steps"][1:] + resumed["steps"][1:]]
    q1, med, q3 = statistics.quantiles(ms, n=4)
    if profile_path:
        from neat_tpu_torch.train.step import step_generator

        r = R.TrainRunner(conf=conf, data_root=data_root, exps_folder=exps, nepochs=3, is_continue=True)

        def one():
            r.state, _ = r.step_fn(r.state, r.scene_dev, step_generator(0, 0, r.state.step, r.device))

        one()  # warm-up outside the window
        rec["profile"] = profile_calls("runner", one, 3, profile_path)
        r.close()
    require(os.path.exists(os.path.join(resumed["rundir"], "checkpoints", "latest.ckpt")),
            "runner: the resumed run wrote no checkpoints/latest.ckpt")
    rec.update(rundir=resumed["rundir"], data_root=data_root)
    rec.update(load_s=[first["load_s"], resumed["load_s"]], support=first["support"],
               losses=[s["loss"] for s in steps], median_ms=med, q1_ms=q1, q3_ms=q3, n_timed=len(ms),
               rays_per_sec=cfg.num_pixels / (med / 1e3),
               launches_per_step=steps[0]["launches"], step_ms=[s["ms"] for s in steps])
    return rec


# ---------------------------------------------------------------------------
# the finalize phase: what comes after training, on the runner's rundir
# ---------------------------------------------------------------------------

# the finalize pipeline's chunks: finalize's view_field_lines, render eval's
# render_view, the mesh grid (the CLIs' defaults)
FIN_CHUNK, RENDER_CHUNK, MESH_CHUNK, MESH_RES = 2048, 1024, 65536, 100
# views whose view_field_lines runs on the kernels, on the plain versions
# in f32 and on the plain versions in f64 (the reference)
FIN_COMPARE_VIEWS = (0, 1)
# A ray whose z values moved by more than FIN_Z_FLIP of the largest z
# between the two f32 routes had a sampler decision or an ill-conditioned
# inverse-CDF sample move; every other ray is held within FIN_TOL of each
# output's largest entry. Both counts are printed. What is required: on z,
# lines3d, lines2d and l3d, on each view, the share of rays more than
# FIN_TOL off the f64 reference is on the kernels at most the plain f32
# route's share plus FIN_MAX_FLIPPED (f32 in any summation order moves some
# rays: the inverse CDF in a near-empty bin, l3d's division by the tangent
# plane's d . n on a grazing ray), and the median ray is within FIN_TOL of
# it. Each f32 route's f64 reference is its shadow (SamplerTape): the model
# in f64 sampling as that route did (its decisions, its f32 bookkeeping),
# so that it differs from the route by the network's rounding alone, and
# a ray whose reference is not finite counts as off. An f64 run on its own
# decisions places the inverse-CDF draw at u = 0 of each refinement round
# elsewhere on a trained field, where f32's refinement pdf is exactly 0
# over more leading intervals (exp(err_int) - 1 below f32's epsilon,
# exp(-d*/beta) underflowing); the proposals' ranks shift and the extra
# samples taken by rank move, on the median ray by a step of the
# 128-sample grid (6/127) or more, in the JAX package's f32 sampler as in
# the port's (tests/test_torch_sampler_shadow.py). That run is printed
# beside the shadows.
FIN_Z_FLIP, FIN_MAX_FLIPPED, FIN_TOL = 1e-4, 0.005, 1e-4
FIN_OUTPUTS = ("z", "lines3d", "lines2d", "l3d")


class Recorder:
    """Within ``with``: every launch through module.name (a kernel
    wrapper's launch helper, so the wrapper's own count stays as it is)
    goes through; ``key(args)`` gives (points, dtype, inputs to keep), and
    the inputs of the first launch of each size are kept in ``seen``, the
    dtypes in ``dtypes``."""

    def __init__(self, module, name, key):
        self.module, self.name, self.key, self.seen, self.dtypes = module, name, key, {}, set()

    def __enter__(self):
        self.orig = orig = getattr(self.module, self.name)

        def wrapped(*args):
            n, dtype, keep = self.key(args)
            self.dtypes.add(str(dtype))
            if n not in self.seen:
                self.seen[n] = _clone(keep)
            return orig(*args)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class SamplerTape:
    """Shadow execution of the error-bounded sampler
    (neat_tpu_torch/sampling/samplers.py). Within ``recording()`` every
    decision the sampler takes through its module's ``torch`` is kept in
    call order: each ``torch.where``'s condition, each
    ``torch.searchsorted``'s indices, each ``torch.sort``'s order; the
    sampler's results stay bit for bit its own. Within ``shadowing()`` a
    run of the model in f64 samples as the recorded run did: the same
    calls, in the same order, take the kept decisions instead of their own,
    and the sampler's bookkeeping runs in f32, as in the recorded run (the
    same plain code on every route), on the f64 network's SDF rounded to
    f32; the rest of the forward stays in f64. So the shadow differs from
    the recorded run by what the network computes (K1 and K3 on the
    kernels' route) and by rounding alone. (f64 bookkeeping under f32's
    decisions divides by intervals that f64 finds empty where f32 did not.)
    Every other call passes through."""

    def __init__(self):
        self.kept, self.pos, self.replay = [], 0, False

    def take(self, decide):
        if not self.replay:
            self.kept.append(decide())
            return self.kept[-1]
        d = self.kept[self.pos]
        self.pos += 1
        return d

    def _swap(self, replay):
        import torch

        import neat_tpu_torch.model.neat as NM
        import neat_tpu_torch.sampling.samplers as S

        sample = NM.error_bound_z_vals

        def shadow(ray_dirs, cam_loc, sdf_fn, density, cfg, training, beta_min=1e-4, noise=None):
            beta = types.SimpleNamespace(beta=density.beta.detach().float())
            z, z_eik = sample(ray_dirs.float(), cam_loc.float(), lambda p: sdf_fn(p.double()).float(), beta, cfg,
                              training, beta_min=beta_min, noise=noise)
            return z.double(), None if z_eik is None else z_eik.double()

        @contextlib.contextmanager
        def ctx():
            self.replay, self.pos = replay, 0
            S.torch = _TapedTorch(self)
            if replay:
                NM.error_bound_z_vals = shadow
            try:
                yield self
            finally:
                S.torch, NM.error_bound_z_vals = torch, sample
            if replay:
                require(self.pos == len(self.kept), f"sampler tape: {self.pos} of {len(self.kept)} decisions replayed")

        return ctx()

    def recording(self):
        return self._swap(False)

    def shadowing(self):
        return self._swap(True)


class _TapedTorch:
    """The sampler module's ``torch`` under a SamplerTape."""

    def __init__(self, tape):
        self._tape = tape

    def __getattr__(self, name):
        import torch

        return getattr(torch, name)

    def _kept(self, got, decide):
        d = self._tape.take(decide)
        require(d.shape == got, f"sampler tape: a decision of shape {tuple(d.shape)} where {tuple(got)} is taken")
        return d

    def where(self, cond, a, b):
        import torch

        return torch.where(self._kept(cond.shape, lambda: cond), a, b)

    def searchsorted(self, seq, values, **kw):
        import torch

        return self._kept(values.shape, lambda: torch.searchsorted(seq, values, **kw))

    def sort(self, x, dim=-1, stable=False):
        import torch

        order = self._kept(x.shape, lambda: torch.sort(x, dim=dim, stable=stable).indices)
        return _Sorted(torch.gather(x, dim, order), order)


_Sorted = collections.namedtuple("sort", ("values", "indices"))


def _clone(args):
    import torch

    if isinstance(args, torch.Tensor):
        return args.detach().clone()
    if isinstance(args, (tuple, list)):
        return type(args)(_clone(a) for a in args)
    return args


def _launched(fns, before):
    return {k: f.launches - before[k] for k, f in fns.items()}


def time_calls(module, name, fns, timers):
    """Wrap module.name: each call records its seconds (ending in a
    synchronize) and the kernel launches it made in timers[name]. Returns
    the original, which the caller puts back."""
    import torch

    orig = getattr(module, name)

    def wrapped(*a, **k):
        before = {k2: f.launches for k2, f in fns.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(*a, **k)
        torch.cuda.synchronize()
        timers[name] = {"s": time.perf_counter() - t0, "launches": _launched(fns, before)}
        return res

    setattr(module, name, wrapped)
    return orig


def field_lines_routes(model, cfg, scene, view):
    """view_field_lines of one view on the f32 kernels and on the plain
    versions in f32, each recording its sampler decisions (SamplerTape);
    then the plain versions in f64 (a copy of the model in f64) three
    times: as each f32 route's shadow, and sampling on its own. Each timed
    (host clock, ending in its host copies), with the per-ray z values the
    chunks' forwards returned."""
    import copy

    import torch

    import neat_tpu_torch.model.neat as NM
    import neat_tpu_torch.wireframe.finalize as F

    out = {}
    orig = NM.neat_forward  # the chunks' forward (NM.forward_on_mesh)
    m64 = copy.deepcopy(model).double()
    tapes = {"kernel": SamplerTape(), "plain": SamplerTape()}
    for route, m, kernels, taped in (("kernel", model, True, tapes["kernel"].recording),
                                     ("plain", model, False, tapes["plain"].recording),
                                     ("f64_kernel", m64, False, tapes["kernel"].shadowing),
                                     ("f64_plain", m64, False, tapes["plain"].shadowing),
                                     ("f64", m64, False, contextlib.nullcontext)):
        zs = []

        def rec(*a, **k):
            res = orig(*a, **k)
            zs.append(res["z_vals"])
            return res

        NM.neat_forward = rec
        try:
            with taped():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                l3, l2, lp, _ = F.view_field_lines(m, cfg, scene, view, FIN_CHUNK, kernels=kernels)
                secs = time.perf_counter() - t0
        finally:
            NM.neat_forward = orig
        n = l3.shape[0]
        out[route] = {"lines3d": torch.from_numpy(l3), "lines2d": torch.from_numpy(l2), "l3d": torch.from_numpy(lp),
                      "z": torch.cat(zs)[:n].cpu(), "s": secs, "rays": n}
    return out


def _ray_err(a, b):
    """Per ray: max |a - b| over the ray's entries / max |b| over all."""
    a, b = a.reshape(a.shape[0], -1).double(), b.reshape(b.shape[0], -1).double()
    return (a - b).abs().amax(dim=1) / max(float(b.abs().max()), 1e-12)


def _ref_err(a, ref):
    """Per ray: max |a - ref| over the ray's entries / max |a| over all (a
    is the route under test, finite); a ray whose reference is not finite
    is infinitely far off."""
    import torch

    a, ref = a.reshape(a.shape[0], -1).double(), ref.reshape(ref.shape[0], -1).double()
    err = (a - ref).abs().amax(dim=1) / max(float(a.abs().max()), 1e-12)
    return torch.where(ref.isfinite().all(dim=1), err, math.inf)


def compare_field_lines(routes, view):
    """The two f32 routes of one view against each other (flipped rays and
    the error on the rest, printed), each against its f64 shadow (the
    requirement, FIN_OUTPUTS' comment) and against the f64 route on its own
    decisions (printed); what fails goes to rec["failures"], which the
    caller requires empty once every check has printed."""
    import torch

    k, p = routes["kernel"], routes["plain"]
    n = k["rays"]
    rec = {"view": view, "rays": n, "kernel_rays_per_s": n / k["s"], "plain_rays_per_s": n / p["s"],
           "f64_rays_per_s": n / routes["f64"]["s"], "failures": []}
    if not (all(r["rays"] == n for r in routes.values()) and n > 0):
        rec["failures"].append(f"finalize view {view}: rays by route "
                               f"{json.dumps({name: r['rays'] for name, r in routes.items()})}")
        return rec
    for key in FIN_OUTPUTS:
        if not bool(k[key].isfinite().all()):
            rec["failures"].append(f"finalize view {view}: non-finite {key} on the kernels")
    # the two f32 routes against each other
    dz = _ray_err(k["z"], p["z"])
    flipped = dz > FIN_Z_FLIP
    keep = ~flipped
    rec["flipped_rays"] = int(flipped.sum())
    rec["dz_quantiles"] = [float(q) for q in torch.quantile(dz, torch.tensor([0.5, 0.99, 1.0], dtype=torch.float64))]
    rec["err"] = {key: float(_ray_err(k[key], p[key])[keep].max()) if bool(keep.any()) else 0.0
                  for key in FIN_OUTPUTS[1:]}
    # each against the f64 reference: its shadow (required), the f64 route
    # on its own decisions (printed)
    for name, refs in (("off_f64", ("f64_kernel", "f64_plain")), ("off_f64_own", ("f64", "f64"))):
        rec[name], rec[name.replace("off", "median")] = {}, {}
        for key in FIN_OUTPUTS:
            ek, ep = _ref_err(k[key], routes[refs[0]][key]), _ref_err(p[key], routes[refs[1]][key])
            rec[name][key] = (int((ek > FIN_TOL).sum()), int((ep > FIN_TOL).sum()))
            rec[name.replace("off", "median")][key] = (float(ek.median()), float(ep.median()))
    for key in FIN_OUTPUTS:
        if rec["off_f64"][key][0] > rec["off_f64"][key][1] + FIN_MAX_FLIPPED * n:
            rec["failures"].append(f"finalize view {view}: {key} off the f64 shadow by > {FIN_TOL} on "
                                   f"{rec['off_f64'][key][0]} rays on the kernels, {rec['off_f64'][key][1]} plain")
        if rec["median_f64"][key][0] > FIN_TOL:
            rec["failures"].append(f"finalize view {view}: the median ray's {key} is "
                                   f"{rec['median_f64'][key][0]:.3g} off the f64 shadow")
    return rec


def time_eval_kernels(k1_inputs, k3_inputs, model, cfg):
    """The f32 K1 and K3-fwd (the 3xTF32 kernels) on the inputs the pipeline
    handed them (one chunk of each shape): each against its plain version
    (TOL) and, beside its scalar variant, against the plain version in f64
    (the f64 criterion); the device time of the kernel and of the scalar
    variant from the profiler's events (10 launches each, in turns, one
    shape a profiler window), the plain version's and the library route's
    time (CUDA events), and both bounds."""
    import torch
    import torch.nn.functional as Fn

    from neat_tpu_torch.fields.mlp import _softplus100
    from neat_tpu_torch.ops import fused_field as F
    from neat_tpu_torch.ops.fused_sdf import (
        CANONICAL_SHAPES, fused_sdf_kernel, fused_sdf_kernel_variant, fused_sdf_plain,
    )

    icfg, rcfg = cfg.implicit, cfg.rendering
    calls, recs = {}, {}
    names = ("sdf", "grads", "rgb", "att")
    with torch.no_grad():
        for n, (emb, ws, bs) in sorted(k1_inputs.items()):
            got, ref = fused_sdf_kernel(emb, ws, bs), fused_sdf_plain(emb, ws, bs)
            sc = fused_sdf_kernel_variant(emb, ws, bs, "scalar")
            ref64 = fused_sdf_plain(emb.double(), [w.double() for w in ws], [b.double() for b in bs])
            wl = [w.T.contiguous() for w in ws]

            def lib(emb=emb, wl=wl, bs=bs):
                h = emb
                for l in range(4):
                    h = _softplus100(Fn.linear(h, wl[l], bs[l]))
                h = torch.cat([h, emb], dim=-1) * (1.0 / math.sqrt(2.0))
                for l in range(4, 8):
                    h = _softplus100(Fn.linear(h, wl[l], bs[l]))
                return Fn.linear(h, wl[8], bs[8])

            recs[f"k1/{n}"] = rec = {"kernel": "K1", "n": n, "err": rel_err(got, ref), "scalar_err": rel_err(sc, ref),
                                     "max_abs_err": float((got - ref).abs().max()),
                                     "f64": {"sdf": f64_scores({"kernel": got, "scalar": sc, "plain": ref}, ref64)},
                                     "plain_ms": time_ms(lambda: fused_sdf_plain(emb, ws, bs), 6),
                                     "library_ms": time_ms(lib, 6)}
            f32_bounds(k1_macs_per_point() * n, n * (39 * 4 + 4) + weight_bytes(CANONICAL_SHAPES, 4), rec)
            calls[f"k1/{n}"] = {
                "ms": (lambda emb=emb, ws=ws, bs=bs: fused_sdf_kernel(emb, ws, bs), "fused_sdf_tf32_kernel"),
                "scalar_ms": (lambda emb=emb, ws=ws, bs=bs: fused_sdf_kernel_variant(emb, ws, bs, "scalar"),
                              "fused_sdf_kernel<float>"),
            }
            del ref64
        for n, (flat, x, d, _, cd) in sorted(k3_inputs.items()):
            got, ref = F.field_fwd_kernel(flat, x, d, icfg, cd), F.field_math(flat, x, d, icfg, rcfg, cd)
            sc = F.field_fwd_kernel_variant(flat, x, d, icfg, cd, "scalar")
            ref64 = F.field_math(tuple(t.double() for t in flat), x.double(), d.double(), icfg, rcfg, torch.float64)
            with torch.enable_grad():
                lib = library_fwd(model, cfg, x.clone().requires_grad_(True), d.clone().requires_grad_(True), None)
                lib_ms = time_ms(lib, 4)
            recs[f"k3/{n}"] = rec = {
                "kernel": "K3-fwd", "n": n, "err": max(rel_err(a, b) for a, b in zip(got, ref)),
                "scalar_err": max(rel_err(a, b) for a, b in zip(sc, ref)),
                "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
                "f64": {k: f64_scores({"kernel": a, "scalar": c, "plain": b}, r)
                        for k, a, c, b, r in zip(names, got, sc, ref, ref64)},
                "plain_ms": time_ms(lambda: F.field_math(flat, x, d, icfg, rcfg, cd), 4), "library_ms": lib_ms}
            f32_bounds(k2_macs_per_point()[0] * n, fwd_bytes(n, "k3", 4), rec)
            calls[f"k3/{n}"] = {
                "ms": (lambda flat=flat, x=x, d=d, cd=cd: F.field_fwd_kernel(flat, x, d, icfg, cd),
                       "field_fwd_tf32_kernel"),
                "scalar_ms": (lambda flat=flat, x=x, d=d, cd=cd: F.field_fwd_kernel_variant(flat, x, d, icfg, cd, "scalar"),
                              "field_fwd_kernel<float>"),
            }
            del ref64
        # the profiler tells the kernels apart by name only: one size a window,
        # the kernel and its scalar variant in turns
        dev = {key: device_ms_in_turns(pair, 10) for key, pair in calls.items()}
    for key, r in recs.items():
        r["ms"], r["seen"] = dev[key]["ms"]
        r["scalar_ms"], r["scalar_seen"] = dev[key]["scalar_ms"]
        r["share"] = r["bound_ms"] / r["ms"]
        r["scalar_share"] = r["bound_ms"] / r["scalar_ms"]
        what = f"{r['kernel']} f32 n={r['n']}"
        require(r["err"] <= TOL["float32"], f"{what}: err {r['err']:.3g} > {TOL['float32']}")
        require(r["scalar_err"] <= TOL["float32"], f"{what}: scalar kernel's err {r['scalar_err']:.3g} > {TOL['float32']}")
        for k, f in r["f64"].items():
            if r["n"] >= F64_MIN_POINTS:
                require_f64(f, f"{what}: {k}")
    return recs


def finalize_phase(rundir, data_root):
    """What a user runs after training (scripts/run-abc-toy.sh), through the
    port's CLIs in this process on the toy phase's rundir: finalize (all
    views, --vote-ratio 0.2), eval_abc on its -neat.pkl, render eval of
    view 0 and the mesh. Every launch counted per CLI: each field
    evaluation runs the f32 K1 (5 launches a chunk) and the f32 K3-fwd (1),
    nothing else; the mesh grid K1 alone. Then view_field_lines of two
    views on both routes, the whole distillation's decisions on both
    (compare_decisions), the mesh grid's SDF on both, and the two kernels
    checked and timed at the shapes the pipeline gave them, beside their
    scalar variants. Last, the trained model's floors: TOY_MIN_JUNCTIONS,
    TOY_MIN_LINES, TOY_MIN_RECALL and TOY_MIN_PSNR."""
    import glob
    import pickle

    import numpy as np
    import torch

    import neat_tpu_torch.evaluation.render_eval as RE
    import neat_tpu_torch.wireframe.finalize as F
    from neat_tpu_torch.data.datasets import load_scene_for_config
    from neat_tpu_torch.evaluation import eval_abc as EA
    from neat_tpu_torch.ops import fused_field, fused_sdf
    from neat_tpu_torch.train.checkpoint import load_model
    from neat_tpu_torch.train.config import load_experiment_config
    from neat_tpu_torch.viz.mesh import load_ply, sdf_to_mesh

    conf = os.path.join(rundir, "runconf.conf")
    cfg = load_experiment_config(conf)
    rounds = cfg.model.sampler.max_total_iters
    fns = counters()
    rec = {"rundir": rundir}
    timers = {}

    # fused_sdf._launch(emb, ws, bs, variant); fused_field._fwd_launch(flat_eff, x, d, icfg, cd, variant)
    k1_key = lambda a: (a[0].shape[0], a[0].dtype, a[:3])
    k3_key = lambda a: (a[1].shape[0], a[4], a[:5])
    scene = load_scene_for_config(cfg, data_root, distance_threshold=1.0)
    chunks = sum(-(-int(m.sum()) // FIN_CHUNK) for m in scene.mask)
    rec["support"] = [int(m.sum()) for m in scene.mask]
    origs = {"distill_views": time_calls(F, "distill_views", fns, timers),
             "render_views_psnr": time_calls(RE, "render_views_psnr", fns, timers),
             "export_scene_mesh": time_calls(RE, "export_scene_mesh", fns, timers)}
    try:
        with Recorder(fused_sdf, "_launch", k1_key) as k1, Recorder(fused_field, "_fwd_launch", k3_key) as k3:
            for f in fns.values():
                f.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = F.main(["--conf", conf, "--checkpoint", "latest", "--vote-ratio", "0.2",
                              "--data_root", data_root])
            rec["finalize_s"] = time.perf_counter() - t0
            rec["finalize_launches"] = {k: f.launches for k, f in fns.items()}
            pkls = sorted(glob.glob(os.path.join(rundir, "wireframes", "*-neat.pkl")), key=os.path.getmtime)
            require(len(pkls) == 1, f"finalize: {len(pkls)} -neat.pkl files")
            rec["eval_abc"] = EA.main(["--data", pkls[0], "--scan", os.path.join(data_root, RUNNER_SCENE)])
            for f in fns.values():
                f.launches = 0
            t0 = time.perf_counter()
            rec["render_eval"] = RE.main(["--conf", conf, "--checkpoint", "latest", "--data_root", data_root,
                                          "--views", "0"])
            rec["render_eval_s"] = time.perf_counter() - t0
        rec["k1_dtypes"], rec["k3_dtypes"] = sorted(k1.dtypes), sorted(k3.dtypes)
    finally:
        for name, orig in origs.items():
            setattr(F if name == "distill_views" else RE, name, orig)
    rec["distill_s"] = timers["distill_views"]["s"]
    rec["assemble_s"] = rec["finalize_s"] - rec["distill_s"]
    rec["render_s"], rec["mesh_s"] = timers["render_views_psnr"]["s"], timers["export_scene_mesh"]["s"]
    rec["render_launches"] = timers["render_views_psnr"]["launches"]
    rec["mesh_launches"] = timers["export_scene_mesh"]["launches"]
    rec["chunks"] = chunks
    h, w = cfg.img_res
    render_chunks = -(-h * w // RENDER_CHUNK)
    mesh_chunks = -(-MESH_RES ** 3 // MESH_CHUNK)
    expect = lambda **kw: dict.fromkeys(fns, 0) | kw
    for what, got, want in (
        ("finalize", rec["finalize_launches"], expect(fused_sdf=rounds * chunks, field_fwd=chunks)),
        ("render", rec["render_launches"], expect(fused_sdf=rounds * render_chunks, field_fwd=render_chunks)),
        ("mesh", rec["mesh_launches"], expect(fused_sdf=mesh_chunks)),
    ):
        require(got == want, f"{what} launched {got}, expected {want}")
    require(rec["k1_dtypes"] == ["torch.float32"] and rec["k3_dtypes"] == ["torch.float32"],
            f"the pipeline's kernels ran in {rec['k1_dtypes']} / {rec['k3_dtypes']}, not f32")

    # every output there and finite
    wdir = os.path.join(rundir, "wireframes")
    base = pkls[0][: -len("-neat.pkl")]
    for suffix in ("all.npz", "wfi.npz", "wfi_checked.npz", "neat.pkl"):
        require(os.path.exists(f"{base}-{suffix}"), f"finalize: no {base}-{suffix}")
    require(len(glob.glob(os.path.join(wdir, "*-distill.pkl"))) == 1, "finalize: no -distill.pkl")
    arrays = {f"{k}": v for k, v in results.items() if isinstance(v, np.ndarray)}
    for path in glob.glob(os.path.join(wdir, "*.npz")):
        with np.load(path) as z:
            arrays.update({f"{os.path.basename(path)}:{k}": z[k] for k in z.files})
    with open(glob.glob(os.path.join(wdir, "*-distill.pkl"))[0], "rb") as f:
        arrays.update({f"distill:{k}": v for k, v in pickle.load(f).items()})
    for key, a in arrays.items():
        require(bool(np.isfinite(a).all()), f"finalize: non-finite {key}")
    ev = os.path.join(rundir, "evaluation")
    epoch = rec["render_eval"]["epoch"]
    for name in ("psnr.csv", "eval_000.png", "normal_000.png", f"surface_{epoch}.ply"):
        require(os.path.exists(os.path.join(ev, name)), f"render eval: no evaluation/{name}")
    verts, faces = load_ply(os.path.join(ev, f"surface_{epoch}.ply"))
    require(bool(np.isfinite(verts).all()), "render eval: non-finite mesh vertices")
    require(math.isfinite(rec["render_eval"]["psnr_mean"]), "render eval: non-finite PSNR")
    rec.update(mesh_verts=len(verts), mesh_faces=len(faces), junctions=int(results["junctions3d_initial"].shape[0]),
               lines_all=int(results["lines3d_all"].shape[0]), lines_wfi=int(results["lines3d_wfi"].shape[0]),
               lines_wfi_checked=int(results["lines3d_wfi_checked"].shape[0]))

    # kernel route against plain route
    model, _ = load_model(os.path.join(rundir, "checkpoints"), "latest", cfg.model, "cuda")
    rec["compare"] = [compare_field_lines(field_lines_routes(model, cfg.model, scene, v), v) for v in FIN_COMPARE_VIEWS]
    rec["decisions"] = compare_decisions(model, cfg.model, scene, results, os.path.join(data_root, RUNNER_SCENE))
    grids = {}
    for route, kernels in (("kernel", True), ("plain", False)):
        fn, vals = RE.grid_sdf_fn(model, cfg.model, kernels), []

        def keep(p, fn=fn, vals=vals):
            vals.append(fn(p))
            return vals[-1]

        v, _ = sdf_to_mesh(keep, resolution=MESH_RES, grid_boundary=cfg.grid_boundary, chunk=MESH_CHUNK)
        grids[route] = (torch.from_numpy(np.concatenate(vals)), len(v))
    rec["grid_err"] = rel_err(grids["kernel"][0], grids["plain"][0])
    rec["grid_verts"] = {route: g[1] for route, g in grids.items()}
    require(rec["grid_err"] <= TOL["float32"], f"mesh grid: K1 f32 err {rec['grid_err']:.3g} > {TOL['float32']}")
    rec["kernels"] = time_eval_kernels(k1.seen, k3.seen, model, cfg.model)
    print_finalize(rec, card_line())
    fails = [f for c in rec["compare"] for f in c["failures"]]
    dec = rec["decisions"]
    if not dec["same"] and dec["off_f64"]["kernel"] > dec["off_f64"]["plain"]:
        fails.append(f"finalize: the kernels' wireframe {dec['kernel']} is farther from the f64 route's "
                     f"{dec['f64']} than plain f32's {dec['plain']}")
    e = rec["eval_abc"]
    for value, floor, what in ((rec["junctions"], TOY_MIN_JUNCTIONS, "junctions"),
                               (rec["lines_wfi_checked"], TOY_MIN_LINES, "wfi_checked lines"),
                               (e["junction_recall"][-1], TOY_MIN_RECALL, "eval_abc junction recall at 5%"),
                               (e["line_recall"][-1], TOY_MIN_RECALL, "eval_abc line recall at 5%"),
                               (rec["render_eval"]["psnr_mean"], TOY_MIN_PSNR, "view 0's PSNR")):
        if not value >= floor:
            fails.append(f"finalize: {what} {value} below the floor {floor}")
    require(not fails, "; ".join(fails))
    return rec


# ---------------------------------------------------------------------------
# the toy phase: scripts/run-abc-toy.sh's training, to a wireframe
# ---------------------------------------------------------------------------

# views of the toy scene: --vote-ratio 0.2 of 24 views asks 5 votes of a
# junction, the visibility check (--ckview 5) 5 views of a line
TOY_VIEWS = 24
# the runner's --nepoch: (TOY_EPOCHS + 1) x TOY_VIEWS = 3,240 steps, 1.5 x
# the 2,160 at which the calibration's floors first held (--nepoch 89;
# PERF.md §6, the toy recipe; neat_tpu_torch/tools/toy_curve.py)
TOY_EPOCHS = 134
# what phase 8 requires of the trained toy model (PERF.md §6, the toy recipe): the
# finalized wireframe's junctions and visibility-checked lines, eval_abc's
# junction and line recall at its largest threshold (5% of the scene's
# scale), view 0's PSNR in dB
TOY_MIN_JUNCTIONS, TOY_MIN_LINES, TOY_MIN_RECALL, TOY_MIN_PSNR = 4, 4, 0.5, 28.0


def toy_phase(seed=None, note=""):
    """abc-neat-a at full width trained through the runner's main
    (neat_tpu_torch/tools/toy_curve.py:train_toy) on a generated cuboid
    (abc/00075213: 8 junctions, 12 lines; 512 x 512 x TOY_VIEWS, seed 0),
    --nepoch TOY_EPOCHS, the runner's --seed where given: every step must
    launch exactly the main path's kernels (K1 x5, K2-fwd, the split
    K2-bwd) and every loss must be finite. Returns the rundir and data root
    phase 8 reads, the steps, the seconds and the losses. ``note`` goes
    with the printed times (what ran beside them)."""
    import shutil

    import numpy as np
    import torch

    from neat_tpu_torch.tools.toy_curve import make_scene, train_toy

    t_phase = time.perf_counter()
    work = toy_work(seed)
    shutil.rmtree(work, ignore_errors=True)
    data_root, exps = os.path.join(work, "data"), os.path.join(work, "exps")
    conf = os.path.join(REPO, RUNNER_CONF)
    t0 = time.perf_counter()
    make_scene(data_root, TOY_VIEWS, conf)
    rec = {"views": TOY_VIEWS, "epochs": TOY_EPOCHS, "seed": seed, "generate_s": time.perf_counter() - t0}

    fns = counters()
    expected = {k: PATHS["main"][1].get(k, 0) for k in fns}
    wrong = []

    def counted(step_fn):
        def step(state, scene, gen):
            before = {k: f.launches for k, f in fns.items()}
            state, aux = step_fn(state, scene, gen)
            launched = _launched(fns, before)
            if launched != expected:
                wrong.append((state.step, launched))
            return state, aux

        return step

    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner, per_step = train_toy(data_root, exps, TOY_EPOCHS, seed=seed, wrap_step=counted, conf=conf)
    torch.cuda.synchronize()
    rec["train_s"] = time.perf_counter() - t0
    rec["launches"] = {k: f.launches for k, f in fns.items()}
    steps = (TOY_EPOCHS + 1) * TOY_VIEWS
    loss = per_step[:, 0]
    require(not wrong, f"toy: {len(wrong)} steps launched other kernels than {expected}, the first {wrong[:1]}")
    require(len(loss) == steps, f"toy: {len(loss)} steps, expected {steps}")
    bad = [int(i) for i in (~np.isfinite(loss)).nonzero()[0]]
    require(not bad, f"toy: a non-finite loss at steps {bad[:5]}")
    with open(os.path.join(runner.rundir, "train.log")) as f:
        require(sum("rays/s)" in l for l in f) == TOY_EPOCHS + 1, "toy: train.log lacks an epoch line")
    res = tuple(runner.cfg.img_res)
    rec.update(res=list(res), rundir=runner.rundir, data_root=data_root, steps=steps,
               ms_per_step=1e3 * rec["train_s"] / steps, loss_first=float(loss[:TOY_VIEWS].mean()),
               loss_last=float(loss[-TOY_VIEWS:].mean()), launches_per_step=expected,
               seconds=time.perf_counter() - t_phase, note=note)
    seeded = f", --seed {seed}" if seed is not None else ""
    print(f"toy: abc-neat-a trained {steps} steps (N; --nepoch {TOY_EPOCHS}{seeded} of {TOY_VIEWS} views of "
          f"{res[0]} x {res[1]}, generated in {rec['generate_s']:.2f} s) in {rec['train_s']:.1f} s, "
          f"{rec['ms_per_step']:.2f} ms/step; mean loss of the first epoch {rec['loss_first']:.4f}, of the last "
          f"{rec['loss_last']:.4f}; every step {({k: v for k, v in expected.items() if v})}; the training "
          f"{rec['seconds']:.1f} s of the toy phase; {card_line()}{note}", flush=True)
    return rec


def toy_work(seed) -> str:
    """The toy phase's directory for a runner seed (None: the runner's own)."""
    return os.path.join(OUT_DIR, "toy" if seed is None else f"toy_seed{seed}")


def _toy_child(out: str, seed, note: str) -> None:
    """toy_phase in a process of its own; its record, or the failure that
    ended it, as JSON in ``out``."""
    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        status = {"ok": True, "rec": toy_phase(seed, note)}
    except SystemExit as e:  # require's failure
        status = {"ok": False, "error": str(e)}
    with open(out, "w") as f:
        json.dump(status, f)


def start_toy(seed=None, note=""):
    """The toy phase's training in a process of its own (spawned: CUDA),
    so that it can run beside other work on the card. -> (process, its
    JSON's path)."""
    import multiprocessing

    out = toy_work(seed) + ".json"
    if os.path.exists(out):
        os.remove(out)
    proc = multiprocessing.get_context("spawn").Process(target=_toy_child, args=(out, seed, note))
    proc.start()
    return proc, out


def join_toy(proc, out) -> dict:
    proc.join()
    require(proc.exitcode == 0 and os.path.exists(out), f"toy: the training process exited {proc.exitcode}")
    with open(out) as f:
        status = json.load(f)
    if not status["ok"]:
        raise SystemExit(status["error"])
    return status["rec"]


def run_toys(seeds, note=""):
    """One toy training process per runner seed, all at once; -> their
    records in the seeds' order. A process left running is ended."""
    procs = [start_toy(seed, note) for seed in seeds]
    try:
        return [join_toy(*p) for p in procs]
    finally:
        for proc, _ in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join()


def wireframe_numbers(results, scan) -> dict:
    """What a wireframe decides: its junctions, its visibility-checked
    lines and eval_abc's precision and recall of both."""
    from neat_tpu_torch.evaluation.eval_abc import eval_abc

    ev = eval_abc(results, scan, verbose=False)
    return {"junctions": int(results["junctions3d_initial"].shape[0]),
            "lines_wfi_checked": int(results["lines3d_wfi_checked"].shape[0]),
            **{k: [float(v) for v in ev[k]] for k in ("junction_precision", "junction_recall", "line_precision",
                                                     "line_recall")}}


def _flat(numbers) -> list:
    return [x for v in numbers.values() for x in (v if isinstance(v, list) else [v])]


def compare_decisions(model, cfg, scene, results, scan):
    """The finalize CLI's wireframe (the distillation on the f32 kernels)
    against the same checkpoint distilled on the plain f32 route over all
    views, assembled and checked with the CLI's own gates (the reference
    recipe's, as its kwargs record them): equal junction and line counts
    and equal eval_abc numbers. Where they differ, the plain f64 route is
    distilled too, and the kernels' numbers may be no farther from its
    numbers (the sum of |differences|) than plain f32's are."""
    import copy
    import functools

    import neat_tpu_torch.wireframe.finalize as F

    kw = results["kwargs"]

    def route(m, kernels):
        orig = F.view_field_lines
        F.view_field_lines = functools.partial(orig, kernels=kernels)
        try:
            t0 = time.perf_counter()
            d = F.distill_views(m, cfg, scene, chunksize=FIN_CHUNK, line_dis_threshold=kw["distance"],
                                junc_match_threshold=kw["junc_match_threshold"], verbose=False)
            secs = time.perf_counter() - t0
        finally:
            F.view_field_lines = orig
        r = F.assemble_wireframe(d, m, cfg, vote_threshold=kw["vote_threshold"])
        r["lines3d_wfi_checked"] = F.visibility_checking(r["lines3d_wfi"], scene, mindis_th=kw["ckdist"],
                                                         min_visible_views=kw["ckview"])
        return {**wireframe_numbers(r, scan), "distill_s": secs}

    rec = {"kernel": wireframe_numbers(results, scan), "plain": route(model, False)}
    rec["plain_distill_s"] = rec["plain"].pop("distill_s")
    rec["same"] = rec["kernel"] == rec["plain"]
    if not rec["same"]:
        rec["f64"] = route(copy.deepcopy(model).double(), False)
        rec["f64"].pop("distill_s")
        f64 = _flat(rec["f64"])
        rec["off_f64"] = {r: sum(abs(a - b) for a, b in zip(_flat(rec[r]), f64)) for r in ("kernel", "plain")}
    return rec


def print_finalize(r, card: str) -> None:
    print(f"finalize: {len(r['support'])} views, support pixels {r['support']} in {r['chunks']} chunks of "
          f"{FIN_CHUNK} rays; {r['finalize_s']:.2f} s (distillation {r['distill_s']:.2f}, the rest "
          f"{r['assemble_s']:.2f}); launches {r['finalize_launches']['fused_sdf']} K1 f32, "
          f"{r['finalize_launches']['field_fwd']} K3-fwd f32, nothing else; {r['junctions']} junctions, "
          f"{r['lines_all']} lines, {r['lines_wfi']} wfi, {r['lines_wfi_checked']} wfi_checked; {card}", flush=True)
    e = r["eval_abc"]
    print("eval_abc: junction P " + " ".join(f"{v:.3f}" for v in e["junction_precision"]) + " R "
          + " ".join(f"{v:.3f}" for v in e["junction_recall"]) + "; line P "
          + " ".join(f"{v:.3f}" for v in e["line_precision"]) + " R "
          + " ".join(f"{v:.3f}" for v in e["line_recall"]) + f" at {e['thresholds']}", flush=True)
    print(f"render eval: view 0 in {r['render_s']:.2f} s ({r['render_launches']['fused_sdf']} K1 f32, "
          f"{r['render_launches']['field_fwd']} K3-fwd f32), PSNR {r['render_eval']['psnr_mean']:.3f}; mesh at "
          f"{MESH_RES}^3 in {r['mesh_s']:.2f} s ({r['mesh_launches']['fused_sdf']} K1 f32), {r['mesh_verts']} "
          f"vertices, {r['mesh_faces']} faces; the CLI {r['render_eval_s']:.2f} s; {card}", flush=True)
    for c in r["compare"]:
        if "err" not in c:
            continue
        fmt = lambda med: json.dumps({k: [float(f"{x:.2e}") for x in v] for k, v in med.items()})
        print(f"finalize view {c['view']}, kernels against plain f32: {c['rays']} rays, {c['flipped_rays']} whose z "
              f"moved by > {FIN_Z_FLIP} (z moves: median {c['dz_quantiles'][0]:.2e}, 99% {c['dz_quantiles'][1]:.2e}, "
              f"max {c['dz_quantiles'][2]:.2e}); elsewhere err "
              f"{json.dumps({k: float(f'{v:.3g}') for k, v in c['err'].items()})}. Against each route's f64 shadow "
              f"(sampling as the route did), rays off by > {FIN_TOL} (kernels, plain f32) {json.dumps(c['off_f64'])}, "
              f"median ray {fmt(c['median_f64'])}; against the f64 route on its own decisions "
              f"{json.dumps(c['off_f64_own'])}, median ray {fmt(c['median_f64_own'])}; "
              f"{c['kernel_rays_per_s']:.1f} rays/s on the kernels, {c['plain_rays_per_s']:.1f} plain f32, "
              f"{c['f64_rays_per_s']:.1f} f64", flush=True)
    d = r["decisions"]
    print(f"finalize decisions, the whole distillation: on the kernels {json.dumps(d['kernel'])}; plain f32 "
          + ("the same" if d["same"] else f"{json.dumps(d['plain'])}; plain f64 {json.dumps(d['f64'])}; off f64 "
             f"(sum of |differences|) {json.dumps(d['off_f64'])}")
          + f"; plain f32 distilled in {d['plain_distill_s']:.2f} s", flush=True)
    print(f"finalize floors: {r['junctions']} junctions (>= {TOY_MIN_JUNCTIONS}), {r['lines_wfi_checked']} "
          f"wfi_checked (>= {TOY_MIN_LINES}), recall at 5% junctions {r['eval_abc']['junction_recall'][-1]:.3f} "
          f"lines {r['eval_abc']['line_recall'][-1]:.3f} (>= {TOY_MIN_RECALL}), view 0's PSNR "
          f"{r['render_eval']['psnr_mean']:.3f} (>= {TOY_MIN_PSNR}); {card}", flush=True)
    print(f"mesh grid, K1 f32 against plain: err {r['grid_err']:.3g}; vertices {r['grid_verts']['kernel']} on the "
          f"kernel, {r['grid_verts']['plain']} plain", flush=True)
    for key, k in r["kernels"].items():
        print(f"{k['kernel']} f32 n={k['n']}: err {k['err']:.3g} (scalar kernel {k['scalar_err']:.3g}); "
              + "; ".join(f"{o} {f64_text(f)}" for o, f in k["f64"].items())
              + f"; device {k['ms']:.3f} ms (the profiler saw {k['seen']} of 10), the scalar kernel "
              f"{k['scalar_ms']:.3f} ({k['scalar_seen']} of 10), plain {k['plain_ms']:.3f}, library "
              f"{k['library_ms']:.3f}; bound {k['bound_ms']:.3f} by {k['bound_by']} as 3xTF32 "
              f"({100 * k['share']:.1f}%, the scalar kernel {100 * k['scalar_share']:.1f}%), on the CUDA cores "
              f"{k['cuda_core_bound_ms']:.3f}; {card}", flush=True)


def finalize_kernel_entries(fin):
    """The kernels line's entries for the f32 K1 and K3-fwd at finalize's
    chunk shape; launches are finalize's over all views, render eval's and
    the mesh's beside them."""
    src = "neat_tpu_torch/csrc/"
    out = []
    for name, key, prefix, file, replaces in (
        ("fused_sdf_f32", "fused_sdf", "k1/", "fused_sdf_tf32.cu", "neat_tpu/ops/fused_sdf.py:66"),
        ("field_fwd_f32", "field_fwd", "k3/", "field_fwd_tf32.cu", "neat_tpu/ops/fused_field.py:210"),
    ):
        # finalize's chunk is the largest shape each kernel is handed
        rec = max((r for k, r in fin["kernels"].items() if k.startswith(prefix)), key=lambda r: r["n"])
        out.append(dict(
            name=name, route="cuda", source=src + file, replaces=replaces, launches=fin["finalize_launches"][key],
            max_abs_err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"], n=rec["n"],
            launches_render_view=fin["render_launches"][key], launches_mesh=fin["mesh_launches"][key],
            scalar_ms=rec["scalar_ms"], cuda_core_bound_ms=rec["cuda_core_bound_ms"]))
    return out


# ---------------------------------------------------------------------------
# the dtu phase: DBSCAN junction proposals on the card, the per-scan ABC and
# DTU confs through the training CLI, then the DTU evaluation
# ---------------------------------------------------------------------------

ABC_SCAN_CONF, ABC_SCAN, ABC_SCAN_VIEWS = os.path.join("confs", "abc", "abc-1776.conf"), os.path.join("abc", "00001776"), 8
# dtu.conf's own 1200 x 1600; DTU's 49-64 views cut to 16
DTU_CONF, DTU_VIEWS = os.path.join("confs", "dtu.conf"), 16
# the ground-truth frame of the generated DTU scene: every view's scale_mat.
# DTU's own are some 200-300 mm a unit; at that size eval_dtu's 0.2 mm mesh
# sampling of a surface takes minutes on the host, at 20 about a second
DTU_SCALE = ((20.0, 0.0, 0.0, 5.0), (0.0, 20.0, 0.0, -10.0), (0.0, 0.0, 20.0, 600.0), (0.0, 0.0, 0.0, 1.0))
# DBSCAN: the step's 2048 endpoints; the label iterations between two host
# checks that are timed; the means on the card against the CPU's (the sums
# in another order)
DBSCAN_N, DBSCAN_PERIODS, DBSCAN_MEANS_TOL = 2048, (1, 2, 4, 8, 16, 64), 1e-6
DEPTH_STEPS = 3
# rays a chunk of the dtu view's render eval: the CLI's 1,024 took 125 s for
# the 1200 x 1600 view on the card (1,875 chunks, the host's work a chunk),
# which the toy phase's training needs more
DTU_RENDER_CHUNK = 8192


def dbscan_points(seed: int = 0):
    """DBSCAN_N points from a numpy seed: 150 clumps of 2-10 points within
    0.002 of a centre (some repeated exactly, as rays through one pixel
    give) and isolated noise, in a random order, and in the middle an
    eps-chain of 130 links in index order (past the 64-iteration cap; as
    tests/test_sampling.py's chain, pointer jumping collapses it in about
    log2(130) iterations). No pair lies within a relative 1e-4 of eps
    unless it is a duplicate."""
    import numpy as np

    rs = np.random.RandomState(seed)
    pts = []
    for c in rs.uniform(-1.5, 1.5, (150, 3)):
        k = rs.randint(2, 11)
        p = c + rs.uniform(-0.002, 0.002, (k, 3))
        p[rs.rand(k) < 0.3] = p[0]
        pts.append(p)
    chain = np.zeros((130, 3)) + np.asarray([2.5, -2.5, -2.5])
    chain[:, 0] += np.arange(130) * 0.009
    pts = np.concatenate(pts)
    pts = np.concatenate([pts, rs.uniform(-3.0, 3.0, (DBSCAN_N - len(pts) - len(chain), 3))])
    pts = pts[rs.permutation(len(pts))]
    pts = np.concatenate([pts[: len(pts) // 2], chain, pts[len(pts) // 2:]]).astype(np.float32)
    d = np.sqrt(((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1))
    require(not ((d > 0) & (np.abs(d - 0.01) < 1e-6)).any(), "dbscan: a pair of points on the eps threshold")
    return pts


def check_dbscan(name, pts):
    """DBSCAN of pts (N, 3) on the card against its plain run on the CPU
    (the same code): the valid rows (the representatives) exactly, the
    means within DBSCAN_MEANS_TOL. Then, at each host-check period, a call's
    device time and launches (profiler events over 5 calls), its host syncs
    and label iterations, and its host ms (median of 10 calls)."""
    import torch

    from neat_tpu_torch.assignment import clustering as C

    f = C.dbscan_cluster_means
    cpu = pts.detach().float().cpu()
    m_ref, v_ref = f(cpu)
    dev = cpu.cuda()
    m, v = f(dev)
    torch.cuda.synchronize()
    require(torch.equal(v.cpu(), v_ref), f"dbscan {name}: the valid rows differ from the CPU run's")
    err = float((m.cpu()[v_ref] - m_ref[v_ref]).abs().max()) if bool(v_ref.any()) else 0.0
    require(err <= DBSCAN_MEANS_TOL, f"dbscan {name}: means {err:.3g} off the CPU run's")
    rec = {"n": int(cpu.shape[0]), "clusters": int(v_ref.sum()), "max_abs_err": err, "periods": {}}
    for k in DBSCAN_PERIODS:
        call = lambda k=k: f(dev, check_every=k)
        call()
        f.iterations = f.syncs = 0
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        it, syncs = f.iterations / 10, f.syncs / 10
        prof = profile_calls(f"dbscan_{name}_{k}", call, 5, os.path.join(OUT_DIR, f"profile_dbscan_{name}_{k}.txt"))
        rec["periods"][k] = {"iterations": it, "syncs": syncs, "host_ms": statistics.median(times),
                             "device_ms": prof["device_busy_ms_per_step"], "launches": prof["launches_per_step"]}
    # with a check after every iteration the loop stops where JAX's does
    rec["converged_at"] = rec["periods"][1]["iterations"]
    return rec


def print_dbscan(r, card: str) -> None:
    print(f"dbscan {r['name']}: {r['n']} points, {r['clusters']} clusters, the same valid rows on the card as "
          f"on the CPU, means {r['max_abs_err']:.3g} off; labels converge in {r['converged_at']:.0f} "
          f"iterations; {card}", flush=True)
    for k, p in r["periods"].items():
        print(f"  check every {k:2d}: {p['iterations']:.0f} iterations, {p['syncs']:.0f} host syncs, "
              f"{p['launches']:.0f} launches, device {p['device_ms']:.3f} ms, host {p['host_ms']:.3f} ms a call",
              flush=True)


def conf_runner(label, conf, data_root, exps):
    """neat_tpu_torch.train.runner.main on conf in this process, --nepoch 1
    (2 epochs, a step per view each). Every step's loss must be finite and
    every step must launch exactly the main path's kernels. Per step: the
    valid DBSCAN proposals, the junctions the 10 px gate kept, each
    auction's rounds, DBSCAN's label iterations and the host syncs of
    DBSCAN and the auctions; the first step's endpoints are kept."""
    import torch

    import neat_tpu_torch.model.loss as NL
    import neat_tpu_torch.model.neat as NM
    import neat_tpu_torch.train.step as ST
    from neat_tpu_torch.assignment.clustering import dbscan_cluster_means
    from neat_tpu_torch.assignment.matching import auction_assignment
    from neat_tpu_torch.train import runner as R

    fns = counters()
    expected = {k: PATHS["main"][1].get(k, 0) for k in fns}
    rec, steps, cur = {"label": label}, [], {}
    origs = {"run": R.TrainRunner.run, "db": NM.dbscan_cluster_means, "fwd": ST.neat_forward,
             "model_auction": NM.masked_assignment, "loss_auction": NL.masked_assignment}

    def db(points, *a, **k):
        means, valid = origs["db"](points, *a, **k)
        cur["valid"] = valid.sum()
        rec.setdefault("endpoints", points.detach().clone())
        return means, valid

    def fwd(*a, **k):
        out = origs["fwd"](*a, **k)
        cur["kept"] = out["j_local_mask"].sum()
        return out

    def rounds_of(which):
        def assign(*a, **k):
            r0 = auction_assignment.rounds
            res = origs[which](*a, **k)
            cur[which] = auction_assignment.rounds - r0
            return res

        return assign

    def run(self):
        rec.update(rundir=self.rundir, load_s=self.load_seconds, n_views=self.n_views,
                   support=[int(c) for c in self.scene.mask.sum(axis=1)],
                   device_bytes=sum(t.numel() * t.element_size() for t in self.scene_dev.values()))
        step_fn = self.step_fn

        def counted(state, scene, gen):
            before = {k: f.launches for k, f in fns.items()}
            syncs0 = (dbscan_cluster_means.iterations, dbscan_cluster_means.syncs, auction_assignment.syncs)
            cur.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, aux = step_fn(state, scene, gen)
            loss = float(aux["loss"])
            ms = (time.perf_counter() - t) * 1e3
            s = {"ms": ms, "loss": loss, "launches": _launched(fns, before), "valid": int(cur["valid"]),
                 "kept": int(cur["kept"]), "rounds": (cur["model_auction"], cur["loss_auction"]),
                 "dbscan_iterations": dbscan_cluster_means.iterations - syncs0[0],
                 "dbscan_syncs": dbscan_cluster_means.syncs - syncs0[1],
                 "auction_syncs": auction_assignment.syncs - syncs0[2]}
            steps.append(s)
            require(math.isfinite(loss), f"{label}: non-finite loss {loss} at step {state.step}")
            require(s["launches"] == expected, f"{label}: a step launched {s['launches']}, expected {expected}")
            return state, aux

        self.step_fn = counted
        return origs["run"](self)

    R.TrainRunner.run, NM.dbscan_cluster_means, ST.neat_forward = run, db, fwd
    NM.masked_assignment, NL.masked_assignment = rounds_of("model_auction"), rounds_of("loss_auction")
    try:
        for f in fns.values():
            f.launches = 0
        R.main(["--conf", conf, "--data_root", data_root, "--exps_folder", exps, "--nepoch", "1"])
    finally:
        R.TrainRunner.run, NM.dbscan_cluster_means, ST.neat_forward = origs["run"], origs["db"], origs["fwd"]
        NM.masked_assignment, NL.masked_assignment = origs["model_auction"], origs["loss_auction"]
    require(len(steps) == 2 * rec["n_views"], f"{label}: {len(steps)} steps")
    require(min(rec["support"]) > 0, f"{label}: a view has no support pixels: {rec['support']}")
    ms = [s["ms"] for s in steps[1:]]
    rec.update(steps=steps, median_ms=statistics.median(ms), q1_ms=statistics.quantiles(ms, n=4)[0],
               q3_ms=statistics.quantiles(ms, n=4)[2])
    return rec


def print_conf_runner(r, card: str) -> None:
    steps = r["steps"]
    print(f"{r['label']}: {len(steps)} steps, losses {steps[0]['loss']:.4f} .. {steps[-1]['loss']:.4f}, launches "
          f"per step {dict((k, v) for k, v in steps[0]['launches'].items() if v)}; median {r['median_ms']:.2f} ms/step "
          f"(quartiles {r['q1_ms']:.2f} .. {r['q3_ms']:.2f}) over the steps after the first, "
          f"{1024 / (r['median_ms'] / 1e3):.1f} rays/s; {card}", flush=True)
    print(f"  per step: valid DBSCAN proposals {[s['valid'] for s in steps]}", flush=True)
    print(f"  junctions the 10 px gate kept {[s['kept'] for s in steps]}", flush=True)
    print(f"  auction rounds (the proposals', the loss's) {[s['rounds'] for s in steps]}", flush=True)
    print(f"  DBSCAN label iterations {[s['dbscan_iterations'] for s in steps]}, host syncs of DBSCAN "
          f"{[s['dbscan_syncs'] for s in steps]} and of the auctions {[s['auction_syncs'] for s in steps]}",
          flush=True)
    print(f"  ms per step {[round(s['ms'], 1) for s in steps]}", flush=True)


def depth_steps(kind, conf_path, data_root, exps, label=None):
    """DEPTH_STEPS training steps through the runner's own step (conf_path:
    a conf with depth cues and loss.depth_weight / depth_loss_kind): finite
    losses, the main path's kernels and, with ``kind``, a depth term above
    0. Records the runner's set-up and scene load seconds and the scene's
    bytes on the device."""
    import torch

    from neat_tpu_torch.train import runner as R
    from neat_tpu_torch.train.step import step_generator

    label = label or f"depth {kind}"
    fns = counters()
    expected = {k: PATHS["main"][1].get(k, 0) for k in fns}
    t0 = time.perf_counter()
    r = R.TrainRunner(conf=conf_path, data_root=data_root, exps_folder=exps, nepochs=1)
    rec = {"kind": kind, "load_s": time.perf_counter() - t0, "scene_load_s": r.load_seconds,
           "n_views": r.n_views, "res": list(r.scene.img_res),
           "device_bytes": sum(t.numel() * t.element_size() for t in r.scene_dev.values()),
           "cue_pixels": int((r.scene.depth > 0).sum()) if r.scene.depth is not None else 0,
           "losses": [], "depth_losses": [], "ms": []}
    try:
        if kind is not None:
            require("depth" in r.scene_dev and r.cfg.loss.depth_loss_kind == kind and r.cfg.loss.depth_weight > 0,
                    f"{label}: the runner has no depth cues or no depth term")
        for _ in range(DEPTH_STEPS):
            before = {k: f.launches for k, f in fns.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            r.state, aux = r.step_fn(r.state, r.scene_dev, step_generator(0, 0, r.state.step, r.device))
            loss = float(aux["loss"])
            depth_loss = float(aux["depth_loss"]) if "depth_loss" in aux else 0.0  # no depth term: none
            rec["ms"].append((time.perf_counter() - t) * 1e3)
            rec["losses"].append(loss)
            rec["depth_losses"].append(depth_loss)
            require(math.isfinite(loss) and math.isfinite(depth_loss) and (kind is None or depth_loss > 0),
                    f"{label}: loss {loss}, depth term {depth_loss}")
            require(_launched(fns, before) == expected, f"{label}: a step launched {_launched(fns, before)}")
    finally:
        r.close()
    return rec


def dtu_pipeline(rundir, data_root, eval_dir, scan):
    """scripts/eval-neat-dtu.sh's order through the port's CLIs in this
    process: finalize (--ckview 5 --ckdist 100), eval_lsr in its junction
    and line modes against the generated ground truth (with the scene's
    scale_mat), render eval of view 0 with the mesh in the ground-truth
    frame, eval_dtu on that mesh. Launches counted: each field chunk of
    finalize and of the render runs the f32 K1 5 times and the f32 K3-fwd
    once, the mesh grid K1 alone; every output there and finite."""
    import glob

    import numpy as np
    import torch

    import neat_tpu_torch.evaluation.eval_dtu as ED
    import neat_tpu_torch.evaluation.eval_lsr as EL
    import neat_tpu_torch.evaluation.render_eval as RE
    import neat_tpu_torch.wireframe.finalize as F
    from neat_tpu_torch.train.config import load_experiment_config
    from neat_tpu_torch.viz.mesh import load_ply

    conf = os.path.join(rundir, "runconf.conf")
    cfg = load_experiment_config(conf)
    rounds = cfg.model.sampler.max_total_iters
    fns = counters()
    rec, timers = {}, {}

    def cli(name, fn, args):
        before = {k: f.launches for k, f in fns.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(args)
        torch.cuda.synchronize()
        rec[f"{name}_s"] = time.perf_counter() - t0
        rec[f"{name}_launches"] = _launched(fns, before)
        return out

    results = cli("finalize", F.main, ["--conf", conf, "--checkpoint", "latest", "--data_root", data_root,
                                       "--ckview", "5", "--ckdist", "100"])
    wdir = os.path.join(rundir, "wireframes")
    wfc = sorted(glob.glob(os.path.join(wdir, "*-wfi_checked.npz")), key=os.path.getmtime)
    require(len(wfc) == 1, f"finalize: {len(wfc)} -wfi_checked.npz files")
    arrays = {k: v for k, v in results.items() if isinstance(v, np.ndarray)}
    for path in glob.glob(os.path.join(wdir, "*.npz")):
        with np.load(path) as z:
            arrays.update({f"{os.path.basename(path)}:{k}": z[k] for k in z.files})
    for key, a in arrays.items():
        require(bool(np.isfinite(a).all()), f"finalize: non-finite {key}")
    fl = rec["finalize_launches"]
    require(fl["field_fwd"] > 0 and fl["fused_sdf"] == rounds * fl["field_fwd"]
            and sum(fl.values()) == fl["fused_sdf"] + fl["field_fwd"],
            f"finalize launched {fl}, expected the f32 K1 x{rounds} and K3-fwd x1 a chunk")
    rec.update(junctions=int(results["junctions3d_initial"].shape[0]), lines_all=int(results["lines3d_all"].shape[0]),
               lines_wfi_checked=int(results["lines3d_wfi_checked"].shape[0]))
    cams = os.path.join(data_root, cfg.data_dir, f"scan{scan}", "cameras.npz")
    for mode in ("junctions", "lines"):
        out = cli(f"eval_lsr_{mode}", EL.main, ["--mode", mode, "--data", wfc[0], "--scan", str(scan),
                                                "--dataset_dir", eval_dir, "--cameras", cams])
        rec[f"eval_lsr_{mode}"] = out
        if rec["lines_wfi_checked"]:
            require(all(math.isfinite(v) for v in out.values()), f"eval_lsr {mode}: {out}")
    origs = {name: time_calls(RE, name, fns, timers) for name in ("render_views_psnr", "export_scene_mesh")}
    try:
        rec["render_eval"] = cli("render_eval", RE.main, ["--conf", conf, "--checkpoint", "latest", "--data_root",
                                                          data_root, "--views", "0", "--chunksize",
                                                          str(DTU_RENDER_CHUNK)])
    finally:
        for name, orig in origs.items():
            setattr(RE, name, orig)
    h, w = cfg.img_res
    render_chunks, mesh_chunks = -(-h * w // DTU_RENDER_CHUNK), -(-MESH_RES ** 3 // MESH_CHUNK)
    rec["render_s"], rec["mesh_s"] = timers["render_views_psnr"]["s"], timers["export_scene_mesh"]["s"]
    expect = lambda **kw: dict.fromkeys(fns, 0) | kw
    for what, got, want in (
        ("render", timers["render_views_psnr"]["launches"],
         expect(fused_sdf=rounds * render_chunks, field_fwd=render_chunks)),
        ("mesh", timers["export_scene_mesh"]["launches"], expect(fused_sdf=mesh_chunks)),
    ):
        require(got == want, f"dtu {what} launched {got}, expected {want}")
    rec["render_chunks"] = render_chunks
    mesh = rec["render_eval"]["mesh"]
    verts, faces = load_ply(mesh)
    require(len(verts) > 0 and bool(np.isfinite(verts).all()), "render eval: an empty or non-finite mesh")
    require(math.isfinite(rec["render_eval"]["psnr_mean"]), "render eval: non-finite PSNR")
    ev = os.path.dirname(mesh)
    for name in ("psnr.csv", "eval_000.png", "normal_000.png"):
        require(os.path.exists(os.path.join(ev, name)), f"render eval: no evaluation/{name}")
    rec.update(mesh_verts=len(verts), mesh_faces=len(faces))
    rec["eval_dtu"] = cli("eval_dtu", ED.main, ["--data", mesh, "--scan", str(scan), "--dataset_dir", eval_dir])
    require(all(math.isfinite(v) for v in rec["eval_dtu"].values()), f"eval_dtu: {rec['eval_dtu']}")
    return rec


def print_dtu_pipeline(r, card: str) -> None:
    num = lambda d: ", ".join(f"{k} {v:.4g}" for k, v in d.items())
    print(f"dtu finalize: {r['finalize_s']:.2f} s, launches {r['finalize_launches']['fused_sdf']} K1 f32, "
          f"{r['finalize_launches']['field_fwd']} K3-fwd f32, nothing else; {r['junctions']} junctions, "
          f"{r['lines_all']} lines, {r['lines_wfi_checked']} wfi_checked; {card}", flush=True)
    for mode in ("junctions", "lines"):
        print(f"dtu eval_lsr --mode {mode}: {r[f'eval_lsr_{mode}_s']:.2f} s; {num(r[f'eval_lsr_{mode}'])}", flush=True)
    print(f"dtu render eval: view 0 in {r['render_s']:.2f} s ({r['render_chunks']} chunks; "
          f"{r['render_eval_launches']['fused_sdf']} K1 f32, {r['render_eval_launches']['field_fwd']} K3-fwd f32 "
          f"with the mesh), PSNR {r['render_eval']['psnr_mean']:.3f}; mesh {r['mesh_s']:.2f} s, {r['mesh_verts']} "
          f"vertices, {r['mesh_faces']} faces; the CLI {r['render_eval_s']:.2f} s; {card}", flush=True)
    print(f"dtu eval_dtu: {r['eval_dtu_s']:.2f} s; {num(r['eval_dtu'])}", flush=True)


def dtu_phase(card=None):
    """DBSCAN on the card against the CPU (2048 seeded points, and the
    endpoints of the DTU model's first step), abc-1776.conf and dtu.conf
    through the training CLI on generated scenes, 3 steps each with the
    l1 and the ssi depth term, and the DTU evaluation on the dtu run.
    ``card`` ends each printed line (default: the card's own line)."""
    import shutil

    import numpy as np
    import torch

    from neat_tpu_torch.data.datasets import load_scene_for_config
    from neat_tpu_torch.data.encodels import build_native, encode_line_attraction
    from neat_tpu_torch.data.synthetic import generate_scene, write_dtu_groundtruth
    from neat_tpu_torch.train.config import dump_hocon, load_experiment_config, parse_hocon, put_path

    work = os.path.join(OUT_DIR, "dtu")
    shutil.rmtree(work, ignore_errors=True)
    data_root, exps, eval_dir = (os.path.join(work, d) for d in ("data", "exps", "eval"))
    card = card or card_line()
    rec = {"dbscan": []}
    build_native()
    r = check_dbscan("seeded", torch.from_numpy(dbscan_points()))
    rec["dbscan"].append(dict(r, name="seeded"))

    # abc-1776 on a generated ABC-layout scene
    conf = os.path.join(REPO, ABC_SCAN_CONF)
    cfg = load_experiment_config(conf)
    require(cfg.data_dir == ABC_SCAN, f"{ABC_SCAN_CONF} names {cfg.data_dir}")
    generate_scene(os.path.join(data_root, ABC_SCAN), n_views=ABC_SCAN_VIEWS, res=tuple(cfg.img_res), seed=0)
    rec["abc"] = conf_runner("abc-1776", conf, data_root, exps)

    # dtu.conf on a generated DTU-layout scene at the conf's own size
    conf = os.path.join(REPO, DTU_CONF)
    cfg = load_experiment_config(conf)
    scan_dir = os.path.join(data_root, cfg.data_dir, f"scan{cfg.scan_id}")
    t0 = time.perf_counter()
    generate_scene(scan_dir, n_views=DTU_VIEWS, res=tuple(cfg.img_res), seed=0, convention="dtu",
                   scale_mat=np.asarray(DTU_SCALE), depth_dir="depth")
    rec["dtu_generate_s"] = time.perf_counter() - t0
    write_dtu_groundtruth(eval_dir, cfg.scan_id, np.asarray(DTU_SCALE))
    rec["dtu"] = conf_runner("dtu", conf, data_root, exps)
    scene = load_scene_for_config(cfg, data_root)
    t0 = time.perf_counter()
    for v in range(scene.n_images):
        encode_line_attraction(scene.lines[v, : scene.n_lines[v]], *scene.img_res, backend="native")
    rec["dtu_encodels_s"] = time.perf_counter() - t0
    del scene
    r = check_dbscan("dtu_step", rec["dtu"].pop("endpoints"))
    rec["dbscan"].append(dict(r, name="dtu step's endpoints"))
    rec["abc"].pop("endpoints")
    with open(conf) as f:
        text = f.read()
    for kind in ("l1", "ssi"):
        raw = parse_hocon(text)
        put_path(raw, "dataset.depth_dir", "depth")
        put_path(raw, "loss.depth_weight", 0.1)
        put_path(raw, "loss.depth_loss_kind", kind)
        path = os.path.join(work, f"dtu_depth_{kind}.conf")
        with open(path, "w") as f:
            f.write(dump_hocon(raw))
        rec[f"depth_{kind}"] = depth_steps(kind, path, data_root, exps)
    rec["pipeline"] = dtu_pipeline(rec["dtu"]["rundir"], data_root, eval_dir, cfg.scan_id)
    for r in rec["dbscan"]:
        print_dbscan(r, card)
    print_conf_runner(rec["abc"], card)
    d = rec["dtu"]
    print(f"dtu scene: {d['n_views']} views of {cfg.img_res[0]} x {cfg.img_res[1]} (DTU's 49-64 views cut to "
          f"{DTU_VIEWS}), generated in {rec['dtu_generate_s']:.2f} s, loaded in {d['load_s']:.2f} s (encodels "
          f"{rec['dtu_encodels_s']:.2f} s of it, native), {d['device_bytes'] / 1e9:.3f} GB on the device; support "
          f"pixels per view {d['support']}", flush=True)
    print_conf_runner(d, card)
    for kind in ("l1", "ssi"):
        r = rec[f"depth_{kind}"]
        print(f"dtu depth term {kind}: {DEPTH_STEPS} steps, losses {[round(x, 4) for x in r['losses']]}, depth "
              f"terms {[round(x, 4) for x in r['depth_losses']]}, ms {[round(x, 1) for x in r['ms']]}; the "
              f"runner's set-up {r['load_s']:.2f} s", flush=True)
    print_dtu_pipeline(rec["pipeline"], card)
    return rec


# ---------------------------------------------------------------------------
# the rest of the trainer: the JAX command line's flags and the ScanNet and
# scene_line scene kinds, through the training CLI
# ---------------------------------------------------------------------------

# a ScanNet-layout scene at ScanNet's 480 x 640 color size, its sparse cues a
# fifth of the pixels; the scene_line scene at dtu.conf's 1200 x 1600
SCANNET_RES, SCANNET_VIEWS, SCANNET_CUE_SHARE = (480, 640), 8, 0.2
SCENE_LINE_VIEWS = 4
# epochs of each run through the CLI: the first is left out of ms/step
CLI_EPOCHS = 5


def scene_split(scene) -> dict:
    """Whether a runner's scene is split over its group (shard_scene) and
    the bytes of the per-pixel tables this process holds."""
    from neat_tpu_torch.parallel.mesh import PER_PIXEL, ShardedScene

    sharded = isinstance(scene, ShardedScene)
    held = scene.local_bytes() if sharded else sum(scene[k].numel() * scene[k].element_size()
                                                   for k in PER_PIXEL if k in scene)
    return {"sharded": sharded, "pixel_bytes": held}


def cli_run(label, args, n_epochs, path="main"):
    """neat_tpu_torch.train.runner.main(args + --nepoch) in this process for
    n_epochs epochs; every call of the runner's step function (one step, or
    with --epoch_scan an epoch's steps) counted without a sync: each step
    the kernels of ``path`` (PATHS), and per call the host syncs of the callback
    assignment, of DBSCAN and of the auctions and the host ms of the
    callback's scipy work. Every loss must be finite (read after the run).
    ms/step comes from the runner's own clock, the rays/s of each epoch's
    log line, the same in both modes; the median over the epochs after the
    first."""
    import re

    import torch

    from neat_tpu_torch.assignment.clustering import dbscan_cluster_means
    from neat_tpu_torch.assignment.matching import auction_assignment, hungarian_callback
    from neat_tpu_torch.train import runner as R

    fns = counters()
    expected = {k: PATHS[path][1].get(k, 0) for k in fns}
    rec = {"label": label, "args": args, "calls": []}
    losses = []
    orig_run = R.TrainRunner.run

    def run(self):
        rec.update(rundir=self.rundir, load_s=self.load_seconds, n_views=self.n_views, n_rays=self.n_rays,
                   device_bytes=sum(t.numel() * t.element_size() for t in self.scene_dev.values()),
                   **scene_split(self.scene_dev))
        step_fn = self.step_fn

        def counted(state, scene, gens):
            k = len(gens) if isinstance(gens, list) else 1
            before = {name: f.launches for name, f in fns.items()}
            syncs0 = (hungarian_callback.syncs, hungarian_callback.host_s, dbscan_cluster_means.syncs,
                      auction_assignment.syncs)
            state, aux = step_fn(state, scene, gens)
            losses.append(aux["loss"].detach().reshape(-1))
            c = {"steps": k, "launches": _launched(fns, before),
                 "callback_syncs": hungarian_callback.syncs - syncs0[0],
                 "callback_host_ms": (hungarian_callback.host_s - syncs0[1]) * 1e3,
                 "dbscan_syncs": dbscan_cluster_means.syncs - syncs0[2],
                 "auction_syncs": auction_assignment.syncs - syncs0[3]}
            rec["calls"].append(c)
            want = {name: n * k for name, n in expected.items()}
            require(c["launches"] == want, f"{label}: {k} steps launched {c['launches']}, expected {want}")
            return state, aux

        self.step_fn = counted
        return orig_run(self)

    R.TrainRunner.run = run
    try:
        for f in fns.values():
            f.launches = 0
        R.main(args + ["--nepoch", str(n_epochs - 1)])
    finally:
        R.TrainRunner.run = orig_run
    losses = torch.cat(losses).tolist()
    calls = rec["calls"]
    steps = sum(c["steps"] for c in calls)
    require(steps == n_epochs * rec["n_views"] == len(losses), f"{label}: {steps} steps")
    require(all(math.isfinite(x) for x in losses), f"{label}: losses {losses}")
    with open(os.path.join(rec["rundir"], "train.log")) as f:
        rays_s = [float(m.replace(",", "")) for m in re.findall(r"\(([0-9,]+) rays/s\)", f.read())]
    require(len(rays_s) == n_epochs, f"{label}: {len(rays_s)} epoch lines in train.log")
    ms = [1e3 * rec["n_rays"] / x for x in rays_s]
    rec.update(steps=steps, epoch_ms_per_step=ms, median_ms=statistics.median(ms[1:] or ms), losses=losses,
               launches_per_step={k: v // calls[0]["steps"] for k, v in calls[0]["launches"].items() if v},
               callback_syncs_per_step=sum(c["callback_syncs"] for c in calls) / steps,
               # the first call imports scipy: left out
               callback_host_ms_per_step=statistics.median(c["callback_host_ms"] / c["steps"] for c in calls[1:]),
               dbscan_syncs_per_step=sum(c["dbscan_syncs"] for c in calls) / steps,
               auction_syncs_per_step=sum(c["auction_syncs"] for c in calls) / steps)
    return rec


def _latest_state(rundir):
    from neat_tpu_torch.train.checkpoint import load_checkpoint

    return load_checkpoint(os.path.join(rundir, "checkpoints"), "latest")[0]


def _max_param_diff(a, b) -> float:
    import numpy as np

    return max(float(np.abs(a["params"][k].astype(np.float64) - b["params"][k]).max()) for k in a["params"])


def nan_steps(conf, data_root, exps):
    """With NaN debugging on, one clean step of the runner's own step (no
    raise, the main path's kernels) and one after a parameter is set to NaN,
    which must raise FloatingPointError and leave the state as it was."""
    import torch

    from neat_tpu_torch.train import runner as R
    from neat_tpu_torch.train.checkpoint import host_state
    from neat_tpu_torch.train.step import step_generator
    from neat_tpu_torch.utils.profiling import enable_nan_debugging

    fns = counters()
    expected = {k: PATHS["main"][1].get(k, 0) for k in fns}
    r = R.TrainRunner(conf=conf, data_root=data_root, exps_folder=exps, nepochs=1)
    previous = enable_nan_debugging()
    rec = {}
    try:
        def step():
            return r.step_fn(r.state, r.scene_dev, step_generator(0, 0, r.state.step, r.device))

        before = {k: f.launches for k, f in fns.items()}
        r.state, aux = step()
        rec["clean_loss"] = float(aux["loss"])
        require(_launched(fns, before) == expected, f"debug_nans: the clean step launched {_launched(fns, before)}")
        with torch.no_grad():
            r.state.model.implicit.lin0.v[0, 0] = float("nan")
        state0 = host_state(r.state)
        try:
            step()
        except FloatingPointError as e:
            rec["raised"] = str(e)
        require("raised" in rec, "debug_nans: a step with a NaN parameter did not raise FloatingPointError")
        require(_same_state(state0, host_state(r.state)), "debug_nans: the raising step moved the state")
    finally:
        enable_nan_debugging(previous)
        r.close()
    return rec


def cli_phase(abc_data_root=None):
    """The training CLI on the JAX command line's flags and the two scene
    kinds, each step counted (the main path's kernels): abc-neat-a with and
    without --epoch_scan (--nepoch 1, the same seed, equal parameters);
    --debug_nans --batch_size 1 for an epoch, and a NaN step that raises;
    abc-1776 with the auction and with --assignment callback; a ScanNet
    conf on a generated 480 x 640 x 8-view scene with sparse depth_colmap
    cues (3 steps, the l1 depth term above 0); a scene_line conf on a
    generated 1200 x 1600 DTU-layout scene with the generator's own edges
    as lines3d (3 steps). ``abc_data_root``: the runner phase's data root,
    whose abc-neat-a scene is used (generated here without one)."""
    import shutil

    import numpy as np

    from neat_tpu_torch.data.synthetic import generate_scene
    from neat_tpu_torch.train.config import dump_hocon, load_experiment_config, parse_hocon, put_path

    t_phase = time.perf_counter()
    work = os.path.join(OUT_DIR, "cli")
    shutil.rmtree(work, ignore_errors=True)
    data_root, exps = os.path.join(work, "data"), os.path.join(work, "exps")
    rec = {}
    conf = os.path.join(REPO, RUNNER_CONF)
    cfg = load_experiment_config(conf)
    if abc_data_root is None:
        abc_data_root = data_root
        generate_scene(os.path.join(data_root, RUNNER_SCENE), n_views=RUNNER_VIEWS, res=tuple(cfg.img_res), seed=0)

    # --epoch_scan beside the steps one by one, from the same seed
    args = ["--conf", conf, "--data_root", abc_data_root, "--exps_folder", exps]
    rec["sequential"] = cli_run("abc-neat-a", args, CLI_EPOCHS)
    rec["epoch_scan"] = cli_run("abc-neat-a --epoch_scan", args + ["--epoch_scan"], CLI_EPOCHS)
    require(rec["epoch_scan"]["calls"][0]["steps"] == RUNNER_VIEWS, "epoch_scan: a call is not an epoch's steps")
    seq, scan = (_latest_state(rec[k]["rundir"]) for k in ("sequential", "epoch_scan"))
    rec["bit_equal"] = _same_state(seq, scan)
    rec["scan_diff"] = 0.0 if rec["bit_equal"] else _max_param_diff(seq, scan)
    # a process's first training run is bit for bit its later ones
    require(rec["bit_equal"], f"epoch_scan: parameters {rec['scan_diff']:.3g} off the sequential run's")

    # --debug_nans and --batch_size through the CLI, then a NaN step
    rec["debug_nans"] = cli_run("abc-neat-a --debug_nans --batch_size 1",
                                args + ["--debug_nans", "--batch_size", "1"], CLI_EPOCHS)
    rec["nan_step"] = nan_steps(conf, abc_data_root, exps)

    # abc-1776: the auction, then scipy's Hungarian on the host
    conf1776 = os.path.join(REPO, ABC_SCAN_CONF)
    cfg1776 = load_experiment_config(conf1776)
    generate_scene(os.path.join(data_root, ABC_SCAN), n_views=ABC_SCAN_VIEWS, res=tuple(cfg1776.img_res), seed=0)
    args = ["--conf", conf1776, "--data_root", data_root, "--exps_folder", exps]
    rec["auction"] = cli_run("abc-1776", args, CLI_EPOCHS)
    rec["callback"] = cli_run("abc-1776 --assignment callback", args + ["--assignment", "callback"], CLI_EPOCHS)
    require(rec["callback"]["callback_syncs_per_step"] == 2 and rec["callback"]["auction_syncs_per_step"] == 0,
            "callback: not two scipy assignments and no auction a step")

    with open(conf) as f:
        text = f.read()
    # ScanNet: abc-neat-a's model on a ScanNet-layout scene with sparse cues
    raw = parse_hocon(text)
    for key, value in (("train.dataset_class", "datasets.scannet_hawp_dataset.SceneDataset"),
                       ("dataset.data_dir", "scannet"), ("dataset.scan_id", "scene0000_00"),
                       ("dataset.img_res", list(SCANNET_RES)), ("loss.depth_weight", 0.1),
                       ("loss.depth_loss_kind", "l1")):
        put_path(raw, key, value)
    path = os.path.join(work, "scannet.conf")
    with open(path, "w") as f:
        f.write(dump_hocon(raw))
    scan_dir = os.path.join(data_root, "scannet", "scene0000_00")
    t0 = time.perf_counter()
    generate_scene(scan_dir, n_views=SCANNET_VIEWS, res=SCANNET_RES, seed=0, convention="scannet",
                   depth_dir="depth_colmap")
    rs = np.random.RandomState(0)
    for name in sorted(os.listdir(os.path.join(scan_dir, "depth_colmap"))):
        cue = os.path.join(scan_dir, "depth_colmap", name)
        d = np.load(cue)
        np.save(cue, np.where(rs.rand(*d.shape) < SCANNET_CUE_SHARE, d, 0.0).astype(np.float32))
    rec["scannet_generate_s"] = time.perf_counter() - t0
    rec["scannet"] = depth_steps("l1", path, data_root, exps, label="scannet")

    # scene_line: dtu.conf on a generated DTU-layout scene, its edges as lines3d
    dtu_text = open(os.path.join(REPO, DTU_CONF)).read()
    raw = parse_hocon(dtu_text)
    dcfg = load_experiment_config(os.path.join(REPO, DTU_CONF))
    scan_dir = os.path.join(data_root, dcfg.data_dir, f"scan{dcfg.scan_id}")
    t0 = time.perf_counter()
    generate_scene(scan_dir, n_views=SCENE_LINE_VIEWS, res=tuple(dcfg.img_res), seed=0, convention="dtu")
    rec["scene_line_generate_s"] = time.perf_counter() - t0
    with open(os.path.join(scan_dir, "lines.json")) as f:
        gt = json.load(f)
    npz = os.path.join(work, "lines3d.npz")
    np.savez(npz, lines3d=np.asarray(gt["junctions"], np.float32)[np.asarray(gt["lines"], np.int64)])
    put_path(raw, "train.dataset_class", "datasets.scene_line_dataset.SceneDataset")
    put_path(raw, "dataset.lines_npz", npz)
    path = os.path.join(work, "scene_line.conf")
    with open(path, "w") as f:
        f.write(dump_hocon(raw))
    rec["scene_line"] = depth_steps(None, path, data_root, exps, label="scene_line")
    require(rec["scene_line"]["cue_pixels"] > 0, "scene_line: no depth cue on any view")
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def print_cli(r, card: str) -> None:
    for key in ("sequential", "epoch_scan", "debug_nans", "auction", "callback"):
        c = r[key]
        print(f"cli {c['label']}: {c['steps']} steps in {len(c['calls'])} calls, losses {c['losses'][0]:.4f} .. "
              f"{c['losses'][-1]:.4f}; launches a step {c['launches_per_step']}; {c['median_ms']:.2f} ms/step "
              f"(the runner's epoch clock, median of the epochs after the first; each epoch "
              f"{[round(x, 2) for x in c['epoch_ms_per_step']]}); host syncs a step: callback "
              f"{c['callback_syncs_per_step']:.2f}, DBSCAN {c['dbscan_syncs_per_step']:.2f}, auction "
              f"{c['auction_syncs_per_step']:.2f}; scipy's host ms a step {c['callback_host_ms_per_step']:.3f} "
              f"(median after the first call); "
              f"{card}", flush=True)
    print(f"cli --epoch_scan against the steps one by one: {'bit for bit' if r['bit_equal'] else r['scan_diff']}",
          flush=True)
    print(f"cli --debug_nans: a clean step (loss {r['nan_step']['clean_loss']:.4f}), then a NaN parameter raised "
          f"FloatingPointError: {r['nan_step']['raised']}", flush=True)
    for key in ("scannet", "scene_line"):
        d = r[key]
        print(f"cli {key}: {d['n_views']} views of {d['res'][0]} x {d['res'][1]} generated in "
              f"{r[key + '_generate_s']:.2f} s, loaded in {d['scene_load_s']:.2f} s, {d['device_bytes'] / 1e9:.3f} "
              f"GB on the device, {d['cue_pixels']} cue pixels; {DEPTH_STEPS} steps, losses "
              f"{[round(x, 4) for x in d['losses']]}, depth terms {[round(x, 4) for x in d['depth_losses']]}, ms "
              f"{[round(x, 1) for x in d['ms']]}; {card}", flush=True)
    print(f"cli phase: {r['seconds']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# 11. the reference's model variants and JPEG views
# ---------------------------------------------------------------------------

VARIANT_VIEWS = 4  # views of each variant run's scene: its one epoch is 4 steps
K2_STEP = dict(field_fwd_stash=1, **K2_BWD)
# label: (train.model_class, the conf it swaps into, extra conf keys, K1
# launches a step, whether K2 runs: the table of ROADMAP.md §1, variants)
VARIANTS = {
    "rend_c": ("model.networks.neat_wfr_rend_c.VolSDFNetwork", ABC_SCAN_CONF, {}, 5, True),
    "junction_eikonal": ("model.networks.neat_wfr_rend_a.VolSDFNetwork", RUNNER_CONF,
                         {"model.junction_eikonal": True}, 5, True),
    "neat_uni": ("model.networks.neat_uni.VolSDFNetwork", RUNNER_CONF, {}, 0, True),
    "volsdf": ("model.network.VolSDFNetwork", RUNNER_CONF, {}, 0, False),
    "neat_wfr": ("model.networks.neat_wfr.VolSDFNetwork", RUNNER_CONF, {}, 5, False),
    "neat_wfr_a": ("model.networks.neat_wfr_a.VolSDFNetwork", RUNNER_CONF, {}, 5, False),
    "neat_simple": ("model.networks.neat_simple.VolSDFNetwork", RUNNER_CONF, {}, 5, False),
    "neat_wfr_dual": ("model.networks.neat_wfr_dual.VolSDFNetwork", RUNNER_CONF, {}, 10, False),
    "neat_along_ray": ("model.neat_along_ray.VolSDFNetwork", RUNNER_CONF, {}, 5, False),
    "neat_along_ray_v2": ("model.networks.neat_along_ray_v2.VolSDFNetwork", RUNNER_CONF, {}, 5, False),
}
JPEG_DIR = os.path.join("tests", "data", "jpeg")
# the 968 x 1296 frame of each kind the decode seconds per megapixel are timed on
JPEG_FRAMES = {"baseline": "frame_968x1296.jpg", "progressive": "frame_968x1296_progressive.jpg",
               "arithmetic progressive": "frame_968x1296_arith_progressive.jpg"}
JPEG_DECODES = 10  # decodes of each frame timed
JPEG_SCENE = dict(convention="scannet", n_views=4, res=(480, 640), seed=0)
JPEG_VIEWS = "scannet_480x640_progressive"  # the scene's committed views: progressive JPEGs


def variant_run(label, conf, data_root, exps, k1, k2, extra=(), views=VARIANT_VIEWS):
    """One epoch (``views`` steps) of a variant conf through the training
    CLI in this process, with the flags ``extra``; every step counted: K1
    ``k1`` times, K2 (forward, row-local pass, GEMM) once or not at all,
    nothing else; every loss finite. ms/step: the host clock around each
    step, which ends in a sync, the median of the steps after the first."""
    import torch

    from neat_tpu_torch.train import runner as R

    fns = counters()
    expected = dict.fromkeys(fns, 0) | {"fused_sdf": k1} | (K2_STEP if k2 else {})
    rec = {"label": label, "launches": [], "ms": [], "losses": []}
    orig_run = R.TrainRunner.run

    def run(self):
        rec.update(rundir=self.rundir, n_views=self.n_views, flags=(self.cfg.model.dbscan_enabled,
                                                                   self.cfg.model.dbscan_include_global),
                   **scene_split(self.scene_dev))
        step_fn = self.step_fn

        def counted(state, scene, gen):
            before = {name: f.launches for name, f in fns.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, aux = step_fn(state, scene, gen)
            rec["losses"].append(float(aux["loss"]))
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["launches"].append(_launched(fns, before))
            return state, aux

        self.step_fn = counted
        return orig_run(self)

    R.TrainRunner.run = run
    try:
        for f in fns.values():
            f.launches = 0
        R.main(["--conf", conf, "--data_root", data_root, "--exps_folder", exps, "--nepoch", "0", *extra])
    finally:
        R.TrainRunner.run = orig_run
    require(len(rec["ms"]) == rec["n_views"] == views, f"{label}: {len(rec['ms'])} steps")
    for c in rec["launches"]:
        require(c == expected, f"{label}: a step launched {c}, expected {expected}")
    require(all(math.isfinite(x) for x in rec["losses"]), f"{label}: losses {rec['losses']}")
    rec["median_ms"] = statistics.median(rec["ms"][1:])
    rec["launches_per_step"] = {k: v for k, v in rec["launches"][0].items() if v}
    return rec


def variant_eval(label, rundir, data_root):
    """The eval CLIs on a variant's checkpoint, every launch counted: for
    the wfr class finalize (its eval forward re-evaluates the attraction
    at l3d; the f32 K1, 5 launches a chunk, and the plain field: its
    no_view head is not the field kernels'), for the volsdf class render
    eval of view 0 and its mesh (the f32 K1 alone)."""
    import glob

    import numpy as np

    import neat_tpu_torch.evaluation.render_eval as RE
    import neat_tpu_torch.wireframe.finalize as F
    from neat_tpu_torch.data.datasets import load_scene_for_config
    from neat_tpu_torch.train.config import load_experiment_config

    fns = counters()
    conf = os.path.join(rundir, "runconf.conf")
    cfg = load_experiment_config(conf)
    rounds = cfg.model.sampler.max_total_iters
    expect = lambda **kw: dict.fromkeys(fns, 0) | kw
    rec = {}
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    if label == "neat_wfr":
        require(cfg.model.eval_attraction_at_l3d, "neat_wfr: the eval branch is off")
        scene = load_scene_for_config(cfg, data_root, distance_threshold=1.0)
        chunks = sum(-(-int(m.sum()) // FIN_CHUNK) for m in scene.mask)
        results = F.main(["--conf", conf, "--checkpoint", "latest", "--vote-ratio", "0.2", "--data_root", data_root])
        rec.update(what="finalize", chunks=chunks, launches={k: f.launches for k, f in fns.items()})
        require(rec["launches"] == expect(fused_sdf=rounds * chunks),
                f"neat_wfr finalize launched {rec['launches']}, expected {rounds} x {chunks} of K1")
        require(len(glob.glob(os.path.join(rundir, "wireframes", "*-neat.pkl"))) == 1, "neat_wfr: no -neat.pkl")
        for key, a in results.items():
            if isinstance(a, np.ndarray):
                require(bool(np.isfinite(a).all()), f"neat_wfr finalize: non-finite {key}")
        rec["lines"] = int(results["lines3d_all"].shape[0])
    else:
        out = RE.main(["--conf", conf, "--checkpoint", "latest", "--data_root", data_root, "--views", "0"])
        h, w = cfg.img_res
        want = rounds * -(-h * w // RENDER_CHUNK) + -(-MESH_RES ** 3 // MESH_CHUNK)
        rec.update(what="render eval", launches={k: f.launches for k, f in fns.items()}, psnr=out["psnr_mean"])
        require(rec["launches"] == expect(fused_sdf=want), f"volsdf render eval launched {rec['launches']}")
        require(math.isfinite(out["psnr_mean"]), "volsdf render eval: non-finite PSNR")
    rec["s"] = time.perf_counter() - t0
    return rec


def jpeg_part(work, data_root, exps):
    """The JPEG decoder on the card machine's host: every committed fixture
    (tests/data/jpeg) decoded and held to the SHA-256 of the reference's
    uint8 samples committed beside it, and each file the reference refuses
    refused (NotImplementedError, ValueError for the truncated one); decode
    seconds per megapixel of the 968 x 1296 frame as a baseline, a
    progressive and an arithmetic-coded progressive file (JPEG_DECODES
    decodes each); then 3 steps of abc-neat-a's model on a generated
    ScanNet-layout scene whose views are the committed progressive JPEG
    files, the main path's kernels every step."""
    import hashlib
    import shutil

    from neat_tpu_torch.data.jpeg import build_native, read_jpeg
    from neat_tpu_torch.data.synthetic import generate_scene
    from neat_tpu_torch.train.config import dump_hocon, parse_hocon, put_path

    rec = {"decode_s_per_mp": {}, "refused": {}}
    t0 = time.perf_counter()
    build_native()
    rec["build_s"] = time.perf_counter() - t0
    fixtures = os.path.join(REPO, JPEG_DIR)
    with open(os.path.join(fixtures, "sha256.json")) as f:
        digests = json.load(f)
    for name, want in digests.items():
        path = os.path.join(fixtures, name)
        if "refused" in want:
            try:
                read_jpeg(path)
            except (NotImplementedError, ValueError) as e:
                rec["refused"][name] = type(e).__name__
            require(name in rec["refused"], f"jpeg {name}: decoded, but the reference refuses it ({want['refused']})")
            continue
        got = read_jpeg(path)
        require(list(got.shape) == want["shape"] and hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"],
                f"jpeg {name}: the samples are not the reference's")
    rec["fixtures"] = len(digests)
    for kind, name in JPEG_FRAMES.items():
        frame = os.path.join(fixtures, name)
        img = read_jpeg(frame)
        t0 = time.perf_counter()
        for _ in range(JPEG_DECODES):
            read_jpeg(frame)
        rec["decode_s_per_mp"][kind] = (time.perf_counter() - t0) / JPEG_DECODES / (img.shape[0] * img.shape[1] / 1e6)
    scan_dir = os.path.join(data_root, "scannet", "scene0000_00")
    generate_scene(scan_dir, **JPEG_SCENE)
    for i in range(JPEG_SCENE["n_views"]):
        os.remove(os.path.join(scan_dir, "images", f"image_{i:04d}.png"))
        view = os.path.join(fixtures, JPEG_VIEWS, f"image_{i:04d}.jpg")
        with open(view, "rb") as f:
            require(b"\xff\xc2" in f.read(), f"jpeg scene: {view} is not progressive")
        shutil.copy(view, os.path.join(scan_dir, "images"))
    with open(os.path.join(REPO, RUNNER_CONF)) as f:
        raw = parse_hocon(f.read())
    for key, value in (("train.dataset_class", "datasets.scannet_hawp_dataset.SceneDataset"),
                       ("train.expname", "jpeg_scene"), ("dataset.data_dir", "scannet"),
                       ("dataset.scan_id", "scene0000_00"), ("dataset.img_res", list(JPEG_SCENE["res"]))):
        put_path(raw, key, value)
    path = os.path.join(work, "jpeg_scene.conf")
    with open(path, "w") as f:
        f.write(dump_hocon(raw))
    rec["scene"] = depth_steps(None, path, data_root, exps, label="progressive jpeg scene")
    require(rec["scene"]["n_views"] == JPEG_SCENE["n_views"], "jpeg scene: not every JPEG view loaded")
    return rec


def variant_conf(label, work) -> str:
    """VARIANTS[label]'s conf, written under ``work``: its path."""
    from neat_tpu_torch.train.config import dump_hocon, parse_hocon, put_path

    model_class, conf, extra, _, _ = VARIANTS[label]
    with open(os.path.join(REPO, conf)) as f:
        raw = parse_hocon(f.read())
    for key, value in {"train.model_class": model_class, "train.expname": f"variant_{label}", **extra}.items():
        put_path(raw, key, value)
    path = os.path.join(work, f"{label}.conf")
    with open(path, "w") as f:
        f.write(dump_hocon(raw))
    return path


def variants_phase():
    """Each model class of VARIANTS trains one epoch of VARIANT_VIEWS steps
    through the training CLI at abc-neat-a's full width (rend_c on
    abc-1776's conf, DBSCAN on), its K1 and K2 launches held to the table;
    finalize on the neat_wfr checkpoint, render eval of one view on the
    volsdf one; then the JPEG part."""
    import shutil

    from neat_tpu_torch.data.synthetic import generate_scene
    from neat_tpu_torch.train.config import load_experiment_config

    t_phase = time.perf_counter()
    work = os.path.join(OUT_DIR, "variants")
    shutil.rmtree(work, ignore_errors=True)
    data_root, exps = os.path.join(work, "data"), os.path.join(work, "exps")
    for conf, scene in ((RUNNER_CONF, RUNNER_SCENE), (ABC_SCAN_CONF, ABC_SCAN)):
        res = tuple(load_experiment_config(os.path.join(REPO, conf)).img_res)
        generate_scene(os.path.join(data_root, scene), n_views=VARIANT_VIEWS, res=res, seed=0)
    rec = {"runs": {}, "evals": {}}
    for label, (_, _, _, k1, k2) in VARIANTS.items():
        r = rec["runs"][label] = variant_run(label, variant_conf(label, work), data_root, exps, k1, k2)
        if label == "rend_c":
            require(r["flags"] == (True, True), f"rend_c: DBSCAN and the global junctions {r['flags']}")
        if label in ("neat_wfr", "volsdf"):
            rec["evals"][label] = variant_eval(label, r["rundir"], data_root)
    rec["jpeg"] = jpeg_part(work, data_root, exps)
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def print_variants(r, card: str) -> None:
    for label, c in r["runs"].items():
        print(f"variant {label}: {len(c['ms'])} steps, losses {[round(x, 4) for x in c['losses']]}; launches a step "
              f"{c['launches_per_step']}; {c['median_ms']:.2f} ms/step (host clock, median after the first step; "
              f"each {[round(x, 1) for x in c['ms']]}); {card}", flush=True)
    for label, e in r["evals"].items():
        extra = f", {e['lines']} lines" if "lines" in e else f", PSNR {e['psnr']:.3f}"
        print(f"variant {label} {e['what']}: {e['s']:.2f} s, launches "
              f"{ {k: v for k, v in e['launches'].items() if v} }{extra}", flush=True)
    j = r["jpeg"]
    d = j["scene"]
    per_mp = ", ".join(f"{kind} {v:.4f}" for kind, v in j["decode_s_per_mp"].items())
    print(f"jpeg: decoder built in {j['build_s']:.2f} s; {j['fixtures'] - len(j['refused'])} fixtures equal the "
          f"reference's SHA-256, {len(j['refused'])} refused as the reference refuses them {j['refused']}; s per "
          f"megapixel of the 968 x 1296 frame ({JPEG_DECODES} decodes, the card machine's host): {per_mp}; a scene of "
          f"{d['n_views']} progressive JPEG views of {d['res'][0]} x {d['res'][1]} loaded in {d['scene_load_s']:.2f} s, "
          f"{DEPTH_STEPS} steps (K1 x5 and the split K2 each), losses {[round(x, 4) for x in d['losses']]}, ms "
          f"{[round(x, 1) for x in d['ms']]}; {card}", flush=True)
    print(f"variants phase: {r['seconds']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 12: multi-GPU, the data-parallel step through the CLI at world size 1
# ---------------------------------------------------------------------------

# epochs of each run of phase 12 (8 steps each); the first is left out of ms/step
MULTI_EPOCHS = 2
# render eval's chunks in phase 12: fewer than the CLI's 1024-ray default, so
# fewer host round trips (most of a rendered view's time, PERF.md §5)
MULTI_RENDER_CHUNK = 8192
# the device kernels behind each launch counter, as the profiler names them:
# K1's tensor-core kernel, the bf16 field forward (K2-fwd, K3-fwd and K3-bwd's
# chunk forwards), the row-local pass, the weight-gradient GEMM
PROFILED = {"fused_sdf_mma": ("fused_sdf",),
            "field_fwd_mma": ("field_fwd_stash", "field_fwd", "field_bwd_chunk_fwd"),
            "field_bwd_mma": ("field_bwd_rowlocal", "field_bwd_chunk_rowlocal"),
            "dw_gemm": ("field_dw", "field_bwd_chunk_dw")}
PROFILED_STEPS = 3
GATHER_STEPS = 5  # steps whose sharded gathers are timed by CUDA events
# the variants the JAX package's shard_map step refuses
MULTI_VARIANTS = ("neat_wfr_dual", "junction_eikonal")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _group_of_one():
    """The CLI flags of an NCCL group of this one process."""
    return ["--mesh", "--distributed", "--coordinator", f"127.0.0.1:{_free_port()}", "--num_processes", "1",
            "--process_id", "0"]


def time_gathers(r, n_steps):
    """The sharded gather's device ms a step: CUDA events around each
    ``take_columns`` call (its indexing and its NCCL all-reduce) and
    around each of its all-reduces alone, over ``n_steps`` of the runner's
    steps -> (gather ms a step, all-reduce ms a step, gathers a step). The
    events also count the time the device waits for the host to launch
    the gather's small ops."""
    import torch
    import torch.distributed as dist

    from neat_tpu_torch.train import step as S
    from neat_tpu_torch.train.step import step_generator

    orig_take, orig_reduce = S.take_columns, dist.all_reduce
    events = {"gather": [], "reduce": []}

    def timed(fn, key):
        def call(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events[key].append((start, end))
            return out

        return call

    S.take_columns, dist.all_reduce = timed(orig_take, "gather"), timed(orig_reduce, "reduce")
    try:
        for _ in range(n_steps):
            r.state, _ = r.step_fn(r.state, r.scene_dev, step_generator(0, 0, r.state.step, r.device))
        torch.cuda.synchronize()
    finally:
        S.take_columns, dist.all_reduce = orig_take, orig_reduce
    ms = {k: sum(a.elapsed_time(b) for a, b in v) / n_steps for k, v in events.items()}
    return ms["gather"], ms["reduce"], len(events["gather"]) / n_steps


def profile_sharded(conf, data_root, exps, field_path):
    """In an NCCL group of this process: the CLI's runner with --mesh, one
    warm-up step, then PROFILED_STEPS steps under torch.profiler; the device
    kernels named in PROFILED counted against the launch counters of the
    same steps, and the NCCL kernels' device time a step (the sharded
    gather's all-reduces; the gradient sum makes none at world size 1).
    Then GATHER_STEPS steps with the sharded gather timed by CUDA events,
    and one NCCL all-reduce of a flat buffer of every gradient leaf, what
    a step's gradient sum costs over a group of several, timed by CUDA
    events."""
    import torch
    import torch.distributed as dist

    from neat_tpu_torch.parallel.mesh import init_distributed
    from neat_tpu_torch.train import runner as R
    from neat_tpu_torch.train.step import step_generator

    device = init_distributed("cuda", f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        r = R.TrainRunner(conf=conf, data_root=data_root, exps_folder=exps, nepochs=1, use_mesh=True,
                          field_path=field_path, device=device)
        fns = counters()
        require(r.shard is not None and r.shard.size == 1, "multigpu: the runner took no shard")
        split = scene_split(r.scene_dev)
        require(split["sharded"], "multigpu: the runner's scene is not split over its group")

        def one():
            r.state, _ = r.step_fn(r.state, r.scene_dev, step_generator(0, 0, r.state.step, r.device))

        one()
        before = {k: f.launches for k, f in fns.items()}
        prof = profile_calls(f"multigpu {field_path}", one, PROFILED_STEPS,
                             os.path.join(OUT_DIR, f"profile_multigpu_{field_path}.txt"))
        launched = _launched(fns, before)
        seen = {name: sum(round(cnt * PROFILED_STEPS) for _, cnt, key in prof["rows"] if name in key)
                for name in PROFILED}
        want = {name: sum(launched[c] for c in names) for name, names in PROFILED.items()}
        nccl = [(ms, cnt, key) for ms, cnt, key in prof["rows"] if "nccl" in key.lower()]
        gather_ms, reduce_ms_step, gathers = time_gathers(r, GATHER_STEPS)
        flat = torch.randn(sum(p.numel() for p in r.state.model.parameters()), device=device)
        reduce_ms = time_ms(lambda: dist.all_reduce(flat, op=dist.ReduceOp.SUM), 20)
        r.close()
    finally:
        dist.destroy_process_group()
    require(seen == want, f"multigpu {field_path}: the profiler saw {seen}, the counters {want}")
    return {"profiled_kernels": seen, "launches": launched, "wall_ms": prof["wall_ms_per_step"],
            "device_busy_ms": prof["device_busy_ms_per_step"], "idle_share": prof["idle_share"],
            "launches_per_step": prof["launches_per_step"],
            "nccl_ms_per_step": sum(ms for ms, _, _ in nccl), "nccl_kernels": [key[:80] for _, _, key in nccl],
            "all_reduce_ms": reduce_ms, "grad_bytes": 4 * flat.numel(), "gather_ms_per_step": gather_ms,
            "gather_reduce_ms_per_step": reduce_ms_step, "gathers_per_step": gathers,
            "pixel_bytes": split["pixel_bytes"]}


def _outputs(directory, names):
    out = {}
    for name in names:
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = f.read()
    return out


def multigpu_phase(abc_data_root=None):
    """Phase 12: the data-parallel path at world size 1 through the real
    NCCL group (the card machine has one GPU). The training CLI with --mesh
    --distributed --coordinator ... --num_processes 1 --process_id 0 beside
    the plain runner on abc-neat-a's scene, in turns (plain, mesh, mesh,
    plain), every step counted (the main path's kernels), the parameters of
    every mesh run bit for bit the plain runs'; the same pair with
    --field_path recompute (K3's launches); each path's sharded step
    profiled (the device kernels against the counters; the NCCL time) and
    its gradient all-reduce timed. Then finalize and render eval with --mesh
    1 on the first plain run's rundir, equal to the runs without it, and
    --mesh 2, which must raise."""
    import shutil

    import numpy as np

    from neat_tpu_torch.data.synthetic import generate_scene
    from neat_tpu_torch.evaluation import render_eval as RE
    from neat_tpu_torch.train.config import load_experiment_config
    from neat_tpu_torch.wireframe import finalize as F

    t_phase = time.perf_counter()
    work = os.path.join(OUT_DIR, "multigpu")
    shutil.rmtree(work, ignore_errors=True)
    exps = os.path.join(work, "exps")
    conf = os.path.join(REPO, RUNNER_CONF)
    if abc_data_root is None:
        abc_data_root = os.path.join(work, "data")
        cfg = load_experiment_config(conf)
        generate_scene(os.path.join(abc_data_root, RUNNER_SCENE), n_views=RUNNER_VIEWS, res=tuple(cfg.img_res),
                       seed=0)
    args = ["--conf", conf, "--data_root", abc_data_root, "--exps_folder", exps]
    rec = {"runs": []}
    for label, path, extra in (("plain", "main", []), ("mesh", "main", _group_of_one()),
                               ("mesh", "main", _group_of_one()), ("plain", "main", []),
                               ("plain recompute", "recompute", ["--field_path", "recompute"]),
                               ("mesh recompute", "recompute", ["--field_path", "recompute", *_group_of_one()])):
        rec["runs"].append(cli_run(label, args + extra, MULTI_EPOCHS, path))
    for r in rec["runs"]:
        require(r["sharded"] == r["label"].startswith("mesh"),
                f"multigpu {r['label']}: the scene is {'' if r['sharded'] else 'not '}split over a group")
    rec["pixel_bytes"] = {"whole": rec["runs"][0]["pixel_bytes"], "rank": rec["runs"][1]["pixel_bytes"]}
    states = [_latest_state(r["rundir"]) for r in rec["runs"]]
    for i, j in ((0, 1), (0, 2), (0, 3), (4, 5)):
        require(_same_state(states[i], states[j]),
                f"multigpu: {rec['runs'][j]['label']} run {j} off {rec['runs'][i]['label']} run {i} by "
                f"{_max_param_diff(states[i], states[j]):.3g}")
    for label in ("plain", "mesh"):
        ms = [m for r in rec["runs"][:4] if r["label"] == label for m in r["epoch_ms_per_step"][1:]]
        rec[f"{label}_ms"] = statistics.median(ms)
    rec["profile"] = {p: profile_sharded(conf, abc_data_root, exps, p) for p in ("stash", "recompute")}

    # the variants JAX runs only without its kernels (gspmd): here every
    # mode keeps them, K1 and K2 as on one device, bit for bit
    rec["variants"] = {}
    for label in MULTI_VARIANTS:
        vconf, (_, _, _, k1, k2) = variant_conf(label, work), VARIANTS[label]
        runs = [variant_run(f"{label} {tag}", vconf, abc_data_root, exps, k1, k2, extra, RUNNER_VIEWS)
                for tag, extra in (("plain", []), ("mesh", _group_of_one()))]
        require(_same_state(*(_latest_state(r["rundir"]) for r in runs)),
                f"multigpu: {label} with --mesh off the run without it")
        require([r["sharded"] for r in runs] == [False, True], f"multigpu: {label}: the mesh run's scene is not split")
        rec["variants"][label] = {"launches_per_step": runs[1]["launches_per_step"],
                                  "ms": [r["median_ms"] for r in runs]}

    # finalize and render eval with --mesh 1 against without, on one rundir
    rundir = rec["runs"][0]["rundir"]
    fin_args = ["--conf", os.path.join(rundir, "runconf.conf"), "--checkpoint", "latest", "--data_root",
                abc_data_root, "--overwrite"]
    re_args = ["--conf", os.path.join(rundir, "runconf.conf"), "--checkpoint", "latest", "--data_root",
               abc_data_root, "--views", "0", "--resolution", "40", "--chunksize", str(MULTI_RENDER_CHUNK)]
    fns = counters()
    outs = {}
    for mesh in ([], ["--mesh", "1"]):
        for f in fns.values():
            f.launches = 0
        t0 = time.perf_counter()
        fin = F.main(fin_args + mesh)
        fin_s = time.perf_counter() - t0
        fin_launches = {k: f.launches for k, f in fns.items() if f.launches}
        t0 = time.perf_counter()
        stats = RE.main(re_args + mesh)
        re_s = time.perf_counter() - t0
        ev = os.path.join(rundir, "evaluation")
        outs[bool(mesh)] = {"finalize": fin, "finalize_s": fin_s, "finalize_launches": fin_launches,
                            "render_eval_s": re_s, "psnr": stats["psnr_mean"],
                            "files": _outputs(ev, ("eval_000.png", "normal_000.png", "psnr.csv",
                                                   f"surface_{stats['epoch']}.ply"))}
    a, b = outs[False], outs[True]
    same_fin = a["finalize"].keys() == b["finalize"].keys() and all(
        np.array_equal(np.asarray(a["finalize"][k]), np.asarray(b["finalize"][k]))
        for k in a["finalize"] if k != "kwargs")
    require(same_fin, "multigpu: finalize --mesh 1 differs from finalize without it")
    require(a["finalize_launches"] == b["finalize_launches"] and a["finalize_launches"].get("fused_sdf", 0) > 0,
            f"multigpu: finalize launches {a['finalize_launches']} without --mesh, {b['finalize_launches']} with")
    require(a["files"] == b["files"], "multigpu: render eval --mesh 1 wrote other files than without it")
    rec["finalize"] = {k: {x: v[x] for x in ("finalize_s", "finalize_launches", "render_eval_s", "psnr")}
                       for k, v in (("single", a), ("mesh1", b))}
    for name, main in (("finalize", lambda a: F.main(fin_args + a)), ("render_eval", lambda a: RE.main(re_args + a))):
        for key, flags, message in (("mesh2", ["--mesh", "2"], "requested a 2-device mesh"),
                                    ("cpu_mesh1", ["--device", "cpu", "--mesh", "1"], "--device cpu")):
            try:
                main(flags)
            except ValueError as e:
                rec[f"{name}_{key}"] = str(e)
            require(message in rec.get(f"{name}_{key}", ""), f"multigpu: {name} {' '.join(flags)} ran")
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def print_multigpu(r, card: str) -> None:
    for c in r["runs"]:
        print(f"multigpu {c['label']}: {c['steps']} steps, losses {c['losses'][0]:.4f} .. {c['losses'][-1]:.4f}; "
              f"launches a step {c['launches_per_step']}; {c['median_ms']:.2f} ms/step", flush=True)
    for path, p in r["profile"].items():
        print(f"multigpu profile {path} (NCCL, world size 1): wall {p['wall_ms']:.2f} ms/step, device busy "
              f"{p['device_busy_ms']:.2f} ms/step in {p['launches_per_step']:.0f} launches/step, idle share "
              f"{p['idle_share']:.3f}; kernels over {PROFILED_STEPS} steps {p['profiled_kernels']}; NCCL kernels "
              f"{p['nccl_ms_per_step']:.4f} ms/step {p['nccl_kernels']}; the sharded gather "
              f"{p['gather_ms_per_step']:.4f} ms/step, its {p['gathers_per_step']:.0f} all-reduces alone "
              f"{p['gather_reduce_ms_per_step']:.4f} ms/step (CUDA events, {GATHER_STEPS} steps); per-pixel tables held {p['pixel_bytes'] / 1e6:.2f} MB; one NCCL all-reduce "
              f"of the gradients ({p['grad_bytes'] / 1e6:.2f} MB; none in the step at world size 1) "
              f"{p['all_reduce_ms']:.4f} ms", flush=True)
    for label, v in r["variants"].items():
        print(f"multigpu {label}: launches a step under --mesh {v['launches_per_step']}, bit for bit the run "
              f"without it; ms/step plain {v['ms'][0]:.2f}, mesh {v['ms'][1]:.2f}", flush=True)
    f1, f2 = r["finalize"]["single"], r["finalize"]["mesh1"]
    print(f"multigpu finalize: {f1['finalize_s']:.2f} s, --mesh 1 {f2['finalize_s']:.2f} s (launches "
          f"{f2['finalize_launches']}); render eval {f1['render_eval_s']:.2f} s, --mesh 1 {f2['render_eval_s']:.2f} s, "
          f"PSNR {f2['psnr']:.4f}; outputs equal; --mesh 2: {r['finalize_mesh2']}; --device cpu --mesh 1: "
          f"{r['finalize_cpu_mesh1']}", flush=True)
    print(f"multigpu ms/step in turns (plain, mesh, mesh, plain; {MULTI_EPOCHS - 1} epochs each after the first): "
          f"single device {r['plain_ms']:.2f}, data-parallel at world size 1 (NCCL, the scene split by "
          f"shard_scene) {r['mesh_ms']:.2f}; parameters bit for bit equal; per-pixel tables "
          f"{r['pixel_bytes']['whole'] / 1e6:.2f} MB whole, {r['pixel_bytes']['rank'] / 1e6:.2f} MB held by the rank; "
          f"phase {r['seconds']:.1f} s; {card}", flush=True)


# ---------------------------------------------------------------------------
# 13. the periphery
# ---------------------------------------------------------------------------

# --nepoch of the --do_vis run: previews at the start of epochs 1 .. PERI_EPOCHS;
# the exit save rewrites checkpoint PERI_EPOCHS, so epochs 1 .. PERI_EPOCHS - 1
# keep the parameters their preview drew
PERI_EPOCHS = 3
PERI_PROFILED_CHUNKS = 4  # preview chunks traced by torch.profiler
# the f32 kernels' device names (csrc/fused_sdf_tf32.cu, csrc/field_fwd_tf32.cu)
F32_KERNELS = ("fused_sdf_tf32_kernel", "field_fwd_tf32_kernel")
TRACED = ("fused_sdf_mma", "field_fwd_mma", "field_bwd_mma", "dw_gemm")


def _eval_chunks(scene, views, chunk) -> int:
    return sum(-(-int(scene.mask[v].sum()) // chunk) for v in views)


def _counted(fn, *args):
    """fn(*args) with every launch counter set to 0 just before and read
    just after -> (result, launches)."""
    fns = counters()
    for f in fns.values():
        f.launches = 0
    out = fn(*args)
    return out, {k: f.launches for k, f in fns.items()}


def _colmap_model_of(scene, directory):
    """A COLMAP text model of a scene's cameras (PINHOLE, one a view) and
    64 seeded points -> the world mats K [R | t] the conversion must give."""
    import numpy as np

    from neat_tpu_torch.colmap_tools.model_io import Camera, Image, Point3D, rotmat2qvec, write_model

    cams, imgs, want = {}, {}, {}
    for v in range(scene.n_images):
        k = np.asarray(scene.intrinsics[v], np.float64)[:3, :3]
        w2c = np.linalg.inv(np.asarray(scene.pose[v], np.float64))
        name = f"{v:04d}.png"
        cams[v + 1] = Camera(v + 1, "PINHOLE", scene.img_res[1], scene.img_res[0],
                             np.asarray([k[0, 0], k[1, 1], k[0, 2], k[1, 2]]))
        imgs[v + 1] = Image(v + 1, rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], v + 1, name, np.zeros((0, 2)),
                            np.zeros((0,), np.int64))
        p = np.eye(4)
        p[:3] = k @ w2c[:3]
        want[name] = p
    rs = np.random.RandomState(0)
    pts = {j: Point3D(j, rs.normal(size=3) * 0.5, rs.randint(0, 256, 3), 0.5, np.asarray([1, 2]),
                      np.asarray([0, 0])) for j in range(1, 65)}
    os.makedirs(directory, exist_ok=True)
    write_model(cams, imgs, pts, directory, ext=".txt")
    return [want[n] for n in sorted(want)]


def periphery_phase(abc_data_root=None):
    """13. The periphery on the card: abc-neat-a (plot_freq and
    checkpoint_freq 1) through the CLI with --do_vis --use_tb --gitexp in a
    git repository of its own, between two plain runs of the same conf;
    every step and every preview chunk counted; each kept preview's render
    panel against render_view of its checkpoint, bit for bit; 4 preview
    chunks profiled (the f32 K1 x5 and K3-fwd x1 a chunk by name); the
    debug tools in their three modes; the checkpoint exported to a
    reference .pth, imported back bit for bit, converted into a new rundir
    and finalized; two training steps under utils/profiling.py:trace; the
    viewer's record and replay on the run's junctions; colmap_tools.convert
    on a text model of the scene's cameras; monodepth's exit without a
    backend. ``abc_data_root``: the runner phase's data root."""
    import glob
    import re
    import shutil

    import numpy as np
    import torch

    import neat_tpu_torch.wireframe.debug_tools as D
    import neat_tpu_torch.wireframe.finalize as F
    from neat_tpu_torch.colmap_tools import convert as C
    from neat_tpu_torch.data import monodepth as M
    from neat_tpu_torch.data.datasets import load_scene_for_config
    from neat_tpu_torch.data.png import read_png
    from neat_tpu_torch.data.synthetic import generate_scene
    from neat_tpu_torch.evaluation.render_eval import render_view
    from neat_tpu_torch.interop import convert_checkpoint as IC
    from neat_tpu_torch.interop import torch_export as IE
    from neat_tpu_torch.interop.torch_import import import_reference_checkpoint
    from neat_tpu_torch.model.neat import eval_kernel_config, forward_on_mesh
    from neat_tpu_torch.train.checkpoint import load_checkpoint, load_model
    from neat_tpu_torch.train.config import dump_hocon, load_experiment_config, parse_hocon, put_path
    from neat_tpu_torch.train.step import step_generator
    from neat_tpu_torch.utils.benchscene import bench_scene, bench_step
    from neat_tpu_torch.utils.chunking import split_input
    from neat_tpu_torch.utils.profiling import trace
    from neat_tpu_torch.viz import raster, viewer as V

    t_phase = time.perf_counter()
    work = os.path.join(OUT_DIR, "periphery")
    shutil.rmtree(work, ignore_errors=True)
    data_root, exps = os.path.join(work, "data"), os.path.join(work, "exps")
    os.makedirs(exps)
    # --gitexp commits into this repository, the nearest one to the runs
    subprocess.run(["git", "init", "-q", exps], check=True)
    rec = {}
    base = load_experiment_config(os.path.join(REPO, RUNNER_CONF))
    if abc_data_root is None:
        abc_data_root = data_root
        generate_scene(os.path.join(data_root, RUNNER_SCENE), n_views=RUNNER_VIEWS, res=tuple(base.img_res), seed=0)
    with open(os.path.join(REPO, RUNNER_CONF)) as f:
        raw = parse_hocon(f.read())
    put_path(raw, "train.plot_freq", 1)
    put_path(raw, "train.checkpoint_freq", 1)
    conf = os.path.join(work, "abc-neat-a-vis.conf")
    with open(conf, "w") as f:
        f.write(dump_hocon(raw))
    cfg = load_experiment_config(conf)
    rounds = cfg.model.sampler.max_total_iters
    h, w = cfg.img_res
    preview_chunks = -(-h * w // cfg.split_n_pixels)
    args = ["--conf", conf, "--data_root", abc_data_root, "--exps_folder", exps]

    # 1. training with --do_vis --use_tb --gitexp, between two plain runs
    runs = {}
    runs["plain_a"] = cli_run("periphery plain", args, PERI_EPOCHS + 1)
    t0 = time.perf_counter()
    vis = runs["vis"] = cli_run("periphery --do_vis", args + ["--do_vis", "--use_tb", "--gitexp"], PERI_EPOCHS + 1)
    vis_s = time.perf_counter() - t0
    launched = {k: f.launches for k, f in counters().items()}
    runs["plain_b"] = cli_run("periphery plain", args, PERI_EPOCHS + 1)
    steps = vis["steps"]
    previews = PERI_EPOCHS
    want = dict.fromkeys(launched, 0) | {k: n * steps for k, n in PATHS["main"][1].items()}
    want["fused_sdf"] += rounds * preview_chunks * previews
    want["field_fwd"] += preview_chunks * previews
    require(launched == want, f"periphery --do_vis: launched {launched}, expected {want}")
    rundir = vis["rundir"]
    plots = os.path.join(rundir, "plots")
    names = sorted(os.listdir(plots))
    want_names = sorted(["cameras.png"] + [f"rendering_{e}_{e % RUNNER_VIEWS}.png" for e in range(1, previews + 1)]
                        + [f"junctions_{e}.png" for e in range(1, previews + 1)])
    require(names == want_names, f"periphery: plots/ holds {names}, expected {want_names}")
    shapes = {n: read_png(os.path.join(plots, n)).shape for n in names}
    scene = load_scene_for_config(cfg, abc_data_root)
    panels = []
    for e in range(1, previews):
        model, _ = load_model(os.path.join(rundir, "checkpoints"), str(e), cfg.model, "cuda")
        out = render_view(model, cfg.model, scene, e % RUNNER_VIEWS, chunksize=cfg.split_n_pixels)
        grid = read_png(os.path.join(plots, f"rendering_{e}_{e % RUNNER_VIEWS}.png"))
        (y, x, ph, pw), *_ = raster.panel_boxes([(h, w)] * 3)[1]
        same = bool(np.array_equal(grid[y : y + ph, x : x + pw], raster.to_uint8(out["rgb"])))
        panels.append(same)
        require(same, f"periphery: the render panel of epoch {e} is not render_view of checkpoint {e}")
    with open(os.path.join(rundir, "train.log")) as f:
        log = f.read()
    preview_s = [float(x) for x in re.findall(r"preview of epoch \d+: view \d+ in ([0-9.]+) s", log)]
    require(len(preview_s) == previews, f"periphery: {len(preview_s)} preview lines in train.log")
    events = glob.glob(os.path.join(rundir, "logs", "events.out.tfevents.*"))
    tb_warned = "tensorboard unavailable; continuing without" in log
    require(bool(events) or tb_warned, "periphery --use_tb: no event file and no warning")
    commits = subprocess.run(["git", "-C", exps, "log", "--format=%an|%s"], capture_output=True, text=True).stdout
    git_warned = "gitexp commit failed" in log
    committed = commits.startswith(f"expbot|experiment {cfg.expname}/{os.path.basename(rundir)}")
    require(committed or git_warned, f"periphery --gitexp: no expbot commit ({commits!r}) and no warning")

    # the preview's chunks by name under the profiler
    model, _ = load_model(os.path.join(rundir, "checkpoints"), "1", cfg.model, "cuda")
    uv = scene.uv_full()
    chunks = iter(split_input({"uv": uv, "uv_proj": uv}, uv.shape[0], n_pixels=cfg.split_n_pixels))
    ecfg = eval_kernel_config(cfg.model, "cuda")
    cams = {"intrinsics": scene.intrinsics[1], "pose": scene.pose[1]}

    def one_chunk():
        c = next(chunks)
        forward_on_mesh([model], {"uv": c["uv"], "uv_proj": c["uv_proj"], **cams}, ecfg)

    prof = profile_calls("periphery preview chunks", one_chunk, PERI_PROFILED_CHUNKS,
                         os.path.join(OUT_DIR, "profile_periphery_preview.txt"))
    seen = {name: sum(round(cnt * PERI_PROFILED_CHUNKS) for _, cnt, key in prof["rows"] if name in key)
            for name in F32_KERNELS}
    want_seen = {"fused_sdf_tf32_kernel": rounds * PERI_PROFILED_CHUNKS, "field_fwd_tf32_kernel": PERI_PROFILED_CHUNKS}
    require(seen == want_seen, f"periphery: the profiler saw {seen} in {PERI_PROFILED_CHUNKS} chunks, not {want_seen}")
    rec.update(runs={k: {x: r[x] for x in ("rundir", "median_ms", "epoch_ms_per_step", "steps")}
                     for k, r in runs.items()},
               vis_wall_s=vis_s, launches=launched, plots=names, png_shapes={k: list(v) for k, v in shapes.items()},
               panels_equal=panels, preview_s=preview_s, preview_chunks=preview_chunks, tb_events=len(events),
               tb_warned=tb_warned, git_committed=committed, git_warned=git_warned, profiled=seen,
               profile_chunk_busy_ms=prof["device_busy_ms_per_step"], profile_chunk_wall_ms=prof["wall_ms_per_step"])

    # 2. the debug tools on the card
    runconf = os.path.join(rundir, "runconf.conf")
    scene1 = load_scene_for_config(cfg, abc_data_root, distance_threshold=1.0)
    scene5 = load_scene_for_config(cfg, abc_data_root, distance_threshold=5.0)
    dbg = os.path.join(rundir, "debug")
    tools = {}
    for mode, sc, views in (("recon", scene1, range(RUNNER_VIEWS)), ("softmax", scene5, [0]), ("show", scene1, [0])):
        n = _eval_chunks(sc, views, 2048)
        t0 = time.perf_counter()
        _, got = _counted(D.main, ["--conf", runconf, "--data_root", abc_data_root, "--mode", mode, "--view", "0"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        expect = dict.fromkeys(got, 0) | {"fused_sdf": rounds * n, "field_fwd": n}
        require(got == expect, f"debug_tools {mode}: launched {got}, expected {expect} ({n} chunks)")
        tools[mode] = {"chunks": n, "seconds": secs}
    for path in ("debug_lines.npz", "softmax_view0000.npz", "show_view0000.png",
                 *[os.path.join("masks", f"{v:04d}.png") for v in range(RUNNER_VIEWS)]):
        require(os.path.exists(os.path.join(dbg, path)), f"debug_tools: no debug/{path}")
    require(read_png(os.path.join(dbg, "show_view0000.png")).shape == (h, w, 3), "debug_tools: show overlay size")
    require(read_png(os.path.join(dbg, "masks", "0000.png")).shape == (h, w, 4), "debug_tools: mask size")
    rec["debug_tools"] = tools

    # 3. interop: export, import back, convert, finalize
    pth = os.path.join(work, "export.pth")
    epoch = IE.main(["--rundir", rundir, "--out", pth])
    host, _ = load_checkpoint(os.path.join(rundir, "checkpoints"), "latest")
    back = import_reference_checkpoint(pth, cfg.model)
    same = sorted(back) == sorted(host["params"]) and all(
        back[k].numpy().tobytes() == host["params"][k].tobytes() and back[k].numpy().dtype == host["params"][k].dtype
        for k in back)
    require(same, "interop: the exported .pth does not import back bit for bit")
    converted = os.path.join(work, "converted")
    IC.main(["--pth", pth, "--conf", conf, "--out", converted])
    chost, cepoch = load_checkpoint(os.path.join(converted, "checkpoints"), "latest")
    require(cepoch == epoch and all(chost["params"][k].tobytes() == v.tobytes() for k, v in host["params"].items()),
            "interop: the converted rundir's parameters are not the run's")
    n = _eval_chunks(scene1, range(RUNNER_VIEWS), FIN_CHUNK)
    t0 = time.perf_counter()
    _, got = _counted(F.main, ["--conf", os.path.join(converted, "runconf.conf"), "--checkpoint", "latest",
                               "--data_root", abc_data_root])
    fin_s = time.perf_counter() - t0
    expect = dict.fromkeys(got, 0) | {"fused_sdf": rounds * n, "field_fwd": n}
    require(got == expect, f"interop finalize: launched {got}, expected {expect}")
    require(len(glob.glob(os.path.join(converted, "wireframes", "*-neat.pkl"))) == 1, "interop: finalize wrote no -neat.pkl")
    rec["interop"] = {"epoch": epoch, "pth_bytes": os.path.getsize(pth), "finalize_s": fin_s, "finalize_chunks": n}

    # 4. two training steps under profiling.trace
    bcfg = path_config("main")
    bscene = bench_scene(bcfg, device="cuda")
    step, state = bench_step(bcfg, device="cuda")
    gen = step_generator(0, 0, 0, "cuda")
    state, _ = step(state, bscene, gen)
    with trace(os.path.join(work, "trace")) as prof:
        for _ in range(2):
            state, _ = step(state, bscene, gen)
    with open(prof.trace_path) as f:
        text = f.read()
    named = {k: text.count(k) for k in TRACED}
    require(all(named.values()), f"periphery trace: kernels missing from {prof.trace_path}: {named}")
    rec["trace"] = {"bytes": len(text), "named": named}

    # 5. viewer, COLMAP, monodepth
    pts = np.load(os.path.join(rundir, "junctions", f"{PERI_EPOCHS}.npy"))
    npz = os.path.join(work, "junction_wireframe.npz")
    np.savez(npz, lines3d=np.stack([pts[:-1], pts[1:]], 1), junctions3d_initial=pts)
    rec_dir, rep_dir = os.path.join(work, "record"), os.path.join(work, "replay")
    require(V.main(["--data", npz, "--mode", "record", "--frames", "4", "--out", rec_dir, "--show-junctions"]) == 4,
            "viewer: record")
    require(V.main(["--data", npz, "--mode", "replay", "--cam_dir", rec_dir, "--out", rep_dir]) == 4, "viewer: replay")
    require(read_png(rep_dir + ".png").shape == (512, 512, 3), "viewer: the replay animation")
    want_mats = _colmap_model_of(scene, os.path.join(work, "colmap"))
    out = C.main(["--model", os.path.join(work, "colmap"), "--out", os.path.join(work, "cameras.npz"),
                  "--no-normalize"])
    z = np.load(out)
    # relative to each matrix's largest entry: the rotation goes through a
    # quaternion, the rotation nearest the scene's float32 one (orthonormal
    # to about 6e-8)
    err = max(float(np.abs(z[f"world_mat_{i}"] - m).max() / np.abs(m).max()) for i, m in enumerate(want_mats))
    require(len(z.files) == 2 * RUNNER_VIEWS and err < 1e-6, f"colmap: world mats off by {err} (relative)")
    img_dir = os.path.join(abc_data_root, RUNNER_SCENE, "images")
    backend = M._try_omnidata("depth") or M._try_transformers_dpt()
    if backend is None:
        try:
            M.run(img_dir, os.path.join(work, "cues"))
            require(False, "monodepth: no backend, and no exit")
        except SystemExit as e:
            require("No monocular-cue backend" in str(e), f"monodepth: {e}")
    rec.update(viewer_frames=4, colmap_world_mat_err=err, monodepth_backend=backend)
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def print_periphery(r, card: str) -> None:
    ms = {k: v["median_ms"] for k, v in r["runs"].items()}
    print(f"periphery ms/step in turns (plain, --do_vis --use_tb --gitexp, plain; runner's epoch clock, "
          f"previews outside it): plain {ms['plain_a']:.2f} / {ms['plain_b']:.2f}, vis {ms['vis']:.2f}; vis run "
          f"{r['vis_wall_s']:.1f} s wall; one preview ({r['preview_chunks']} chunks) "
          f"{', '.join(f'{s:.2f}' for s in r['preview_s'])} s; {card}", flush=True)
    print(f"periphery: launches { {k: v for k, v in r['launches'].items() if v} }; panels equal to render_view "
          f"{r['panels_equal']}; profiler per {PERI_PROFILED_CHUNKS} chunks {r['profiled']} (device busy "
          f"{r['profile_chunk_busy_ms']:.2f} ms a chunk, wall {r['profile_chunk_wall_ms']:.2f}); tensorboard "
          f"{'events' if r['tb_events'] else 'warned'}, gitexp {'committed' if r['git_committed'] else 'warned'}",
          flush=True)
    print("periphery debug tools: " + ", ".join(f"{m} {t['chunks']} chunks {t['seconds']:.2f} s"
                                                for m, t in r["debug_tools"].items())
          + f"; interop: export/import bit for bit, finalize of the converted rundir {r['interop']['finalize_s']:.2f} s; "
          f"trace names {r['trace']['named']}; colmap world mats rel err {r['colmap_world_mat_err']:.3g}; monodepth "
          f"backend {r['monodepth_backend']}; phase {r['seconds']:.1f} s; {card}", flush=True)


# ---------------------------------------------------------------------------

# the toy phase: the main path's sources; finalize's f32 ones and the scalar
# kernels they are held against
TOY_SOURCES = ("fused_sdf", "field_fwd_mma", "fused_field_stash", "field_dw_mma", "field_bwd_mma", "fused_field",
               "fused_sdf_tf32", "field_fwd_tf32")
# --only <kernel>: the libraries that kernel's checks build (the kernel's
# own and the scalar kernel it is held against; for K4, K1's, which the
# sampler run that makes its inputs launches)
ONLY = {"k1": ("fused_sdf", "fused_sdf_tf32"), "k2": ("field_fwd_mma", "fused_field_stash"),
        "k3": ("field_fwd_mma", "fused_field", "field_fwd_tf32"),
        "k2b": ("field_dw_mma", "fused_field_stash", "field_bwd_mma"),
        "k3b": ("field_fwd_mma", "fused_field_stash", "field_dw_mma", "field_bwd_mma", "fused_field"),
        "runner": ("fused_sdf", "field_fwd_mma", "fused_field_stash", "field_dw_mma", "field_bwd_mma"),
        "k4": ("fused_round", "fused_sdf"),
        "toy": TOY_SOURCES, "finalize": TOY_SOURCES,
        "dtu": ("fused_sdf", "field_fwd_mma", "fused_field_stash", "field_dw_mma", "field_bwd_mma", "fused_field",
                "fused_sdf_tf32", "field_fwd_tf32"),
        "cli": ("fused_sdf", "field_fwd_mma", "fused_field_stash", "field_dw_mma", "field_bwd_mma"),
        "variants": ("fused_sdf", "field_fwd_mma", "fused_field_stash", "field_dw_mma", "field_bwd_mma",
                     "fused_sdf_tf32"),
        "multigpu": ("fused_sdf", "field_fwd_mma", "fused_field_stash", "field_dw_mma", "field_bwd_mma",
                     "fused_field", "fused_sdf_tf32", "field_fwd_tf32"),
        "periphery": ("fused_sdf", "field_fwd_mma", "fused_field_stash", "field_dw_mma", "field_bwd_mma",
                      "fused_sdf_tf32", "field_fwd_tf32")}


def print_runner(r, card: str) -> None:
    print(f"runner scene: {r['views']} views of {r['res'][0]} x {r['res'][1]} generated in {r['generate_s']:.2f} s, "
          f"loaded in {r['load_s'][0]:.3f} s (resumed run {r['load_s'][1]:.3f} s); encodels native build "
          f"{r['encodels_build_s']:.2f} s, run {r['encodels_run_s']:.3f} s over {r['views']} views; support "
          f"pixels per view {r['support']}", flush=True)
    print(f"runner: {len(r['losses'])} steps, losses {r['losses'][0]:.4f} .. {r['losses'][-1]:.4f}, launches per step "
          f"{ {k: v for k, v in r['launches_per_step'].items() if v} }; median {r['median_ms']:.2f} ms/step "
          f"(quartiles {r['q1_ms']:.2f} .. {r['q3_ms']:.2f}) over the {r['n_timed']} steps after each run's "
          f"first, {r['rays_per_sec']:.1f} rays/s; {card}", flush=True)
    if "profile" in r:
        prof = r["profile"]
        print(f"profile runner: wall {prof['wall_ms_per_step']:.2f} ms/step, device busy "
              f"{prof['device_busy_ms_per_step']:.2f} ms/step in {prof['launches_per_step']:.0f} launches/step, "
              f"idle share {prof['idle_share']:.3f}", flush=True)
        for ms, cnt, key in prof["top"][:6]:
            print(f"  {ms:9.3f} ms/step {cnt:7.1f}x  {key[:100]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="build + small kernel checks only")
    ap.add_argument("--only", choices=tuple(ONLY), default=None,
                    help="build one library and run its kernel's checks and timings alone")
    ap.add_argument("--profile", action="store_true",
                    help="also trace 3 steps of each path and of the runner with torch.profiler "
                         "(build/chip_smoke/profile_<path>.txt)")
    ap.add_argument("--turns", type=int, default=0, metavar="N",
                    help="also time N steps of each path, the paths taken in turns")
    ap.add_argument("--toy_seeds", type=int, nargs="+", default=None, metavar="SEED",
                    help="with --only toy: train the toy model once for each runner seed, all at once, and "
                         "hold each to phase 8 (default: the runner's own seed)")
    args = ap.parse_args()
    t_start = time.perf_counter()

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
    logs = _build.build_all(ONLY[args.only] if args.only else _build.SOURCES)
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = logs
    print(f"build: {report['build_s']:.1f} s ({', '.join(sorted(logs)) or 'cached'})", flush=True)
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or (args.only and "Compiling entry" in line):
                print(f"  ptxas {name}: {line.strip()[:160]}")

    cfg = bench_config("bfloat16", device="cuda")
    model = init_neat(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    os.makedirs(OUT_DIR, exist_ok=True)
    n_main = 1024 * (cfg.sampler.n_samples + cfg.sampler.n_samples_extra + 2)  # the main field pass
    from neat_tpu_torch.ops.fused_field import recompute_chunks

    require(len(recompute_chunks(n_main)) == K3_CHUNKS, "K3_CHUNKS is not the main field pass's chunk count")
    if args.only:
        if args.only == "k1":
            report["k1"] = k1_phase(model, cfg, gen, args.quick)
            for r in report["k1"]:
                print_k1(r)
        elif args.only == "k2b":
            report["k2b"] = k2b_phase(model, cfg, gen, args.quick, n_main)
            for r in report["k2b"]:
                print_k2b(r)
        elif args.only == "runner":
            report["runner"] = runner_phase(os.path.join(OUT_DIR, "profile_runner.txt") if args.profile else None)
            print_runner(report["runner"], card)
        elif args.only == "k4":
            report["k4"] = k4_phase(model, cfg, gen, args.quick)
            print_k4(report["k4"])
        elif args.only in ("toy", "finalize"):
            seeds = args.toy_seeds or [None]
            note = f"; contended: {len(seeds)} trainings at once on this card" if len(seeds) > 1 else ""
            toys = run_toys(seeds, note)
            report["toy"], report["finalize"] = toys[0], []
            for toy in toys:  # each seed's model held by phase 8, in turn
                report["finalize"].append(finalize_phase(toy["rundir"], toy["data_root"]))
        elif args.only == "dtu":
            report["dtu"] = dtu_phase()
        elif args.only == "cli":
            report["cli"] = cli_phase()
            print_cli(report["cli"], card)
        elif args.only == "variants":
            report["variants"] = variants_phase()
            print_variants(report["variants"], card)
        elif args.only == "multigpu":
            report["multigpu"] = multigpu_phase()
            print_multigpu(report["multigpu"], card)
        elif args.only == "periphery":
            report["periphery"] = periphery_phase()
            print_periphery(report["periphery"], card)
        elif args.only == "k3b":
            report["k3b"], report["k3b_chunk"] = k3b_phase(model, cfg, gen, args.quick, n_main)
            for r in report["k3b"]:
                print_k3(r)
            print_k3_chunk(report["k3b_chunk"])
        else:
            report[args.only] = fwd_phase(args.only, model, cfg, gen, args.quick, n_main)
            for r in report[args.only]:
                print_fwd(r)
        report["seconds"] = time.perf_counter() - t_start
        report["profiler_retries"] = PROFILER_RETRIES
        with open(os.path.join(OUT_DIR, f"chip_smoke_{args.only}.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(f"profiler windows taken again: {len(PROFILER_RETRIES)} {json.dumps(PROFILER_RETRIES)}", flush=True)
        print(f"chip_smoke: {report['seconds']:.1f} s", flush=True)
        print(card, flush=True)
        return 0
    k1 = k1_phase(model, cfg, gen, args.quick)
    fwd2 = fwd_phase("k2", model, cfg, gen, args.quick, n_main)
    fwd3 = fwd_phase("k3", model, cfg, gen, args.quick, n_main)
    k2b = k2b_phase(model, cfg, gen, args.quick, n_main)
    k2, k3 = [], []
    k4 = k4_phase(model, cfg, gen, args.quick)
    if args.quick:
        for dt in ("float32", "bfloat16"):
            k2.append(check_k2(model, cfg, 1000, dt, gen, reps=0))
            k3.append(check_k3(model, cfg, 1000, dt, gen, reps=0, self_noise=True))
    else:
        for dt in ("float32", "bfloat16"):
            k2.append(check_k2(model, cfg, 4096, dt, gen, reps=0))
            k3.append(check_k3(model, cfg, 4096, dt, gen, reps=0, self_noise=True))
        k2.append(check_k2(model, cfg, n_main, "bfloat16", gen, reps=3, library=True))
        k3.append(check_k3(model, cfg, n_main, "bfloat16", gen, reps=4,
                           library=(k2[-1]["fwd_library_ms"], k2[-1]["bwd_library_ms"])))
        k3_chunk = check_k3_chunk(model, cfg, gen, reps=10)
    for r in k1:
        print_k1(r)
    for r in fwd2 + fwd3:
        print_fwd(r)
    for r in k2b:
        print_k2b(r)
    for r in k2:
        print(f"K2 {r['dtype']} n={r['n']}: fwd {json.dumps(r['fwd_err'])} bwd {json.dumps(r['bwd_err'])}"
              + (f", bwd {r['bwd_ms']:.3f} ms" if "bwd_ms" in r else ""),
              flush=True)
    for r in k3:
        print_k3(r)
    if not args.quick:
        print_k3_chunk(k3_chunk)
    print_k4(k4)
    report.update(k1=k1, k2_fwd=fwd2, k3_fwd=fwd3, k2b=k2b, k2=k2, k3=k3, k4=k4)
    if not args.quick:
        report["k3_chunk"] = k3_chunk
    out_path = os.path.join(OUT_DIR, "chip_smoke.json")

    if not args.quick:
        runs = {}
        for path, n_steps in (("main", 5), ("recompute", 3), ("fused_rounds", 3)):
            runs[path] = train_steps(path, n_steps)
            print(f"{path}: losses {runs[path]['losses']}, ms/step {runs[path]['median_ms']:.2f}, "
                  f"launches {runs[path]['launches']}", flush=True)
        train = report["train"] = runs["main"]
        report["train_paths"] = runs
        print("peak device memory over one step: " + ", ".join(
            f"{path} {r['peak_bytes'] / 1e9:.3f} GB" for path, r in runs.items()), flush=True)
        require(runs["recompute"]["peak_bytes"] < runs["main"]["peak_bytes"],
                "the recompute step's peak device memory is not below the main step's")
        print(f"ms/step: {train['median_ms']:.2f}", flush=True)
        print(f"rays/s: {train['rays_per_sec']:.1f}", flush=True)
        report["eval_forward"] = eval_forward(1024)
        print(f"eval forward (no grad, 1024 rays): launches {report['eval_forward']['launches']}, "
              f"err against the plain field path {json.dumps(report['eval_forward']['err'])}", flush=True)
        if args.turns:
            report["turns"] = time_paths_in_turns(args.turns)
            for path, r in report["turns"].items():
                print(f"in turns, {path}: median {r['median_ms']:.2f} ms/step (quartiles "
                      f"{r['q1_ms']:.2f} .. {r['q3_ms']:.2f}, min {r['min_ms']:.2f}) over {r['n']} steps",
                      flush=True)
        if args.profile:
            report["profile"] = {}
            for path in PATHS:
                prof = profile_steps(path, 3, os.path.join(OUT_DIR, f"profile_{path}.txt"))
                report["profile"][path] = prof
                print(f"profile {path}: wall {prof['wall_ms_per_step']:.2f} ms/step, device busy "
                      f"{prof['device_busy_ms_per_step']:.2f} ms/step in "
                      f"{prof['launches_per_step']:.0f} launches/step, idle share "
                      f"{prof['idle_share']:.3f}", flush=True)
                for ms, cnt, key in prof["top"]:
                    print(f"  {ms:9.3f} ms/step {cnt:7.1f}x  {key[:100]}", flush=True)
            prof = profile_eval_forward(1024, 3, os.path.join(OUT_DIR, "profile_eval_forward.txt"))
            report["profile"]["eval_forward"] = prof
            print(f"profile eval forward (no grad, 1024 rays): wall {prof['wall_ms_per_step']:.2f} ms/call, "
                  f"device busy {prof['device_busy_ms_per_step']:.2f} ms/call in "
                  f"{prof['launches_per_step']:.0f} launches/call, idle share {prof['idle_share']:.3f}", flush=True)
            for ms, cnt, key in prof["top"][:4]:
                print(f"  {ms:9.3f} ms/call {cnt:7.1f}x  {key[:100]}", flush=True)
        paths = compare_paths()
        report["paths"] = paths
        for key in ("loss", "rgb_loss", "eikonal_loss"):
            print(f"one step, {key}: " + ", ".join(
                f"{name} {paths[name][key]:.6g}" for name in (*PATHS, "plain")), flush=True)
        print(f"z values with K4 against without: median |diff| {paths['z_median_diff']:.3g}, "
              f"mean {paths['z_mean_diff']:.3g}; plain step ms {paths['plain_step_ms']}", flush=True)
        report["runner"] = runner_phase(os.path.join(OUT_DIR, "profile_runner.txt") if args.profile else None)
        print_runner(report["runner"], card)
        seconds = report["phase_s"] = {"to the toy phase": time.perf_counter() - t_start}
        # phase 8's training beside phases 9-13: each side's clock is
        # contended by the other, and says so where it prints and records
        beside = "; contended: the toy training runs beside on this card"
        toy = start_toy(note="; contended: phases 9-13 run beside on this card")
        report["contended"] = ["toy", "dtu", "cli", "variants", "multigpu", "periphery"]
        print("contended from here: phases 9-13 run beside phase 8's training (a second process on this card); "
              "their times are not comparable with runs alone", flush=True)
        try:
            t0 = time.perf_counter()
            report["dtu"] = dtu_phase(card + beside)
            report["cli"] = cli_phase(report["runner"]["data_root"])
            print_cli(report["cli"], card + beside)
            report["variants"] = variants_phase()
            print_variants(report["variants"], card + beside)
            report["multigpu"] = multigpu_phase(report["runner"]["data_root"])
            print_multigpu(report["multigpu"], card + beside)
            report["periphery"] = periphery_phase(report["runner"]["data_root"])
            print_periphery(report["periphery"], card + beside)
            seconds["phases 9-13"] = time.perf_counter() - t0
            report["toy"] = join_toy(*toy)
        finally:
            if toy[0].is_alive():
                toy[0].terminate()
                toy[0].join()
        print("contended until here: the toy training has ended", flush=True)
        seconds["the toy training after phase 13"] = time.perf_counter() - t0 - seconds["phases 9-13"]
        t0 = time.perf_counter()
        report["finalize"] = finalize_phase(report["toy"]["rundir"], report["toy"]["data_root"])
        seconds["phase 8's finalize"] = time.perf_counter() - t0
        print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)
        t1, t3 = k1[0], k3[-1]
        src = "neat_tpu_torch/csrc/"
        kernels = [
            dict(name="fused_sdf", route="cuda", source=src + "fused_sdf.cu",
                 replaces="neat_tpu/ops/fused_sdf.py:66", launches=runs["main"]["launches"]["fused_sdf"],
                 max_abs_err=t1["max_abs_err"], ms=t1["ms"], plain_ms=t1["plain_ms"],
                 bound_ms=t1["bound_ms"], bound_by=t1["bound_by"], library_ms=t1["library_ms"]),
        ]
        # the forwards: the tensor-core kernel, timed in turns at the main path's size
        bf16_fwd3 = [r for r in fwd3 if r.get("dtype") != "float32"]
        for name, file, line, rec, path in (
            ("field_fwd_stash", "fused_field_stash", 448, fwd2[-1], "main"),
            ("field_fwd", "fused_field", 210, bf16_fwd3[-1], "recompute"),
        ):
            kernels.append(dict(
                name=name, route="cuda", source=src + "field_fwd_mma.cu",
                replaces=f"neat_tpu/ops/{file}.py:{line}", launches=runs[path]["launches"][name],
                max_abs_err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
                bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=rec["library_ms"]))
        # the bf16 K2-bwd, the split one, timed in turns at the main path's
        # size; and its two kernels, each with its own plain version and bound
        tb = k2b[-1]
        rowlocal_src = "field_bwd_mma.cu"
        kernels.append(dict(
            name="field_bwd_stash", route="cuda", source=src + rowlocal_src,
            replaces="neat_tpu/ops/fused_field_stash.py:465", launches=runs["main"]["launches"]["field_bwd_stash"],
            max_abs_err=tb["mma_max_abs_err"], ms=tb["ms"], plain_ms=tb["plain_ms"], bound_ms=tb["bound_ms"],
            bound_by=tb["bound_by"], library_ms=tb["library_ms"]))
        kernels.append(dict(
            name="field_bwd_rowlocal", route="cuda", source=src + rowlocal_src,
            replaces="neat_tpu/ops/fused_field_stash.py:465",
            launches=runs["main"]["launches"]["field_bwd_rowlocal"],
            max_abs_err=tb["mma_rowlocal_max_abs_err"],
            ms=tb["producer_ms"], plain_ms=tb["producer_plain_ms"], bound_ms=tb["producer_bound_ms"],
            bound_by=tb["producer_bound_by"], library_ms=None))
        kernels.append(dict(
            name="field_dw", route="cuda", source=src + "field_dw_mma.cu",
            replaces="neat_tpu/ops/fused_field_stash.py:465", launches=runs["main"]["launches"]["field_dw"],
            max_abs_err=tb["gemm_max_abs_err"], ms=tb["gemm_ms"], plain_ms=tb["gemm_plain_ms"],
            bound_ms=tb["gemm_bound_ms"], bound_by=tb["gemm_bound_by"], library_ms=tb["gemm_library_ms"]))
        # the bf16 K3-bwd (the split backward over chunks; its row-local
        # pass's source, the bulk of its time), timed in turns at the main
        # path's size against its chunked plain version; and the three
        # kernels it runs on each chunk, at a chunk's shape
        kernels.append(dict(
            name="field_bwd", route="cuda", source=src + rowlocal_src,
            replaces="neat_tpu/ops/fused_field.py:223", launches=runs["recompute"]["launches"]["field_bwd"],
            max_abs_err=t3["bwd_split_plain_max_abs_err"], ms=t3["bwd_ms"], plain_ms=t3["bwd_plain_ms"],
            bound_ms=t3["bwd_bound_ms"], bound_by=t3["bwd_bound_by"], library_ms=t3["bwd_library_ms"]))
        for key, file in (("fwd", "field_fwd_mma.cu"), ("rowlocal", rowlocal_src), ("dw", "field_dw_mma.cu")):
            name = f"field_bwd_chunk_{key}"
            kernels.append(dict(
                name=name, route="cuda", source=src + file, replaces="neat_tpu/ops/fused_field.py:223",
                launches=runs["recompute"]["launches"][name], max_abs_err=k3_chunk[f"{key}_max_abs_err"],
                ms=k3_chunk[f"{key}_ms"], plain_ms=k3_chunk[f"{key}_plain_ms"],
                bound_ms=k3_chunk[f"{key}_bound_ms"], bound_by=k3_chunk[f"{key}_bound_by"],
                library_ms=k3_chunk.get(f"{key}_library_ms")))
        # K4 a launch: the mean over the five rounds of a step, each at its
        # width and refine, of the device time, the plain time and the
        # round's own bound; bound_by names what bounds the larger part of
        # it; the step's sums beside them
        k4_times = k4["times"]
        mean = lambda key: statistics.fmean(r[key] for r in k4_times)
        by = {b: sum(r["bound_ms"] for r in k4_times if r["bound_by"] == b) for b in ("operations", "bytes")}
        kernels.append(dict(
            name="fused_round", route="cuda", source=src + "fused_round.cu",
            replaces="neat_tpu/ops/fused_round.py:105",
            launches=runs["fused_rounds"]["launches"]["fused_round"],
            max_abs_err=max(r["max_abs_err"] for r in k4["checks"]),
            ms=mean("ms"), plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"), bound_by=max(by, key=by.get),
            library_ms=None, step_ms=len(k4_times) * mean("ms"),
            step_bound_ms=len(k4_times) * mean("bound_ms")))
        kernels += finalize_kernel_entries(report["finalize"])
        for k in kernels:  # the toy phase's training: the main path's kernels, its own launches
            if k["name"] in report["toy"]["launches"] and report["toy"]["launches"][k["name"]]:
                k["launches_toy"] = report["toy"]["launches"][k["name"]]
        report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    report["profiler_retries"] = PROFILER_RETRIES
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"profiler windows taken again: {len(PROFILER_RETRIES)} {json.dumps(PROFILER_RETRIES)}", flush=True)
    print(f"chip_smoke: {report['seconds']:.1f} s", flush=True)
    print(card, flush=True)  # nvidia-smi's own name, power.limit line
    if not args.quick:
        print(json.dumps({"kernels": report["kernels"]}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
