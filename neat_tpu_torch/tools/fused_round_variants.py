"""Edits of the round kernel (K4), timed against the tree's in turns.

Each variant is ``csrc/fused_round.cu`` with the text edits and extra nvcc
flags of ``VARIANTS`` applied (the tree's source is not changed), built
beside the others into ``build/fused_round_variants/<name>/``. The first
port, which runs every bisection step also once the beta0 check has passed,
is one of them (``chip_smoke.py`` times it beside the tree's kernel). All
run in one process on the round inputs a sampler run of the bench model
(random weights, 1024 rays) hands the kernel at each of its five widths,
each with the refine the sampler runs it with. Each variant's outputs are
compared bit for bit with the tree's kernel (a variant that changes the
arithmetic, such as fast math, is a diagnostic of where the time goes and
says so); then the variants are timed with CUDA events in rounds, the order
reversed from round to round, and each one's median over the rounds is
printed, beside the share of rays whose beta0 check passed. ``--sass`` also
counts the special-function, branch and shuffle instructions of each kernel
in the tree's library (cuobjdump). ``--launches N`` profiles N bench steps
of the fused_rounds path with each variant's library in the wrapper's place
and prints the launches a step: a data-dependent count (the auction's
rounds) moves with any change in the kernel's bits.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 -m neat_tpu_torch.tools.fused_round_variants [--rounds 15] [--reps 20] [--sass] [--launches 3]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(REPO, "build", "fused_round_variants")

_EXIT = "for (int it = curr <= eps ? beta_iters : 0; it < beta_iters; ++it) {"
# name: (text edits, extra nvcc flags)
VARIANTS = {
    "tree": ((), ()),
    # every bisection step, also after the beta0 check has passed: the work
    # of a ray whose check fails, as on a trained model's rays; the kernel
    # renamed, so that a profiler tells it from the tree's
    "first_port": (((_EXIT, _EXIT.replace("curr <= eps ? beta_iters : 0", "0")),
                    ("    round_kernel(const float*", "    round_kernel_first_port(const float*"),
                    ("round_kernel<ITEMS><<<", "round_kernel_first_port<ITEMS><<<")), ()),
    # a diagnostic, other arithmetic: approximate division and exponential,
    # fused multiply-adds
    "fast_math": ((), ("--use_fast_math",)),
}


def variant_source(name: str) -> str:
    from neat_tpu_torch.ops import _build

    src = (_build.CSRC / "fused_round.cu").read_text()
    for old, new in VARIANTS[name][0]:
        if src.count(old) != 1:
            raise SystemExit(f"fused_round_variants: the kernel source changed; no single match for {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(names):
    """Compile every variant's source in parallel -> {name: its loaded library}."""
    from neat_tpu_torch.ops import _build

    procs = {}
    for name in names:
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "fused_round.cu"), "w") as f:
            f.write(variant_source(name))
        flags = (*_build.NVCC_FLAGS, *_build.EXTRA_FLAGS["fused_round"], *VARIANTS[name][1])
        cmd = [_build._nvcc(), *flags, "-o", os.path.join(d, "lib.so"), os.path.join(d, "fused_round.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        lib.fused_round.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.fused_round.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, z, sdf, beta, beta0, eps, beta_iters, add_tiny, refine, out=None):
    """One launch of a variant's kernel on CUDA tensors, as
    ``fused_round_kernel`` launches the tree's (not counted); ``out``: the
    (beta, weights, pdf) tensors to write, fresh ones if None."""
    import torch

    from neat_tpu_torch.ops import _build

    n_rays, lanes = z.shape
    if out is None:
        kw = dict(dtype=torch.float32, device=z.device)
        out = (torch.empty((n_rays,), **kw), torch.empty((n_rays, lanes), **kw),
               torch.empty((n_rays, lanes), **kw))
    P = _build.ptr
    err = lib.fused_round(P(z), P(sdf), P(beta), P(beta0), *(P(t) for t in out), n_rays, lanes, eps,
                          beta_iters, add_tiny, int(refine), _build.stream_ptr(z))
    _build.check(err, "fused_round variant launch")
    return out


def sass_counts(so_path: str):
    """{kernel symbol: Counter of opcode families} from cuobjdump -sass."""
    from neat_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so_path], check=True, capture_output=True, text=True).stdout
    counts, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = counts.setdefault(m.group(1), Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?", line)
        if m and current is not None:
            op = m.group(1)
            current[op] += 1
            current["all"] += 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--reps", type=int, default=20, help="launches in each timed window")
    ap.add_argument("--only", nargs="*", default=None, help="variant names (default: all)")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--launches", type=int, default=0,
                    help="also profile this many fused_rounds bench steps with each variant's kernel in the "
                         "wrapper's place, and print the launches a step")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("fused_round_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import card_line, sampler_rounds
    from neat_tpu_torch.model.neat import init_neat
    from neat_tpu_torch.ops import _build
    from neat_tpu_torch.utils.benchscene import bench_config

    print(f"card: {card_line()}", flush=True)
    names = args.only or list(VARIANTS)
    if "tree" not in names:
        names = ["tree", *names]
    _build.build_all(("fused_sdf",))
    libs = build(names)
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        with open(os.path.join(OUT, "tree.sass"), "w") as f:  # the whole listing, for reading
            subprocess.run([cuobjdump, "-sass", os.path.join(OUT, "tree", "lib.so")], check=True, stdout=f)
        for sym, c in sorted(sass_counts(os.path.join(OUT, "tree", "lib.so")).items()):
            if "round_kernel" in sym:
                keys = ("all", "MUFU", "FCHK", "CALL", "BRA", "BSSY", "SHFL", "BAR", "LDL", "STL")
                print(f"sass {sym}: " + ", ".join(f"{k} {c[k]}" for k in keys), flush=True)

    cfg = bench_config("bfloat16", device="cuda")
    model = init_neat(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rounds = sampler_rounds(model, cfg, 1024, gen)
    scfg = cfg.sampler
    for i, (z, sdf, beta, beta0) in enumerate(rounds):
        refine = i < len(rounds) - 1
        n_rays, lanes = z.shape
        outs = {}
        round_args = (scfg.eps, scfg.beta_iters, scfg.add_tiny, refine)

        def run(name, outs=outs, data=(z, sdf, beta, beta0), round_args=round_args):
            outs[name] = launch(libs[name], *data, *round_args, out=outs.get(name))

        for name in names:
            run(name)
        torch.cuda.synchronize()
        ref = outs["tree"]
        same = {name: all(torch.equal(a, b) for a, b in zip(outs[name], ref)) for name in names}
        converged = float((ref[0] == beta0[0]).float().mean())
        times = {name: [] for name in names}
        order = list(names)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(args.rounds):
            for name in order:
                torch.cuda.synchronize()
                start.record()
                for _ in range(args.reps):
                    run(name)
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / args.reps)
            order.reverse()
        print(f"S={lanes} refine={refine}: beta0 check passed on {converged:.3f} of the rays", flush=True)
        for name in names:
            print(f"  {name:12s} {statistics.median(times[name]):.4f} ms (min {min(times[name]):.4f})  "
                  f"{'same bits as tree' if same[name] else 'DIFFERS from tree'}", flush=True)
    if args.launches:
        from chip_smoke import profile_steps
        from neat_tpu_torch.ops import fused_round as R

        R._lib()
        tree_lib = R._LIB["lib"]
        for name in names:
            R._LIB["lib"] = libs[name]  # the wrapper launches (and counts) this variant's kernel
            prof = profile_steps("fused_rounds", args.launches, os.path.join(OUT, f"profile_{name}.txt"))
            print(f"fused_rounds step with {name}'s kernel: {prof['launches_per_step']:.1f} launches a step, "
                  f"device busy {prof['device_busy_ms_per_step']:.3f} ms a step over {args.launches} steps",
                  flush=True)
        R._LIB["lib"] = tree_lib
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
