"""Edits of the tensor-core row-local pass, timed against the tree's in turns.

Each variant is ``csrc/field_bwd_mma.cu`` with the text edits of
``VARIANTS`` applied (the tree's source is not changed), built by nvcc
beside the others into ``build/field_bwd_variants/<name>/``. All run in one
process on the same K2-fwd stash and cotangents (bench model, random
weights, 100,352 points by default): each variant's outputs (dx, dd, the
bias gradients, the workspace) are checked bit for bit against the tree's,
then the variants are timed in rounds, the order rotating from round to
round, and each one's median and quartiles over the rounds are printed.

The variants: the workspace offset the pass could take. The tree counts a
row's start in 64-point chunks in 32 bits and scales it to elements in 64;
``offset_i32`` is a 32-bit element offset (right only below 2^31 workspace
elements, about 167,000 points), ``offset_i64`` a 64-bit product of row and
width.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 -m neat_tpu_torch.tools.field_bwd_variants [--rounds 12] [--points 100352]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(REPO, "build", "field_bwd_variants")

_PUT = "(p + r)[(size_t)((uint32_t)row * (uint32_t)nc) * 64] ="
_WS = "const Ws ws{ws_base + row0, np / 64, valid};"
VARIANTS = {
    "tree": (),
    "offset_i32": ((_PUT, "p[(uint32_t)(row * nc + r)] ="), (_WS, _WS.replace("np / 64", "np"))),
    "offset_i64": ((_PUT, "p[(long)row * nc + r] ="), (_WS, _WS.replace("np / 64", "np"))),
}


def variant_source(name: str) -> str:
    from neat_tpu_torch.ops import _build

    src = (_build.CSRC / "field_bwd_mma.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"field_bwd_variants: the kernel source changed; no single match for {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(names):
    """Compile every variant in parallel -> {name: its loaded library}."""
    from neat_tpu_torch.ops import _build

    procs = {}
    for name in names:
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for header in ("common.cuh", "mma_tile.cuh"):
            shutil.copy(_build.CSRC / header, d)
        with open(os.path.join(d, "field_bwd_mma.cu"), "w") as f:
            f.write(variant_source(name))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"), os.path.join(d, "field_bwd_mma.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        spills = [line.strip() for line in out.splitlines() if "spill" in line or "registers" in line]
        print(f"{name}: {' / '.join(spills[-2:])}", flush=True)
        libs[name] = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--points", type=int, default=100_352)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("field_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from neat_tpu_torch.model.neat import init_neat
    from neat_tpu_torch.ops import _build
    from neat_tpu_torch.ops import fused_field_stash as K
    from neat_tpu_torch.ops.fused_field import _flatten_eff
    from neat_tpu_torch.utils.benchscene import bench_config

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    _build.build_all(("field_fwd_mma",))
    libs = build(VARIANTS)
    cd, n = torch.bfloat16, args.points
    cfg = bench_config("bfloat16", device="cuda")
    model = init_neat(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.rand((n, 3), generator=gen, device="cuda") * 2 - 1) * 1.5
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen, device="cuda"), dim=-1)
    cots = tuple(torch.randn((n, w), generator=gen, device="cuda") for w in (1, 3, 3, 6))

    def run(name):
        _build._LIBS["field_bwd_mma"] = libs[name]
        return K._bwd_rowlocal_launch(*inputs, cd, "mma", w_bwd)

    with torch.no_grad():
        flat = tuple(w.detach().contiguous() for w in _flatten_eff(model))
        _, grads, rgb, _, scd, sf32 = K.field_fwd_stash_kernel(flat, x, d, cfg.implicit, cd)
        inputs = (flat, x, d, scd, sf32, rgb, grads, cots, cfg.implicit)
        w_bwd = K.pack_field_bwd_weights_gather(flat, cd)
        ref = run("tree")
        for name in VARIANTS:
            same = all(torch.equal(a, b) for a, b in zip(run(name), ref))
            print(f"{name}: outputs equal the tree's bit for bit: {same}", flush=True)
        del ref
        times = {name: [] for name in VARIANTS}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        names = list(VARIANTS)
        for rnd in range(args.rounds):
            for name in names[rnd % len(names):] + names[: rnd % len(names)]:
                run(name)
                torch.cuda.synchronize()
                start.record()
                for _ in range(4):
                    run(name)
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / 4)
    for name, ts in times.items():
        q = statistics.quantiles(ts, n=4)
        wins = sum(a < b for a, b in zip(ts, times["tree"]))
        print(f"{name}: median {statistics.median(ts):.3f} ms (quartiles {q[0]:.3f} .. {q[2]:.3f}) over "
              f"{len(ts)} rounds, faster than the tree in {wins}; " + " ".join(f"{t:.3f}" for t in ts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
