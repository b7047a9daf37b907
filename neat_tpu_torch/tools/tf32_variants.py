"""Edits of the f32 tensor-core kernels (3xTF32), timed against the tree's in turns.

Each variant is ``csrc/tf32_tile.cuh``, ``csrc/fused_sdf_tf32.cu`` and
``csrc/field_fwd_tf32.cu`` with the text edits of ``VARIANTS`` applied (the
tree's sources are not changed), built by nvcc beside the others into
``build/tf32_variants/<name>/``. All run in one process on the same inputs
(the bench model's random weights; K1 at a finalize chunk's 262,144
points, K3-fwd at its 200,704): each variant's outputs are checked against
the plain version (the f32 tolerance) and against the tree's bit for bit
where the variant keeps the order of every sum (``SAME_BITS``), and each
output's max, root-mean-square and mean signed error against the plain
version in f64 are printed beside plain f32's; then the variants are timed
in rounds (CUDA events around 5 and 3 launches), the order reversed from
round to round, and each one's median over the rounds is printed with the
card. ``--sass`` also counts each kernel's spill instructions (STL, LDL)
in ``cuobjdump -sass`` and keeps the listings in the variant's directory.

The variants:
- ``turns``: the two warpgroups take turns at the tensor cores (named
  barriers), a turn for each quarter of a pair, as the bf16 kernels take
  them a layer at a time.
- ``select``: the first form of the tree: a quarter's accumulator
  declared in the loop, and the running sum taking the first pair's value
  by a select (``add ? sum + part : part``) where the tree starts it from
  zero. ptxas moves the running sum between register blocks around every
  quarter and spills (the same values; a zero's sign can differ).
- ``no_nudge``: the product not moved toward its truncations' loss at
  its end: the loss stays in it (the sdf's mean error against f64 -1.5e-7
  of its largest value, plain f32's -6.3e-8, on the card).
- ``whole_ulp``: every entry one ulp away from zero at the end (the
  first design: mean error +8.5e-8, root mean square 1.03e-7).
- ``nudge2``: two ulps away from zero at the product's end.
- ``frac12``, ``frac34``: the ulp given back to a half or three quarters
  of the entries, chosen by the running sum's low bits (the tree gives it
  to five eighths).
- ``pair_nudge``: each pair's quarter sum moved one ulp away from zero
  before it joins the running sum, nothing at the end.
- ``four_terms``: the fourth product A_lo B_lo too (two more wgmmas a
  pair), the small terms first.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 -m neat_tpu_torch.tools.tf32_variants [--rounds 6] [--sass]
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
OUT = os.path.join(REPO, "build", "tf32_variants")
SOURCES = ("fused_sdf_tf32", "field_fwd_tf32")

_TURNS = '''// the warpgroups' turns at the tensor cores (the turns variant)
struct Turns {
  int wg, left;
  __device__ __forceinline__ Turns(int total) : wg((threadIdx.x >> 7) & 1), left(total) {
    if (wg == 1) mma_tile::named_arrive(1, 256);
  }
  __device__ __forceinline__ void take() { mma_tile::named_sync(1 + wg, 256); }
  __device__ __forceinline__ void give() {
    --left;
    if (wg == 0 || left > 0) mma_tile::named_arrive(2 - wg, 256);
  }
};

'''
_ZERO = ("  if (!accumulate) {\n#pragma unroll\n    for (int j = 0; j < 32; ++j)\n#pragma unroll\n"
         "      for (int i = 0; i < 4; ++i) sum[j][i] = 0.f;\n  }\n")
_SLOT = "    const uint32_t slot = mma_tile::smem_u32(ring.wait(q));\n"
_NUDGE = "    for (int i = 0; i < 4; ++i) sum[j][i] = give_back(sum[j][i]);"
_SIG = "float (&sum)[32][4], const float* A, Ring& ring, bool feeder,"
_PRIME = "  if (feeder) ring.prime();\n"
_LO0 = "      wgmma_m64n64k8(part, lo[0], dh, 0);\n"
_LO1 = "        wgmma_m64n64k8(part, lo[1], dh + 2, 1);\n"


def _dither(cond: str) -> str:
    """The end-of-product nudge on the entries whose low bits b meet cond."""
    return ("    for (int i = 0; i < 4; ++i) {\n      const int b = __float_as_int(sum[j][i]);\n"
            f"      if ({cond}) sum[j][i] = ulp_away(sum[j][i]);\n    }}")


# {file: ((old, new), ...)} a variant's text edits, each of every occurrence
VARIANTS = {
    "tree": {},
    "turns": {
        "tf32_tile.cuh": (
            ("// sum = (accumulate ? sum : 0) + A[16 x 8", _TURNS + "// sum = (accumulate ? sum : 0) + A[16 x 8"),
            (_SIG, "float (&sum)[32][4], const float* A, Ring& ring, Turns& turns, bool feeder,"),
            ("      mma_tile::wgmma_fence();", "      turns.take();\n      mma_tile::wgmma_fence();"),
            ("      mma_tile::wgmma_commit();\n", "      mma_tile::wgmma_commit();\n      turns.give();\n"),
        ),
        "fused_sdf_tf32.cu": (
            (_PRIME, _PRIME + "  tf32_tile::Turns turns(mine * N_SDF_PAIRS * 4);\n"),
            ("ring, feeder,", "ring, turns, feeder,"),
        ),
        "field_fwd_tf32.cu": (
            (_PRIME, _PRIME + "  tf32_tile::Turns turns(mine * N_FIELD_PAIRS * 4);\n"),
            ("ring, feeder,", "ring, turns, feeder,"),
        ),
    },
    "select": {
        "tf32_tile.cuh": (
            (_ZERO, ""), ("  float part[8][4];\n", ""),
            ("      mma_tile::wgmma_fence();", "      float part[8][4];\n      mma_tile::wgmma_fence();"),
            (_SLOT, _SLOT + "    const bool add = accumulate || q > 0;\n"),
            ("sum[8 * c + j][i] += part[j][i];",
             "sum[8 * c + j][i] = add ? sum[8 * c + j][i] + part[j][i] : part[j][i];"),
        ),
    },
    "no_nudge": {"tf32_tile.cuh": ((_NUDGE, "    for (int i = 0; i < 4; ++i) {}"),)},
    "whole_ulp": {"tf32_tile.cuh": ((_NUDGE, "    for (int i = 0; i < 4; ++i) sum[j][i] = ulp_away(sum[j][i]);"),)},
    "nudge2": {"tf32_tile.cuh": ((_NUDGE, "    for (int i = 0; i < 4; ++i) sum[j][i] = ulp_away(ulp_away(sum[j][i]));"),)},
    "frac12": {"tf32_tile.cuh": ((_NUDGE, _dither("(b & 1) == 0")),)},
    "frac34": {"tf32_tile.cuh": ((_NUDGE, _dither("(b & 3) != 0")),)},
    "pair_nudge": {"tf32_tile.cuh": (
        (_NUDGE, "    for (int i = 0; i < 4; ++i) {}"),
        ("sum[8 * c + j][i] += part[j][i];", "sum[8 * c + j][i] += ulp_away(part[j][i]);"),
    )},
    "four_terms": {"tf32_tile.cuh": (
        (_LO0, _LO0 + "      wgmma_m64n64k8(part, lo[0], dl, 1);\n"),
        (_LO1, _LO1 + "        wgmma_m64n64k8(part, lo[1], dl + 2, 1);\n"),
    )},
}
SAME_BITS = ("tree", "turns")


def variant_sources(name: str) -> dict:
    """{file: text} of the variant's edited sources (every csrc file)."""
    from neat_tpu_torch.ops import _build

    files = {p.name: p.read_text() for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    for file, edits in VARIANTS[name].items():
        src = files[file]
        for old, new in edits:  # every occurrence
            if old not in src:
                raise SystemExit(f"tf32_variants: the kernel source changed; no match for {old[:60]!r} in {file}")
            src = src.replace(old, new)
        files[file] = src
    return files


def build(names, sass=False):
    """Compile both kernels of every variant in parallel -> {(name, source): library}."""
    from neat_tpu_torch.ops import _build

    procs = {}
    for name in names:
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for file, text in variant_sources(name).items():
            with open(os.path.join(d, file), "w") as f:
                f.write(text)
        for src in SOURCES:
            so = os.path.join(d, f"lib{src}.so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, os.path.join(d, f"{src}.cu")]
            procs[name, src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for (name, src), (proc, so) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} {src}:\n{out}")
        report = [line.strip() for line in out.splitlines() if "spill" in line or "registers" in line]
        line = f"{name} {src}: {' / '.join(report[-2:])}"
        if sass:
            listing = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass", so],
                                     check=True, capture_output=True, text=True).stdout
            with open(so[:-3] + ".sass", "w") as f:
                f.write(listing)
            line += f"; STL {listing.count('STL')}, LDL {listing.count('LDL')}"
        print(line, flush=True)
        libs[name, src] = ctypes.CDLL(so)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--sass", action="store_true", help="count spill instructions in cuobjdump's listing")
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("tf32_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from neat_tpu_torch.core.embedder import positional_encoding
    from neat_tpu_torch.model.neat import init_neat
    from neat_tpu_torch.ops import _build
    from neat_tpu_torch.ops import fused_field as F
    from neat_tpu_torch.ops import fused_sdf as K1
    from neat_tpu_torch.ops import tf32 as T
    from neat_tpu_torch.utils.benchscene import bench_config

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    libs = build(args.variants, args.sass)
    cfg = bench_config("bfloat16", device="cuda")
    model = init_neat(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    icfg, rcfg = cfg.implicit, cfg.rendering
    P = _build.ptr
    with torch.no_grad():
        ws, bs = K1._effective_weights(model.implicit, icfg, torch.float32)
        ws = [w.contiguous() for w in ws]
        w1, b1 = T.pack_sdf_weights_tf32(ws, bs)
        n1 = 2048 * cfg.sampler.n_samples_eval
        emb = positional_encoding((torch.rand((n1, 3), generator=gen, device="cuda") * 2 - 1) * 3.0, 6).contiguous()
        flat = tuple(t.detach().contiguous() for t in F._flatten_eff(model))
        w3, b3 = T.pack_field_weights_tf32(flat)
        n3 = 2048 * (cfg.sampler.n_samples + cfg.sampler.n_samples_extra + 2)
        x = ((torch.rand((n3, 3), generator=gen, device="cuda") * 2 - 1) * 1.5).contiguous()
        d = torch.nn.functional.normalize(torch.randn((n3, 3), generator=gen, device="cuda"), dim=-1).contiguous()
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        n_blocks, s_f32 = F._tf32_layout(n3, n_sm)
        scratch = torch.empty((n_blocks, s_f32), device="cuda")
        stream = _build.stream_ptr(emb)

        def k1(name):
            out = torch.empty((n1,), device="cuda")
            fn = libs[name, "fused_sdf_tf32"].fused_sdf_fwd_tf32
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
            _build.check(fn(P(emb), P(w1), P(b1), P(out), n1, stream), f"{name} K1")
            return (out,)

        def k3(name):
            outs = tuple(torch.empty((n3, w), device="cuda") for w in F.OUT_WIDTHS)
            fn = libs[name, "field_fwd_tf32"].field_fwd_tf32
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
            _build.check(fn(P(x), P(d), P(w3), P(b3), *(P(o) for o in outs), P(scratch), n3, n_sm,
                            icfg.sdf_bounding_sphere, icfg.sphere_scale, stream), f"{name} K3-fwd")
            return outs

        plain = {"k1": (K1.fused_sdf_plain(emb, ws, bs),), "k3": F.field_math(flat, x, d, icfg, rcfg, torch.float32)}
        f64 = {"k1": (K1.fused_sdf_plain(emb.double(), [w.double() for w in ws], [b.double() for b in bs]),),
               "k3": F.field_math(tuple(t.double() for t in flat), x.double(), d.double(), icfg, rcfg, torch.float64)}
        runs = {"k1": k1, "k3": k3}
        tree = {kernel: run(args.variants[0]) for kernel, run in runs.items()}

        def off_f64(outs, kernel):
            """Each output against f64, of its largest entry: max, root mean square and mean signed error."""
            line = []
            for a, r in zip(outs, f64[kernel]):
                e, scale = a.double() - r, float(r.abs().max())
                line.append(f"max {float(e.abs().max()) / scale:.2e} rms {float(e.pow(2).mean().sqrt()) / scale:.2e} "
                            f"mean {float(e.mean()) / scale:+.2e}")
            return "; ".join(line)

        for kernel in runs:
            print(f"plain {kernel} against f64: {off_f64(plain[kernel], kernel)}", flush=True)
        for name in args.variants:
            for kernel, run in runs.items():
                got = run(name)
                torch.cuda.synchronize()
                for a, p, t in zip(got, plain[kernel], tree[kernel]):
                    err = float((a - p).abs().max()) / float(p.abs().max())
                    if err > 1e-3:
                        raise SystemExit(f"tf32_variants: {name} {kernel}: err {err:.3g} against plain")
                    if name in SAME_BITS and args.variants[0] in SAME_BITS and not torch.equal(a, t):
                        raise SystemExit(f"tf32_variants: {name} {kernel} differs from {args.variants[0]}'s bits")
                print(f"{name} {kernel} against f64: {off_f64(got, kernel)}", flush=True)
        del f64

        def ev(fn, reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            fn()
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps

        times = {name: {"k1": [], "k3": []} for name in args.variants}
        order = list(args.variants)
        for _ in range(args.rounds):
            for name in order:
                times[name]["k1"].append(ev(lambda: k1(name), 5))
                times[name]["k3"].append(ev(lambda: k3(name), 3))
            order.reverse()
    for name, t in times.items():
        print(f"{name}: K1 n={n1} median {statistics.median(t['k1']):.3f} ms, K3-fwd n={n3} median "
              f"{statistics.median(t['k3']):.3f} ms over {args.rounds} rounds; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
