"""Where the tensor-core field forward spends a tile, read from clock64().

Builds an instrumented copy of ``csrc/field_fwd_mma.cu`` into
``build/field_fwd_phases/`` (the kernel's own source is not changed): a
timestamp goes to a device array before and after each turn at the tensor
cores and after each step's stash copies, for the second tile of block 0.
Then it runs K2-fwd and K3-fwd at the main path's 100,352 points (bench
model, random weights) and prints, for warp 0 (warpgroup 0) and warp 4
(warpgroup 1), each turn's wait for the turn, its products and what follows
them up to the next turn, in SM cycles, and the split of the implicit
chain's and the sweep's epilogues.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 -m neat_tpu_torch.tools.field_fwd_phases
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(REPO, "build", "field_fwd_phases")

HEADER = """
__device__ unsigned long long g_phase[8][128];
extern "C" int phase_dump(void* out) { return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)); }
#define PHASE(tag) do { if (blockIdx.x == 0 && tile == (int)(blockIdx.x + gridDim.x) && lane == 0) \\
    g_phase[warp][pk] = (clock64() << 8) | (tag); ++pk; } while (0)
"""
# tags: 1 before a turn, 2 in it, 3 after it; 4 after a sweep step's
# load_in, 5 after its epilogue; 6 after a chain layer's activation, 7 after
# its copy out
EDITS = (
    ('#include "mma_tile.cuh"\n', '#include "mma_tile.cuh"\n' + HEADER),
    ("take_turn();", "PHASE(1); take_turn(); PHASE(2);"),
    ("give_turn();", "give_turn(); PHASE(3);"),
    ("    const long row0 = (long)tile * TILE_POINTS + warp * R;", "    int pk = 0;\n    const long row0 = (long)tile * TILE_POINTS + warp * R;"),
    ("      load_in(A, S, ld_s, soff(L - 1), rows);\n      __syncwarp();\n",
     "      load_in(A, S, ld_s, soff(L - 1), rows);\n      __syncwarp(); PHASE(4);\n"),
    ("      sweep_epilogue(acc, A, CE, L == 4, m);\n", "      sweep_epilogue(acc, A, CE, L == 4, m); PHASE(5);\n"),
    ("        store_act<false>(acc, B + 256 * l, A);\n        __syncwarp();\n        copy_out(A, S, ld_s, soff(l), l == 3 ? N_SKIP : 256, rows);\n",
     "        store_act<false>(acc, B + 256 * l, A);\n        __syncwarp(); PHASE(6);\n"
     "        copy_out(A, S, ld_s, soff(l), l == 3 ? N_SKIP : 256, rows); PHASE(7);\n"),
)


def instrumented_source() -> str:
    from neat_tpu_torch.ops import _build

    src = (_build.CSRC / "field_fwd_mma.cu").read_text()
    for old, new in EDITS:
        if old not in src:
            raise SystemExit(f"field_fwd_phases: the kernel source changed; no match for {old[:60]!r}")
        src = src.replace(old, new)
    return src


def report(name, events):
    """Per-turn (wait, products, after) cycles and the epilogue splits of one warp."""
    t0 = events[0] >> 8
    ev = [((v >> 8) - t0, v & 255) for v in events]
    turns, chain, sweep = [], [], []
    for i, (t, tag) in enumerate(ev):
        if tag == 1 and i + 2 < len(ev) and ev[i + 1][1] == 2 and ev[i + 2][1] == 3:
            nxt = next((u for u, g in ev[i + 3:] if g == 1), ev[-1][0])
            turns.append((ev[i + 1][0] - t, ev[i + 2][0] - ev[i + 1][0], nxt - ev[i + 2][0]))
        if tag == 6 and i > 0:
            chain.append((t - ev[i - 1][0], ev[i + 1][0] - t))
        if tag == 4 and i > 0:
            sweep.append((t - ev[i - 1][0], ev[i + 1][0] - t))
    print(f"{name}: {len(turns)} turns, {ev[-1][0]} cycles from the first to the last timestamp")
    print("  turns, wait/products/after: " + " ".join(f"{a}/{p}/{e}" for a, p, e in turns))
    print("  chain layers 0-6, activation/copy out: " + " ".join(f"{a}/{c}" for a, c in chain))
    print("  sweep steps 7-1, load in/epilogue: " + " ".join(f"{a}/{c}" for a, c in sweep))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("field_fwd_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from neat_tpu_torch.model.neat import init_neat
    from neat_tpu_torch.ops import _build
    from neat_tpu_torch.ops import fused_field_stash as K
    from neat_tpu_torch.ops.fused_field import _flatten_eff
    from neat_tpu_torch.utils.benchscene import bench_config

    os.makedirs(OUT, exist_ok=True)
    for h in ("common.cuh", "mma_tile.cuh"):
        with open(os.path.join(OUT, h), "w") as f:
            f.write((_build.CSRC / h).read_text())
    src, lib = os.path.join(OUT, "field_fwd_phases.cu"), os.path.join(OUT, "libfield_fwd_phases.so")
    with open(src, "w") as f:
        f.write(instrumented_source())
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src], check=True, capture_output=True)

    cfg = bench_config("bfloat16", device="cuda")
    model = init_neat(cfg, seed=0, device="cuda")
    flat = tuple(t.detach().contiguous() for t in _flatten_eff(model))
    n = 1024 * (cfg.sampler.n_samples + cfg.sampler.n_samples_extra + 2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = ((torch.rand((n, 3), generator=gen, device="cuda") * 2 - 1) * 1.5).contiguous()
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen, device="cuda"), dim=-1).contiguous()
    w, b = K.pack_field_weights_gather(flat, torch.bfloat16)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    outs = [torch.empty((n, k), device="cuda") for k in (1, 3, 3, 6)]
    stash = (torch.empty((n, K.W_CD), dtype=torch.bfloat16, device="cuda"), torch.empty((n, K.W_F32), device="cuda"))
    scratch = (torch.empty((n_sm, 128 * 2009), dtype=torch.bfloat16, device="cuda"),
               torch.empty((n_sm, 128 * 256), device="cuda"))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    so = ctypes.CDLL(lib)
    buf = torch.zeros((8, 128), dtype=torch.int64)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    for entry, (a, c) in (("field_fwd_mma_stash", stash), ("field_fwd_mma_primal", scratch)):
        fn = getattr(so, entry)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for _ in range(3):
            _build.check(fn(ptr(x), ptr(d), ptr(w), ptr(b), *map(ptr, outs), ptr(a), ptr(c), n, n_sm,
                            cfg.implicit.sdf_bounding_sphere, cfg.implicit.sphere_scale, stream), entry)
        torch.cuda.synchronize()
        _build.check(so.phase_dump(ctypes.c_void_p(buf.data_ptr())), "phase_dump")
        for warp in (0, 4):
            report(f"{entry} warp {warp}", [int(v) for v in buf[warp].tolist() if v != 0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
