"""Which rays of a finalize chunk do the f32 kernels move off the f64 route?

One chunk of ``wireframe.finalize.view_field_lines`` on a generated 64 x 64,
2-view ABC scene at the full-width model (random weights, seed 3), view 0:
the same chunk ``tests/test_torch_cuda.py::
test_view_field_lines_on_the_f32_kernels_matches_plain`` holds. It runs
through five routes: the f32 kernels (the f32 K1 x5 and the f32 K3-fwd),
the f32 K1 alone (plain field), the f32 K3-fwd alone (plain sampler),
the plain route in f32 and the plain route in f64 (the reference). For
z, lines3d, lines2d and l3d it counts the rays more than 1e-4 of the
output's largest entry off the reference, as the test does, and lists
each ray that the kernels move off while plain f32 keeps it on: its
error in every output on every route, and the first sample index where
its z leaves the reference's (a sampler decision flipped) or none (the
field value itself moved). The per-ray outputs of every route go to
``<out>/f32_rays.npz``.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 -m neat_tpu_torch.tools.f32_rays [--out build/f32_rays] [--build-dir DIR]

``--build-dir`` loads the two tf32 libraries from DIR instead of
``build/kernels`` (a variant ``tools/tf32_variants.py`` built).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import tempfile

import numpy as np
import torch

OUTPUTS = ("z", "lines3d", "lines2d", "l3d")
LIMIT = 1e-4


def scene_and_model(root: str):
    """The test's fixture: the generated scene and the f32 model on the card."""
    from ..data.datasets import load_blender_scene
    from ..data.synthetic import generate_scene
    from ..model.neat import NeatConfig, init_neat

    generate_scene(os.path.join(root, "toy"), n_views=2, res=(64, 64), seed=0)
    scene = load_blender_scene("toy", (64, 64), data_root=root, distance_threshold=1.0)
    cfg = NeatConfig.for_abc()
    return cfg, init_neat(cfg, seed=3, device="cuda").requires_grad_(False), scene


def route(model, cfg, scene, n, kernels: bool, **flags):
    """{output: (n, ...) f64 array} of one route; ``flags`` override the
    kernel config's (``use_pallas_sampler``, ``use_pallas_field``)."""
    import neat_tpu_torch.wireframe.finalize as FIN

    zs = []
    fwd, kcfg = FIN.neat_forward, FIN.eval_kernel_config

    def rec(*a, **k):
        out = fwd(*a, **k)
        zs.append(out["z_vals"].cpu())
        return out

    FIN.neat_forward = rec
    if flags:
        FIN.eval_kernel_config = lambda c, d: dataclasses.replace(kcfg(c, d), **flags)
    try:
        lines3d, lines2d, l3d, _ = FIN.view_field_lines(model, cfg, scene, 0, 2048, kernels=kernels)
    finally:
        FIN.neat_forward, FIN.eval_kernel_config = fwd, kcfg
    torch.cuda.synchronize()
    outs = dict(z=torch.cat(zs)[:n].numpy(), lines3d=lines3d, lines2d=lines2d, l3d=l3d)
    return {k: np.asarray(v, np.float64).reshape(n, -1) for k, v in outs.items()}


def ray_errors(got, ref):
    """{output: (n,) the ray's max |err| over the output's largest entry}."""
    return {k: np.abs(got[k] - ref[k]).max(axis=1) / np.abs(ref[k]).max() for k in OUTPUTS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/f32_rays")
    ap.add_argument("--build-dir", help="load the tf32 libraries from here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("f32_rays: no CUDA device")
    from pathlib import Path

    from ..ops import _build

    if args.build_dir:
        _build.BUILD_DIR = Path(args.build_dir).resolve()
    _build.build_all(("fused_sdf_tf32", "field_fwd_tf32"))
    with tempfile.TemporaryDirectory() as root:
        cfg, model, scene = scene_and_model(root)
    n = int(scene.mask[0].sum())
    routes = {
        "kernels": route(model, cfg, scene, n, True),
        "k1_only": route(model, cfg, scene, n, True, use_pallas_field=False),
        "k3_only": route(model, cfg, scene, n, True, use_pallas_sampler=False),
        "plain32": route(model, cfg, scene, n, False),
    }
    ref = route(copy.deepcopy(model).double(), cfg, scene, n, False)
    errs = {name: ray_errors(r, ref) for name, r in routes.items()}
    print(f"{n} rays; rays more than {LIMIT:g} of the largest entry off the f64 route, by output:")
    for name, e in errs.items():
        off = {k: int((e[k] > LIMIT).sum()) for k in OUTPUTS}
        any_off = int(np.any([e[k] > LIMIT for k in OUTPUTS], axis=0).sum())
        print(f"  {name:8s} {off} (any output: {any_off})")
    plain_off = np.any([errs["plain32"][k] > LIMIT for k in OUTPUTS], axis=0)
    for k in OUTPUTS:
        extra = np.nonzero((errs["kernels"][k] > LIMIT) & ~(errs["plain32"][k] > LIMIT))[0]
        print(f"{k}: kernels off, plain f32 on: rays {extra.tolist()}")
    extra = np.nonzero(np.any([errs["kernels"][k] > LIMIT for k in OUTPUTS], axis=0) & ~plain_off)[0]
    for i in extra:
        dz = np.nonzero(np.abs(routes["kernels"]["z"][i] - ref["z"][i]) > LIMIT * np.abs(ref["z"]).max())[0]
        first = int(dz[0]) if len(dz) else None
        row = "; ".join(f"{name} " + " ".join(f"{k} {errs[name][k][i]:.2e}" for k in OUTPUTS) for name in errs)
        print(f"ray {i}: z leaves the reference at sample {first}; {row}")
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, "f32_rays.npz"),
             **{f"{name}_{k}": v for name, r in {**routes, "f64": ref}.items() for k, v in r.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
