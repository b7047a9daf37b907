"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the fixture, never at import). Run on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances, of each output's own largest entry (so zeros or a flipped sign
score 1 or 2): f32 1e-3 — the kernels sum in another order than cuBLAS;
bf16 3e-2 — also the rare activation whose f32 sum rounds to the
neighbouring bf16 value.
"""

import pytest
import torch

from neat_tpu_torch.model.neat import init_neat
from neat_tpu_torch.ops import fused_field_stash as K
from neat_tpu_torch.ops.fused_field import _flatten_eff
from neat_tpu_torch.ops.fused_sdf import _effective_weights, fused_sdf_kernel, fused_sdf_plain
from neat_tpu_torch.core.embedder import positional_encoding
from neat_tpu_torch.utils.benchscene import bench_config, bench_scene, bench_step

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = bench_config("bfloat16", device="cuda")
    return cfg, init_neat(cfg, seed=0, device="cuda")


def _err(a, b):
    return float((a.float() - b.float()).abs().max()) / max(1e-12, float(b.float().abs().max()))


@pytest.mark.parametrize("cd", DTYPES)
def test_k1_kernel_matches_plain(setup, cd):
    cfg, model = setup
    pts = (torch.rand((1000, 3), device="cuda") * 2 - 1) * 3.0  # a ragged last tile
    with torch.no_grad():
        emb = positional_encoding(pts, 6).to(cd).contiguous()
        ws, bs = _effective_weights(model.implicit, cfg.implicit, cd)
        ws = [w.contiguous() for w in ws]
        assert _err(fused_sdf_kernel(emb, ws, bs), fused_sdf_plain(emb, ws, bs)) < TOL[cd]


@pytest.mark.parametrize("cd", DTYPES)
def test_k2_kernels_match_plain(setup, cd):
    cfg, model = setup
    icfg, rcfg = cfg.implicit, cfg.rendering
    n = 1000
    x = (torch.rand((n, 3), device="cuda") * 2 - 1) * 1.5
    x[:100] *= 3.2 / torch.linalg.norm(x[:100], dim=-1, keepdim=True)
    d = torch.nn.functional.normalize(torch.randn((n, 3), device="cuda"), dim=-1)
    cots = tuple(torch.randn((n, w), device="cuda") for w in (1, 3, 3, 6))
    with torch.no_grad():
        flat = tuple(w.detach().contiguous() for w in _flatten_eff(model))
        got = K.field_fwd_stash_kernel(flat, x, d, icfg, cd)
        out, res = K.field_fwd_res(flat, x, d, icfg, rcfg, cd)
        ref = (*out, *K._pack_res(res))
        for a, b in zip(got, ref):
            assert _err(a, b) < TOL[cd]
        scd, sf32 = (r.contiguous() for r in ref[4:])
        rgb, grads = out[2].contiguous(), out[1].contiguous()
        deff, dx, dd = K.field_bwd_stash_kernel(flat, x, d, scd, sf32, rgb, grads, cots, icfg, cd)
        res = K._unpack_res(scd, sf32, rgb, grads, icfg, rcfg)
        deff_p, dx_p, dd_p = K.field_bwd_stashed(flat, x, d, res, cots, icfg, rcfg, cd)
    assert _err(dx, dx_p) < TOL[cd] and _err(dd, dd_p) < TOL[cd]
    for a, b in zip(deff, deff_p):
        assert _err(a, b) < TOL[cd]


def test_training_step_launches_every_kernel(setup):
    cfg, _ = setup
    scene = bench_scene(cfg, device="cuda")
    step, state = bench_step(cfg, device="cuda", n_rays=64)
    fns = (K.field_fwd_stash_kernel, K.field_bwd_stash_kernel, fused_sdf_kernel)
    before = [f.launches for f in fns]
    state, metrics = step(state, scene, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"])
    assert all(f.launches > b for f, b in zip(fns, before))
