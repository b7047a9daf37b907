"""The bf16 recompute backward (K3-bwd) as the split backward over chunks,
through its plain version, on the CPU.

* ``field_bwd_recompute_split_plain`` (chunks of 128 points, four chunks)
  against the JAX package's K3-bwd, ``_bwd_pallas(..., interpret=True)``,
  on the same seed-made inputs and weights at narrow widths: f32 within
  1e-4 of each output's largest entry (``test_split_matches_jax``'s
  tolerance). In bf16 the JAX K3-bwd rounds where autodiff of
  ``_field_math`` rounds, while the split backward rounds each product's
  operands as the stash-replaying backward does: the JAX package's own
  ``field_bwd_stashed`` is 0.112 of the largest entry (b12) and 0.0575 in
  relative L2 norm (b14) away from its K3-bwd on these inputs, and the
  chunked plain version reads the same (0.112, 0.0575). So bf16 is held
  there in relative L2 norm at 0.08, above what the JAX package's own two
  backwards differ by, and below ``chip_smoke.py``'s limit against
  autodiff (``K3_BWD_L2``, 0.15).
* the same chunked plain version against the JAX package's
  ``field_bwd_stashed`` after its ``field_fwd_res`` (one batch, no
  chunks): f32 1e-4, f64 1e-10, bf16 2e-2 (``test_split_matches_jax``'s).
  JAX's K3-bwd does not take f64: its products accumulate in f32.
* the chunked plain version equals ``field_bwd_split_plain`` on the
  unchunked residuals in dx and dd bit for bit (a point's backward does
  not depend on the chunking), every gradient within 1e-5 (the f32 sums
  over the chunks in another order); canonical widths, f32 and bf16. The
  last chunk holds 16 points: MKL's products of one or two rows sum in
  another order than its products of many.
* an exact sdf_raw == sphere tie (f64, one point): the chunked plain
  version equals the stashed backward in dx and dd, and agrees within
  1e-10 with the JAX package's stashed backward and with autograd of
  ``field_math``, both of which send half the cotangent into each branch.
* the chunks: ``recompute_chunks`` covers every point once, in order;
  ``RECOMPUTE_CHUNK`` is a multiple of the forward's 128-point tile and the
  workspace's 64-point chunk; a chunk's stash and workspace stay below
  1.2 GB.
* the K3-bwd wrappers and its chunk kernels refuse what the kernels do not
  take (CPU tensors, an f32 stash or variant, a variant that is not
  "scalar") and count nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neat_tpu.ops.fused_field as jff
import neat_tpu.ops.fused_field_stash as jfs
import neat_tpu_torch.model.neat as tneat
from _torch_helpers import n, to_numpy
from neat_tpu_torch.ops import field_dw as DW
from neat_tpu_torch.ops import fused_field as F
from neat_tpu_torch.ops import fused_field_stash as K
from test_torch_field_bwd_split import _canonical, _flat, _narrow, _rel, _to_jax

CHUNK = 128  # small chunks, so that a few hundred points make four of them
N_PTS = 400  # 3 x 128 + 16
# bf16 against the JAX K3-bwd, relative L2 norm: JAX's field_bwd_stashed reads 0.0575 there
K3_BWD_L2_BF16 = 0.08


def _l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _chunked(dtype, seed=4):
    """The narrow nets, inputs and the chunked plain K3-bwd on them."""
    cfg_j, cfg_t, sub, model, x, d, cots = _narrow(dtype, seed=seed, n_pts=N_PTS)
    flat = tuple(w.detach() for w in F._flatten_eff(model))
    t = lambda a: torch.as_tensor(np.asarray(a))
    with torch.no_grad():
        got = K.field_bwd_recompute_split_plain(
            flat, t(x), t(d), [t(c) for c in cots], cfg_t.implicit, cfg_t.rendering,
            getattr(torch, dtype), chunk=CHUNK,
        )
    assert bool((np.linalg.norm(x, axis=-1) > 3.0).any())  # the clamp is active somewhere
    return cfg_j, flat, x, d, cots, got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_plain_matches_jax_k3_bwd(dtype, capsys):
    cfg_j, flat, x, d, cots, got = _chunked(dtype)
    jx_dt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    fl, xj, dj, cj = tuple(map(_to_jax, flat)), jnp.asarray(x), jnp.asarray(d), tuple(map(jnp.asarray, cots))
    ref = jff._bwd_pallas(fl, xj, dj, cj, cfg_j.implicit, cfg_j.rendering, jx_dt, True)
    ref = [*to_numpy(ref[0]), np.asarray(ref[1], np.float64), np.asarray(ref[2], np.float64)]
    got = [n(a) for a in (*got[0], got[1], got[2])]
    assert len(got) == len(ref) == 40
    for i, (a, b) in enumerate(zip(got, ref)):
        if dtype == "float32":
            assert _rel(a, b) < 1e-4, (i, _rel(a, b))
        else:
            assert _l2(a, b) < K3_BWD_L2_BF16, (i, _l2(a, b))
    if dtype == "bfloat16":  # the JAX package's own stashed backward, read against its K3-bwd the same way
        _, res = jfs.field_fwd_res(fl, xj, dj, cfg_j.implicit, cfg_j.rendering, jx_dt)
        st = jfs.field_bwd_stashed(fl, xj, dj, res, cj, cfg_j.implicit, cfg_j.rendering, jx_dt)
        st = [*to_numpy(st[0]), np.asarray(st[1], np.float64), np.asarray(st[2], np.float64)]
        with capsys.disabled():
            for what, outs in (("chunked plain K3-bwd", got), ("JAX field_bwd_stashed", st)):
                l2 = [_l2(a, b) for a, b in zip(outs, ref)]
                rel = [_rel(a, b) for a, b in zip(outs, ref)]
                print(f"\n{what} against the JAX K3-bwd, bf16: largest relative L2 {max(l2):.4f} "
                      f"(output {int(np.argmax(l2))}), of the largest entry {max(rel):.4f} "
                      f"(output {int(np.argmax(rel))})")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("float64", 1e-10), ("bfloat16", 2e-2)])
def test_chunked_plain_matches_jax_stashed(dtype, tol):
    cfg_j, flat, x, d, cots, got = _chunked(dtype)
    jx_dt = {"float32": jnp.float32, "float64": jnp.float64, "bfloat16": jnp.bfloat16}[dtype]
    with jax.enable_x64(dtype == "float64"):
        fl, xj, dj = tuple(map(_to_jax, flat)), jnp.asarray(x), jnp.asarray(d)
        _, res = jfs.field_fwd_res(fl, xj, dj, cfg_j.implicit, cfg_j.rendering, jx_dt)
        deff_j, dx_j, dd_j = jfs.field_bwd_stashed(
            fl, xj, dj, res, tuple(map(jnp.asarray, cots)), cfg_j.implicit, cfg_j.rendering, jx_dt
        )
        ref = [*to_numpy(deff_j), np.asarray(dx_j, np.float64), np.asarray(dd_j, np.float64)]
    got = [n(a) for a in (*got[0], got[1], got[2])]
    for i, (a, b) in enumerate(zip(got, ref)):
        assert _rel(a, b) < tol, (i, _rel(a, b))


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_chunked_plain_equals_split_plain(cd):
    flat, x, d, res, cots, icfg, rcfg = _canonical(cd, N_PTS)
    deff_s, dx_s, dd_s = K.field_bwd_split_plain(flat, x, d, res, cots, icfg, rcfg, cd)
    deff, dx, dd = K.field_bwd_recompute_split_plain(flat, x, d, cots, icfg, rcfg, cd, chunk=CHUNK)
    assert len(F.recompute_chunks(N_PTS, CHUNK)) == 4
    assert torch.equal(dx, dx_s) and torch.equal(dd, dd_s)
    assert len(deff) == 38
    for l, (a, b) in enumerate(zip(deff, deff_s)):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel(n(a), n(b)) <= 1e-5, (l, _rel(n(a), n(b)))


def test_chunked_plain_at_a_clamp_tie_matches_jax():
    """At an exact sdf_raw == sphere tie (f64, one point) the chunked plain
    K3-bwd equals the stashed backward in dx and dd and agrees with the JAX
    package's stashed backward (its balanced multipliers send half of the
    cotangent into each branch) and with autograd of ``field_math``, whose
    minimum does the same (the JAX K3-bwd itself does not take f64)."""
    cfg_j, cfg_t, _, model, _, _, _ = _narrow("float64", seed=11, n_pts=4)
    icfg, rcfg = cfg_t.implicit, cfg_t.rendering
    x = torch.tensor([[0.5, 0.25, -0.125]], dtype=torch.float64)  # exact norm ops
    d = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    flat = [w.detach().to(torch.float64) for w in F._flatten_eff(model)]
    nosphere = dataclasses.replace(icfg, sdf_bounding_sphere=0.0)
    sphere_val = float(icfg.sphere_scale * (icfg.sdf_bounding_sphere - torch.linalg.norm(x[0])))
    last_b = 2 * (F.N_IMPLICIT_LAYERS - 1) + 1
    raw = lambda fe: float(K.field_fwd_res(fe, x, d, nosphere, rcfg, torch.float64)[0][0][0, 0])
    for _ in range(8):  # sdf_raw is affine in the last bias: a few corrections pin the tie
        gap = sphere_val - raw(flat)
        if gap == 0.0:
            break
        flat[last_b] = flat[last_b].clone()
        flat[last_b][0, 0] += gap
    assert raw(flat) == sphere_val, "could not pin an exact tie"
    (sdf, _, _, _), res = K.field_fwd_res(flat, x, d, icfg, rcfg, torch.float64)
    assert float(sdf[0, 0]) == sphere_val
    cots = [torch.tensor(np.random.RandomState(3).randn(1, w)) for w in (1, 3, 3, 6)]
    deff, dx, dd = K.field_bwd_recompute_split_plain(flat, x, d, cots, icfg, rcfg, torch.float64, chunk=CHUNK)
    _, dx_s, dd_s = K.field_bwd_stashed(flat, x, d, res, cots, icfg, rcfg, torch.float64)
    assert torch.equal(dx, dx_s) and torch.equal(dd, dd_s)
    got = [n(a) for a in (*deff, dx, dd)]
    with jax.enable_x64(True):
        j = lambda a: jnp.asarray(n(a))
        jres = (j(res[0]), tuple(map(j, res[1])), tuple(map(j, res[2])), tuple(map(j, res[3])),
                j(res[4]), j(res[5]), j(res[6]))
        deff_j, dx_j, dd_j = jfs.field_bwd_stashed(
            tuple(map(j, flat)), j(x), j(d), jres, tuple(map(j, cots)), cfg_j.implicit, cfg_j.rendering,
            jnp.float64,
        )
        ref_j = [*to_numpy(deff_j), np.asarray(dx_j), np.asarray(dd_j)]
    leaves = [w.clone().requires_grad_(True) for w in (*flat, x, d)]
    outs = F.field_math(leaves[:-2], leaves[-2], leaves[-1], icfg, rcfg, torch.float64)
    ref_a = [n(a) for a in torch.autograd.grad(outs, leaves, cots)]
    for ref in (ref_j, ref_a):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("n_pts", [0, 1, 127, F.RECOMPUTE_CHUNK, F.RECOMPUTE_CHUNK + 1, 100_352])
def test_recompute_chunks_cover_the_points_once(n_pts):
    chunks = F.recompute_chunks(n_pts)
    assert [c0 for c0, _ in chunks] == list(range(0, n_pts, F.RECOMPUTE_CHUNK))
    assert all(0 < c1 - c0 <= F.RECOMPUTE_CHUNK for c0, c1 in chunks)
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert (chunks[-1][1] if chunks else 0) == n_pts
    assert F.RECOMPUTE_CHUNK % 128 == 0 and F.RECOMPUTE_CHUNK % DW.WS_CHUNK == 0
    # a chunk's stash (bf16 activations, f32 embedding and z8) and workspace
    per_point = K.W_CD * 2 + K.W_F32 * 4 + DW.WS_ROWS * 2
    assert (per_point, DW.WS_ROWS * 2) == (35_002, 25_704)
    assert 0.5e9 <= F.RECOMPUTE_CHUNK * per_point <= 1.2e9


def _calls():
    flat = _flat(torch.bfloat16)
    icfg = tneat.NeatConfig.for_abc().implicit
    bf, f32 = torch.bfloat16, torch.float32
    x, d = torch.zeros((4, 3)), torch.zeros((4, 3))
    cots = [torch.zeros((4, w)) for w in (1, 3, 3, 6)]
    args = (flat, x, d, cots, icfg)
    scd, sf32 = torch.zeros((4, K.W_CD), dtype=bf), torch.zeros((4, K.W_F32))
    return {
        "bwd_cpu": (ValueError, lambda: F.field_bwd_kernel(*args, bf)),
        "bwd_cpu_f32": (ValueError, lambda: F.field_bwd_kernel(*args, f32)),
        # the split backward's chunk kernels
        "split_cpu": (ValueError, lambda: F.field_bwd_chunk_fwd(flat, x, d, icfg)),
        "scalar_cpu": (ValueError, lambda: F.field_bwd_kernel_variant(*args, bf, "scalar")),
        "split_f32": (ValueError, lambda: F.field_bwd_chunk_rowlocal(
            flat, x, d, scd.float(), sf32, x, x, cots, icfg)),
        "scalar_f32": (TypeError, lambda: F.field_bwd_kernel_variant(*args, f32, "scalar")),
        # the split backward is the model's bf16 K3-bwd, not a variant
        "unknown": (ValueError, lambda: F.field_bwd_kernel_variant(*args, bf, "split")),
        "cots_shape": (ValueError, lambda: F.field_bwd_kernel(flat, x, d, cots[::-1], icfg, bf)),
    }


@pytest.mark.parametrize("case", list(_calls()))
def test_recompute_bwd_refuses_what_the_kernels_do_not_take(case):
    err, call = _calls()[case]
    counters = (F.field_bwd_kernel, F.field_bwd_chunk_fwd, F.field_bwd_chunk_rowlocal, F.field_bwd_chunk_dw)
    before = [f.launches for f in counters]
    with pytest.raises(err):
        call()
    assert [f.launches for f in counters] == before
