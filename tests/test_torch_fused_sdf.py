"""K1's packed operands and the kernel build's dependency tracking, on the CPU.

* ``pack_sdf_weights`` lays the nine matrices out as the tensor-core kernel
  stages them (29 swizzled panels of 256 x 64, transposed). Unpacking gives
  every matrix and bias back bit for bit, every pad is zero, element
  ``W_l[k, n]`` sits where the kernel's swizzle looks for it, and the offsets
  are the ones ``csrc/fused_sdf.cu`` hard-codes (read from the source).
* ``fused_sdf_plain_packed`` runs the plain math on the padded operands (K
  39 -> 64, N 217 -> 256, zero-padded embedding): zeros added to an f32 sum
  change nothing, so it equals ``fused_sdf_plain`` exactly (tolerance 0) in
  bf16 and f32. Padding cannot change the kernel's answer. (Three points
  at least: one or two f32 rows go through a matrix-vector routine that sums
  k in lanes, where 25 more zeros regroup the terms.)
* ``_build.dependencies`` follows ``#include "..."`` lines from header to
  header, and ``_build._stale`` marks exactly the sources that reach a
  touched header. No compiler is needed: the libraries are empty files.
"""

import os
import re

import numpy as np
import pytest
import torch

from neat_tpu_torch.ops import _build
from neat_tpu_torch.ops import fused_sdf as K

DTYPES = [torch.bfloat16, torch.float32]


def _operands(cd, seed=0):
    rs = np.random.RandomState(seed)
    ws = [torch.as_tensor(rs.randn(i, o).astype(np.float32) * (1.5 / np.sqrt(i))).to(cd)
          for i, o in K.CANONICAL_SHAPES]
    bs = [torch.as_tensor(rs.randn(o).astype(np.float32) * 0.1) for _, o in K.CANONICAL_SHAPES]
    return ws, bs


@pytest.mark.parametrize("cd", DTYPES)
def test_pack_sdf_weights_round_trips(cd):
    ws, bs = _operands(cd)
    w, b = K.pack_sdf_weights(ws, bs)
    assert w.shape == (K.W_TOTAL,) and w.dtype == cd
    assert b.shape == (K.B_TOTAL,) and b.dtype == torch.float32
    ws2, bs2 = K.unpack_sdf_weights(w, b)
    assert [tuple(x.shape) for x in ws2] == list(K.CANONICAL_SHAPES)
    for a, c in zip(ws + bs, ws2 + bs2):
        assert torch.equal(a, c)


@pytest.mark.parametrize("cd", DTYPES)
def test_pack_by_gather_is_pack(cd):
    for seed in (0, 7):  # the cached positions serve every later call
        ws, bs = _operands(cd, seed=seed)
        for a, c in zip(K.pack_sdf_weights_gather(ws, bs), K.pack_sdf_weights(ws, bs)):
            assert a.dtype == c.dtype and torch.equal(a, c)


def test_pack_sdf_weights_pads_are_zero_and_the_swizzle_is_the_kernels():
    ws, bs = _operands(torch.bfloat16, seed=1)
    ws = [x.abs() + 1 for x in ws]  # no zero among the payload
    bs = [x.abs() + 1 for x in bs]
    w, b = K.pack_sdf_weights(ws, bs)
    assert int((w != 0).sum()) == sum(i * o for i, o in K.CANONICAL_SHAPES)
    assert int((b != 0).sum()) == sum(o for _, o in K.CANONICAL_SHAPES)
    # W_l[k0 + k, n]: panel i, row n, 16-byte piece (k // 8) ^ (n % 8), element k % 8
    rs = np.random.RandomState(5)
    for i, (l, k0) in enumerate(K.PANELS):
        k_rows, n_out = K.CANONICAL_SHAPES[l]
        for _ in range(200):
            k, n = rs.randint(min(K.PANEL_K, k_rows - k0)), rs.randint(n_out)
            at = i * K.PANEL_ELEMS + n * K.PANEL_K + (((k // 8) ^ (n % 8)) * 8 + k % 8)
            assert w[at] == ws[l][k0 + k, n]
    padded, pb = K.unpack_sdf_weights(w, b, keep_pads=True)
    assert padded[0].shape == (K.PANEL_K, 256) and bool((padded[0][39:] == 0).all())
    assert padded[3].shape == (256, K.PANEL_ROWS) and bool((padded[3][:, 217:] == 0).all())
    assert pb[3].shape == (256,) and bool((pb[3][217:] == 0).all())


def test_packed_layout_matches_the_cuda_source():
    consts = {}
    for name in ("fused_sdf.cu", "mma_tile.cuh"):
        text = (_build.CSRC / name).read_text()
        consts.update({k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)})
    for name in ("TILE_POINTS", "N_PANELS", "W8_OFF", "W_TOTAL", "B8_OFF", "B_TOTAL", "PANEL_K",
                 "PANEL_ROWS"):
        assert consts[name] == getattr(K, name), name
    assert K.W8_OFF == K.N_PANELS * K.PANEL_ELEMS
    assert K.PANEL_ELEMS * 2 % 1024 == 0  # every panel starts on 1024 bytes
    # one panel for layer 0, then four (64 k rows each) for every hidden layer, in order
    assert K.PANELS == ((0, 0),) + tuple((l, k0) for l in range(1, 8) for k0 in (0, 64, 128, 192))


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("n_points", [3, 129, 1000])
def test_plain_on_padded_operands_equals_plain(cd, n_points):
    ws, bs = _operands(cd, seed=2)
    rs = np.random.RandomState(3)
    emb = torch.as_tensor(rs.randn(n_points, 39).astype(np.float32)).to(cd)
    ref = K.fused_sdf_plain(emb, ws, bs)
    got = K.fused_sdf_plain_packed(emb, *K.pack_sdf_weights(ws, bs))
    assert ref.dtype == got.dtype == torch.float32 and got.shape == (n_points,)
    assert float(ref.abs().max()) > 1e-3  # the weights give a signal to compare
    assert torch.equal(got, ref)


def test_kernel_variants_refuse_what_they_do_not_take():
    ws, bs = _operands(torch.bfloat16)
    with pytest.raises(ValueError):  # a CPU tensor: no silent fallback
        K.fused_sdf_kernel_variant(torch.zeros((4, 39), dtype=torch.bfloat16), ws, bs, "scalar")
    with pytest.raises(TypeError):  # the variants are bf16 kernels
        K.fused_sdf_kernel_variant(torch.zeros((4, 39)), ws, bs, "wgmma_exact")
    with pytest.raises(ValueError):
        K.fused_sdf_kernel(torch.zeros((4, 39), dtype=torch.bfloat16), ws, bs)


# ---------------------------------------------------------------------------
# the build's dependency tracking
# ---------------------------------------------------------------------------


def _fake_tree(tmp_path):
    """a.cu -> x.cuh -> y.cuh; b.cu -> y.cuh; c.cu includes only <system> headers."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    out.mkdir()
    (csrc / "y.cuh").write_text("#pragma once\n#include <cuda_runtime.h>\n")
    (csrc / "x.cuh").write_text('#pragma once\n  #  include "y.cuh"\n// #include "z.cuh" in a comment is not followed\n')
    (csrc / "z.cuh").write_text("#pragma once\n")
    (csrc / "a.cu").write_text('#include <stdint.h>\n#include "x.cuh"\n')
    (csrc / "b.cu").write_text('#include "y.cuh"\n')
    (csrc / "c.cu").write_text("#include <cuda_bf16.h>\n")
    old = 1_000_000_000
    for f in csrc.iterdir():
        os.utime(f, (old, old))
    for name in "abc":
        lib = out / f"lib{name}.so"
        lib.write_bytes(b"")
        os.utime(lib, (old + 10, old + 10))
    return csrc, out, old


def test_dependencies_follow_quoted_includes(tmp_path):
    csrc, _, _ = _fake_tree(tmp_path)
    names = lambda src: sorted(p.name for p in _build.dependencies(csrc / src))
    assert names("a.cu") == ["a.cu", "x.cuh", "y.cuh"]
    assert names("b.cu") == ["b.cu", "y.cuh"]
    assert names("c.cu") == ["c.cu"]


@pytest.mark.parametrize(
    "touched,stale",
    [("x.cuh", "a"), ("y.cuh", "ab"), ("a.cu", "a"), ("b.cu", "b"), ("c.cu", "c"), (None, "")],
)
def test_stale_marks_exactly_the_sources_that_include_a_touched_header(tmp_path, touched, stale):
    csrc, out, old = _fake_tree(tmp_path)
    if touched:
        os.utime(csrc / touched, (old + 20, old + 20))
    assert "".join(n for n in "abc" if _build._stale(n, csrc, out)) == stale
    (out / "libb.so").unlink()  # a missing library is stale whatever the dates
    assert _build._stale("b", csrc, out)


def test_only_fused_sdf_depends_on_the_mma_header():
    """The tensor-core kernels (K1, the field forward, the split backward's
    weight-gradient GEMM and its row-local pass, and the f32 K1 and field
    forward through ``tf32_tile.cuh``) alone include ``mma_tile.cuh``; none
    of them includes the scalar tile, the scalar field kernels do not reach
    the mma header, and no bf16 kernel reaches the tf32 one."""
    reach = {name: {p.name for p in _build.dependencies(_build.CSRC / f"{name}.cu")} for name in _build.SOURCES}
    assert reach["fused_sdf"] == {"fused_sdf.cu", "common.cuh", "mma_tile.cuh"}
    assert reach["field_fwd_mma"] == {"field_fwd_mma.cu", "common.cuh", "mma_tile.cuh"}
    assert reach["field_dw_mma"] == {"field_dw_mma.cu", "mma_tile.cuh"}
    assert reach["field_bwd_mma"] == {"field_bwd_mma.cu", "common.cuh", "mma_tile.cuh"}
    assert reach["fused_sdf_tf32"] == {"fused_sdf_tf32.cu", "tf32_tile.cuh", "common.cuh", "mma_tile.cuh"}
    assert reach["field_fwd_tf32"] == {"field_fwd_tf32.cu", "tf32_tile.cuh", "common.cuh", "mma_tile.cuh"}
    assert [name for name in _build.SOURCES if "mma_tile.cuh" in reach[name]] == [
        "fused_sdf", "field_fwd_mma", "field_dw_mma", "field_bwd_mma", "fused_sdf_tf32", "field_fwd_tf32"]
    assert [name for name in _build.SOURCES if "tf32_tile.cuh" in reach[name]] == ["fused_sdf_tf32", "field_fwd_tf32"]
    assert reach["fused_field"] == {"fused_field.cu", "field_tile.cuh", "common.cuh"}
    assert reach["fused_field_stash"] == {"fused_field_stash.cu", "field_tile.cuh", "common.cuh"}
    assert reach["fused_round"] == {"fused_round.cu"}


@pytest.mark.parametrize(
    "touched,stale",
    [
        ("mma_tile.cuh", {"fused_sdf", "field_fwd_mma", "field_dw_mma", "field_bwd_mma", "fused_sdf_tf32",
                          "field_fwd_tf32"}),
        ("field_tile.cuh", {"fused_field_stash", "fused_field"}),
        ("common.cuh", {"fused_sdf", "fused_field_stash", "fused_field", "field_fwd_mma", "field_bwd_mma",
                        "fused_sdf_tf32", "field_fwd_tf32"}),
        ("field_fwd_mma.cu", {"field_fwd_mma"}),
        ("field_dw_mma.cu", {"field_dw_mma"}),
        ("field_bwd_mma.cu", {"field_bwd_mma"}),
        ("tf32_tile.cuh", {"fused_sdf_tf32", "field_fwd_tf32"}),
        ("fused_sdf_tf32.cu", {"fused_sdf_tf32"}),
        ("field_fwd_tf32.cu", {"field_fwd_tf32"}),
    ],
)
def test_stale_on_the_kernel_sources(tmp_path, touched, stale):
    """``_stale`` on a copy of the real sources with every library built:
    touching one file makes exactly the libraries that reach it stale."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    out.mkdir()
    old = 1_000_000_000
    for src in _build.CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
        os.utime(csrc / src.name, (old, old))
    for name in _build.SOURCES:
        (out / f"lib{name}.so").write_bytes(b"")
        os.utime(out / f"lib{name}.so", (old + 10, old + 10))
    assert not any(_build._stale(name, csrc, out) for name in _build.SOURCES)
    os.utime(csrc / touched, (old + 20, old + 20))
    assert {name for name in _build.SOURCES if _build._stale(name, csrc, out)} == stale
