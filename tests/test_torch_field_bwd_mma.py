"""The tensor-core row-local pass's packed operands and its plain version, on
the CPU.

* ``pack_field_bwd_weights`` lays the 19 layers out as
  ``csrc/field_bwd_mma.cu`` stages them: 105 swizzled panels of 256 x 64 in
  the order a tile reads them (each head's hidden layers transposed, its
  first layer's leading and feature rows; the tangent forward's panels,
  which are K1's; layer 8's feature columns and the implicit layers
  transposed for the sweep), then W_13^T, W_18^T and W_8's sdf column. Every
  element sits where the kernel reads it (the 128-byte swizzle: row n's
  16-byte piece c at c ^ (n % 8)), every pad is zero, the gather form the
  wrapper runs equals the direct pack, and the numbers the CUDA source
  hard-codes are read from it and match.
* ``field_bwd_plain_packed`` reads every product's matrix from that buffer
  alone and equals ``field_bwd_rowlocal_plain`` bit for bit (workspace, bias
  gradients, layer 8's tangent column, dx, dd) at 1, 63, 64, 65 and 300
  points, around the 64-point tile, the sphere clamp active.
* ``bwd_mma_table``, the kernel's int table: the workspace rows, each
  bias's offset in a block's partials and in the gradient vector, and layer
  8's tangent column's place.
* ``tools/field_bwd_variants.py``'s text edits of the kernel source each
  find their one place.
"""

import re

import numpy as np
import pytest
import torch

import neat_tpu_torch.model.neat as tneat
from neat_tpu_torch.ops import _build
from neat_tpu_torch.ops import field_dw as DW
from neat_tpu_torch.ops import fused_field as F
from neat_tpu_torch.ops import fused_field_stash as K
from neat_tpu_torch.ops import fused_sdf as K1
from test_torch_field_fwd_mma import _flat, _points


def _at(p, n, k):
    """Element (row n, k) of panel p in the packed buffer."""
    return p * K1.PANEL_ELEMS + n * K1.PANEL_K + ((k // 8) ^ (n % 8)) * 8 + k % 8


def test_every_panel_element_sits_where_the_kernel_reads_it():
    flat = _flat(torch.bfloat16, seed=1, positive=True)
    ws = flat[0::2]
    w = K.pack_field_bwd_weights(flat)
    assert w.shape == (K.BWD_W_TOTAL,) and w.dtype == torch.bfloat16
    shapes = F.CANONICAL_SHAPES
    # every weight of the 19 layers once for the transposed products (W_8's
    # sdf column after the panels), the eight implicit layers once more for
    # the tangent forward
    assert int((w != 0).sum()) == sum(i * o for i, o in shapes) + sum(i * o for i, o in shapes[:8])
    rs = np.random.RandomState(5)
    for p, (part, l, k0) in enumerate(K.BWD_PANELS):
        wl = ws[l]
        for _ in range(40):
            n, k = rs.randint(K1.PANEL_ROWS), rs.randint(K1.PANEL_K)
            if part == "tr":  # row n is the layer's input n, k its output k0 + k
                want = wl[n, k0 + k] if n < wl.shape[0] and k0 + k < wl.shape[1] else 0
            elif part == "trlead":
                want = wl[n, k0 + k] if n < K.N_LEAD[l] else 0
            elif part == "trfeat":
                want = wl[K.N_LEAD[l] + n, k0 + k]
            elif part == "tr8":
                want = wl[n, 1 + k0 + k]
            else:  # the tangent forward: row n is the output, k the input k0 + k
                want = wl[k0 + k, n] if k0 + k < wl.shape[0] and n < wl.shape[1] else 0
            assert w[_at(p, n, k)] == want, (part, l, k0, n, k)
    assert torch.equal(w[K.BWD_W13_OFF : K.BWD_W18_OFF], ws[13].T.reshape(-1))
    assert torch.equal(w[K.BWD_W18_OFF : K.BWD_W8_OFF], ws[18].T.reshape(-1))
    assert torch.equal(w[K.BWD_W8_OFF :], ws[8][:, 0])


def test_the_panels_come_in_the_order_a_tile_reads_them():
    parts = [(part, l) for part, l, _ in K.BWD_PANELS]
    assert K.N_BWD_PANELS == len(parts) == 105
    for first, l0 in ((0, 9), (20, 14)):
        assert parts[first : first + 20] == (
            [("tr", l) for l in (l0 + 3, l0 + 2, l0 + 1) for _ in range(4)]
            + [("trlead", l0)] * 4 + [("trfeat", l0)] * 4
        )
    assert parts[40:69] == [("fwd", l) for l, _ in K1.PANELS]
    assert parts[69:73] == [("tr8", 8)] * 4
    assert parts[73:] == [("tr", l) for l in range(7, -1, -1) for _ in range(4)]
    # the tangent forward's panels are K1's, in K1's order
    flat = _flat(torch.bfloat16, seed=4)
    w = K.pack_field_bwd_weights(flat)
    ws, bs = list(flat[0::2]), [b.reshape(-1) for b in flat[1::2]]
    w_sdf, _ = K1.pack_sdf_weights(ws[:8] + [ws[8][:, :1]], bs[:8] + [bs[8][:1]])
    assert torch.equal(w[40 * K1.PANEL_ELEMS : 69 * K1.PANEL_ELEMS], w_sdf[: K1.W8_OFF])


@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_pack_by_gather_is_pack_and_unpacks_to_the_operands(cd):
    flat = _flat(cd, seed=3)
    w = K.pack_field_bwd_weights(flat)
    assert torch.equal(K.pack_field_bwd_weights_gather(flat, cd), w)
    fwd, tr = K.unpack_field_bwd_weights(w)
    assert len(fwd) == 8 and len(tr) == 19
    for l, m in enumerate(flat[0::2]):
        assert tr[l].is_contiguous() and torch.equal(tr[l], m), l
        if l < 8:
            assert fwd[l].is_contiguous() and torch.equal(fwd[l], m), l


def test_packed_layout_matches_the_cuda_source():
    text = (_build.CSRC / "field_bwd_mma.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert consts["N_PANELS"] == K.N_BWD_PANELS
    assert consts["N_LEAD_R"] == K.N_LEAD[9] and consts["N_LEAD_A"] == K.N_LEAD[14]
    table = K.bwd_mma_table()
    assert consts["N_BIAS"] == table[len(DW.ws_row_table()) + 19] == sum(o for _, o in F.CANONICAL_SHAPES)
    # W_13^T, W_18^T and W_8's sdf column right after the panels
    offs = re.findall(r"constexpr long (\w+) = ([^;]+);", text)
    assert [name for name, _ in offs[:3]] == ["W13T_OFF", "W18T_OFF", "W8S_OFF"]
    assert (K.BWD_W18_OFF - K.BWD_W13_OFF, K.BWD_W8_OFF - K.BWD_W18_OFF, K.BWD_W_TOTAL - K.BWD_W8_OFF) == (
        3 * 256, 6 * 256, 256)
    assert K.BWD_W13_OFF == K.N_BWD_PANELS * K1.PANEL_ELEMS


def test_the_kernel_table_holds_rows_and_offsets():
    table = K.bwd_mma_table()
    rows = DW.ws_row_table()
    assert len(table) == len(rows) + 20 + 19 + 2 == 95
    assert table[: len(rows)] == rows
    boff, gbias, (g8, out8) = table[54:74], table[74:93], table[93:]
    outs = [o for _, o in F.CANONICAL_SHAPES]
    assert boff == [sum(outs[:l]) for l in range(20)]
    offs = DW.param_offsets()
    for l, (i, o) in enumerate(F.CANONICAL_SHAPES):
        assert gbias[l] == offs[l] + i * o  # b_l follows dW_l
    assert (g8, out8) == (offs[8], 257)


@pytest.mark.parametrize("n_points", [1, 63, 64, 65, 300])
def test_plain_on_packed_operands_equals_the_plain_row_local_pass(n_points):
    cd = torch.bfloat16
    cfg = tneat.NeatConfig.for_abc()
    icfg, rcfg = cfg.implicit, cfg.rendering
    flat = _flat(cd, seed=n_points)
    x, d = (torch.as_tensor(a) for a in _points(n_points, seed=n_points))
    rs = np.random.RandomState(n_points)
    cots = [torch.as_tensor(rs.randn(n_points, w).astype(np.float32)) for w in (1, 3, 3, 6)]
    _, res = K.field_fwd_res(flat, x, d, icfg, rcfg, cd)
    assert bool((x.norm(dim=-1) > 3.0).any())
    want = K.field_bwd_rowlocal_plain(flat, x, d, res, cots, icfg, rcfg, cd)
    got = K.field_bwd_plain_packed(flat, x, d, res, cots, K.pack_field_bwd_weights(flat), icfg, rcfg, cd)
    assert torch.equal(got[0], want[0])  # the workspace
    assert len(got[1]) == len(want[1]) == 19
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    for a, b in zip(got[2:], want[2:]):  # col8, dx, dd
        assert torch.equal(a, b)


def test_variant_tool_edits_the_kernel_source():
    """``tools/field_bwd_variants.py`` builds edits of the pass's source by
    matching its text: each edit finds exactly one place, and the tree's
    variant is the source itself."""
    from neat_tpu_torch.tools import field_bwd_variants as V

    text = (_build.CSRC / "field_bwd_mma.cu").read_text()
    assert V.variant_source("tree") == text
    for name, edits in V.VARIANTS.items():
        src = V.variant_source(name)
        for old, new in edits:
            assert text.count(old) == 1 and old not in src and new in src, (name, old)
