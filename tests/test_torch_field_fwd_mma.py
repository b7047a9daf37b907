"""The tensor-core field forward's packed operands and its plain version, on the CPU.

* ``pack_field_weights`` lays the 19 layers out as ``csrc/field_fwd_mma.cu``
  stages them: 99 swizzled panels of 256 x 64 in the order a tile reads
  them, the first 29 (and W_8's sdf column) being ``pack_sdf_weights``' own
  buffer, then the two output layers as rows. Unpacking gives every matrix,
  bias and transposed copy back bit for bit; every pad is zero; the gather
  form the wrapper runs equals the direct pack; the offsets are the ones the
  CUDA source hard-codes (read from it).
* ``field_fwd_plain_packed`` runs ``field_fwd_res`` on the padded operands
  read back from the buffers (the sweep through the transposed panels, each
  head's first layer split at its feature rows): zeros added to an f32 sum
  change nothing, so outputs and stash equal ``field_fwd_res``'s exactly
  (tolerance 0) in bf16 and f32, at sizes ragged against the 128-point tile
  (three points at least: one or two f32 rows take a matrix-vector routine
  that regroups the terms), with the sphere clamp active.
* In f32 it agrees with the JAX package's ``field_fwd_res`` and its
  ``_pack_res`` stash within 2e-5 of each output's largest entry (summation
  order only; the tolerance of ``test_torch_ops.py``).
* The wrappers refuse what the kernels do not take: CPU tensors (no silent
  fallback), f32 for the bf16 variants, unknown variants, wrong shapes.
* ``tools/field_fwd_phases.py``'s edits still find their places in the
  kernel's source.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neat_tpu.model.neat as jneat
import neat_tpu.ops.fused_field_stash as jfs
import neat_tpu_torch.model.neat as tneat
from neat_tpu_torch.ops import _build
from neat_tpu_torch.ops import fused_field as F
from neat_tpu_torch.ops import fused_field_stash as K
from neat_tpu_torch.ops import fused_sdf as K1

DTYPES = [torch.bfloat16, torch.float32]


def _flat(cd, seed=0, positive=False):
    """38 operands of the canonical shapes: W (in, out) in cd, b (1, out) f32."""
    rs = np.random.RandomState(seed)
    flat = []
    for i, o in F.CANONICAL_SHAPES:
        w = rs.randn(i, o).astype(np.float32) * (1.5 / np.sqrt(i))
        b = rs.randn(1, o).astype(np.float32) * 0.1
        if positive:  # no zero among the payload
            w, b = np.abs(w) + 1, np.abs(b) + 1
        flat += [torch.as_tensor(w).to(cd), torch.as_tensor(b)]
    return tuple(flat)


def _points(n, seed=3):
    """Points with a quarter past the bounding sphere (clamp active), unit directions."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 3) * 2.4 - 1.2
    far = max(1, n // 4)
    x[:far] *= 3.2 / np.linalg.norm(x[:far], axis=-1, keepdims=True)
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("cd", DTYPES)
def test_pack_field_weights_round_trips(cd):
    flat = _flat(cd)
    w, b = K.pack_field_weights(flat)
    assert w.shape == (K.FIELD_W_TOTAL,) and w.dtype == cd
    assert b.shape == (K.FIELD_B_TOTAL,) and b.dtype == torch.float32
    back, sweep = K.unpack_field_weights(w, b)
    assert len(back) == 38
    for a, c in zip(back, flat):
        assert a.shape == c.shape and torch.equal(a, c)
    for l in range(8):  # the sweep's transposed copies
        assert torch.equal(sweep[l], flat[2 * l].T)


@pytest.mark.parametrize("cd", DTYPES)
def test_pack_by_gather_is_pack(cd):
    for seed in (0, 7):  # the cached positions serve every later call
        flat = _flat(torch.float32, seed=seed)  # the gather casts to cd itself
        direct = K.pack_field_weights(tuple(t.to(cd) if i % 2 == 0 else t for i, t in enumerate(flat)))
        for a, c in zip(K.pack_field_weights_gather(flat, cd), direct):
            assert a.dtype == c.dtype and torch.equal(a, c)


def test_pads_are_zero_and_elements_sit_where_the_kernel_reads_them():
    flat = _flat(torch.bfloat16, seed=1, positive=True)
    ws = flat[0::2]
    w, b = K.pack_field_weights(flat)
    shapes = F.CANONICAL_SHAPES
    # every weight once, the eight implicit layers twice (the sweep's copy)
    assert int((w != 0).sum()) == sum(i * o for i, o in shapes) + sum(i * o for i, o in shapes[:8])
    assert int((b != 0).sum()) == sum(o for _, o in shapes)
    # panel p, row n, k: at p's panel, row n, 16-byte piece (k // 8) ^ (n % 8)
    rs = np.random.RandomState(5)

    def at(p, n, k):
        base = p * K1.PANEL_ELEMS if p < K1.N_PANELS else K.SDF_W_TOTAL + (p - K1.N_PANELS) * K1.PANEL_ELEMS
        return base + n * K1.PANEL_K + ((k // 8) ^ (n % 8)) * 8 + k % 8

    for p, (part, l, k0) in enumerate(K.FIELD_PANELS):
        wl = ws[l]
        for _ in range(50):
            k, n = rs.randint(K1.PANEL_K), rs.randint(K1.PANEL_ROWS)
            if part == "sweep":  # row n is the layer's input n, k its output k0 + k
                want = wl[n, k0 + k] if n < wl.shape[0] and k0 + k < wl.shape[1] else 0
            elif part == "feat":
                want = wl[k0 + k, 1 + n]
            elif part == "lead":
                want = wl[k, n] if k < K.N_LEAD[l] else 0
            elif part == "hfeat":
                want = wl[K.N_LEAD[l] + k0 + k, n]
            else:
                want = wl[k0 + k, n] if k0 + k < wl.shape[0] and n < wl.shape[1] else 0
            assert w[at(p, n, k)] == want, (part, l, k0, n, k)
    assert torch.equal(w[K.W13_OFF : K.W18_OFF], ws[13].T.reshape(-1))
    assert torch.equal(w[K.W18_OFF :], ws[18].T.reshape(-1))


@pytest.mark.parametrize("cd", DTYPES)
def test_the_first_panels_are_the_sdf_kernels(cd):
    flat = _flat(cd, seed=2)
    ws, bs = list(flat[0::2]), [x.reshape(-1) for x in flat[1::2]]
    w_sdf, b_sdf = K1.pack_sdf_weights(ws[:8] + [ws[8][:, :1]], bs[:8] + [bs[8][:1]])
    w, b = K.pack_field_weights(flat)
    assert torch.equal(w[: K.SDF_W_TOTAL], w_sdf) and K.SDF_W_TOTAL == K1.W_TOTAL
    assert torch.equal(b[: K1.B_TOTAL], b_sdf)


def test_packed_layout_matches_the_cuda_source():
    consts = {}
    for name in ("field_fwd_mma.cu", "mma_tile.cuh"):
        text = (_build.CSRC / name).read_text()
        consts.update({k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)})
    expect = dict(
        TILE_POINTS=K1.TILE_POINTS, N_SDF_PANELS=K1.N_PANELS, N_FIELD_PANELS=K.N_FIELD_PANELS,
        SDF_W_TOTAL=K.SDF_W_TOTAL, W8_OFF=K1.W8_OFF, W13_OFF=K.W13_OFF, W18_OFF=K.W18_OFF,
        FIELD_W_TOTAL=K.FIELD_W_TOTAL, B8_OFF=K1.B8_OFF, B8F_OFF=K.B8F_OFF,
        B9_OFF=256 * K.B_SLOT[9], B13_OFF=256 * K.B_SLOT[13], B14_OFF=256 * K.B_SLOT[14],
        B18_OFF=256 * K.B_SLOT[18], FIELD_B_TOTAL=K.FIELD_B_TOTAL, PANEL_K=K1.PANEL_K,
        PANEL_ROWS=K1.PANEL_ROWS,
    )
    for name, value in expect.items():
        assert consts[name] == value, name
    assert K.N_FIELD_PANELS == 99
    # the hidden head layers' biases lie 256 apart after the first layer's
    assert [K.B_SLOT[l] for l in range(9, 13)] == [K.B_SLOT[9] + i for i in range(4)]
    assert [K.B_SLOT[l] for l in range(14, 18)] == [K.B_SLOT[14] + i for i in range(4)]
    # the order a tile reads them: the chain, layer 8's features, the sweep
    # from layer 7 down, then each head (leading panel, features, 3 x 4)
    parts = [(part, l) for part, l, _ in K.FIELD_PANELS]
    assert parts[: K1.N_PANELS] == [("fwd", l) for l, _ in K1.PANELS]
    assert parts[29:33] == [("feat", 8)] * 4
    assert parts[33:65] == [("sweep", l) for l in range(7, -1, -1) for _ in range(4)]
    for first, l0 in ((65, 9), (82, 14)):
        assert parts[first : first + 17] == (
            [("lead", l0)] + [("hfeat", l0)] * 4 + [("fwd", l) for l in range(l0 + 1, l0 + 4) for _ in range(4)]
        )


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("n_points", [3, 129, 1000])
def test_plain_on_packed_operands_equals_field_fwd_res(cd, n_points):
    cfg = tneat.NeatConfig.for_abc()
    icfg, rcfg = cfg.implicit, cfg.rendering
    flat = _flat(cd, seed=4)
    x, d = (torch.as_tensor(a) for a in _points(n_points))
    out_r, res_r = K.field_fwd_res(flat, x, d, icfg, rcfg, cd)
    out_p, res_p = K.field_fwd_plain_packed(x, d, *K.pack_field_weights(flat), icfg, cd)
    assert bool((torch.linalg.norm(x, dim=-1) > icfg.sdf_bounding_sphere).any())  # the clamp is active
    assert float(out_r[1].abs().max()) > 1e-3  # the gradient sweep gives a signal to compare
    for a, c in zip((*out_r, *K._pack_res(res_r)), (*out_p, *K._pack_res(res_p))):
        assert a.dtype == c.dtype and a.shape == c.shape and torch.equal(a, c)


def test_plain_on_packed_operands_matches_jax():
    cfg_j, cfg_t = jneat.NeatConfig.for_abc(), tneat.NeatConfig.for_abc()
    flat = _flat(torch.float32, seed=6)
    x, d = _points(24, seed=8)
    out_j, res_j = jfs.field_fwd_res(
        tuple(jnp.asarray(t.numpy()) for t in flat), jnp.asarray(x), jnp.asarray(d),
        cfg_j.implicit, cfg_j.rendering, jnp.float32,
    )
    stash_j = jfs._pack_res(res_j, cfg_j.implicit)
    out_t, res_t = K.field_fwd_plain_packed(
        torch.as_tensor(x), torch.as_tensor(d), *K.pack_field_weights(flat), cfg_t.implicit, torch.float32
    )
    names = ("sdf", "grads", "rgb", "att", "stash_cd", "stash_f32")
    for name, a, b in zip(names, (*out_t, *K._pack_res(res_t)), (*out_j, *stash_j)):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 2e-5 * max(np.abs(b).max(), 1e-12), name


def _calls():
    flat = _flat(torch.bfloat16)
    icfg = tneat.NeatConfig.for_abc().implicit
    x, d = torch.zeros((4, 3)), torch.zeros((4, 3))
    bf = torch.bfloat16
    return {
        # a CPU tensor: no silent fallback
        "stash_cpu": (ValueError, lambda: K.field_fwd_stash_kernel(flat, x, d, icfg, bf)),
        "primal_cpu": (ValueError, lambda: F.field_fwd_kernel(flat, x, d, icfg, bf)),
        "stash_scalar_cpu": (ValueError, lambda: K.field_fwd_stash_kernel_variant(flat, x, d, icfg, bf, "scalar")),
        "primal_scalar_cpu": (ValueError, lambda: F.field_fwd_kernel_variant(flat, x, d, icfg, bf, "scalar")),
        # the variants are bf16 kernels, and there are two of them
        "stash_variant_f32": (TypeError, lambda: K.field_fwd_stash_kernel_variant(flat, x, d, icfg, torch.float32, "mma")),
        "primal_variant_f32": (TypeError, lambda: F.field_fwd_kernel_variant(flat, x, d, icfg, torch.float32, "mma")),
        "stash_variant_unknown": (ValueError, lambda: K.field_fwd_stash_kernel_variant(flat, x, d, icfg, bf, "wgmma")),
        "primal_variant_unknown": (ValueError, lambda: F.field_fwd_kernel_variant(flat, x, d, icfg, bf, "tf32")),
        # wrong shapes
        "stash_points_shape": (ValueError, lambda: K.field_fwd_stash_kernel(flat, torch.zeros((4, 2)), d, icfg, bf)),
        "primal_weights_shape": (ValueError, lambda: F.field_fwd_kernel(flat[2:] + flat[:2], x, d, icfg, bf)),
    }


@pytest.mark.parametrize("case", list(_calls()))
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    err, call = _calls()[case]
    with pytest.raises(err):
        call()


def test_phase_tool_instruments_the_kernel_source():
    """``tools/field_fwd_phases.py`` edits a copy of the kernel's source by
    matching its text: every edit still finds its place, and every turn
    gets a timestamp before, in and after it."""
    from neat_tpu_torch.tools import field_fwd_phases

    src = field_fwd_phases.instrumented_source()
    original = (_build.CSRC / "field_fwd_mma.cu").read_text()
    turns = original.count("take_turn();")
    assert turns > 0 and src.count("PHASE(1); take_turn(); PHASE(2);") == turns
    assert src.count("give_turn(); PHASE(3);") == original.count("give_turn();")
    for tag in (4, 5, 6, 7):
        assert src.count(f"PHASE({tag});") == 1
