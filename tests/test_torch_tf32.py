"""The 3xTF32 operands of the f32 K1 and K3-fwd (``ops/tf32.py``), their
accuracy against the JAX package in f64, and the f32 dispatch, on the CPU.

* ``tf32_split``: hi has its low 13 bits zero, lo = tf32(v - hi), and
  |v - hi - lo| <= 2^-21 |v|; rounding is to nearest, ties away from zero
  (``cvt.rna.tf32.f32``), shown on hand-made bit patterns.
* The packers round-trip: every matrix comes back from its pairs as
  exactly ``tf32_split``'s hi and lo (so hi + lo summed in f64 is the split's
  sum bit for bit, within 2^-21 of the weight), every bias and every f32
  tail bit for bit; every pad is zero; the sweep's pairs hold the
  transposes; element W[k, n] sits where the kernel reads it (64-byte
  swizzle, k permuted inside each group of 8); the offsets and counts are
  the ones the CUDA sources hard-code (read from them).
* The design's accuracy against the JAX package in f64 is held in
  tests/test_torch_tf32_k1_design.py and test_torch_tf32_field_design.py
  (one file each, so the test workers take them apart).
* Dispatch (the launchers patched, the tensors made to look like CUDA
  tensors): no-grad ``field_primal``, ``fused_field_eval``,
  ``fused_field_eval_stash`` and ``fused_sdf_eval`` take the 3xTF32 kernels
  in f32; the recompute pair under autograd takes the scalar forward; the
  f32 variants accept "tf32" and "scalar" and refuse other names; a CPU
  tensor never reaches a launcher. ``TensorCache`` rebuilds exactly when a
  weight changes.
"""

import re

import numpy as np
import pytest
import torch

import neat_tpu_torch.model.neat as tneat
from neat_tpu_torch.ops import _build
from neat_tpu_torch.ops import fused_field as F
from neat_tpu_torch.ops import fused_field_stash as K
from neat_tpu_torch.ops import fused_sdf as K1
from neat_tpu_torch.ops import tf32 as T

from _tf32_designs import _flat, _points, _sdf_operands
from _torch_helpers import one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


BITS = lambda v: torch.tensor([v], dtype=torch.int64).to(torch.int32).view(torch.float32)


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------

ROUNDING = {
    "exact": (0x3F800000, 0x3F800000),
    "below_half": (0x3F800FFF, 0x3F800000),
    "above_half": (0x3F801001, 0x3F802000),
    "tie_away_from_even": (0x3F805000, 0x3F806000),  # nearest-even would keep 0x3F804000
    "tie_negative": (0xBF801000, 0xBF802000),
    "below_half_negative": (0xBF800FFF, 0xBF800000),
    "carry_into_the_exponent": (0x3FFFF000, 0x40000000),
    "subnormal_tie": (0x00001000, 0x00002000),
}


@pytest.mark.parametrize("case", list(ROUNDING))
def test_tf32_round_is_nearest_ties_away(case):
    v, want = ROUNDING[case]
    hi, lo = T.tf32_split(BITS(v))
    assert int(hi.view(torch.int32)) & 0xFFFFFFFF == want
    assert torch.equal(lo, T.tf32_round(BITS(v) - hi))


def test_tf32_split_bounds():
    rs = np.random.RandomState(0)
    v = torch.as_tensor((np.exp(rs.uniform(-40, 40, 100_000)) * rs.choice([-1, 1], 100_000)).astype(np.float32))
    hi, lo = T.tf32_split(v)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any()) and not bool((lo.view(torch.int32) & 0x1FFF).any())
    assert torch.equal((v - hi).double(), v.double() - hi.double())  # v - hi is exact in f32
    assert torch.equal(lo, T.tf32_round(v - hi))
    rest = (v.double() - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0 ** -21 * v.double().abs()).all())
    assert float(rest.max()) > 0  # the split is not exact: lo drops bits


def test_mm_3xtf32_takes_the_small_terms():
    """An exact product comes out exact, moved one ulp away from zero where
    its low three bits are below 5 (the kernels give back the truncations'
    expected loss to five entries in eight) and left where they are not;
    one TF32 product loses the small term; one accumulator gives nothing
    back."""
    a = BITS(0x3F800800).reshape(1, 1)  # 1 + 2^-12: hi = 1, lo = 2^-12
    b = torch.tensor([[3.0]])
    hi, lo = T.tf32_split(b)
    up = lambda v: float(torch.nextafter(torch.tensor(v), torch.tensor(float("inf"))))
    assert float(T.mm_3xtf32(a, hi, lo)) == up(3.0 + 3.0 * 2.0 ** -12)
    assert float(T.mm_3xtf32(-a, hi, lo)) == -up(3.0 + 3.0 * 2.0 ** -12)
    assert float(T.mm_3xtf32(a, hi, lo, terms=1)) == up(3.0)
    assert float(T.mm_3xtf32(a, hi, lo, sum_every=None)) == 3.0 + 3.0 * 2.0 ** -12
    odd = BITS(0x40400005).reshape(1, 1)  # 3 + 5 ulp: low bits 101, exact as hi + lo
    assert float(T.mm_3xtf32(torch.ones((1, 1)), *T.tf32_split(odd))) == float(odd)


# ---------------------------------------------------------------------------
# the packed weights
# ---------------------------------------------------------------------------


def test_pack_sdf_weights_tf32_round_trips():
    ws, bs = _sdf_operands(_flat(seed=1))
    w, b = T.pack_sdf_weights_tf32(ws, bs)
    assert w.shape == (T.SDF_W_TOTAL,) and b.shape == (K1.B_TOTAL,) and w.dtype == b.dtype == torch.float32
    mats = T.unpack_pairs(w, T.SDF_PAIRS)
    for l in range(8):
        hi, lo = mats["fwd", l]
        k, n = ws[l].shape
        assert hi.shape == lo.shape == (-(-k // 16) * 16, 256)
        h2, l2 = T.tf32_split(ws[l])
        assert torch.equal(hi[:k, :n], h2) and torch.equal(lo[:k, :n], l2)
        assert torch.equal(hi[:k, :n].double() + lo[:k, :n].double(), h2.double() + l2.double())
        assert bool(((hi[:k, :n].double() + lo[:k, :n].double() - ws[l].double()).abs()
                     <= 2.0 ** -21 * ws[l].double().abs()).all())
        assert not (hi[k:].any() or hi[:, n:].any() or lo[k:].any() or lo[:, n:].any())
    assert torch.equal(w[T.SDF_W8_OFF :], ws[8][:, 0])
    for l in range(8):
        assert torch.equal(b[256 * l : 256 * l + bs[l].shape[0]], bs[l]) and not b[256 * l + bs[l].shape[0] : 256 * (l + 1)].any()
    assert torch.equal(b[K1.B8_OFF :], bs[8])


def test_pack_field_weights_tf32_round_trips():
    flat = _flat(seed=2)
    w, b = T.pack_field_weights_tf32(flat)
    assert w.shape == (T.FIELD_W_TOTAL,) and b.shape == (K.FIELD_B_TOTAL,)
    layers, sweep = T.unpack_field_weights_tf32(w, b)
    assert len(layers) == 19
    for l, ((hi, lo, bias), wl, bl) in enumerate(zip(layers, flat[0::2], flat[1::2])):
        assert hi.shape == lo.shape == wl.shape and torch.equal(bias, bl), l
        h2, l2 = T.tf32_split(wl)
        if l in (13, 18):  # the heads' output layers: f32 dot products
            assert torch.equal(hi, wl) and not lo.any(), l
        elif l == 8:  # its sdf column in f32, its features split
            assert torch.equal(hi[:, 0], wl[:, 0]) and not lo[:, 0].any()
            assert torch.equal(hi[:, 1:], h2[:, 1:]) and torch.equal(lo[:, 1:], l2[:, 1:])
        else:
            assert torch.equal(hi, h2) and torch.equal(lo, l2), l
    for l in range(8):  # the sweep's pairs: the transposes, zero-padded to 256 x 256
        k, n = flat[2 * l].shape
        hi, lo = sweep[l]
        assert hi.shape == lo.shape == (256, 256)
        assert torch.equal(hi[:n, :k], layers[l][0].T) and torch.equal(lo[:n, :k], layers[l][1].T)
        assert not (hi[n:].any() or hi[:, k:].any() or lo[n:].any() or lo[:, k:].any())


def test_the_first_pairs_are_the_sdf_kernels():
    flat = _flat(seed=3)
    w_sdf, b_sdf = T.pack_sdf_weights_tf32(*_sdf_operands(flat))
    w, b = T.pack_field_weights_tf32(flat)
    assert torch.equal(w[: T.SDF_W_TOTAL], w_sdf) and torch.equal(b[: K1.B_TOTAL], b_sdf)
    # the biases are the bf16 forward's layout
    assert torch.equal(b, K.pack_field_weights(flat)[1])


@pytest.mark.parametrize("which", ["sdf", "field"])
def test_pads_are_zero_and_elements_sit_where_the_kernel_reads_them(which):
    flat = _flat(seed=4, positive=True)
    if which == "sdf":
        ws, bs = _sdf_operands(flat)
        w, _ = T.pack_sdf_weights_tf32(ws, bs)
        layout = T.SDF_PAIRS
    else:
        ws = flat[0::2]
        w, _ = T.pack_field_weights_tf32(flat)
        layout = T.FIELD_PAIRS
    # every split weight twice (hi, lo) where lo is not zero; count the hi's
    his = torch.cat([w[i * T.PAIR_ELEMS : i * T.PAIR_ELEMS + T.PANEL_ELEMS] for i in range(T.N_SDF_PAIRS)])
    assert int((his != 0).sum()) == sum(i * o for i, o in K1.CANONICAL_SHAPES[:8])
    rs = np.random.RandomState(5)
    for i, (part, l, k0) in enumerate(layout):
        at = i * T.PAIR_ELEMS if i < T.N_SDF_PAIRS else T.SDF_W_TOTAL + (i - T.N_SDF_PAIRS) * T.PAIR_ELEMS
        block = T._block([x.float() for x in ws], part, l, k0)
        hi, lo = T.tf32_split(block)
        for _ in range(20):
            if not block.numel():  # a pair past the layer's rows (layer 3's sweep: 217 -> 256)
                assert not w[at : at + T.PAIR_ELEMS].any()
                break
            k, n = rs.randint(block.shape[0]), rs.randint(block.shape[1])
            # position p of k in its group of 8, its 16-byte piece swizzled by the row
            p = 8 * (k // 8) + T.K_PERM.index(k % 8)
            off = n * T.PANEL_K + 4 * ((p // 4) ^ ((n >> 1) & 3)) + p % 4
            assert w[at + off] == hi[k, n] and w[at + T.PANEL_ELEMS + off] == lo[k, n], (part, l, k0, k, n)


def test_packed_layout_matches_the_cuda_source():
    consts = {}
    for name in ("fused_sdf_tf32.cu", "field_fwd_tf32.cu", "tf32_tile.cuh"):
        text = (_build.CSRC / name).read_text()
        found = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
        for k, v in found.items():  # the two kernels agree where they share a name
            assert consts.setdefault(k, v) == v, (name, k)
    expect = dict(
        TILE_POINTS=K1.TILE_POINTS, N_SDF_PAIRS=T.N_SDF_PAIRS, N_FIELD_PAIRS=T.N_FIELD_PAIRS,
        SDF_W8_OFF=T.SDF_W8_OFF, SDF_W_TOTAL=T.SDF_W_TOTAL, W13_OFF=T.FIELD_W13_OFF, W18_OFF=T.FIELD_W18_OFF,
        FIELD_W_TOTAL=T.FIELD_W_TOTAL, B8_OFF=K1.B8_OFF, B8F_OFF=K.B8F_OFF, B9_OFF=256 * K.B_SLOT[9],
        B13_OFF=256 * K.B_SLOT[13], B14_OFF=256 * K.B_SLOT[14], B18_OFF=256 * K.B_SLOT[18],
        PANEL_K=T.PANEL_K, PANEL_ROWS=T.PANEL_ROWS, N_SKIP=217,
    )
    for name, value in expect.items():
        assert consts[name] == value, name
    assert T.N_SDF_PAIRS == 115 and T.N_FIELD_PAIRS == 391
    assert T.PAIR_ELEMS * 4 == 32768  # a pair is one 32 KB slot of the ring
    # the order a tile reads them: the chain (layer 0 in three), layer 8's
    # features, the sweep from layer 7 down, then each head (leading pairs,
    # feature pairs, 3 x 16)
    parts = [(part, l) for part, l, _ in T.FIELD_PAIRS]
    assert parts[:3] == [("fwd", 0)] * 3 and parts[3:115] == [("fwd", l) for l in range(1, 8) for _ in range(16)]
    assert parts[115:131] == [("feat", 8)] * 16
    assert parts[131:259] == [("sweep", l) for l in range(7, -1, -1) for _ in range(16)]
    for first, l0, n_lead in ((259, 9, 3), (326, 14, 1)):
        assert parts[first : first + n_lead + 64] == (
            [("lead", l0)] * n_lead + [("hfeat", l0)] * 16 + [("fwd", l) for l in range(l0 + 1, l0 + 4) for _ in range(16)]
        )


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


@pytest.fixture
def launches(monkeypatch):
    """The launch helpers replaced by recorders of (kernel, variant) that
    return zeros; the recorded list."""
    seen = []

    def fwd(flat_eff, x, d, icfg, cd, variant):
        seen.append(("field_fwd", str(cd), variant))
        return tuple(torch.zeros((x.shape[0], w)) for w in F.OUT_WIDTHS)

    def sdf(emb, ws, bs, variant):
        seen.append(("fused_sdf", str(emb.dtype), variant))
        return torch.zeros((emb.shape[0],))

    monkeypatch.setattr(F, "_fwd_launch", fwd)
    monkeypatch.setattr(K1, "_launch", sdf)
    # the wrappers count these fake launches: their counts come back after
    # the test, so a later test in this process sees only its own
    for wrapper in (F.field_fwd_kernel, F.field_bwd_kernel, K.field_fwd_stash_kernel, K1.fused_sdf_kernel):
        monkeypatch.setattr(wrapper, "launches", wrapper.launches)
    return seen


@pytest.fixture
def model():
    cfg = tneat.NeatConfig.for_abc()
    return cfg, tneat.init_neat(cfg, seed=0, device="cpu")


def _eval(kind, cfg, m, x, d):
    c = dict(compute_dtype="float32", acfg=cfg.attraction)
    if kind == "field_primal":
        flat = tuple(t.detach() for t in F._flatten_eff(m))
        return F.field_primal(flat, x, d, cfg.implicit, cfg.rendering, torch.float32)
    if kind == "eval_recompute":
        return F.fused_field_eval(m, x, d, cfg.implicit, cfg.rendering, **c)
    if kind == "eval_stash":
        return K.fused_field_eval_stash(m, x, d, cfg.implicit, cfg.rendering, **c)
    return K1.fused_sdf_eval(m.implicit, x, cfg.implicit, "float32")


DISPATCH = {  # (route, grad mode) -> the launches it makes
    ("field_primal", False): [("field_fwd", "torch.float32", "tf32")],
    ("eval_recompute", False): [("field_fwd", "torch.float32", "tf32")],
    ("eval_stash", False): [("field_fwd", "torch.float32", "tf32")],
    ("fused_sdf_eval", False): [("fused_sdf", "torch.float32", "tf32")],
    # the recompute pair under autograd: its f32 forward is the scalar tile K3-bwd re-runs
    ("eval_recompute", True): [("field_fwd", "torch.float32", "scalar")],
}


@pytest.mark.parametrize("route,grad", list(DISPATCH), ids=[f"{r}-{'grad' if g else 'no_grad'}" for r, g in DISPATCH])
def test_f32_dispatch_picks_the_kernel(monkeypatch, launches, model, route, grad):
    cfg, m = model
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True), raising=False)
    x, d = (torch.as_tensor(a) for a in _points(8, seed=10))
    with torch.set_grad_enabled(grad):
        _eval(route, cfg, m, x, d)
    assert launches == DISPATCH[route, grad]


@pytest.mark.parametrize("route", ["field_primal", "eval_recompute", "eval_stash", "fused_sdf_eval"])
def test_a_cpu_tensor_never_reaches_a_launcher(launches, model, route):
    cfg, m = model
    x, d = (torch.as_tensor(a) for a in _points(8, seed=11))
    with torch.no_grad():
        out = _eval(route, cfg, m, x, d)
    assert launches == []
    if route != "fused_sdf_eval":
        flat = tuple(t.detach() for t in F._flatten_eff(m))
        ref = F.field_math(flat, x, d, cfg.implicit, cfg.rendering, torch.float32)
        for a, b in zip(out[:3], ref[:3]):
            assert torch.equal(a, b)


VARIANTS = {  # (kernel, variant) -> what the call does: the launch it makes, or the error
    ("k1", "tf32"): ("fused_sdf", "tf32"),
    ("k1", "scalar"): ("fused_sdf", "scalar"),
    ("k1", "wgmma_exact"): TypeError,  # a bf16 kernel
    ("k1", "nope"): TypeError,
    ("k3", "tf32"): ("field_fwd", "tf32"),
    ("k3", "scalar"): ("field_fwd", "scalar"),
    ("k3", "mma"): TypeError,  # the bf16 kernel
    ("k3", "nope"): TypeError,
}


@pytest.mark.parametrize("kernel,variant", list(VARIANTS), ids=[f"{k}-{v}" for k, v in VARIANTS])
def test_f32_variants_accept_tf32_and_scalar_only(launches, kernel, variant):
    flat = _flat(seed=12)
    icfg = tneat.NeatConfig.for_abc().implicit
    x = torch.zeros((4, 3))
    if kernel == "k1":
        call = lambda: K1.fused_sdf_kernel_variant(torch.zeros((4, 39)), *_sdf_operands(flat), variant)
    else:
        call = lambda: F.field_fwd_kernel_variant(flat, x, x, icfg, torch.float32, variant)
    want = VARIANTS[kernel, variant]
    if isinstance(want, tuple):
        call()
        assert launches == [(want[0], "torch.float32", want[1])]
    else:
        with pytest.raises(want):
            call()
        assert launches == []


def test_tensor_cache_rebuilds_when_a_weight_changes():
    cache, built = T.TensorCache(), []
    w, b = torch.ones(4, 3), torch.zeros(3)
    build = lambda: built.append(1) or len(built)
    assert cache.get((w, b), build) == 1
    assert cache.get((w, b), build) == 1  # the same tensors: kept
    assert cache.get((w.T.T, b[:]), build) == 1  # other views of the same storage: kept
    w.add_(1.0)  # an in-place update bumps the version
    assert cache.get((w, b), build) == 2
    assert cache.get((w.clone(), b), build) == 3  # another storage
    assert cache.get((w[:2], b), build) == 4  # another shape


def test_variant_tool_edits_find_their_places():
    """``tools/tf32_variants.py`` edits copies of the kernels' sources by
    matching their text: every edit of every variant still finds its place."""
    from neat_tpu_torch.tools import tf32_variants as V

    tree = V.variant_sources("tree")
    for name in V.VARIANTS:
        changed = {f for f, text in V.variant_sources(name).items() if text != tree[f]}
        assert changed == set(V.VARIANTS[name]), name
