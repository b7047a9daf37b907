"""3xTF32: the f32 products of the f32 K1 and K3-fwd on the tensor cores.

The H100's tensor cores multiply f32 operands only as TF32 (10 mantissa
bits), which alone is far from f32 (the model's outputs move by up to 1e-3
of their scale, its spatial gradient by its own size). Split each operand v
as hi = tf32(v) and lo = tf32(v - hi), rounding to nearest with ties away
from zero as ``cvt.rna.tf32.f32`` does; then

    a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi

summed in f32 drops only a_lo b_lo (2^-22 of the product) and the bits that
the split leaves out (|v - hi - lo| <= 2^-21 |v|): three TF32 products give
an f32 result, if the sums are f32 sums. The tensor cores add each k8
step into their accumulator rounding toward zero, so over a 256-wide layer
the error piles up on one side (15 times plain f32's against f64 on the
model); the kernels restart the accumulator every pair of panels (k16),
add those sums in f32, rounded to nearest, and give back what the
truncations take off on average, about 0.65 ulp: five entries in eight,
chosen by the low three bits of the sum, move one ulp away from zero.
That brings the mean error to nearly zero and its spread below plain
f32's (``give_back``). ``tf32_split`` is the split, ``mm_3xtf32`` the product as the kernels
form it (rounding included), here on the CPU.

The packed weights (``csrc/fused_sdf_tf32.cu``, ``csrc/field_fwd_tf32.cu``
and ``csrc/tf32_tile.cuh`` hard-code the same numbers) are the shared-memory
image of *pairs*: a hi panel, then its lo panel, each PANEL_ROWS = 256 rows
(a product's output columns) by PANEL_K = 16 k values, K-major (the only
layout ``wgmma`` takes for TF32): row n holds its 16 values in 64 bytes,
its four 16-byte pieces permuted by the 64-byte swizzle (piece c at
position c ^ ((n >> 1) & 3)). Inside each group of 8 k the values are
permuted (``K_PERM``): position p holds k column K_PERM[p], so that the A
fragment of a k8 step, which takes (row g, k t) and (row g, k t + 4), is the
activations' columns 2t and 2t + 1, one 8-byte load from shared memory. A
pair is 32 KB, one slot of the kernels' ring. The pairs run in the order a
tile reads them (``SDF_PAIRS``, ``FIELD_PAIRS``); the products the kernels
take on the CUDA cores (the last implicit layer's sdf column, the heads'
output layers) follow as plain f32. Widths that are not a multiple of 16
(39, 217, the heads' 33 and 9 leading inputs) are zero-padded.

The weights are split and packed once per weight set: ``TensorCache`` keeps
the last one while every weight is the same storage at the same version.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

PANEL_K = 16  # k values of a panel: 64 bytes of f32
PANEL_ROWS = 256  # its rows: a product's output columns
PANEL_ELEMS = PANEL_ROWS * PANEL_K  # 16 KB
PAIR_ELEMS = 2 * PANEL_ELEMS  # the hi panel, then the lo panel: 32 KB
K_PERM = (0, 2, 4, 6, 1, 3, 5, 7)  # position p of a group of 8 holds k column K_PERM[p]

# (part, layer, first k row) of each pair, in the order a tile reads them.
# "fwd": W_l[k0 + k, n] at row n; "feat": layer 8's feature columns
# W_8[k0 + k, 1 + n]; "sweep": the transposed product's W_l[n, k0 + k];
# "lead" and "hfeat": a head's first layer split at its 256 feature rows,
# the leading rows W_l[k0 + k, n] (k0 + k < 33 or 9) and the feature rows
# W_l[n_lead + k0 + k, n].
_K16 = tuple(range(0, 256, PANEL_K))
N_LEAD = {9: 33, 14: 9}  # [x, PE4(d), grads] and [x, d, grads]
SDF_PAIRS = tuple(("fwd", 0, k0) for k0 in range(0, 39, PANEL_K)) + tuple(
    ("fwd", l, k0) for l in range(1, 8) for k0 in _K16
)
FIELD_PAIRS = (
    SDF_PAIRS
    + tuple(("feat", 8, k0) for k0 in _K16)
    + tuple(("sweep", l, k0) for l in range(7, -1, -1) for k0 in _K16)
    + tuple(
        p
        for l0 in (9, 14)
        for p in tuple(("lead", l0, k0) for k0 in range(0, N_LEAD[l0], PANEL_K))
        + tuple(("hfeat", l0, k0) for k0 in _K16)
        + tuple(("fwd", l, k0) for l in range(l0 + 1, l0 + 4) for k0 in _K16)
    )
)
N_SDF_PAIRS = len(SDF_PAIRS)  # 115
N_FIELD_PAIRS = len(FIELD_PAIRS)  # 391
# K1's buffer: its pairs, then W_8's sdf column (256 f32)
SDF_W8_OFF = N_SDF_PAIRS * PAIR_ELEMS
SDF_W_TOTAL = SDF_W8_OFF + 256
# the field forward's buffer: K1's, the further pairs, then W_13^T (3 x 256)
# and W_18^T (6 x 256)
FIELD_W13_OFF = SDF_W_TOTAL + (N_FIELD_PAIRS - N_SDF_PAIRS) * PAIR_ELEMS
FIELD_W18_OFF = FIELD_W13_OFF + 3 * 256
FIELD_W_TOTAL = FIELD_W18_OFF + 6 * 256


# ---------------------------------------------------------------------------
# the split and the product
# ---------------------------------------------------------------------------


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 -> f32 with the low 13 mantissa bits zero: rounded to nearest,
    ties away from zero (``cvt.rna.tf32.f32``). The bit pattern is sign and
    magnitude, so adding half a step to the magnitude and truncating rounds
    both signs away from zero at a tie."""
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(v: torch.Tensor):
    """(hi, lo): hi = tf32(v), lo = tf32(v - hi); v - hi is exact in f32."""
    hi = tf32_round(v)
    return hi, tf32_round(v.to(torch.float32) - hi)


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero."""
    y = x.to(torch.float32)
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def mm_3xtf32(a: torch.Tensor, b_hi: torch.Tensor, b_lo: torch.Tensor, terms: int = 3, sum_every: int = PANEL_K):
    """a @ b as the kernels form it on the tensor cores. ``a`` is split; each
    k8 step is three wgmmas (a_lo b_hi, a_hi b_lo, a_hi b_hi; ``terms=1``:
    a_hi b_hi alone), each adding its exact sum of 8 products into the tensor
    core's accumulator rounded toward zero (as the H100's tensor cores
    round). The accumulator starts from zero every ``sum_every`` k (a pair
    of panels), takes the small terms of the pair's k8 steps first, then
    the large ones, and those sums are added in f32, rounded to nearest;
    the truncations' expected loss is given back (``give_back``).
    ``sum_every=None``: one accumulator for the whole product, step after
    step, nothing given back."""
    a_hi, a_lo = tf32_split(a)
    k_total = a.shape[-1]
    acc = total = torch.zeros((*a.shape[:-1], b_hi.shape[-1]), dtype=torch.float32)
    for p0 in range(0, k_total, sum_every or k_total):
        steps = [(k0, k0 + 8) for k0 in range(p0, min(p0 + (sum_every or k_total), k_total), 8)]
        small = [(a_lo, b_hi), (a_hi, b_lo)] if terms == 3 else []
        if sum_every:
            seq = [(x, w, s) for s in steps for x, w in small] + [(a_hi, b_hi, s) for s in steps]
        else:
            seq = [(x, w, s) for s in steps for x, w in small + [(a_hi, b_hi)]]
        for x, w, (k0, k1) in seq:
            acc = _round_toward_zero(acc.double() + x[..., k0:k1].double() @ w[k0:k1].double())
        if sum_every:
            total, acc = total + acc, torch.zeros_like(acc)
    return give_back(total) if sum_every else acc


def give_back(v: torch.Tensor) -> torch.Tensor:
    """v moved one ulp away from zero (zero stays zero) where its low three
    bits are below 5, five values in eight: 0.625 ulp on average, the
    truncations' mean loss (0.65 ulp on the card)."""
    bits = v.contiguous().view(torch.int32)
    return (bits + ((v != 0) & ((bits & 7) < 5)).to(torch.int32)).view(torch.float32)


class Mm3xTf32(torch.autograd.Function):
    """h @ W by ``mm_3xtf32`` on W's split (hi, lo); its gradient in h is the
    transposed product formed the same way, as the kernels' sweep takes it.
    No gradient in W."""

    @staticmethod
    def forward(ctx, h, w_hi, w_lo, terms, sum_every):
        ctx.save_for_backward(w_hi, w_lo)
        ctx.how = (terms, sum_every)
        return mm_3xtf32(h, w_hi, w_lo, terms, sum_every)

    @staticmethod
    def backward(ctx, g):
        w_hi, w_lo = ctx.saved_tensors
        return mm_3xtf32(g, w_hi.T, w_lo.T, *ctx.how), None, None, None, None


# ---------------------------------------------------------------------------
# the packed weights
# ---------------------------------------------------------------------------

_K_OF_POS = torch.tensor([8 * (p // 8) + K_PERM[p % 8] for p in range(PANEL_K)])
_POS_OF_K = torch.argsort(_K_OF_POS)
_ROWS = torch.arange(PANEL_ROWS)[:, None]
_PIECE_AT = torch.arange(PANEL_K // 4)[None, :] ^ ((_ROWS >> 1) & 3)  # stored piece -> piece (an involution)


def _panel(block: torch.Tensor) -> torch.Tensor:
    """One panel as the kernel reads it: a (k <= 16, n <= 256) block of a
    product's B operand -> (PANEL_ROWS, PANEL_K), row n its 16 k values in
    the order of K_PERM, swizzled; zero where the block ends."""
    p = block.new_zeros((PANEL_ROWS, PANEL_K))
    p[: block.shape[1], : block.shape[0]] = block.T
    p = p[:, _K_OF_POS]
    return p.reshape(PANEL_ROWS, PANEL_K // 4, 4)[_ROWS, _PIECE_AT].reshape(PANEL_ROWS, PANEL_K)


def _unpanel(p: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_panel``: (PANEL_ROWS, PANEL_K) -> B's (16, 256) block."""
    p = p.reshape(PANEL_ROWS, PANEL_K // 4, 4)[_ROWS, _PIECE_AT].reshape(PANEL_ROWS, PANEL_K)
    return p[:, _POS_OF_K].T


def _block(ws, part: str, l: int, k0: int) -> torch.Tensor:
    """The (k, n) block of a pair's product from the (in, out) matrices ws."""
    w = ws[l]
    if part == "feat":
        return w[k0 : k0 + PANEL_K, 1:]
    if part == "sweep":
        return w[:, k0 : k0 + PANEL_K].T
    if part == "lead":
        return w[: N_LEAD[l]][k0 : k0 + PANEL_K]
    if part == "hfeat":
        return w[N_LEAD[l] + k0 : N_LEAD[l] + k0 + PANEL_K]
    return w[k0 : k0 + PANEL_K]


def _pairs(ws, layout) -> torch.Tensor:
    """The pairs of ``layout`` from the f32 matrices ws: (len, PAIR_ELEMS),
    each the hi panel then the lo panel."""
    vals = torch.stack([_panel(_block(ws, *p)) for p in layout]).reshape(len(layout), PANEL_ELEMS)
    return torch.cat(tf32_split(vals), dim=1)


def pack_sdf_weights_tf32(ws: List[torch.Tensor], bs: List[torch.Tensor]):
    """K1's nine (in, out) matrices and biases (layer 8: its sdf column) as
    the f32 tensor-core kernel reads them: (SDF_W_TOTAL,) and (B_TOTAL,) f32.
    The weights are the SDF_PAIRS, then W_8's sdf column unsplit; the biases
    are laid out as ``fused_sdf.pack_sdf_biases`` lays them out."""
    from . import fused_sdf as K1

    ws = [w.detach().float() for w in ws]
    bs = [b.detach().float().reshape(-1) for b in bs]
    w = torch.cat([_pairs(ws, SDF_PAIRS).reshape(-1), ws[8][:, 0]])
    return w, K1.pack_sdf_biases(bs)


def pack_field_weights_tf32(flat_eff: Sequence[torch.Tensor]):
    """The 19 layers of ``flat_eff`` as the f32 tensor-core field forward
    reads them: (FIELD_W_TOTAL,) and (FIELD_B_TOTAL,) f32. The weights are
    K1's buffer (``pack_sdf_weights_tf32``), the further FIELD_PAIRS, then
    W_13 and W_18 transposed, unsplit; the biases are laid out as
    ``fused_field_stash.pack_field_biases`` lays them out."""
    from .fused_field_stash import pack_field_biases

    ws = [w.detach().float() for w in flat_eff[0::2]]
    bs = [b.detach().float().reshape(-1) for b in flat_eff[1::2]]
    w_sdf, _ = pack_sdf_weights_tf32(ws[:8] + [ws[8][:, :1]], bs[:8] + [bs[8][:1]])
    rest = _pairs(ws, FIELD_PAIRS[N_SDF_PAIRS:]).reshape(-1)
    return torch.cat([w_sdf, rest, ws[13].T.reshape(-1), ws[18].T.reshape(-1)]), pack_field_biases(bs)


def unpack_pairs(w: torch.Tensor, layout):
    """{(part, layer): (hi, lo)}: each product's B operand, (k, n) matrices
    read back from the pairs of ``w`` (which starts at the first pair), the
    k rows of its pairs stacked in order, zero pads included (K rounded up
    to 16, N to 256)."""
    pairs = w[: len(layout) * PAIR_ELEMS].reshape(len(layout), 2, PANEL_ROWS, PANEL_K)
    by = {}
    for (part, l, _), pair in zip(layout, pairs):
        by.setdefault((part, l), ([], []))
        by[part, l][0].append(_unpanel(pair[0]))
        by[part, l][1].append(_unpanel(pair[1]))
    return {key: (torch.cat(hi), torch.cat(lo)) for key, (hi, lo) in by.items()}


# ---------------------------------------------------------------------------
# the kernels' math on the packed operands (CPU)
# ---------------------------------------------------------------------------


def fused_sdf_plain_tf32(emb: torch.Tensor, w: torch.Tensor, b: torch.Tensor, terms: int = 3,
                         sum_every: int = PANEL_K) -> torch.Tensor:
    """The f32 K1 kernel's math on its packed operands: ``fused_sdf_plain``
    with layers 0-7 as ``mm_3xtf32`` on the (hi, lo) read back from the
    pairs (the embedding zero-padded to 48, layer 3's pad columns dropped at
    the skip) and the sdf column in f32. ``terms``, ``sum_every``: as
    ``mm_3xtf32`` takes them."""
    from .fused_sdf import fused_sdf_plain

    mats = unpack_pairs(w, SDF_PAIRS)
    hi = [mats["fwd", l][0] for l in range(8)]
    lo = [mats["fwd", l][1] for l in range(8)]
    w8 = w[SDF_W8_OFF:SDF_W_TOTAL].reshape(256, 1)
    bs = [b[256 * l : 256 * (l + 1)] for l in range(8)] + [b[2048:]]

    def mm(h, l):
        if l == 8:
            return h @ w8
        h = torch.nn.functional.pad(h, (0, hi[l].shape[0] - h.shape[-1]))
        out = mm_3xtf32(h, hi[l], lo[l], terms, sum_every)
        return out[:, :217] if l == 3 else out

    return fused_sdf_plain(emb, [None] * 9, bs[:3] + [bs[3][:217]] + bs[4:], mm=mm)


def unpack_field_weights_tf32(w: torch.Tensor, b: torch.Tensor):
    """The 38 operands of ``pack_field_weights_tf32``'s buffers as the kernel
    multiplies them: (hi, lo, bias) of each layer, the (in, out) matrices at
    their canonical widths; the products the kernel takes in f32 (W_8's sdf
    column, W_13, W_18) as hi with lo = 0. And the sweep's (hi, lo) of W_l^T
    (l < 8, 256 x 256 with the pads), read from its own pairs."""
    from .fused_field import CANONICAL_SHAPES
    from .fused_field_stash import B8F_OFF, B_SLOT

    sdf = unpack_pairs(w, SDF_PAIRS)
    rest = unpack_pairs(w[SDF_W_TOTAL:FIELD_W13_OFF], FIELD_PAIRS[N_SDF_PAIRS:])
    mats = {**sdf, **{key: v for key, v in rest.items() if key[0] != "fwd"}}
    mats.update({("fwd", l): v for (part, l), v in rest.items() if part == "fwd"})
    zero = lambda t: torch.zeros_like(t)
    w8 = w[SDF_W8_OFF:SDF_W_TOTAL].reshape(256, 1)
    layers = [mats["fwd", l] for l in range(8)]
    feat = mats["feat", 8]
    layers.append((torch.cat([w8, feat[0]], dim=1), torch.cat([zero(w8), feat[1]], dim=1)))
    for l0, tail in ((9, w[FIELD_W13_OFF:FIELD_W18_OFF].reshape(3, 256)),
                     (14, w[FIELD_W18_OFF:FIELD_W_TOTAL].reshape(6, 256))):
        lead, hfeat = mats["lead", l0], mats["hfeat", l0]
        layers.append(tuple(torch.cat([a[: N_LEAD[l0]], c]) for a, c in zip(lead, hfeat)))
        layers += [mats["fwd", l] for l in range(l0 + 1, l0 + 4)]
        layers.append((tail.T, zero(tail.T)))
    out = []
    for l, ((hi, lo), (k, n)) in enumerate(zip(layers, CANONICAL_SHAPES)):
        slot = {8: None}.get(l, B_SLOT.get(l, l))
        bias = torch.cat([b[2048:2049], b[B8F_OFF : B8F_OFF + 256]]) if slot is None else b[256 * slot : 256 * slot + n]
        out.append((hi[:k, :n], lo[:k, :n], bias[None, :]))
    sweep = [mats["sweep", l] for l in range(8)]
    return out, sweep


def field_math_tf32(w: torch.Tensor, b: torch.Tensor, x, d, icfg, rcfg, terms: int = 3, sum_every: int = PANEL_K):
    """The f32 field forward kernel's math on its packed operands:
    ``field_math`` with every product ``mm_3xtf32`` on the (hi, lo) read
    back from the buffers (the spatial gradient's transposed products formed
    the same way, ``Mm3xTf32``), the f32 dot products of the kernel's
    epilogues as hi with lo = 0. ``terms``, ``sum_every``: as ``mm_3xtf32``
    takes them."""
    from .fused_field import field_math

    layers, _ = unpack_field_weights_tf32(w, b)
    flat, split = [], {}
    for hi, lo, bias in layers:
        flat += [hi, bias]
        split[id(hi)] = (hi, lo)

    def mm(h, wl, cd, el):
        return Mm3xTf32.apply(h, *split[id(wl)], terms, sum_every)

    return field_math(flat, x, d, icfg, rcfg, torch.float32, mm=mm)


class TensorCache:
    """One cached value, built from a set of tensors and kept while each of
    them is the same storage, at the same offset, shape and strides, at the
    same version (an in-place update bumps ``_version``). The tensors are
    held, so their storage cannot be freed and taken by another tensor while
    the value is cached."""

    def __init__(self):
        self.key, self.held, self.value = None, None, None

    def get(self, tensors: Sequence[torch.Tensor], build: Callable, *extra):
        key = tuple(
            (t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape), t.stride(), t.dtype,
             str(t.device), t._version)
            for t in tensors
        ) + extra
        if key != self.key:
            self.value = build()
            self.key, self.held = key, tuple(tensors)
        return self.value
