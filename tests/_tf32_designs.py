"""Shared inputs and checks of the 3xTF32 design tests (tests/test_torch_tf32*.py).

The design's accuracy: the emulated 3xTF32 products (``ops/tf32.py``) run
through ``fused_sdf_plain`` and ``field_math`` on the operands read back from
the packed buffers, against the JAX package's ``_field_math`` in f64
(``jax.enable_x64``) on the same inputs from a seed. Each output's max |err|
is at most 1.5x plain f32's against the same f64, or 2^-20 of its largest
entry. One TF32 product (1xTF32) fails the same check, and so do three
products into one tensor-core accumulator a layer.

The emulation is thousands of small f64 products: it runs on one thread
(``one_thread``), which takes about as long as all threads do alone and does
not slow down by a factor of tens when the test workers share the cores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import neat_tpu.model.neat as jneat
import neat_tpu.ops.fused_field as jff
import neat_tpu_torch.model.neat as tneat
from neat_tpu_torch.ops import fused_field as F
from neat_tpu_torch.ops import fused_sdf as K1
from neat_tpu_torch.ops import tf32 as T
from _torch_helpers import one_thread


def _flat(seed=0, positive=False):
    """38 f32 operands of the canonical shapes: W (in, out), b (1, out)."""
    rs = np.random.RandomState(seed)
    flat = []
    for i, o in F.CANONICAL_SHAPES:
        w = rs.randn(i, o) * (1.5 / np.sqrt(i))
        b = rs.randn(1, o) * 0.1
        if positive:  # no zero among the payload
            w, b = np.abs(w) + 1, np.abs(b) + 1
        flat += [torch.as_tensor(w.astype(np.float32)), torch.as_tensor(b.astype(np.float32))]
    return tuple(flat)


def _sdf_operands(flat):
    """K1's nine matrices and biases from the field's: layer 8's sdf column."""
    ws, bs = list(flat[0:18:2]), [b.reshape(-1) for b in flat[1:18:2]]
    return ws[:8] + [ws[8][:, :1]], bs[:8] + [bs[8][:1]]


def _points(n, seed):
    """Points with a quarter past the bounding sphere (clamp active), unit directions."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 3) * 2.4 - 1.2
    x[: n // 4] *= 3.2 / np.linalg.norm(x[: n // 4], axis=-1, keepdims=True)
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x.astype(np.float32), d.astype(np.float32)


def _within(got, plain, ref, what):
    """Each output: max |got - ref| <= max(1.5 x max |plain - ref|, 2^-20 max |ref|).
    Prints each output's two errors, of its largest f64 entry."""
    out, line = [], []
    for a, p, r in zip(got, plain, ref):
        a, p, r = (np.asarray(t, np.float64) for t in (a, p, r))
        err, err32, scale = np.abs(a - r).max(), np.abs(p - r).max(), np.abs(r).max()
        out.append(bool(err <= max(1.5 * err32, 2.0 ** -20 * scale)))
        line.append(f"{err / scale:.2e} (plain f32 {err32 / scale:.2e})")
    print(f"\n{what} against f64, of the largest entry: " + ", ".join(line))
    return out


def _jax_f64(flat, x, d):
    cfg = jneat.NeatConfig.for_abc()
    with jax.enable_x64(True):
        outs = jff._field_math(tuple(jnp.asarray(t.double().numpy()) for t in flat), jnp.asarray(x, jnp.float64),
                               jnp.asarray(d, jnp.float64), cfg.implicit, cfg.rendering, jnp.float64)
        return [np.asarray(o, np.float64) for o in outs]


# the kernels' products; one TF32 product; three with one tensor-core accumulator for a whole product
DESIGNS = {"3xtf32": ((3, T.PANEL_K), True), "1xtf32": ((1, T.PANEL_K), False),
           "one_accumulator": ((3, None), False)}


def k1_design_is_as_close_to_f64_as_f32(design, capsys):
    """The f32 K1's math on its packed operands against JAX's f64 sdf (the
    sphere clamp applied to both f32 routes)."""
    flat = _flat(seed=6)
    x, d = _points(1024, seed=7)
    ref = _jax_f64(flat, x, d)[0]
    icfg = tneat.NeatConfig.for_abc().implicit
    xt = torch.as_tensor(x)
    emb = F._pe(xt, icfg.multires)
    ws, bs = _sdf_operands(flat)
    sphere = icfg.sphere_scale * (icfg.sdf_bounding_sphere - np.linalg.norm(x.astype(np.float64), axis=-1))
    clamp = lambda raw: np.minimum(raw.numpy().astype(np.float64), sphere)[:, None]
    (terms, sum_every), holds = DESIGNS[design]
    with one_thread():
        got = clamp(T.fused_sdf_plain_tf32(emb, *T.pack_sdf_weights_tf32(ws, bs), terms, sum_every))
    plain = clamp(K1.fused_sdf_plain(emb, ws, bs))
    assert bool((sphere > ref[:, 0] + 1e-3).any())  # the clamp leaves most raw values alone
    with capsys.disabled():
        within = _within([got], [plain], [ref], f"K1 {design}: sdf")
    assert within == [holds]


def field_design_is_as_close_to_f64_as_f32(design, capsys):
    """The f32 field forward's math on its packed operands (``field_math``
    with every product, the spatial gradient's transposed ones too, as the
    kernel forms it) against JAX's f64 ``_field_math``: sdf, grads, rgb, att."""
    flat = _flat(seed=8)
    x, d = _points(512, seed=9)
    ref = _jax_f64(flat, x, d)
    cfg = tneat.NeatConfig.for_abc()
    xt, dt = torch.as_tensor(x), torch.as_tensor(d)
    (terms, sum_every), holds = DESIGNS[design]
    with one_thread():
        got = T.field_math_tf32(*T.pack_field_weights_tf32(flat), xt, dt, cfg.implicit, cfg.rendering, terms,
                                sum_every)
    plain = F.field_math(flat, xt, dt, cfg.implicit, cfg.rendering, torch.float32)
    with capsys.disabled():
        within = _within([t.detach() for t in got], [t.detach() for t in plain], ref, f"field {design}: sdf, grads, rgb, att")
    assert all(within) if holds else not all(within), within


