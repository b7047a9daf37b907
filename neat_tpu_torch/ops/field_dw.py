"""The weight gradients of the split field backward (K2-bwd, bf16): a
workspace of bf16 operands and a tensor-core GEMM that sums them.

The plain version computes every weight gradient of ``field_bwd_stashed``
as ``_mm(inp.T, cot, cd, el)``: both operands rounded to the compute dtype,
their products summed in f32. The split backward stores those rounded
operands instead of summing them tile by tile, and one GEMM (per layer
dW_l = sum over the points of A_l[p]^T Y_l[p]) sums them afterwards. The
implicit layers put their primal and tangent terms in one sum over twice the
points. Layer 8's tangent term is a column sum (its cotangent is the one-hot
sdf seed): the row-local pass adds it, and the GEMM only the primal term.

The workspace: one (WS_ROWS, np) array in the compute dtype, np the points
rounded up to a multiple of WS_CHUNK. Each operand is a block of rows, one
row per feature, each row holding the points contiguously (feature-major),
so the GEMM reads both operands K-major. Padded points are zeros in every
operand. The operands go layer by layer, in the order ``ws_operands`` gives.
This module is the one definition of the layout: the producer
(``csrc/field_tile.cuh``) takes the first row of each operand with its
launch, from ``ws_row_table``.

What bounds the GEMM on the H100: bytes at the main path's size. It does
1.52 M MACs a point (0.31 ms at the bf16 rate for 100,352 points) and reads
25.7 KB of workspace a point (0.77 ms at 3.35 TB/s). What the design does
about it (``csrc/field_dw_mma.cu``): output tiles of 128 x 256 on two
warpgroups (wgmma, both operands from 128-byte-swizzled shared memory), fed
by TMA through a ring of four stages with mbarriers; the points are split
over enough blocks to fill the card, each block writing its own f32 partial,
and a second kernel sums the partials of each tile in a fixed order and adds
them into the gradients: deterministic, no atomics.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from . import _build
from .fused_field import CANONICAL_SHAPES, N_IMPLICIT_LAYERS, _n_param_grads, _n_sm

WS_CHUNK = 64  # points of one k chunk of the GEMM (128 bytes of bf16)
TILE_M, TILE_N = 128, 256  # the GEMM's output tile
UNIT_INTS, TILE_INTS = 8, 8  # int32 fields of a work unit and of a tile


def ws_points(n: int) -> int:
    """Columns of the workspace for n points: a multiple of WS_CHUNK."""
    return -(-n // WS_CHUNK) * WS_CHUNK


def ws_operands(shapes: Sequence[Tuple[int, int]] = CANONICAL_SHAPES):
    """((kind, layer), rows) of every operand, in workspace order. For each
    layer: its input ("in"), for an implicit layer below 8 its tangent input
    ("tin"), its output cotangent ("cot") and tangent cotangent ("tcot")."""
    ops = []
    for l, (i, o) in enumerate(shapes):
        tangent = l < N_IMPLICIT_LAYERS - 1
        ops.append((("in", l), i))
        if tangent:
            ops.append((("tin", l), i))
        ops.append((("cot", l), o))
        if tangent:
            ops.append((("tcot", l), o))
    return tuple(ops)


def ws_rows(shapes=CANONICAL_SHAPES) -> Dict[Tuple[str, int], int]:
    """First row of each operand."""
    rows, at = {}, 0
    for key, r in ws_operands(shapes):
        rows[key] = at
        at += r
    return rows


WS_ROW = ws_rows()
WS_ROWS = sum(r for _, r in ws_operands())  # 12,852 bf16 values a point


def ws_row_table() -> List[int]:
    """The first rows the producer takes (its ``WsOut``): every layer's input,
    the tangent inputs of layers 0..7, every layer's cotangent, the tangent
    cotangents of layers 0..7, each group in layer order."""
    n_tangent = N_IMPLICIT_LAYERS - 1
    return ([WS_ROW["in", l] for l in range(len(CANONICAL_SHAPES))]
            + [WS_ROW["tin", l] for l in range(n_tangent)]
            + [WS_ROW["cot", l] for l in range(len(CANONICAL_SHAPES))]
            + [WS_ROW["tcot", l] for l in range(n_tangent)])


def dw_products(shapes=CANONICAL_SHAPES):
    """For each layer: (M = in, N = out, [(input row, cotangent row) of each
    term]); dW_l = sum over its terms of A^T Y."""
    rows = ws_rows(shapes)
    out = []
    for l, (i, o) in enumerate(shapes):
        terms = [(rows["in", l], rows["cot", l])]
        if l < N_IMPLICIT_LAYERS - 1:
            terms.append((rows["tin", l], rows["tcot", l]))
        out.append((i, o, terms))
    return out


def pack_workspace(ops: Dict[Tuple[str, int], torch.Tensor], n: int, cd, shapes=CANONICAL_SHAPES):
    """The (rows, np) workspace from the (n, width) operands, cast to cd;
    padded points are zeros."""
    width = ws_points(n)
    parts = []
    for key, r in ws_operands(shapes):
        t = ops[key].to(cd)
        if t.shape != (n, r):
            raise ValueError(f"workspace operand {key} is {tuple(t.shape)}, expected {(n, r)}")
        parts.append(torch.nn.functional.pad(t.T, (0, width - n)))
    return torch.cat(parts, dim=0).contiguous()


def unpack_workspace(ws: torch.Tensor, n: int, shapes=CANONICAL_SHAPES):
    """The inverse of ``pack_workspace``: {key: (n, width)}."""
    rows = ws_rows(shapes)
    return {key: ws[rows[key] : rows[key] + r, :n].T for key, r in ws_operands(shapes)}


def field_dw_plain(ws: torch.Tensor, shapes=CANONICAL_SHAPES) -> List[torch.Tensor]:
    """The plain version of the GEMM: dW_l (in, out) for every layer, each
    the f32 (for an f64 workspace f64) sum over all its terms and points of
    input x cotangent (layer 8: the primal term only)."""
    el = torch.promote_types(torch.float32, ws.dtype)
    out = []
    for m, n_, terms in dw_products(shapes):
        a = torch.cat([ws[ra : ra + m] for ra, _ in terms], dim=1).to(el)
        y = torch.cat([ws[ry : ry + n_] for _, ry in terms], dim=1).to(el)
        out.append(a @ y.T)
    return out


def param_offsets(shapes=CANONICAL_SHAPES) -> List[int]:
    """Offset of dW_l in the flat gradient vector (W_0, b_0, W_1, ...)."""
    offs, at = [], 0
    for i, o in shapes:
        offs.append(at)
        at += i * o + o
    return offs


def dw_schedule(n: int, n_sm: int, shapes=CANONICAL_SHAPES):
    """The GEMM's work for n points on n_sm SMs: (units, tiles), int32.

    A tile is 128 x 256 outputs of one layer; its k chunks (WS_CHUNK points
    of one term) are cut into runs of equal length, one work unit (block)
    each, so that there are about four units per SM. Units of the m tiles of
    one (layer, n tile, run) are neighbours, so they read the cotangent rows
    at the same time. A unit: (input row, cotangent row, first point) of the
    chunk range [c0, c1), with chunk c in term c // chunks, at point
    (c % chunks) * WS_CHUNK: [a_row0, y_row0, a_row1, y_row1, chunks, c0, c1,
    0]. A tile: [rows M, columns N, gradient offset of its first entry,
    row stride (the layer's out), first unit, unit stride, units, 0]."""
    chunks = ws_points(n) // WS_CHUNK
    prods = dw_products(shapes)
    total = sum(
        -(-m // TILE_M) * -(-o // TILE_N) * len(terms) * chunks for m, o, terms in prods
    )
    run = max(1, -(-total // (4 * n_sm)))
    offs = param_offsets(shapes)
    units, tiles = [], []
    for l, (m, o, terms) in enumerate(prods):
        n_mt, n_nt = -(-m // TILE_M), -(-o // TILE_N)
        span = len(terms) * chunks
        runs = [(c, min(c + run, span)) for c in range(0, span, run)]
        for nt in range(n_nt):
            base = len(units)
            for c0, c1 in runs:
                for mt in range(n_mt):
                    seg = [(ra + mt * TILE_M, ry + nt * TILE_N) for ra, ry in terms]
                    seg += seg[:1] * (2 - len(seg))
                    units.append([seg[0][0], seg[0][1], seg[1][0], seg[1][1], chunks, c0, c1, 0])
            for mt in range(n_mt):
                tiles.append([
                    min(TILE_M, m - mt * TILE_M), min(TILE_N, o - nt * TILE_N),
                    offs[l] + mt * TILE_M * o + nt * TILE_N, o, base + mt, n_mt, len(runs), 0,
                ])
    return torch.tensor(units, dtype=torch.int32), torch.tensor(tiles, dtype=torch.int32)


def dw_schedule_plain(ws: torch.Tensor, n: int, n_sm: int, shapes=CANONICAL_SHAPES) -> torch.Tensor:
    """What the GEMM computes, from its own schedule, in plain PyTorch: the
    flat f32 gradient vector with every dW entry the ordered sum of its
    units' f32 partials and every bias entry 0. The proof on the CPU that
    ``dw_schedule`` covers each product exactly once."""
    units, tiles = dw_schedule(n, n_sm, shapes)
    n_params = sum(i * o + o for i, o in shapes)
    out = torch.zeros(n_params, dtype=torch.float32, device=ws.device)
    wsf = ws.float()
    rows = wsf.shape[0]

    def block(r0, size, p0):  # rows r0 .. r0 + size of a chunk, zeros past the end (TMA's fill)
        b = wsf[r0 : min(r0 + size, rows), p0 : p0 + WS_CHUNK]
        return torch.nn.functional.pad(b, (0, 0, 0, size - b.shape[0]))

    partials = []
    for a0, y0, a1, y1, chunks, c0, c1, _ in units.tolist():
        acc = torch.zeros((TILE_M, TILE_N), dtype=torch.float32, device=ws.device)
        for c in range(c0, c1):
            ra, ry = (a0, y0) if c < chunks else (a1, y1)
            p0 = (c % chunks) * WS_CHUNK
            acc += block(ra, TILE_M, p0) @ block(ry, TILE_N, p0).T
        partials.append(acc)
    for m, o, g, ld, u0, stride, count, _ in tiles.tolist():
        s = partials[u0][:m, :o].clone()
        for k in range(1, count):
            s += partials[u0 + k * stride][:m, :o]
        idx = g + torch.arange(m)[:, None] * ld + torch.arange(o)[None, :]
        out[idx.reshape(-1).to(ws.device)] += s.reshape(-1)
    return out


_SCHEDULES = {}  # (points rounded up, n_sm, device) -> (units, tiles) on the device


def dw_launch(ws: torch.Tensor, n: int, dparams: torch.Tensor) -> None:
    """Launch the GEMM and the ordered sum of its partials on the bf16
    workspace ``ws`` of n points: every dW entry of the flat f32 gradient
    vector ``dparams`` gets the layer's sum added in place (layer 8: the
    primal term). CUDA tensors only. Counts nothing: each caller's wrapper
    counts its own launches."""
    np_ = ws_points(n)
    if not ws.is_cuda or ws.device != dparams.device:
        raise ValueError("the weight-gradient GEMM takes CUDA tensors on one device")
    if ws.dtype != torch.bfloat16 or ws.shape != (WS_ROWS, np_) or not ws.is_contiguous():
        raise ValueError("the weight-gradient GEMM takes the contiguous bf16 workspace of n points")
    if dparams.dtype != torch.float32 or dparams.shape != (_n_param_grads(),):
        raise ValueError("the weight-gradient GEMM adds into the flat f32 gradient vector")
    if n == 0:
        return
    n_sm = _n_sm(ws)
    key = (np_, n_sm, ws.device)
    if key not in _SCHEDULES:
        _SCHEDULES[key] = tuple(t.to(ws.device) for t in dw_schedule(n, n_sm))
    units, tiles = _SCHEDULES[key]
    partials = torch.empty((units.shape[0], TILE_M * TILE_N), dtype=torch.float32, device=ws.device)
    fn = _build.load("field_dw_mma").field_dw_mma
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    P = _build.ptr
    err = fn(P(ws), P(units), P(tiles), P(partials), P(dparams),
             units.shape[0], tiles.shape[0], WS_ROWS, np_, _build.stream_ptr(ws))
    _build.check(err, "weight-gradient GEMM launch")


def field_dw_kernel(ws: torch.Tensor, n: int, dparams: torch.Tensor) -> None:
    """K2-bwd's weight-gradient GEMM (``dw_launch``), counted."""
    dw_launch(ws, n, dparams)
    if n:
        field_dw_kernel.launches += 1


field_dw_kernel.launches = 0
