"""The yardstick's arithmetic: the operations and bytes of the functions
the step's kernels compute, from the layer widths a configuration file
states, and the card's published peaks.

Operations are the matrix products' multiply-adds, two operations each.
Bytes count each input read once and each output written once: the
points, the weights, the upstream cotangents, the outputs and the
gradients. No stash, workspace or recomputation is counted, so no
implementation can read above its bound.

K1 is the sampler's proposal SDF: the encoded points (39 wide, bf16) in,
the SDF out, the chain with the last layer's SDF column alone. K2 is the
main field pass as one function, forward and backward: the SDF, its
spatial gradient, the colour and the attraction at each point, and their
vector-Jacobian product. Its forward is the chain, the gradient sweep
seeded on the SDF and the two heads; its backward is the heads twice
(weight gradient and transposed product), the tangent chain (no last
layer) and the combined sweep (a weight gradient and a transposed product
per layer for each half).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate, HBM3 bandwidth
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def implicit_shapes(model: dict) -> List[Tuple[int, int]]:
    """(in, out) of each SDF layer, the last one whole (SDF and features)."""
    imp = model["implicit"]
    enc = imp["d_in"] * (1 + 2 * imp["multires"]) if imp["multires"] > 0 else imp["d_in"]
    dims = (enc, *imp["dims"], imp["d_out"] + model["feature_vector_size"])
    return [(dims[l], dims[l + 1] - (enc if l + 1 in imp["skip_in"] else 0)) for l in range(len(dims) - 1)]


def head_shapes(model: dict, head: str) -> List[Tuple[int, int]]:
    h = model[head]
    d0 = h["d_in"] + model["feature_vector_size"]
    if h["multires_view"] > 0:
        d0 += 3 * 2 * h["multires_view"]
    dims = (d0, *h["dims"], h["d_out"])
    return [(dims[l], dims[l + 1]) for l in range(len(dims) - 1)]


def _macs(shapes) -> int:
    return sum(i * o for i, o in shapes)


def _weight_bytes(shapes, cd_bytes: int) -> int:
    return sum(i * o * cd_bytes + o * 4 for i, o in shapes)


def sdf_chain_macs(model: dict) -> int:
    """Multiply-adds a point of the SDF chain with the last layer's SDF
    column alone (the seeded gradient sweep costs the same)."""
    imp = implicit_shapes(model)
    return _macs(imp[:-1]) + imp[-1][0] * model["implicit"]["d_out"]


def k1_macs(model: dict) -> int:
    return sdf_chain_macs(model)


def k1_bytes(model: dict, n: int, cd_bytes: int = 2) -> int:
    """K1 at n points: the encoding read in the compute dtype, one float
    written a point, the weights read once."""
    imp = implicit_shapes(model)
    return n * (imp[0][0] * cd_bytes + 4) + _weight_bytes(imp[:-1] + [(imp[-1][0], 1)], cd_bytes)


def k2_macs(model: dict) -> Tuple[int, int]:
    """(forward, backward) multiply-adds a point of the field pass."""
    imp = implicit_shapes(model)
    full = _macs(imp)
    last = imp[-1][0] * imp[-1][1]
    seeded = sdf_chain_macs(model)
    heads = _macs(head_shapes(model, "rendering")) + _macs(head_shapes(model, "attraction"))
    return full + seeded + heads, 2 * heads + (full - last) + 2 * full + 2 * seeded


def k2_bytes(model: dict, n: int, cd_bytes: int = 2) -> int:
    """K2 forward and backward at n points: points and directions (24 B),
    the outputs (SDF, gradient, colour, two endpoints: 52 B), their
    cotangents (52 B), the points' and directions' gradients (24 B), the
    weights once and the weight gradients (f32) once."""
    shapes = implicit_shapes(model) + head_shapes(model, "rendering") + head_shapes(model, "attraction")
    n_params = sum(i * o + 2 * o for i, o in shapes)  # v, g, b of each weight-normed layer
    return n * (24 + 52 + 52 + 24) + _weight_bytes(shapes, cd_bytes) + 4 * n_params


def bound_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """(the least seconds on the card: the larger of the operations at the
    bf16 peak and the bytes at the memory rate, and which bounds it)."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def step_flops(model: dict, n_rays: int) -> Dict[str, float]:
    """The model FLOPs of one training step by part, from the shapes (no
    recomputation): the sampler's proposals, the field pass forward and
    backward, the eikonal points (the SDF and its gradient, then their
    backward), the surface points (forward only: no loss term reads them
    back) and the junction decoder forward and backward."""
    s = model["sampler"]
    proposals = n_rays * s["n_samples_eval"] * s["max_total_iters"]
    field = n_rays * (s["n_samples"] + s["n_samples_extra"] + 2)
    chain = sdf_chain_macs(model)
    fwd, bwd = k2_macs(model)
    imp = implicit_shapes(model)
    j = model["junctions"]
    jmacs = j["num_junctions"] * (j["dim_hidden"] ** 2 * j["num_layers"] + j["dim_hidden"] * j["dim_out"])
    return {
        "sampler": 2.0 * k1_macs(model) * proposals,
        "field": 2.0 * (fwd + bwd) * field,
        "eikonal": 2.0 * (2 * chain + 5 * chain - imp[-1][0]) * 2 * n_rays,
        "surface": 2.0 * (_macs(imp) + chain) * n_rays,
        "junctions": 2.0 * 3 * jmacs,
    }
