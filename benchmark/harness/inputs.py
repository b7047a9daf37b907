"""What the benchmark makes from ``--seed``, on the device, in a few large
calls: the weights (the published initialisation: the SDF network's
geometric sphere init of IDR / VolSDF, the heads' and the junction
decoder's uniform fan-in init, normal junction latents) and the scene (the
configuration's ``assumed`` views, lines, junctions and support pixels,
in the per-pixel tables the training step reads). Both go to the program
and to the reference alike."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def _seed_word(seed: int, tag: int) -> int:
    """A 63-bit generator seed for one use (``tag``) of the run's seed."""
    words = np.random.SeedSequence([seed, 0x62656E63, tag]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def _generator(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_seed_word(seed, tag))


def _layouts(model: dict) -> List[Tuple[str, str, int, int, dict]]:
    """(prefix, kind, in, out, extra) of every linear layer, in the
    program's parameter order."""
    imp = model["implicit"]
    feat = model["feature_vector_size"]
    enc = imp["d_in"] * (1 + 2 * imp["multires"])
    dims = (enc, *imp["dims"], imp["d_out"] + feat)
    out = []
    for l in range(len(dims) - 1):
        o = dims[l + 1] - (enc if l + 1 in imp["skip_in"] else 0)
        kind = "sdf_last" if l == len(dims) - 2 else "sdf_first" if l == 0 else (
            "sdf_skip" if l in imp["skip_in"] else "sdf")
        out.append((f"implicit.lin{l}", kind, dims[l], o, {"enc": enc}))
    for head in ("rendering", "attraction"):
        h = model[head]
        d0 = h["d_in"] + feat + (3 * 2 * h["multires_view"] if h["multires_view"] > 0 else 0)
        hd = (d0, *h["dims"], h["d_out"])
        out += [(f"{head}.lin{l}", "uniform", hd[l], hd[l + 1], {}) for l in range(len(hd) - 1)]
    j = model["junctions"]
    out += [(f"junctions.ffn.lin{i}", "plain", j["dim_hidden"],
             j["dim_hidden"] if i != j["num_layers"] else j["dim_out"], {}) for i in range(j["num_layers"] + 1)]
    return out


def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter leaf under the program's name, float32 on
    ``device``: one normal and one uniform draw for the whole model."""
    layers = _layouts(model)
    j = model["junctions"]
    n_normal = sum(i * o for _, k, i, o, _ in layers if k.startswith("sdf")) + j["num_junctions"] * j["dim_hidden"]
    n_uniform = sum(i * o + o for _, k, i, o, _ in layers if not k.startswith("sdf"))
    gen = _generator(seed, 1, device)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0
    bias = model["implicit"]["bias"]
    out: Dict[str, torch.Tensor] = {}
    ni = ui = 0
    for name, kind, d_in, d_out, extra in layers:
        if kind.startswith("sdf"):
            w = normal[ni:ni + d_in * d_out].reshape(d_out, d_in)
            ni += d_in * d_out
            b = torch.zeros(d_out, device=device)
            std = math.sqrt(2.0) / math.sqrt(d_out)
            if kind == "sdf_last":
                w = w * 1e-4 + math.sqrt(math.pi) / math.sqrt(d_in)
                b = torch.full((d_out,), -bias, device=device)
            elif kind == "sdf_first":  # the encoding's frequencies start at zero
                w = torch.cat([w[:, :3] * std, torch.zeros_like(w[:, 3:])], dim=1)
            elif kind == "sdf_skip":  # the skipped-in encoding starts at zero
                w = torch.cat([w[:, :d_in - extra["enc"] + 3] * std, torch.zeros_like(w[:, d_in - extra["enc"] + 3:])],
                              dim=1)
            else:
                w = w * std
        else:
            bound = 1.0 / math.sqrt(d_in)
            w = uniform[ui:ui + d_in * d_out].reshape(d_out, d_in) * bound
            b = uniform[ui + d_in * d_out:ui + d_in * d_out + d_out] * bound
            ui += d_in * d_out + d_out
        if kind == "plain":
            out[f"{name}.w"], out[f"{name}.b"] = w.contiguous(), b.contiguous()
        else:  # weight-normed: v, g = |v| by rows, b
            out[f"{name}.v"], out[f"{name}.g"], out[f"{name}.b"] = (
                w.contiguous(), torch.linalg.norm(w, dim=1), b.contiguous())
    out["density.beta"] = torch.tensor(model["density_beta_init"], dtype=torch.float32, device=device)
    out["junctions.latents"] = normal[ni:ni + j["num_junctions"] * j["dim_hidden"]].reshape(
        j["num_junctions"], j["dim_hidden"]).clone()
    return out


def _look_at(centres: torch.Tensor) -> torch.Tensor:
    """Camera-to-world 4x4 poses at ``centres`` (V, 3) looking at the
    origin, the image's y axis towards world -z."""
    fwd = -centres / torch.linalg.norm(centres, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], device=centres.device).expand_as(fwd)
    right = torch.linalg.cross(fwd, up, dim=-1)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right, dim=-1)
    pose = torch.eye(4, device=centres.device).repeat(centres.shape[0], 1, 1)
    pose[:, :3, 0], pose[:, :3, 1], pose[:, :3, 2], pose[:, :3, 3] = right, down, fwd, centres
    return pose


def _foot(px: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The nearest point of segment a-b to each point px (all (..., 2))."""
    ab = b - a
    t = torch.sum((px - a) * ab, dim=-1) / torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-12)
    return a + torch.clamp(t, 0.0, 1.0)[..., None] * ab


def make_scene(scene_cfg: dict, img_res, max_verts: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The per-view tables the training step reads (``rgb``, ``intrinsics``,
    ``pose``, ``mask``, ``labels``, ``uv_proj``, ``lines``, ``verts2d``,
    ``verts_mask``, ``support_idx``, ``support_count``), made on the device.

    Each view: a camera at ``camera.distance`` from the origin looking at
    it, at a uniform azimuth and an elevation within +-60 degrees, with
    ``camera.focal`` px; ``valid_verts`` junctions uniform in the image;
    ``lines_per_view`` segments each between two distinct junctions, with a
    score uniform in [0.05, 1]; uniform colours. Support ``"all"``: every
    pixel, attracted to a uniform line. Support ``{"pixels_per_view": S,
    "band_px": d}``: S pixels each drawn on a uniform line within d px of
    it (with repeats, as the loader's padded table). A support pixel's
    ``uv_proj`` is its foot on its line; the other pixels' tables stay 0.
    Every seed gets the same counts and sizes."""
    h, w = int(img_res[0]), int(img_res[1])
    hw = h * w
    n_views, n_lines, n_verts = scene_cfg["views"], scene_cfg["lines_per_view"], scene_cfg["valid_verts"]
    cam = scene_cfg["camera"]
    gen = _generator(seed, 2, device)
    kw = dict(generator=gen, device=device)

    az = torch.rand(n_views, **kw) * (2 * math.pi)
    el = (torch.rand(n_views, **kw) * 2.0 - 1.0) * (math.pi / 3)
    centres = cam["distance"] * torch.stack([torch.cos(el) * torch.cos(az), torch.cos(el) * torch.sin(az),
                                              torch.sin(el)], dim=-1)
    k = torch.eye(4, device=device)
    k[0, 0] = k[1, 1] = float(cam["focal"])
    k[0, 2], k[1, 2] = w / 2.0, h / 2.0

    size = torch.tensor([w, h], dtype=torch.float32, device=device)
    verts2d = torch.zeros((n_views, max_verts, 2), device=device)
    verts2d[:, :n_verts] = torch.rand((n_views, n_verts, 2), **kw) * size
    verts_mask = torch.zeros((n_views, max_verts), dtype=torch.bool, device=device)
    verts_mask[:, :n_verts] = True
    i0 = torch.randint(0, n_verts, (n_views, n_lines), **kw)
    i1 = (i0 + 1 + torch.randint(0, n_verts - 1, (n_views, n_lines), **kw)) % n_verts
    vi = torch.arange(n_views, device=device)[:, None]
    lines = torch.cat([verts2d[vi, i0], verts2d[vi, i1], 0.05 + 0.95 * torch.rand((n_views, n_lines, 1), **kw)],
                      dim=-1)

    rgb = torch.rand((n_views, hw, 3), **kw)
    labels = torch.zeros((n_views, hw), dtype=torch.int32, device=device)
    uv_proj = torch.zeros((n_views, hw, 2), device=device)
    mask = torch.zeros((n_views, hw), dtype=torch.bool, device=device)
    support = scene_cfg["support"]
    if support == "all":
        count = hw
        support_idx = torch.arange(hw, dtype=torch.int32, device=device).repeat(n_views, 1)
        labels = torch.randint(0, n_lines, (n_views, hw), **kw).to(torch.int32)
        pix = torch.arange(hw, device=device)
        px = torch.stack([(pix % w).float(), (pix // w).float()], dim=-1)
        for v in range(n_views):  # a view at a time: the feet take (HW, 2) floats each
            seg = lines[v, labels[v].long()]
            uv_proj[v] = _foot(px, seg[:, 0:2], seg[:, 2:4])
        mask[:] = True
    else:
        count = int(support["pixels_per_view"])
        band = float(support["band_px"])
        lab = torch.randint(0, n_lines, (n_views, count), **kw)
        t = torch.rand((n_views, count), **kw)
        off = (torch.rand((n_views, count), **kw) * 2.0 - 1.0) * band
        seg = lines[vi, lab]
        a, b = seg[..., 0:2], seg[..., 2:4]
        d = b - a
        normal = torch.stack([-d[..., 1], d[..., 0]], dim=-1) / torch.clamp(
            torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-6)
        p = a + t[..., None] * d + off[..., None] * normal
        x = torch.clamp(torch.round(p[..., 0]), 0, w - 1).long()
        y = torch.clamp(torch.round(p[..., 1]), 0, h - 1).long()
        support_idx = (y * w + x).to(torch.int32)
        feet = _foot(torch.stack([x.float(), y.float()], dim=-1), a, b)
        # a pixel drawn twice keeps its last draw's line, the same on every run
        entry = torch.arange(count, device=device).expand(n_views, count)
        last = torch.full((n_views, hw), -1, dtype=torch.long, device=device).scatter_reduce(
            1, support_idx.long(), entry, reduce="amax", include_self=True)
        for v in range(n_views):
            hit = torch.nonzero(last[v] >= 0)[:, 0]
            src = last[v, hit]
            labels[v, hit] = lab[v, src].to(torch.int32)
            uv_proj[v, hit] = feet[v, src]
            mask[v, hit] = True
    return {
        "rgb": rgb,
        "intrinsics": k.repeat(n_views, 1, 1),
        "pose": _look_at(centres),
        "mask": mask,
        "labels": labels,
        "uv_proj": uv_proj,
        "lines": lines,
        "verts2d": verts2d,
        "verts_mask": verts_mask,
        "support_idx": support_idx,
        "support_count": torch.full((n_views,), count, dtype=torch.int32, device=device),
    }
