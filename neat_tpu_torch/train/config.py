"""Config system: HOCON-compatible parsing + conf -> dataclass translation
(port of neat_tpu/train/config.py, no JAX).

The confs name their model, loss and data set by the reference's class
paths. This module parses the conf dialect with its own parser (pyhocon is
not needed) and translates the class paths and block names into this
package's config dataclasses, so every conf under ``confs/`` resolves to
the same values as in the JAX package, every reference model class
(the ablation variants) to the flags the model runs.

Supported dialect (everything the reference confs use):
  nested blocks ``name { ... }`` (brace may follow on the next line),
  ``key = value``, comments (# and //), lists, numbers, booleans,
  bare/quoted strings.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

from ..fields.mlp import (
    GlobalJunctionsConfig,
    ImplicitNetConfig,
    RenderNetConfig,
)
from ..model.loss import LossConfig
from ..model.neat import NeatConfig
from ..sampling.samplers import ErrorBoundSamplerConfig


# ---------------------------------------------------------------------------
# HOCON subset parser
# ---------------------------------------------------------------------------


def _strip_comment(line: str) -> str:
    out = []
    in_str = False
    i = 0
    while i < len(line):
        c = line[i]
        if c == '"':
            in_str = not in_str
        if not in_str:
            if c == "#" or line[i : i + 2] == "//":
                break
        out.append(c)
        i += 1
    return "".join(out)


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith("[") and tok.endswith("]"):
        inner = tok[1:-1].strip()
        if not inner:
            return []
        return [_parse_value(t) for t in inner.split(",")]
    if tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    low = tok.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    try:
        if re.fullmatch(r"[+-]?\d+", tok):
            return int(tok)
        return float(tok)
    except ValueError:
        return tok


def parse_hocon(text: str) -> Dict[str, Any]:
    """Parse the conf dialect into nested dicts."""
    root: Dict[str, Any] = {}
    stack: List[Dict[str, Any]] = [root]
    pending_key: Optional[str] = None

    lines = text.splitlines()
    for raw in lines:
        line = _strip_comment(raw).strip()
        if not line:
            continue
        while line:
            if pending_key is not None:
                if line.startswith("{"):
                    new: Dict[str, Any] = {}
                    stack[-1][pending_key] = new
                    stack.append(new)
                    pending_key = None
                    line = line[1:].strip()
                    continue
                # a bare token must be a block header whose '{' opens the
                # next line; anything else is a malformed conf — fail loudly
                # rather than silently dropping this line
                raise ValueError(
                    f"bare key {pending_key!r} not followed by a block; "
                    f"offending line: {raw!r}"
                )
            m = re.match(r"^([A-Za-z0-9_.\-]+)\s*\{", line)
            if m:
                new = {}
                stack[-1][m.group(1)] = new
                stack.append(new)
                line = line[m.end():].strip()
                continue
            if line.startswith("}"):
                if len(stack) > 1:
                    stack.pop()
                line = line[1:].strip()
                continue
            # value stops at an unquoted '}' so inline blocks parse:
            # params_init { beta = 0.1 }
            m = re.match(r"^([A-Za-z0-9_.\-]+)\s*[=:]\s*([^}]*)", line)
            if m:
                stack[-1][m.group(1)] = _parse_value(m.group(2))
                line = line[m.end():].strip()
                continue
            m = re.match(r"^([A-Za-z0-9_.\-]+)\s*$", line)
            if m:
                # block header whose '{' is on the next line
                pending_key = m.group(1)
                line = ""
                continue
            raise ValueError(f"cannot parse conf line: {raw!r}")
    return root


def get_path(conf: Dict[str, Any], path: str, default=None):
    cur: Any = conf
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


def put_path(conf: Dict[str, Any], path: str, value) -> None:
    parts = path.split(".")
    cur = conf
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


def dump_hocon(conf: Dict[str, Any], indent: int = 0) -> str:
    """Serialize back to the conf dialect (runconf.conf snapshots)."""
    pad = "    " * indent
    out = []
    for k, v in conf.items():
        if isinstance(v, dict):
            out.append(f"{pad}{k}{{")
            out.append(dump_hocon(v, indent + 1))
            out.append(f"{pad}}}")
        elif isinstance(v, list):
            out.append(f"{pad}{k} = [{', '.join(str(x) for x in v)}]")
        elif isinstance(v, bool):
            out.append(f"{pad}{k} = {'True' if v else 'False'}")
        elif isinstance(v, str):
            out.append(f"{pad}{k} = {v}")
        else:
            out.append(f"{pad}{k} = {v}")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# reference class-path translation
# ---------------------------------------------------------------------------

# dataset_class -> (loader kind, needs scan_id)
_DATASET_CLASS_MAP = {
    "datasets.blender_hawp_dataset.BlenderDataset": "blender",
    "datasets.scene_hawp_dataset.SceneDataset": "dtu",
    "datasets.blender_dataset.BlenderDataset": "blender_plain",
    "datasets.scene_dataset.SceneDataset": "dtu_plain",
    # the reference file names its class SceneDataset like the DTU one
    # (scannet_hawp_dataset.py:16); accept both spellings
    "datasets.scannet_hawp_dataset.SceneDataset": "scannet",
    "datasets.scannet_hawp_dataset.ScanNetDataset": "scannet",
    "datasets.scene_line_dataset.SceneDataset": "scene_line",
    "datasets.scene_line_depth_dataset.SceneDataset": "scene_line",
}

# model_class -> variant flag overrides (the reference's ablation model
# family, SURVEY.md §2 C34, expressed as flags)
_MODEL_CLASS_MAP: Dict[str, Dict[str, Any]] = {
    "model.networks.neat_wfr_rend_a.VolSDFNetwork": {},
    # rend_show is rend_a's forward hacked into an interactive probe
    # (hardcoded GT-mesh trimesh scene + pdb mid-forward + matplotlib
    # overlays, rend_show:317-324,416-470). Upstream it returns only
    # {points, rgb_values, sdf, depth, xyz} and pdb's before the eikonal
    # block — it cannot train with any shipped loss; mapping it to full
    # rend_a behavior is a documented SUPERSET. The overlay itself is the
    # headless `neat_tpu.wireframe.debug_tools --mode show` CLI
    "model.networks.neat_wfr_rend_show.VolSDFNetwork": {},
    "model.networks.neat_wfr_rend.VolSDFNetwork": {"detach_line_weights": False},
    "model.networks.neat_wfr_rend_b.VolSDFNetwork": {"_attraction_mode": "no_view"},
    "model.networks.neat_wfr_rend_c.VolSDFNetwork": {"dbscan_include_global": True},
    # the wfr/wfr_a/simple family evaluates the attraction net ONCE at the
    # detached rendered surface point (neat_wfr.py:397-409) instead of the
    # rend family's per-sample weighted line integral
    "model.networks.neat_wfr.VolSDFNetwork": {
        "_attraction_mode": "no_view",
        "attraction_at_surface": True,
        "eval_attraction_at_l3d": True,  # neat_wfr.py:469-474
    },
    "model.networks.neat_wfr_a.VolSDFNetwork": {
        "_attraction_mode": "no_view",
        "attraction_at_surface": True,
        # wfr_a projects lines3d live into the uncalibrated loss (wfr_a:405)
        "detach_lines2d": False,
        # residual deviations (documented): wfr_a drops the MODEL-side
        # observed-vertex match/median gate (its loss re-matches and
        # median-WEIGHTS instead, loss_wfr_a.py:96-131) — here the gate
        # stays model-side; and wfr_a/simple use the naive x/x[-1]
        # perspective division where ours is sign-safe everywhere
    },
    "model.networks.neat_uni.VolSDFNetwork": {"sampler_kind": "uniform"},
    # simple upstream has NO global-junction head, no calib projection,
    # and pairs with no shipped loss (every junction-reading loss would
    # KeyError on it); the junction machinery stays active here as a
    # documented superset
    "model.networks.neat_simple.VolSDFNetwork": {
        "_attraction_mode": "no_view",
        "attraction_at_surface": True,
        "eval_attraction_at_l3d": True,  # neat_simple.py:359-363
        "detach_lines2d": False,  # simple:345 projects lines3d live
    },
    # dual's wireframe pass evaluates the attraction ONCE at the detached
    # surface point with detached no_view implicit outputs (dual:433, and
    # eval forward :563) — the wfr convention, not the rend per-sample
    # integral; its eval l3d re-eval is commented out (:627)
    "model.networks.neat_wfr_dual.VolSDFNetwork": {
        "dual_batch": True,
        "_attraction_mode": "no_view",
        "attraction_at_surface": True,
    },
    # along-ray family: per-sample no_view attraction whose endpoint
    # tracks are volume-rendered along their own camera-distance ordering
    # (neat_along_ray.py:329-359); v2 scores endpoints with a second SDF
    # net (neat_along_ray_v2.py:268,335-336). Neither has a conf or a
    # compatible shipped loss upstream (no junction outputs there); here
    # the junction head stays active as a documented superset
    "model.neat_along_ray.VolSDFNetwork": {
        "_attraction_mode": "no_view",
        "attraction_aggregation": "endpoint_render",
        "detach_lines2d": False,  # along_ray:365 projects lines3d live
    },
    "model.networks.neat_along_ray_v2.VolSDFNetwork": {
        "_attraction_mode": "no_view",
        "attraction_aggregation": "endpoint_render",
        "endpoint_sdf_separate": True,
        "detach_lines2d": False,  # along_ray_v2:368 projects lines3d live
    },
    "model.network.VolSDFNetwork": {"model_variant": "volsdf"},
}

_LOSS_CLASS_MAP: Dict[str, Dict[str, Any]] = {
    "model.networks.loss_wfr.VolSDFLoss": {},
    # wfr_a: uncalibrated line loss + 0.01-scaled j2d assignment cost
    # (loss_wfr_a.py:112). Its observed-vertex re-matching + median quality
    # gate is realized by the model-side verts2d assignment + median gate
    # this architecture always applies (j_local_mask); residual deviation:
    # the reference matches with an L1 metric, the model gate uses L2.
    "model.networks.loss_wfr_a.VolSDFLoss": {
        "calibrated_branch": False,
        "junction_cost_2d_scale": 0.01,
    },
    "model.networks.loss_wfr_spd.VolSDFLoss": {"depth_weight": 0.1},
    "model.networks.loss_wfr_rpd.VolSDFLoss": {
        "depth_weight": 0.1,
        "depth_loss_kind": "ssi",
    },
    # unnormalize: pixel-space line loss, 0.01 j2d cost scale, NaN->1e5
    # cost guard (the guard is unconditional in neat_loss)
    "model.networks.loss_wfr_unnormalize.VolSDFLoss": {
        "calibrated_branch": False,
        "junction_cost_2d_scale": 0.01,
        "junction_stat_gated": True,
    },
    # jc: pixel-space line loss (conf line_weight), p=2 j3d-only cost,
    # SQUARED-L2 pair loss at fixed 0.1 weight, no j2d term (loss_jc.py:
    # 66-77; the constructor takes no junction weights)
    "model.networks.loss_jc.VolSDFLoss": {
        "calibrated_branch": False,
        "junction_mode": "jc",
        "junction_3d_weight": 0.1,
        "junction_2d_weight": 0.0,
    },
    # ins: uncalibrated-only line loss, junction terms absent
    # (loss_ins.py:140-146 sums rgb + eikonal + line only). Its fourth
    # term — ins_weight * Hungarian CE+soft-IoU over
    # model_outputs['ins'] (loss_ins.py:16-72,133-138) — is dead
    # upstream: no reference model emits 'ins' and no conf instantiates
    # this loss (it would KeyError), so only the defined subset maps
    "model.networks.loss_ins.VolSDFLoss": {
        "calibrated_branch": False,
        "junction_3d_weight": 0.0,
        "junction_2d_weight": 0.0,
    },
    "model.loss.VolSDFLoss": {"line_weight": 0.0},
}


@dataclasses.dataclass
class ExperimentConfig:
    expname: str
    model: NeatConfig
    loss: LossConfig
    # training
    learning_rate: float = 5e-4
    sched_decay_rate: float = 0.1
    num_pixels: int = 1024
    checkpoint_freq: int = 100
    plot_freq: int = 100
    split_n_pixels: int = 1024
    nepochs: int = 2000
    # dataset
    dataset_kind: str = "blender"
    data_dir: str = ""
    img_res: Tuple[int, int] = (512, 512)
    scan_id: int = -1
    distance_threshold: float = 10.0
    line_detector: str = "hawp"
    depth_dir: Optional[str] = None
    # precomputed-3D-line conditioning (scene_line datasets)
    lines_npz: Optional[str] = None
    # plot block
    plot_nimgs: int = 1
    plot_resolution: int = 100
    grid_boundary: Tuple[float, float] = (-1.5, 1.5)
    # raw parsed conf for snapshots
    raw: Optional[Dict[str, Any]] = None


def _seq(v, default):
    if v is None:
        return default
    return tuple(v)


def build_experiment_config(
    conf: Dict[str, Any],
    scan_id: int = -1,
    nepochs: Optional[int] = None,
    max_verts: int = 512,
    assignment_method: str = "auction",
) -> ExperimentConfig:
    """Translate a parsed reference conf into dataclass configs."""
    m = conf.get("model", {})
    white_bkgd = bool(m.get("white_bkgd", False))
    scene_r = float(m.get("scene_bounding_sphere", 1.0))

    imp = m.get("implicit_network", {})
    implicit = ImplicitNetConfig(
        feature_vector_size=int(m.get("feature_vector_size", 256)),
        sdf_bounding_sphere=0.0 if white_bkgd else scene_r,
        d_in=int(imp.get("d_in", 3)),
        d_out=int(imp.get("d_out", 1)),
        dims=_seq(imp.get("dims"), (256,) * 8),
        geometric_init=bool(imp.get("geometric_init", True)),
        bias=float(imp.get("bias", 1.0)),
        skip_in=_seq(imp.get("skip_in"), ()),
        weight_norm=bool(imp.get("weight_norm", True)),
        multires=int(imp.get("multires", 0)),
        sphere_scale=float(imp.get("sphere_scale", 1.0)),
        inside_out=bool(imp.get("inside_out", False)),
    )
    ren = m.get("rendering_network", {})
    rendering = RenderNetConfig(
        feature_vector_size=int(m.get("feature_vector_size", 256)),
        mode=ren.get("mode", "idr"),
        d_in=int(ren.get("d_in", 9)),
        d_out=int(ren.get("d_out", 3)),
        dims=_seq(ren.get("dims"), (256,) * 4),
        weight_norm=bool(ren.get("weight_norm", True)),
        multires_view=int(ren.get("multires_view", 0)),
    )
    att = m.get("attraction_network", {})
    attraction = RenderNetConfig(
        feature_vector_size=int(m.get("feature_vector_size", 256)),
        mode=att.get("mode", "idr"),
        d_in=int(att.get("d_in", 9)),
        d_out=int(att.get("d_out", 6)),
        dims=_seq(att.get("dims"), (256,) * 4),
        weight_norm=bool(att.get("weight_norm", True)),
        multires_view=int(att.get("multires_view", 0)),
    )
    jun = m.get("global_junctions", {})
    junctions = GlobalJunctionsConfig(
        num_junctions=int(jun.get("num_junctions", 1024)),
        num_layers=int(jun.get("num_layers", 2)),
        dim_hidden=int(jun.get("dim_hidden", 256)),
        dim_out=int(jun.get("dim_out", 3)),
    )
    rs = m.get("ray_sampler", {})
    sampler = ErrorBoundSamplerConfig(
        scene_bounding_sphere=scene_r,
        near=float(rs.get("near", 0.0)),
        n_samples=int(rs.get("N_samples", 64)),
        n_samples_eval=int(rs.get("N_samples_eval", 128)),
        n_samples_extra=int(rs.get("N_samples_extra", 32)),
        eps=float(rs.get("eps", 0.1)),
        beta_iters=int(rs.get("beta_iters", 10)),
        max_total_iters=int(rs.get("max_total_iters", 5)),
        add_tiny=float(rs.get("add_tiny", 0.0)),
        beta_search=rs.get("beta_search", "bisect"),
        beta_grid_size=int(rs.get("beta_grid_size", 32)),
    )
    den = m.get("density", {})
    beta_init = float(den.get("params_init", {}).get("beta", 0.1))
    beta_min = float(den.get("beta_min", 1e-4))

    model_class = get_path(conf, "train.model_class", "")
    variant_overrides = dict(_MODEL_CLASS_MAP.get(model_class, {}))
    attraction_mode = variant_overrides.pop("_attraction_mode", None)
    if attraction_mode is not None:
        attraction = dataclasses.replace(attraction, mode=attraction_mode)
    if attraction.mode == "no_view" and attraction.d_in == 9:
        # no_view consumes [points, normals, feats] (rend_b:175-183) —
        # the reference sizes the net from an explicitly-reduced conf
        # d_in; a conf written at the idr width (d_in = 9) must shed the
        # 3 view dims or the first matmul width mismatches. Applies
        # whether the mode came from the class map or the conf itself
        attraction = dataclasses.replace(attraction, d_in=6)

    model = NeatConfig(
        feature_vector_size=int(m.get("feature_vector_size", 256)),
        scene_bounding_sphere=scene_r,
        white_bkgd=white_bkgd,
        bg_color=_seq(m.get("bg_color"), (1.0, 1.0, 1.0)),
        implicit=implicit,
        rendering=rendering,
        attraction=attraction,
        junctions=junctions,
        sampler=sampler,
        density_beta_init=beta_init,
        density_beta_min=beta_min,
        dbscan_enabled=bool(m.get("dbscan_enabled", True)),
        use_median=bool(m.get("use_median", False)),
        use_l3d=bool(m.get("use_l3d", False)),
        junction_eikonal=bool(m.get("junction_eikonal", False)),
        max_verts=max_verts,
        assignment_method=assignment_method,
        sampler_compute_dtype=str(m.get("sampler_compute_dtype", "bfloat16")),
        field_compute_dtype=str(m.get("field_compute_dtype", "float32")),
        **variant_overrides,
    )

    loss_class = get_path(conf, "train.loss_class", "")
    lc = conf.get("loss", {})
    rgb_loss_name = lc.get("rgb_loss", "torch.nn.L1Loss")
    # class-map structural defaults first, then every conf-provided key
    # wins — the reference instantiates the loss class with the conf's
    # loss block as kwargs, so conf values override class defaults there
    loss = dataclasses.replace(
        LossConfig(
            rgb_loss="l1" if "L1" in str(rgb_loss_name) else "mse",
            assignment_method=assignment_method,
        ),
        **_LOSS_CLASS_MAP.get(loss_class, {}),
    )
    conf_casts = {
        "eikonal_weight": float,
        "line_weight": float,
        "junction_3d_weight": float,
        "junction_2d_weight": float,
        "line_gate_px": float,
        "depth_weight": float,
        "depth_loss_kind": str,
    }
    loss = dataclasses.replace(
        loss, **{k: cast(lc[k]) for k, cast in conf_casts.items() if k in lc}
    )

    ds = conf.get("dataset", {})
    dataset_class = get_path(conf, "train.dataset_class", "")
    dataset_kind = _DATASET_CLASS_MAP.get(dataset_class, "blender")
    # scan ids are ints on DTU/BMVS but directory STRINGS on ScanNet
    # (scannet_hawp_dataset.py:21-28, default scan 0); keep non-numeric
    # ids verbatim
    raw_scan = scan_id if scan_id != -1 else ds.get("scan_id", -1)
    try:
        eff_scan = int(raw_scan)
    except (TypeError, ValueError):
        eff_scan = str(raw_scan)
    if eff_scan == -1 and dataset_kind == "scannet":
        eff_scan = 0

    pl = conf.get("plot", {})
    return ExperimentConfig(
        expname=get_path(conf, "train.expname", "exp"),
        model=model,
        loss=loss,
        learning_rate=float(get_path(conf, "train.learning_rate", 5e-4)),
        sched_decay_rate=float(get_path(conf, "train.sched_decay_rate", 0.1)),
        num_pixels=int(get_path(conf, "train.num_pixels", 1024)),
        checkpoint_freq=int(get_path(conf, "train.checkpoint_freq", 100)),
        plot_freq=int(get_path(conf, "train.plot_freq", 100)),
        split_n_pixels=int(get_path(conf, "train.split_n_pixels", 10000)),
        nepochs=nepochs if nepochs is not None else 2000,
        dataset_kind=dataset_kind,
        data_dir=ds.get("data_dir", ""),
        img_res=_seq(ds.get("img_res"), (512, 512)),
        scan_id=eff_scan,
        # per-kind reference defaults: 10 px for blender
        # (blender_hawp_dataset.py:23), 5 px for the DTU/BMVS/ScanNet/
        # scene-line families (scene_hawp_dataset.py:24 etc.) — dtu.conf /
        # bmvs.conf set none, so the default IS the flagship behavior
        distance_threshold=float(
            ds.get(
                "distance_threshold",
                10.0 if dataset_kind in ("blender", "blender_plain") else 5.0,
            )
        ),
        line_detector=ds.get("line_detector", "hawp"),
        depth_dir=ds.get("depth_dir"),
        lines_npz=ds.get("lines_npz"),
        plot_nimgs=int(pl.get("plot_nimgs", 1)),
        plot_resolution=int(pl.get("resolution", 100)),
        grid_boundary=_seq(pl.get("grid_boundary"), (-1.5, 1.5)),
        raw=conf,
    )


def load_experiment_config(path: str, **kwargs) -> ExperimentConfig:
    with open(path) as f:
        conf = parse_hocon(f.read())
    return build_experiment_config(conf, **kwargs)
