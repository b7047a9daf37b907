"""The system under test: ``neat_tpu_torch``'s training step, built the way
``train/runner.py`` builds it from the configuration's conf, with the
benchmark's weights in its parameters. The only program names the
benchmark reads are here, in ``trace.py`` (kernel names, counters) and in
the metric readers."""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List

import torch


def _mismatches(stated, parsed, path: str = ""):
    """``path: stated != parsed`` for each number the configuration file
    states that the conf, as the program parses it, does not give."""
    if isinstance(stated, dict):
        out = []
        for k, v in stated.items():
            out += _mismatches(v, parsed.get(k) if isinstance(parsed, dict) else None, f"{path}{k}.")
        return out
    if isinstance(stated, (list, tuple)):
        stated = list(stated)
        parsed = list(parsed) if isinstance(parsed, (list, tuple)) else parsed
    if isinstance(stated, float) and isinstance(parsed, (int, float)):
        same = math.isclose(stated, float(parsed), rel_tol=1e-12)
    else:
        same = stated == parsed
    return [] if same else [f"{path[:-1]}: the file states {stated!r}, the conf gives {parsed!r}"]


def load_experiment(config: dict, n_rays: int, repo_root: str):
    """The conf's ExperimentConfig as the runner loads it (its defaults:
    2000 epochs, 512 junction slots, the auction), held against every
    number the configuration file states; ``train.num_pixels`` is the
    mix's."""
    import os

    from neat_tpu_torch.train.config import load_experiment_config

    exp = load_experiment_config(os.path.join(repo_root, config["conf"]))
    parsed = dataclasses.asdict(exp)
    parsed.pop("raw")
    bad = _mismatches({k: config[k] for k in ("model", "loss", "train")}, {
        "model": parsed["model"], "loss": parsed["loss"], "train": parsed})
    bad += _mismatches({"img_res": config["scene"]["img_res"]}, parsed)
    if bad:
        raise ValueError("the conf and the configuration file disagree:\n  " + "\n  ".join(bad))
    return dataclasses.replace(exp, num_pixels=n_rays)


def build_step(exp, n_views: int, device):
    """(step, model config): ``make_train_step`` with the runner's
    arguments, on the kernel configuration the runner trains with."""
    from neat_tpu_torch.model.neat import train_kernel_config
    from neat_tpu_torch.train.step import make_train_step

    model_cfg = train_kernel_config(exp.model, device)
    step = make_train_step(model_cfg, exp.loss, exp.learning_rate, exp.sched_decay_rate, exp.nepochs * n_views,
                           exp.num_pixels, exp.img_res[1])
    return step, model_cfg


def build_state(model_cfg, weights: Dict[str, torch.Tensor], device):
    """The runner's ``init_train_state(init_neat(...))`` with every
    parameter set to the benchmark's weights."""
    from neat_tpu_torch.model.neat import init_neat
    from neat_tpu_torch.train.step import init_train_state

    model = init_neat(model_cfg, seed=0, device=device)
    names = dict(model.named_parameters())
    if set(names) != set(weights):
        raise ValueError(f"the program's parameters {sorted(set(names) ^ set(weights))} are not the benchmark's")
    with torch.no_grad():
        for name, p in names.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: the program's shape {tuple(p.shape)}, the benchmark's "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
    return init_train_state(model)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The runner's generator for a step of its first epoch."""
    from neat_tpu_torch.train.step import step_generator as gen

    return gen(seed, 0, step, device)


def params_of(state) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in state.model.named_parameters()}


def first_moment(state) -> Dict[str, torch.Tensor]:
    return {k: m.detach().clone() for (k, _), m in zip(state.model.named_parameters(), state.mu)}


def kernel_launches() -> Dict[str, int]:
    """The program's launch counter of each hand-written kernel."""
    from neat_tpu_torch.ops.work import launches

    return launches()


def counters() -> Dict[str, int]:
    """The program's counters the metrics read: DBSCAN's label iterations
    and the auction's rounds, since the process started."""
    from neat_tpu_torch.assignment.clustering import dbscan_cluster_means
    from neat_tpu_torch.assignment.matching import auction_assignment

    return {"dbscan_iterations": int(dbscan_cluster_means.iterations),
            "auction_rounds": int(auction_assignment.rounds)}


@contextlib.contextmanager
def recording(records: List[dict]):
    """While open, each training step appends to ``records`` what the check
    follows and checks, moved to the host: the sampler's depths (``z``,
    ``z_eik``); the junction stage's inputs and decisions: DBSCAN's
    endpoints, means and valid mask (where it clusters), the first assignment's
    cost, masks and answer, the gate (the second assignment's row mask),
    the detached line endpoints (``endpoints``), the matched local
    junctions (``j3d_local``, ``j2d_local_calib``), the
    second assignment's cost and answer; and in the first step K1's
    points and SDF at each proposal round (``k1``) and the field pass's
    points, directions and outputs (``field``: SDF, gradient, colour,
    lines). Only the steps the check follows run with it; the window does
    not."""
    import neat_tpu_torch.model.loss as L
    import neat_tpu_torch.model.neat as N
    import neat_tpu_torch.ops.fused_field_stash as K2
    import neat_tpu_torch.ops.fused_sdf as K1
    import neat_tpu_torch.train.step as S

    entry: dict = {}
    orig = (N.dbscan_cluster_means, N.masked_assignment, L.masked_assignment, N._sample_z, K1.fused_sdf_eval,
            K2.fused_field_eval_stash, S.neat_loss)
    host = lambda t: None if t is None else t.detach().to("cpu", copy=True)

    def sample_z(*args, **kwargs):
        z, z_eik = orig[3](*args, **kwargs)
        entry.update(z=host(z), z_eik=host(z_eik))
        return z, z_eik

    def k1(net, points, *args, **kwargs):
        sdf = orig[4](net, points, *args, **kwargs)
        if not records:  # the first step's proposal evaluations
            entry.setdefault("k1", []).append((host(points), host(sdf)))
        return sdf

    def loss(outputs, *args, **kwargs):
        if "j3d_local" in outputs:
            entry.update(endpoints=host(outputs["lines3d"].reshape(-1, 3)), j3d_local=host(outputs["j3d_local"]),
                         j2d_local_calib=host(outputs["j2d_local_calib"]))
        return orig[6](outputs, *args, **kwargs)

    def k2(model, points, dirs, *args, **kwargs):
        out = orig[5](model, points, dirs, *args, **kwargs)
        if not records:  # the first step's field pass
            entry["field"] = tuple(host(t) for t in (points, dirs, *out))
        return out

    def dbscan(points, *args, **kwargs):
        means, valid = orig[0](points, *args, **kwargs)
        entry.update(points=host(points), proposals=host(means), dbscan_valid=host(valid))
        return means, valid

    def assign1(cost, row_mask=None, col_mask=None, method="auction"):
        col, valid = orig[1](cost, row_mask, col_mask, method=method)
        entry.update(cost1=host(cost), rows1=host(row_mask), cols1=host(col_mask), col1=host(col),
                     valid1=host(valid))
        return col, valid

    def assign2(cost, row_mask=None, col_mask=None, method="auction"):
        col, valid = orig[2](cost, row_mask, col_mask, method=method)
        records.append(dict(entry, cost2=host(cost), keep=host(row_mask), col2=host(col), valid2=host(valid)))
        entry.clear()
        return col, valid

    (N.dbscan_cluster_means, N.masked_assignment, L.masked_assignment, N._sample_z, K1.fused_sdf_eval,
     K2.fused_field_eval_stash, S.neat_loss) = dbscan, assign1, assign2, sample_z, k1, k2, loss
    try:
        yield records
    finally:
        (N.dbscan_cluster_means, N.masked_assignment, L.masked_assignment, N._sample_z, K1.fused_sdf_eval,
         K2.fused_field_eval_stash, S.neat_loss) = orig
