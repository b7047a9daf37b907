"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, the
configuration file it names, its traffic mix (``mixes/<traffic>.json``),
its limits (``limits/<cell>.json``) and the reader of each per-layer
metric (``metrics/<metric>.py``). A new configuration, mix, limit or
metric is a new file; no code names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, Optional


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file, plus its "name" and "file"
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]  # the cell's per-layer metrics


def load_manifest(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str, bench_dir: str = "benchmark") -> Cell:
    """The cell ``name`` of the manifest at ``root``; KeyError where the
    manifest has none."""
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    conf_entry = {c["name"]: c for c in man["configs"]}[w["config"]]
    with open(os.path.join(root, conf_entry["file"])) as f:
        config = dict(json.load(f), name=conf_entry["name"], file=conf_entry["file"])
    with open(os.path.join(root, bench_dir, "mixes", f"{w['traffic']}.json")) as f:
        mix = json.load(f)
    limits_path = os.path.join(root, bench_dir, "limits", f"{name}.json")
    limits = {}
    if os.path.exists(limits_path):
        with open(limits_path) as f:
            limits = {k: float(v) for k, v in json.load(f)["limits"].items()}
    return Cell(
        name=name, chips=int(w["chips"]), config=config, mix=mix, limits=limits,
        end_to_end=[m for m in man["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in man["per_layer"] if _applies(m, name)],
    )


def load_reader(root: str, metric: dict, bench_dir: str = "benchmark"):
    """The reader module of a per-layer metric, ``metrics/<name>.py``; its
    declared layer, unit, source and ``moves`` must be the manifest's."""
    path = os.path.join(root, bench_dir, "metrics", f"{metric['name']}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric['name'].replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key in ("layer", "unit", "source", "moves"):
        if getattr(mod, key.upper()) != metric[key]:
            raise ValueError(f"metrics/{metric['name']}.py declares {key} {getattr(mod, key.upper())!r}, "
                             f"BENCHMARK.json {metric[key]!r}")
    return mod


def read_metric(mod, ctx) -> Optional[float]:
    value = mod.read(ctx)
    return None if value is None else float(value)
