"""The benchmark's own tests: the harness and the reference at tiny sizes
on the CPU; the tests marked ``cuda`` need the card and skip without one.

    python -m pytest benchmark/tests -q
"""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_root(tmp_path, field_dtype: str = "bfloat16", limits=None):
    """A checkout in ``tmp_path`` with the benchmark, the program (linked)
    and two tiny cells, ``tiny-abc.r32`` and ``tiny-dtu.r32``: the
    configurations' networks at 32 rays a step on a 2-view 64 x 48 scene.
    With ``field_dtype`` float32 the confs run the field pass and the
    sampler in float32. ``limits``: the check's limits of both cells."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "neat_tpu_torch"), root / "neat_tpu_torch")
    (root / "confs").mkdir()
    man = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    for src in ("abc-neat-a", "dtu"):
        name = "tiny-" + src.split("-")[0]
        conf = open(os.path.join(ROOT, "confs", f"{src}.conf")).read()
        conf = conf.replace("img_res = [512, 512]", "img_res = [48, 64]").replace("img_res = [1200, 1600]",
                                                                                  "img_res = [48, 64]")
        conf = conf.replace("field_compute_dtype = bfloat16",
                            f"field_compute_dtype = {field_dtype}\n    sampler_compute_dtype = {field_dtype}")
        (root / "confs" / f"{name}.conf").write_text(conf)
        cfg = json.loads(open(os.path.join(BENCH, "configs", f"{src}.json")).read())
        cfg["conf"] = f"confs/{name}.conf"
        cfg["model"]["field_compute_dtype"] = cfg["model"]["sampler_compute_dtype"] = field_dtype
        cfg["scene"].update(img_res=[48, 64], views=2)
        cfg["scene"]["camera"]["focal"] = 60.0
        if isinstance(cfg["scene"]["support"], dict):
            cfg["scene"]["support"]["pixels_per_view"] = 500
        (root / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        man["configs"].append({"name": name, "source": "https://arxiv.org/abs/2307.10206",
                               "file": f"benchmark/configs/{name}.json", "reduced": []})
        man["workloads"].append({"name": f"{name}.r32", "config": name, "traffic": "r32", "chips": 1,
                                 "why": "a test cell"})
        if limits is not None:
            (root / "benchmark" / "limits" / f"{name}.r32.json").write_text(json.dumps({"limits": limits}))
    (root / "benchmark" / "mixes" / "r32.json").write_text(json.dumps({"rays_per_step": 32}))
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root
