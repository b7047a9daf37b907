"""The harness: the manifest against the contract, cells found by name in
files added without an edit, the result line's keys, the work
arithmetic, the import check, and no result without a card."""

import json
import math
import os
import re
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_keeps_the_contract():
    from harness import manifest

    man = _manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"] and man["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= man["run_seconds"] <= 51
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
    names = {c["name"] for c in man["configs"]}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in names and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH, "mixes", f"{w['traffic']}.json"))
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        mod = manifest.load_reader(ROOT, m)  # declarations equal to the manifest's
        assert layers.setdefault(mod.LAYER.split(" (")[0], mod.LAYER) == mod.LAYER
    for w in man["workloads"]:
        cell = manifest.load_cell(ROOT, w["name"])
        assert cell.per_layer and cell.limits, w["name"]


def test_a_cell_added_as_files_runs_and_prints_the_contract(tmp_path):
    """A configuration, a mix, a limits file and a per-layer metric added as
    new files are found by their names; a run on the CPU reads the new
    metric and the result has the contract's keys, the checks last."""
    from harness import manifest
    from harness.cell import run_cell

    root = tiny_root(tmp_path, limits={"loss": 1.0, "grad": 10.0, "change": 10.0})
    (root / "benchmark" / "metrics" / "steps_in_window.train.py").write_text(
        'LAYER = "step driver (train/step.py)"\nUNIT = "count"\nSOURCE = "host_clock"\n'
        'MOVES = "train_rays_per_sec"\n\n\ndef read(ctx):\n    return ctx["window_steps"]\n')
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "steps_in_window.train", "unit": "count", "better": "higher",
                             "source": "host_clock", "layer": "step driver (train/step.py)",
                             "moves": "train_rays_per_sec", "workloads": ["tiny-abc.r32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    cell = manifest.load_cell(str(root), "tiny-abc.r32")
    assert cell.mix["rays_per_step"] == 32 and cell.config["scene"]["views"] == 2 and cell.limits["loss"] == 1.0
    assert "steps_in_window.train" in {m["name"] for m in cell.per_layer}
    assert "steps_in_window.train" not in {m["name"] for m in manifest.load_cell(str(root), "tiny-dtu.r32").per_layer}

    for traced in (False, True):
        res = run_cell(str(root), "tiny-abc.r32", 2**31 + 11, 0.5, traced, device="cpu", require_card=False)
        assert list(res)[-1] == "checks"
        assert set(res) == {"correct", "attempted", "failed", "metrics", "device", "checks"} | (
            {"breakdown"} if traced else set())
        assert res["attempted"] >= 1 and res["failed"] == 0 and res["correct"] is True
        assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
        if traced:
            # a CPU run reads no device metric: the new count, a span and a counter
            assert set(res["metrics"]) == {"steps_in_window.train", "sampler_host_ms.train", "auction_rounds_per_step"}
            assert res["metrics"]["steps_in_window.train"]["value"] == res["attempted"]
        else:
            assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_work_reproduces_the_kernel_bounds():
    """PERF.md's kernel table: K1 bf16 at 131,072 points 0.122 ms (by its
    operations), the K2 pass's operations at 100,352 points 0.309 ms
    forward and 0.710 ms backward."""
    from harness import work

    model = json.load(open(os.path.join(BENCH, "configs", "abc-neat-a.json")))["model"]
    t, by = work.bound_s(2.0 * work.k1_macs(model) * 131072, work.k1_bytes(model, 131072))
    assert by == "operations" and round(t * 1e3, 3) == 0.122
    fwd, bwd = work.k2_macs(model)
    assert round(2.0 * fwd * 100352 / work.PEAK_FLOPS * 1e3, 3) == 0.309
    assert round(2.0 * bwd * 100352 / work.PEAK_FLOPS * 1e3, 3) == 0.710
    # a step at 8192 rays: about 13.0 TFLOP, most in the field pass
    flops = work.step_flops(model, 8192)
    assert math.isclose(sum(flops.values()), 13.0e12, rel_tol=0.01) and max(flops, key=flops.get) == "field"


def test_kernel_functions_by_name():
    from harness import trace

    assert trace.kernel_function("(anonymous namespace)::field_bwd_mma(float const*, float*)") == "field_bwd_mma"
    assert trace.kernel_function("void field_fwd_mma<true>(float const*, float*)") == "field_fwd_mma"
    assert trace.kernel_function("bias_reduce(float const*, float*, int)") == "bias_reduce"
    assert trace.kernel_function("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
                                 "at::native::MaxOps<float>, unsigned int> >(at::native::ReduceOp<float>)") == \
        "reduce_kernel"


@pytest.mark.parametrize("name", [m["name"] for m in _manifest()["per_layer"] if m["source"] == "device_trace"]
                         + ["mfu.train"])
def test_a_slice_that_dropped_launches_reads_nothing(name):
    """Where no traced slice showed every hand-kernel launch the harness
    hands no device trace: a reader of it reads nothing, never a number."""
    from harness import manifest, work

    mod = manifest.load_reader(ROOT, next(m for m in _manifest()["per_layer"] if m["name"] == name))
    model = json.load(open(os.path.join(BENCH, "configs", "abc-neat-a.json")))["model"]
    ctx = {"n_rays": 8192, "model": model, "work": work, "trace": None, "host_spans_s": {"sampler": 0.1},
           "trace_steps": 3, "host_step_s": 0.25, "window_steps": 100, "dbscan_iterations": 0,
           "auction_rounds": 0}
    assert manifest.read_metric(mod, ctx) is None


def test_import_check_names():
    from harness import imports

    assert imports.forbidden_loaded(["neat_tpu_torch", "neat_tpu_torch.ops", "numpy", "jaxtyping"]) == []
    assert imports.forbidden_loaded(["neat_tpu.model", "jax", "jaxlib.xla", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "neat_tpu"]
    assert imports.reference_violations(os.path.join(BENCH, "reference")) == []


def test_import_check_catches_a_reference_import(tmp_path):
    from harness import imports

    (tmp_path / "ref.py").write_text("import torch\nfrom neat_tpu_torch.model import neat\n")
    assert imports.reference_violations(str(tmp_path)) == ["ref.py: neat_tpu_torch"]


def test_nothing_run_loads_jax_and_the_reference_loads_no_program():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from reference import neat_ref\n"
        "from harness import imports\n"
        "ref = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'neat_tpu', "
        "'neat_tpu_torch'})\n"
        "from harness import cell, faults\n"
        "import neat_tpu_torch.train.step, neat_tpu_torch.train.config, neat_tpu_torch.model.neat\n"
        "import neat_tpu_torch.ops.work, neat_tpu_torch.ops.fused_field_stash, neat_tpu_torch.ops.fused_sdf\n"
        "print(ref, imports.forbidden_loaded())\n" % (BENCH, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[] []"


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", "abc-neat-a.r8192",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_without_the_program_a_run_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark: no result."""
    import shutil

    from harness.cell import run_cell

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    with pytest.raises((ImportError, OSError)):
        run_cell(str(tmp_path), "abc-neat-a.r8192", 1, 1.0, False, device="cpu", require_card=False)
