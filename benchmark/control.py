"""The readings that the check's limits are set from, for one cell at its
own size: in one process, for each seed, the program's first three steps
(sound, and with each planted fault) and the control (the reference in
the precision below the configuration's: fp8 products in the field pass
and the sampler, TF32 elsewhere), each compared with the float32
reference as a benchmark run compares them.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \\
        [--control_seeds 1 2 3] [--faults half_batch altered gathered means] [--out <file>]

Prints one JSON line a reading and, last, the largest sound reading and
the smallest control and fault reading of each number. The benchmark's own
runs never run this.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]

NUMBERS = ("loss", "loss1", "rgb_loss", "eikonal_loss", "line_loss", "j3d_loss", "j2d_loss", "grad", "grad_median",
           "change", "change_median", "junctions", "proposals", "depths", "k1", "field_sdf", "field_grad", "field_rgb",
           "field_lines")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control_seeds", type=int, nargs="*", default=None)
    p.add_argument("--faults", nargs="*", default=["half_batch", "altered"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from harness import cell as C
    from harness import check, faults, manifest
    from reference import neat_ref

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = manifest.load_cell(ROOT, args.workload)
    control_seeds = args.seeds[:3] if args.control_seeds is None else args.control_seeds
    rows, step = [], None

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        run = C.prepare(ROOT, cell, seed, device, step)
        step = run.step
        state, prog, records = C.first_steps(run, seed, device)
        del state
        emit(dict(C.checked_numbers(run, seed, prog, records), kind="sound", seed=seed, losses=prog[0]))
        for name in args.faults:
            run.state = C.program.build_state(run.model_cfg, run.weights, device)
            with faults.FAULTS[name]():
                _, bad, bad_records = C.first_steps(run, seed, device)
            emit(dict(C.checked_numbers(run, seed, bad, bad_records), kind=name, seed=seed, losses=bad[0]))
        if seed in control_seeds:
            # the control in the program's place: its own decisions, followed
            # by the float32 reference
            ctl_records, ctl_stages = [], {}
            ctl_losses, ctl_g1, ctl_p3 = C.reference_steps(run, seed, prec=neat_ref.CONTROL, record=ctl_records,
                                                           stages=ctl_stages)
            ctl_records[0].update(k1=ctl_stages["k1"], field=ctl_stages["field"])
            moment1 = {k: g * (1.0 - check.B1) for k, g in ctl_g1.items()}
            numbers = C.checked_numbers(run, seed, (ctl_losses, moment1, ctl_p3), ctl_records)
            emit(dict(numbers, kind="control", seed=seed, losses=ctl_losses))
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()

    summary = {"workload": args.workload, "sound_max": {}, "lowest": {}}
    for k in NUMBERS:
        if not all(k in r for r in rows):
            continue
        summary["sound_max"][k] = max(r[k] for r in rows if r["kind"] == "sound")
        for kind in {r["kind"] for r in rows} - {"sound"}:
            summary["lowest"].setdefault(kind, {})[k] = min(r[k] for r in rows if r["kind"] == kind)
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
