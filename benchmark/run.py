"""Run one cell of the benchmark of neat_tpu_torch's training step once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error repeat the checks. Without a card, or
with JAX or the JAX package loaded, it exits with an error and prints no
result. What a cell is made of is found by name: ``BENCHMARK.json``,
``benchmark/configs``, ``mixes``, ``limits`` and ``metrics``.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]
# The bytecode of every module a run imports (PyTorch's own some two
# thousand, several seconds to compile) is kept at a fixed path in the
# checkout, so that only the checkout's first run compiles it.
sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
sys.dont_write_bytecode = False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from harness import imports

    found = imports.forbidden_loaded()
    if found:
        print(f"loaded before the run: {found}", file=sys.stderr)
        return 3
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 2
    from harness.cell import run_cell

    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    found = imports.forbidden_loaded()
    if found:
        print(f"loaded by the run: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
