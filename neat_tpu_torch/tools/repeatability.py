"""Are the bf16 main path's training steps bit for bit repeatable on the card?

Runs the bench step (``utils/benchscene.py``: abc-neat-a at full width,
the main path's kernels) from the same seed several times in one process
and records, for every step, the inputs and outputs of each kernel
wrapper (K1, K2-fwd, K2-bwd), every output of the forward and every
gradient. Each run is compared with the first and with the second: the
first recorded tensor that differs (its step, and how many entries by
how much), the first step whose loss differs, the largest parameter
difference. Before the last two runs the caching allocator's free memory
is filled with NaN, then with 0, so that a read of memory no one wrote
would show; the last run runs under ``torch.use_deterministic_algorithms``
(warn only), which names any op PyTorch knows to be nondeterministic.
With ``--warm``, one small matmul and its backward run before the first
run.

``--nodes`` runs the first step twice instead, with a hook on every node
of the loss's autograd graph (the eikonal double backward's nodes
included): it names the first node, in the order the backward runs them,
whose incoming gradients are the same in both runs and whose outgoing ones
are not, with the shapes, strides and addresses (mod 1024) of the tensors
it saved in each run (or, where the backward ran the nodes in another
order, the nodes there with their sequence numbers, which order the
engine's ready queue); and the process-wide precision and algorithm flags
before and after each run.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 -m neat_tpu_torch.tools.repeatability [--steps 3] [--warm] [--nodes]
"""

from __future__ import annotations

import argparse
import warnings

import torch


def _flat(xs):
    for x in xs:
        if torch.is_tensor(x):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _flat(x)


def _recorder(record):
    """Wrap the kernel wrappers, the forward and Adam so that every call
    appends (name, {tensor name: a copy}) to ``record``; returns the undo."""
    import neat_tpu_torch.ops.fused_field_stash as FF
    import neat_tpu_torch.ops.fused_sdf as FS
    import neat_tpu_torch.train.step as ST

    undo = []

    def wrap(mod, name, keep):
        f = getattr(mod, name)

        def w(*a, **k):
            out = f(*a, **k)
            record.append((name, keep(a, out)))
            return out

        w.launches = getattr(f, "launches", 0)  # the kernel wrappers count on their module's name
        setattr(mod, name, w)
        undo.append((mod, name, f))

    def io(a, out):
        ins = {f"in{i}": x.detach().clone() for i, x in enumerate(_flat(a))}
        outs = {f"out{i}": x.detach().clone() for i, x in enumerate(_flat(out if isinstance(out, tuple) else (out,)))}
        return {**ins, **outs}

    wrap(FS, "fused_sdf_kernel", io)
    wrap(FF, "field_fwd_stash_kernel", io)
    wrap(FF, "field_bwd_stash_kernel", io)
    wrap(ST, "neat_forward", lambda a, out: {k: v.detach().clone() for k, v in out.items() if torch.is_tensor(v)})
    wrap(ST, "adam_update", lambda a, out: {n: g.detach().clone() for (n, _), g in
                                            zip(a[0].model.named_parameters(), a[1])})
    return lambda: [setattr(m, n, f) for m, n, f in undo]


def flags() -> dict:
    """The process-wide switches that choose a CUDA op's precision or
    algorithm."""
    b = torch.backends
    return {
        "matmul.allow_tf32": b.cuda.matmul.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "fp16_reduced_reduction": b.cuda.matmul.allow_fp16_reduced_precision_reduction,
        "bf16_reduced_reduction": b.cuda.matmul.allow_bf16_reduced_precision_reduction,
        "blas_library": str(b.cuda.preferred_blas_library()),
        "linalg_library": str(b.cuda.preferred_linalg_library()),
        "cudnn.allow_tf32": b.cudnn.allow_tf32,
        "cudnn.benchmark": b.cudnn.benchmark,
        "deterministic": torch.are_deterministic_algorithms_enabled(),
    }


def _saved(fn) -> str:
    """The tensors a node saved: shape, strides, address mod 1024."""
    out = []
    for name in dir(fn):
        if name.startswith("_saved_"):
            try:
                x = getattr(fn, name)
            except RuntimeError:
                continue
            if torch.is_tensor(x):
                out.append(f"{name[7:]} {tuple(x.shape)}/{x.stride()}@{x.data_ptr() % 1024}")
    return ", ".join(out)


def hook_graph(loss, record) -> None:
    """A hook on every node of ``loss``'s graph appending (node name, what it
    saved, its outgoing gradients, its incoming ones) as the backward runs."""
    seen, todo = set(), [loss.grad_fn]
    copy = lambda gs: [None if g is None else g.detach().clone() for g in gs]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        desc = _saved(fn)
        name = f"{fn.name()}#{fn._sequence_nr()}"  # the number the engine orders ready nodes by
        fn.register_hook(lambda gi, go, name=name, desc=desc: record.append((name, desc, copy(gi), copy(go))))
        todo.extend(f for f, _ in fn.next_functions)


def _same(xs, ys) -> bool:
    return all((x is None and y is None) or (x is not None and y is not None and torch.equal(x, y))
               for x, y in zip(xs, ys))


def first_node(a, b) -> str:
    """The first node whose incoming gradients agree and outgoing do not."""
    kind = lambda r: r[0].split("#")[0]
    na, nb = [r[0] for r in a], [r[0] for r in b]
    if [kind(r) for r in a] != [kind(r) for r in b]:
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if kind(x) != kind(y)), min(len(na), len(nb)))
        return (f"the two graphs differ: {len(na)} and {len(nb)} nodes, from node {i}: "
                f"{na[max(i - 2, 0):i + 4]} and {nb[max(i - 2, 0):i + 4]}")
    for i, ((name, da, gia, goa), (_, db, gib, gob)) in enumerate(zip(a, b)):
        if _same(goa, gob) and not _same(gia, gib):
            diffs = [f"{int((x != y).sum())} of {x.numel()} entries, at most {float((x.double() - y.double()).abs().max()):.3g}"
                     for x, y in zip(gia, gib) if x is not None and y is not None and not torch.equal(x, y)]
            return (f"node {i} of {len(a)}, {name}: outgoing {diffs}; incoming shapes "
                    f"{[None if g is None else tuple(g.shape) for g in goa]}; saved in run 1: {da}; in run 2: {db}")
    return "none"


def nodes(cfg, scene) -> None:
    """``--nodes``: the first step, twice, every node of its graph hooked."""
    import neat_tpu_torch.train.step as ST
    from neat_tpu_torch.utils.benchscene import bench_step

    runs = []
    for _ in range(2):
        before = flags()
        record = []
        loss_fn = ST.neat_loss

        def hooked(out, gt, lcfg):
            losses = loss_fn(out, gt, lcfg)
            hook_graph(losses["loss"], record)
            return losses

        ST.neat_loss = hooked
        try:
            step, state = bench_step(cfg, device="cuda")
            step(state, scene, torch.Generator(device="cuda").manual_seed(0))
        finally:
            ST.neat_loss = loss_fn
        torch.cuda.synchronize()
        print(f"flags before run {len(runs) + 1}: {before}; after: {flags()}", flush=True)
        runs.append(record)
    print(f"nodes: {len(runs[0])}; the first node whose outgoing gradients differ with its incoming ones equal: "
          f"{first_node(*runs)}", flush=True)


def _first_difference(a, b) -> str:
    step = -1
    for (ka, da), (kb, db) in zip(a, b):
        if ka == "step":
            step += 1
            continue
        for key, x in da.items():
            y = db[key]
            if x.shape != y.shape:
                return f"step {step}, {ka} {key}: shapes {tuple(x.shape)} and {tuple(y.shape)}"
            if not torch.equal(x, y):
                d = (x.double() - y.double()).abs()
                return (f"step {step}, {ka} {key}: {int((d > 0).sum())} of {x.numel()} entries, at most "
                        f"{float(d.max()):.3g}")
    return "none"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warm", action="store_true", help="one small matmul and its backward before the first run")
    ap.add_argument("--nodes", action="store_true", help="hook every node of the first step's graph, two runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("repeatability: no CUDA device")
    from neat_tpu_torch.ops import _build
    from neat_tpu_torch.utils.benchscene import bench_config, bench_scene, bench_step

    _build.build_all(("fused_sdf", "field_fwd_mma", "fused_field_stash", "field_dw_mma", "field_bwd_mma"))
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = bench_config("bfloat16", device="cuda")
    scene = bench_scene(cfg, device="cuda")
    if args.warm:
        a = torch.randn(64, 32, device="cuda", requires_grad=True)
        (a @ torch.randn(32, 16, device="cuda")).sum().backward()
    if args.nodes:
        nodes(cfg, scene)
        return 0

    def run(fill=None, deterministic=False):
        if fill is not None:  # the allocator's free memory, written with fill
            torch.full((int(torch.cuda.mem_get_info()[0] * 0.6) // 4,), fill, device="cuda")
        record = []
        undo = _recorder(record)
        step, state = bench_step(cfg, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        losses = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            try:
                for _ in range(args.steps):
                    record.append(("step", {}))
                    state, metrics = step(state, scene, gen)
                    losses.append(metrics["loss"].detach())
            finally:
                torch.use_deterministic_algorithms(False)
                undo()
        torch.cuda.synchronize()
        params = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        named = sorted({str(w.message).splitlines()[0][:160] for w in caught})
        return torch.stack(losses).cpu(), params, record, named

    runs = {"first": run(), "second": run(), "third": run(), "NaN fill": run(fill=float("nan")),
            "0 fill": run(fill=0.0), "deterministic": run(deterministic=True)}
    names = list(runs)
    for base in names[:2]:
        for other in names[names.index(base) + 1:]:
            a, b = runs[base], runs[other]
            differ = (a[0] != b[0]).nonzero()
            step = int(differ[0, 0]) if len(differ) else None
            worst = max(float((a[1][k].double() - b[1][k].double()).abs().max()) for k in a[1])
            print(f"run {base!r} against run {other!r}: the first loss that differs at step {step}, the largest "
                  f"parameter difference {worst:.3g}; the first tensor that differs: "
                  f"{_first_difference(a[2], b[2])}", flush=True)
    print(f"ops named by use_deterministic_algorithms: {runs['deterministic'][3] or 'none'}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
