"""The toy recipe (scripts/run-abc-toy.sh) on the card, and its training
curve: abc-neat-a (confs/abc-neat-a.conf) trained through the training
CLI's ``main`` on a generated cuboid scene (512 x 512, seed 0).

``train_toy`` is the training both this tool and ``chip_smoke.py``'s toy
phase run. This tool adds a checkpoint every ``--every`` epochs and scores
each as scripts/run-abc-toy.sh scores the last one: finalize with the
reference recipe and ``--vote-ratio 0.2`` over all views, eval_abc on its
wireframe, and view 0 rendered for its PSNR. One line a checkpoint: steps,
the mean training loss and PSNR of the epoch before it, view 0's PSNR,
junctions, lines3d_wfi_checked, eval_abc's precision and recall at 1/2/5%
of the scene's scale; a JSON report, toy_curve_<label>.json, in ``--out``.

Run from a checkout's root on a machine with a CUDA card and nvcc:

    python3 -m neat_tpu_torch.tools.toy_curve --epochs 333 --every 20 [--field_path xla] [--label NAME]

``--field_path xla`` trains on the plain field path (no K2), the same
scene, weights and draws; the f32 K1 and K3-fwd still run the scoring.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import os.path as osp
import time

import numpy as np
import torch

CONF = osp.join("confs", "abc-neat-a.conf")
VIEWS = 24  # chip_smoke.py's TOY_VIEWS
RENDER_CHUNK = 8192  # rays a chunk of view 0's render (the CLI's 1,024 gives the same rays, slower)


def make_scene(data_root: str, views: int, conf: str = CONF) -> str:
    """The generated cuboid (8 junctions, 12 lines) of ``views`` views at
    the conf's resolution, seed 0, under the conf's data_dir; -> its
    directory."""
    from ..data.synthetic import generate_scene
    from ..train.config import load_experiment_config

    cfg = load_experiment_config(conf)
    scene_dir = osp.join(data_root, cfg.data_dir)
    generate_scene(scene_dir, n_views=views, res=tuple(cfg.img_res), seed=0)
    return scene_dir


def train_toy(data_root: str, exps: str, epochs: int, seed=None, field_path=None, every=None, wrap_step=None,
              conf: str = CONF):
    """``conf`` through the training CLI's main, --nepoch ``epochs`` (and
    ``--seed``, ``--field_path`` where given), a checkpoint every ``every``
    epochs where given (else the conf's). Each step goes through
    ``wrap_step(step_fn)`` where given; its loss and PSNR are kept on the
    device. -> (the runner, the steps' (loss, PSNR) as an (N, 2) array)."""
    from ..train import runner as R

    metrics = []
    orig_run = R.TrainRunner.run

    def run(self):
        if every is not None:
            self.cfg = dataclasses.replace(self.cfg, checkpoint_freq=every)
        step_fn = wrap_step(self.step_fn) if wrap_step is not None else self.step_fn

        def kept(state, scene, gen):
            state, aux = step_fn(state, scene, gen)
            metrics.append(torch.stack([aux["loss"].detach().float(), aux["psnr"].detach().float()]))
            return state, aux

        self.step_fn = kept
        return orig_run(self)

    argv = ["--conf", conf, "--data_root", data_root, "--exps_folder", exps, "--nepoch", str(epochs)]
    argv += ["--seed", str(seed)] if seed is not None else []
    argv += ["--field_path", field_path] if field_path is not None else []
    R.TrainRunner.run = run
    try:
        runner = R.main(argv)
    finally:
        R.TrainRunner.run = orig_run
    return runner, torch.stack(metrics).cpu().numpy()


def distilled_stats(rundir: str, tag: str) -> dict:
    """What the distillation cache of a checkpoint holds before the gates:
    its lines, those under the 0.01 line-score gate, the latents voted for
    and the most votes one took."""
    import pickle

    (path,) = glob.glob(osp.join(rundir, "wireframes", f"{tag}-*-distill.pkl"))
    with open(path, "rb") as f:
        d = pickle.load(f)
    votes = np.bincount(d["votes_idx"]) if d["votes_idx"].size else np.zeros(1, np.int64)
    return {"raw_lines": int(d["scores_raw"].shape[0]), "raw_under_gate": int((d["scores_raw"] < 0.01).sum()),
            "score_median": float(np.median(d["scores_raw"])) if d["scores_raw"].size else None,
            "voted_latents": int((votes > 0).sum()), "max_votes": int(votes.max())}


def score_checkpoint(rundir: str, tag: str, data_root: str, scene) -> dict:
    """finalize (reference recipe, --vote-ratio 0.2), eval_abc and view 0's
    PSNR of one checkpoint of a rundir."""
    from ..evaluation.eval_abc import eval_abc
    from ..evaluation.render_eval import render_views_psnr
    from ..train.checkpoint import load_model
    from ..train.config import load_experiment_config
    from ..wireframe.finalize import wireframe_recon

    conf = osp.join(rundir, "runconf.conf")
    cfg = load_experiment_config(conf)
    t0 = time.perf_counter()
    res = wireframe_recon(conf, checkpoint=tag, vote_ratio=0.2, data_root=data_root, verbose=False)
    finalize_s = time.perf_counter() - t0
    (pkl,) = glob.glob(osp.join(rundir, "wireframes", f"{tag}-*-neat.pkl"))
    ev = eval_abc(pkl, osp.join(data_root, cfg.data_dir), verbose=False)
    model, _ = load_model(osp.join(rundir, "checkpoints"), tag, cfg.model)
    t0 = time.perf_counter()
    psnr = render_views_psnr(model, cfg.model, scene, views=[0], chunksize=RENDER_CHUNK)["psnr_mean"]
    return {"junctions": int(res["junctions3d_initial"].shape[0]), "lines_all": int(res["lines3d_all"].shape[0]),
            "lines_wfi": int(res["lines3d_wfi"].shape[0]),
            "lines_wfi_checked": int(res["lines3d_wfi_checked"].shape[0]),
            "psnr_view0": psnr, "eval_abc": ev, **distilled_stats(rundir, tag),
            "finalize_s": finalize_s, "render_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    from ..data.datasets import load_scene_for_config
    from ..ops import _build
    from ..train.checkpoint import load_checkpoint

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=333, help="the runner's --nepoch")
    ap.add_argument("--every", type=int, default=20, help="a checkpoint every this many epochs")
    ap.add_argument("--field_path", default=None, choices=["xla", "stash"])
    ap.add_argument("--label", default=None, help="the run's name (default: the field path)")
    ap.add_argument("--out", default=osp.join("build", "toy_curve"))
    args = ap.parse_args(argv)
    label = args.label or (args.field_path or "kernels")
    if not torch.cuda.is_available():
        raise SystemExit("toy_curve: no CUDA device")
    _build.build_all(_build.SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False

    data_root = osp.join(args.out, "data")
    if not osp.exists(osp.join(data_root, "abc", "00075213", "lines.json")):
        make_scene(data_root, VIEWS)
    t0 = time.perf_counter()
    runner, per_step = train_toy(data_root, osp.join(args.out, "exps", label), args.epochs,
                                 field_path=args.field_path, every=args.every)
    train_s = time.perf_counter() - t0
    print(f"toy_curve {label}: {len(per_step)} steps in {train_s:.1f} s ({1e3 * train_s / len(per_step):.2f} "
          f"ms/step), loss {per_step[0, 0]:.4f} -> {per_step[-1, 0]:.4f}", flush=True)
    finite = bool(np.isfinite(per_step).all())

    scene = load_scene_for_config(runner.cfg, data_root)
    ckpt = runner.ckpt_dir
    tags = sorted((n[:-5] for n in os.listdir(ckpt) if n.endswith(".ckpt") and n != "latest.ckpt"), key=int)
    rows = []
    for tag in tags:
        steps = int(load_checkpoint(ckpt, tag)[0]["step"])
        if steps == 0:
            continue
        window = per_step[max(0, steps - VIEWS):steps]
        row = {"epoch": int(tag), "steps": steps, "train_loss": float(window[:, 0].mean()),
               "train_psnr": float(window[:, 1].mean())}
        row.update(score_checkpoint(runner.rundir, tag, data_root, scene))
        e = row["eval_abc"]
        print(f"toy_curve {label} steps {steps}: loss {row['train_loss']:.4f}, train PSNR {row['train_psnr']:.2f}, "
              f"view 0 PSNR {row['psnr_view0']:.3f}; {row['junctions']} junctions, {row['lines_wfi']} wfi, "
              f"{row['lines_wfi_checked']} wfi_checked ({row['raw_under_gate']} of {row['raw_lines']} lines under the "
              f"score gate, median score {row['score_median']}, {row['voted_latents']} latents voted, at most "
              f"{row['max_votes']} votes); junction P/R "
              + " ".join(f"{v:.3f}" for v in e["junction_precision"] + e["junction_recall"]) + ", line P/R "
              + " ".join(f"{v:.3f}" for v in e["line_precision"] + e["line_recall"])
              + f" at {e['thresholds']}; finalize {row['finalize_s']:.1f} s, render {row['render_s']:.1f} s",
              flush=True)
        rows.append(row)
    report = {"label": label, "field_path": args.field_path, "views": VIEWS, "epochs": args.epochs,
              "every": args.every, "train_s": train_s, "steps": int(len(per_step)),
              "ms_per_step": 1e3 * train_s / len(per_step), "finite": finite,
              "loss": per_step[:, 0].tolist(), "psnr": per_step[:, 1].tolist(), "checkpoints": rows,
              "device": torch.cuda.get_device_name(0)}
    with open(osp.join(args.out, f"toy_curve_{label}.json"), "w") as f:
        json.dump(report, f)
    if not finite:
        raise SystemExit(f"toy_curve {label}: a non-finite loss or PSNR")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
