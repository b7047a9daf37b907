"""Experiment runtime on one device: directories, the config snapshot, the
epoch loop, the log, checkpoints and junction snapshots (port of
neat_tpu/train/runner.py, single device).

    python -m neat_tpu_torch.train.runner --conf confs/abc-neat-a.conf \\
        --data_root <dir holding abc/00075213> --exps_folder <dir> --nepoch N

The experiment directory is the JAX package's::

    <exps_folder>/<expname>[/<scan_id>]/<timestamp>/
        runconf.conf            frozen config snapshot
        train.log               the log, one line per epoch
        checkpoints/            full-state snapshots (checkpoint.py)
        junctions/{epoch}.npy   decoded global-junction point clouds
        plots/                  created empty: the plots are not ported

An epoch is one step per view (``nepoch`` N runs epochs 0 .. N). Each step
draws from a generator seeded by ``train/step.py:step_generator``.
Metrics stay on the device until the epoch's log line, one transfer an
epoch. ``--epoch_scan`` runs an epoch's steps through one
``make_train_multi_step`` call, on the same generators: the same bits as
the steps one by one. ``--debug_nans`` makes every step check its loss and
gradients (``utils/profiling.py``). ``--batch_size`` is accepted and
ignored, as in the JAX package: a step is one view's rays.

The runner runs on a CUDA device unless ``device="cpu"`` (``--device
cpu``) is asked for; with no CUDA device it raises. On the card the
canonical configuration takes the hand-written kernels through the model's
own dispatch: K1 for the sampler's proposals when
``sampler_compute_dtype`` is bf16, and the stashed field pass (K2) when
``field_compute_dtype`` is bf16; ``--field_path xla|recompute|stash``
overrides the field pass. f32 confs keep the plain path.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import os.path as osp
import signal
import sys
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from ..data.datasets import load_scene_for_config
from ..fields.mlp import global_junctions_forward
from ..model.neat import init_neat
from ..utils.profiling import enable_nan_debugging, nan_debugging_enabled
from .checkpoint import load_checkpoint, restore_state, save_checkpoint
from .config import dump_hocon, load_experiment_config
from .step import init_train_state, make_train_multi_step, make_train_step, scene_to_device, step_generator


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md §1, {item})")


class TrainRunner:
    def __init__(
        self,
        conf: str,
        data_root: str = "../data",
        exps_folder: str = "../exps",
        expname_suffix: str = "",
        scan_id: int = -1,
        nepochs: int = 2000,
        batch_rays: Optional[int] = None,
        is_continue: bool = False,
        timestamp: str = "latest",
        checkpoint: str = "latest",
        max_verts: int = 512,
        assignment_method: str = "auction",
        seed: int = 42,
        log_every_epochs: int = 1,
        use_tb: bool = False,
        use_mesh: bool = False,
        do_vis: bool = False,
        gitexp: bool = False,
        field_dtype: Optional[str] = None,
        field_path: Optional[str] = None,
        epoch_scan: bool = False,
        device="cuda",
    ):
        for asked, what, item in (
            (use_mesh, "the data-parallel mesh (--mesh)", "multi-GPU"),
            (use_tb, "TensorBoard logging (--use_tb)", "periphery"),
            (do_vis, "preview plots (--do_vis)", "periphery"),
            (gitexp, "--gitexp", "periphery"),
        ):
            if asked:
                raise _unported(what, item)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the runner trains on the card; pass --device cpu for the CPU")
        self.cfg = load_experiment_config(
            conf,
            scan_id=scan_id,
            nepochs=nepochs,
            max_verts=max_verts,
            assignment_method=assignment_method,
        )
        if field_dtype is not None:
            self._set_model(field_compute_dtype=field_dtype)
        if field_path is not None:
            self._set_model(
                use_pallas_field=field_path != "xla",
                pallas_field_backward=field_path if field_path != "xla" else "recompute",
            )
        self.expname = self.cfg.expname + expname_suffix
        if self.cfg.scan_id != -1:
            self.expname = f"{self.expname}/{self.cfg.scan_id}"
        self.seed = seed
        self.epoch_scan = epoch_scan
        self.log_every_epochs = log_every_epochs

        # ----- experiment directories
        self.expdir = osp.join(exps_folder, self.expname)
        os.makedirs(self.expdir, exist_ok=True)
        old_timestamp = None
        if is_continue and timestamp == "latest":
            stamps = sorted(d for d in os.listdir(self.expdir) if osp.isdir(osp.join(self.expdir, d)))
            old_timestamp = stamps[-1] if stamps else None
        elif is_continue:
            old_timestamp = timestamp

        self.timestamp = "{:%Y_%m_%d_%H_%M_%S}".format(datetime.now())
        while osp.exists(osp.join(self.expdir, self.timestamp)):  # a run started within the same second
            time.sleep(0.05)
            self.timestamp = "{:%Y_%m_%d_%H_%M_%S}".format(datetime.now())
        self.rundir = osp.join(self.expdir, self.timestamp)
        self.ckpt_dir = osp.join(self.rundir, "checkpoints")
        self.junctions_dir = osp.join(self.rundir, "junctions")
        self.plots_dir = osp.join(self.rundir, "plots")
        for d in (self.rundir, self.ckpt_dir, self.junctions_dir, self.plots_dir):
            os.makedirs(d, exist_ok=True)
        if self.cfg.raw is not None:
            with open(osp.join(self.rundir, "runconf.conf"), "w") as f:
                f.write(dump_hocon(self.cfg.raw))

        self.logger = self._make_logger()

        # ----- data
        self.logger.info("Loading data ...")
        t0 = time.perf_counter()
        self.scene = load_scene_for_config(self.cfg, data_root)
        self.load_seconds = time.perf_counter() - t0
        self.n_views = self.scene.n_images
        self.logger.info(f"Data-set size: {self.n_views}")

        # BlendedMVS fixed-iteration rule
        if self.cfg.data_dir == "BlendedMVS":
            self.cfg = dataclasses.replace(self.cfg, nepochs=int(200000 / self.n_views))

        self.n_rays = batch_rays or self.cfg.num_pixels
        self.decay_steps = self.cfg.nepochs * self.n_views

        # ----- the kernels, for the canonical architecture on the card
        from ..ops.fused_field import supports_fused_field
        from ..ops.fused_sdf import supports_fused_sdf

        m = self.cfg.model
        on_card = self.device.type == "cuda" and m.model_variant == "neat"
        if on_card and supports_fused_sdf(m.implicit) and m.sampler_compute_dtype == "bfloat16":
            self._set_model(use_pallas_sampler=True)
            self.logger.info("fused-SDF sampler kernel (K1) enabled")
        if (
            field_path is None
            and on_card
            and not m.use_pallas_field
            and m.field_compute_dtype == "bfloat16"
            and supports_fused_field(m.implicit, m.rendering, m.attraction)
        ):
            self._set_model(use_pallas_field=True, pallas_field_backward="stash")
            self.logger.info("stashed-backward field kernels (K2) enabled")

        # ----- model/optimizer state
        self.state = init_train_state(init_neat(self.cfg.model, seed=seed, device=self.device))
        self.start_epoch = 0
        if old_timestamp is not None:
            old_ckpt = osp.join(self.expdir, old_timestamp, "checkpoints")
            try:
                host, self.start_epoch = load_checkpoint(old_ckpt, checkpoint)
            except (FileNotFoundError, RuntimeError) as e:
                # a run killed before its first save leaves a rundir with
                # no loadable snapshot: an unattended resume starts fresh
                self.logger.warning(
                    f"resume requested but no loadable checkpoint in {old_ckpt} ({e}); starting from scratch"
                )
            else:
                restore_state(self.state, host)
                self.logger.info(
                    f"Resumed epoch {self.start_epoch} from {old_ckpt} "
                    "(params + optimizer + schedule restored exactly)"
                )

        self.scene_dev = scene_to_device(self.scene, self.device)
        self.step_fn = (make_train_multi_step if epoch_scan else make_train_step)(
            self.cfg.model,
            self.cfg.loss,
            self.cfg.learning_rate,
            self.cfg.sched_decay_rate,
            self.decay_steps,
            self.n_rays,
            self.scene.img_res[1],
        )

    # ------------------------------------------------------------------
    def _set_model(self, **changes) -> None:
        self.cfg = dataclasses.replace(self.cfg, model=dataclasses.replace(self.cfg.model, **changes))

    def _make_logger(self):
        # a logger of its own, outside logging's registry: two runners in one
        # process (a test, a resume) never share or clear each other's handlers
        logger = logging.Logger(f"train.{self.timestamp}", logging.DEBUG)
        fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
        fh = logging.FileHandler(osp.join(self.rundir, "train.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
        return logger

    def close(self) -> None:
        """Close the log file."""
        for h in list(self.logger.handlers):
            self.logger.removeHandler(h)
            h.close()

    # ------------------------------------------------------------------
    def save(self, epoch: int) -> None:
        save_checkpoint(self.ckpt_dir, self.state, epoch)

    @torch.no_grad()
    def dump_junctions(self, epoch: int) -> None:
        """The decoded global junctions as junctions/{epoch}.npy; nothing for
        a model without a junction head (the vanilla VolSDF network)."""
        if self.state.model.junctions is None:
            return
        pts = global_junctions_forward(self.state.model.junctions, self.cfg.model.junctions)
        np.save(osp.join(self.junctions_dir, f"{epoch}.npy"), pts.cpu().numpy())

    def run(self) -> None:
        """Train; a checkpoint is written on exit, KeyboardInterrupt and
        SIGTERM included, so a crash and resume loses at most the epoch in
        flight."""

        # SIGTERM must unwind through the finally below; the default
        # handler would skip it
        def _on_term(signum, frame):
            raise SystemExit(128 + signum)

        prev_handler = None
        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:  # not the main thread: keep the default
            pass

        # _run_epochs updates _current_epoch as it goes, so an interrupt
        # saves the epoch training had reached, not start_epoch
        self._current_epoch = self.start_epoch
        try:
            self._current_epoch = self._run_epochs()
        finally:
            try:
                epoch = self._current_epoch
                self.save(epoch)
                self.dump_junctions(epoch)
            finally:
                if prev_handler is not None:
                    signal.signal(signal.SIGTERM, prev_handler)
        self.logger.info(f"Training finished after {epoch} epochs")

    def _run_epochs(self) -> int:
        self.logger.info("training...")
        cfg = self.cfg
        epoch = self.start_epoch
        for epoch in range(self.start_epoch, cfg.nepochs + 1):
            self._current_epoch = epoch
            if epoch % cfg.checkpoint_freq == 0:
                self.save(epoch)
            self.dump_junctions(epoch)

            t0 = time.time()
            # a generator per step, a function of the step count each has
            # when it runs: the same in both modes
            gens = [
                step_generator(self.seed, epoch - self.start_epoch, self.state.step + i, self.device)
                for i in range(self.n_views)
            ]
            if self.epoch_scan:
                self.state, stacked = self.step_fn(self.state, self.scene_dev, gens)
            else:
                metrics = []
                for gen in gens:
                    self.state, aux = self.step_fn(self.state, self.scene_dev, gen)
                    metrics.append(aux)
                stacked = {k: torch.stack([a[k] for a in metrics]) for k in metrics[0]}

            if epoch % self.log_every_epochs == 0:
                # one transfer for the whole epoch's metrics
                keys = sorted(stacked)
                means = torch.stack([stacked[k].mean() for k in keys]).tolist()
                msg = " ".join(f"{k} = {v:.4f}" for k, v in zip(keys, means))
                rays_s = self.n_views * self.n_rays / max(time.time() - t0, 1e-9)
                self.logger.info(f"{self.expname} [{epoch}/{cfg.nepochs}]: {msg} ({rays_s:,.0f} rays/s)")
        return epoch


def main(argv=None) -> TrainRunner:
    parser = argparse.ArgumentParser(description="neat_tpu_torch trainer (one device)")
    parser.add_argument("--conf", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=1,
                        help="views per step: accepted and ignored, as in the JAX trainer (a step is one view)")
    parser.add_argument("--nepoch", type=int, default=2000)
    parser.add_argument("--expname", type=str, default="")
    parser.add_argument("--scan_id", type=int, default=-1)
    parser.add_argument("--exps_folder", type=str, default="../exps")
    parser.add_argument("--data_root", type=str, default="../data")
    parser.add_argument("--is_continue", default=False, action="store_true")
    parser.add_argument("--timestamp", default="latest", type=str)
    parser.add_argument("--checkpoint", default="latest", type=str)
    parser.add_argument("--assignment", default="auction", choices=["auction", "callback"],
                        help="junction assignment: the auction on the device, or scipy's Hungarian on the host")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--epoch_scan", default=False, action="store_true",
                        help="run each epoch's steps through one multi-step call (the same bits as one by one)")
    parser.add_argument("--field_dtype", default=None, choices=["float32", "bfloat16"],
                        help="override model.field_compute_dtype (precision of the main field pass)")
    parser.add_argument("--field_path", default=None, choices=["xla", "recompute", "stash"],
                        help="main field pass: the plain PyTorch path (the JAX package's name, 'xla'), "
                        "K3 with its recomputing backward, or K2 with its stashed backward")
    parser.add_argument("--debug_nans", default=False, action="store_true",
                        help="check every step's loss and gradients and raise FloatingPointError where one "
                        "is not finite (one host sync a step)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a CUDA device) or 'cpu'")
    # the JAX trainer's flags whose modules are not ported: each raises
    parser.add_argument("--use_tb", default=False, action="store_true")
    parser.add_argument("--mesh", default=False, action="store_true")
    parser.add_argument("--distributed", default=False, action="store_true")
    parser.add_argument("--do_vis", default=False, action="store_true")
    parser.add_argument("--gitexp", default=False, action="store_true")
    for flag, kind in (("--parallel_mode", str), ("--platform", str), ("--coordinator", str),
                       ("--num_processes", int), ("--process_id", int)):
        parser.add_argument(flag, default=None, type=kind)
    args = parser.parse_args(argv)
    if args.distributed:
        raise _unported("--distributed", "multi-GPU")
    for flag in ("parallel_mode", "platform", "coordinator", "num_processes", "process_id"):
        if getattr(args, flag) is not None:
            raise _unported(f"--{flag}", "multi-GPU")

    runner = TrainRunner(
        conf=args.conf,
        data_root=args.data_root,
        exps_folder=args.exps_folder,
        expname_suffix=args.expname,
        scan_id=args.scan_id,
        nepochs=args.nepoch,
        is_continue=args.is_continue,
        timestamp=args.timestamp,
        checkpoint=args.checkpoint,
        assignment_method=args.assignment,
        seed=args.seed,
        use_tb=args.use_tb,
        use_mesh=args.mesh,
        do_vis=args.do_vis,
        gitexp=args.gitexp,
        field_dtype=args.field_dtype,
        field_path=args.field_path,
        epoch_scan=args.epoch_scan,
        device=args.device,
    )
    previous = enable_nan_debugging(args.debug_nans or nan_debugging_enabled())
    try:
        runner.run()
    finally:
        runner.close()
        enable_nan_debugging(previous)
    return runner


if __name__ == "__main__":
    main()
