"""Write the trained weights of tests/test_torch_finalize_trained.py.

Run from the repository root (the JAX package on the CPU; about 75
minutes on 8 cores):

    python tests/data/finalize_trained/make_fixture.py

The JAX package's training CLI (``neat_tpu.train.runner``, ``--platform
cpu``, its default ``--seed 42``) trains the narrow model of
``runconf.conf`` beside this file (a 9-layer, 64-wide SDF with the skip at
layer 4; 5-layer, 64-wide idr heads; 16 global junctions; 512 rays a step;
a checkpoint every 25 epochs) with ``--nepoch 600`` (7,212 steps) on the
scene the test generates: ``neat_tpu_torch.data.synthetic.generate_scene``
of a cuboid (8 junctions, 12 lines), 12 views of 256 x 256, seed 0. Then
the JAX package's finalize CLI runs on each checkpoint in turn as the test
runs it (the reference recipe, ``--vote-ratio 0.2``), and ``params.npz``
is the first checkpoint whose wireframe has junctions and
visibility-checked lines, as the JAX package exports it
(``ModelParameters``: the parameter tree's key strings, f32 arrays),
compressed. The committed file is the checkpoint of epoch 500 (6,000
steps): 2 junctions, 1 checked line. 64 x 64 views do not get there: a
pixel spans 0.026 scene units at the cameras' distance, and the 0.01
line-score gate averages surface points within a pixel of a line.
"""

import glob
import os
import pickle
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from neat_tpu_torch.data.synthetic import generate_scene  # noqa: E402

SCENE = dict(n_views=12, res=(256, 256), seed=0)
DATA_DIR = os.path.join("abc", "00075213")  # runconf.conf's dataset.data_dir
EPOCHS = 600  # the runner's --nepoch; the LR decays over its steps
EVERY = 25  # runconf.conf's train.checkpoint_freq


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import neat_tpu.train.runner as runner
    import neat_tpu.wireframe.finalize as finalize

    work = tempfile.mkdtemp(prefix="finalize_trained_")
    # the CLI's XLA compile cache goes with the rest
    os.environ["NEAT_TPU_COMPILE_CACHE"] = os.path.join(work, "xla_cache")
    try:
        data_root, exps = os.path.join(work, "data"), os.path.join(work, "exps")
        generate_scene(os.path.join(data_root, DATA_DIR), **SCENE)
        runner.main(["--conf", os.path.join(HERE, "runconf.conf"), "--data_root", data_root, "--exps_folder", exps,
                     "--nepoch", str(EPOCHS), "--platform", "cpu"])
        (rundir,) = [os.path.join(exps, "fin", d) for d in os.listdir(os.path.join(exps, "fin"))]
        for epoch in range(EVERY, EPOCHS + 1, EVERY):
            finalize.main(["--conf", os.path.join(rundir, "runconf.conf"), "--checkpoint", str(epoch),
                           "--data_root", data_root, "--vote-ratio", "0.2"])
            (pkl,) = glob.glob(os.path.join(rundir, "wireframes", f"{epoch}-*-neat.pkl"))
            with open(pkl, "rb") as f:
                res = pickle.load(f)
            n_j, n_l = res["junctions3d_initial"].shape[0], res["lines3d_wfi_checked"].shape[0]
            print(f"epoch {epoch}: {n_j} junctions, {n_l} wfi_checked lines", flush=True)
            if n_j > 0 and n_l > 0:
                path = os.path.join(rundir, "checkpoints", "ModelParameters", f"{epoch}.npz")
                with np.load(path) as z:
                    np.savez_compressed(os.path.join(HERE, "params.npz"), **{k: z[k] for k in z.files})
                print(f"params.npz: the checkpoint of epoch {epoch}")
                return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("no checkpoint's wireframe has junctions and checked lines; params.npz left as it was")
    return 1


if __name__ == "__main__":
    sys.exit(main())
