"""neat_tpu_torch: the PyTorch + CUDA port of neat_tpu for one NVIDIA H100.

The package mirrors ``neat_tpu``'s subpackages and function names so each
module's counterpart is easy to find. It imports ``torch`` and never
``jax`` or ``neat_tpu``; only the tests under ``tests/test_torch_*.py``
import both packages, to hold the port against the JAX reference.

The entry point is the training CLI, which trains a scene from disk:

    python -m neat_tpu_torch.train.runner --conf confs/abc-neat-a.conf \\
        --data_root <dir> --exps_folder <dir> --nepoch N

(``train/runner.py``: the conf parser ``train/config.py``, the scene
loader ``data/``, checkpoints ``train/checkpoint.py``, the step
``train/step.py``.) ``utils/benchscene.py`` sets up the same step on a
random scene for timing.

Every Pallas kernel of the JAX package is hand-written CUDA C++ for
``sm_90a`` (``csrc/*.cu``), built with ``nvcc`` on first use into
``build/kernels/`` and bound through ``ctypes``:

  * ``ops/fused_sdf.py``          K1, the sampler's fused SDF MLP
                                  (``fused_sdf.cu``);
  * ``ops/fused_field_stash.py``  K2-fwd, the main field pass forward with
                                  its residual stash (``field_fwd_mma.cu``
                                  in bf16), and K2-bwd, which replays it:
                                  in bf16 a row-local pass
                                  (``field_bwd_mma.cu``) and a
                                  weight-gradient GEMM (``ops/field_dw.py``,
                                  ``field_dw_mma.cu``); in f32 the scalar
                                  ``fused_field_stash.cu``;
  * ``ops/fused_field.py``        K3-fwd and K3-bwd, the residual-free
                                  forward and the backward that recomputes
                                  it (bf16: K2's split backward chunk by
                                  chunk; f32: ``fused_field.cu``);
  * ``ops/fused_round.py``        K4, one error-bounded sampler round
                                  (``fused_round.cu``, opt-in).

A training step of the canonical configuration on the card launches K1
five times, K2-fwd, the row-local pass and the GEMM once each; the DBSCAN
confs (the per-scan ABC confs, dtu.conf, bmvs.conf) also cluster the
step's line endpoints on the device in plain tensor operations
(``assignment/clustering.py``). Each
wrapper launches its kernel for a CUDA tensor and runs the plain PyTorch
version of the same math only for a CPU tensor (what the CPU tests use);
there is no fallback from one to the other.

The reference's other model classes (the vanilla VolSDF network, the
uniform sampler, the wfr, dual and along-ray families) are flags of
``model/neat.py``; on the card they take K1 and K2 where their heads are
the kernels' (``train/runner.py``).

``csrc/encodels.cpp``, the attraction-field rasterizer that packs a
scene, and ``csrc/jpeg.cpp``, the baseline JPEG decoder of the views
(``data/jpeg.py``), are host code, built with ``g++`` into
``build/host/``.

Entry points take an explicit ``device`` (default ``"cuda"``) and every
random draw an explicit ``torch.Generator``.
"""
