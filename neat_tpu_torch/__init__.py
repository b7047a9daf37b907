"""neat_tpu_torch: the PyTorch + CUDA port of neat_tpu for one NVIDIA H100.

The package mirrors ``neat_tpu``'s subpackages and function names so each
module's counterpart is easy to find. It imports ``torch`` and never
``jax`` or ``neat_tpu``; only the tests under ``tests/test_torch_*.py``
import both packages, to hold the port against the JAX reference.

The three Pallas kernels on the training step's path are hand-written CUDA
C++ for ``sm_90a`` (``csrc/``), built with ``nvcc`` on first use into
``build/kernels/`` and bound through ``ctypes``:

  * ``ops/fused_sdf.py``          the sampler's fused SDF MLP (K1);
  * ``ops/fused_field_stash.py``  the main field pass forward with its
                                  residual stash (K2-fwd) and the backward
                                  that replays it (K2-bwd).

Each wrapper launches its kernel for a CUDA tensor and runs the plain
PyTorch version of the same math only for a CPU tensor (what the CPU tests
use); there is no fallback from one to the other.

Entry points take an explicit ``device`` (default ``"cuda"``) and every
random draw an explicit ``torch.Generator``.
"""
