"""Build the CUDA sources in ``neat_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/kernels/lib<name>.so`` at the root
of the checkout, and loaded with ``ctypes``. A library is rebuilt when it is
missing or older than its own ``.cu`` or any header that source reaches
through ``#include "..."`` lines (followed from header to header), so an
edit to a header rebuilds only the sources that include it. ``build_all``
starts one ``nvcc`` per stale source, all at once, and waits for them.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fused_sdf", "fused_field_stash", "fused_field", "fused_round", "field_fwd_mma", "field_dw_mma",
           "field_bwd_mma", "fused_sdf_tf32", "field_fwd_tf32")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The round kernel's bisection decides on err <= eps: without fused
# multiply-adds each product and sum rounds as the plain version's own
# elementwise operations do. It holds no matrix product to lose by it.
EXTRA_FLAGS = {"fused_round": ("-fmad=false",)}

_LIBS: Dict[str, ctypes.CDLL] = {}  # loaded once per process


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _so_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def dependencies(source: Path) -> List[Path]:
    """``source`` and every file it reaches through ``#include "..."`` lines,
    each resolved beside the file that names it (system headers in ``<...>``
    are not followed). A quoted header that does not exist is left out: the
    compiler reports it."""
    source = Path(source)
    seen: List[Path] = []
    todo = [source]
    while todo:
        path = todo.pop()
        if path in seen or (path != source and not path.exists()):
            continue
        seen.append(path)
        todo.extend(path.parent / inc for inc in _INCLUDE.findall(path.read_text()))
    return seen


def _stale(name: str, csrc: Path = None, build_dir: Path = None) -> bool:
    """Whether ``lib<name>.so`` is missing or older than one of its sources."""
    so = (BUILD_DIR if build_dir is None else build_dir) / f"lib{name}.so"
    if not so.exists():
        return True
    deps = dependencies((CSRC if csrc is None else csrc) / f"{name}.cu")
    return so.stat().st_mtime < max(d.stat().st_mtime for d in deps)


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale source in parallel; raise with nvcc's output if
    one fails. Returns nvcc's output (the ptxas report of registers, shared
    memory and spills) for each library it built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    failed, logs = [], {}
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            # the error lines first: nvcc's full report is long
            errors = "\n".join(l for l in out.splitlines() if "error" in l)
            failed.append(f"nvcc failed for {name}.cu:\n{errors}\n--- full output ---\n{out}")
            continue
        os.replace(tmp, _so_path(name))  # atomic: no half-written library
        logs[name] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build_all((name,))
        _LIBS[name] = ctypes.CDLL(str(_so_path(name)))
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
