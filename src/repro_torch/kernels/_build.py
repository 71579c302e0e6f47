"""Build and load the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds, not minutes).  Libraries go to ``build/`` at the repository
root, named by a hash of the source, the ``csrc/*.cuh`` headers it includes
and the flags, so an edited source or header rebuilds and an unchanged one
loads at once.  Nothing builds at import: the
first launch of a kernel builds it, or ``build`` / ``build_all`` do so
beforehand (``build_all`` runs one ``nvcc`` per source, all at once).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("conv2d_direct", "conv2d_wu", "conv2d_q8", "conv2d_streams",
           "flash_attention", "matmul_fused", "conv1d_causal", "moe_gmm",
           "conv2d_direct_whole", "conv2d_wu_whole", "conv2d_q8_whole",
           "pool2d", "flash_attention_bwd")

_loaded: dict[str, ctypes.CDLL] = {}

NO_BACKWARD = ("ROADMAP Queue 1 item 14: the K8 and K9 backward kernels, "
               "hybrid and MoE training on the card")


def no_grad_inputs(name: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and one of
    ``tensors`` (None entries are skipped) requires grad: the CUDA kernel
    ``name`` has no backward, and its output, written by the kernel, would
    carry no ``grad_fn``, so every gradient through it would be lost
    without a word.  Each CUDA wrapper without a backward calls this before
    it launches; K7's gradient is its backward kernel instead."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel, so on the card it refuses "
            f"inputs that require grad under grad mode (a gradient through "
            f"it would be lost silently): {NO_BACKWARD}")


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises when none exists."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.MULTILINE)


def _sources(path: Path, seen: list[Path]) -> list[Path]:
    """``path`` and every ``#include "*.cuh"`` it reaches under ``CSRC``,
    each once, in the order first met."""
    if path in seen:
        return seen
    seen.append(path)
    for header in _INCLUDE.findall(path.read_bytes()):
        _sources(CSRC / header.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source, every header
    of ``csrc`` it includes, and the flags."""
    digest = hashlib.sha256()
    for path in _sources(CSRC / f"{name}.cu", []):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=KERNELS) -> dict[str, float]:
    """Build every ``csrc/<name>.cu`` of ``names`` that is not built yet,
    one ``nvcc`` each, all started together.  The compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) goes to
    ``<library>.log``.  Returns each name's build seconds (0.0 when already
    built); raises with the log of the first build that fails, after every
    compiler has exited."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    seconds = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            seconds[name] = 0.0
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        with open(lib.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen(nvcc_command(name, tmp), stdout=log,
                                    stderr=subprocess.STDOUT)
        started[name] = (proc, tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in started.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, library_path(name))   # atomic: no reader sees half
        else:
            failed.append((name, rc))
    if failed:
        name, rc = failed[0]
        raise RuntimeError(f"kernel build failed: {name} (nvcc exit {rc}):\n"
                           + build_log(name))
    return seconds


def build(name: str) -> float:
    """Build ``csrc/<name>.cu`` unless it is built already; returns the
    build seconds (0.0 when already built)."""
    return build_all((name,))[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` ('' if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
