"""Build and load the port's CUDA kernels: nvcc into a plain-C shared
library per source, loaded with ctypes.

Each ``csrc/<name>.cu`` compiles for Hopper (``sm_90a``) at first use into
``geomesa_tpu_torch/_build/`` (listed in ``.gitignore``), under a file name
that carries a hash of the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source rebuilds and an unchanged one loads as is. Nothing builds at import time: this module
is imported on machines without ``nvcc``, where only the plain PyTorch
versions run.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Tuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")

# -fmad=false: no multiply-add contraction, so the f32 arithmetic rounds
# exactly as the plain versions' separate operations do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# every kernel of the port, by its source's name under csrc/
KERNELS = ("pip_refine", "grid_scatter", "box_count", "dist_refine",
           "merge_scatter", "seg_band", "block_gate", "fused_scan",
           "ordered_compact", "masked_hist", "topk_nearest", "geom_unary",
           "geom_dist", "geom_pred", "pip_join", "pair_band")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    # the shared headers too, so an edited header rebuilds its includers
    for hdr in sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, hdr), "rb") as fh:
            digest.update(fh.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named kernel that is not built yet, one nvcc process
    per source, all started together. Returns name → {"seconds", "log"}
    (the log holds ptxas' register and shared-memory report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        src, so = _target(name)
        if os.path.exists(so):
            out[name] = {"seconds": 0.0, "log": "cached"}
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so)
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        os.replace(tmp, so)
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _, so = _target(name)
            if not os.path.exists(so):
                build([name])
            lib = ctypes.CDLL(so)
            _LIBS[name] = lib
        return lib


def on_device(dev: torch.device):
    """A context in which ``dev`` is the current CUDA device (a launch must
    go to a stream of the current device): none when it already is."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def raw_stream(dev: torch.device) -> int:
    """The handle of PyTorch's current stream on ``dev``, without making a
    ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def placed(t: torch.Tensor, dev: torch.device) -> None:
    """Raise unless ``t`` is contiguous and on ``dev`` (a wrapper's rule for
    every tensor it hands a kernel)."""
    if not t.is_contiguous():
        raise ValueError("every input must be contiguous")
    if t.device != dev:
        raise ValueError("every input must lie on one device")
