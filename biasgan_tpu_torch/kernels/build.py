"""Build and load the port's CUDA kernels.

Each kernel source in ``kernels/csrc/`` has a plain C interface and may
include the shared headers there (``*.cuh``). On first use it is compiled
with ``nvcc`` for sm_90a into a shared library under ``kernels/_build/``
(listed in .gitignore) and loaded with ctypes. The library name carries a
hash of the source, the headers and the flags, so an edited source or
header rebuilds and an unchanged one is loaded as built. Nothing here runs
at import time: this module imports on hosts with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",  # register / shared-memory / spill report, kept beside the library
)
# BIASGAN_KERNEL_WATCHDOG=1 makes a check build: a spin wait (an mbarrier's
# phase, the halo exchange's flags) that never ends traps instead of holding
# the card (csrc/common.cuh, watchdog_check)
WATCHDOG_FLAGS = ("-DPORT_WATCHDOG",)


def nvcc_flags() -> tuple:
    """NVCC_FLAGS, with WATCHDOG_FLAGS under BIASGAN_KERNEL_WATCHDOG=1."""
    watchdog = os.environ.get("BIASGAN_KERNEL_WATCHDOG") == "1"
    return NVCC_FLAGS + (WATCHDOG_FLAGS if watchdog else ())


# every kernel of the port, the one list of them: its source csrc/<name>.cu
# -> the wrapper that launches it, kernels/<module>.py::<wrapper>
SOURCES = {
    "conv3x3_fused": ("conv3x3_fused", "conv3x3_fused"),
    "conv3x3_fused_bwd": ("conv3x3_fused", "conv3x3_fused_bwd"),
    "conv3x3s2_fused": ("conv3x3s2_fused", "conv3x3s2_fused"),
    "convt3x3s2_fused": ("convt3x3s2_fused", "convt3x3s2_fused"),
    "conv7x7": ("conv7x7", "conv7x7"),
    "instance_norm_act": ("instance_norm_act", "instance_norm_act"),
    "instance_norm_act_bwd": ("instance_norm_act", "instance_norm_act_bwd"),
    "conv3x3_valid": ("conv3x3_valid", "conv3x3_valid"),
    "halo_exchange": ("halo_exchange", "halo_exchange_w"),
}
# the span each library's launches run in (kernels/common.launch)
SPANS = {lib: "port.kernel." + wrapper for lib, (_, wrapper) in SOURCES.items()}

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda, or PATH; raises if absent."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.isfile(cand):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels need the CUDA toolkit"
        )
    return found


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` into a shared library (if not built yet)
    and return its path. The compiler's output, with ptxas's register and
    shared-memory report per kernel, is kept in ``<library>.log``."""
    src = os.path.join(_CSRC, name + ".cu")
    flags = nvcc_flags()
    h = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build into a private name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [find_nvcc(), *flags, "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src}:\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        with open(out + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _LOADED[name] = lib
        return lib
