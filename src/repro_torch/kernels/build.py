"""Build the port's CUDA kernels from the sources in the package.

Each ``csrc/*.cu`` file has a plain C entry point and is compiled by
``nvcc`` into its own shared library for Hopper (``sm_90a``), loaded with
``ctypes``.  Libraries land in ``kernels/_build/`` (git-ignored), named by
a hash of the source and flags, so an edited source is rebuilt and an
unchanged one is built once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def sources() -> list[Path]:
    """Every CUDA source of the port's kernels."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc`` as PyTorch finds it, else
    the one on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(src: Path) -> str:
    """Compile ``src`` unless its library exists.  Returns nvcc's output
    (``-Xptxas -v`` puts registers and shared memory there), empty when
    nothing was compiled; raises with that output if the build fails."""
    out = lib_path(src)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src.name} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def check_inputs(kind: str, tensors, dev, strided: bool = False) -> None:
    """Raise unless each ``(tensor, dtype)`` or ``(tensor, dtype, shape)`` is
    a tensor of that dtype (and shape) on ``dev``, and contiguous unless
    ``strided`` (for a kernel that takes element strides): what a kernel
    launched through ``ctypes`` assumes of its pointers."""
    for t, dtype, *shape in tensors:
        if (t.device != dev or t.dtype != dtype or not (strided or t.is_contiguous())
                or (shape and tuple(t.shape) != tuple(shape[0]))):
            want = f" of shape {tuple(shape[0])}" if shape else ""
            layout = "" if strided else "contiguous "
            raise ValueError(
                f"{kind} kernel input must be a {layout}{dtype} tensor{want} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


@functools.lru_cache(maxsize=None)
def load(src: Path) -> ctypes.CDLL:
    """The shared library of one source, built first if missing."""
    build(src)
    return ctypes.CDLL(str(lib_path(src)))
