"""Build a CUDA source of the package into a shared library and load it.

Each kernel is a `.cu` file under `defer_tpu_torch/csrc/` with a plain C
interface. It is compiled with `nvcc` for Hopper (sm_90a) into a shared
library under `defer_tpu_torch/_build/` (git-ignored) at first use and
loaded with ctypes (`utils/native.py` `build_library`); no PyTorch
headers are involved, so a build takes seconds. Sources may include the
headers (`*.cuh`) beside them. The library's file name carries a hash of
the source, those headers and the flags, so an edited source or header
is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil

from defer_tpu_torch.utils.native import BUILD_DIR, build_library, build_seconds

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

__all__ = ["build_seconds", "library_path", "load_library", "nvcc_path"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "of defer_tpu_torch are built from source at first use"
    )


def library_path(source: str) -> pathlib.Path:
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def load_library(source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` (once per content) and return the loaded
    library. Raises RuntimeError with nvcc's output when the build
    fails. Calls for different sources build in parallel; calls for the
    same source wait for one build."""
    return build_library(
        source,
        library_path(source),
        lambda tmp: [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / source)],
    )
