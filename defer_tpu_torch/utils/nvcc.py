"""Build a CUDA source of the package into a shared library and load it.

Each kernel is a `.cu` file under `defer_tpu_torch/csrc/` with a plain C
interface. It is compiled with `nvcc` for Hopper (sm_90a) into a shared
library under `defer_tpu_torch/_build/` (git-ignored) at first use and
loaded with ctypes; no PyTorch headers are involved, so a build takes
seconds. The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never
loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

from defer_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# One lock per source, so that builds of different sources run side by
# side; `_locks_guard` only guards the dict of locks, never a build.
_locks_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
# Seconds each library took to build and load in this process (only the
# load when it was already on disk), for the build report.
build_seconds: dict[str, float] = {}


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
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def load_library(source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` (once per content) and return the loaded
    library. Raises RuntimeError with nvcc's output when the build
    fails. Calls for different sources build in parallel; calls for the
    same source wait for one build."""
    with _locks_guard:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        lib = _loaded.get(source)
        if lib is not None:
            return lib
        out = library_path(source)
        t0 = time.perf_counter()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build to a private name, then rename: a concurrent process
            # never loads a half-written library.
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed on {source} ({proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
            log.info("built %s in %.1fs", out.name,
                     time.perf_counter() - t0)
        build_seconds[source] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        _loaded[source] = lib
        return lib
