"""Build a source of the package into a shared library and load it.

The one builder behind the port's compiled code: the CUDA kernels
(`utils/nvcc.py`, nvcc for sm_90a) and the two host libraries, the array
codec (`native/codec.cpp`, byteshuffle + zstd) and the image
preprocessor (`native/imageproc.cpp`), built with g++. Each library is
compiled at first use into the git-ignored `defer_tpu_torch/_build/`
under a name that carries a hash of its sources and flags, so an edited
source is rebuilt and a stale library is never loaded, and is loaded
with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
import time
from typing import Callable

from defer_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

NATIVE = pathlib.Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# One lock per library, so that builds of different libraries run side
# by side; `_locks_guard` only guards the dict of locks, never a build.
_locks_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
# Seconds each library took to build and load in this process (only the
# load when it was already on disk), for the build report.
build_seconds: dict[str, float] = {}


def build_library(
    key: str,
    out: pathlib.Path,
    command: Callable[[pathlib.Path], list[str]],
) -> ctypes.CDLL:
    """Build `out` with `command(output path)` unless it exists, and load
    it (once per `key` in this process). Raises RuntimeError with the
    compiler's output when the build fails. Calls for different keys
    build in parallel; calls for the same key wait for one build."""
    with _locks_guard:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        lib = _loaded.get(key)
        if lib is not None:
            return lib
        t0 = time.perf_counter()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build to a private name, then rename: a concurrent process
            # never loads a half-written library.
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = command(tmp)
            tool = os.path.basename(cmd[0])
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"{tool} did not run on {key}: {e}") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"{tool} failed on {key} ({proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
            log.info("built %s in %.1fs", out.name, time.perf_counter() - t0)
        build_seconds[key] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        _loaded[key] = lib
        return lib


def library_path(source: str, libs: tuple[str, ...] = ()) -> pathlib.Path:
    src = NATIVE / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join((*CXX_FLAGS, *libs)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def load_library(source: str, libs: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile `native/<source>` with g++ (once per content), linking
    `libs`, and return the loaded library."""
    return build_library(
        f"native/{source}",
        library_path(source, libs),
        lambda tmp: ["g++", *CXX_FLAGS, str(NATIVE / source), "-o", str(tmp),
                     *libs],
    )
