"""ctypes loader for the native host image preprocessor (counterpart of
`defer_tpu/runtime/native_image.py`).

`defer_tpu_torch/native/imageproc.cpp` (the port's own copy of the JAX
package's source) fuses bilinear resize + center crop + per-channel
affine into one multithreaded C++ pass. It is built with g++ into
`defer_tpu_torch/_build/` at first use. `imagenet_preprocess` in
runtime/data.py uses it for uint8 input and takes the numpy path when
the build is unavailable — both produce the same values (tested to
1e-3 absolute).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Any

import numpy as np
import torch

from defer_tpu_torch.utils import native
from defer_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_tried = False

# mode -> (scale, per-OUTPUT-channel offsets, swap_rb)
_MODES: dict[str, tuple[float, tuple[float, float, float], int]] = {
    "scale": (1.0 / 127.5, (-1.0, -1.0, -1.0), 0),
    "unit": (1.0 / 255.0, (0.0, 0.0, 0.0), 0),
    "caffe": (1.0, (-103.939, -116.779, -123.68), 1),
}


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        try:
            lib = native.load_library("imageproc.cpp", ("-pthread",))
        except (RuntimeError, OSError) as e:
            log.warning("native imageproc unavailable: %s", e)
            return None
        lib.defer_preprocess.restype = ctypes.c_int
        lib.defer_preprocess.argtypes = [
            ctypes.c_void_p,  # src
            ctypes.c_int64,  # n
            ctypes.c_int64,  # h
            ctypes.c_int64,  # w
            ctypes.c_int64,  # c
            ctypes.c_int64,  # size
            ctypes.POINTER(ctypes.c_float),  # scale
            ctypes.POINTER(ctypes.c_float),  # offset
            ctypes.c_int,  # swap_rb
            ctypes.c_int,  # out_bf16
            ctypes.c_int64,  # num_threads
            ctypes.c_void_p,  # dst
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_preprocess(
    images: Any,
    *,
    size: int,
    mode: str,
    out_dtype: torch.dtype | None = None,
    num_threads: int | None = None,
) -> torch.Tensor | None:
    """Fused resize+crop+affine via the C++ library: uint8 NHWC (or HWC)
    RGB in, a CPU tensor of float32 or bfloat16 out.

    Returns None when the native path cannot handle the request (no
    library, non-uint8 input, unknown mode, unsupported out_dtype) —
    the caller falls back to numpy.
    """
    if mode not in _MODES:
        return None
    x = images.numpy() if isinstance(images, torch.Tensor) else np.asarray(
        images
    )
    if x.ndim == 3:
        x = x[None]
    if x.ndim != 4 or x.dtype != np.uint8 or x.shape[-1] != 3:
        return None
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if out_dtype not in (torch.float32, torch.bfloat16):
        return None
    lib = _load()
    if lib is None:
        return None

    x = np.ascontiguousarray(x)
    n, h, w, c = x.shape
    scale_v, offsets, swap = _MODES[mode]
    scale_arr = (ctypes.c_float * c)(*([scale_v] * c))
    offset_arr = (ctypes.c_float * c)(*offsets)
    bf16 = out_dtype == torch.bfloat16
    out = torch.empty(
        (n, size, size, c), dtype=torch.int16 if bf16 else torch.float32
    )
    if num_threads is None:
        num_threads = max(1, (os.cpu_count() or 2) // 2)
    rc = lib.defer_preprocess(
        x.ctypes.data_as(ctypes.c_void_p),
        n,
        h,
        w,
        c,
        size,
        scale_arr,
        offset_arr,
        swap,
        1 if bf16 else 0,
        num_threads,
        ctypes.c_void_p(out.data_ptr()),
    )
    if rc != 0:
        log.warning("native preprocess returned rc=%d; falling back", rc)
        return None
    return out.view(torch.bfloat16) if bf16 else out
