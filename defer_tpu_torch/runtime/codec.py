"""Array transfer codec (counterpart of `defer_tpu/runtime/codec.py`).

Every weight and activation hop of DEFER's socket leg goes through this
seam, where the reference ran ZFP + LZ4 (reference
src/dispatcher.py:89-92, src/node.py:93-96). The frames are the JAX
package's, byte for byte, so either package decodes what the other
encoded:

  * native: `defer_tpu_torch/native/codec.cpp` (byteshuffle + zstd),
    built with g++ into `defer_tpu_torch/_build/` at first use and
    loaded through ctypes;
  * fallback: numpy byteshuffle + zlib, for a host where the native
    build fails. Same frame layout, a different `scheme` tag.

Frame: magic(2) ver(1) scheme(1) dtype_len(1) dtype ndim(1) dims(8 each)
then payload.

`encode` takes a CPU tensor or a numpy array; `decode` returns a CPU
tensor. bfloat16, which numpy lacks, rides as its 2-byte pattern (an
int16 view, never widened) under the dtype field `bfloat16`, which the
JAX package's decoder reads as `np.dtype("bfloat16")` wherever
ml_dtypes is loaded. The JAX package itself writes a bfloat16 array's
field as `<V2` (numpy's raw void type: `arr.dtype.str`), which loses the
element type; such a frame is refused here with an error that says so.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Any

import numpy as np
import torch

from defer_tpu_torch.models.quant import quantize_symmetric
from defer_tpu_torch.obs.metrics import get_registry
from defer_tpu_torch.utils import native
from defer_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# Raw-in vs frame-out byte totals; their ratio is the codec's achieved
# compression over everything this process encoded.
_obs_raw = get_registry().counter(
    "defer_codec_raw_bytes_total", "Uncompressed bytes handed to encode()"
)
_obs_encoded = get_registry().counter(
    "defer_codec_encoded_bytes_total", "Frame bytes produced by encode()"
)

_MAGIC = b"DC"
_VERSION = 1
SCHEME_RAW = 0  # passthrough (level=0): fast links where codec loses
SCHEME_ZSTD_SHUFFLE = 1  # native codec
SCHEME_ZLIB_SHUFFLE = 2  # pure-python fallback
SCHEME_Q8 = 3  # lossy: symmetric int8 quantization, then 0/1/2 inside

BF16 = "bfloat16"
# The zstd runtime by its soname: a host may lack the unversioned
# development link (and <zstd.h>) while the runtime is there.
_LIBS = ("-l:libzstd.so.1",)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_tried = False


def load_native() -> ctypes.CDLL | None:
    """Build (if needed) and load the native codec; None if the build or
    the load fails (encode then falls back to zlib)."""
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        try:
            lib = native.load_library("codec.cpp", _LIBS)
        except (RuntimeError, OSError) as e:
            log.warning("native codec unavailable: %s", e)
            return None
        lib.defer_codec_bound.restype = ctypes.c_size_t
        lib.defer_codec_bound.argtypes = [ctypes.c_size_t]
        lib.defer_codec_encode.restype = ctypes.c_size_t
        lib.defer_codec_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.defer_codec_decode.restype = ctypes.c_size_t
        lib.defer_codec_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_size_t,
        ]
        _lib = lib
        return _lib


def _host_array(arr: Any) -> tuple[np.ndarray, str]:
    """(a contiguous numpy array holding the payload's bytes, the frame's
    dtype field). A bfloat16 tensor (or an ml_dtypes bfloat16 array)
    becomes its uint16 bit pattern under the field `bfloat16`."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != "cpu":
            raise ValueError(
                f"encode takes a CPU tensor, got one on {arr.device}: copy "
                "it to the host first (transport.ArraySender.send does)"
            )
        t = arr.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        a = t.numpy()
    else:
        a = np.ascontiguousarray(arr)
        if a.dtype.name == BF16:
            return a.view(np.uint16), BF16
    if a.dtype.kind == "V":
        raise ValueError(f"cannot encode a raw void array ({a.dtype})")
    return a, a.dtype.str


def _to_tensor(a: np.ndarray, field: str) -> torch.Tensor:
    if field == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _shuffle_np(raw: bytes, elem: int) -> bytes:
    a = np.frombuffer(raw, np.uint8).reshape(-1, elem)
    return np.ascontiguousarray(a.T).tobytes()


def _unshuffle_np(raw: bytes, elem: int) -> bytes:
    a = np.frombuffer(raw, np.uint8).reshape(elem, -1)
    return np.ascontiguousarray(a.T).tobytes()


def _count(raw_bytes: int, frame: bytes) -> None:
    _obs_raw.inc(raw_bytes)
    _obs_encoded.inc(len(frame))


def encode(
    arr: Any,
    *,
    level: int = 3,
    quantize: str | None = None,
    _count_bytes: bool = True,
) -> bytes:
    """CPU tensor or numpy array -> self-describing compressed frame.
    level=0 skips compression (raw passthrough).

    quantize="int8" (floating arrays only) is the LOSSY mode: symmetric
    per-tensor int8 with an fp64 scale (models/quant.py's convention,
    computed in float64), max abs error amax/127; the inner int8 payload
    goes through the lossless pipeline, and decode restores the original
    dtype."""
    a, field = _host_array(arr)
    if quantize is not None:
        if quantize != "int8":
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if field != BF16 and not np.issubdtype(a.dtype, np.floating):
            raise ValueError(
                f"quantize='int8' needs a floating dtype, got {a.dtype}"
            )
        t64 = _to_tensor(a, field).to(torch.float64)
        if t64.numel() and not bool(torch.isfinite(t64).all()):
            # One NaN/Inf would corrupt the whole tensor (scale=inf
            # zeroes everything); the lossless path keeps them.
            raise ValueError(
                "quantize='int8' requires finite values; tensor contains "
                "NaN/Inf — send it losslessly instead"
            )
        q, s = quantize_symmetric(t64)
        # The inner frame is part of THIS encode: counting it too would
        # book the raw bytes twice.
        inner = encode(q, level=level, _count_bytes=False)
        dtype = field.encode()
        header = struct.pack(
            f"<2sBBB{len(dtype)}sB", _MAGIC, _VERSION, SCHEME_Q8,
            len(dtype), dtype, 0,
        )
        frame = header + struct.pack("<d", float(s)) + inner
        if _count_bytes:
            _count(a.nbytes, frame)
        return frame

    raw = a.tobytes()
    elem = a.dtype.itemsize
    dtype = field.encode()
    payload = None
    scheme = SCHEME_ZLIB_SHUFFLE
    if level == 0:
        payload, scheme = raw, SCHEME_RAW
    lib = load_native() if payload is None else None
    if lib is not None and raw:
        cap = lib.defer_codec_bound(len(raw))
        dst = ctypes.create_string_buffer(cap)
        n = lib.defer_codec_encode(raw, len(raw), elem, level, dst, cap)
        if n:
            payload = ctypes.string_at(dst, n)
            scheme = SCHEME_ZSTD_SHUFFLE
        else:
            log.warning("native codec encode failed; using fallback")
    if payload is None:
        shuffled = _shuffle_np(raw, elem) if elem > 1 and raw else raw
        # zstd levels run to 22; clamp for zlib's 0-9 range.
        payload = zlib.compress(shuffled, min(level, 9))
    header = struct.pack(
        f"<2sBBB{len(dtype)}sB{a.ndim}q",
        _MAGIC, _VERSION, scheme, len(dtype), dtype, a.ndim, *a.shape,
    )
    frame = header + payload
    if _count_bytes:
        _count(a.nbytes, frame)
    return frame


def _header(frame: bytes) -> tuple[int, str, tuple[int, ...], int]:
    """(scheme, dtype field, shape, payload offset) of a frame."""
    if frame[:2] != _MAGIC:
        raise ValueError("not a defer_tpu codec frame")
    ver, scheme, dlen = struct.unpack_from("<BBB", frame, 2)
    if ver != _VERSION:
        raise ValueError(f"unsupported codec frame version {ver}")
    off = 5
    field = bytes(frame[off : off + dlen]).decode()
    off += dlen
    (ndim,) = struct.unpack_from("<B", frame, off)
    off += 1
    shape = struct.unpack_from(f"<{ndim}q", frame, off)
    return scheme, field, shape, off + 8 * ndim


def frame_schemes(frame: bytes) -> tuple[int, ...]:
    """The frame's scheme; for an int8 frame (SCHEME_Q8) also the scheme
    of the int8 payload inside it."""
    scheme, _, _, off = _header(frame)
    if scheme == SCHEME_Q8:
        return (scheme, *frame_schemes(frame[off + 8 :]))
    return (scheme,)


def _np_dtype(field: str) -> np.dtype:
    if field == BF16:
        return np.dtype(np.uint16)
    dtype = np.dtype(field)
    if dtype.kind == "V":
        raise ValueError(
            f"codec frame has the dtype field {field!r}, a raw void type "
            "with no element type. The JAX package's codec writes a "
            "bfloat16 array's field so (arr.dtype.str is '<V2' for "
            "ml_dtypes.bfloat16), a fault of that encoder: its bfloat16 "
            "frames cannot be decoded as numbers. Send bfloat16 from "
            "defer_tpu_torch (field 'bfloat16'), or as float32 or a "
            "uint16 view from the JAX package."
        )
    return dtype


def decode(frame: bytes) -> torch.Tensor:
    """Compressed frame (either scheme, either package) -> CPU tensor."""
    scheme, field, shape, off = _header(frame)
    dtype = _np_dtype(field)
    payload = frame[off:]
    if scheme == SCHEME_Q8:
        (scale,) = struct.unpack_from("<d", payload, 0)
        q = decode(payload[8:])
        target = _to_tensor(np.empty(0, dtype), field).dtype
        return (q.to(torch.float64) * scale).to(target)
    ndim = len(shape)
    nbytes = (
        int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if ndim else dtype.itemsize
    )
    nbytes = max(nbytes, 0)
    elem = dtype.itemsize
    if scheme == SCHEME_RAW:
        if len(payload) != nbytes:
            raise ValueError("corrupt raw codec frame")
        raw = payload
    elif scheme == SCHEME_ZSTD_SHUFFLE:
        lib = load_native()
        if lib is None:
            raise RuntimeError(
                "frame was encoded with the native zstd codec but the "
                "native library is unavailable on this host"
            )
        raw = b""
        if nbytes:
            dst = ctypes.create_string_buffer(nbytes)
            n = lib.defer_codec_decode(
                bytes(payload), len(payload), dst, nbytes, elem
            )
            if n != nbytes:
                raise ValueError("corrupt native codec frame")
            raw = dst.raw
    elif scheme == SCHEME_ZLIB_SHUFFLE:
        shuffled = zlib.decompress(payload)
        if len(shuffled) != nbytes:
            raise ValueError("corrupt zlib codec frame")
        raw = (
            _unshuffle_np(shuffled, elem) if elem > 1 and nbytes
            else shuffled
        )
    else:
        raise ValueError(f"unknown codec scheme {scheme}")
    a = np.frombuffer(raw, dtype).reshape(shape).copy()
    return _to_tensor(a, field)
