"""Flash decode: a hand-written Hopper kernel and its plain version.

Replaces the TPU kernel `defer_tpu/ops/pallas_attention.py`
(`flash_decode`, body `_decode_kernel`, live range `_decode_lo_hi`): one
query token per sequence against a contiguous KV cache, the T=1 step of
the decoder (`models/gpt.py`). q [B, Hq, Dh] attends k/v [B, Hkv, S, Dh]
(GQA: the G = Hq/Hkv query rows of a KV head share it), masked to the
columns `col <= pos[b]` and, with a window, `col > pos[b] - window`;
q is pre-scaled by Dh**-0.5 in f32, the softmax runs in f32 with the
finite `_MASK_VALUE`, and the output acc / l is cast to q's dtype.

What bounds it on an H100: the bytes of the live K/V rows. At the
serving path's shape (B=4, Hq=32, Hkv=8, Dh=128, S=4096, bf16) each live
row costs 2 x 8 x 128 x 2 B = 4 KB a sequence, against 32 KB of q and o
in all. The design carries over the TPU kernel's one property that
matters, the live range: the kernel reads `pos` from device memory (no
host sync, so `pos` may live on the card as the decode server keeps it)
and loads only rows in [max(pos-window+1, 0), min(pos, S-1)], never the
whole cache. The TPU kernel's zero-padding of G to 8 rows and its
scalar-prefetch index maps have no counterpart. To fill 132 SMs at a
small batch, the live range is split ("flash-decoding"): the grid is
(splits, Hkv, B), each CTA takes a chunk of at least 32 live rows sized
in the kernel from pos, CTAs past the live range exit at once, and a
second small kernel merges the partial (m, l, acc) of the splits that
ran. `csrc/flash_decode.cu` has the thread layout.

Dispatch follows the tensor's device and nothing else: a CUDA tensor
launches the kernel or raises; a CPU or meta tensor takes the plain
version. The plain version keeps f32 probabilities through the second
product, as the TPU kernel does, so the port's CPU decode step equals
the JAX package run with DEFER_TPU_PALLAS_INTERPRET=1; it is not the
JAX package's einsum path, which casts the softmax weights to the
compute dtype before the PV product. There is no backward: the TPU
kernel has none either.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

# Finite stand-in for -inf, as the TPU kernel's (pallas_attention.py).
_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

_SOURCE = "flash_decode.cu"
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (32, 64, 128)
# Fewest live rows one split takes; kMinChunk in the CUDA source.
_MIN_CHUNK = 32
# Most splits of one sequence's live range.
_MAX_SPLITS = 64


def _decode_lo_hi(p_b: int, block_k: int, window: int | None):
    """First/last live K block (inclusive) of a sequence whose last
    valid key is `p_b`, as the TPU kernel's `_decode_lo_hi`: blocks
    wholly outside [p_b - window + 1, p_b] are dead. With block_k=1 the
    blocks are rows."""
    hi = p_b // block_k
    lo = max(p_b - window + 1, 0) // block_k if window is not None else 0
    return lo, hi


def live_rows(p_b: int, seq: int, window: int | None) -> int:
    """K/V rows of one sequence that the kernel reads: the live range
    [max(p_b - window + 1, 0), min(p_b, seq - 1)]."""
    lo, hi = _decode_lo_hi(p_b, 1, window)
    return max(0, min(hi, seq - 1) - lo + 1)


def _check(q, k, v, window) -> None:
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(
            f"expected q (B, Hq, Dh) and k/v (B, Hkv, S, Dh), got "
            f"{tuple(q.shape)} and {tuple(k.shape)}"
        )
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[2]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch "
            "or head dim"
        )
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"Hq={q.shape[1]} must be a multiple of Hkv={k.shape[1]}"
        )
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be None or >= 1")


def flash_decode_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos,
    *,
    window: int | None = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 scores and
    probabilities, `_MASK_VALUE` on masked columns, one cast at the
    end. `pos` is a (B,) or scalar int tensor, or an int; inclusive."""
    _check(q, k, v, window)
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    posv = torch.as_tensor(pos, device=q.device).reshape(-1).expand(b)
    qf = q.float().reshape(b, hkv, hq // hkv, dh) * dh**-0.5
    sc = torch.einsum("bkgd,bksd->bkgs", qf, k.float())
    j = torch.arange(s, device=q.device)
    live = j[None, :] <= posv[:, None]
    if window is not None:
        live &= j[None, :] > posv[:, None] - window
    sc = sc.masked_fill(~live[:, None, None, :], _MASK_VALUE)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    out = out / p.sum(dim=-1, keepdim=True)
    return out.to(q.dtype).reshape(b, hq, dh)


@functools.cache
def _kernel():
    """The built library's entry point, typed once."""
    from defer_tpu_torch.utils.nvcc import load_library

    fn = load_library(_SOURCE).defer_flash_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ]
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _num_splits(device: torch.device, ctas: int, seq: int) -> int:
    """Splits of each sequence's live range: enough CTAs for about four
    a streaming multiprocessor, no more than S holds chunks of
    `_MIN_CHUNK` rows. Depends on shapes only, never on pos."""
    want = math.ceil(4 * _sm_count(device.index or 0) / ctas)
    return max(1, min(want, math.ceil(seq / _MIN_CHUNK), _MAX_SPLITS))


@functools.lru_cache(maxsize=256)
def _launch_plan(q_shape, q_stride, k_shape, k_stride, v_stride, dtypes,
                 device):
    """What a launch needs beyond the pointers, checked and computed
    once per shape: (splits, element strides as a ctypes array, the
    row alignment in bytes). Raises on what the kernel does not take."""
    b, hq, dh = q_shape
    hkv, s = k_shape[1], k_shape[2]
    dtype = dtypes[0]
    if dtype not in _DTYPE_CODE or len(set(dtypes)) != 1:
        raise TypeError(
            "the CUDA flash-decode kernel takes float32, float16 or "
            f"bfloat16 q/k/v of one dtype; got {'/'.join(map(str, dtypes))}"
        )
    if dh not in _HEAD_DIMS:
        raise ValueError(
            f"the CUDA flash-decode kernel takes Dh in {_HEAD_DIMS}, got {dh}"
        )
    # One lane loads Dh/32 consecutive elements: rows must be aligned to
    # that width (up to 16 bytes).
    itemsize = dtype.itemsize
    align = min(16, dh // 32 * itemsize)
    for name, stride in (("q", q_stride), ("k", k_stride), ("v", v_stride)):
        if stride[-1] != 1:
            raise ValueError(f"{name} needs a unit Dh stride")
        if any(st * itemsize % align for st in stride[:-1]):
            raise ValueError(f"{name} rows are not {align}-byte aligned")
    splits = _num_splits(device, b * hkv * math.ceil(hq // hkv / 8), s)
    strides = (ctypes.c_longlong * 10)(
        q_stride[0], q_stride[1], *k_stride[:3], *v_stride[:3], hq * dh, dh,
    )
    return splits, strides, align


def _decode_cuda(q, k, v, pos, window) -> torch.Tensor:
    """Launch the sm_90a kernel on q's current stream. q, k, v may be
    strided views with a unit Dh stride; `pos` stays on the card."""
    b, hq, dh = q.shape
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q/k/v on different devices: {q.device}/{k.device}/{v.device}"
        )
    splits, strides, align = _launch_plan(
        tuple(q.shape), q.stride(), tuple(k.shape), k.stride(), v.stride(),
        (q.dtype, k.dtype, v.dtype), q.device,
    )
    if any(t.data_ptr() % align for t in (q, k, v)):
        raise ValueError(f"q/k/v rows are not {align}-byte aligned")
    if isinstance(pos, int):
        pos = torch.full((b,), pos, dtype=torch.int32, device=q.device)
    if pos.device != q.device:
        raise ValueError(f"pos on {pos.device}, q on {q.device}")
    if pos.ndim > 1 or (pos.ndim == 1 and pos.shape[0] != b):
        raise ValueError(f"pos must be () or ({b},), got {tuple(pos.shape)}")
    if pos.dtype != torch.int32:
        pos = pos.to(torch.int32)  # on the card: no host sync
    pos_stride = pos.stride(0) if pos.ndim == 1 else 0

    out = torch.empty((b, hq, dh), dtype=q.dtype, device=q.device)
    part_acc = part_ml = None
    if splits > 1:
        # One f32 workspace: the partial acc [B, Hq, splits, Dh], then
        # the partial (m, l) [B, Hq, splits, 2].
        n_acc = b * hq * splits * dh
        ws = torch.empty(n_acc + b * hq * splits * 2, dtype=torch.float32,
                         device=q.device)
        part_acc = ws.data_ptr()
        part_ml = part_acc + 4 * n_acc
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        pos.data_ptr(), pos_stride, part_acc, part_ml, _DTYPE_CODE[q.dtype],
        b, hq, k.shape[1], k.shape[2], dh, strides,
        0 if window is None else int(window), splits, dh**-0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if torch.cuda.current_device() == q.device.index:
        rc = _kernel()(*args)
    else:
        with torch.cuda.device(q.device):
            rc = _kernel()(*args)
    if rc != 0:
        raise RuntimeError(
            f"flash-decode kernel launch failed with CUDA error {rc} for q "
            f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, window={window}"
        )
    flash_decode.launches += 1
    return out


def flash_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos,
    *,
    window: int | None = None,
) -> torch.Tensor:
    """One query token per sequence against its cache: q [B, Hq, Dh],
    k/v [B, Hkv, S, Dh], pos [B] (or a scalar, broadcast) int, the index
    of each sequence's last valid key, inclusive and >= 0. Returns
    [B, Hq, Dh] in q's dtype.

    CUDA tensors run the hand-written kernel (any S >= 1 and G >= 1,
    Dh in 32/64/128, float32/float16/bfloat16) and raise on what it does
    not take; CPU and meta tensors run `flash_decode_plain`.
    `flash_decode.launches` counts kernel launches."""
    _check(q, k, v, window)
    if q.device.type == "cuda":
        return _decode_cuda(q, k, v, pos, window)
    if q.device.type in ("cpu", "meta"):
        return flash_decode_plain(q, k, v, pos, window=window)
    raise ValueError(
        f"flash decode has no path for device {q.device}: CUDA launches "
        "the kernel, CPU and meta take the plain version"
    )


flash_decode.launches = 0
