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
in all; at the tick's depths (about 180 rows) that is under 3 MB, about
1 us at 3.35 TB/s, so a call's cost is latency. The design carries over
the TPU kernel's one property that matters, the live range: the kernel
reads `pos` from device memory (no host sync, so `pos` may live on the
card as the decode server keeps it) and loads only rows in
[max(pos-window+1, 0), min(pos, S-1)], never the whole cache. The TPU
kernel's zero-padding of G to 8 rows and its scalar-prefetch index maps
have no counterpart. For bf16/f16 q, `csrc/flash_decode.cu` runs the
tensor-core decode engine of `csrc/decode_tile.cuh`: a thread block
cluster of C CTAs (`_cluster_size`, from S only; the launch lowers it
until every cluster of the grid fits on the card at once) per (sequence,
KV head, 16 query rows; G > 16 takes ceil(G / 16) CTAs a KV head) takes
equal shares of the live 64-row tiles, each warp
stages 16-row slices of K and V by cp.async in a 3-stage ring, both
products run on `mma.sync`, and the CTAs' states merge through
distributed shared memory in the same kernel: one launch a call, no
workspace. `_warp_slices` mirrors which rows each warp takes. f32 q
keeps an FMA kernel (TF32 would miss the f32 tolerance), each rank of
its cluster taking one chunk of the live rows (`_f32_chunks`).

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
# The decode engine's work split (csrc/decode_tile.cuh): K/V rows a warp
# takes a step, warps of a CTA, and the most CTAs of a cluster (portable).
_SLICE = 16
_WARPS = 4
_MAX_CLUSTER = 8
# Fewest live rows a rank of the f32 FMA kernel takes; kMinChunk there.
_MIN_CHUNK = 32

def _decode_lo_hi(p_b: int, block_k: int, window: int | None):
    """First/last live K block (inclusive) of a sequence whose last
    valid key is `p_b`, as the TPU kernel's `_decode_lo_hi`: blocks
    wholly outside [p_b - window + 1, p_b] are dead. With block_k=1 the
    blocks are rows."""
    hi = p_b // block_k
    lo = max(p_b - window + 1, 0) // block_k if window is not None else 0
    return lo, hi


def _live_bounds(p_b: int, span: int, window: int | None):
    """The live rows [lo, hi] the kernels walk for a last valid key at
    `p_b`: `live_range` in the CUDA sources."""
    hi = min(p_b, span - 1)
    lo = max(p_b - window + 1, 0) if window is not None else 0
    return lo, hi


def live_rows(p_b: int, seq: int, window: int | None) -> int:
    """K/V rows of one sequence that the kernel reads: the live range
    [max(p_b - window + 1, 0), min(p_b, seq - 1)]."""
    lo, hi = _live_bounds(p_b, seq, window)
    return max(0, hi - lo + 1)


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
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return fn


def run_counter(kernel: str) -> tuple:
    """A kernel's count of its own runs on the card, as the functions
    (`_runs`, `card_runs`, `reset_card_runs`) its wrapper module exports:
    `_runs(index)` is device `index`'s uint64 counter, which each launch
    hands the kernel and one thread of its grid adds one to, made at the
    device's first launch (which must not be under graph capture, nor
    can it be: a launch plan queries the card); `card_runs(index)` reads
    the runs since `reset_card_runs(index)` to the host: eager launches
    and launches replayed from a captured CUDA graph alike, which the
    wrapper's host count (`.launches`) cannot see."""

    @functools.cache
    def _runs(index: int) -> torch.Tensor:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the first {kernel} launch on a device must run eagerly, "
                "before any graph capture"
            )
        return torch.zeros((), dtype=torch.int64, device=f"cuda:{index}")

    def card_runs(index: int = 0) -> int:
        return int(_runs(index))

    def reset_card_runs(index: int = 0) -> None:
        _runs(index).zero_()

    card_runs.__doc__ = (
        f"The {kernel} kernels card `index` has run since "
        "`reset_card_runs`, graph replays included (`run_counter`)."
    )
    return _runs, card_runs, reset_card_runs


_runs, card_runs, reset_card_runs = run_counter("flash_decode")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _cluster_size(span: int) -> int:
    """CTAs that share one (sequence, KV head): one per 64-row tile of a
    span of `span` rows (S, or the table's MB * bs), at most 8 (a
    portable cluster). Depends on shapes only, never on pos."""
    return max(1, min(_MAX_CLUSTER, math.ceil(span / (_WARPS * _SLICE))))


def _warp_slices(lo: int, hi: int, cluster: int) -> dict:
    """The tensor-core kernels' work split (csrc/decode_tile.cuh): the
    live rows [lo, hi] cut into 16-row slices from lo, slice j taken by
    warp j % 4 of rank (j // 4) % cluster. Returns {(rank, warp): [(first
    row, last row), ...]} with the rows past hi cut off (the kernel
    zero-fills them and weighs them 0)."""
    nslices = (hi - lo) // _SLICE + 1 if hi >= lo else 0
    nw = cluster * _WARPS
    out = {}
    for rank in range(cluster):
        for warp in range(_WARPS):
            gw = rank * _WARPS + warp
            cnt = -(-(nslices - gw) // nw) if nslices > gw else 0
            out[rank, warp] = [
                (lo + _SLICE * j, min(lo + _SLICE * j + _SLICE - 1, hi))
                for j in (gw + k * nw for k in range(cnt))
            ]
    return out


def _f32_chunks(lo: int, hi: int, cluster: int, bs: int = 1) -> list:
    """The f32 FMA kernels' work split: rank r's rows [first, last] of
    the live rows, in chunks of whole `bs`-row blocks of at least
    `_MIN_CHUNK` rows (bs 1 for the contiguous cache), or None where the
    chunks end before it."""
    lo_blk = lo // bs
    nblk = hi // bs - lo_blk + 1
    chunk = max(-(-_MIN_CHUNK // bs), -(-nblk // cluster))
    out = []
    for rank in range(cluster):
        blk0 = lo_blk + rank * chunk
        r0, r1 = max(blk0 * bs, lo), min((blk0 + chunk) * bs, hi + 1)
        out.append((r0, r1 - 1) if r0 < r1 else None)
    return out


@functools.lru_cache(maxsize=256)
def _launch_plan(q_shape, q_stride, k_shape, k_stride, v_stride, dtypes):
    """What a launch needs beyond the pointers, checked and computed
    once per shape: (cluster size, element strides as a ctypes array,
    the row alignment in bytes). Raises on what the kernel does not
    take."""
    b, hq, dh = q_shape
    s = k_shape[2]
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
    # 16-bit rows are copied 16 bytes at a time; an f32 lane loads Dh/32
    # consecutive elements.
    itemsize = dtype.itemsize
    align = 16 if itemsize == 2 else min(16, dh // 32 * itemsize)
    for name, stride in (("q", q_stride), ("k", k_stride), ("v", v_stride)):
        if stride[-1] != 1:
            raise ValueError(f"{name} needs a unit Dh stride")
        if any(st * itemsize % align for st in stride[:-1]):
            raise ValueError(f"{name} rows are not {align}-byte aligned")
    strides = (ctypes.c_longlong * 10)(
        q_stride[0], q_stride[1], *k_stride[:3], *v_stride[:3], hq * dh, dh,
    )
    return _cluster_size(s), strides, align


def _decode_cuda(q, k, v, pos, window) -> torch.Tensor:
    """Launch the sm_90a kernel on q's current stream. q, k, v may be
    strided views with a unit Dh stride; `pos` stays on the card."""
    b, hq, dh = q.shape
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q/k/v on different devices: {q.device}/{k.device}/{v.device}"
        )
    cluster, strides, align = _launch_plan(
        tuple(q.shape), q.stride(), tuple(k.shape), k.stride(), v.stride(),
        (q.dtype, k.dtype, v.dtype),
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
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        pos.data_ptr(), pos_stride, _DTYPE_CODE[q.dtype], b, hq,
        k.shape[1], k.shape[2], dh, strides,
        0 if window is None else int(window), cluster, dh**-0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
        _runs(q.device.index).data_ptr(),
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
    `flash_decode.launches` counts kernel launches on the host;
    `card_runs` counts the kernel's runs on the card, graph replays
    included."""
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
