"""Paged flash prefill: a hand-written Hopper kernel and its plain version.

Replaces the TPU kernel `defer_tpu/ops/pallas_attention.py`
(`paged_flash_prefill`, body `_paged_prefill_kernel`, live range
`_prefill_lo_hi`): a window of T query tokens per slot attending its
block table, the multi-token companion of `paged_flash_decode` that
chunked pool-native prefill runs (runtime/paged.py `prefill_chunk=`).
q [B, Hq, T, Dh] holds tokens at absolute positions start[b] ..
start[b] + T - 1, already rotated; the window's own K/V rows are already
in the pool (write-then-attend). Query rows are token-major, row r being
token r // G of group row r % G, so the causal mask is per row: row r
attends the columns `col <= start + r // G` and, with a window,
`col > start + r // G - window`. q is pre-scaled by Dh**-0.5 in f32,
the softmax runs in f32 with the finite `_MASK_VALUE`, and the output is
cast to q's dtype once.

What bounds it on an H100: the live pool rows and q/o, read and written
once, and 4 * T * Hq * Dh FLOP a live column: at a 2k-deep 64-token
chunk of Mistral-7B about 3 us of bytes and 2 us of tensor-core
operations. `csrc/paged_flash_prefill.cu` (on the Hopper engine of
`csrc/attn_wgmma.cuh`) runs both products on wgmma: a CTA of one
consumer warpgroup (64 token-major query rows) per (row tile, KV head,
slot, split), K/V tiles of 64 pool rows brought by TMA through the
table (a producer warp reads the entries ahead) into a ring of 2-4
stages, P rounded to q's type in registers. The CTA reads start[b] on
the card and walks only the live columns of its rows, from the edge of
the first live block. Split-K: the live tiles of each (row tile, KV
head, slot) are cut into `splits` chunks of whole 64-column tiles (two
at least), one CTA each, and the CTAs are one thread block cluster that
merges the chunks' f32 states through distributed shared memory: one
kernel a call, no workspace; a shallow chunk, one rank's whole, is
written by that rank with no merge. `splits` comes from the SM count and
the shapes (`_prefill_plan`), never from start, so the launch needs no
host sync.
Rows padded past T * G are never written. f32 q keeps the f32 FMA loop
of the first form (TF32 would miss the f32 tolerance).

The pool is q's dtype, or int8 with per-(block, head) f32 scales
`scale_k`/`scale_v` [NB, Hkv], as in `paged_flash_decode`: the kernel
copies the int8 payload by TMA, widens each tile once to q's type in
shared memory (exact), and folds the scales per column:
scores times the column's K scale, probabilities times its V scale
before P V. Dead columns read neither payload nor scale.

Dispatch follows the tensor's device and nothing else: a CUDA tensor
launches the kernel or raises; a CPU or meta tensor takes the plain
version, the JAX package's `_blockwise_attend_mt` fold.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from defer_tpu_torch.ops.flash_decode import (
    _DTYPE_CODE,
    _HEAD_DIMS,
    _MASK_VALUE,
    _sm_count,
    run_counter,
)
from defer_tpu_torch.ops.paged_flash_decode import (
    _check_pool,
    _check_scales,
    _pool_code,
    _pool_rows,
    _positions,
    _scale_strides,
    folded_blocks,
)

_SOURCE = "paged_flash_prefill.cu"
# Query rows of a consumer warpgroup and key columns of a tile (kRows /
# kCols in csrc/attn_wgmma.cuh).
_TILE = 64
# The most CTAs of a cluster (the portable cluster size), and the fewest
# 64-column tiles a rank of one walks (kMaxCluster, kMinChunk).
_MAX_CLUSTER = 8
_MIN_CHUNK = 2


def _prefill_plan(sms: int, b: int, hq: int, hkv: int, t_q: int, bs: int,
                  mb: int) -> int:
    """`splits` of the tensor-core kernel on a card of `sms` SMs: the
    CTAs of a cluster, each a chunk of the live range of 64 token-major
    query rows, enough for two CTAs an SM (as many as fit on a float
    pool; the launch lowers `splits` where fewer clusters fit, as on an
    int8 pool), at most a portable cluster, no more than the table span
    holds tiles. From shapes only, never from start."""
    ctas = b * hkv * math.ceil(t_q * (hq // hkv) / _TILE)
    want = math.ceil(2 * sms / ctas)
    return max(1, min(want, _MAX_CLUSTER, math.ceil(mb * bs / _TILE)))


def _prefill_lo_hi(p0: int, t_q: int, block_size: int, window: int | None):
    """First/last live table column (inclusive) of a prefill window of
    `t_q` tokens at absolute positions p0 .. p0 + t_q - 1, as the TPU
    kernel's `_prefill_lo_hi`: the last token attends through column
    (p0 + t_q - 1) // bs, the first back to max(p0 - window + 1, 0)."""
    hi = (p0 + t_q - 1) // block_size
    lo = max(p0 - window + 1, 0) // block_size if window is not None else 0
    return lo, hi


def _live_span(start: int, r0: int, group: int, t_q: int, bs: int, mb: int,
               window: int | None, splits: int):
    """`live_span` of the CUDA source for the 64 token-major rows of the
    CTA at r0: the first and last live column (c0 on a block edge), the
    64-column tiles between them, and the tiles one rank of a cluster of
    `splits` takes (at least `_MIN_CHUNK`, so a shallow chunk is one
    rank's and merges nothing)."""
    t_first = r0 // group
    t_last = min((r0 + _TILE - 1) // group, t_q - 1)
    hi = min(start + t_last, mb * bs - 1)
    lo = max(start + t_first - window + 1, 0) if window is not None else 0
    c0 = lo // bs * bs
    ntiles = max(1, (hi - c0) // _TILE + 1)
    return c0, hi, ntiles, max(_MIN_CHUNK, math.ceil(ntiles / splits))


def _split_columns(start: int, r0: int, group: int, t_q: int, bs: int,
                   mb: int, window: int | None, splits: int):
    """The columns [first, last] each rank of the cluster at r0 walks,
    for the ranks that have tiles: rank s takes tiles s * chunk ..
    (s + 1) * chunk - 1 (rank 0 always has one); columns past hi weigh
    nothing. The cluster's merge reads exactly these ranks' states (with
    one such rank, it writes O itself and nothing merges). The launch
    may lower `splits` until every cluster is resident; the cut is the
    same for any value."""
    c0, hi, ntiles, chunk = _live_span(start, r0, group, t_q, bs, mb,
                                       window, splits)
    return [(c0 + s * chunk * _TILE,
             min(c0 + (s + 1) * chunk * _TILE - 1, hi))
            for s in range(splits) if s * chunk < ntiles]


def _check(q, pool_k, pool_v, tables, window) -> None:
    if q.ndim != 4:
        raise ValueError(f"expected q (B, Hq, T, Dh), got {tuple(q.shape)}")
    _check_pool(q, pool_k, pool_v, tables, "q")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be None or >= 1")


def paged_flash_prefill_plain(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    tables: torch.Tensor,
    start,
    *,
    window: int | None = None,
    num_blocks: int | None = None,
    scale_k: torch.Tensor | None = None,
    scale_v: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, as the JAX package's
    `_blockwise_attend_mt` computes it: table columns 0..num_blocks-1
    fold one at a time into f32 (m, l, acc) per query row, each row
    masked at its own position start + t; an int8 pool's blocks are
    widened to f32 and times their scales as they are gathered.
    `num_blocks` defaults to the deepest row's live block + 1 for CPU
    tensors (read on the host) and to the whole table elsewhere. Returns
    [B, Hq, T, Dh] in q's dtype."""
    _check(q, pool_k, pool_v, tables, window)
    _check_scales(pool_k, pool_v, scale_k, scale_v)
    b, hq, t, dh = q.shape
    hkv, bs = pool_k.shape[1], pool_k.shape[2]
    mb = tables.shape[1]
    g = hq // hkv
    startv = _positions(start, b, q.device)
    if num_blocks is None:
        num_blocks = (
            folded_blocks(startv, t, bs, mb) if q.device.type == "cpu" else mb
        )
    qg = q.float().reshape(b, hkv, g, t, dh) * dh**-0.5
    qpos = startv[:, None] + torch.arange(t, device=q.device)  # [B, T]
    m = torch.full((b, hkv, g, t), _MASK_VALUE, device=q.device)
    l = torch.zeros((b, hkv, g, t), device=q.device)
    acc = torch.zeros((b, hkv, g, t, dh), device=q.device)
    span = torch.arange(bs, device=q.device)
    for j in range(num_blocks):
        blk = tables[:, j].long()
        k = _pool_rows(pool_k, scale_k, blk)  # [B, Hkv, bs, Dh]
        v = _pool_rows(pool_v, scale_v, blk)
        s = torch.einsum("bkgtd,bksd->bkgts", qg, k)
        cols = j * bs + span
        live = cols[None, None, :] <= qpos[:, :, None]  # [B, T, bs]
        if window is not None:
            live &= cols[None, None, :] > qpos[:, :, None] - window
        s = s.masked_fill(~live[:, None, None, :, :], _MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgts,bksd->bkgtd", p, v
        )
        m = m_new
    out = acc / l[..., None]  # [B, Hkv, G, T, Dh]
    return out.to(q.dtype).reshape(b, hq, t, dh)


@functools.cache
def _kernel():
    """The built library's entry point, typed once."""
    from defer_tpu_torch.utils.nvcc import load_library

    fn = load_library(_SOURCE).defer_paged_flash_prefill
    fn.restype = ctypes.c_int
    fn.argtypes = [
        # q, pool_k, pool_v, o, tables, scale_k, scale_v, start
        *[ctypes.c_void_p] * 8, ctypes.c_longlong,
        # dtype, pool_dtype, batch, hq, hkv, t_q, nb, bs, mb, dh
        *[ctypes.c_int] * 10,
        ctypes.POINTER(ctypes.c_longlong),
        # window, splits
        *[ctypes.c_int] * 2,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return fn


_runs, card_runs, reset_card_runs = run_counter("paged_flash_prefill")


@functools.lru_cache(maxsize=256)
def _launch_plan(q_shape, q_stride, pool_shape, k_stride, v_stride,
                 tables_stride0, mb, scale_strides, dtypes, device):
    """What a launch needs beyond the pointers, checked and computed
    once per shape: (splits, element strides as a ctypes array, the pool
    dtype code). Raises on what the kernel does not take."""
    b, hq, t, dh = q_shape
    hkv, bs = pool_shape[1], pool_shape[2]
    pool_code = _pool_code("paged flash-prefill", dtypes)
    if dh not in _HEAD_DIMS:
        raise ValueError(
            f"the CUDA paged flash-prefill kernel takes Dh in {_HEAD_DIMS}, "
            f"got {dh}"
        )
    # Rows are read 16 bytes at a time, and a 16-bit or int8 pool by TMA,
    # whose strides must be multiples of 16 bytes and not 0 along a
    # dimension longer than 1.
    for name, stride, dtype in (("q", q_stride, dtypes[0]),
                                ("pool_k", k_stride, dtypes[1]),
                                ("pool_v", v_stride, dtypes[2])):
        if stride[-1] != 1:
            raise ValueError(f"{name} needs a unit Dh stride")
        if any(st * dtype.itemsize % 16 for st in stride[:-1]):
            raise ValueError(f"{name} rows are not 16-byte aligned")
    if any(st == 0 and n > 1 for stride in (k_stride, v_stride)
           for st, n in zip(stride[:3], pool_shape[:3])):
        raise ValueError("pool_k/pool_v need a nonzero stride along every "
                         "dimension longer than 1")
    # f32 q runs the FMA loop: one CTA a row tile, no cluster.
    splits = 1 if dtypes[0] == torch.float32 else _prefill_plan(
        _sm_count(device.index or 0), b, hq, hkv, t, bs, mb
    )
    # The output is [B, T, Hq, Dh], contiguous.
    strides = (ctypes.c_longlong * 17)(
        *q_stride[:3], *k_stride[:3], *v_stride[:3], tables_stride0,
        t * hq * dh, dh, hq * dh, *scale_strides,
    )
    return splits, strides, pool_code


def _prefill_cuda(q, pool_k, pool_v, tables, start, window, scale_k,
                  scale_v) -> torch.Tensor:
    """Launch the sm_90a kernel on q's current stream; tables, start and
    the scales stay on the card."""
    b, hq, t, dh = q.shape
    device = q.device
    if not (device == pool_k.device == pool_v.device == tables.device):
        raise ValueError(
            f"q/pool/tables on different devices: {q.device}/"
            f"{pool_k.device}/{pool_v.device}/{tables.device}"
        )
    if tables.dtype != torch.int32 or tables.stride(1) != 1:
        tables = tables.to(torch.int32).contiguous()  # on the card
    if isinstance(start, int):
        start = torch.full((b,), start, dtype=torch.int32, device=device)
    if start.device != device:
        raise ValueError(f"start on {start.device}, q on {device}")
    if start.ndim > 1 or (start.ndim == 1 and start.shape[0] != b):
        raise ValueError(
            f"start must be () or ({b},), got {tuple(start.shape)}"
        )
    if start.dtype != torch.int32:
        start = start.to(torch.int32)  # on the card: no host sync
    splits, strides, pool_code = _launch_plan(
        tuple(q.shape), q.stride(), tuple(pool_k.shape), pool_k.stride(),
        pool_v.stride(), tables.stride(0), tables.shape[1],
        _scale_strides(scale_k, scale_v),
        (q.dtype, pool_k.dtype, pool_v.dtype), device,
    )
    # Token-major rows land in [B, T, Hq, Dh]; the caller gets the
    # [B, Hq, T, Dh] view, whose transpose back is free.
    out = torch.empty((b, t, hq, dh), dtype=q.dtype, device=device)
    if any(x.data_ptr() % 16 for x in (q, pool_k, pool_v)):
        raise ValueError("q/pool rows are not 16-byte aligned")
    quantized = scale_k is not None
    rc = _kernel()(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), out.data_ptr(),
        tables.data_ptr(), scale_k.data_ptr() if quantized else None,
        scale_v.data_ptr() if quantized else None, start.data_ptr(),
        start.stride(0) if start.ndim == 1 else 0,
        _DTYPE_CODE[q.dtype], pool_code, b, hq, pool_k.shape[1], t,
        pool_k.shape[0], pool_k.shape[2], tables.shape[1], dh, strides,
        0 if window is None else int(window), splits, dh**-0.5,
        device.index, torch.cuda.current_stream(device).cuda_stream,
        _runs(device.index).data_ptr(),
    )
    if rc != 0:
        raise RuntimeError(
            f"paged flash-prefill kernel launch failed with CUDA error {rc} "
            f"for q {tuple(q.shape)} {q.dtype}, pool {tuple(pool_k.shape)} "
            f"{pool_k.dtype}, tables {tuple(tables.shape)}, window={window}"
        )
    if quantized:
        paged_flash_prefill.launches_int8 += 1
    else:
        paged_flash_prefill.launches += 1
    return out.transpose(1, 2)


def paged_flash_prefill(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    tables: torch.Tensor,
    start,
    *,
    window: int | None = None,
    scale_k: torch.Tensor | None = None,
    scale_v: torch.Tensor | None = None,
) -> torch.Tensor:
    """T query tokens per slot against its block table: q [B, Hq, T, Dh]
    at absolute positions start .. start + T - 1, pool_k/pool_v
    [NB, Hkv, bs, Dh] (one layer, the window's own rows already written),
    tables [B, MB] int (unallocated entries = trash block 0), start [B]
    (or a scalar, broadcast) int. Returns [B, Hq, T, Dh] in q's dtype.
    An int8 pool needs scale_k/scale_v, float32 [NB, Hkv] on the pool's
    device (pass both or neither).

    CUDA tensors run the hand-written kernel (any T, bs and G >= 1, Dh
    in 32/64/128, float32/float16/bfloat16 q) and raise on what it does
    not take; CPU and meta tensors run `paged_flash_prefill_plain`.
    `paged_flash_prefill.launches` counts calls that launch the kernel
    (one kernel a call, its split-K merge inside) on a float pool,
    `paged_flash_prefill.launches_int8` those on an int8 pool. Both are
    host counts; `card_runs` counts the kernel's runs on the card,
    graph replays included."""
    _check(q, pool_k, pool_v, tables, window)
    _check_scales(pool_k, pool_v, scale_k, scale_v)
    if q.device.type == "cuda":
        return _prefill_cuda(q, pool_k, pool_v, tables, start, window,
                             scale_k, scale_v)
    if q.device.type in ("cpu", "meta"):
        return paged_flash_prefill_plain(q, pool_k, pool_v, tables, start,
                                         window=window, scale_k=scale_k,
                                         scale_v=scale_v)
    raise ValueError(
        f"paged flash prefill has no path for device {q.device}: CUDA "
        "launches the kernel, CPU and meta take the plain version"
    )


paged_flash_prefill.launches = 0
paged_flash_prefill.launches_int8 = 0
