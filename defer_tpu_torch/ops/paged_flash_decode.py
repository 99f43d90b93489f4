"""Paged flash decode: a hand-written Hopper kernel and its plain version.

Replaces the TPU kernel `defer_tpu/ops/pallas_attention.py`
(`paged_flash_decode`, body `_paged_decode_kernel`, live range
`_decode_lo_hi`): one query token per slot attending its BLOCK TABLE.
q [B, Hq, Dh] attends one layer of the shared block pool, pool_k/pool_v
[NB, Hkv, bs, Dh], where row r of slot b is row r % bs of pool block
tables[b, r // bs]; the columns are masked to `col <= pos[b]` and, with
a window, `col > pos[b] - window`. Unallocated table entries point at
the trash block 0 (runtime/paged.py); they lie past `pos` and are never
read. q is pre-scaled by Dh**-0.5 in f32, the softmax runs in f32 with
the finite `_MASK_VALUE`, and the output acc / l is cast to q's dtype.

What bounds it on an H100: the bytes of the live K/V rows, as for
`flash_decode`, and at the tick's depths the latency of a call. For
bf16/f16 q, `csrc/paged_flash_decode.cu` runs the tensor-core decode
engine of `csrc/decode_tile.cuh` with the table indirection: the kernel
reads `pos[b]` and the table on the card (no host sync, so both may
live there, as the paged server keeps them), works out the live range
[max(pos - window + 1, 0), pos] in rows, and a cluster of C CTAs
(`_cluster_size` of the table span MB * bs) per (slot, KV head, 16
query rows) takes equal shares of its 64-row tiles; each warp stages
16-row slices by cp.async (3 stages on a float pool, 4 on an int8
pool), loading the table entries of the next slice while one is in
flight, and the CTAs' states merge through distributed shared memory in
the same kernel: one launch a call. A dead table column is never
fetched, the property the TPU kernel's clamped index maps give.
`_warp_slices` and `_table_reads` mirror the split and the reads.

The pool is q's dtype, or int8 with per-(block, head) f32 scales
`scale_k`/`scale_v` [NB, Hkv] (runtime/paged.py `kv_dtype="int8"`), the
TPU kernel's `quantized` path: a row is its int8 payload times its
block's scale. The kernel copies the int8 payload as it
is (half the bytes), widens each slice once into q's type (exact),
reads a block's two scales once per slice that touches it, and folds
them per column into the scores and the probabilities; no dequantized
copy of the pool is ever made. f32 q keeps an FMA kernel (`_f32_chunks`
mirrors its split).

Dispatch follows the tensor's device and nothing else: a CUDA tensor
launches the kernel or raises; a CPU or meta tensor takes the plain
version, the JAX package's `_blockwise_attend` fold (one table column at
a time into an f32 online softmax, an int8 block widened to f32 and
scaled as it is gathered).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from defer_tpu_torch.ops.flash_decode import (  # noqa: F401 (_decode_lo_hi)
    _DTYPE_CODE,
    _HEAD_DIMS,
    _MASK_VALUE,
    _cluster_size,
    _decode_lo_hi,
    _warp_slices,
    run_counter,
)

_SOURCE = "paged_flash_decode.cu"
# The kernels' code for an int8 pool (beside _DTYPE_CODE's float codes).
_INT8_POOL = 3


def _check_pool(q, pool_k, pool_v, tables, what: str) -> None:
    if pool_k.ndim != 4 or pool_k.shape != pool_v.shape:
        raise ValueError(
            f"pool_k/pool_v must be [NB, Hkv, bs, Dh] alike, got "
            f"{tuple(pool_k.shape)} and {tuple(pool_v.shape)}"
        )
    if pool_k.shape[3] != q.shape[-1]:
        raise ValueError(
            f"{what} {tuple(q.shape)} and pool {tuple(pool_k.shape)} "
            "disagree on head dim"
        )
    if q.shape[1] % pool_k.shape[1]:
        raise ValueError(
            f"Hq={q.shape[1]} must be a multiple of Hkv={pool_k.shape[1]}"
        )
    if tables.ndim != 2 or tables.shape[0] != q.shape[0]:
        raise ValueError(
            f"tables must be [B={q.shape[0]}, MB], got {tuple(tables.shape)}"
        )


def _check_scales(pool_k, pool_v, scale_k, scale_v) -> bool:
    """Validate the int8 pool's scales against the pool; returns whether
    the pool is quantized."""
    if (scale_k is None) != (scale_v is None):
        raise ValueError("pass both scale_k and scale_v, or neither")
    int8_pool = pool_k.dtype == torch.int8 or pool_v.dtype == torch.int8
    if scale_k is None:
        if int8_pool:
            raise ValueError(
                "an int8 pool needs its per-(block, head) scale_k/scale_v"
            )
        return False
    if not (pool_k.dtype == pool_v.dtype == torch.int8):
        raise ValueError(
            f"scale_k/scale_v go with an int8 pool, got pool "
            f"{pool_k.dtype}/{pool_v.dtype}"
        )
    want = tuple(pool_k.shape[:2])
    for name, sc in (("scale_k", scale_k), ("scale_v", scale_v)):
        if tuple(sc.shape) != want or sc.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 [NB, Hkv] = {list(want)}, got "
                f"{sc.dtype} {list(sc.shape)}"
            )
        if sc.device != pool_k.device:
            raise ValueError(f"{name} on {sc.device}, pool on "
                             f"{pool_k.device}")
    return True


def _pool_rows(pool, scale, blk) -> torch.Tensor:
    """Pool blocks `blk` widened to f32, an int8 block times its
    scale: the JAX package's `_pool_gather(pool_l, blk, float32)`."""
    rows = pool[blk].float()
    return rows if scale is None else rows * scale[blk][..., None, None]


def _check(q, pool_k, pool_v, tables, window) -> None:
    if q.ndim != 3:
        raise ValueError(f"expected q (B, Hq, Dh), got {tuple(q.shape)}")
    _check_pool(q, pool_k, pool_v, tables, "q")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be None or >= 1")


def _positions(pos, b: int, device) -> torch.Tensor:
    """pos as a (B,) tensor on `device` (an int or a 0-d tensor
    broadcasts)."""
    return torch.as_tensor(pos, device=device).reshape(-1).expand(b)


def folded_blocks(pos: torch.Tensor, t: int, bs: int, mb: int) -> int:
    """Table columns a fold must visit so that every slot's deepest
    query row (pos + t - 1) is covered: the JAX package's traced
    `nb_live` bound. Reads pos on the host."""
    return min(int(pos.max()) + t - 1, mb * bs - 1) // bs + 1


def paged_flash_decode_plain(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    tables: torch.Tensor,
    pos,
    *,
    window: int | None = None,
    num_blocks: int | None = None,
    scale_k: torch.Tensor | None = None,
    scale_v: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, as the JAX package's
    `_blockwise_attend` computes it: table columns 0..num_blocks-1 fold
    one at a time into f32 (m, l, acc) with `_MASK_VALUE` on masked
    columns, one cast at the end; an int8 pool's blocks are widened to
    f32 and times their scales as they are gathered. Columns past a
    slot's live range add exactly nothing. `num_blocks` defaults to the
    deepest slot's live block + 1 for CPU tensors (read on the host) and
    to the whole table elsewhere. Returns [B, Hq, Dh] in q's dtype."""
    _check(q, pool_k, pool_v, tables, window)
    _check_scales(pool_k, pool_v, scale_k, scale_v)
    b, hq, dh = q.shape
    hkv, bs = pool_k.shape[1], pool_k.shape[2]
    mb = tables.shape[1]
    g = hq // hkv
    posv = _positions(pos, b, q.device)
    if num_blocks is None:
        num_blocks = (
            folded_blocks(posv, 1, bs, mb) if q.device.type == "cpu" else mb
        )
    qg = q.float().reshape(b, hkv, g, dh) * dh**-0.5
    m = torch.full((b, hkv, g), _MASK_VALUE, device=q.device)
    l = torch.zeros((b, hkv, g), device=q.device)
    acc = torch.zeros((b, hkv, g, dh), device=q.device)
    span = torch.arange(bs, device=q.device)
    for j in range(num_blocks):
        blk = tables[:, j].long()
        k = _pool_rows(pool_k, scale_k, blk)  # [B, Hkv, bs, Dh]
        v = _pool_rows(pool_v, scale_v, blk)
        s = torch.einsum("bkgd,bksd->bkgs", qg, k)
        cols = j * bs + span
        live = cols[None, :] <= posv[:, None]  # [B, bs]
        if window is not None:
            live &= cols[None, :] > posv[:, None] - window
        s = s.masked_fill(~live[:, None, None, :], _MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgs,bksd->bkgd", p, v)
        m = m_new
    out = acc / l[..., None]
    return out.to(q.dtype).reshape(b, hq, dh)


@functools.cache
def _kernel():
    """The built library's entry point, typed once."""
    from defer_tpu_torch.utils.nvcc import load_library

    fn = load_library(_SOURCE).defer_paged_flash_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [
        # q, pool_k, pool_v, o, tables, scale_k, scale_v, pos
        *[ctypes.c_void_p] * 8,
        ctypes.c_longlong,
        # dtype, pool_dtype, batch, hq, hkv, bs, mb, dh
        *[ctypes.c_int] * 8,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return fn


_runs, card_runs, reset_card_runs = run_counter("paged_flash_decode")


def _table_reads(lo: int, hi: int, bs: int, cluster: int) -> dict:
    """What the tensor-core kernel reads of a slot's table and scales:
    {(rank, warp): [(table columns whose entries it loads, table
    columns whose scales it loads), ...]}, one pair a slice. Lane r of
    the warp loads the entry of the slice's row r when that row is live
    (rows of one block share the address), and the scales where row r is
    the first row of its block in the slice."""
    out = {}
    for key, rows in _warp_slices(lo, hi, cluster).items():
        out[key] = [
            (sorted({r // bs for r in range(first, last + 1)}),
             [r // bs for r in range(first, last + 1)
              if r == first or r % bs == 0])
            for first, last in rows
        ]
    return out


def _pool_code(kernel: str, dtypes) -> int:
    """The kernels' pool dtype code: q's own (q, pool_k and pool_v of
    one float dtype) or `_INT8_POOL`. Raises on what they do not take."""
    q_dtype, k_dtype, v_dtype = dtypes
    if q_dtype in _DTYPE_CODE and k_dtype == v_dtype:
        if k_dtype == q_dtype:
            return _DTYPE_CODE[q_dtype]
        if k_dtype == torch.int8:
            return _INT8_POOL
    raise TypeError(
        f"the CUDA {kernel} kernel takes float32, float16 or bfloat16 q "
        "with a pool of q's dtype or of int8; got "
        f"{'/'.join(map(str, dtypes))}"
    )


def _scale_strides(scale_k, scale_v) -> tuple:
    """(block, head) element strides of both scales; zeros without."""
    if scale_k is None:
        return (0, 0, 0, 0)
    return (*scale_k.stride(), *scale_v.stride())


@functools.lru_cache(maxsize=256)
def _launch_plan(q_shape, q_stride, pool_shape, k_stride, v_stride,
                 tables_stride, scale_strides, dtypes):
    """What a launch needs beyond the pointers, checked and computed
    once per shape: (cluster size, element strides as a ctypes array, the pool
    dtype code, q's and the pool's row alignment in bytes). Raises on
    what the kernel does not take."""
    hq, dh = q_shape[1:]
    bs = pool_shape[2]
    mb = tables_stride[1]
    pool_code = _pool_code("paged flash-decode", dtypes)
    if dh not in _HEAD_DIMS:
        raise ValueError(
            f"the CUDA paged flash-decode kernel takes Dh in {_HEAD_DIMS}, "
            f"got {dh}"
        )
    # 16-bit q: q and pool rows are copied 16 bytes at a time; f32 q: a
    # lane loads Dh / 32 consecutive elements of a row at once.
    if dtypes[0].itemsize == 2:
        aligns = (16, 16)
    else:
        aligns = tuple(min(16, dh // 32 * dt.itemsize) for dt in dtypes[:2])
    for name, stride, dtype, align in (
        ("q", q_stride, dtypes[0], aligns[0]),
        ("pool_k", k_stride, dtypes[1], aligns[1]),
        ("pool_v", v_stride, dtypes[2], aligns[1]),
    ):
        if stride[-1] != 1:
            raise ValueError(f"{name} needs a unit Dh stride")
        if any(st * dtype.itemsize % align for st in stride[:-1]):
            raise ValueError(f"{name} rows are not {align}-byte aligned")
    strides = (ctypes.c_longlong * 15)(
        q_stride[0], q_stride[1], *k_stride[:3], *v_stride[:3],
        tables_stride[0], hq * dh, dh, *scale_strides,
    )
    return _cluster_size(mb * bs), strides, pool_code, aligns


def _decode_cuda(q, pool_k, pool_v, tables, pos, window, scale_k,
                 scale_v) -> torch.Tensor:
    """Launch the sm_90a kernel on q's current stream; tables, pos and
    the scales stay on the card."""
    b, hq, dh = q.shape
    if not (q.device == pool_k.device == pool_v.device == tables.device):
        raise ValueError(
            f"q/pool/tables on different devices: {q.device}/"
            f"{pool_k.device}/{pool_v.device}/{tables.device}"
        )
    if tables.dtype != torch.int32 or tables.stride(1) != 1:
        tables = tables.to(torch.int32).contiguous()  # on the card
    cluster, strides, pool_code, (q_align, pool_align) = _launch_plan(
        tuple(q.shape), q.stride(), tuple(pool_k.shape), pool_k.stride(),
        pool_v.stride(), (tables.stride(0), tables.shape[1]),
        _scale_strides(scale_k, scale_v),
        (q.dtype, pool_k.dtype, pool_v.dtype),
    )
    if q.data_ptr() % q_align or any(
        t.data_ptr() % pool_align for t in (pool_k, pool_v)
    ):
        raise ValueError("q/pool rows are not aligned for the kernel's loads")
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
    quantized = scale_k is not None
    args = (
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), out.data_ptr(),
        tables.data_ptr(), scale_k.data_ptr() if quantized else None,
        scale_v.data_ptr() if quantized else None, pos.data_ptr(),
        pos_stride, _DTYPE_CODE[q.dtype], pool_code, b,
        hq, pool_k.shape[1], pool_k.shape[2], tables.shape[1], dh, strides,
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
            f"paged flash-decode kernel launch failed with CUDA error {rc} "
            f"for q {tuple(q.shape)} {q.dtype}, pool {tuple(pool_k.shape)} "
            f"{pool_k.dtype}, tables {tuple(tables.shape)}, window={window}"
        )
    if quantized:
        paged_flash_decode.launches_int8 += 1
    else:
        paged_flash_decode.launches += 1
    return out


def paged_flash_decode(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    tables: torch.Tensor,
    pos,
    *,
    window: int | None = None,
    scale_k: torch.Tensor | None = None,
    scale_v: torch.Tensor | None = None,
) -> torch.Tensor:
    """One query token per slot against its block table: q [B, Hq, Dh],
    pool_k/pool_v [NB, Hkv, bs, Dh] (one layer of the pool), tables
    [B, MB] int pool indices (unallocated entries = trash block 0), pos
    [B] (or a scalar, broadcast) int, each slot's last valid key,
    inclusive and >= 0. Returns [B, Hq, Dh] in q's dtype. An int8 pool
    needs scale_k/scale_v, float32 [NB, Hkv] on the pool's device (pass
    both or neither); a float pool is q's dtype and takes none.

    CUDA tensors run the hand-written kernel (any bs >= 1 and G >= 1,
    Dh in 32/64/128, float32/float16/bfloat16 q) and raise on what it
    does not take; CPU and meta tensors run `paged_flash_decode_plain`.
    `paged_flash_decode.launches` counts kernel launches on a float pool,
    `paged_flash_decode.launches_int8` those on an int8 pool. Both are
    host counts; `card_runs` counts the kernel's runs on the card,
    graph replays included."""
    _check(q, pool_k, pool_v, tables, window)
    _check_scales(pool_k, pool_v, scale_k, scale_v)
    if q.device.type == "cuda":
        return _decode_cuda(q, pool_k, pool_v, tables, pos, window, scale_k,
                            scale_v)
    if q.device.type in ("cpu", "meta"):
        return paged_flash_decode_plain(q, pool_k, pool_v, tables, pos,
                                        window=window, scale_k=scale_k,
                                        scale_v=scale_v)
    raise ValueError(
        f"paged flash decode has no path for device {q.device}: CUDA "
        "launches the kernel, CPU and meta take the plain version"
    )


paged_flash_decode.launches = 0
paged_flash_decode.launches_int8 = 0
