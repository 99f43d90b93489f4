"""Flash attention: a hand-written Hopper kernel and its plain version.

Replaces the TPU kernel `defer_tpu/ops/pallas_attention.py`
(`_flash_fwd_impl`, body `_mha_kernel`, public `flash_attention`):
softmax attention on (B, H, S, Dh) tensors, q pre-scaled by Dh**-0.5 in
f32, an online-softmax recurrence over K tiles with f32 m/l/acc, an
optional causal mask with the same finite `_MASK_VALUE`, and the output
`acc / l` cast to q's dtype.

What bounds it on an H100: at BERT-base's shape (B=16, H=12, S=128,
Dh=64, bf16) the call moves 12.6 MB (q, k, v, o once each) and does
0.81 GFLOP, i.e. 3.8 us at 3.35 TB/s against 0.8 us at 989 TFLOP/s:
memory-bound, once the products run on the tensor cores. The design
keeps the S x S scores out of device memory, as the TPU kernel did, and
is built for Hopper (`csrc/attn_wgmma.cuh`): a CTA is one warpgroup of
64 query rows; Q, K, V and O move by TMA on 4-D tensor maps (Dh, S, H,
B) over the caller's strides, K/V through a ring of two stages with
mbarriers, issued by one elected thread; S = Q K^T and O += P V are
asynchronous `wgmma`, tile t's scores issued with tile t - 1's P V and
both retired before tile t's softmax, while the SM's other CTAs keep the
tensor cores busy. Every K tile is scored 64 columns wide, the columns
past S masked; causal query tiles run heaviest first. The wrapper plans
that tiling (`launch_plan`) and the launch takes it.
The scores are scaled by Dh**-0.5 in f32; P is rounded to q's type
before P V, as the TPU kernel's f32 dots, one bf16 MXU pass at default
precision, round their operands. f32 inputs keep an f32 FMA loop,
chosen by dtype: the tensor cores take f32 only as TF32, which misses
the f32 tolerance. `csrc/flash_attention.cu` has the layout.

Dispatch follows the tensor's device and nothing else: a CUDA tensor
launches the kernel or raises; a CPU or meta tensor takes the plain
version. There is no fallback from the kernel to the plain path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

# Finite stand-in for -inf, as the TPU kernel's (pallas_attention.py).
_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

_SOURCE = "flash_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool):
    # Plain tuples: comparing torch.Size objects costs microseconds a call.
    qs, ks, vs = tuple(q.shape), tuple(k.shape), tuple(v.shape)
    if len(qs) != 4:
        raise ValueError(f"expected (B, H, S, Dh), got {qs}")
    if ks != vs or len(ks) != 4:
        raise ValueError(f"k/v must be (B, H, S_k, Dh) alike: {ks} vs {vs}")
    if ks[:2] != qs[:2] or ks[3] != qs[3]:
        raise ValueError(
            f"q {qs} and k {ks} disagree on batch, heads or head dim"
        )
    if causal and qs[2] != ks[2]:
        raise ValueError("causal flash attention requires s_q == s_k")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 scores and
    probabilities, one cast at the end. Unlike `attention_reference`,
    which casts the weights to v's dtype before the second product."""
    _check(q, k, v, causal)
    dh = q.shape[-1]
    qf = q.float() * dh**-0.5
    s = torch.einsum("bhqd,bhkd->bhqk", qf, k.float())
    if causal:
        n = q.shape[2]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return (out / p.sum(dim=-1, keepdim=True)).to(q.dtype)


# The card kernel's tile: wgmma's 64 query rows a consumer warpgroup, 64
# key columns a K/V tile, 64 head-dim columns a TMA box (panel).
_ROWS = _COLS = _PANEL = 64


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the card kernel tiles a float16 / bfloat16 call of (s_q, s_k,
    Dh, causal). `_flash_cuda` hands the first four fields to the C entry,
    which sizes the grid and the K loop from them.

    panels: 64-column TMA boxes of the head dim (1 up to Dh 64, else 2),
      which pick the kernel's instantiation; both products run over all
      64 * panels columns (zeros past Dh).
    q_tiles: 64-row query tiles, the grid's y extent.
    k_tiles: 64-column K/V tiles an unmasked query tile walks; every one
      is scored at N = 64, the last one's columns past s_k masked out.
    heaviest_first: blockIdx.y 0 takes the last query tile, the one that
      walks the most K tiles under the causal mask (set for causal calls).
    ctas: (first query row, K tiles walked) of each blockIdx.y in launch
      order, as the kernel derives them from the fields above.
    work_ratio: the query-key products the tiles compute over the ones
      the call needs (s_q x s_k, or the causal triangle with its
      diagonal); derived from the tiling, not measured.
    """

    panels: int
    q_tiles: int
    k_tiles: int
    heaviest_first: bool
    ctas: tuple[tuple[int, int], ...]
    work_ratio: float


@functools.lru_cache(maxsize=1024)
def launch_plan(s_q: int, s_k: int, dh: int, causal: bool) -> LaunchPlan:
    """The card kernel's tiling of a call (cached: the wrapper computes it
    on every launch)."""
    q_tiles = -(-s_q // _ROWS)
    k_tiles = -(-s_k // _COLS)
    order = range(q_tiles - 1, -1, -1) if causal else range(q_tiles)
    ctas = tuple(
        (y * _ROWS, min(k_tiles, y + 1) if causal else k_tiles)
        for y in order
    )
    computed = sum(_ROWS * _COLS * n_k for _, n_k in ctas)
    needed = s_q * (s_q + 1) // 2 if causal else s_q * s_k
    return LaunchPlan(
        panels=1 if dh <= _PANEL else 2,
        q_tiles=q_tiles,
        k_tiles=k_tiles,
        heaviest_first=causal,
        ctas=ctas,
        work_ratio=computed / needed,
    )


@functools.cache
def _kernel():
    """The built library's entry point, typed once."""
    from defer_tpu_torch.utils.nvcc import load_library

    fn = load_library(_SOURCE).defer_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def _flash_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
) -> torch.Tensor:
    """Launch the sm_90a kernel on q's current stream. Inputs may be
    strided views (the head split of a (B, S, H*Dh) projection) as long
    as Dh is the unit-stride dim; the output is laid out (B, S, H, Dh)
    in memory, so merging the heads back is a free view."""
    b, h, s_q, dh = q.shape
    s_k = k.shape[2]
    dtype, device = q.dtype, q.device
    code = _DTYPE_CODE.get(dtype)
    if code is None or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(
            "the CUDA flash kernel takes float32, float16 or bfloat16 "
            f"q/k/v of one dtype; got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if dh % 8 or not 8 <= dh <= 128:
        raise ValueError(
            f"the CUDA flash kernel takes Dh a multiple of 8 up to 128, "
            f"got {dh}"
        )
    if k.device != device or v.device != device:
        raise ValueError(
            f"q/k/v on different devices: {q.device}/{k.device}/{v.device}"
        )
    # One pass over each tensor's strides (ints, not tensor calls): the
    # wrapper's host time is the BERT stream's bottleneck.
    strides = []
    for t in (q, k, v):
        st = t.stride()
        if st[3] != 1:
            raise ValueError("the CUDA flash kernel needs a unit Dh stride")
        if code:
            # 16-bit tensors are read by TMA: rows and strides on 16
            # bytes, none of the strides 0 along a dimension it steps.
            if t.data_ptr() % 16 or (st[0] | st[1] | st[2]) % 8:
                raise ValueError(
                    "the CUDA flash kernel needs float16/bfloat16 rows that "
                    "start on 16 bytes"
                )
            if 0 in st[:3] and any(
                n > 1 and d == 0 for n, d in zip(t.shape[:3], st[:3])
            ):
                raise ValueError(
                    "the CUDA flash kernel needs a nonzero stride along "
                    "every batch, head and sequence dimension longer than 1"
                )
        strides += st[:3]
    fn = _kernel()
    # O is laid out (B, S, H, Dh) in memory: strides (S*H*Dh, Dh, H*Dh).
    out = torch.empty(
        (b, s_q, h, dh), dtype=dtype, device=device
    ).transpose(1, 2)
    strides += (s_q * h * dh, dh, h * dh)
    plan = launch_plan(s_q, s_k, dh, causal)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        code, b, h, s_q, s_k, dh, (ctypes.c_longlong * 12)(*strides),
        dh**-0.5, int(causal), plan.panels, plan.q_tiles, plan.k_tiles,
        int(plan.heaviest_first), device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed with CUDA error {rc} "
            f"for q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, "
            f"causal={causal}"
        )
    flash_attention.launches += 1
    return out


def _flash_forward(q, k, v, causal: bool) -> torch.Tensor:
    _check(q, k, v, causal)
    if q.device.type == "cuda":
        return _flash_cuda(q, k, v, causal)
    if q.device.type in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, causal=causal)
    raise ValueError(
        f"flash attention has no path for device {q.device}: CUDA "
        "launches the kernel, CPU and meta take the plain version"
    )


class _Flash(torch.autograd.Function):
    """Forward through the kernel; backward recomputes attention with
    the plain version and differentiates that, as the TPU version's
    custom VJP does with its reference (there is no backward kernel on
    either side). Only q/k/v are saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _flash_forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = flash_attention_plain(*leaves, causal=ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
) -> torch.Tensor:
    """Flash attention on (B, H, S, Dh) tensors; returns (B, H, S, Dh).

    CUDA tensors run the hand-written kernel (any S >= 1, Dh a multiple
    of 8 up to 128, float32/float16/bfloat16) and raise on what it does
    not take; CPU and meta tensors run `flash_attention_plain`.
    `flash_attention.launches` counts kernel launches. Where no input
    needs a gradient the call skips the autograd node (about 10 us of
    host time a call)."""
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        return _Flash.apply(q, k, v, causal)
    return _flash_forward(q, k, v, causal)


flash_attention.launches = 0
