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
keeps the S x S scores out of device memory, as the TPU kernel did: one
CTA of 4 warps per (batch*head, 64-row q tile), K/V tiles of 64 rows
copied into shared memory in q's own type by cp.async, double-buffered,
and S = Q K^T and O += P V on `mma.sync` bf16/f16 -> f32 with the
online softmax in registers (`csrc/attn_tile.cuh`). The scores are
scaled by Dh**-0.5 in f32; P is rounded to q's type before P V, as the
TPU kernel's f32 dots, one bf16 MXU pass at default precision, round
their operands. f32 inputs keep an f32 FMA loop, chosen by dtype: the
tensor cores take f32 only as TF32, which misses the f32 tolerance.
`csrc/flash_attention.cu` has the layout.

Dispatch follows the tensor's device and nothing else: a CUDA tensor
launches the kernel or raises; a CPU or meta tensor takes the plain
version. There is no fallback from the kernel to the plain path.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

# Finite stand-in for -inf, as the TPU kernel's (pallas_attention.py).
_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

_SOURCE = "flash_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool):
    if q.ndim != 4:
        raise ValueError(f"expected (B, H, S, Dh), got {tuple(q.shape)}")
    if k.shape != v.shape or k.ndim != 4:
        raise ValueError(
            f"k/v must be (B, H, S_k, Dh) alike: {tuple(k.shape)} vs "
            f"{tuple(v.shape)}"
        )
    if k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on "
            "batch, heads or head dim"
        )
    if causal and q.shape[2] != k.shape[2]:
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


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


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
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
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
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            "the CUDA flash kernel takes float32, float16 or bfloat16 "
            f"q/k/v of one dtype; got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if dh % 8 or not 8 <= dh <= 128:
        raise ValueError(
            f"the CUDA flash kernel takes Dh a multiple of 8 up to 128, "
            f"got {dh}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q/k/v on different devices: {q.device}/{k.device}/{v.device}"
        )
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the CUDA flash kernel needs a unit Dh stride")
    # 16-bit rows are staged by 16-byte cp.async copies.
    if q.dtype != torch.float32 and any(
        t.data_ptr() % 16 or any(st * t.element_size() % 16
                                 for st in t.stride()[:3])
        for t in (q, k, v)
    ):
        raise ValueError(
            "the CUDA flash kernel needs float16/bfloat16 rows that start "
            "on 16 bytes"
        )
    fn = _kernel()
    out = torch.empty(
        (b, s_q, h, dh), dtype=q.dtype, device=q.device
    ).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *_strides(q), *_strides(k), *_strides(v), *_strides(out)
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, s_q, s_k, dh, strides,
            dh**-0.5, int(causal), stream,
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
    `flash_attention.launches` counts kernel launches."""
    return _Flash.apply(q, k, v, causal)


flash_attention.launches = 0
