"""defer_tpu_torch's flash_attention against the JAX package's.

On the CPU the port's wrapper runs its plain version (the kernel's math
in plain PyTorch); the JAX side runs the Pallas kernel in interpret
mode and the XLA reference. Inputs are numpy draws from a fixed seed,
handed to both. Tolerance: atol = rtol = 1e-5 in float32 (the two sides
sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.ops.attention import attention_reference as jax_reference
from defer_tpu.ops.pallas_attention import flash_attention as jax_flash
from defer_tpu_torch.ops.attention import attention_reference
from defer_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [8, 64])
def test_flash_matches_jax(seq, causal):
    q, k, v = _qkv((2, 3, seq, 16), seed=seq)
    before = flash_attention.launches
    got = flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal
    )
    assert flash_attention.launches == before  # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (2, 3, seq, 16)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_kernel = jax_flash(jq, jk, jv, causal=causal, interpret=True)
    want_ref = jax_reference(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_jax(causal):
    q, k, v = _qkv((2, 2, 24, 8), seed=7)
    bias = np.random.default_rng(8).standard_normal((2, 1, 24, 24))
    bias = bias.astype(np.float32)
    got = attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        bias=torch.from_numpy(bias),
        causal=causal,
    )
    want = jax_reference(
        *(jnp.asarray(a) for a in (q, k, v)),
        bias=jnp.asarray(bias),
        causal=causal,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_keeps_probabilities_in_f32():
    """bf16 inputs: one cast at the end, so the plain version equals the
    f32 computation rounded once."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv((1, 2, 40, 16)))
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q.float(), k.float(), v.float())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.bfloat16(), atol=0, rtol=0)


def test_meta_tensors_give_shapes():
    q = torch.empty(2, 4, 33, 8, device="meta")
    k = torch.empty(2, 4, 50, 8, device="meta")
    out = flash_attention(q, k, k)
    assert out.device.type == "meta" and out.shape == (2, 4, 33, 8)


def test_causal_needs_square():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 1, 8, 8)))
    with pytest.raises(ValueError, match="s_q == s_k"):
        flash_attention(q, k[:, :, :4], v[:, :, :4], causal=True)


def test_backward_matches_reference():
    q, k, v = (
        torch.from_numpy(a).requires_grad_() for a in _qkv((1, 2, 16, 8), 3)
    )
    flash_attention(q, k, v, causal=True).sum().backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    attention_reference(q, k, v, causal=True).sum().backward()
    for got, t in zip(grads, (q, k, v)):
        torch.testing.assert_close(got, t.grad, **TOL)


def _tiled_bf16_p(q, k, v, causal):
    """The card kernel's arithmetic on the CPU: f32 scores of bf16
    operands scaled by Dh**-0.5, an online softmax over 64-column tiles
    with f32 m/l, and P rounded to bf16 before P V (f32 accumulation)."""
    dh, s_k = q.shape[-1], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * dh**-0.5
    if causal:
        keep = torch.ones(q.shape[2], s_k, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, -0.7 * float(np.finfo(np.float32).max))
    m = torch.full(s.shape[:-1], -float("inf"))
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(*s.shape[:-1], dh)
    for k0 in range(0, s_k, 64):
        st = s[..., k0:k0 + 64]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.bfloat16().float(), v[:, :, k0:k0 + 64].float()
        )
        m = m_new
    return (acc / l[..., None]).bfloat16()


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_probabilities_stay_within_the_card_tolerance(causal):
    """The tensor-core kernel rounds P to bf16 before P V (at most 2^-9
    relative a weight); at BERT-base's head shape (S 128, Dh 64) with 2
    heads that stays within the bf16 tolerance the card holds the kernel
    to against `flash_attention_plain` (atol = rtol = 1e-2)."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv((2, 2, 128, 64), seed=11))
    got = _tiled_bf16_p(q, k, v, causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    err = (got.float() - want.float()).abs()
    assert (err <= 1e-2 + 1e-2 * want.float().abs()).all()
    assert err.max() > 0  # the rounding is real, not a no-op
