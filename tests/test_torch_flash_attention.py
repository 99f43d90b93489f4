"""defer_tpu_torch's flash_attention against the JAX package's.

On the CPU the port's wrapper runs its plain version (the kernel's math
in plain PyTorch); the JAX side runs the Pallas kernel in interpret
mode and the XLA reference. Inputs are numpy draws from a fixed seed,
handed to both. Tolerance: atol = rtol = 1e-5 in float32 (the two sides
sum in different orders).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.ops.attention import attention_reference as jax_reference
from defer_tpu.ops.pallas_attention import flash_attention as jax_flash
from defer_tpu_torch.ops import flash_attention as fa
from defer_tpu_torch.ops.attention import attention_reference
from defer_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    launch_plan,
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


# The card kernel's tiling (`launch_plan`), which the wrapper hands to the
# C entry on every launch; checked here since the kernel itself runs only
# on a card.
PLAN_S = [1, 8, 16, 17, 77, 128, 197, 200, 512]
PLAN_DH = [16, 40, 64, 72, 128]


def _covered_once(spans, n):
    """Every index in [0, n) lies in exactly one [start, start + width)."""
    hits = np.zeros(n + 128, dtype=int)
    for start, width in spans:
        hits[start:start + width] += 1
    return (hits[:n] == 1).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", PLAN_DH)
@pytest.mark.parametrize("s", PLAN_S)
def test_launch_plan_covers_every_row_and_column_once(s, dh, causal):
    plan = launch_plan(s, s, dh, causal)
    assert plan.panels == (1 if dh <= 64 else 2)
    assert dh <= 64 * plan.panels < dh + 64
    assert len(plan.ctas) == plan.q_tiles
    assert _covered_once([(q0, 64) for q0, _ in plan.ctas], s)
    assert 64 * plan.k_tiles - 64 < s <= 64 * plan.k_tiles
    for q0, n_k in plan.ctas:
        # Columns this tile's rows may attend to: all of them, or those up
        # to its last valid row under the mask; the last K tile walked
        # holds the last of them.
        need = min(s, q0 + 64) if causal else s
        assert _covered_once([(64 * t, 64) for t in range(n_k)], need)
        assert 64 * (n_k - 1) < need <= 64 * n_k
    # Launch order: the heaviest query tiles first where the mask makes
    # them differ.
    work = [n_k for _, n_k in plan.ctas]
    assert work == sorted(work, reverse=True)
    assert plan.heaviest_first == causal
    if causal:
        assert plan.ctas[0][0] == max(q0 for q0, _ in plan.ctas)
    computed = 64 * 64 * sum(work)
    needed = s * (s + 1) // 2 if causal else s * s
    assert plan.work_ratio == pytest.approx(computed / needed)


def test_launch_plan_at_vit_scores_full_tiles():
    """ViT-B/16's S = 197: four 64-row query tiles, each walking four
    64-column K tiles, so the kernel computes 256 x 256 products where
    197 x 197 are needed."""
    plan = launch_plan(197, 197, 64, False)
    assert plan.ctas == ((0, 4), (64, 4), (128, 4), (192, 4))
    assert plan.work_ratio == pytest.approx(256 * 256 / 197**2)


def test_launch_plan_cross_attention_walks_every_key_tile():
    plan = launch_plan(77, 1030, 64, False)
    assert plan.k_tiles == 17
    assert plan.ctas == ((0, 17), (64, 17))
    assert _covered_once([(q0, 64) for q0, _ in plan.ctas], 77)


@pytest.mark.parametrize(
    "shape,s_k,causal",
    [((1, 2, 197, 72), 197, False), ((2, 3, 130, 64), 130, True),
     ((1, 2, 77, 40), 1030, False)],
)
def test_the_launch_takes_the_plan(monkeypatch, shape, s_k, causal):
    """The wrapper hands the C entry the plan's tiling: panels, query
    tiles, K tiles and the order (the entry point recorded in place of
    the built library, a stream stubbed in place of the card's)."""
    calls = []
    monkeypatch.setattr(fa, "_kernel", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: types.SimpleNamespace(cuda_stream=0),
    )
    monkeypatch.setattr(flash_attention, "launches", 0)
    b, h, s_q, dh = shape
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, h, s_q, dh, generator=gen).bfloat16()
    k, v = (torch.randn(b, h, s_k, dh, generator=gen).bfloat16()
            for _ in range(2))
    fa._flash_cuda(q, k, v, causal)
    plan = launch_plan(s_q, s_k, dh, causal)
    assert len(calls) == 1 and flash_attention.launches == 1
    assert calls[0][13:17] == (plan.panels, plan.q_tiles, plan.k_tiles,
                               int(plan.heaviest_first))
