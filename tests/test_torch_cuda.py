"""Card-only tests of defer_tpu_torch: the hand-written kernels against
their plain versions, and the main path through them.

Every test here is marked `cuda` and skips without a CUDA card. The
file imports neither jax nor defer_tpu, so on the card it runs on its
own, without tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: kernel vs plain version, atol + rtol of 1e-2 in bfloat16
and 1e-5 in float32 (both compute in f32 and round once at the end);
the pipelined output vs the unpartitioned graph, 1e-2 in bfloat16 (the
same kernels on the same inputs).
"""

import queue
import threading

import pytest
import torch

from defer_tpu_torch import DEFER, DeferConfig
from defer_tpu_torch.models import get_model
from defer_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from defer_tpu_torch.parallel.pipeline import cast_params_to_storage

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.parametrize(
    "shape,s_k,dtype,causal,tol",
    [
        ((2, 12, 128, 64), 128, torch.bfloat16, False, 1e-2),
        ((2, 12, 128, 64), 128, torch.bfloat16, True, 1e-2),
        ((2, 4, 77, 64), 77, torch.float32, True, 1e-5),
        ((1, 4, 33, 128), 150, torch.float16, False, 2e-3),
        ((1, 2, 1, 8), 1, torch.float32, False, 1e-5),
    ],
)
def test_kernel_matches_plain(card, shape, s_k, dtype, causal, tol):
    gen = torch.Generator(device=card).manual_seed(0)
    b, h, _, dh = shape
    q = torch.randn(shape, generator=gen, device=card).to(dtype)
    k, v = (
        torch.randn((b, h, s_k, dh), generator=gen, device=card).to(dtype)
        for _ in range(2)
    )
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def test_backward_through_the_plain_version(card):
    gen = torch.Generator(device=card).manual_seed(2)
    qkv = [
        torch.randn(1, 2, 40, 16, generator=gen, device=card)
        .requires_grad_()
        for _ in range(3)
    ]
    flash_attention(*qkv, causal=True).square().sum().backward()
    got = [t.grad.clone() for t in qkv]
    for t in qkv:
        t.grad = None
    flash_attention_plain(*qkv, causal=True).square().sum().backward()
    for g, t in zip(got, qkv):
        torch.testing.assert_close(g, t.grad, atol=1e-5, rtol=1e-5)


def test_kernel_takes_strided_heads(card):
    """The head split of a (B, S, H*Dh) projection is a strided view;
    the kernel reads it in place."""
    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(2, 50, 3 * 64, generator=gen, device=card).bfloat16()
    qh = x.view(2, 50, 3, 64).transpose(1, 2)
    got = flash_attention(qh, qh, qh)
    want = flash_attention_plain(qh.contiguous(), qh.contiguous(),
                                 qh.contiguous())
    torch.testing.assert_close(got, want, atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize(
    "make,err",
    [
        (lambda d: torch.zeros(1, 1, 8, 12, device=d), ValueError),
        (lambda d: torch.zeros(1, 1, 8, 8, device=d,
                               dtype=torch.float64), TypeError),
    ],
)
def test_kernel_refuses_what_it_does_not_take(card, make, err):
    t = make(card)
    with pytest.raises(err):
        flash_attention(t, t, t)


def test_run_defer_goes_through_the_kernel(card):
    model = get_model("bert_tiny", seq_len=16)
    params = model.init(torch.Generator(device=card).manual_seed(0),
                        batch_size=2)
    xs = [torch.randint(0, 128, (2, 16),
                        generator=torch.Generator().manual_seed(i))
          for i in range(4)]
    cfg = DeferConfig(compute_dtype=torch.bfloat16)
    in_q: "queue.Queue" = queue.Queue()
    out_q: "queue.Queue" = queue.Queue()
    for x in xs:
        in_q.put(x)
    in_q.put(None)
    defer = DEFER(config=cfg)
    before = flash_attention.launches
    t = threading.Thread(
        target=defer.run_defer,
        args=(model, ["encoder_1_out"], in_q, out_q),
        kwargs={"params": params},
        daemon=True,
    )
    t.start()
    outs = [out_q.get(timeout=120) for _ in xs]
    t.join(timeout=60)
    assert not t.is_alive()
    assert flash_attention.launches - before == 4 * len(xs)
    with torch.inference_mode():
        want = model.graph.apply(cast_params_to_storage(params, cfg),
                                 xs[0].to(card))
    assert outs[0].device.type == "cuda"
    torch.testing.assert_close(outs[0].float(), want.float(), atol=1e-2,
                               rtol=1e-2)
