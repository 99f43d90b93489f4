"""Card-only tests of defer_tpu_torch: the hand-written kernels against
their plain versions, and the main paths through them (run_defer and
the decode server).

Every test here is marked `cuda` and skips without a CUDA card. The
file imports neither jax nor defer_tpu, so on the card it runs on its
own, without tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: kernel vs plain version, atol + rtol of 1e-2 in bfloat16,
2e-3 in float16 and 1e-5 in float32 (both compute in f32 and round once
at the end); the pipelined output vs the unpartitioned graph, 1e-2 in
bfloat16 (the same kernels on the same inputs); a served token's
reference logit within 0.08 of its row's max (a greedy tie tolerance
for bf16 decoding, as examples/serve_decode.py uses).
"""

import queue
import threading

import pytest
import torch

from defer_tpu_torch import DEFER, DeferConfig
from defer_tpu_torch.models import get_model
from defer_tpu_torch.models.llama import llama_config
from defer_tpu_torch.models.gpt import GptDecoder
from defer_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from defer_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain
from defer_tpu_torch.runtime.decode_server import DecodeServer
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


# (B, Hq, Hkv, S, Dh, dtype, pos, window): the main path's shape, a
# binding window, MHA at Dh 64, G=8, a ragged S, f32, a scalar pos.
DECODE_CASES = [
    (4, 32, 8, 4096, 128, torch.bfloat16, [4095, 2047, 130, 0], None),
    (2, 32, 8, 4096, 128, torch.bfloat16, [3000, 100], 256),
    (2, 8, 8, 300, 64, torch.bfloat16, [299, 37], None),
    (2, 32, 4, 512, 128, torch.bfloat16, [511, 260], None),
    (3, 8, 2, 77, 64, torch.float16, [76, 0, 40], None),
    (2, 16, 4, 1000, 128, torch.float32, [999, 513], None),
    (4, 32, 8, 640, 128, torch.bfloat16, 321, None),
]
DECODE_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-5}


def _decode_inputs(card, b, hq, hkv, s, dh, dtype, pos, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    # q as the decoder hands it over: q[:, :, 0, :] of a head split.
    q = torch.randn(b, 1, hq * dh, generator=gen, device=card).to(dtype)
    q = q.view(b, 1, hq, dh).transpose(1, 2)[:, :, 0, :]
    k, v = (
        torch.randn(b, hkv, s, dh, generator=gen, device=card).to(dtype)
        for _ in range(2)
    )
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device=card)


@pytest.mark.parametrize("b,hq,hkv,s,dh,dtype,pos,window", DECODE_CASES)
def test_flash_decode_matches_plain(card, b, hq, hkv, s, dh, dtype, pos,
                                    window):
    q, k, v, posv = _decode_inputs(card, b, hq, hkv, s, dh, dtype, pos)
    before = flash_decode.launches
    got = flash_decode(q, k, v, posv, window=window)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    want = flash_decode_plain(q, k, v, posv, window=window)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def test_flash_decode_reads_only_live_rows(card):
    """Rows past pos (and before a window) are never read: filling them
    with NaN changes nothing."""
    q, k, v, posv = _decode_inputs(card, 2, 8, 2, 512, 64, torch.bfloat16,
                                   [100, 300])
    want = flash_decode(q, k, v, posv, window=64)
    for t in (k, v):
        t[0, :, 101:] = float("nan")
        t[1, :, 301:] = float("nan")
        t[1, :, :237] = float("nan")
    got = flash_decode(q, k, v, posv, window=64)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize(
    "shapes,dtypes,err",
    [
        (((2, 8, 48), (2, 2, 64, 48)), (torch.bfloat16,) * 2, ValueError),
        (((2, 8, 64), (2, 2, 64, 64)),
         (torch.bfloat16, torch.float16), TypeError),
        (((2, 8, 64), (2, 3, 64, 64)), (torch.bfloat16,) * 2, ValueError),
    ],
)
def test_flash_decode_refuses_what_it_does_not_take(card, shapes, dtypes,
                                                    err):
    q = torch.zeros(shapes[0], dtype=dtypes[0], device=card)
    k = torch.zeros(shapes[1], dtype=dtypes[1], device=card)
    with pytest.raises(err):
        flash_decode(q, k, k, torch.zeros(2, dtype=torch.int32,
                                          device=card))


def test_decode_server_tick_goes_through_the_kernel(card):
    """One decode tick of a bf16 llama-shaped decoder launches the
    kernel once per layer, and the served tokens are valid greedy
    choices under reference_logits."""
    cfg = llama_config(num_layers=2, dim=256, num_heads=4, num_kv_heads=2,
                       ffn_dim=512, vocab_size=512, max_len=128)
    dec = GptDecoder(cfg, compute_dtype=torch.bfloat16)
    params = dec.cast_params(
        dec.init(torch.Generator(device=card).manual_seed(0))
    )
    srv = DecodeServer(dec, params, max_batch=2)
    prompts = [torch.randint(0, 512, (1, n),
                             generator=torch.Generator().manual_seed(n))
               for n in (5, 9)]
    rids = [srv.submit(p, 4) for p in prompts]
    srv._admit()
    before = flash_decode.launches
    srv._tick()
    torch.cuda.synchronize()
    assert flash_decode.launches - before == cfg.num_layers
    done = srv.run()
    for p, rid in zip(prompts, rids):
        out = done[rid]
        assert out.shape == (1, p.shape[1] + 4)
        logits = dec.reference_logits(params, out[:, :-1])[0]
        for j in range(p.shape[1], out.shape[1]):
            row = logits[j - 1]
            assert row.max() - row[out[0, j]] <= 0.08
