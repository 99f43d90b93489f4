"""Card-only tests of defer_tpu_torch: the hand-written kernels against
their plain versions, and the main paths through them (run_defer, the
decode server and the paged server, on a float and an int8 pool); the
decode server's windows as captured CUDA graphs against its
decode_window=1 ticks; the CNN ops through cuDNN against their CPU path,
and the image models' stages; a remote stage worker on the card behind a
loopback socket, and run_defer with replicas=2; what a kernel call runs
on the card (each kernel's own run counter and the aten ops it
dispatches); and fleet serving on one card
(prefix migration between two servers, two windowed replicas capturing
at once, device= placement); training on the card (a BERT-base-width
train step's flash_attention launches with and without remat, the
kernel's gradient, the MoE dispatches); the training collectives on the
card (two gloo ranks sharing cuda:0 under tp, FSDP and the stage axis
across ranks, against one process; every collective on a world-size-1
NCCL group); the multi-rank example drivers under torchrun, their ranks
sharing cuda:0 on gloo.

Every test here is marked `cuda` and skips without a CUDA card. The
file imports neither jax nor defer_tpu, so on the card it runs on its
own, without tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: kernel vs plain version, atol + rtol of 1e-2 in bfloat16,
2e-3 in float16 and 1e-5 in float32 (both compute in f32 and round once
at the end); the pipelined output vs the unpartitioned graph, 1e-2 in
bfloat16 (the same kernels on the same inputs); the CNN ops on the card
against the CPU, atol = rtol = 1e-4 in float32 with TF32 off (cuDNN
and the CPU sum in different orders); a served token's
reference logit within 0.08 of its row's max (a greedy tie tolerance
for bf16 decoding, as examples/serve_decode.py uses).
"""

import dataclasses
import queue
import threading
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from defer_tpu_torch import DEFER, DeferConfig
from defer_tpu_torch.models import get_model
from defer_tpu_torch.models.llama import llama_config, mistral_config
from defer_tpu_torch.models.gpt import GptDecoder
from defer_tpu_torch.models.quant import quantize_symmetric
from defer_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from defer_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain
from defer_tpu_torch.ops.paged_flash_decode import (
    paged_flash_decode,
    paged_flash_decode_plain,
)
from defer_tpu_torch.ops.paged_flash_prefill import (
    _prefill_lo_hi,
    paged_flash_prefill,
    paged_flash_prefill_plain,
)
from defer_tpu_torch.models.gpt import SamplingParams
from defer_tpu_torch.runtime.decode_server import DecodeServer, serve_greedy
from defer_tpu_torch.runtime.paged import PagedDecodeServer, serve_paged
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
        # Dh not a multiple of 16: zero-padded to 48 and 80 on the card.
        ((2, 4, 100, 40), 100, torch.bfloat16, False, 1e-2),
        ((2, 4, 70, 72), 70, torch.bfloat16, True, 1e-2),
        # One row, one partial tile, and a ragged second tile, causal.
        ((2, 4, 1, 64), 1, torch.bfloat16, True, 1e-2),
        ((2, 4, 8, 64), 8, torch.bfloat16, True, 1e-2),
        ((2, 4, 200, 64), 200, torch.bfloat16, True, 1e-2),
        # ViT-B/16 and ViT-S/16 at 224 (S = 197, a ragged last tile) and
        # vit_tiny (Dh 16, S = 17).
        ((2, 12, 197, 64), 197, torch.bfloat16, False, 1e-2),
        ((2, 4, 17, 16), 17, torch.bfloat16, False, 1e-2),
        # What only the TMA / wgmma design can break: 16 K tiles through
        # the 2-stage ring (its barriers' phases wrap), two 64-column boxes
        # a tile at Dh 128 with a 16-wide last tile, and a 1030-key cross
        # attention in f16 (a 16-wide last tile after 16 full ones).
        ((2, 4, 1024, 64), 1024, torch.bfloat16, False, 1e-2),
        ((2, 4, 1024, 64), 1024, torch.bfloat16, True, 1e-2),
        ((2, 4, 197, 128), 197, torch.bfloat16, False, 1e-2),
        ((2, 4, 77, 64), 1030, torch.float16, False, 2e-3),
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


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_takes_strided_heads_at_dh40(card, causal):
    """Dh 40: each row is 80 bytes of a (B, S, H*40) projection, and the
    TMA box reads 64 columns of it, the 24 past Dh as zeros."""
    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v = (
        torch.randn(2, 90, 5 * 40, generator=gen, device=card).bfloat16()
        .view(2, 90, 5, 40).transpose(1, 2)
        for _ in range(3)
    )
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)


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


@pytest.mark.parametrize(
    "shape,causal",
    [((16, 12, 128, 64), False), ((4, 12, 512, 64), True),
     ((2, 12, 1024, 64), False), ((2, 12, 197, 64), False)],
)
def test_kernel_gives_the_same_bits_every_call(card, shape, causal):
    """A register read or written while a wgmma that owns it is in flight
    shows as calls that differ (a build that ran the softmax under the
    P V gave a few calls in a hundred with inf); strided heads as the
    main path hands them over, with allocations between the calls so
    the output lands at other addresses."""
    gen = torch.Generator(device=card).manual_seed(4)
    b, h, s, dh = shape
    q, k, v = (
        torch.randn(b, s, h * dh, generator=gen, device=card).bfloat16()
        .view(b, s, h, dh).transpose(1, 2)
        for _ in range(3)
    )
    first = flash_attention(q, k, v, causal=causal)
    junk = []
    for i in range(100):
        junk.append(torch.empty(1 + 997 * i % 5000, device=card))
        got = flash_attention(q, k, v, causal=causal)
        assert torch.equal(got, first), f"call {i} differs"
        junk = junk[-8:]


def test_kernel_refuses_a_zero_stride(card):
    """A head broadcast by expand has stride 0, which a TMA map cannot
    step: the wrapper raises before the launch."""
    q = torch.zeros(1, 4, 16, 64, device=card, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 16, 64, device=card,
                     dtype=torch.bfloat16).expand(1, 4, 16, 64)
    with pytest.raises(ValueError, match="nonzero stride"):
        flash_attention(q, kv, kv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_runs_from_a_fresh_thread(card, dtype):
    """A thread that has made no CUDA call (a serving thread handed
    tensors from the main one) launches the kernel on the tensors' card,
    the last one, and is left on that card: the entry point binds its
    context there and sets no other card current."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (
        torch.randn(2, 4, 150, 64, generator=gen, device=dev).to(dtype)
        for _ in range(3)
    )
    torch.cuda.synchronize(dev)
    res = {}

    def work():
        try:
            res["got"] = flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize(dev)
            res["device"] = torch.cuda.current_device()
        except Exception as exc:  # raised again in the test's thread
            res["error"] = exc

    t = threading.Thread(target=work)
    t.start()
    t.join()
    if "error" in res:
        raise res["error"]
    assert res["device"] == dev.index
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(
        res["got"], flash_attention_plain(q, k, v, causal=True),
        atol=tol, rtol=tol,
    )


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
# binding window, MHA at Dh 64, G=8, a ragged S, f32, a scalar pos; then
# the tick's depths, G 1/4/8 at Dh 32/64/128 in f16 and f32, and G=20
# (two CTAs of 16 query rows a KV head).
DECODE_CASES = [
    (4, 32, 8, 4096, 128, torch.bfloat16, [4095, 2047, 130, 0], None),
    (2, 32, 8, 4096, 128, torch.bfloat16, [3000, 100], 256),
    (2, 8, 8, 300, 64, torch.bfloat16, [299, 37], None),
    (2, 32, 4, 512, 128, torch.bfloat16, [511, 260], None),
    (3, 8, 2, 77, 64, torch.float16, [76, 0, 40], None),
    (2, 16, 4, 1000, 128, torch.float32, [999, 513], None),
    (4, 32, 8, 640, 128, torch.bfloat16, 321, None),
    (4, 32, 8, 4096, 128, torch.bfloat16, [170, 176, 182, 188], 4096),
    (2, 8, 8, 256, 32, torch.float16, [255, 3], None),
    (2, 16, 4, 700, 64, torch.float16, [699, 64], 200),
    (2, 64, 8, 300, 32, torch.bfloat16, [299, 15], None),
    (2, 8, 2, 500, 64, torch.float32, [499, 16], 100),
    (2, 4, 4, 130, 32, torch.float32, [129, 0], None),
    (2, 40, 2, 1000, 128, torch.bfloat16, [999, 300], 500),
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


def _paged_inputs(card, b, hq, hkv, t, dh, bs, mb, dtype, pos, seed=0):
    """q as the decoder hands it over (a head split of [B, T, Hq*Dh]; T
    None for the decode kernel's [B, Hq, Dh]), one layer of a pool of
    1 + B * MB blocks, and tables drawn as a seeded permutation of the
    pool with each slot's entries past its need on trash block 0."""
    gen = torch.Generator(device=card).manual_seed(seed)
    tq = 1 if t is None else t
    q = torch.randn(b, tq, hq * dh, generator=gen, device=card).to(dtype)
    q = q.view(b, tq, hq, dh).transpose(1, 2)
    if t is None:
        q = q[:, :, 0, :]
    nb = 1 + b * mb
    pool_k, pool_v = (
        torch.randn(nb, hkv, bs, dh, generator=gen, device=card).to(dtype)
        for _ in range(2)
    )
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(seed))
    tables = (perm + 1).reshape(b, mb).to(torch.int32)
    for i, p in enumerate(pos):
        tables[i, (p + tq - 1) // bs + 1:] = 0
    posv = torch.tensor(pos, dtype=torch.int32)
    return q, pool_k, pool_v, tables.to(card), posv.to(card)


# (B, Hq, Hkv, Dh, bs, MB, dtype, pos, window): the paged tick's shape, a
# window crossing a block edge, G=1 at Dh 64, G=8, fp16 at bs 8, f32 at
# bs 32, position 0.
PAGED_DECODE_CASES = [
    (4, 32, 8, 128, 16, 256, torch.bfloat16, [4095, 2047, 130, 0], 4096),
    (2, 32, 8, 128, 16, 64, torch.bfloat16, [700, 40], 100),
    (2, 8, 8, 64, 16, 32, torch.bfloat16, [500, 77], None),
    (2, 64, 8, 128, 16, 64, torch.bfloat16, [1000, 300], None),
    (3, 16, 4, 64, 8, 64, torch.float16, [511, 0, 100], None),
    (2, 32, 8, 128, 32, 32, torch.float32, [1023, 513], 200),
    (2, 4, 2, 32, 1, 16, torch.float32, [0, 15], None),
    # The tick's depths; bs 1 and 4 in 16-bit; a window whose low edge
    # falls mid-block; G=20 (two CTAs of 16 query rows a KV head).
    (4, 32, 8, 128, 16, 256, torch.bfloat16, [170, 176, 182, 188], 4096),
    (2, 8, 2, 64, 1, 300, torch.bfloat16, [299, 100], None),
    (2, 16, 4, 32, 4, 64, torch.float16, [255, 9], 37),
    (2, 8, 8, 128, 32, 32, torch.bfloat16, [1000, 40], 333),
    (2, 40, 2, 128, 16, 64, torch.bfloat16, [1023, 77], None),
]


@pytest.mark.parametrize("b,hq,hkv,dh,bs,mb,dtype,pos,window",
                         PAGED_DECODE_CASES)
def test_paged_flash_decode_matches_plain(card, b, hq, hkv, dh, bs, mb,
                                          dtype, pos, window):
    q, pk, pv, tables, posv = _paged_inputs(card, b, hq, hkv, None, dh, bs,
                                            mb, dtype, pos)
    before = paged_flash_decode.launches
    got = paged_flash_decode(q, pk, pv, tables, posv, window=window)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    want = paged_flash_decode_plain(q, pk, pv, tables, posv, window=window,
                                    num_blocks=max(pos) // bs + 1)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


# (B, Hq, Hkv, T, Dh, bs, MB, dtype, start, window): the phase-5 chunk
# after a 4-block hit, deep chunks (a cluster's ranks split the live range
# and merge), a deep and a shallow slot (the shallow slot's late ranks walk
# nothing), start 0, a window crossing a block edge, G=1 at Dh 64, G=8,
# B=4 with T=5, fp16 at bs 8, bf16 at bs 4 (a TMA box of 4 rows lands
# inside a swizzle atom), f32 at bs 32.
PAGED_PREFILL_CASES = [
    (1, 32, 8, 64, 128, 16, 256, torch.bfloat16, [64], 4096),
    (1, 32, 8, 64, 128, 16, 256, torch.bfloat16, [1984], 4096),
    (1, 32, 8, 64, 128, 16, 256, torch.bfloat16, [4032], 4096),
    (2, 32, 8, 64, 128, 16, 256, torch.bfloat16, [4032, 64], 4096),
    (1, 32, 8, 64, 128, 16, 256, torch.bfloat16, [0], 4096),
    (2, 32, 8, 64, 128, 16, 64, torch.bfloat16, [500, 37], 100),
    (2, 8, 8, 16, 64, 16, 32, torch.bfloat16, [100, 0], None),
    (1, 64, 8, 32, 128, 16, 64, torch.bfloat16, [300], None),
    (4, 32, 8, 5, 128, 16, 64, torch.bfloat16, [0, 17, 400, 1000], None),
    (2, 16, 4, 24, 64, 8, 64, torch.float16, [100, 7], None),
    (2, 16, 4, 24, 128, 4, 64, torch.bfloat16, [100, 7], None),
    (2, 32, 8, 40, 128, 32, 32, torch.float32, [600, 3], 200),
]


@pytest.mark.parametrize("b,hq,hkv,t,dh,bs,mb,dtype,start,window",
                         PAGED_PREFILL_CASES)
def test_paged_flash_prefill_matches_plain(card, b, hq, hkv, t, dh, bs, mb,
                                           dtype, start, window):
    q, pk, pv, tables, startv = _paged_inputs(card, b, hq, hkv, t, dh, bs,
                                              mb, dtype, start)
    before = paged_flash_prefill.launches
    got = paged_flash_prefill(q, pk, pv, tables, startv, window=window)
    torch.cuda.synchronize()
    assert paged_flash_prefill.launches == before + 1
    want = paged_flash_prefill_plain(
        q, pk, pv, tables, startv, window=window,
        num_blocks=min((max(start) + t - 1) // bs + 1, mb),
    )
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def _live_blocks(tables, pos, t, bs, window) -> set:
    """The pool blocks a decode row at pos and the T prefill rows from
    pos reach, through each slot's table."""
    live = set()
    for i, p in enumerate(pos):
        lo, hi = _prefill_lo_hi(p, t, bs, window)
        live |= set(tables[i, lo:hi + 1].tolist())
    return live


# (pos, MB, window): shallow slots, then a deep slot beside a shallow one,
# where the prefill kernel splits the live columns and merges the splits.
LIVE_BLOCK_CASES = [([100, 37], 16, 80), ([3000, 37], 256, 2100)]


@pytest.mark.parametrize("pos,mb,window", LIVE_BLOCK_CASES)
def test_paged_kernels_read_only_live_blocks(card, pos, mb, window):
    """Pool blocks no live row reaches (trash block 0 and every block
    not in a live table column) hold NaN: neither kernel reads them."""
    q, pk, pv, tables, posv = _paged_inputs(card, 2, 8, 2, 6, 64, 16, mb,
                                            torch.bfloat16, pos)
    live = _live_blocks(tables, pos, 6, 16, window)

    def both():
        return (
            paged_flash_decode(q[:, :, 0, :], pk, pv, tables, posv,
                               window=window),
            paged_flash_prefill(q, pk, pv, tables, posv, window=window),
        )

    want = both()
    dead = [i for i in range(pk.shape[0]) if i not in live]
    for t in (pk, pv):
        t[dead] = float("nan")
    got = both()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def _small_llama(card):
    """A small f32 llama on the card and four requests behind one shared
    16-token system prompt: (cfg, decoder, params, requests)."""
    cfg = llama_config(num_layers=2, dim=256, num_heads=4, num_kv_heads=2,
                       ffn_dim=512, vocab_size=512, max_len=128,
                       window=40)
    dec = GptDecoder(cfg, compute_dtype=torch.float32)
    params = dec.init(torch.Generator(device=card).manual_seed(0))
    system = torch.randint(0, 512, (1, 16),
                           generator=torch.Generator().manual_seed(1))
    reqs = [
        (torch.cat([system, torch.randint(
            0, 512, (1, n), generator=torch.Generator().manual_seed(n))],
            dim=1), s)
        for n, s in ((5, 12), (9, 30), (3, 7), (20, 16))
    ]
    return cfg, dec, params, reqs


def test_pallas_server_matches_gathered_server(card):
    """A small f32 llama through the port's "pallas" server (both paged
    kernels: chunked prefill after radix hits, then the ticks) gives the
    tokens of its "gathered" server, and launches each kernel once a
    layer per tick or chunk."""
    cfg, dec, params, reqs = _small_llama(card)
    knobs = dict(num_blocks=40, block_size=8, max_batch=2,
                 prefix_cache=True, prefill_chunk=8)
    want, _ = serve_paged(dec, params, reqs, attention="gathered", **knobs)
    dec0, pre0 = paged_flash_decode.launches, paged_flash_prefill.launches
    got, stats = serve_paged(dec, params, reqs, attention="pallas", **knobs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert paged_flash_decode.launches - dec0 == cfg.num_layers * stats.ticks
    assert paged_flash_prefill.launches > pre0
    assert stats.prefill_tokens_saved == 16 * 3


def _int8(pool):
    """A float pool as the int8 pool stores it: payload and one f32 scale
    per (block, head)."""
    return quantize_symmetric(pool.float(), axis=(-2, -1))


@pytest.mark.parametrize("b,hq,hkv,dh,bs,mb,dtype,pos,window",
                         PAGED_DECODE_CASES)
def test_paged_flash_decode_int8_matches_plain(card, b, hq, hkv, dh, bs, mb,
                                               dtype, pos, window):
    """The int8 scale path over the same grid: the kernel reads the int8
    payload and scales as they are; the plain version widens and scales
    each gathered block. Both compute in f32, so the float tolerances
    hold."""
    q, pk, pv, tables, posv = _paged_inputs(card, b, hq, hkv, None, dh, bs,
                                            mb, dtype, pos)
    (kq, ks), (vq, vs) = _int8(pk), _int8(pv)
    before = paged_flash_decode.launches_int8
    fp_before = paged_flash_decode.launches
    got = paged_flash_decode(q, kq, vq, tables, posv, window=window,
                             scale_k=ks, scale_v=vs)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches_int8 == before + 1
    assert paged_flash_decode.launches == fp_before
    want = paged_flash_decode_plain(q, kq, vq, tables, posv, window=window,
                                    num_blocks=max(pos) // bs + 1,
                                    scale_k=ks, scale_v=vs)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("b,hq,hkv,t,dh,bs,mb,dtype,start,window",
                         PAGED_PREFILL_CASES)
def test_paged_flash_prefill_int8_matches_plain(card, b, hq, hkv, t, dh, bs,
                                                mb, dtype, start, window):
    q, pk, pv, tables, startv = _paged_inputs(card, b, hq, hkv, t, dh, bs,
                                              mb, dtype, start)
    (kq, ks), (vq, vs) = _int8(pk), _int8(pv)
    before = paged_flash_prefill.launches_int8
    got = paged_flash_prefill(q, kq, vq, tables, startv, window=window,
                              scale_k=ks, scale_v=vs)
    torch.cuda.synchronize()
    assert paged_flash_prefill.launches_int8 == before + 1
    want = paged_flash_prefill_plain(
        q, kq, vq, tables, startv, window=window,
        num_blocks=min((max(start) + t - 1) // bs + 1, mb),
        scale_k=ks, scale_v=vs,
    )
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("pos,mb,window", LIVE_BLOCK_CASES)
def test_int8_kernels_read_only_live_blocks(card, pos, mb, window):
    """An int8 pool whose dead blocks hold garbage payload and NaN scales
    (trash block 0 and every block no live row reaches): neither kernel
    reads them."""
    q, pk, pv, tables, posv = _paged_inputs(card, 2, 8, 2, 6, 64, 16, mb,
                                            torch.bfloat16, pos)
    (kq, ks), (vq, vs) = _int8(pk), _int8(pv)
    live = _live_blocks(tables, pos, 6, 16, window)

    def both():
        return (
            paged_flash_decode(q[:, :, 0, :], kq, vq, tables, posv,
                               window=window, scale_k=ks, scale_v=vs),
            paged_flash_prefill(q, kq, vq, tables, posv, window=window,
                                scale_k=ks, scale_v=vs),
        )

    want = both()
    dead = [i for i in range(kq.shape[0]) if i not in live]
    kq[dead], vq[dead] = 127, -127
    ks[dead], vs[dead] = float("nan"), float("nan")
    got = both()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_int8_pallas_server_matches_blockwise_server(card):
    """The same small f32 llama on an int8 pool: the "pallas" server (the
    kernels' int8 path, launched and counted apart from the float one)
    gives the tokens of the "blockwise" server, the plain PyTorch fold of
    the same write-then-attend math. (The "gathered" server attends each
    tick's own row before it is quantized, so on an int8 pool its tokens
    are another valid greedy run, not the same one.)"""
    cfg, dec, params, reqs = _small_llama(card)
    knobs = dict(num_blocks=40, block_size=8, max_batch=2,
                 prefix_cache=True, prefill_chunk=8, kv_dtype="int8")
    want, _ = serve_paged(dec, params, reqs, attention="blockwise", **knobs)
    counts = (paged_flash_decode.launches, paged_flash_prefill.launches,
              paged_flash_decode.launches_int8,
              paged_flash_prefill.launches_int8)
    got, stats = serve_paged(dec, params, reqs, attention="pallas", **knobs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    dec_fp, pre_fp, dec8, pre8 = counts
    assert paged_flash_decode.launches == dec_fp
    assert paged_flash_prefill.launches == pre_fp
    assert (paged_flash_decode.launches_int8 - dec8
            == cfg.num_layers * stats.ticks)
    assert paged_flash_prefill.launches_int8 > pre8
    assert stats.prefill_tokens_saved == 16 * 3
    assert stats.kv_dtype == "int8"


def test_spill_drain_makes_no_sync(card):
    """A prefix block handed to the host spill tier drains to host memory
    while the serving thread ticks under
    torch.cuda.set_sync_debug_mode("error"): neither the clone on the
    serving stream, nor the drain thread's copy, nor the ticks wait for
    the card, and the store holds the block's bytes as they were."""
    _, dec, params, reqs = _small_llama(card)
    srv = PagedDecodeServer(dec, params, num_blocks=16, block_size=8,
                            max_batch=1, attention="pallas",
                            prefix_cache=True, kv_dtype="int8",
                            spill_bytes=1 << 20)
    srv.submit(reqs[1][0], 30)
    srv.step()  # the admission prefill and the first tick
    blk = int(srv.tables[0, 0])
    want = [t[:, blk].cpu() for t in srv._leaves()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        srv._spill_block(b"key", b"tok", blk)
        for _ in range(3):
            srv.step()
        deadline = time.monotonic() + 10
        while srv._spill.stored_blocks == 0 and time.monotonic() < deadline:
            time.sleep(1e-3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = srv._spill.get(b"key", b"tok")
    assert got is not None, "the block never reached the host store"
    for g, w in zip(got, want):
        assert torch.equal(g[:, 0], w)
    srv._spill.close()


# (kind, B, Hq, Hkv, Dh, S or MB * bs, pos, window): the tick's depths and
# the deep phase-2 positions, each kernel at Mistral-7B's shape.
DEAD_ROW_CASES = [
    (kind, pos)
    for kind in ("flat", "paged", "int8")
    for pos in ([170, 176, 182, 188], [4095, 2047, 130, 0])
]


def _decode_call(card, kind, pos, window=4096, poison=False):
    """One decode call of `kind` (flat flash_decode, paged on a bf16 pool,
    paged on an int8 pool) at Mistral-7B's tick shape; with `poison`,
    every K/V row (flat) or pool block (paged) outside the slots' live
    ranges holds NaN (an int8 block: garbage payload and NaN scales)."""
    if kind == "flat":
        q, k, v, posv = _decode_inputs(card, 4, 32, 8, 4096, 128,
                                       torch.bfloat16, pos)
        if poison:
            for i, p in enumerate(pos):
                lo = max(p - window + 1, 0)
                for t in (k, v):
                    t[i, :, p + 1:] = float("nan")
                    t[i, :, :lo] = float("nan")
        return lambda: flash_decode(q, k, v, posv, window=window)
    q, pk, pv, tables, posv = _paged_inputs(card, 4, 32, 8, None, 128, 16,
                                            256, torch.bfloat16, pos)
    live = set()
    for i, p in enumerate(pos):
        lo = max(p - window + 1, 0) // 16
        live |= set(tables[i, lo:p // 16 + 1].tolist())
    dead = [i for i in range(pk.shape[0]) if i not in live]
    if kind == "paged":
        if poison:
            pk[dead], pv[dead] = float("nan"), float("nan")
        return lambda: paged_flash_decode(q, pk, pv, tables, posv,
                                          window=window)
    (kq, ks), (vq, vs) = _int8(pk), _int8(pv)
    if poison:
        kq[dead], vq[dead] = 127, -127
        ks[dead], vs[dead] = float("nan"), float("nan")
    return lambda: paged_flash_decode(q, kq, vq, tables, posv, window=window,
                                      scale_k=ks, scale_v=vs)


@pytest.mark.parametrize("kind,pos", DEAD_ROW_CASES)
def test_decode_kernels_read_only_live_rows_at_mistral_shape(card, kind,
                                                              pos):
    """At the tick's depths and at the deep positions, NaN in every row
    or block outside the live ranges (and NaN int8 scales there) leaves
    each decode kernel's output finite and bit-identical."""
    want = _decode_call(card, kind, pos)()
    got = _decode_call(card, kind, pos, poison=True)()
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def _counters() -> dict:
    """Every decode and paged kernel's own count of its runs on the
    card."""
    from defer_tpu_torch.ops import flash_decode as fd
    from defer_tpu_torch.ops import paged_flash_decode as pfd
    from defer_tpu_torch.ops import paged_flash_prefill as pfp

    return {"flat": fd.card_runs, "paged": pfd.card_runs,
            "prefill": pfp.card_runs}


class _CudaOps(TorchDispatchMode):
    """Records the aten ops dispatched with a CUDA tensor among their
    arguments or results."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat = tree_leaves((args, kwargs, out))
        if any(isinstance(t, torch.Tensor) and t.is_cuda for t in flat):
            self.ops.append(str(func.overloadpacket))
        return out


_FILL_COPY = ("fill", "zero", "zeros", "full", "ones", "copy", "_to_copy",
              "clone", "index_put", "masked_fill")


def _ops_and_runs(call) -> tuple:
    """(the aten ops on CUDA tensors one call dispatches, each counter's
    advance over it), after a warm-up call."""
    call()
    torch.cuda.synchronize()
    before = {k: f() for k, f in _counters().items()}
    with _CudaOps() as mode:
        call()
    torch.cuda.synchronize()
    return mode.ops, {k: f() - before[k] for k, f in _counters().items()}


@pytest.mark.parametrize("kind", ["flat", "paged", "int8"])
def test_a_decode_call_is_one_cuda_kernel(card, kind):
    """The CTAs that share a sequence merge in the kernel (a thread
    block cluster): a call runs its kernel once on the card (its own
    `card_runs`), no split-K merge and no other counted kernel, and
    dispatches no fill or copy beside it (no workspace to clear): the
    only aten op on CUDA tensors is the output's allocation."""
    ops, runs = _ops_and_runs(_decode_call(card, kind, [4095, 2047, 130, 0]))
    main = "flat" if kind == "flat" else "paged"
    assert runs == {k: int(k == main) for k in runs}, runs
    assert not [op for op in ops if any(w in op for w in _FILL_COPY)], ops
    assert ops == ["aten.empty"], ops


@pytest.mark.parametrize("mb,start", [(256, 0), (256, 1984), (4, 0)])
def test_a_prefill_call_is_one_cuda_kernel(card, mb, start):
    """A 64-token chunk of Mistral-7B's heads runs the prefill kernel
    once on the card (its own `card_runs`), whether the launch plan cuts
    the table span among the ranks of a cluster (256 blocks: a phase-5
    chunk and a deep one) or not (4 blocks): the ranks merge inside the
    launch. No other counted kernel runs, and no fill or copy is
    dispatched beside it: the only aten ops on CUDA tensors are the
    output's allocation and its transposed view."""
    from defer_tpu_torch.ops.paged_flash_prefill import _prefill_plan

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    splits = _prefill_plan(sms, 1, 32, 8, 64, 16, mb)
    q, pk, pv, tables, _ = _paged_inputs(card, 1, 32, 8, 64, 128, 16, mb,
                                         torch.bfloat16, [start])
    at = torch.tensor([start], dtype=torch.int32, device=card)
    ops, runs = _ops_and_runs(
        lambda: paged_flash_prefill(q, pk, pv, tables, at, window=4096))
    assert (mb == 4) == (splits == 1)
    assert runs == {"flat": 0, "paged": 0, "prefill": 1}, runs
    assert ops == ["aten.empty", "aten.transpose"], ops


@pytest.mark.parametrize("int8", [False, True])
def test_prefill_gives_the_same_bits_every_call(card, int8):
    """A register read or written while a wgmma that owns it is in
    flight, or a rank's state read before it is written, shows as calls
    that differ: a deep chunk (start 1984, the ranks of each cluster
    walk their share of the live range and merge) on a bf16 and an int8
    pool, with allocations between the calls so the output lands at
    other addresses."""
    q, pk, pv, tables, at = _paged_inputs(card, 1, 32, 8, 64, 128, 16, 256,
                                          torch.bfloat16, [1984])
    scales = {}
    if int8:
        (pk, ks), (pv, vs) = _int8(pk), _int8(pv)
        scales = {"scale_k": ks, "scale_v": vs}
    first = paged_flash_prefill(q, pk, pv, tables, at, window=4096,
                                **scales)
    junk = []
    for i in range(100):
        junk.append(torch.empty(1 + 997 * i % 5000, device=card))
        got = paged_flash_prefill(q, pk, pv, tables, at, window=4096,
                                  **scales)
        assert torch.equal(got, first), f"call {i} differs"
        junk = junk[-8:]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_runs_from_a_fresh_thread(card, dtype):
    """A thread that has made no CUDA call (a fleet replica's serving
    thread) launches the prefill kernel on the tensors' card, the last
    one, and is left on that card: the entry point binds its context
    there (the pool maps are encoded under it) and sets no other card
    current."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    q, pk, pv, tables, at = _paged_inputs(dev, 2, 32, 8, 64, 128, 16, 64,
                                          dtype, [500, 37])
    torch.cuda.synchronize(dev)
    res = {}

    def work():
        try:
            res["got"] = paged_flash_prefill(q, pk, pv, tables, at,
                                             window=100)
            torch.cuda.synchronize(dev)
            res["device"] = torch.cuda.current_device()
        except Exception as exc:  # raised again in the test's thread
            res["error"] = exc

    t = threading.Thread(target=work)
    t.start()
    t.join()
    if "error" in res:
        raise res["error"]
    assert res["device"] == dev.index
    want = paged_flash_prefill_plain(q, pk, pv, tables, at, window=100,
                                     num_blocks=(500 + 63) // 16 + 1)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(res["got"], want, atol=tol, rtol=tol)


# -- the CNN ops and the image models --------------------------------------

# (op, attrs, NHWC input): strided SAME convs and pools whose padding is
# asymmetric at these sizes (MobileNetV2's Conv1 at 224 pads (0, 1)),
# beside symmetric ones.
CNN_CASES = [
    ("conv", {"features": 32, "kernel_size": 3, "strides": 2},
     (2, 224, 224, 3)),
    ("conv", {"features": 8, "kernel_size": 3, "strides": 2}, (2, 9, 9, 4)),
    ("conv", {"features": 16, "kernel_size": 1, "strides": 2,
              "use_bias": True}, (2, 8, 8, 16)),
    ("depthwise_conv", {"kernel_size": 5, "strides": 2}, (2, 8, 10, 16)),
    ("depthwise_conv", {"kernel_size": 3, "depth_multiplier": 2},
     (2, 7, 7, 8)),
    ("separable_conv", {"features": 24, "kernel_size": 3, "strides": 2},
     (2, 9, 8, 16)),
    ("max_pool", {"window": 3, "strides": 2, "padding": "SAME"},
     (2, 8, 8, 16)),
    ("max_pool", {"window": 3, "strides": 1, "padding": "SAME"},
     (2, 7, 7, 16)),
    ("avg_pool", {"window": 3, "strides": 2, "padding": "SAME"},
     (2, 8, 8, 16)),
    ("avg_pool", {"window": 3, "strides": 1, "padding": "SAME"},
     (2, 7, 7, 16)),
    ("batch_norm", {"eps": 1.001e-5}, (2, 7, 7, 16)),
]


@pytest.mark.parametrize(
    "op,attrs,shape", CNN_CASES,
    ids=[f"{c[0]}-{i}" for i, c in enumerate(CNN_CASES)],
)
def test_cnn_op_on_the_card_matches_the_cpu(card, monkeypatch, op, attrs,
                                            shape):
    """The card's cuDNN path against the port's CPU path on the same
    float32 inputs, with the params as stored and as a stage places
    them."""
    from defer_tpu_torch.ops import get_op

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gen = torch.Generator().manual_seed(0)
    params = get_op(op).init(gen, attrs, [shape], torch.float32)
    params = {k: v + 0.1 * torch.randn(v.shape, generator=gen)
              for k, v in params.items()}
    if "var" in params:
        params["var"] = params["var"].abs() + 0.5
    x = torch.randn(shape, generator=gen)
    want = get_op(op).apply(params, [x], attrs)
    on_card = {k: v.to(card) for k, v in params.items()}
    placed = get_op(op).place(on_card, attrs, torch.float32)
    for p in (on_card, placed):
        got = get_op(op).apply(p, [x.to(card)], attrs)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.is_contiguous()
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,image", [("vit_tiny", 32), ("vit_s16", 224),
                                        ("vit_b16", 224)])
def test_every_vit_reaches_the_kernel(card, name, image):
    """Every ViT zoo entry's attention takes the hand-written kernel
    (Dh 16 for vit_tiny, 64 for the others; S 17 and 197), none its
    raise: one launch a block."""
    model = get_model(name, image_size=image)
    params = cast_params_to_storage(
        model.init(torch.Generator(device=card).manual_seed(0)),
        DeferConfig(compute_dtype=torch.bfloat16),
    )
    x = torch.randn((2, image, image, 3), device=card, dtype=torch.bfloat16)
    before = flash_attention.launches
    with torch.inference_mode():
        out = model.graph.apply(params, x)
    torch.cuda.synchronize()
    layers = sum(1 for n in model.graph.nodes if n.op == "mha")
    assert flash_attention.launches - before == layers
    assert torch.isfinite(out.float()).all()


_COPY_OPS = ("aten::copy_", "aten::_to_copy", "aten::clone",
             "aten::contiguous")


def _kernels_by_op(run) -> dict:
    """Kernels launched by `run()`, by the PyTorch op that launched
    them; copies launched inside a pad (its interior write) are the pad's
    own and are left out."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        parent, in_pad = e.cpu_parent, False
        while parent is not None:
            in_pad |= parent.name in ("aten::pad", "aten::constant_pad_nd")
            parent = parent.cpu_parent
        if not (in_pad and e.name in _COPY_OPS):
            out.setdefault(e.name, []).extend(k.name for k in e.kernels)
    return out


def test_resnet50_stage_copies_no_weight(card):
    """A placed ResNet50 stage launches no copy a call (beyond its two
    zero pads' own writes): its conv kernels are stored so that cuDNN's
    OIHW view is channels-last, and each batch norm is one addcmul. The
    same graph on the stored params copies every conv kernel on every
    call."""
    from defer_tpu_torch.parallel.pipeline import Stage

    model = get_model("resnet50")
    config = DeferConfig(compute_dtype=torch.bfloat16)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    stage = Stage(model.graph, params, card, config)
    stored = cast_params_to_storage(params, config)
    x = torch.randn((8, 224, 224, 3), device=card, dtype=torch.bfloat16)
    convs = sum(1 for n in model.graph.nodes if n.op == "conv")
    bns = sum(1 for n in model.graph.nodes if n.op == "batch_norm")
    with torch.inference_mode():
        stage(x)
        placed = _kernels_by_op(lambda: stage(x))
        unplaced = _kernels_by_op(lambda: model.graph.apply(stored, x))
    copies = [k for op in _COPY_OPS for k in placed.get(op, [])]
    layout = [k for ks in placed.values() for k in ks
              if "nchwToNhwc" in k or "nhwcToNchw" in k]
    assert copies == [] and layout == [], (copies, layout)
    assert len(placed["aten::addcmul"]) == bns
    assert len(placed["aten::cudnn_convolution"]) >= convs
    assert sum(len(unplaced.get(op, [])) for op in _COPY_OPS) >= convs


def test_remote_stage_worker_on_the_card(card):
    """A bert_tiny stage dispatched over loopback to a worker on the card
    (bf16 weights, so it computes in bf16) relays what the same stage
    gives in a placed pipeline on the card, through flash_attention, and
    its frames carry the native codec."""
    from defer_tpu_torch.graph.partition import partition, stage_params
    from defer_tpu_torch.parallel.pipeline import Pipeline
    from defer_tpu_torch.runtime.remote_stage import (
        dispatch_stage,
        recv_results,
        send_activation,
        serve_stage,
    )
    from defer_tpu_torch.runtime.transport import ArrayReceiver, ArraySender

    model = get_model("bert_tiny", seq_len=16)
    config = DeferConfig(compute_dtype=torch.bfloat16)
    params = cast_params_to_storage(
        model.init(torch.Generator().manual_seed(0), batch_size=4), config
    )
    st0, st1 = partition(model.graph, ["encoder_1_out"])
    results = ArrayReceiver(0, host="127.0.0.1", accept_timeout_s=30.0)
    ports, bound, res = [], threading.Event(), {}

    def run():
        res["n"] = serve_stage(
            0, "127.0.0.1", results.port, listen_host="127.0.0.1",
            accept_timeout_s=30.0,
            announce=lambda p: (ports.append(p), bound.set()),
        )

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    assert bound.wait(30.0)
    got: list = []
    reader = threading.Thread(
        target=lambda: got.extend(recv_results(results)), daemon=True
    )
    reader.start()
    head = Pipeline([st0], params, [card], config)
    tail = Pipeline([st1], params, [card], config)
    ids = torch.randint(0, 128, (3, 4, 16),
                        generator=torch.Generator().manual_seed(1))
    send = ArraySender("127.0.0.1", ports[0])
    dispatch_stage(send, st1, stage_params(params, st1))
    before = flash_attention.launches
    acts = [head(x.to(card)) for x in ids]
    for a in acts:
        send_activation(send, a)
    send.close()
    worker.join(timeout=60)
    reader.join(timeout=60)
    results.close()
    layers = sum(1 for n in st1.nodes if n.op == "mha")
    assert res == {"n": 3} and len(got) == 3
    assert flash_attention.launches >= before + layers * 3
    assert set(results.schemes) == {(1,)}
    for a, out in zip(acts, got):
        assert out.dtype == torch.bfloat16
        torch.testing.assert_close(out.float(), tail(a).float().cpu(),
                                   atol=1e-2, rtol=1e-2)


def test_replicas_on_the_card_match_one_replica(card):
    """run_defer(replicas=2) over [cuda:0] * 4 streams bert_tiny's
    outputs in order, equal to one replica's on the card."""
    model = get_model("bert_tiny", seq_len=16)
    config = DeferConfig(compute_dtype=torch.bfloat16)
    params = model.init(torch.Generator(device=card).manual_seed(0),
                        batch_size=4)
    xs = [torch.randint(0, 128, (4, 16), device=card,
                        generator=torch.Generator(device=card).manual_seed(i))
          for i in range(6)]
    defer = DEFER(devices=[card] * 4, config=config)
    in_q, out_q = queue.Queue(), queue.Queue()
    for x in xs:
        in_q.put(x)
    in_q.put(None)
    defer.run_defer(model, ["encoder_1_out"], in_q, out_q, params=params,
                    replicas=2)
    assert defer.last_pipeline.num_replicas == 2
    one, _ = DEFER(devices=[card], config=config).build_pipeline(
        model, ["encoder_1_out"], params=params)
    for x in xs:
        torch.testing.assert_close(out_q.get_nowait(), one(x), rtol=0, atol=0)


# -- decode windows on CUDA graphs -----------------------------------------


def _window_model(card):
    cfg = llama_config(num_layers=2, dim=256, num_heads=4, num_kv_heads=2,
                       ffn_dim=512, vocab_size=512, max_len=128)
    dec = GptDecoder(cfg, compute_dtype=torch.bfloat16)
    params = dec.cast_params(
        dec.init(torch.Generator(device=card).manual_seed(0)))
    gen = torch.Generator().manual_seed(1)
    reqs = [(torch.randint(0, 512, (1, n), generator=gen), s)
            for n, s in ((5, 9), (9, 6), (3, 11), (12, 4), (7, 8))]
    return dec, params, reqs


def test_captured_window_equals_eager_k1_bit_for_bit(card):
    """decode_window=4 on a CUDA decoder replays a captured graph; its
    tokens equal the decode_window=1 ticks' bit for bit, and the server
    captures its greedy window once and keeps it."""
    dec, params, reqs = _window_model(card)
    k1, _ = serve_greedy(dec, params, reqs, max_batch=2)
    srv = DecodeServer(dec, params, max_batch=2, decode_window=4)
    rids = [srv.submit(p, s) for p, s in reqs]
    done = srv.run()
    for r, b in zip(rids, k1):
        assert torch.equal(done[r], b)
    assert srv.graph_replays == srv.dispatches > 0
    assert srv.graph_captures == 1
    assert list(srv._graphs) == [("argmax", False)]


def test_window_replays_launch_k_x_layers_kernels(card):
    """The profiler's flash_decode kernels during a served window run
    equal graph_replays x K x layers, which the server reports as
    window_kernel_launches, and so does the kernel's own count of its
    runs on the card; flash_decode.launches, a host counter, does not
    move on a replay."""
    from torch.profiler import ProfilerActivity, profile

    from defer_tpu_torch.ops.flash_decode import card_runs, reset_card_runs

    dec, params, reqs = _window_model(card)
    warm = DecodeServer(dec, params, max_batch=2, decode_window=4)
    srv = DecodeServer(dec, params, max_batch=2, decode_window=4)
    for p, s in reqs:
        warm.submit(p, s)
        srv.submit(p, s)
    warm.run()  # captures on its own buffers; srv captures anew below
    srv._admit()
    srv._tick()  # this server's capture (warm-up and capture launches)
    torch.cuda.synchronize()
    before = flash_decode.launches
    replays = srv.graph_replays
    reset_card_runs(card.index)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        srv.run()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "flash_decode" in e.name)
    done = srv.graph_replays - replays
    assert done > 0
    assert n == done * 4 * dec.cfg.num_layers
    assert card_runs(card.index) == n
    assert flash_decode.launches == before
    assert srv.window_kernel_launches == srv.graph_replays * 4 * 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_runs_count_each_eager_launch(card, dtype):
    """Each eager flash_decode launch adds one to the kernel's own count
    of its runs on the card (the tensor-core and the f32 kernel alike),
    as it adds one to the wrapper's host count."""
    from defer_tpu_torch.ops.flash_decode import card_runs, reset_card_runs

    gen = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(2, 8, 64, generator=gen, device=card).to(dtype)
    k = torch.randn(2, 2, 96, 64, generator=gen, device=card).to(dtype)
    v = torch.randn(2, 2, 96, 64, generator=gen, device=card).to(dtype)
    pos = torch.tensor([95, 7], dtype=torch.int32, device=card)
    flash_decode(q, k, v, pos)
    reset_card_runs(card.index)
    before = flash_decode.launches
    for _ in range(3):
        flash_decode(q, k, v, pos)
    assert card_runs(card.index) == flash_decode.launches - before == 3


def test_sampled_window_equals_k1_per_seed(card):
    dec, params, reqs = _window_model(card)
    samps = [SamplingParams(temperature=0.8, top_k=20, seed=7), None,
             SamplingParams(temperature=1.1, top_p=0.9, seed=3),
             SamplingParams(temperature=0.7, seed=5), None]
    k1, _ = serve_greedy(dec, params, reqs, max_batch=2, sampling=samps)
    k8, stats = serve_greedy(dec, params, reqs, max_batch=2,
                             sampling=samps, decode_window=8)
    for a, b in zip(k8, k1):
        assert torch.equal(a, b)
    assert stats["graph_replays"] > 0


def _serve_ids(dec, params, reqs, window, ids=None):
    srv = DecodeServer(dec, params, max_batch=2, decode_window=window)
    rids = [srv.submit(p, s, adapter_id=a)
            for (p, s), a in zip(reqs, ids or [0] * len(reqs))]
    done = srv.run()
    return [done[r] for r in rids], srv.graph_replays


def test_rolling_and_banked_windows_equal_k1(card):
    """A captured window over a rolling cache (its warm-up writes and
    restores slots 0 and W-1, both live here) and over LoRA banks (the
    adapter ids read in the graph) gives the decode_window=1 tokens."""
    from defer_tpu_torch.parallel.lora import stack_adapters
    from defer_tpu_torch.parallel.transformer_stack import lora_target_dims

    cfg = mistral_config(num_layers=2, dim=256, num_heads=4, num_kv_heads=2,
                         ffn_dim=512, vocab_size=512, max_len=128, window=16)
    roll = GptDecoder(cfg, compute_dtype=torch.bfloat16, rolling_cache=True)
    params = roll.cast_params(
        roll.init(torch.Generator(device=card).manual_seed(0)))
    gen = torch.Generator().manual_seed(2)
    reqs = [(torch.randint(0, 512, (1, n), generator=gen), s)
            for n, s in ((5, 30), (20, 9), (3, 25))]
    k1, _ = _serve_ids(roll, params, reqs, 1)
    k4, replays = _serve_ids(roll, params, reqs, 4)
    assert replays > 0
    for a, b in zip(k4, k1):
        assert torch.equal(a, b)

    flat = GptDecoder(cfg, compute_dtype=torch.bfloat16)
    lcfg = dataclasses.replace(cfg, lora_rank=8, lora_alpha=8.0)
    dims = lora_target_dims(lcfg)
    g = torch.Generator(device=card).manual_seed(3)
    trees = [{"stack": {
        key: (torch.randn(2, *shape, generator=g, device=card) * 0.05
              ).to(torch.bfloat16)
        for t in lcfg.lora_targets
        for key, shape in ((f"{t}:a", (dims[t][0], 8)),
                           (f"{t}:b", (8, dims[t][1])))}} for _ in range(2)]
    banked = stack_adapters(params, trees, lcfg)
    k1, _ = _serve_ids(flat, banked, reqs, 1, [1, 2, 0])
    k4, replays = _serve_ids(flat, banked, reqs, 4, [1, 2, 0])
    assert replays > 0
    for a, b in zip(k4, k1):
        assert torch.equal(a, b)


# -- the paged server's windows, mixed ticks and speculation on the card -----


def _paged_model(card):
    """A small bf16 llama on the card and five requests behind one shared
    16-token system prompt: (decoder, params, requests)."""
    cfg = llama_config(num_layers=2, dim=256, num_heads=4, num_kv_heads=2,
                       ffn_dim=512, vocab_size=512, max_len=128, window=40)
    dec = GptDecoder(cfg, compute_dtype=torch.bfloat16)
    params = dec.cast_params(
        dec.init(torch.Generator(device=card).manual_seed(0)))
    gen = torch.Generator().manual_seed(1)
    system = torch.randint(0, 512, (1, 16), generator=gen)
    reqs = [(torch.cat([system, torch.randint(0, 512, (1, n),
                                              generator=gen)], dim=1), s)
            for n, s in ((5, 9), (9, 6), (3, 11), (12, 4), (7, 8))]
    return dec, params, reqs


PAGED_KNOBS = dict(num_blocks=40, block_size=8, max_batch=2,
                   attention="pallas", prefix_cache=True, prefill_chunk=8)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_captured_paged_window_equals_eager_k1(card, kv_dtype):
    """decode_window=4 on a CUDA paged server replays a captured graph
    of the paged kernels; its tokens equal the decode_window=1 ticks'
    bit for bit, in bf16 and on an int8 pool, and the server captures
    its greedy window once."""
    dec, params, reqs = _paged_model(card)
    k1, _ = serve_paged(dec, params, reqs, kv_dtype=kv_dtype, **PAGED_KNOBS)
    srv = PagedDecodeServer(dec, params, decode_window=4, kv_dtype=kv_dtype,
                            **PAGED_KNOBS)
    rids = [srv.submit(p, s) for p, s in reqs]
    done = srv.run()
    for r, b in zip(rids, k1):
        assert torch.equal(done[r], b)
    assert srv.graph_replays == srv.dispatches > 0
    assert srv.graph_captures == 1
    assert list(srv._graphs) == [("decode", "argmax", False)]


@pytest.mark.parametrize("dtype,kv_dtype", [(torch.bfloat16, "fp"),
                                            (torch.float32, "fp"),
                                            (torch.bfloat16, "int8")])
def test_paged_card_runs_count_each_eager_launch(card, dtype, kv_dtype):
    """Each eager launch of either paged kernel adds one to the kernel's
    own count of its runs on the card, as to the wrapper's host count
    (a split prefill is one run: its ranks merge inside the launch)."""
    from defer_tpu_torch.ops import paged_flash_decode as pfd
    from defer_tpu_torch.ops import paged_flash_prefill as pfp

    gen = torch.Generator(device=card).manual_seed(0)
    pool = torch.randn(9, 2, 8, 64, generator=gen, device=card).to(dtype)
    scale = None
    if kv_dtype == "int8":
        pool, scale = quantize_symmetric(pool.float(), axis=(-2, -1))
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32,
                          device=card)
    pos = torch.tensor([29, 3], dtype=torch.int32, device=card)
    q1 = torch.randn(2, 8, 64, generator=gen, device=card).to(dtype)
    qt = torch.randn(2, 8, 5, 64, generator=gen, device=card).to(dtype)
    for wrapper, mod, q in ((paged_flash_decode, pfd, q1),
                            (paged_flash_prefill, pfp, qt)):
        wrapper(q, pool, pool, tables, pos, scale_k=scale, scale_v=scale)
        mod.reset_card_runs(card.index)
        host = "launches_int8" if scale is not None else "launches"
        before = getattr(wrapper, host)
        for _ in range(3):
            wrapper(q, pool, pool, tables, pos, scale_k=scale, scale_v=scale)
        assert mod.card_runs(card.index) == getattr(wrapper, host) - before \
            == 3


def _steady_window(srv, reqs):
    """Seat every slot (budgets far off), one window run to capture, and
    the replay closure; the window's static budget is refilled before
    each replay."""
    for p, _ in reqs[: srv.B]:
        srv.submit(p, 60)
    srv.step()
    assert all(s is not None for s in srv.slots)
    kind = "spec" if srv.spec_k else "decode"
    program = srv._window_program(kind, "argmax", False)
    w = srv._wbuf

    def replay():
        w["budget"].fill_(1 << 20)
        program()

    return replay


def test_paged_window_replay_runs_k_x_layers_decode_kernels(card):
    """One replay of a captured paged window runs paged_flash_decode
    K x layers times on the card (the kernel's own count: the wrapper's
    host count does not move on a replay), and no prefill kernel."""
    from defer_tpu_torch.ops import paged_flash_decode as pfd
    from defer_tpu_torch.ops import paged_flash_prefill as pfp

    dec, params, reqs = _paged_model(card)
    srv = PagedDecodeServer(dec, params, decode_window=4, **PAGED_KNOBS)
    replay = _steady_window(srv, reqs)
    torch.cuda.synchronize()
    host = paged_flash_decode.launches
    pfd.reset_card_runs(card.index)
    pfp.reset_card_runs(card.index)
    replay()
    replay()
    assert pfd.card_runs(card.index) == 2 * 4 * dec.cfg.num_layers
    assert pfp.card_runs(card.index) == 0
    assert paged_flash_decode.launches == host


def test_spec_window_verify_runs_the_prefill_kernel(card):
    """A captured speculative window (decode_window=4, spec_k=3, the
    target as its own draft): each replay's four verify steps run
    paged_flash_prefill once a layer each, by the kernel's count; its
    tokens equal spec_k=0's."""
    from defer_tpu_torch.ops import paged_flash_decode as pfd
    from defer_tpu_torch.ops import paged_flash_prefill as pfp

    dec, params, reqs = _paged_model(card)
    k1, _ = serve_paged(dec, params, reqs, **PAGED_KNOBS)
    spec = dict(spec_k=3, spec_draft=dec, spec_params=params)
    got, stats = serve_paged(dec, params, reqs, decode_window=4, **spec,
                             **PAGED_KNOBS)
    for a, b in zip(got, k1):
        assert torch.equal(a, b)
    assert stats["graph_replays"] > 0 and stats["spec_acceptance"] == 1.0
    srv = PagedDecodeServer(dec, params, decode_window=4, **spec,
                            **PAGED_KNOBS)
    replay = _steady_window(srv, reqs)
    torch.cuda.synchronize()
    pfp.reset_card_runs(card.index)
    pfd.reset_card_runs(card.index)
    replay()
    assert pfp.card_runs(card.index) == 4 * dec.cfg.num_layers
    assert pfd.card_runs(card.index) == 0


@pytest.mark.parametrize("spec_k", [0, 3])
def test_a_paged_window_replay_makes_no_sync(card, spec_k):
    """Under torch.cuda.set_sync_debug_mode("error"), a paged window's
    replay (and a speculative window's) makes no synchronizing call."""
    dec, params, reqs = _paged_model(card)
    spec = dict(spec_k=spec_k, spec_draft=dec, spec_params=params) \
        if spec_k else {}
    srv = PagedDecodeServer(dec, params, decode_window=4, kv_dtype="int8",
                            **spec, **PAGED_KNOBS)
    replay = _steady_window(srv, reqs)
    replay()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_mixed_ticks_and_constraints_on_the_card(card):
    """prefill_budget mixed ticks (eager, through paged_flash_prefill)
    give the stall path's tokens, and a constrained window the
    constrained K=1 ticks' tokens."""
    from defer_tpu_torch.constrain import compile_regex

    dec, params, reqs = _paged_model(card)
    k1, _ = serve_paged(dec, params, reqs, **PAGED_KNOBS)
    mixed, stats = serve_paged(dec, params, reqs, prefill_budget=16,
                               **PAGED_KNOBS)
    assert stats["mixed_ticks"] > 0
    for a, b in zip(mixed, k1):
        assert torch.equal(a, b)
    vocab = [""] + [chr(48 + i % 10) if i < 100 else f"<{i}>"
                    for i in range(1, 512)]
    cons = {"d": compile_regex("[0-9]+", vocab)}
    samp = [SamplingParams(constraint="d")] * len(reqs)
    runs = [serve_paged(dec, params, reqs, eos_id=0, constraints=cons,
                        sampling=samp, decode_window=K, **PAGED_KNOBS)[0]
            for K in (1, 4)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# -- fleet serving on one card -----------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_prefix_migration_between_servers_on_the_card(card, kv_dtype):
    """A parked system-prompt chain exported from one server on cuda:0
    and imported into another (the 16-token hit is two whole 8-token
    prefill chunks, so the suffix prefill chunks alike). A bf16 pool's
    blocks cross bit for bit, and the migrated request serves the same
    tokens as a local radix hit. An int8 pool's blocks cross the wire
    dequantized to bf16 (the JAX package's format) and requantize on
    landing: the payload comes back bit for bit, each (layer, block,
    head) scale within bf16's rounding (2^-8 relative), and every
    migrated token is within the int8 pool's accuracy contract (5% of
    its row's logit scale of the reference row max, as for any int8
    pool) instead of token-identical."""
    dec, params, reqs = _paged_model(card)
    from defer_tpu_torch.fleet import chain_digests

    knobs = dict(PAGED_KNOBS, kv_dtype=kv_dtype, device=card)
    src = PagedDecodeServer(dec, params, **knobs)
    src.submit(*reqs[0])
    src.run()
    keys = chain_digests(reqs[1][0], 2, 8)
    toks, k, v = src.export_prefix_blocks(keys)
    assert k.device.type == "cpu" and k.dtype == torch.bfloat16
    blks = [src.radix.by_key[key] for key in keys]
    rid = src.submit(*reqs[1])
    local = src.run()[rid]
    dst = PagedDecodeServer(dec, params, **knobs)
    assert dst.import_prefix_blocks(toks, k, v) == 2
    got = [dst.radix.by_key[key] for key in keys]
    for a, b in ((src.pool_k, dst.pool_k), (src.pool_v, dst.pool_v)):
        if kv_dtype == "fp":
            assert torch.equal(a[:, blks], b[:, got])
        else:
            assert torch.equal(a["q"][:, blks], b["q"][:, got])
            torch.testing.assert_close(b["s"][:, got], a["s"][:, blks],
                                       rtol=2**-8, atol=0)
    rid = dst.submit(*reqs[1])
    migrated = dst.run()[rid]
    assert dst.prefill_tokens_saved == 16
    if kv_dtype == "fp":
        assert torch.equal(migrated, local)
        return
    t_in = reqs[1][0].shape[1]
    rows = dec.reference_logits(params, migrated[:, :-1])[0, t_in - 1:]
    chosen = rows.gather(-1, migrated[0, t_in:].long()[:, None])[:, 0]
    gap = (rows.amax(-1) - chosen) / rows.abs().amax(-1)
    assert float(gap.max()) <= 0.05


def test_window_replicas_capture_concurrently(card):
    """Two decode_window=4 replicas on cuda:0, each on its own thread,
    capture their windows while the other serves; the fleet's tokens
    equal the decode_window=1 server's."""
    from defer_tpu_torch.fleet import FleetFrontend

    dec, params, reqs = _paged_model(card)
    k1, _ = serve_paged(dec, params, reqs, **PAGED_KNOBS)
    fe = FleetFrontend(dec, params, n_replicas=2, devices=[card],
                       decode_window=4, policy="round_robin",
                       **PAGED_KNOBS)
    try:
        gids = [fe.submit(p, s) for p, s in reqs]
        outs = [fe.result(g, timeout=300) for g in gids]
        captures = [r.srv.graph_captures for r in fe.replicas]
    finally:
        fe.close()
    assert captures == [1, 1]
    for a, b in zip(outs, k1):
        assert torch.equal(a, b)


def test_device_moves_cpu_params_to_the_card(card):
    """device="cuda:0" with a CPU decoder and CPU params moves them to the
    card and serves the CUDA server's tokens; params already on the card
    are shared, not copied; a card this process lacks raises."""
    dec, params, reqs = _paged_model(card)
    host = GptDecoder(dec.cfg, compute_dtype=torch.bfloat16, device="cpu")
    cpu_params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    srv = PagedDecodeServer(host, cpu_params, device="cuda:0", **PAGED_KNOBS)
    assert srv.device == card and srv.dec.device == card
    assert srv.params["token_embedding"].device == card
    got, _ = serve_paged(dec, params, reqs, **PAGED_KNOBS)
    rids = [srv.submit(p, s) for p, s in reqs]
    done = srv.run()
    for rid, want in zip(rids, got):
        assert torch.equal(done[rid], want)
    shared = PagedDecodeServer(dec, params, device="cuda", **PAGED_KNOBS)
    assert shared.params["token_embedding"] is params["token_embedding"]
    with pytest.raises(ValueError, match="device"):
        PagedDecodeServer(dec, params, **PAGED_KNOBS,
                          device=f"cuda:{torch.cuda.device_count()}")


# -- training on the card -----------------------------------------------------

BERT_BASE = dict(num_layers=12, dim=768, num_heads=12, ffn_dim=3072,
                 vocab_size=30522, max_len=512)


@pytest.mark.parametrize("remat", [False, True])
def test_bert_base_train_step_launches_the_kernel(card, remat):
    """A BERT-base-width classifier step on {"stage": 4} over the card
    launches flash_attention 12 x M times in its forward, and 24 x M
    under remat, whose backward recomputes each block (flash's own
    backward runs the plain version and launches nothing)."""
    import functools

    from defer_tpu_torch.models.bert import SpmdBert
    from defer_tpu_torch.parallel import train
    from defer_tpu_torch.parallel.mesh import make_mesh
    from defer_tpu_torch.parallel.transformer_stack import TransformerConfig

    m, b, s = 2, 4, 128
    cfg = TransformerConfig(**BERT_BASE, remat=remat)
    sb = SpmdBert(make_mesh({"stage": 4}, [card] * 4), cfg,
                  compute_dtype=torch.bfloat16)
    init, step = train.make_train_step(
        sb, functools.partial(torch.optim.AdamW, lr=1e-4), num_classes=2)
    state = init(torch.Generator(device=card).manual_seed(0))
    gen = torch.Generator(device=card).manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (m, b, s), generator=gen,
                        device=card)
    labels = torch.randint(0, 2, (m, b), generator=gen, device=card)
    before = flash_attention.launches
    state, loss = step(state, ids, labels)
    torch.cuda.synchronize()
    assert flash_attention.launches - before == (24 if remat else 12) * m
    assert loss.device == card and bool(torch.isfinite(loss))


def test_flash_gradient_on_the_card_equals_the_plain_ones(card):
    """_Flash's backward on bf16 card tensors (the kernel's forward, the
    plain version's recompute) against differentiating the plain version
    itself: bf16 tolerance, 2e-2 (the upstream gradient is the kernel's
    output, rounded to bf16 like the plain one's)."""
    gen = torch.Generator(device=card).manual_seed(3)
    for causal in (False, True):
        qkv = [torch.randn(2, 12, 128, 64, generator=gen, device=card)
               .bfloat16().requires_grad_() for _ in range(3)]
        g = torch.randn(2, 12, 128, 64, generator=gen, device=card).bfloat16()
        got = torch.autograd.grad(
            flash_attention(*qkv, causal=causal), qkv, g)
        want = torch.autograd.grad(
            flash_attention_plain(*qkv, causal=causal), qkv, g)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_dense_equals_a2a_on_the_card(card, k):
    """At BERT-base widths with 8 experts, the a2a dispatch at a capacity
    that cannot drop (cf = E / k) equals dense within the bf16 kernel
    tolerance (1e-2): the same routing, expert products batched
    differently."""
    from defer_tpu_torch.parallel import transformer_stack as ts

    cfg = ts.TransformerConfig(**dict(BERT_BASE, num_layers=1),
                               num_experts=8)
    p = {key: v[0] for key, v in ts.init_stack(
        torch.Generator(device=card).manual_seed(4), cfg).items()}
    x = torch.randn(8, 128, cfg.dim, device=card,
                    generator=torch.Generator(device=card).manual_seed(5))
    x = x.bfloat16()
    dense = ts.moe_ffn(p, x, top_k=k)
    a2a = ts.moe_ffn_a2a(p, x, capacity_factor=8 / k, top_k=k)
    torch.testing.assert_close(a2a, dense, atol=1e-2, rtol=1e-2)


# -- the training collectives: ranks sharing the card -----------------------

DIST_CFG = dict(num_layers=12, dim=768, num_heads=12, ffn_dim=3072,
                vocab_size=30522, max_len=512)


def _one_process(card, cfg_kw, ids, labels):
    """The {"stage": 1} run in this process: the worker's "card" run."""
    import functools

    from defer_tpu_torch.models.bert import SpmdBert
    from defer_tpu_torch.parallel import mesh, train
    from defer_tpu_torch.parallel.transformer_stack import TransformerConfig

    sb = SpmdBert(mesh.make_mesh({"stage": 1}, [card]),
                  TransformerConfig(**cfg_kw), compute_dtype=torch.bfloat16)
    init, step = train.make_train_step(
        sb, functools.partial(torch.optim.AdamW, lr=1e-5), num_classes=2)
    state = init(torch.Generator(device=card).manual_seed(0))
    ids, labels = (torch.from_numpy(a).to(card, torch.int64)
                   for a in (ids, labels))
    with torch.no_grad():
        pooled = sb.make_step()(state.params, ids).float().cpu()
    _, loss = step(state, ids, labels)
    return pooled, float(loss)


@pytest.mark.parametrize("axes,fsdp,launches", [
    ({"stage": 1, "model": 2}, False, 12 * 2),   # 6 heads a rank
    ({"data": 2, "stage": 1}, True, 12 * 2),
    ({"stage": 2}, False, 6 * (2 + 2 - 1)),      # the bubble steps too
], ids=["tp", "fsdp", "stage2"])
def test_two_gloo_ranks_on_the_card_match_one_process(card, tmp_path, axes,
                                                      fsdp, launches):
    """Two ranks on cuda:0 over gloo at BERT-base widths, M 2 x B 2 x S
    128: each rank's flash_attention launches a forward (every layer it
    holds, once a microbatch step), the pooled output within 5% relative
    L2 and step 1's loss within 1e-2 of one process on the same seeded
    weights (bf16: the order of the sums differs)."""
    import numpy as np

    from test_torch_dist_worker import spawn

    rng = np.random.default_rng(0)
    ids = rng.integers(0, DIST_CFG["vocab_size"], (2, 2, 128))
    labels = rng.integers(0, 2, (2, 2))
    case = dict(name="card", run="card", axes=axes, cfg=DIST_CFG, fsdp=fsdp,
                ids=ids, labels=labels)
    ranks = spawn({"device": "cuda", "cases": [case]}, 2, str(tmp_path))
    want, want_loss = _one_process(card, DIST_CFG, ids, labels)
    for got in (r["card"] for r in ranks):
        assert got["launches"] == launches
        rel = float(np.linalg.norm(got["forward"] - want.numpy())
                    / np.linalg.norm(want.numpy()))
        assert rel <= 5e-2, rel
        assert abs(got["loss"] - want_loss) <= 1e-2, (got["loss"], want_loss)


def test_every_collective_on_a_world_size_1_nccl_group(card, tmp_path):
    """NCCL at one rank: each op of parallel/collectives.py (psum, pvary,
    all_gather, all_to_all, ppermute, shard, unshard) forward and
    backward, each the identity."""
    import numpy as np

    from test_torch_dist_worker import spawn

    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    cot = np.random.default_rng(3).standard_normal((4, 12)).astype(
        np.float32)
    case = dict(name="ops", run="ops", axes={"seq": 1}, x=x, cot=cot)
    (ranks,) = spawn({"backend": "nccl", "device": "cuda",
                      "cases": [case]}, 1, str(tmp_path))
    assert len(ranks["ops"]) == 7
    for op, (y, g) in ranks["ops"].items():
        np.testing.assert_array_equal(y, x, err_msg=op)
        np.testing.assert_array_equal(g, cot[:4, :6], err_msg=op)


# -- sharded decode serving on the card -------------------------------------

# Dh 32: the paged kernels take Dh 32, 64 or 128.
SHARD_CFG = dict(num_layers=4, dim=128, num_heads=4, ffn_dim=256,
                 vocab_size=128, max_len=64, norm_style="pre")


def _shard_case(card):
    """A tiny f32 decoder's weights as numpy and three requests."""
    import numpy as np

    from defer_tpu_torch import params_to_numpy
    from defer_tpu_torch.parallel.transformer_stack import TransformerConfig

    dec = GptDecoder(TransformerConfig(**SHARD_CFG),
                     compute_dtype=torch.float32, device=card)
    params = dec.init(torch.Generator(device=card).manual_seed(0))
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(1, 128, (1, n)).astype(np.int32), s)
            for n, s in ((6, 7), (10, 5), (11, 6))]
    return dec, params, params_to_numpy(params), reqs


def test_paged_mesh_on_two_gloo_ranks_on_the_card(card, tmp_path):
    """PagedDecodeServer(mesh={"model": 2}) on two gloo ranks sharing
    cuda:0, "pallas" at K=1: each rank runs paged_flash_decode on its
    two KV heads L times a tick (its own card count), and the tokens are
    the mesh=None server's on the card (f32)."""
    import numpy as np

    from test_torch_dist_worker import _paged, spawn

    _, _, np_params, reqs = _shard_case(card)
    case = dict(name="paged", run="paged", axes={"model": 2},
                cfg=SHARD_CFG, params=np_params, phases=[reqs],
                knobs=dict(num_blocks=16, block_size=4, max_batch=2,
                           attention="pallas"))
    ranks = spawn({"device": "cuda", "cases": [case]}, 2, str(tmp_path))
    ctl = ranks[0]["paged"]
    for got in (r["paged"] for r in ranks):
        assert got["card_runs"] == {
            "paged_flash_decode": SHARD_CFG["num_layers"] * ctl["ticks"],
            "paged_flash_prefill": 0}
    want = _paged(dict(case, device="cuda"), None)
    for a, b in zip(ctl["tokens"], want["tokens"]):
        np.testing.assert_array_equal(a, b)


def test_pp_two_stages_on_one_card(card):
    """pp_stages=2 on [cuda:0] * 2, "pallas": every stage dispatch (a
    decode round at T=1 or a prefill chunk) runs paged_flash_prefill on
    each of its layers, the card's count equal to the dispatches', and
    the tokens are pp_stages=1's (f32)."""
    from defer_tpu_torch.ops import paged_flash_decode as pfd
    from defer_tpu_torch.ops import paged_flash_prefill as pfp

    dec, params, _, reqs = _shard_case(card)
    reqs = [(torch.from_numpy(p).long(), s) for p, s in reqs]
    kw = dict(num_blocks=16, block_size=4, max_batch=2, attention="pallas",
              decode_window=4)
    want, _ = serve_paged(dec, params, reqs, **kw)
    pfd.reset_card_runs()
    pfp.reset_card_runs()
    got, st = serve_paged(dec, params, reqs, pp_stages=2, pp_inflight=2,
                          pp_devices=[card] * 2, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    layers = SHARD_CFG["num_layers"] // 2
    assert pfp.card_runs() == layers * sum(st["pp_stage_dispatches"]) > 0
    assert pfd.card_runs() == 0


# -- the rest of the sharded legs on the card --------------------------------


def test_fleet_tp_replicas_on_two_gloo_ranks_on_the_card(card, tmp_path):
    """serve_fleet(model_axis_size=2) on two gloo ranks sharing cuda:0,
    "pallas": both replicas read mesh_shape "model=2" on both ranks, each
    rank's paged kernels ran on its head shard (its own card counts, the
    same on both ranks), one shard of the tree a rank, and the tokens
    are the mesh=None server's on the card (f32)."""
    import numpy as np

    from test_torch_dist_worker import _paged, spawn

    _, _, np_params, reqs = _shard_case(card)
    knobs = dict(num_blocks=16, block_size=4, max_batch=2,
                 attention="pallas")
    case = dict(name="fleet", run="fleet", axes={"model": 2}, cfg=SHARD_CFG,
                params=np_params, requests=reqs,
                knobs=dict(knobs, n_replicas=2, model_axis_size=2,
                           policy="round_robin"))
    ranks = spawn({"device": "cuda", "cases": [case]}, 2, str(tmp_path))
    ctl, follower = (r["fleet"] for r in ranks)
    for res in (ctl, follower):
        assert res["mesh_shapes"] == ["model=2", "model=2"]
        assert res["shards"] == 1
        assert res["card_runs"]["paged_flash_decode"] > 0
    assert ctl["card_runs"] == follower["card_runs"]
    want = _paged(dict(name="ref", cfg=SHARD_CFG, params=np_params,
                       knobs=knobs, phases=[reqs], device="cuda"), None)
    for a, b in zip(ctl["tokens"], want["tokens"]):
        np.testing.assert_array_equal(a, b)


def test_data_axis_and_pp_x_tp_on_four_gloo_ranks_on_the_card(card,
                                                             tmp_path):
    """Four gloo ranks sharing cuda:0, "pallas": a {"data": 2, "model":
    2} server (every rank runs paged_flash_decode L times a tick on its
    head shard) and pp 2 x tp 2 (each rank runs paged_flash_prefill on
    its stage's layers at every chain); the tokens are the mesh=None
    server's on the card (f32)."""
    import numpy as np

    from test_torch_dist_worker import _paged, spawn

    _, _, np_params, reqs = _shard_case(card)
    knobs = dict(num_blocks=16, block_size=4, max_batch=2,
                 attention="pallas")
    cases = [
        dict(name="dp", run="paged", axes={"data": 2, "model": 2},
             cfg=SHARD_CFG, params=np_params, phases=[reqs], knobs=knobs),
        dict(name="pp", run="paged", axes={"stage": 2, "model": 2},
             cfg=SHARD_CFG, params=np_params, phases=[reqs],
             knobs=dict(knobs, pp_stages=2, pp_inflight=2, decode_window=4)),
    ]
    ranks = spawn({"device": "cuda", "cases": cases}, 4, str(tmp_path))
    want = _paged(dict(cases[0], device="cuda"), None)
    L = SHARD_CFG["num_layers"]
    dp = [r["dp"] for r in ranks]
    for res in dp:
        assert res["card_runs"]["paged_flash_decode"] == L * dp[0]["ticks"]
    pp = [r["pp"] for r in ranks]
    for res in pp:
        chains = res["pp_dispatches"][0]
        assert res["card_runs"] == {"paged_flash_decode": 0,
                                    "paged_flash_prefill": L // 2 * chains}
    for name in ("dp", "pp"):
        for a, b in zip(ranks[0][name]["tokens"], want["tokens"]):
            np.testing.assert_array_equal(a, b)


def test_spmd_t5_on_two_gloo_ranks_on_the_card(card, tmp_path):
    """SpmdT5 at tp 2 on two gloo ranks sharing cuda:0 (f32): the greedy
    tokens and the step's logits of one T5 on the card (atol / rtol
    1e-4: the psums add the head groups in another order)."""
    import numpy as np

    from defer_tpu_torch import params_to_numpy
    from defer_tpu_torch.models.t5 import tiny_t5
    from test_torch_dist_worker import spawn

    single = tiny_t5(device=card, vocab_size=97)
    params = single.init(torch.Generator(device=card).manual_seed(0))
    rng = np.random.default_rng(1)
    enc = rng.integers(1, 97, (2, 6)).astype(np.int32)
    dec = rng.integers(0, 97, (2, 4)).astype(np.int32)
    mask = np.ones((2, 6), np.int32)
    case = dict(name="t5", run="t5", axes={"model": 2},
                cfg=dataclasses.asdict(single.cfg),
                params=params_to_numpy(params), enc=enc, dec=dec, mask=mask,
                steps=5)
    ranks = spawn({"device": "cuda", "cases": [case]}, 2, str(tmp_path))
    enc_t, dec_t = (torch.from_numpy(a).long() for a in (enc, dec))
    want = single.generate(params, enc_t, 5).cpu().numpy()
    _, cache = single.make_encode()(params, enc_t,
                                    torch.from_numpy(mask))
    logits, _ = single.make_step(donate=False)(params, cache, dec_t)
    for res in (r["t5"] for r in ranks):
        np.testing.assert_array_equal(res["generate"], want)
        np.testing.assert_allclose(res["step"], logits.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_sharded_checkpoint_and_inference_on_the_card(card, tmp_path):
    """Two gloo ranks sharing cuda:0: a ZeRO-1 SpmdBert state on
    {"data": 2} saved after 2 of 4 steps and restored into another
    seed's state ends bit for bit where the uninterrupted run ends; and
    ShardedInference over {"data": 2} gives the unsharded graph's output
    on the card on both ranks (f32, atol / rtol 1e-5)."""
    import numpy as np

    from defer_tpu_torch import Pipeline, params_to_numpy
    from defer_tpu_torch.graph.ir import GraphBuilder
    from test_torch_dist_worker import spawn

    b = GraphBuilder("chain")
    h = b.add("dense", b.input(), name="stem", features=8)
    for i in (1, 2):
        br = b.add("dense", h, name=f"blk{i}_dense", features=8)
        br = b.add("relu", br, name=f"blk{i}_relu")
        h = b.add("add", h, br, name=f"add_{i}")
    graph = b.build(b.add("dense", h, name="head", features=4))
    params = graph.init(torch.Generator().manual_seed(0), (4, 8))
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal((4, 8)).astype(np.float32) for _ in range(2)]
    cases = [
        dict(name="resume", run="resume", axes={"stage": 1, "data": 2},
             dir=str(tmp_path / "ckpt"), steps=4, at=2,
             cfg=dict(num_layers=2, dim=64, num_heads=4, ffn_dim=128,
                      vocab_size=64, max_len=16),
             ids=rng.integers(0, 64, (2, 4, 8)).astype(np.int32),
             labels=rng.integers(0, 2, (2, 4)).astype(np.int32)),
        dict(name="infer", run="infer", axes={"data": 2},
             params=params_to_numpy(params), xs=xs),
    ]
    (tmp_path / "ranks").mkdir()
    ranks = spawn({"device": "cuda", "cases": cases}, 2,
                  str(tmp_path / "ranks"))
    whole = Pipeline([graph], params, [card],
                     DeferConfig(compute_dtype=torch.float32))
    for r in ranks:
        res = r["resume"]
        assert res["sliced"] > 0 and res["restored_step"] == 2
        for a, b_ in zip(tree_leaves(res["straight"]),
                         tree_leaves(res["resumed"])):
            np.testing.assert_array_equal(a, b_)
        for got, x in zip(r["infer"]["outs"], xs):
            want = whole(torch.from_numpy(x).to(card)).cpu().numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- captured mesh windows, the capture and sync sanitizers -----------------


def test_captured_model1_mesh_windows_equal_eager(card):
    """PagedDecodeServer on a one-process {"model": 1} mesh at K=4
    captures its windows (its collectives are the identity): after a
    warm-up request of its own (the capture), the requests served under
    capture_sanitizer capture nothing, replay, count each replay's
    forwards in tp_psums, and give the same server's eager window's
    tokens (captures forced off) and mesh=None's."""
    from defer_tpu_torch.analysis import capture_sanitizer
    from defer_tpu_torch.parallel.mesh import make_mesh

    dec, params, reqs = _paged_model(card)
    want, _ = serve_paged(dec, params, reqs, **PAGED_KNOBS)

    def serve(srv):
        srv.done.clear()
        rids = [srv.submit(p, s) for p, s in reqs]
        done = srv.run()
        return [done[r] for r in rids]

    mesh = make_mesh({"model": 1}, [card])
    srv = PagedDecodeServer(dec, params, mesh=mesh, decode_window=4,
                            **PAGED_KNOBS)
    assert srv._captures
    srv.submit(torch.arange(300, 311)[None], 8)  # shares no block with reqs
    srv.run()
    assert srv.graph_captures == 1
    replays, psums = srv.graph_replays, srv.tp_psums
    with capture_sanitizer(srv) as rep:
        got = serve(srv)
    assert rep.captures == 0 and rep.watched
    assert srv.graph_replays > replays
    eager = PagedDecodeServer(dec, params, mesh=mesh, decode_window=4,
                              **PAGED_KNOBS)
    eager._captures = False
    plain = serve(eager)
    assert eager.graph_replays == 0
    # Each replay counts its K forwards, as each eager window does.
    L = dec.cfg.num_layers
    assert srv.tp_psums - psums == eager.tp_psums > 0
    assert eager.tp_psums % (2 * L + 2) == 0
    for a, c, d in zip(got, plain, want):
        assert torch.equal(a, c) and torch.equal(a, d)


def test_a_new_window_key_inside_a_sanitized_block_raises(card):
    """A warmed greedy server that meets its first sampled request inside
    capture_sanitizer captures a new window key: RecaptureError names
    it. With allow=1 the same block passes and reports it."""
    from defer_tpu_torch.analysis import RecaptureError, capture_sanitizer

    dec, params, reqs = _paged_model(card)
    for allow in (0, 1):
        srv = PagedDecodeServer(dec, params, decode_window=4, **PAGED_KNOBS)
        srv.submit(*reqs[0])
        srv.run()
        assert srv.graph_captures == 1
        srv.submit(*reqs[1], sampling=SamplingParams(temperature=0.8,
                                                     seed=5))
        if allow == 0:
            with pytest.raises(RecaptureError, match="nosort"):
                with capture_sanitizer(srv):
                    srv.run()
        else:
            with capture_sanitizer(srv, allow=1) as rep:
                srv.run()
            assert rep.captures == 1


def test_sync_sanitizer_counts_a_steady_window_drain(card):
    """A steady K=4 window with eos set drains its valid lengths and
    alive flags in one batched transfer: the sanitizer counts that one
    synchronizing call (and nothing else), allows it, raises below it,
    and restores the sync debug mode."""
    from defer_tpu_torch.analysis import HostSyncError, sync_sanitizer

    dec, params, reqs = _paged_model(card)
    srv = PagedDecodeServer(dec, params, decode_window=4, eos_id=511,
                            **PAGED_KNOBS)
    for p, _ in reqs[: srv.B]:
        srv.submit(p, 60)
    srv.step()
    srv.step()
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    with sync_sanitizer(allow=1) as rep:
        srv.step()
    assert rep.active and rep.syncs == 1, rep.messages
    assert torch.cuda.get_sync_debug_mode() == before
    with pytest.raises(HostSyncError):
        with sync_sanitizer(allow=0):
            srv.step()
    assert torch.cuda.get_sync_debug_mode() == before


def test_captured_windows_on_a_world_size_1_nccl_group(card, tmp_path):
    """The paged server on a world-size-1 NCCL process group at K=4
    decides to capture, replays its windows with the NCCL all-reduce and
    all-gather inside the graph, and serves mesh=None's tokens (f32)."""
    import numpy as np

    from test_torch_dist_worker import _paged, spawn

    _, _, np_params, reqs = _shard_case(card)
    case = dict(name="paged", run="paged", axes={"model": 1},
                cfg=SHARD_CFG, params=np_params, phases=[reqs],
                knobs=dict(num_blocks=16, block_size=4, max_batch=2,
                           attention="pallas", decode_window=4))
    (rank,) = spawn({"backend": "nccl", "device": "cuda", "cases": [case]},
                    1, str(tmp_path))
    got = rank["paged"]
    assert got["captures"] and got["graph_replays"] > 0
    assert got["tp_psums"] % (2 * SHARD_CFG["num_layers"] + 2) == 0
    want = _paged(dict(case, device="cuda", knobs=dict(
        case["knobs"], decode_window=1)), None)
    for a, b in zip(got["tokens"], want["tokens"]):
        np.testing.assert_array_equal(a, b)


def _pp_step_parts(srv):
    """chip_smoke.py's `_pp_step_parts` (one decode step of a seated
    pp_stages=1 server decomposed four ways), loaded from the file so
    that the smoke and this test share one copy."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke._pp_step_parts(srv)


def test_pp_rows_part_at_the_kernel_not_the_boundary(card):
    """The pp 2 vs pp 1 question at Mistral-7B width (2 layers, phase
    5's pool geometry, bf16): the stage boundary is exact (two stages
    give the whole stack's rows bit for bit, the activation crosses in
    the compute dtype), so the rows pp 2 serves can part from pp 1's
    only through what differs inside a step: the attention kernel (pp 1
    ticks through paged_flash_decode, a stage through
    paged_flash_prefill at T=1) and a group's GEMM M. Both stay within
    the split check's 0.25; the three servers' greedy tokens are
    reported through the same rows by chip_smoke.py."""
    cfg = mistral_config(num_layers=2)
    dec = GptDecoder(cfg, compute_dtype=torch.bfloat16)
    params = dec.cast_params(
        dec.init(torch.Generator(device=card).manual_seed(0)))
    gen = torch.Generator().manual_seed(4)
    srv = PagedDecodeServer(dec, params, num_blocks=1025, block_size=16,
                            max_batch=4, attention="pallas")
    for n in (70, 90, 110, 130):
        srv.submit(torch.randint(0, cfg.vocab_size, (1, n), generator=gen),
                   50)
    srv.step()
    srv.step()
    assert all(s is not None for s in srv.slots)
    parts = _pp_step_parts(srv)
    print(f"pp step parts: {parts}")
    assert parts["boundary"] == 0.0, parts
    assert parts["boundary_dtype"] == str(torch.bfloat16)
    assert parts["kernel"] <= 0.25 and parts["half_m"] <= 0.25, parts


# -- the example drivers over torchrun ranks sharing cuda:0 -----------------


def _torchrun(module: str, ranks: int, *argv: str, timeout: float = 600):
    """`torchrun --nproc-per-node ranks -m defer_tpu_torch.examples.module`
    on the one card (the ranks share cuda:0, so the drivers join gloo);
    returns rank 0's printed lines."""
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(ranks), "--master-addr", "127.0.0.1", "--master-port",
         str(port), "-m", f"defer_tpu_torch.examples.{module}", *argv],
        cwd=repo, env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=repo),
        capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    print(proc.stdout)
    return proc.stdout


def test_example_generate_tp2_on_two_gloo_ranks(card):
    out = _torchrun("generate", 2, "--tp", "2")
    assert "tensor-parallel decode over 2 ranks (NVIDIA" in out
    assert out.count("steady decode") == 1


def test_example_long_context_on_two_gloo_ranks(card):
    out = _torchrun("long_context", 2, "--seq", "4096", "--check")
    assert "over 2 ranks" in out and "matches unsharded reference" in out


def test_example_spmd_train_on_four_gloo_ranks_resumes(card, tmp_path):
    """The defaults (--stages 2 --tp 2, data = 1) on 4 ranks with a
    sharded checkpoint every 10 steps; a second run resumes it."""
    out = _torchrun("spmd_train", 4, "--ckpt-dir", str(tmp_path))
    assert "mesh dp=1 pp=2 tp=2" in out and "resumed" not in out
    assert "saved sharded checkpoint at step 19" in out
    out = _torchrun("spmd_train", 4, "--ckpt-dir", str(tmp_path), "--steps",
                    "2")
    assert f"resumed sharded state from {tmp_path}" in out


def test_example_finetune_lora_fsdp_on_four_gloo_ranks(card):
    out = _torchrun("finetune_lora", 4, "--fsdp")
    assert "mesh={'data': 2, 'stage': 2}, base FSDP-sharded" in out
    assert "finetune_lora OK" in out
