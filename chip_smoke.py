#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (defer_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; takes no arguments. Phases, each
printing one line per check and failing loudly:

  1. build    — compile every hand-written kernel of the main paths
                from the sources in this checkout (one nvcc per source,
                all started together);
  2. kernels  — each kernel against its plain PyTorch version on the
                card, at its main path's shape and at the edge cases,
                with the tolerance stated; then the kernel's time, the
                plain version's, one library call's (the yardstick, never
                used by the port) and the card's bound for the same work;
  3. main     — DEFER().run_defer on BERT-base at its published width
                (12 layers, dim 768, 12 heads, FFN 3072, vocab 30522),
                seq 128, batch 16, cut into 4 stages on the one card,
                random bf16 weights from a seeded generator, 64 streamed
                microbatches; outputs checked for shape, finiteness and
                against the unpartitioned graph on the card;
  4. decode   — DecodeServer(max_batch=4) over GptDecoder at
                mistral_config()'s full width and depth (32 layers, dim
                4096, 32 heads, 8 KV heads, FFN 14336, vocab 32000,
                window and max_len 4096), random bf16 weights from a
                seeded generator, serving the repo's 12-request mix;
                every output echoes its prompt and every generated token
                is a valid greedy choice under reference_logits within a
                stated tie tolerance; then the host and device time of
                one steady tick;
  5. report   — a JSON line of every kernel, the card's name and power
                limit, and last the line {"ok": true, "device": {...}}.

Every kernel launch count is zeroed just before each path (3, 4) and
read just after it; a path that did not launch its kernel fails.

Exits non-zero, and prints no result, when CUDA is unavailable, when the
package is not beside this file, or when any phase fails. Imports
neither jax nor defer_tpu.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import queue
import subprocess
import sys
import threading
import time

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate and bf16/fp16
# tensor-core rate. A bound is the larger of bytes/rate and ops/rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

BERT_CUTS = ["encoder_2_out", "encoder_5_out", "encoder_8_out"]
BATCH, SEQ, MICROBATCHES = 16, 128, 64

# The decode path: slots of the server, and the tie tolerance of the
# greedy-validity check (a served token's reference logit within this
# of its row's max; bf16 decoding through bucketed prefills and batched
# ticks computes the same math in other shapes than the reference).
DECODE_SLOTS = 4
GREEDY_TIE_TOL = 0.08
# flash_decode at the decode path's tick shape: (B, Hq, Hkv, S, Dh).
DECODE_SHAPE = (DECODE_SLOTS, 32, 8, 4096, 128)


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# Device cycles of the sleep that keeps the card busy while the host
# queues a timed run (about 0.1 s at the H100's 1.98 GHz boost clock).
SLEEP_CYCLES = 200_000_000


def cuda_time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of one call over `iters` back-to-back calls, by
    CUDA events. The card first sleeps for about 0.1 s, so the host
    queues the calls ahead of it and the events time the kernels back to
    back, not the host's enqueue (which for a small kernel can take
    longer than the kernel). Inputs stay L2-resident, as the main path
    leaves them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_time_us(fn, iters: int = 100) -> float:
    """Mean host time to issue one call, timed on an idle card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


# -- phase 1 ---------------------------------------------------------------

# Every hand-written kernel of the main path: (name, csrc source, the TPU
# kernel it replaces).
KERNELS = [
    ("flash_attention", "flash_attention.cu",
     "defer_tpu/ops/pallas_attention.py:134"),
    ("flash_decode", "flash_decode.cu",
     "defer_tpu/ops/pallas_attention.py:341"),
]


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, which counts its launches."""
    from defer_tpu_torch.ops.flash_attention import flash_attention
    from defer_tpu_torch.ops.flash_decode import flash_decode

    return {"flash_attention": flash_attention, "flash_decode": flash_decode}


def zero_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def phase_build() -> None:
    from defer_tpu_torch.utils import nvcc

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        futures = {
            name: pool.submit(nvcc.load_library, src)
            for name, src, _ in KERNELS
        }
        for name, fut in futures.items():
            fut.result()  # raises with nvcc's output on a failed build
    for name, src, _ in KERNELS:
        log(f"build: {name} ({src}) ready in "
            f"{nvcc.build_seconds[src]:.1f}s")
    log(f"build: all kernels in {time.perf_counter() - t0:.1f}s")


# -- phase 2 ---------------------------------------------------------------

# Tolerance of kernel vs plain, per dtype: both compute in f32 and round
# once at the end, so they differ by f32 summation order plus one
# rounding of the output: atol + rtol * |plain|, with a few ulps of the
# output dtype.
TOLERANCE = {"bfloat16": (1e-2, 1e-2), "float16": (2e-3, 2e-3),
             "float32": (1e-5, 1e-5)}


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _bert_qkv(gen, b, h, s, dh, dtype):
    """q, k, v as the main path hands them to the kernel: (B, H, S, Dh)
    strided views of (B, S, H*Dh) projections."""
    import torch

    out = []
    for _ in range(3):
        x = torch.randn(b, s, h * dh, generator=gen, device="cuda")
        out.append(x.to(dtype).view(b, s, h, dh).transpose(1, 2))
    return out


def check_flash_attention() -> dict:
    import torch

    from defer_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # (label, (B, H, S_q, Dh), S_k, dtype, causal)
    cases = [
        ("bert", (BATCH, 12, SEQ, 64), SEQ, bf16, False),
        ("causal", (BATCH, 12, SEQ, 64), SEQ, bf16, True),
        ("ragged77", (2, 12, 77, 64), 77, bf16, False),
        ("ragged200", (2, 12, 200, 64), 200, bf16, False),
        ("ragged200_causal", (2, 12, 200, 64), 200, bf16, True),
        ("cross_77x200_f16", (2, 12, 77, 64), 200, f16, False),
        ("dh128", (4, 8, SEQ, 128), SEQ, bf16, False),
        ("dh40_f32", (2, 4, 100, 40), 100, f32, False),
        ("f32", (4, 12, SEQ, 64), SEQ, f32, False),
        ("f32_causal", (4, 12, SEQ, 64), SEQ, f32, True),
    ]
    bert_err = None
    for label, (b, h, s_q, dh), s_k, dtype, causal in cases:
        q = _bert_qkv(gen, b, h, s_q, dh, dtype)[0]
        k, v = _bert_qkv(gen, b, h, s_k, dh, dtype)[1:]
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        want = flash_attention_plain(q, k, v, causal=causal)
        atol, rtol = TOLERANCE[_dtype_name(dtype)]
        err = (got.float() - want.float()).abs()
        max_err = err.max().item()
        within = bool(
            (err <= atol + rtol * want.float().abs()).all().item()
        )
        log(f"kernels: flash_attention {label} q={tuple(q.shape)} "
            f"s_k={s_k} {_dtype_name(dtype)} causal={causal}: max_abs_err "
            f"{max_err:.3e} (tol atol {atol:g} + rtol {rtol:g}) "
            f"{'ok' if within else 'FAIL'}")
        check(within and got.shape == q.shape and got.dtype == dtype,
              f"flash_attention {label} disagrees with its plain version")
        if label == "bert":
            bert_err = max_err

    q, k, v = _bert_qkv(gen, BATCH, 12, SEQ, 64, bf16)
    kernel_ms = cuda_time_ms(lambda: flash_attention(q, k, v))
    plain_ms = cuda_time_ms(lambda: flash_attention_plain(q, k, v))
    library_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)
    )
    nbytes = 4 * q.numel() * q.element_size()
    flops = 4 * BATCH * 12 * SEQ * SEQ * 64
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    log(f"kernels: flash_attention at {tuple(q.shape)} bf16: kernel_ms "
        f"{kernel_ms:.5f} plain_ms {plain_ms:.5f} library_ms (sdpa) "
        f"{library_ms:.5f} bound_us {bound_ms * 1e3:.3f} "
        f"({nbytes} B, {flops} FLOP)")
    return {
        "max_abs_err": bert_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": library_ms,
    }


def _decode_qkv(gen, b, hq, hkv, s, dh, dtype):
    """q as the decoder hands it to the kernel (q[:, :, 0, :] of a head
    split, a strided view) and one layer's k/v cache slices."""
    import torch

    q = torch.randn(b, 1, hq * dh, generator=gen, device="cuda").to(dtype)
    q = q.view(b, 1, hq, dh).transpose(1, 2)[:, :, 0, :]
    k, v = (
        torch.randn(b, hkv, s, dh, generator=gen, device="cuda").to(dtype)
        for _ in range(2)
    )
    return q, k, v


def check_flash_decode() -> dict:
    import torch

    from defer_tpu_torch.ops.flash_decode import (
        flash_decode,
        flash_decode_plain,
        live_rows,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    b, hq, hkv, s, dh = DECODE_SHAPE
    main_pos = [4095, 2047, 130, 0]
    # (label, (B, Hq, Hkv, S, Dh), dtype, pos, window)
    cases = [
        ("mistral", DECODE_SHAPE, bf16, main_pos, 4096),
        ("window256", (2, 32, 8, 4096, 128), bf16, [3000, 200], 256),
        ("mha_dh64", (2, 16, 16, 1024, 64), bf16, [1023, 77], None),
        ("g8", (2, 64, 8, 2048, 128), bf16, [2047, 500], None),
        ("ragged77", (3, 32, 8, 77, 128), bf16, [76, 0, 40], None),
        ("f32", (2, 32, 8, 1000, 128), f32, [999, 513], None),
        ("scalar_pos", DECODE_SHAPE, bf16, 2500, 4096),
    ]
    main_err = None
    for label, (cb, chq, chkv, cs, cdh), dtype, pos, window in cases:
        q, k, v = _decode_qkv(gen, cb, chq, chkv, cs, cdh, dtype)
        posv = torch.tensor(pos, dtype=torch.int32, device="cuda")
        got = flash_decode(q, k, v, posv, window=window)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        want = flash_decode_plain(q, k, v, posv, window=window)
        atol, rtol = TOLERANCE[_dtype_name(dtype)]
        err = (got.float() - want.float()).abs()
        max_err = err.max().item()
        within = bool(
            (err <= atol + rtol * want.float().abs()).all().item()
        )
        log(f"kernels: flash_decode {label} q={tuple(q.shape)} "
            f"k={tuple(k.shape)} {_dtype_name(dtype)} pos={pos} "
            f"window={window}: max_abs_err {max_err:.3e} (tol atol "
            f"{atol:g} + rtol {rtol:g}) {'ok' if within else 'FAIL'}")
        check(within and got.shape == q.shape and got.dtype == dtype,
              f"flash_decode {label} disagrees with its plain version")
        if label == "mistral":
            main_err = max_err

    q, k, v = _decode_qkv(gen, b, hq, hkv, s, dh, bf16)
    posv = torch.tensor(main_pos, dtype=torch.int32, device="cuda")
    kernel_ms = cuda_time_ms(lambda: flash_decode(q, k, v, posv,
                                                  window=4096))
    wrapper_us = host_time_us(lambda: flash_decode(q, k, v, posv,
                                                   window=4096))
    plain_ms = cuda_time_ms(lambda: flash_decode_plain(q, k, v, posv,
                                                       window=4096))
    j = torch.arange(s, device="cuda")
    mask = ((j[None, :] <= posv[:, None])
            & (j[None, :] > posv[:, None] - 4096))[:, None, None, :]
    library_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True
        )
    )
    live = sum(live_rows(p, s, 4096) for p in main_pos)
    itemsize = q.element_size()
    nbytes = (2 * live * hkv * dh + 2 * b * hq * dh) * itemsize
    flops = 4 * live * (hq // hkv) * hkv * dh
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    log(f"kernels: flash_decode at q={tuple(q.shape)} k={tuple(k.shape)} "
        f"bf16 pos={main_pos}: kernel_ms {kernel_ms:.5f} plain_ms "
        f"{plain_ms:.5f} library_ms (sdpa over all {s} rows, enable_gqa) "
        f"{library_ms:.5f} bound_us {bound_ms * 1e3:.3f} ({live} live rows "
        f"of {b * s}: {nbytes} B, {flops} FLOP); the wrapper's host time "
        f"{wrapper_us:.2f} us a call")
    return {
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": library_ms,
    }


def phase_kernels() -> dict:
    return {
        "flash_attention": check_flash_attention(),
        "flash_decode": check_flash_decode(),
    }


# -- phase 3 ---------------------------------------------------------------

def run_main_path(
    device,
    model_name: str = "bert_base",
    batch: int = BATCH,
    seq: int = SEQ,
    microbatches: int = MICROBATCHES,
    cuts=BERT_CUTS,
    tol: float = 1e-2,
) -> dict:
    """Stream `microbatches` token batches through DEFER.run_defer on
    `device` and check the outputs; returns the launch counts of the
    run and its throughput. `device` is the card in this script."""
    import torch

    from defer_tpu_torch import DEFER, DeferConfig
    from defer_tpu_torch.models import get_model
    from defer_tpu_torch.parallel.pipeline import cast_params_to_storage

    model = get_model(model_name, seq_len=seq)
    config = DeferConfig(compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, batch_size=batch)
    vocab = model.graph.node_map["token_embedding"].attrs["vocab_size"]
    ids = torch.randint(
        0, vocab, (microbatches, batch, seq),
        generator=torch.Generator().manual_seed(1),
    )
    dim = model.graph.node_map["pooler_dense"].attrs["features"]

    # The unpartitioned graph, same weights and dtype, same device.
    with torch.inference_mode():
        want = model.graph.apply(
            cast_params_to_storage(params, config), ids[0].to(device)
        ).float()

    defer = DEFER(devices=[device], config=config)
    in_q: "queue.Queue" = queue.Queue()
    out_q: "queue.Queue" = queue.Queue()
    errors: list[BaseException] = []

    def serve() -> None:
        try:
            defer.run_defer(model, cuts, in_q, out_q, params=params)
        except BaseException as e:  # relayed to the main thread
            errors.append(e)

    zero_launches()
    t0 = time.perf_counter()
    worker = threading.Thread(target=serve, daemon=True)
    worker.start()
    for i in range(microbatches):
        in_q.put(ids[i])
    in_q.put(None)
    outs = []
    t_first = None
    for _ in range(microbatches):
        while True:
            try:
                outs.append(out_q.get(timeout=5.0))
                break
            except queue.Empty:
                check(not errors, f"run_defer raised: {errors!r}")
                check(worker.is_alive(), "run_defer ended early")
                check(time.perf_counter() - t0 < 600,
                      "run_defer made no output for 600s")
        if t_first is None:
            t_first = time.perf_counter()
    worker.join(timeout=60)
    t_end = time.perf_counter()
    launches = read_launches()
    check(not errors, f"run_defer raised: {errors!r}")
    check(not worker.is_alive(), "run_defer did not end after the sentinel")
    check(out_q.empty(), "run_defer produced more outputs than inputs")
    check(defer.last_pipeline.num_stages == len(cuts) + 1,
          f"expected {len(cuts) + 1} stages")

    for i, out in enumerate(outs):
        check(tuple(out.shape) == (batch, dim),
              f"output {i} has shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out.float()).all().item()),
              f"output {i} is not finite")
    err0 = (outs[0].float().cpu() - want.cpu()).abs().max().item()
    check(err0 <= tol,
          f"microbatch 0 differs from the unpartitioned graph by {err0}")
    layers = sum(1 for n in model.graph.nodes if n.op == "mha")
    check(launches["flash_attention"] >= layers * microbatches,
          f"flash_attention launched {launches['flash_attention']} times, "
          f"expected >= {layers} x {microbatches}")
    steady = (microbatches - 1) / (t_end - t_first)
    return {
        "launches": launches,
        "err0": err0,
        "tol": tol,
        "stages": defer.last_pipeline.num_stages,
        "seconds_total": t_end - t0,
        "microbatches_per_sec": steady,
        "items_per_sec": steady * batch,
        "tokens_per_sec": steady * batch * seq,
    }


def phase_main() -> dict:
    import torch

    res = run_main_path(torch.device("cuda", 0))
    log(f"main: run_defer bert_base seq {SEQ} batch {BATCH}, "
        f"{res['stages']} stages on cuda:0, {MICROBATCHES} microbatches: "
        f"all outputs ({BATCH}, 768) finite; microbatch 0 vs unpartitioned "
        f"graph max_abs_err {res['err0']:.3e} (tol {res['tol']:g}, bf16)")
    log(f"main: flash_attention launches {res['launches']['flash_attention']}"
        f" (>= 12 x {MICROBATCHES}); steady state "
        f"{res['items_per_sec']:.1f} items/s, {res['tokens_per_sec']:.0f} "
        f"tokens/s; whole run incl. stage placement "
        f"{res['seconds_total']:.2f}s")
    return res


# -- phase 4 ---------------------------------------------------------------

def decode_requests(vocab: int) -> list:
    """The repo's serving mix (bench.py's decode workload): 12 requests,
    prompt lengths 16 + (i*23) % 112, steps 16 + (i*11) % 48, prompt
    ids from a seeded generator."""
    import torch

    gen = torch.Generator().manual_seed(1)
    return [
        (torch.randint(0, vocab, (1, 16 + (i * 23) % 112), generator=gen),
         16 + (i * 11) % 48)
        for i in range(12)
    ]


def _family(name: str) -> str:
    n = name.lower()
    if "flash_decode" in n:
        return "flash_decode"
    if any(t in n for t in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
        return "matmul"
    return "other"


def tick_split(dec, params, depth: int, reps: int = 5) -> dict:
    """One steady decode tick (the batched step, the idle-slot pin and
    the argmax, as DecodeServer._tick runs them) with every slot at
    `depth`: the host ms to issue it on an idle card (median of
    `reps`), its wall ms to completion, and from torch.profiler its
    device ms by kernel family and its kernel launches. Fails if the
    tick makes a synchronizing CUDA call."""
    import torch

    step = dec.make_step()
    cache = dec.init_cache(DECODE_SLOTS)
    active = torch.ones(DECODE_SLOTS, dtype=torch.bool, device="cuda")
    feed = torch.zeros((DECODE_SLOTS, 1), dtype=torch.int32, device="cuda")

    def tick():
        cache["pos"] = torch.full((DECODE_SLOTS,), depth, dtype=torch.int32,
                                  device="cuda")
        logits, out = step(params, cache, feed)
        torch.where(active, out["pos"], 0)
        return torch.argmax(logits[:, -1, :], dim=-1)

    for _ in range(3):
        tick()
    # The tick must not wait for the card: any synchronizing CUDA call
    # in it raises here.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tick()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tick()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        tick()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            tick()
        torch.cuda.synchronize()
    fam_us: dict = {}
    launches = 0
    for e in prof.key_averages():
        dt = e.self_device_time_total
        if dt <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = _family(e.key)
        fam_us[fam] = fam_us.get(fam, 0.0) + dt
        launches += e.count
    device_ms = sum(fam_us.values()) / reps / 1e3
    check(device_ms > 0, "the profiler saw no device time in the tick")
    return {
        "host_ms": sorted(host)[reps // 2],
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "family_ms": {k: v / reps / 1e3 for k, v in sorted(fam_us.items())},
        "launches": launches / reps,
        "idle_share": 1.0 - device_ms / wall_ms,
    }


def phase_decode() -> dict:
    import torch

    from defer_tpu_torch import DecodeServer, GptDecoder, mistral_config

    cfg = mistral_config()
    dec = GptDecoder(cfg, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = dec.cast_params(
        dec.init(torch.Generator(device="cuda").manual_seed(0))
    )
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    leaves = [params["token_embedding"], params["final_ln_scale"],
              *params["stack"].values()]
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"decode: GptDecoder(mistral_config(), bf16): {cfg.num_layers} "
        f"layers, dim {cfg.dim}, {cfg.num_heads} heads, {cfg.kv_heads} KV "
        f"heads, FFN {cfg.ffn_dim}, vocab {cfg.vocab_size}, window "
        f"{cfg.window}, max_len {cfg.max_len}; {n_params} params, "
        f"{weight_bytes} B; init + cast {time.perf_counter() - t0:.1f}s, "
        f"peak {peak_gb:.1f} GB")

    reqs = decode_requests(cfg.vocab_size)
    srv = DecodeServer(dec, params, max_batch=DECODE_SLOTS)
    rids = [srv.submit(p, s) for p, s in reqs]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    generated = sum(s for _, s in reqs)
    check(len(done) == len(reqs), f"{len(done)} of {len(reqs)} served")
    check(launches["flash_decode"] >= cfg.num_layers * srv.ticks,
          f"flash_decode launched {launches['flash_decode']} times, "
          f"expected >= {cfg.num_layers} x {srv.ticks} ticks")

    gaps = []
    for (prompt, steps), rid in zip(reqs, rids):
        out = done[rid]
        t_in = prompt.shape[1]
        check(tuple(out.shape) == (1, t_in + steps),
              f"request {rid}: output shape {tuple(out.shape)}")
        check(torch.equal(out[:, :t_in].cpu(), prompt),
              f"request {rid}: the prompt does not come back verbatim")
        rows = dec.reference_logits(params, out[:, :-1])[0, t_in - 1:]
        toks = out[0, t_in:].long()
        gaps.append(rows.amax(dim=-1) - rows.gather(-1, toks[:, None])[:, 0])
    gaps = torch.cat(gaps).float().cpu()
    q = torch.quantile(gaps, torch.tensor([0.5, 0.9, 0.99, 1.0])).tolist()
    n_tied = int((gaps > 0).sum())
    log(f"decode: {len(reqs)} requests served, {generated} tokens in "
        f"{srv.ticks} ticks ({generated / srv.ticks:.2f} tokens a tick, "
        f"{srv.solo_steps} solo steps), {wall:.3f}s, "
        f"{generated / wall:.1f} tokens/s incl. admission prefills")
    log(f"decode: flash_decode launches {launches['flash_decode']} "
        f"(>= {cfg.num_layers} x {srv.ticks} ticks)")
    log(f"decode: every output echoes its prompt; greedy gap (reference "
        f"row max - chosen token's logit) over {gaps.numel()} tokens: "
        f"median {q[0]:.4g}, p90 {q[1]:.4g}, p99 {q[2]:.4g}, max "
        f"{q[3]:.4g}; {n_tied} tokens not the reference's argmax "
        f"(tie tolerance {GREEDY_TIE_TOL})")
    check(q[3] <= GREEDY_TIE_TOL,
          f"a generated token is {q[3]:.4g} below the reference row max")

    ticks = srv.ticks
    del srv, done
    torch.cuda.empty_cache()
    depth = 150
    split = tick_split(dec, params, depth)
    weight_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"decode: one steady tick, {DECODE_SLOTS} slots at depth {depth}: "
        f"host {split['host_ms']:.4f} ms to issue (idle card), wall "
        f"{split['wall_ms']:.4f} ms, device {split['device_ms']:.4f} ms of "
        f"kernels ({split['launches']:.0f} launches, no host sync; "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in split["family_ms"].items())
        + f"); idle share {split['idle_share']:.4f}; weight read bound "
        f"{weight_ms:.4f} ms ({weight_bytes} B at 3.35 TB/s)")
    return {"launches": launches, "ticks": ticks}


# -- entry point -----------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError:
        log("FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "defer_tpu_torch")):
        log(f"FAIL: the defer_tpu_torch package is not beside {__file__}")
        return 1
    sys.path.insert(0, here)
    log(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    try:
        card = card_line()
        phase_build()
        kernels = phase_kernels()
        main_res = phase_main()
        decode_res = phase_decode()
        for name in ("jax", "defer_tpu"):
            check(name not in sys.modules, f"{name} was imported")
    except Exception as e:  # every phase failure ends the run non-zero
        log(f"FAIL: {type(e).__name__}: {e}")
        return 1
    # Each kernel's launches are those of the path that runs it.
    path_launches = {
        "flash_attention": main_res["launches"]["flash_attention"],
        "flash_decode": decode_res["launches"]["flash_decode"],
    }
    report = []
    for name, src, replaces in KERNELS:
        k = kernels[name]
        report.append({
            "name": name,
            "route": "cuda",
            "source": f"defer_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": path_launches[name],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
    log(json.dumps({"kernels": report}))
    log(card)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
