#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (defer_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; takes no arguments. Phases, each
printing one line per check and failing loudly:

  1. build    — compile every hand-written kernel of the main path from
                the sources in this checkout (one nvcc per source, all
                started together);
  2. kernels  — each kernel against its plain PyTorch version on the
                card, at the main path's shape and at the edge cases,
                with the tolerance stated; then the kernel's time, the
                plain version's, one library call's (the yardstick, never
                used by the port) and the card's bound for the same work;
  3. main     — DEFER().run_defer on BERT-base at its published width
                (12 layers, dim 768, 12 heads, FFN 3072, vocab 30522),
                seq 128, batch 16, cut into 4 stages on the one card,
                random bf16 weights from a seeded generator, 64 streamed
                microbatches; outputs checked for shape, finiteness and
                against the unpartitioned graph on the card; the kernel
                launch counts are zeroed just before and read just after;
  4. report   — a JSON line of every kernel, the card's name and power
                limit, and last the line {"ok": true, "device": {...}}.

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


def cuda_time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean time of one call over `iters` back-to-back calls, by CUDA
    events (inputs stay L2-resident, as the main path leaves them)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 1 ---------------------------------------------------------------

# Every hand-written kernel of the main path: (name, csrc source, the TPU
# kernel it replaces).
KERNELS = [
    ("flash_attention", "flash_attention.cu",
     "defer_tpu/ops/pallas_attention.py:134"),
]


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


def phase_kernels() -> dict:
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
        "flash_attention": {
            "max_abs_err": bert_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": library_ms,
        }
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
    from defer_tpu_torch.ops.flash_attention import flash_attention
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

    flash_attention.launches = 0
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
    launches = {"flash_attention": flash_attention.launches}
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
        for name in ("jax", "defer_tpu"):
            check(name not in sys.modules, f"{name} was imported")
    except Exception as e:  # every phase failure ends the run non-zero
        log(f"FAIL: {type(e).__name__}: {e}")
        return 1
    report = []
    for name, src, replaces in KERNELS:
        k = kernels[name]
        report.append({
            "name": name,
            "route": "cuda",
            "source": f"defer_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": main_res["launches"][name],
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
