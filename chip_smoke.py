#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (defer_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; takes no arguments. Phases, each
printing one line per check and failing loudly:

  1. build    — compile every hand-written kernel of the main paths
                from the sources in this checkout (one nvcc per source,
                all started together);
  2. kernels  — each kernel against its plain PyTorch version on the
                card, at its main paths' shapes (flash_attention at
                BERT's, at ViT-B/16's and, causal, at GPT-2 small's
                training shape) and at the edge cases,
                with the tolerance stated (the decode kernels also at the
                depths of the serving ticks, TICK_POS, beside the deep
                mix DEEP_POS, and both are timed); then the kernel's time,
                the
                plain version's, one library call's (the yardstick, never
                used by the port) and the card's bound for the same work;
                the paged kernels on a float pool and on an int8 pool
                with per-(block, head) scales (the int8 one also with its
                dead blocks poisoned: payload garbage, scale NaN); the
                prefill kernel also at deep chunks (starts 1984 and
                4032, where a cluster's ranks split the live columns and
                merge inside the launch), at bs 4 (TMA boxes of 4 rows), its
                start-1984 times reported beside the main chunk's;
  3. main     — DEFER().run_defer on BERT-base at its published width
                (12 layers, dim 768, 12 heads, FFN 3072, vocab 30522),
                seq 128, batch 16, cut into 4 stages on the one card,
                random bf16 weights from a seeded generator, 64 streamed
                microbatches; outputs checked for shape, finiteness and
                against the unpartitioned graph on the card;
     cnn      — ResNet50 (224x224x3, 1000 classes) and ViT-B/16 (12
                layers, dim 768, 12 heads, MLP 3072, patch 16) through
                DEFER().run_defer at batch 32, 64 microbatches, cut into
                4 stages (ResNet50 at model.default_cuts(4); ViT at
                block_2/5/8_out, on flash_attention at S = 197), random
                bf16 weights from a seeded generator; every output
                checked (shape, finite, softmax rows summing to 1) and
                microbatch 0 against the unpartitioned graph; images/s
                and MFU (graph_flops over the card's peak); ResNet50 also
                on partition_layers="auto" over [cuda:0] x 4; entry()
                once; then every other zoo entry's bf16 forward at batch
                8 and its published resolution against f32 on the card;
     socket   — DEFER's own deployment: two `python -m defer_tpu_torch
                serve-stage` worker processes on the card, ResNet50 (its
                logits) cut at add_8 as the reference's test.py cuts it,
                dispatched tail-first over loopback, 32 microbatches of
                8 streamed from this process and relayed back to it on
                lossless zstd frames (every frame checked native, scheme
                1; every result against the unpartitioned graph placed
                on the card), then again with the images sent as int8
                frames (the head worker checked to receive them so; held
                to the lossless run); images/s, each hop's codec bytes and one
                hop's codec ms; then a BERT-base stage served in a thread
                of this process, its flash_attention launches counted;
     replicas — ResNet50 through run_defer(replicas=2) over [cuda:0] x 4
                at batch 32, in stream order and equal to replicas=1;
                three readings of each, alternating;
     keras    — a functional Keras JSON string (a residual CNN at
                224x224) through run_defer on "auto" cuts, against the
                imported graph's forward;
     roofline, checkpoint — ResNet50's batch-32 roofline on this card
                beside phase cnn's measured ms, and a bit-equal
                save_checkpoint/load_checkpoint round trip of its params;
     train    — training on cuda:0, params f32 and compute bf16, random
                weights from seeded generators: SpmdBert at bench.py
                bench_bert's shape (BERT-base, {"stage": 1}, M 8 x B 16
                x S 128; tokens/s, MFU, 96 flash_attention launches a
                step, pooled output against an f32 forward through the
                plain attention); the BERT-base classifier on
                {"stage": 4} over [cuda:0] x 4 (8 AdamW steps on one
                batch, the loss falling; step 1's loss and gradient norm
                against an f32 plain computation; step ms, peak memory,
                launches; one remat step: the same loss, twice the
                launches, a lower peak); the MoE FFN with 8 experts at
                top-1 and top-2 (a2a against dense at a capacity that
                cannot drop, the dropped share at cf 1.25, a train step
                each dispatch); GPT-2 small (HF gpt2's widths) trained
                as an LM on an lm_batches block of 512 tokens, its
                pipeline logits against GptDecoder.reference_logits,
                and its flattened tree served on DecodeServer at K=1
                under the split greedy check; DPO (step 1 at log 2, the
                reference tree bit for bit) and LoRA rank 16 (the base
                bit for bit, no .grad);
     dist     — the training collectives (parallel/collectives.py):
                each op once on a world-size-1 NCCL group on cuda:0 (and
                NCCL refused for two ranks on one card), then two gloo
                ranks sharing cuda:0 (this script with --dist-rank),
                started once: tp + LoRA rank 16, dp, dp + ZeRO-1, FSDP,
                ep at 8 experts top-2 (dense and a2a), sp ring and
                Ulysses, and the stage axis across the ranks, at
                BERT-base widths and depth, each a forward and 2 AdamW
                steps against the one-process {"stage": 1} run on the
                same card, weights and batch (pooled, step-1 loss, ZeRO-1
                bit for bit against plain dp); each layout's step ms
                beside one process's, the bytes its collectives move a
                step by axis, flash_attention launches a step per rank;
                then on the same two ranks the rest of the sharded legs:
                SpmdT5 at T5-base tp 2 (phase t5's batch and steps, both
                ranks' tokens equal, rank 0's rows under T5's split
                check, the encode's and a step's ms, the collectives a
                step and their bytes), a ZeRO-1 BERT-base state through
                save_sharded_train_state / restore_sharded_train_state
                (a restored step bit for bit the uninterrupted one's;
                bytes and ms each way), and ShardedInference of
                BERT-base over {"data": 2} (batch 32, each rank the
                whole output within 1e-2 of the unpartitioned graph,
                flash_attention launches by rank);
  4. decode   — DecodeServer(max_batch=4) over GptDecoder at
                mistral_config()'s full width and depth (32 layers, dim
                4096, 32 heads, 8 KV heads, FFN 14336, vocab 32000,
                window and max_len 4096), random bf16 weights from a
                seeded generator, serving the repo's 12-request mix;
                every output echoes its prompt and every generated token
                passes the split greedy check (served_bound: the exact
                argmax of the logits row the server picked it from,
                recorded on a second server that serves the mix again,
                untimed and token-identical, and that row within
                SERVED_LOGIT_BOUND of an f32 forward on the same
                weights); one untimed 256-token greedy generation whose
                served rows' largest gap from f32 is printed for each
                64-token bucket (reported, not gated); then the host and
                device time of one steady tick;
     family   — the rest of the decoder family on phase 4's decoder and
                weights: the mix through decode_window=4 and 8 (captured
                CUDA graphs; token-identical to phase 4's outputs, the
                card's flash_decode runs checked, a steady window's
                split) and three sampled requests identical at K=1 and
                K=8; a rolling cache (a 4000-token prompt and 160 steps
                across the 4096 window, no flash_decode launch);
                speculative_generate with a 4-layer make_draft at k=4
                (and the target's teacher-forced logit error in T=5 and
                T=1 steps); the digits regex and a JSON schema over a
                synthetic 32000-string vocabulary at K=1 and 8; three
                rank-16 LoRA adapters over the mix by adapter id;
                beam_search at beam 4 (and a wrong reorder that its
                score check must catch); every token held by the split
                greedy check (the rolling one against a flat
                max_len-8192 twin, the LoRA ones against each adapter's
                merged weights, the speculative ones on the verify rows
                that committed them, the constrained ones among the
                admissible tokens);
  5. paged    — PagedDecodeServer over phase 4's decoder and weights:
                a 1025-block pool of 16-row blocks (phase 4's 4-slot
                cache plus the trash block), attention="pallas" (the
                paged kernels), radix prefix caching, 64-token chunked
                prefill; the 12 requests each behind one shared 64-token
                system prompt; the same checks as phase 4 (the split
                greedy check on the server's own rows), plus the
                radix hits, the prefill tokens saved and trash block 0
                never handed out; then one steady paged tick's split;
  6. int8     — phase 5's server on an int8 pool (kv_dtype="int8"):
                the same requests and checks (the paged kernels' int8
                path counted apart from the float one), the pool's bytes,
                every generated token within 5% of its reference row's
                logit scale of the row max; then one steady int8 tick's
                split, in turns with the float tick; then the host spill
                tier (spill_bytes=): a system prompt evicted by filler
                requests from a small int8 pool and revived from host
                memory, token-identical to a resident radix hit;
     paged_family — the rest of the paged server on phase 5's setup and
                weights: the 12-request mix through decode_window 4 and
                8 on a bf16 pool and 4 on an int8 pool (captured CUDA
                graphs; token-identical to phases 5 and 6, the paged
                decode kernel's runs on the card checked at (replays +
                capture warm-up) x K x 32, a steady window's split);
                prefill_budget=64 mixed ticks; spec_k=4 with
                make_draft(layers=4) at K=1 and in a window of 4; the
                digits regex and the JSON schema at K=1 and 8; three
                rank-16 LoRA adapters by id; serve_disagg over loopback
                with a prefill worker in a thread, then as a `python -m
                defer_tpu_torch.disagg.prefill_worker` process, on the
                decoder's first 4 layers at full width; every
                token held by the split greedy check, but the
                speculative window's (its verify rows stay inside the
                graph), which must equal the K=1 speculative run's;
     fleet    — fleet serving (defer_tpu_torch/fleet/) on phase 5's
                decoder and weights: two replicas of phase 5's server on
                cuda:0 sharing the one set of weights (the allocation
                grows by their pools and no more), the 24-request mix of
                scripts/bench_fleet.py's _workload (3 system prompts of
                64 tokens, Zipf reuse, paced bursts of 4) under policy
                "prefix" and "round_robin", a forced prefix migration (4
                blocks), both replicas on decode_window=4 at once (each
                captures while the other serves) and an overload flood
                against max_queue=2 and an SLO from the measured TTFT;
                every output token-identical to one paged server's,
                whose tokens pass the split greedy check; the paged
                kernels' card runs summed over the replicas;
     serve_sharded — sharded decode serving at Mistral-7B's full width
                and depth on phase 4's weights (the ranks and workers
                build the same values from the same seed): phase 5's
                server on a {"model": 1} mesh, token-identical to phase
                5; captured mesh windows at K=4 on a one-process
                {"model": 1} mesh and on a world-size-1 NCCL group (this
                script with --nccl-rank 0 PORT OUT): after a warm-up
                request, the mix under capture_sanitizer (no capture),
                replays counted, tokens equal to the eager window's and
                phase 5's, paged_flash_decode's card runs replays x K x
                layers, a steady window's host and device ms and idle
                share beside the gloo tp 2 K=4 rate; sync_sanitizer
                around one steady greedy window of phase 5's server
                (DRAIN_SYNCS allowed, the count printed); then two gloo
                ranks sharing cuda:0 (this script with
                --sharded-rank; rank 0 the controller): SpmdGptDecoder
                on DecodeServer at K=1, and PagedDecodeServer(mesh=,
                "pallas") at K=1, with the prefix cache and 64-token
                chunks, at decode_window=4 (uncaptured sub-steps,
                token-identical to K=1) and on an int8 pool, each under
                the split greedy check on rank 0's rows (the int8 pool
                under phase 6's contract), each rank's kernel runs on
                the card equal to what the path implies, rank 1's
                logits bit-equal to rank 0's (a hash), and one short
                request's pool shards against the mesh=None pool's head
                slices; tokens/s, model-axis bytes a tick, tp_psums and
                the peak allocation per rank; then pp_stages=2 on
                [cuda:0] x 2 (pp_inflight 2, window 4) under the split
                check, its share of tokens identical to phase 5,
                paged_flash_prefill's card runs equal to the stage
                dispatches' layers and the bubble fraction; the pp
                question: the mix's first requests through pp 1 and pp
                2 at pp_inflight 1 and 2, their served rows compared up
                to each first parting token, and one pp 1 step
                decomposed (the decode kernel against the prefill
                kernel at T=1, two stages against one, half the slots'
                GEMM M; the boundary must be exact); then the
                same two stages in two serve_pp_stage worker processes
                (this script with --pp-stage) over loopback,
                token-identical, with the host ms a round trip; on the
                two ranks also serve_fleet's front end with two
                model_axis_size=2 replicas (8 requests of phase fleet's
                mix, rank 0's rows on each replica under the split
                check, mesh_shape model=2 on both ranks, the paged
                kernels' card runs and the allocation by rank); and pp
                2 x tp 2 on four gloo ranks (--sharded-rank R PORT OUT
                pptp; Mistral-7B width, 16 layers) under the split
                check, each rank's paged_flash_prefill runs its stage's
                layers x dispatches, the bubble fraction, tp_psums and
                each axis's bytes;
     t5       — T5(t5_config("base")) in bf16 with random weights: a
                batch of 8 x 512 tokens encoded, 64 greedy tokens through
                the cached step (no flash_attention launch), every token
                held by the split greedy check against a teacher-forced
                f32 forward (T5's own bound, T5_LOGIT_BOUND); the
                encode's and a step's ms;
     examples — the single-process example drivers of
                defer_tpu_torch/examples/, each `run()` in this process
                at the JAX examples' default widths with only the
                durations cut (EXAMPLE_MINUTES): local_infer and then
                distributed_infer on ResNet50 at --batch 32 --synthetic,
                4 stages on the card from --cuts (images/s of each, the
                pipeline's from its first result, and their ratio; the
                same seed-0 weights, so the pipeline's first result is
                held against the baseline's), ViT-B/16
                through distributed_infer (flash_attention launched),
                generate --family llama --speculate 4 (the plain loop,
                then the speculative run; every greedy token of both
                held to the teacher-forced forward within a tie
                tolerance) and serve_decode --check (flash_decode run
                on the card),
                serving_batched briefly, long_context at --seq 4096
                --check on a seq axis of 1, and pretrained_infer offline
                (its SKIP: line);
  7. report   — a JSON line of every kernel, the card's name and power
                limit, and last the line {"ok": true, "device": {...}}.

Every kernel launch count is zeroed just before each path (3, cnn,
socket, each sub-path of train, each layout of dist on each rank, 4,
each sub-path of family, 5, 6, each sub-path of
paged_family, of fleet and of serve_sharded, on each rank, t5, each
driver of examples) and read
just after it; a path that did not launch its
kernels fails (a rolling one fails if it launched flash_decode). A
captured window's replays run kernels the wrappers' host counts cannot
see, so flash_decode and both paged kernels count their own runs on
the card (`card_runs`): phases family and paged_family report that
count for their windows, and check it against the wrapper's on every
path that replays no graph. Every worker process has a time limit and
is stopped by the end of its phase.

Each phase prints its seconds and the smoke's running total
("timing:" lines).

Exits non-zero, and prints no result, when CUDA is unavailable, when the
package is not beside this file, or when any phase fails (a dist or
serve_sharded rank that fails, hangs past its timeout or exits non-zero
among them). Imports neither jax nor defer_tpu. `--dist-rank R PORT
OUT` runs one of phase dist's ranks, `--sharded-rank R PORT OUT` one of
serve_sharded's, `--nccl-rank 0 PORT OUT` its world-size-1 NCCL rank,
`--pp-stage S RESULT_PORT` one of its serve_pp_stage workers; the
phases start them themselves.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import math
import os
import queue
import statistics
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

# The CNN phase: ResNet50 and ViT-B/16 streams at batch 32 over
# MICROBATCHES, ViT cut at its block outputs (ResNet50 at
# model.default_cuts(4), add_4/8/12, as bench.py cuts it); the auto-cut
# run's microbatches; flash_attention at ViT-B/16's shape (B, H, S, Dh).
IMAGE_BATCH, AUTO_MICROBATCHES = 32, 8
VIT_CUTS = ["block_2_out", "block_5_out", "block_8_out"]
VIT_ATTN = (IMAGE_BATCH, 12, 197, 64)
# flash_attention at the LM training step's shape: GPT-2 small, causal,
# a microbatch of 4 x 512 tokens (phase train).
GPT2_ATTN = (4, 12, 512, 64)
# Every other zoo entry: one bf16 forward at batch 8 and its published
# resolution, against the same graph in f32 on the card (TF32 off).
ZOO_BATCH = 8
ZOO = ["vgg16", "vgg19", "mobilenetv2", "efficientnet_b0", "inceptionv3",
       "inception_resnet_v2", "xception", "densenet121", "nasnet_mobile",
       "resnet101", "resnet152", "vit_s16"]
# bf16 against f32: relative L2 error of the logits (before any output
# softmax). bf16 keeps 8 bits; every layer rounds its weights and its
# activations, and the errors of a hundred-odd layers add up (about
# 1-2% expected from a random walk of 0.1-0.2% a layer).
ZOO_REL_L2 = 5e-2
# A stream's microbatch 0 against the unpartitioned graph on the card,
# same bf16 weights and kernels: max abs error over softmax rows
# (ResNet50) or relative to the largest logit (ViT-B/16).
STREAM_TOL = 1e-3

# The decode path: slots of the server.
DECODE_SLOTS = 4
# The split greedy check of the decode paths. bf16 rows lie up to
# 0.105-0.135 from the f32 reference on the same weights
# (f32_reference_logits), over a 0.08 tie tolerance, so a tolerance on the
# f32 row max would pass only where near ties fall. Instead (1) every
# served token must be the exact argmax of the logits row it was picked
# from (recorded as the server or the generate loop makes it: ServedRows,
# or a step wrapper), and (2) those rows must lie within
# SERVED_LOGIT_BOUND of the f32 reference, about twice the largest error
# measured. Then each token's f32 logit is within 2 x SERVED_LOGIT_BOUND
# of its row's max, by the bound and not by where near ties fall. A path
# whose rows stay inside a captured graph (the paged speculative window)
# must equal its K=1 run, which takes the split check.
SERVED_LOGIT_BOUND = 0.25
# T5-base's own bound for (2): its bf16 rows read 0.04495 from the f32
# forward on this card, far under the Mistral readings, so the decoder's
# bound would let a T5 forward at a lower precision through; twice the
# reading.
T5_LOGIT_BOUND = 0.09
# flash_decode at the decode path's tick shape: (B, Hq, Hkv, S, Dh).
DECODE_SHAPE = (DECODE_SLOTS, 32, 8, 4096, 128)
# The decode kernels' two timed positions: a deep mix (one slot at the
# window's end) and the depths at which the serving ticks of phases 4-6
# run them.
DEEP_POS = [4095, 2047, 130, 0]
TICK_POS = [170, 176, 182, 188]
# The paged path: pool blocks (phase 4's 4 x 4096 rows in 16-row blocks,
# plus trash block 0), block size, prefill chunk, and the shared system
# prompt every request starts with.
PAGED_BLOCKS, PAGED_BS, PAGED_CHUNK, SYSTEM_LEN = 1025, 16, 64, 64
# The int8 pool's greedy-validity share: a generated token's reference
# logit within this share of its row's logit scale (max |logit|) of the
# row max, the int8 pool's CPU accuracy contract (tests/test_kv_quant.py).
INT8_LOGIT_SHARE = 0.05
# The spill tier: a pool of 16 usable blocks (one request of 88 rows
# holds 6, a filler of 104 rows 7, so three fillers evict the first
# request's parked blocks) and a host store of 64 MiB.
SPILL_BLOCKS, SPILL_BYTES = 17, 64 << 20


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
# The paged kernels' int8 pool path (the TPU kernels' `quantized` path) is
# the same source, built once, and reported as a kernel of its own.
KERNELS = [
    ("flash_attention", "flash_attention.cu",
     "defer_tpu/ops/pallas_attention.py:134"),
    ("flash_decode", "flash_decode.cu",
     "defer_tpu/ops/pallas_attention.py:341"),
    ("paged_flash_decode", "paged_flash_decode.cu",
     "defer_tpu/ops/pallas_attention.py:543"),
    ("paged_flash_prefill", "paged_flash_prefill.cu",
     "defer_tpu/ops/pallas_attention.py:769"),
    ("paged_flash_decode_int8", "paged_flash_decode.cu",
     "defer_tpu/ops/pallas_attention.py:543"),
    ("paged_flash_prefill_int8", "paged_flash_prefill.cu",
     "defer_tpu/ops/pallas_attention.py:769"),
]


def launch_counters() -> dict:
    """Each kernel's launch count, as (wrapper, attribute): the paged
    wrappers count launches on a float pool and on an int8 pool apart."""
    from defer_tpu_torch.ops.flash_attention import flash_attention
    from defer_tpu_torch.ops.flash_decode import flash_decode
    from defer_tpu_torch.ops.paged_flash_decode import paged_flash_decode
    from defer_tpu_torch.ops.paged_flash_prefill import paged_flash_prefill

    return {
        "flash_attention": (flash_attention, "launches"),
        "flash_decode": (flash_decode, "launches"),
        "paged_flash_decode": (paged_flash_decode, "launches"),
        "paged_flash_prefill": (paged_flash_prefill, "launches"),
        "paged_flash_decode_int8": (paged_flash_decode, "launches_int8"),
        "paged_flash_prefill_int8": (paged_flash_prefill, "launches_int8"),
    }


def _run_counters() -> dict:
    """The decode and paged kernels' own counts of their runs on the
    card (each wrapper module's `card_runs` / `reset_card_runs`)."""
    from defer_tpu_torch.ops import flash_decode as fd
    from defer_tpu_torch.ops import paged_flash_decode as pfd
    from defer_tpu_torch.ops import paged_flash_prefill as pfp

    return {"flash_decode": fd, "paged_flash_decode": pfd,
            "paged_flash_prefill": pfp}


def zero_launches() -> None:
    """Zero every wrapper's host count and the cards' counts of the
    decode and paged kernels' runs (`card_runs`)."""
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)
    for mod in _run_counters().values():
        mod.reset_card_runs()


def read_card_runs() -> dict:
    """Each decode and paged kernel's runs on the card since
    zero_launches(), float and int8 pools together, graph replays
    included."""
    return {name: mod.card_runs() for name, mod in _run_counters().items()}


def eager_decode_launches(label: str) -> dict:
    """read_launches() on a path that replays no captured graph, where
    the card's count of flash_decode runs must equal the wrapper's."""
    from defer_tpu_torch.ops.flash_decode import card_runs

    launches = read_launches()
    card = card_runs()
    check(card == launches["flash_decode"],
          f"{label}: the card ran {card} flash_decode kernels, the wrapper "
          f"launched {launches['flash_decode']}")
    return launches


def read_launches() -> dict:
    return {name: getattr(fn, attr)
            for name, (fn, attr) in launch_counters().items()}


def phase_build() -> None:
    from defer_tpu_torch.utils import nvcc

    sources = sorted({src for _, src, _ in KERNELS})
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        futures = [pool.submit(nvcc.load_library, src) for src in sources]
        for fut in futures:
            fut.result()  # raises with nvcc's output on a failed build
    for src in sources:
        names = ", ".join(n for n, s, _ in KERNELS if s == src)
        log(f"build: {names} ({src}) ready in "
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


def _held(label, name, got, want, dtype, detail) -> float:
    """Check a kernel's output against its plain version; returns the
    max abs error."""
    import torch

    atol, rtol = TOLERANCE[_dtype_name(dtype)]
    err = (got.float() - want.float()).abs()
    max_err = err.max().item()
    within = bool((err <= atol + rtol * want.float().abs()).all().item())
    log(f"kernels: {name} {label} {detail} {_dtype_name(dtype)}: "
        f"max_abs_err {max_err:.3e} (tol atol {atol:g} + rtol {rtol:g}) "
        f"{'ok' if within else 'FAIL'}")
    check(within and got.shape == want.shape and got.dtype == dtype
          and bool(torch.isfinite(got).all().item()),
          f"{name} {label} disagrees with its plain version")
    return max_err


def _bound(nbytes: int, flops: int) -> tuple:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOP_PER_S * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms
                                     else "operations")


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
        launch_plan,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # (label, (B, H, S_q, Dh), S_k, dtype, causal)
    cases = [
        ("bert", (BATCH, 12, SEQ, 64), SEQ, bf16, False),
        ("vit", VIT_ATTN, VIT_ATTN[2], bf16, False),
        ("causal", (BATCH, 12, SEQ, 64), SEQ, bf16, True),
        ("gpt2_causal", GPT2_ATTN, GPT2_ATTN[2], bf16, True),
        ("ragged77", (2, 12, 77, 64), 77, bf16, False),
        ("ragged200", (2, 12, 200, 64), 200, bf16, False),
        ("ragged200_causal", (2, 12, 200, 64), 200, bf16, True),
        ("cross_77x200_f16", (2, 12, 77, 64), 200, f16, False),
        ("dh128", (4, 8, SEQ, 128), SEQ, bf16, False),
        ("dh40", (2, 4, 100, 40), 100, bf16, False),
        ("dh72_causal", (2, 4, 150, 72), 150, bf16, True),
        ("s1_causal", (2, 12, 1, 64), 1, bf16, True),
        ("s8_causal", (2, 12, 8, 64), 8, bf16, True),
        ("dh40_f32", (2, 4, 100, 40), 100, f32, False),
        ("f32", (4, 12, SEQ, 64), SEQ, f32, False),
        ("f32_causal", (4, 12, SEQ, 64), SEQ, f32, True),
        # 16 K tiles through the 2-stage ring: its barriers' phases wrap.
        ("s1024_causal", (2, 12, 1024, 64), 1024, bf16, True),
    ]
    errs = {}
    for label, (b, h, s_q, dh), s_k, dtype, causal in cases:
        q = _bert_qkv(gen, b, h, s_q, dh, dtype)[0]
        k, v = _bert_qkv(gen, b, h, s_k, dh, dtype)[1:]
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        want = flash_attention_plain(q, k, v, causal=causal)
        max_err = _held(label, "flash_attention", got, want, dtype,
                        f"q={tuple(q.shape)} s_k={s_k} causal={causal}")
        errs[label] = max_err

    def timed(shape, causal: bool = False) -> dict:
        b, h, s, dh = shape
        q, k, v = _bert_qkv(gen, b, h, s, dh, bf16)
        kernel_ms = cuda_time_ms(
            lambda: flash_attention(q, k, v, causal=causal))
        plain_ms = cuda_time_ms(
            lambda: flash_attention_plain(q, k, v, causal=causal))
        library_ms = cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal)
        )
        nbytes = 4 * q.numel() * q.element_size()
        # A causal call needs the products of the lower triangle only.
        flops = 4 * b * h * s * s * dh // (2 if causal else 1)
        bound_ms, bound_by = _bound(nbytes, flops)
        log(f"kernels: flash_attention at {tuple(q.shape)} bf16 causal="
            f"{causal}: kernel_ms {kernel_ms:.5f} plain_ms {plain_ms:.5f} "
            f"library_ms (sdpa, is_causal={causal}) {library_ms:.5f} "
            f"bound_us {bound_ms * 1e3:.3f} ({nbytes} B, {flops} FLOP)")
        return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}

    plan = launch_plan(VIT_ATTN[2], VIT_ATTN[2], VIT_ATTN[3], False)
    log(f"kernels: flash_attention at S={VIT_ATTN[2]} computes "
        f"{plan.work_ratio:.4f}x the products it needs (derived from the "
        f"launch plan: {plan.q_tiles} query tiles x {plan.k_tiles} K "
        f"tiles of 64)")
    q, k, v = _bert_qkv(gen, BATCH, 12, SEQ, 64, bf16)
    host_us = host_time_us(lambda: flash_attention(q, k, v), iters=300)
    log(f"kernels: flash_attention host_us a call at {tuple(q.shape)} bf16 "
        f"{host_us:.2f} (300 calls on an idle card, tensor maps encoded)")
    # BERT's shape at the top (as in earlier runs), ViT-B/16's and GPT-2
    # small's causal training shape beside it.
    return {"max_abs_err": errs["bert"], **timed((BATCH, 12, SEQ, 64)),
            "vit": {"max_abs_err": errs["vit"], **timed(VIT_ATTN)},
            "gpt2_causal": {"max_abs_err": errs["gpt2_causal"],
                            **timed(GPT2_ATTN, causal=True)}}


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
    # (label, (B, Hq, Hkv, S, Dh), dtype, pos, window)
    cases = [
        ("mistral", DECODE_SHAPE, bf16, DEEP_POS, 4096),
        ("tick", DECODE_SHAPE, bf16, TICK_POS, 4096),
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
        max_err = _held(label, "flash_decode", got, want, dtype,
                        f"q={tuple(q.shape)} k={tuple(k.shape)} pos={pos} "
                        f"window={window}")
        if label == "mistral":
            main_err = max_err

    q, k, v = _decode_qkv(gen, b, hq, hkv, s, dh, bf16)
    timed = {}
    for label, pos in (("deep", DEEP_POS), ("tick", TICK_POS)):
        posv = torch.tensor(pos, dtype=torch.int32, device="cuda")
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
        live = sum(live_rows(p, s, 4096) for p in pos)
        itemsize = q.element_size()
        nbytes = (2 * live * hkv * dh + 2 * b * hq * dh) * itemsize
        flops = 4 * live * (hq // hkv) * hkv * dh
        bound_ms, bound_by = _bound(nbytes, flops)
        log(f"kernels: flash_decode {label} at q={tuple(q.shape)} "
            f"k={tuple(k.shape)} bf16 pos={pos}: kernel_ms {kernel_ms:.5f} "
            f"plain_ms {plain_ms:.5f} library_ms (sdpa over all {s} rows, "
            f"enable_gqa) {library_ms:.5f} bound_us {bound_ms * 1e3:.3f} "
            f"({live} live rows of {b * s}: {nbytes} B, {flops} FLOP); the "
            f"wrapper's host time {wrapper_us:.2f} us a call")
        timed[label] = {"pos": pos, "ms": kernel_ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms}
    return _decode_report(main_err, timed)


def _paged_inputs(b, hq, hkv, t, dh, bs, mb, dtype, pos, seed):
    """q as the decoder hands it to a paged kernel (a head split of
    [B, T, Hq*Dh]; T None gives the decode kernel's [B, Hq, Dh]), one
    layer of a pool of 1 + B * MB blocks, and tables drawn as a seeded
    permutation of blocks 1.. (so the indirection is real) with each
    slot's entries past its need on trash block 0. Returns (q, pool_k,
    pool_v, tables, pos on the card, live blocks)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    tq = 1 if t is None else t
    q = torch.randn(b, tq, hq * dh, generator=gen, device="cuda").to(dtype)
    q = q.view(b, tq, hq, dh).transpose(1, 2)
    if t is None:
        q = q[:, :, 0, :]
    nb = 1 + b * mb
    pool_k, pool_v = (
        torch.randn(nb, hkv, bs, dh, generator=gen, device="cuda").to(dtype)
        for _ in range(2)
    )
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(seed))
    tables = (perm + 1).reshape(b, mb).to(torch.int32)
    for i, p in enumerate(pos):
        tables[i, (p + tq - 1) // bs + 1:] = 0
    posv = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return q, pool_k, pool_v, tables.cuda(), posv


def _gathered_view(pool, tables):
    """The pool rows of each slot's table as one contiguous
    [B, Hkv, MB * bs, Dh] view: the library yardstick's first call."""
    kc = pool[tables.long()]  # [B, MB, Hkv, bs, Dh]
    b, mb, hkv, bs, dh = kc.shape
    return kc.transpose(1, 2).reshape(b, hkv, mb * bs, dh)


def check_paged_flash_decode() -> dict:
    import torch
    import torch.nn.functional as F

    from defer_tpu_torch.ops.flash_decode import live_rows
    from defer_tpu_torch.ops.paged_flash_decode import (
        paged_flash_decode,
        paged_flash_decode_plain,
    )

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # (label, (B, Hq, Hkv, Dh, bs, MB), dtype, pos, window): the paged
    # tick's shape first, then the edge cases.
    cases = [
        ("mistral", (4, 32, 8, 128, 16, 256), bf16, DEEP_POS, 4096),
        ("tick", (4, 32, 8, 128, 16, 256), bf16, TICK_POS, 4096),
        ("bs1", (2, 8, 2, 64, 1, 300), bf16, [299, 100], None),
        ("pos0", (2, 32, 8, 128, 16, 64), bf16, [0, 0], 4096),
        ("window_edge", (2, 32, 8, 128, 16, 64), bf16, [700, 40], 100),
        ("g1_dh64", (2, 8, 8, 64, 16, 32), bf16, [500, 77], None),
        ("g8", (2, 64, 8, 128, 16, 64), bf16, [1000, 300], None),
        ("f16_bs8", (3, 16, 4, 64, 8, 64), f16, [511, 0, 100], None),
        ("f32_bs32", (2, 32, 8, 128, 32, 32), f32, [1023, 513], 200),
    ]
    main_err = None
    for seed, (label, (b, hq, hkv, dh, bs, mb), dtype, pos, window) in (
        enumerate(cases)
    ):
        q, pk, pv, tables, posv = _paged_inputs(b, hq, hkv, None, dh, bs,
                                                mb, dtype, pos, seed)
        got = paged_flash_decode(q, pk, pv, tables, posv, window=window)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        want = paged_flash_decode_plain(q, pk, pv, tables, posv,
                                        window=window,
                                        num_blocks=max(pos) // bs + 1)
        err = _held(label, "paged_flash_decode", got, want, dtype,
                    f"q={tuple(q.shape)} pool={tuple(pk.shape)} "
                    f"tables={tuple(tables.shape)} pos={pos} "
                    f"window={window}")
        if label == "mistral":
            main_err = err

    b, hq, hkv, dh, bs, mb = cases[0][1]
    timed = {}
    for label, pos in (("deep", DEEP_POS), ("tick", TICK_POS)):
        q, pk, pv, tables, posv = _paged_inputs(b, hq, hkv, None, dh, bs,
                                                mb, bf16, pos, 0)
        kernel_ms = cuda_time_ms(
            lambda: paged_flash_decode(q, pk, pv, tables, posv, window=4096)
        )
        nb_plain = max(pos) // bs + 1
        plain_ms = cuda_time_ms(
            lambda: paged_flash_decode_plain(q, pk, pv, tables, posv,
                                             window=4096,
                                             num_blocks=nb_plain),
            iters=5, warmup=1,
        )
        j = torch.arange(mb * bs, device="cuda")
        mask = ((j[None, :] <= posv[:, None])
                & (j[None, :] > posv[:, None] - 4096))[:, None, None, :]
        library_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], _gathered_view(pk, tables),
                _gathered_view(pv, tables), attn_mask=mask,
                enable_gqa=True,
            )
        )
        # The function needs each slot's live rows (the kernel stops at
        # pos, mid-block), not their whole blocks.
        live = sum(live_rows(p, mb * bs, 4096) for p in pos)
        itemsize = q.element_size()
        nbytes = (2 * live * hkv * dh + 2 * b * hq * dh) * itemsize
        flops = 4 * live * hq * dh
        bound_ms, bound_by = _bound(nbytes, flops)
        log(f"kernels: paged_flash_decode {label} at q={tuple(q.shape)} "
            f"pool={tuple(pk.shape)} tables={tuple(tables.shape)} bf16 "
            f"pos={pos}: kernel_ms {kernel_ms:.5f} plain_ms {plain_ms:.5f} "
            f"library_ms (two calls: pool gather of every table column + "
            f"sdpa enable_gqa) {library_ms:.5f} bound_us "
            f"{bound_ms * 1e3:.3f} ({live} live rows: {nbytes} B, "
            f"{flops} FLOP)")
        timed[label] = {"pos": pos, "ms": kernel_ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms}
    return _decode_report(main_err, timed)


def check_paged_flash_prefill() -> dict:
    import torch
    import torch.nn.functional as F

    from defer_tpu_torch.ops.paged_flash_prefill import (
        paged_flash_prefill,
        paged_flash_prefill_plain,
    )

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # (label, (B, Hq, Hkv, T, Dh, bs, MB), dtype, start, window): the
    # phase-5 chunk after a 4-block hit, deep chunks (a cluster's ranks
    # split the live range and merge), a deep and a shallow slot together
    # (the shallow slot's late ranks walk nothing), then the edges (bs 4:
    # TMA boxes of 4 rows land inside a swizzle atom).
    cases = [
        ("after_hit", (1, 32, 8, 64, 128, 16, 256), bf16, [64], 4096),
        ("deep", (1, 32, 8, 64, 128, 16, 256), bf16, [1984], 4096),
        ("deep4032", (1, 32, 8, 64, 128, 16, 256), bf16, [4032], 4096),
        ("deep_shallow", (2, 32, 8, 64, 128, 16, 256), bf16, [4032, 64],
         4096),
        ("start0", (1, 32, 8, 64, 128, 16, 256), bf16, [0], 4096),
        ("window_edge", (2, 32, 8, 64, 128, 16, 64), bf16, [500, 37], 100),
        ("g1_dh64", (2, 8, 8, 16, 64, 16, 32), bf16, [100, 0], None),
        ("g8", (1, 64, 8, 32, 128, 16, 64), bf16, [300], None),
        ("b4_t5", (4, 32, 8, 5, 128, 16, 64), bf16, [0, 17, 400, 1000],
         None),
        ("f16_bs8", (2, 16, 4, 24, 64, 8, 64), f16, [100, 7], None),
        ("f32_bs32", (2, 32, 8, 40, 128, 32, 32), f32, [600, 3], 200),
        ("bf16_bs4", (2, 16, 4, 24, 128, 4, 64), bf16, [100, 7], None),
    ]
    main_err = None
    for seed, (label, (b, hq, hkv, t, dh, bs, mb), dtype, start, window) in (
        enumerate(cases)
    ):
        q, pk, pv, tables, sv = _paged_inputs(b, hq, hkv, t, dh, bs, mb,
                                              dtype, start, seed)
        got = paged_flash_prefill(q, pk, pv, tables, sv, window=window)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        want = paged_flash_prefill_plain(
            q, pk, pv, tables, sv, window=window,
            num_blocks=min((max(start) + t - 1) // bs + 1, mb),
        )
        err = _held(label, "paged_flash_prefill", got, want, dtype,
                    f"q={tuple(q.shape)} pool={tuple(pk.shape)} "
                    f"tables={tuple(tables.shape)} start={start} "
                    f"window={window}")
        if label == "after_hit":
            main_err = err

    timed = {}
    for label, start in (("after_hit", 64), ("deep", 1984)):
        b, hq, hkv, t, dh, bs, mb = cases[0][1]
        q, pk, pv, tables, sv = _paged_inputs(b, hq, hkv, t, dh, bs, mb,
                                              bf16, [start], 0)
        kernel_ms = cuda_time_ms(
            lambda: paged_flash_prefill(q, pk, pv, tables, sv, window=4096)
        )
        nb_plain = (start + t - 1) // bs + 1
        plain_ms = cuda_time_ms(
            lambda: paged_flash_prefill_plain(q, pk, pv, tables, sv,
                                              window=4096,
                                              num_blocks=nb_plain),
            iters=5, warmup=1,
        )
        j = torch.arange(mb * bs, device="cuda")
        qpos = start + torch.arange(t, device="cuda")
        mask = ((j[None, :] <= qpos[:, None])
                & (j[None, :] > qpos[:, None] - 4096))[None, None]
        library_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(
                q, _gathered_view(pk, tables), _gathered_view(pv, tables),
                attn_mask=mask, enable_gqa=True,
            )
        )
        # Rows the chunk's queries attend (window 4096 reaches row 0 at
        # these starts): each read once, q and o once each.
        live = start + t
        itemsize = q.element_size()
        nbytes = (2 * live * hkv * dh + 2 * b * hq * t * dh) * itemsize
        pairs = sum(start + i + 1 for i in range(t))  # causal (query, key)
        bound_ms, bound_by = _bound(nbytes, 4 * pairs * hq * dh)
        log(f"kernels: paged_flash_prefill {label} at q={tuple(q.shape)} "
            f"pool={tuple(pk.shape)} bf16 start={start}: kernel_ms "
            f"{kernel_ms:.5f} plain_ms {plain_ms:.5f} library_ms (two calls: "
            f"pool gather of every table column + sdpa enable_gqa with a "
            f"boolean mask) {library_ms:.5f} bound_us {bound_ms * 1e3:.3f} "
            f"({live} live rows: {nbytes} B, "
            f"{4 * pairs * hq * dh} FLOP)")
        timed[label] = {"start": start, "ms": kernel_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms}
    # The JSON line reports the chunk the paged path runs most, the one
    # right after a radix hit, and beside it the deep chunk, on which the
    # tensor-core redesign is judged.
    after_hit = {k: v for k, v in timed["after_hit"].items() if k != "start"}
    return {"max_abs_err": main_err, **after_hit, "deep": timed["deep"]}


def _int8_pool(pool):
    """A float pool as the int8 pool stores it: the int8 payload and one
    f32 scale per (block, head)."""
    from defer_tpu_torch.models.quant import quantize_symmetric

    return quantize_symmetric(pool.float(), axis=(-2, -1))


def _gathered_view_int8(pool, scale, tables, dtype):
    """The int8 library yardstick's first call: the pool rows of each
    slot's table, dequantized into one contiguous [B, Hkv, MB * bs, Dh]
    tensor of q's dtype."""
    from defer_tpu_torch.models.quant import dequantize_symmetric

    idx = tables.long()
    kc = dequantize_symmetric(pool[idx], scale[idx][..., None, None], dtype)
    b, mb, hkv, bs, dh = kc.shape
    return kc.transpose(1, 2).reshape(b, hkv, mb * bs, dh)


def _poison_dead(kq, ks, vq, vs, tables, spans) -> int:
    """Every pool block outside the slots' live table columns (trash
    block 0 among them) gets garbage payload and NaN scales, in place;
    returns how many. `spans` holds each slot's (first, last) live
    column."""
    import torch

    live = set()
    for i, (lo, hi) in enumerate(spans):
        live |= set(tables[i, lo:hi + 1].tolist())
    dead = torch.tensor([b for b in range(kq.shape[0]) if b not in live],
                        dtype=torch.long, device=kq.device)
    kq[dead], vq[dead] = 127, -127
    ks[dead], vs[dead] = float("nan"), float("nan")
    return dead.numel()


def check_paged_int8(kind: str) -> dict:
    """The int8 pool path of a paged kernel (`kind` "decode" or
    "prefill"): at the paged tick's shape (decode) or the two chunks of
    phase 6 (prefill) and the edges (bs 1/4/16/32, G 1/4/8, windows, f16
    and f32 q), the kernel on a pool whose dead blocks are poisoned
    against the plain version on the clean pool (both f32 math: the
    float tolerance of q's dtype); then the times and the bound, from
    live rows at 1 B an element, one f32 scale per (live block, head)
    and q/o in q's dtype."""
    import torch
    import torch.nn.functional as F

    from defer_tpu_torch.ops.paged_flash_decode import (
        _decode_lo_hi,
        paged_flash_decode,
        paged_flash_decode_plain,
    )
    from defer_tpu_torch.ops.paged_flash_prefill import (
        _prefill_lo_hi,
        paged_flash_prefill,
        paged_flash_prefill_plain,
    )

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    name = f"paged_flash_{kind}_int8"
    # (label, (B, Hq, Hkv, T, Dh, bs, MB), dtype, pos or start, window); T
    # None is the decode kernel's single token.
    if kind == "decode":
        kernel, plain = paged_flash_decode, paged_flash_decode_plain
        cases = [
            ("mistral", (4, 32, 8, None, 128, 16, 256), bf16, DEEP_POS,
             4096),
            ("tick", (4, 32, 8, None, 128, 16, 256), bf16, TICK_POS, 4096),
            ("bs1_window", (2, 8, 2, None, 64, 1, 300), bf16, [299, 100],
             37),
            ("pos0", (2, 32, 8, None, 128, 16, 64), bf16, [0, 0], 4096),
            ("window_edge", (2, 32, 8, None, 128, 16, 64), bf16, [700, 40],
             100),
            ("g1_dh64", (2, 8, 8, None, 64, 16, 32), bf16, [500, 77], None),
            ("g8", (2, 64, 8, None, 128, 16, 64), bf16, [1000, 300], None),
            ("f16_bs4", (3, 16, 4, None, 64, 4, 64), f16, [255, 0, 100],
             None),
            ("f32_bs1_dh32", (2, 4, 2, None, 32, 1, 16), f32, [0, 15], None),
            ("f32_bs32", (2, 32, 8, None, 128, 32, 32), f32, [1023, 513],
             200),
        ]
        timed = [("deep", cases[0][1], DEEP_POS),
                 ("tick", cases[0][1], TICK_POS)]
    else:
        kernel, plain = paged_flash_prefill, paged_flash_prefill_plain
        cases = [
            ("after_hit", (1, 32, 8, 64, 128, 16, 256), bf16, [64], 4096),
            ("deep", (1, 32, 8, 64, 128, 16, 256), bf16, [1984], 4096),
            ("deep4032", (1, 32, 8, 64, 128, 16, 256), bf16, [4032], 4096),
            ("deep_shallow", (2, 32, 8, 64, 128, 16, 256), bf16,
             [4032, 64], 4096),
            ("start0", (1, 32, 8, 64, 128, 16, 256), bf16, [0], 4096),
            ("window_edge", (2, 32, 8, 64, 128, 16, 64), bf16, [500, 37],
             100),
            ("g1_dh64", (2, 8, 8, 16, 64, 16, 32), bf16, [100, 0], None),
            ("g8", (1, 64, 8, 32, 128, 16, 64), bf16, [300], None),
            ("f16_bs4", (2, 16, 4, 24, 64, 4, 64), f16, [100, 7], None),
            ("f32_bs1_dh32", (2, 4, 2, 5, 32, 1, 16), f32, [0, 9], None),
            ("f32_bs32", (2, 32, 8, 40, 128, 32, 32), f32, [600, 3], 200),
        ]
        timed = [("after_hit", cases[0][1], [64]),
                 ("deep", cases[0][1], [1984])]

    def spans(pos, t, bs, window):
        if t is None:
            return [_decode_lo_hi(p, bs, window) for p in pos]
        return [_prefill_lo_hi(p, t, bs, window) for p in pos]

    main_err = None
    for seed, (label, (b, hq, hkv, t, dh, bs, mb), dtype, pos, window) in (
        enumerate(cases)
    ):
        q, pk, pv, tables, posv = _paged_inputs(b, hq, hkv, t, dh, bs, mb,
                                                dtype, pos, 100 + seed)
        (kq, ks), (vq, vs) = _int8_pool(pk), _int8_pool(pv)
        span = spans(pos, t, bs, window)
        want = plain(q, kq, vq, tables, posv, window=window,
                     num_blocks=max(hi for _, hi in span) + 1,
                     scale_k=ks, scale_v=vs)
        n_dead = _poison_dead(kq, ks, vq, vs, tables, span)
        got = kernel(q, kq, vq, tables, posv, window=window, scale_k=ks,
                     scale_v=vs)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        err = _held(label, name, got, want, dtype,
                    f"q={tuple(q.shape)} pool={tuple(kq.shape)} int8 "
                    f"tables={tuple(tables.shape)} pos={pos} "
                    f"window={window}, {n_dead} dead blocks poisoned")
        if seed == 0:
            main_err = err

    results = {}
    for label, (b, hq, hkv, t, dh, bs, mb), pos in timed:
        q, pk, pv, tables, posv = _paged_inputs(b, hq, hkv, t, dh, bs, mb,
                                                bf16, pos, 0)
        (kq, ks), (vq, vs) = _int8_pool(pk), _int8_pool(pv)
        del pk, pv
        span = spans(pos, t, bs, 4096)
        nb_plain = max(hi for _, hi in span) + 1
        kernel_ms = cuda_time_ms(
            lambda: kernel(q, kq, vq, tables, posv, window=4096,
                           scale_k=ks, scale_v=vs)
        )
        plain_ms = cuda_time_ms(
            lambda: plain(q, kq, vq, tables, posv, window=4096,
                          num_blocks=nb_plain, scale_k=ks, scale_v=vs),
            iters=5, warmup=1,
        )
        j = torch.arange(mb * bs, device="cuda")
        tq = 1 if t is None else t
        qpos = posv[:, None] + torch.arange(tq, device="cuda")  # [B, T]
        mask = ((j[None, None, :] <= qpos[:, :, None])
                & (j[None, None, :] > qpos[:, :, None] - 4096))[:, None]
        q4 = q[:, :, None] if t is None else q
        library_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(
                q4, _gathered_view_int8(kq, ks, tables, bf16),
                _gathered_view_int8(vq, vs, tables, bf16), attn_mask=mask,
                enable_gqa=True,
            )
        )
        # The function needs each slot's live rows (the window of 4096
        # reaches row 0 at these positions), one scale per live block and
        # head for K and V, and q and o once each.
        rows = sum(p + tq for p in pos)
        blocks = sum(hi - lo + 1 for lo, hi in span)
        nbytes = (2 * rows * hkv * dh + 2 * blocks * hkv * 4
                  + 2 * b * hq * tq * dh * q.element_size())
        pairs = sum(p + i + 1 for p in pos for i in range(tq))
        flops = 4 * pairs * hq * dh
        bound_ms, bound_by = _bound(nbytes, flops)
        log(f"kernels: {name} {label} at q={tuple(q.shape)} "
            f"pool={tuple(kq.shape)} int8 pos={pos}: kernel_ms "
            f"{kernel_ms:.5f} plain_ms {plain_ms:.5f} library_ms (two calls: "
            f"dequantizing gather of every table column + sdpa enable_gqa "
            f"with a boolean mask) {library_ms:.5f} bound_us "
            f"{bound_ms * 1e3:.3f} ({rows} live rows, {blocks} live blocks: "
            f"{nbytes} B = {nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms at 3.35 "
            f"TB/s; {flops} FLOP = {flops / BF16_FLOP_PER_S * 1e3:.6f} ms "
            f"at 989 TFLOP/s)")
        results[label] = {"ms": kernel_ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": library_ms}
    if kind == "decode":
        return _decode_report(main_err, {
            label: {"pos": pos, **results[label]}
            for label, _, pos in timed
        })
    # The JSON line reports the chunk the paged path runs most (right
    # after a radix hit) and beside it the deep chunk.
    return {"max_abs_err": main_err, **results["after_hit"],
            "deep": {"start": timed[1][2][0], **results["deep"]}}


def _decode_report(max_abs_err, timed: dict) -> dict:
    """A decode kernel's entry of the JSON line: the deep mix's numbers at
    the top (as in earlier runs) and again under "deep", the serving
    tick's under "tick"."""
    deep = {k: v for k, v in timed["deep"].items() if k != "pos"}
    return {"max_abs_err": max_abs_err, **deep, "deep": timed["deep"],
            "tick": timed["tick"]}


def phase_kernels() -> dict:
    return {
        "flash_attention": check_flash_attention(),
        "flash_decode": check_flash_decode(),
        "paged_flash_decode": check_paged_flash_decode(),
        "paged_flash_prefill": check_paged_flash_prefill(),
        "paged_flash_decode_int8": check_paged_int8("decode"),
        "paged_flash_prefill_int8": check_paged_int8("prefill"),
    }


# -- phase 3 ---------------------------------------------------------------

def stream(defer, model, cuts, params, inputs, replicas=1) -> dict:
    """Stream `inputs` through defer.run_defer in a thread, the caller
    feeding and draining its queues, as a user does; returns the outputs,
    every kernel's launches in the run (the counts zeroed just before
    it) and its times: the whole run, and the steady microbatches/s
    after the first output."""
    in_q: "queue.Queue" = queue.Queue()
    out_q: "queue.Queue" = queue.Queue()
    errors: list[BaseException] = []

    def serve() -> None:
        try:
            defer.run_defer(model, cuts, in_q, out_q, params=params,
                            replicas=replicas)
        except BaseException as e:  # relayed to the main thread
            errors.append(e)

    zero_launches()
    t0 = time.perf_counter()
    worker = threading.Thread(target=serve, daemon=True)
    worker.start()
    for x in inputs:
        in_q.put(x)
    in_q.put(None)
    outs = []
    t_first = None
    for _ in inputs:
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
    return {
        "outs": outs,
        "launches": launches,
        "seconds_total": t_end - t0,
        "microbatches_per_sec": (len(outs) - 1) / (t_end - t_first),
    }

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
    run = stream(defer, model, cuts, params, list(ids))
    outs, launches = run["outs"], run["launches"]
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
    steady = run["microbatches_per_sec"]
    return {
        "launches": launches,
        "err0": err0,
        "tol": tol,
        "stages": defer.last_pipeline.num_stages,
        "seconds_total": run["seconds_total"],
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


# -- phase 3b: the CNN zoo and ViT ------------------------------------------

def _logits_name(graph) -> str:
    """The node before an output softmax (the output itself otherwise),
    so a saturated softmax cannot hide a difference."""
    out = graph.node_map[graph.output_name]
    return out.inputs[0] if out.op == "softmax" else out.name


def image_stream(label, model, cuts, devices, params, xs, config,
                 source=None, tol=STREAM_TOL) -> dict:
    """Stream the device-resident microbatches `xs` through
    DEFER(devices).run_defer(source or model, cuts) (`source`: what
    run_defer is given, e.g. the model's Keras JSON) and check every
    output: shape (batch, classes), finite, softmax rows summing to 1
    within 1e-2 where the model ends in a softmax, and microbatch 0
    against the unpartitioned graph on the card (same bf16 weights,
    within `tol` of the largest output)."""
    import torch

    from defer_tpu_torch import DEFER
    from defer_tpu_torch.parallel.pipeline import cast_params_to_storage

    graph = model.graph
    with torch.inference_mode():
        want = graph.apply(
            cast_params_to_storage(params, config), xs[0].to(config.compute_dtype)
        ).float()
    defer = DEFER(devices=devices, config=config)
    run = stream(defer, source or model, cuts, params, list(xs))
    softmax = graph.node_map[graph.output_name].op == "softmax"
    for i, out in enumerate(run["outs"]):
        check(tuple(out.shape) == tuple(want.shape),
              f"{label} output {i} has shape {tuple(out.shape)}")
        out = out.float()
        check(bool(torch.isfinite(out).all().item()),
              f"{label} output {i} is not finite")
        if softmax:
            rows = (out.sum(-1) - 1).abs().max().item()
            check(rows <= 1e-2, f"{label} output {i}: a row sums to 1 +- {rows}")
    err0 = (run["outs"][0].float() - want).abs().max().item()
    scale = want.abs().max().item()
    check(err0 <= tol * scale,
          f"{label} microbatch 0 differs from the unpartitioned graph by "
          f"{err0} (largest output {scale})")
    stages = defer.last_pipeline.stages
    return {**run, "err0": err0, "scale": scale,
            "stages": len(stages),
            "cuts": [getattr(st, "input_names", None) or st.input_name
                     for st in stages[1:]]}


def phase_cnn() -> dict:
    """ResNet50 and ViT-B/16 at their published widths through a 4-stage
    run_defer on the card, ResNet50 also on FLOPs-balanced auto cuts,
    entry() once, and every other zoo entry's bf16 forward against f32."""
    import dataclasses

    import torch

    from defer_tpu_torch import DEFER, DeferConfig
    from defer_tpu_torch.entry import entry
    from defer_tpu_torch.models import get_model
    from defer_tpu_torch.utils.flops import (
        balanced_cuts,
        graph_flops,
        peak_flops,
    )

    dev = torch.device("cuda", 0)
    config = DeferConfig(compute_dtype=torch.bfloat16)
    peak = peak_flops(torch.cuda.get_device_name(0))
    check(peak is not None, "no bf16 peak FLOP/s known for this card")
    res = {}

    def draw(shape, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev)

    for name, cuts in (("resnet50", None), ("vit_b16", VIT_CUTS)):
        model = get_model(name)
        cuts = cuts or model.default_cuts(4)
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            batch_size=IMAGE_BATCH)
        xs = draw((MICROBATCHES, IMAGE_BATCH, *model.input_shape), 1)
        run = image_stream(name, model, cuts, [dev], params, xs, config)
        check(run["stages"] == 4 and run["cuts"] == list(cuts),
              f"{name}: stages cut at {run['cuts']}, expected {cuts}")
        per_image = graph_flops(model.graph, params, (1, *model.input_shape))
        images = run["microbatches_per_sec"] * IMAGE_BATCH
        mfu = images * per_image / peak
        log(f"cnn: run_defer {name} {model.input_shape} batch {IMAGE_BATCH}, "
            f"4 stages cut at {list(cuts)} on cuda:0, {MICROBATCHES} "
            f"microbatches: all outputs {tuple(run['outs'][0].shape)} finite; "
            f"microbatch 0 vs unpartitioned graph max_abs_err "
            f"{run['err0']:.3e} (tol {STREAM_TOL:g} x {run['scale']:.4g}, "
            f"bf16)")
        log(f"cnn: {name} steady state {images:.1f} images/s, "
            f"{per_image:.6g} FLOP an image, MFU {mfu:.4f} of "
            f"{peak:.4g} FLOP/s; whole run incl. stage placement "
            f"{run['seconds_total']:.2f}s")
        res[name] = {"images_per_sec": images, "mfu": mfu,
                     "flops_per_image": per_image,
                     "launches": run["launches"]}
        if name == "resnet50":
            auto = balanced_cuts(model.graph, params,
                                 (IMAGE_BATCH, *model.input_shape), 4,
                                 model.cut_candidates)
            log(f"cnn: resnet50 balanced_cuts(4) {auto}, default_cuts(4) "
                f"{list(cuts)}")
            run = image_stream("resnet50 auto", model, "auto", [dev] * 4,
                               params, xs[:AUTO_MICROBATCHES], config)
            check(run["stages"] == 4 and run["cuts"] == auto,
                  f"auto cuts gave stages at {run['cuts']}, expected {auto}")
            log(f"cnn: run_defer resnet50 \"auto\" on [cuda:0] x 4: 4 "
                f"stages cut at {run['cuts']}, {AUTO_MICROBATCHES} "
                f"microbatches checked, microbatch 0 max_abs_err "
                f"{run['err0']:.3e}")
        else:
            layers = sum(1 for n in model.graph.nodes if n.op == "mha")
            fa = run["launches"]["flash_attention"]
            check(fa >= layers * MICROBATCHES,
                  f"flash_attention launched {fa} times on the ViT path, "
                  f"expected >= {layers} x {MICROBATCHES}")
            log(f"cnn: vit_b16 flash_attention launches {fa} (>= {layers} x "
                f"{MICROBATCHES})")
        del params, xs, run

    fn, args = entry()
    out = fn(*args)
    check(tuple(out.shape) == (8, 1000)
          and bool(torch.isfinite(out.float()).all().item()),
          f"entry(): output {tuple(out.shape)} not (8, 1000) and finite")
    log(f"cnn: entry() resnet50 batch 8 bf16 -> {tuple(out.shape)} "
        f"{out.dtype}, finite")
    del fn, args, out

    prior = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    t0 = time.perf_counter()
    for name in ZOO:
        model = get_model(name)
        graph = dataclasses.replace(model.graph,
                                    output_name=_logits_name(model.graph))
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            batch_size=ZOO_BATCH)
        x = draw((ZOO_BATCH, *model.input_shape), 2)
        pipe, _ = DEFER(devices=[dev], config=config).build_pipeline(
            graph, None, params=params)
        got = pipe(x).float()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.inference_mode():
                want = graph.apply(params, x)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prior
        rel = ((got - want).norm() / want.norm()).item()
        log(f"cnn: {name} {model.input_shape} batch {ZOO_BATCH}: bf16 "
            f"logits {tuple(got.shape)} vs f32 relative L2 error {rel:.3e} "
            f"(tol {ZOO_REL_L2:g}), max abs {(got - want).abs().max().item():.3e}"
            f" of {want.abs().max().item():.4g}")
        check(bool(torch.isfinite(got).all().item()) and rel <= ZOO_REL_L2,
              f"{name}: bf16 logits differ from f32 by {rel} (relative L2)")
        del params, pipe, x, got, want
    log(f"cnn: {len(ZOO)} zoo entries checked in "
        f"{time.perf_counter() - t0:.1f}s")
    return res


# -- phase socket: DEFER's own deployment over the transport -------------

# Two serve-stage workers on the card, ResNet50 cut where the reference's
# test.py cuts it (two nodes in its IP list); the stream's microbatches
# and batch; the tolerance of the int8 run against the lossless one,
# relative to the largest logit (the images cross their hop as int8, each
# off by up to amax/254; the workers relay lossless); the BERT-base worker's
# stage and microbatches; the worker's time limits.
SOCKET_CUT, SOCKET_BATCH, SOCKET_MICROBATCHES = "add_8", 8, 32
# The one card every phase from here on runs on (workers included).
CARD = "cuda:0"
INT8_STREAM_TOL = 5e-2
BERT_SOCKET_CUT, BERT_SOCKET_MICROBATCHES = "encoder_5_out", 8
WORKER_TIMEOUT_S = 180


class WorkerProcess:
    """`python -m defer_tpu_torch serve-stage` on the card, its output
    read line by line on a thread; killed by `stop()` if still running."""

    def __init__(self, here: str, next_port: int, *extra: str,
                 command: list | None = None):
        """`command` replaces the serve-stage arguments (another worker
        module of the package, with its own flags)."""
        env = {**os.environ, "PYTHONPATH": here}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *(command or [
                "defer_tpu_torch", "serve-stage",
                "--listen", "0", "--next", f"127.0.0.1:{next_port}",
                "--device", CARD, "--accept-timeout", str(WORKER_TIMEOUT_S),
                "--handoff-timeout", str(WORKER_TIMEOUT_S), *extra])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=here, env=env,
        )
        self.lines: "queue.Queue[str]" = queue.Queue()
        self.out: list[str] = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        try:
            self.port = int(self._expect("LISTENING ").split()[1])
        except BaseException:
            self.stop()
            raise

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line.rstrip("\n"))

    def _expect(self, prefix: str) -> str:
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        while time.monotonic() < deadline:
            try:
                line = self.lines.get(timeout=1.0)
            except queue.Empty:
                check(self._reader.is_alive(),
                      f"worker exited ({self.proc.poll()}) before "
                      f"{prefix!r}:\n" + "\n".join(self.out[-20:]))
                continue
            self.out.append(line)
            if line.startswith(prefix):
                return line
        raise SmokeError(f"worker printed no {prefix!r} in "
                         f"{WORKER_TIMEOUT_S}s:\n" + "\n".join(self.out[-20:]))

    def finish(self, n: int) -> dict:
        """The worker's STATS, after checking it printed `DONE n` and
        exited 0."""
        stats = json.loads(self._expect("STATS ").split(" ", 1)[1])
        done = self._expect("DONE ")
        check(done == f"DONE {n}", f"worker printed {done!r}, not 'DONE {n}'")
        check(self.proc.wait(timeout=WORKER_TIMEOUT_S) == 0,
              f"worker exited {self.proc.returncode}")
        return stats

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def _codec_totals() -> tuple:
    from defer_tpu_torch.obs.metrics import get_registry

    reg = get_registry()
    return (reg.value("defer_codec_raw_bytes_total"),
            reg.value("defer_codec_encoded_bytes_total"))


def socket_stream(here, stages, params, xs, quantize=None) -> dict:
    """Dispatch the two stages tail-first to two worker processes, stream
    `xs` (CPU tensors) from this process through them and back to this
    process's ArrayReceiver; returns the results, the wall times, the
    hops' codec bytes and what each receiver saw by scheme. `quantize`
    is the dispatcher's link mode (the images' hop); the workers relay
    lossless."""
    from defer_tpu_torch.runtime.remote_stage import (
        dispatch_stage,
        recv_results,
        send_activation,
    )
    from defer_tpu_torch.runtime.transport import ArrayReceiver, ArraySender

    results = ArrayReceiver(0, host="127.0.0.1",
                            accept_timeout_s=WORKER_TIMEOUT_S,
                            read_timeout_s=WORKER_TIMEOUT_S)
    workers = []
    try:
        t0 = time.perf_counter()
        tail = WorkerProcess(here, results.port, "--expect-peer")
        workers.append(tail)
        send = ArraySender("127.0.0.1", tail.port)
        dispatch_stage(send, stages[1], params[1])
        send.close()
        head = WorkerProcess(here, tail.port)
        workers.append(head)
        send = ArraySender("127.0.0.1", head.port, quantize=quantize)
        dispatch_stage(send, stages[0], params[0])
        t_ready = time.perf_counter()
        got: list = []
        errors: list = []

        def drain() -> None:
            try:
                got.extend(recv_results(results))
            except BaseException as e:  # relayed to the main thread
                errors.append(e)

        reader = threading.Thread(target=drain, daemon=True)
        reader.start()
        raw0, enc0 = _codec_totals()
        t_start = time.perf_counter()
        for x in xs:
            send_activation(send, x)
        raw1, enc1 = _codec_totals()
        send.close()
        reader.join(timeout=WORKER_TIMEOUT_S)
        t_end = time.perf_counter()
        check(not reader.is_alive() and not errors,
              f"result stream did not end cleanly: {errors!r}")
        check(len(got) == len(xs),
              f"{len(got)} results for {len(xs)} microbatches")
        head_stats, tail_stats = head.finish(len(xs)), tail.finish(len(xs))
    finally:
        for w in workers:
            w.stop()
        results.close()
    return {
        "outs": got,
        "setup_s": t_ready - t0,
        "stream_s": t_end - t_start,
        "hops": [("input", raw1 - raw0, enc1 - enc0),
                 ("add_8", head_stats["codec_raw_bytes"],
                  head_stats["codec_encoded_bytes"]),
                 ("output", tail_stats["codec_raw_bytes"],
                  tail_stats["codec_encoded_bytes"])],
        "schemes": {"head": head_stats["rx_schemes"],
                    "tail": tail_stats["rx_schemes"],
                    "results": {",".join(map(str, k)): v
                                for k, v in results.schemes.items()}},
        "wire_bytes": results.rx_frame_bytes,
    }


def _log_socket_run(label: str, run: dict, n_images: int) -> None:
    images = n_images / run["stream_s"]
    log(f"socket: {label}: {n_images} images in {run['stream_s']:.3f}s over "
        f"the sockets, {images:.1f} images/s (setup incl. two worker starts "
        f"and both dispatches {run['setup_s']:.2f}s)")
    for hop, raw, enc in run["hops"]:
        log(f"socket: {label} hop {hop}: codec raw {raw} B, encoded {enc} B, "
            f"ratio {raw / max(enc, 1):.3f}")
    log(f"socket: {label} frames by scheme: {json.dumps(run['schemes'])}")


def phase_socket() -> None:
    """ResNet50 over two serve-stage worker processes on the card, a
    lossless run and a run whose images cross as int8; then a BERT-base stage served in a
    thread of this process behind a socket, through flash_attention.

    The stream carries ResNet50's logits (the graph without its output
    softmax, as phase cnn's zoo check takes it): with random weights the
    softmax saturates to one-hot rows, which would hide a difference.
    The lossless results are held against the unpartitioned graph placed
    as one stage on the card (the same kernels the workers run)."""
    import dataclasses

    import torch

    from defer_tpu_torch import DeferConfig
    from defer_tpu_torch.graph.partition import partition, stage_params
    from defer_tpu_torch.models import get_model
    from defer_tpu_torch.parallel.pipeline import (
        Pipeline,
        cast_params_to_storage,
    )
    from defer_tpu_torch.runtime import codec

    here = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device(CARD)
    check(codec.load_native() is not None,
          "the native codec (native/codec.cpp) did not build or load")
    config = DeferConfig(compute_dtype=torch.bfloat16)
    model = get_model("resnet50")
    graph = dataclasses.replace(model.graph,
                                output_name=_logits_name(model.graph))
    params = cast_params_to_storage(
        model.init(torch.Generator(device=dev).manual_seed(0)), config)
    stages = partition(graph, [SOCKET_CUT])
    sparams = [stage_params(params, st) for st in stages]
    gen = torch.Generator(device=dev).manual_seed(3)
    xs_dev = torch.randn((SOCKET_MICROBATCHES, SOCKET_BATCH,
                          *model.input_shape), generator=gen,
                         device=dev).to(torch.bfloat16)
    whole = Pipeline([graph], params, [dev], config)
    want = [whole(x).float().cpu() for x in xs_dev]
    act = Pipeline([stages[0]], params, [dev], config)(xs_dev[0]).cpu()
    del whole
    xs = list(xs_dev.cpu())
    n_images = SOCKET_MICROBATCHES * SOCKET_BATCH

    lossless = socket_stream(here, stages, sparams, xs)
    _log_socket_run("lossless zstd", lossless, n_images)
    for name, seen in lossless["schemes"].items():
        check(set(seen) == {"1"},
              f"socket: {name} received frames of schemes {seen}, not only "
              "the native zstd scheme 1")
    scale = max(w.abs().max().item() for w in want)
    for i, out in enumerate(lossless["outs"]):
        check(tuple(out.shape) == tuple(want[i].shape)
              and bool(torch.isfinite(out.float()).all().item()),
              f"socket: result {i} {tuple(out.shape)} not finite logits")
    err = max((o.float() - w).abs().max().item()
              for o, w in zip(lossless["outs"], want))
    check(err <= STREAM_TOL * scale,
          f"socket: a result differs from the unpartitioned graph by {err} "
          f"(largest logit {scale})")
    log(f"socket: all {SOCKET_MICROBATCHES} results "
        f"{tuple(lossless['outs'][0].shape)} (logits) vs the unpartitioned "
        f"graph placed on the card: max_abs_err {err:.3e} (tol "
        f"{STREAM_TOL:g} x {scale:.4g})")

    int8 = socket_stream(here, stages, sparams, xs, quantize="int8")
    _log_socket_run("int8 images", int8, n_images)
    # The head worker gets its weights lossless and every microbatch as
    # int8; the relays downstream stay lossless.
    seen = int8["schemes"]
    check(set(seen["head"]) == {"1", "3,1"}
          and seen["head"]["3,1"] == SOCKET_MICROBATCHES,
          f"socket: the head worker received frames {seen['head']}, not "
          f"its weights on scheme 1 and {SOCKET_MICROBATCHES} int8 images")
    for name in ("tail", "results"):
        check(set(seen[name]) == {"1"},
              f"socket: {name} received frames of schemes {seen[name]} in "
              "the int8 run, not only the lossless scheme 1")
    q_err = max((a.float() - b.float()).abs().max().item()
                for a, b in zip(int8["outs"], lossless["outs"]))
    check(q_err <= INT8_STREAM_TOL * scale,
          f"socket: the int8 run differs from the lossless run by {q_err} "
          f"(largest logit {scale})")
    log(f"socket: int8 run vs lossless run: max abs logit difference "
        f"{q_err:.3e}, {q_err / scale:.3e} of the largest (tol "
        f"{INT8_STREAM_TOL:g})")

    # One hop's codec time: the add_8 activation (what the head worker
    # encodes and the tail decodes), lossless and int8, host clock.
    for label, kw in (("zstd", {}), ("int8", {"quantize": "int8"})):
        frame = codec.encode(act, **kw)
        t0 = time.perf_counter()
        for _ in range(10):
            codec.encode(act, **kw)
        t1 = time.perf_counter()
        for _ in range(10):
            codec.decode(frame)
        t2 = time.perf_counter()
        log(f"socket: codec {label} on the {SOCKET_CUT} activation "
            f"{tuple(act.shape)} {act.dtype} ({act.numel() * act.element_size()}"
            f" B -> {len(frame)} B): encode {(t1 - t0) * 100:.3f} ms, decode "
            f"{(t2 - t1) * 100:.3f} ms (host, mean of 10)")
    del params, sparams, xs_dev, xs, want, lossless, int8
    bert_socket_session(dev)


def bert_socket_session(dev) -> None:
    """A BERT-base stage (encoder 6-11 and the pooler, phase 3's batch and
    sequence) served by serve_stage in a thread of this process on the
    card, single-peer: dispatch and activations on one connection.
    Its flash_attention launches are counted."""
    import torch

    from defer_tpu_torch import DeferConfig
    from defer_tpu_torch.graph.partition import partition, stage_params
    from defer_tpu_torch.models import get_model
    from defer_tpu_torch.parallel.pipeline import cast_params_to_storage
    from defer_tpu_torch.runtime.remote_stage import (
        dispatch_stage,
        recv_results,
        send_activation,
        serve_stage,
    )
    from defer_tpu_torch.runtime.transport import ArrayReceiver, ArraySender

    config = DeferConfig(compute_dtype=torch.bfloat16)
    model = get_model("bert_base", seq_len=SEQ)
    params = cast_params_to_storage(
        model.init(torch.Generator(device=dev).manual_seed(0),
                   batch_size=BATCH), config)
    st0, st1 = partition(model.graph, [BERT_SOCKET_CUT])
    ids = torch.randint(0, 30522, (BERT_SOCKET_MICROBATCHES, BATCH, SEQ),
                        generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        acts = [st0.apply(params, x.to(dev)) for x in ids]
        want = [model.graph.apply(params, x.to(dev)).float().cpu()
                for x in ids]
    results = ArrayReceiver(0, host="127.0.0.1", accept_timeout_s=60.0,
                            read_timeout_s=WORKER_TIMEOUT_S)
    bound, ports, res = threading.Event(), [], {}

    def serve() -> None:
        try:
            res["n"] = serve_stage(
                0, "127.0.0.1", results.port, listen_host="127.0.0.1",
                accept_timeout_s=60.0, device=dev,
                announce=lambda p: (ports.append(p), bound.set()))
        except BaseException as e:  # relayed to the main thread
            res["error"] = e
            bound.set()

    zero_launches()
    worker = threading.Thread(target=serve, daemon=True)
    worker.start()
    check(bound.wait(60.0) and ports, f"BERT worker did not bind: {res}")
    got: list = []
    reader = threading.Thread(target=lambda: got.extend(recv_results(results)),
                              daemon=True)
    reader.start()
    send = ArraySender("127.0.0.1", ports[0])
    dispatch_stage(send, st1, stage_params(params, st1))
    t0 = time.perf_counter()
    for a in acts:
        send_activation(send, a)
    send.close()
    worker.join(timeout=WORKER_TIMEOUT_S)
    reader.join(timeout=WORKER_TIMEOUT_S)
    dt = time.perf_counter() - t0
    launches = read_launches()["flash_attention"]
    results.close()
    check(res.get("n") == BERT_SOCKET_MICROBATCHES and len(got) == len(acts),
          f"BERT worker session: {res}, {len(got)} results")
    layers = sum(1 for n in st1.nodes if n.op == "mha")
    check(launches >= layers * BERT_SOCKET_MICROBATCHES,
          f"flash_attention launched {launches} times behind the socket, "
          f"expected >= {layers} x {BERT_SOCKET_MICROBATCHES}")
    err = max((o.float() - w).abs().max().item() for o, w in zip(got, want))
    check(err <= 1e-2, f"BERT worker results differ from the unpartitioned "
                       f"graph by {err}")
    log(f"socket: bert_base stage after {BERT_SOCKET_CUT} served in a thread "
        f"on cuda:0, single peer: {BERT_SOCKET_MICROBATCHES} microbatches "
        f"({BATCH}, {SEQ}) in {dt:.3f}s, flash_attention launches {launches} "
        f"(>= {layers} x {BERT_SOCKET_MICROBATCHES}), max_abs_err vs the "
        f"unpartitioned graph {err:.3e} (tol 1e-2, bf16)")


# -- phase replicas, keras, roofline, checkpoint ----------------------------

REPLICA_MICROBATCHES = 64
# The Keras model's stream against graph.apply: the bf16 tolerance of
# the card tests (a batch norm folded at placement rounds otherwise).
KERAS_TOL = 1e-2


def phase_replicas(cnn_res: dict) -> None:
    """ResNet50 through run_defer with replicas=2 (two 2-stage replicas)
    over [cuda:0] * 4 at batch 32, against replicas=1 on the same cuts.
    Logits, as in phase socket, so that swapped microbatches would show."""
    import dataclasses

    import torch

    from defer_tpu_torch import DEFER, DeferConfig
    from defer_tpu_torch.models import get_model

    dev = torch.device(CARD)
    config = DeferConfig(compute_dtype=torch.bfloat16)
    model = get_model("resnet50")
    model = dataclasses.replace(model, graph=dataclasses.replace(
        model.graph, output_name=_logits_name(model.graph)))
    cuts = model.default_cuts(2)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        batch_size=IMAGE_BATCH)
    gen = torch.Generator(device=dev).manual_seed(4)
    xs = torch.randn((REPLICA_MICROBATCHES, IMAGE_BATCH, *model.input_shape),
                     generator=gen, device=dev)
    # Alternating replicas=1 and 2, three readings of each in the same
    # call: the host's spread between readings of one setting shows
    # beside the difference between the settings.
    rates, outs = {1: [], 2: []}, {}
    for replicas in (1, 2, 1, 2, 1, 2):
        defer = DEFER(devices=[dev] * 4, config=config)
        run = stream(defer, model, cuts, params, list(xs), replicas)
        pipe = defer.last_pipeline
        check(pipe.num_stages == 2
              and getattr(pipe, "num_replicas", 1) == replicas,
              f"replicas={replicas}: built {pipe.num_stages} stages x "
              f"{getattr(pipe, 'num_replicas', 1)} replicas")
        got = [o.float() for o in run["outs"]]
        for i, o in enumerate(got):
            check(bool(torch.isfinite(o).all().item()),
                  f"replicas={replicas} output {i} is not finite")
        outs.setdefault(replicas, got)
        rates[replicas].append(run["microbatches_per_sec"] * IMAGE_BATCH)
    scale = max(o.abs().max().item() for o in outs[1])
    diff = max((a - b).abs().max().item() for a, b in zip(outs[1], outs[2]))
    check(diff <= STREAM_TOL * scale,
          f"replicas=2 differs from replicas=1 by {diff} (largest {scale})")
    # Neighbouring microbatches differ far beyond the tolerance, so an
    # out-of-order stream could not pass the check above.
    apart = min((a - b).abs().max().item()
                for a, b in zip(outs[1], outs[1][1:]))
    check(apart > 10 * STREAM_TOL * scale,
          f"neighbouring microbatches' logits differ by only {apart}")
    log(f"replicas: run_defer resnet50 batch {IMAGE_BATCH} cut at {cuts}, "
        f"{REPLICA_MICROBATCHES} microbatches over [cuda:0] x 4: replicas=2 "
        f"in stream order, max abs logit difference from replicas=1 "
        f"{diff:.3e} (tol {STREAM_TOL:g} x {scale:.4g}; neighbours differ "
        f"by >= {apart:.4g}); images/s in run order, 1 replica "
        f"{', '.join(f'{r:.1f}' for r in rates[1])}; 2 replicas "
        f"{', '.join(f'{r:.1f}' for r in rates[2])}; median 2/1 "
        f"{statistics.median(rates[2]) / statistics.median(rates[1]):.3f} "
        f"(phase cnn, 4 stages: "
        f"{cnn_res['resnet50']['images_per_sec']:.1f})")


def _keras_residual_json(size: int = 224) -> str:
    """A functional Keras model JSON (classic layout): a ResNet-style
    stem and two residual blocks, a pooled head of 1000 classes."""
    def layer(cls, name, inbound, **cfg):
        cfg.setdefault("name", name)
        return {"class_name": cls, "name": name, "config": cfg,
                "inbound_nodes": [[[s, 0, 0, {}] for s in inbound]]
                if inbound else []}

    layers = [
        layer("InputLayer", "image", [], batch_input_shape=[None, size, size, 3]),
        layer("ZeroPadding2D", "stem_pad", ["image"], padding=[[3, 3], [3, 3]]),
        layer("Conv2D", "stem_conv", ["stem_pad"], filters=64,
              kernel_size=[7, 7], strides=[2, 2], padding="valid",
              use_bias=False, activation="linear"),
        layer("BatchNormalization", "stem_bn", ["stem_conv"], axis=3,
              epsilon=1.001e-5),
        layer("Activation", "stem_relu", ["stem_bn"], activation="relu"),
        layer("MaxPooling2D", "stem_pool", ["stem_relu"], pool_size=[3, 3],
              strides=[2, 2], padding="same"),
    ]
    prev = "stem_pool"
    for b in (1, 2):
        layers += [
            layer("Conv2D", f"b{b}_conv1", [prev], filters=64,
                  kernel_size=[3, 3], padding="same", activation="relu"),
            layer("Conv2D", f"b{b}_conv2", [f"b{b}_conv1"], filters=64,
                  kernel_size=[3, 3], padding="same", use_bias=False),
            layer("BatchNormalization", f"b{b}_bn", [f"b{b}_conv2"], axis=3),
            layer("Add", f"b{b}_add", [f"b{b}_bn", prev]),
            layer("ReLU", f"b{b}_out", [f"b{b}_add"]),
        ]
        prev = f"b{b}_out"
    layers += [
        layer("GlobalAveragePooling2D", "gap", [prev]),
        layer("Dense", "predictions", ["gap"], units=1000,
              activation="softmax"),
    ]
    return json.dumps({"class_name": "Functional", "config": {
        "name": "keras_resnet_toy", "layers": layers,
        "input_layers": [["image", 0, 0]],
        "output_layers": [["predictions", 0, 0]],
    }})


def phase_keras() -> None:
    """A Keras JSON string through DEFER.run_defer on "auto" cuts (two
    stages on cuda:0), against the imported graph's direct forward."""
    import torch

    from defer_tpu_torch import DeferConfig
    from defer_tpu_torch.graph.keras_import import model_from_keras

    dev = torch.device(CARD)
    config = DeferConfig(compute_dtype=torch.bfloat16)
    text = _keras_residual_json()
    model, _ = model_from_keras(text)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        batch_size=ZOO_BATCH)
    gen = torch.Generator(device=dev).manual_seed(5)
    xs = torch.randn((AUTO_MICROBATCHES, ZOO_BATCH, *model.input_shape),
                     generator=gen, device=dev)
    # bf16 tolerance: the placed stages fold each batch norm, which rounds
    # otherwise than graph.apply's unfolded one.
    run = image_stream("keras", model, "auto", [dev] * 2, params, xs, config,
                       source=text, tol=KERAS_TOL)
    check(run["stages"] == 2, f"keras: {run['stages']} stages, expected 2")
    log(f"keras: run_defer on a Keras JSON string ({len(text)} chars, "
        f"{len(model.graph.nodes)} IR nodes, {model.input_shape}), \"auto\" "
        f"on [cuda:0] x 2 cut at {run['cuts']}: {AUTO_MICROBATCHES} "
        f"microbatches of {ZOO_BATCH} checked, microbatch 0 vs the graph's "
        f"direct forward max_abs_err {run['err0']:.3e} (tol {KERAS_TOL:g} x "
        f"{run['scale']:.4g})")


def phase_roofline_checkpoint(cnn_res: dict) -> None:
    """ResNet50's batch-32 roofline on this card beside phase cnn's
    measured ms a microbatch, then a bit-equal checkpoint round trip of
    its params."""
    import tempfile

    import torch

    from defer_tpu_torch import DeferConfig
    from defer_tpu_torch.models import get_model
    from defer_tpu_torch.parallel.pipeline import cast_params_to_storage
    from defer_tpu_torch.runtime.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from defer_tpu_torch.utils.roofline import format_report, roofline_report

    dev = torch.device(CARD)
    model = get_model("resnet50")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    stored = cast_params_to_storage(
        params, DeferConfig(compute_dtype=torch.bfloat16))
    kind = torch.cuda.get_device_name(0)
    shape = (IMAGE_BATCH, *model.input_shape)
    measured = IMAGE_BATCH / cnn_res["resnet50"]["images_per_sec"] * 1e3
    for fused in (False, True):
        rep = roofline_report(model.graph, stored, shape, kind,
                              input_dtype=torch.bfloat16, top=3,
                              assume_fusion=fused)
        check(rep.get("t_lower_s") is not None,
              f"roofline: no peak rates known for {kind!r}")
        for line in format_report(rep).splitlines():
            log(f"roofline: {line}")
        log(f"roofline: resnet50 batch {IMAGE_BATCH} bf16, "
            f"{'fused' if fused else 'unfused (eager)'} traffic: predicted "
            f"{rep['t_lower_s'] * 1e3:.4f} ms a microbatch at the bound, "
            f"phase cnn measured {measured:.4f} ms (run_defer, 4 stages)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resnet50.ckpt")
        t0 = time.perf_counter()
        save_checkpoint(path, params)
        t1 = time.perf_counter()
        back = load_checkpoint(path, device=dev)
        t2 = time.perf_counter()
        size = os.path.getsize(path)
    n = 0
    for node, p in params.items():
        for k, v in p.items():
            got = back[node][k]
            check(got.dtype == v.dtype and got.device == v.device
                  and torch.equal(got, v),
                  f"checkpoint: {node}/{k} did not round-trip bit-equal")
            n += 1
    log(f"checkpoint: resnet50 params ({n} arrays, float32) saved in "
        f"{t1 - t0:.2f}s ({size} B on disk) and loaded onto cuda:0 in "
        f"{t2 - t1:.2f}s, bit-equal")


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
    if "paged_decode" in n:
        return "paged_flash_decode"
    if "paged_prefill" in n:
        return "paged_flash_prefill"
    if "flash_decode" in n:
        return "flash_decode"
    if any(t in n for t in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
        return "matmul"
    return "other"


def time_tick(tick, reps: int = 5) -> dict:
    """One steady decode tick `tick()`: the host ms to issue it on an
    idle card (median of `reps`), its wall ms to completion, and from
    torch.profiler its device ms by kernel family and its kernel
    launches. Fails if the tick makes a synchronizing CUDA call."""
    import torch

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
    fam_n: dict = {}
    launches = 0
    for e in prof.key_averages():
        dt = e.self_device_time_total
        if dt <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = _family(e.key)
        fam_us[fam] = fam_us.get(fam, 0.0) + dt
        fam_n[fam] = fam_n.get(fam, 0) + e.count
        launches += e.count
    device_ms = sum(fam_us.values()) / reps / 1e3
    check(device_ms > 0, "the profiler saw no device time in the tick")
    return {
        "host_ms": sorted(host)[reps // 2],
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "family_ms": {k: v / reps / 1e3 for k, v in sorted(fam_us.items())},
        "family_launches": {k: v / reps for k, v in sorted(fam_n.items())},
        "launches": launches / reps,
        "idle_share": 1.0 - device_ms / wall_ms,
    }


def flat_tick(dec, params, depth: int):
    """One steady flat decode tick (the batched step, the idle-slot pin
    and the argmax, as DecodeServer._tick runs them) with every slot at
    `depth`, as a closure for `time_tick`."""
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

    return tick


def log_split(phase: str, split: dict, depth, weight_bytes: int) -> None:
    weight_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"{phase}: one steady tick, {DECODE_SLOTS} slots at depth {depth}: "
        f"host {split['host_ms']:.4f} ms to issue (idle card), wall "
        f"{split['wall_ms']:.4f} ms, device {split['device_ms']:.4f} ms of "
        f"kernels ({split['launches']:.0f} launches, no host sync; "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in split["family_ms"].items())
        + f"); idle share {split['idle_share']:.4f}; weight read bound "
        f"{weight_ms:.4f} ms ({weight_bytes} B at 3.35 TB/s)")


def f32_reference_logits(dec, params, ids):
    """`dec.reference_logits` in float32 on the same weights: one full
    causal forward of ids [B, T] in which every weight is its stored
    bf16 value widened exactly to f32, one layer at a time (Mistral-7B
    whole in f32 would be 29 GB beside the bf16 copy), with TF32 off,
    so that it is the model's own logits and not another bf16 rounding
    of them. Returns [B, T, V] f32."""
    import torch

    from defer_tpu_torch import GptDecoder
    from defer_tpu_torch.models.gpt import _layer_view

    def wide(tree):
        return {k: wide(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}

    cfg = dec.cfg
    d32 = GptDecoder(cfg, compute_dtype=torch.float32, device=dec.device)
    ids = ids.to(dec.device)
    b, t = ids.shape
    dh = cfg.dim // cfg.num_heads
    top = wide({k: v for k, v in params.items() if k != "stack"})
    pos = torch.zeros((), dtype=torch.int32, device=dec.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            x = d32._embed_tokens(top, ids, pos)
            plan = d32._plan(pos, t, t)
            for layer in range(cfg.num_layers):
                kc, vc = (torch.zeros((b, cfg.kv_heads, t, dh),
                                      device=dec.device) for _ in range(2))
                x = d32._block(wide(_layer_view(params["stack"], layer)),
                               x, kc, vc, pos, plan)
            return d32._final_logits(top, x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


class ServedRows:
    """The logits rows one eager server picks its greedy tokens from, by
    request id, copied in f32 as the server makes them: each admission's
    prefill row (`_first_token`) and every step's rows. The flat server's
    ticks (`step` on its slot cache) give one row a live slot, in
    emission order. The paged server's rows are kept by the sequence
    index each predicts: a tick's (`_step`) row for slot i predicts
    pos[i] + 1, a slot-batched multi-token step's (`_mt`: mixed ticks,
    the speculative verify; an admission chunk's `_mt` is one request's
    and gives only its first token's row, through `_first_token`) row j
    pos[i] + j + 1, and a later step
    overwrites only indices not yet committed, so the last row for an
    index is the one its token was picked from. A window that runs
    eagerly (a mesh's, its K sub-steps uncaptured) gives its rows at
    each sub-step (`_decode`): row i predicts pos[i] + 1 for every row
    not frozen (a frozen row's table is all trash). A pipelined window
    (pp_stages > 1) gives them at each chain through the stages
    (`_pp_chain` inside `_tick_pp`), each group row found by its table.
    Wraps the server's own methods on this instance only; `close`
    unwraps."""

    def __init__(self, srv):
        import collections

        self.srv = srv
        self.paged = hasattr(srv, "_step")
        self.rows = collections.defaultdict(dict if self.paged else list)
        self._first = {}
        names = ("_first_token", "_step", "_mt") if self.paged else (
            "_first_token", "step")
        window = self.paged and srv.decode_window > 1 and not srv._captures
        if window:
            names += ("_decode",)
        if self.paged and srv.pp > 1:
            names += ("_tick_pp", "_pp_chain")
        # What close() puts back: an instance attribute, or None where
        # the wrapper shadows a method of the class.
        self._own = {name: vars(srv).get(name) for name in names}
        first_token = srv._first_token

        def first(i, samp, lrow, dtype, cid):
            self._first[i] = lrow.reshape(-1).float().clone()
            return first_token(i, samp, lrow, dtype, cid)

        srv._first_token = first
        if self.paged:
            step, mt = srv._step, srv._mt

            def tick(nb_live):
                self._settle()
                logits = step(nb_live)
                for i, rid in self._live():
                    self.rows[rid][int(srv.pos[i]) + 1] = \
                        logits[i, -1].float().clone()
                return logits

            def multi(tables, pos, ids, *args, **kwargs):
                self._settle()
                logits = mt(tables, pos, ids, *args, **kwargs)
                if ids.shape[0] != srv.B:
                    return logits  # one request's admission chunk
                at = pos.tolist()
                for i, rid in self._live():
                    for j in range(ids.shape[1]):
                        self.rows[rid][at[i] + j + 1] = \
                            logits[i, j].float().clone()
                return logits

            srv._step, srv._mt = tick, multi
            if window:
                decode = srv._decode

                def sub_step(tables, pos, feed, nb_live):
                    self._settle()
                    logits = decode(tables, pos, feed, nb_live)
                    live, at = tables.any(dim=1).tolist(), pos.tolist()
                    for i, rid in self._live():
                        if live[i]:
                            self.rows[rid][at[i] + 1] = \
                                logits[i, -1].float().clone()
                    return logits

                srv._decode = sub_step
            if srv.pp > 1:
                tick_pp, chain = srv._tick_pp, srv._pp_chain
                self._in_window = False

                def pp_window():
                    self._settle()
                    self._in_window = True
                    try:
                        return tick_pp()
                    finally:
                        self._in_window = False

                def stages(tables, pos, xin, *args):
                    logits = chain(tables, pos, xin, *args)
                    if self._in_window:
                        tabs, at = tables.cpu().numpy(), pos.tolist()
                        for r, tab in enumerate(tabs):
                            for i, rid in self._live():
                                if tab.any() and (srv.tables[i] == tab).all():
                                    self.rows[rid][at[r] + 1] = \
                                        logits[r, -1].float().clone()
                    return logits

                srv._tick_pp, srv._pp_chain = pp_window, stages
        else:  # the flat server: its tick is `step` on the slot cache
            step = srv.step

            def flat_tick(params, cache, ids):
                logits, out = step(params, cache, ids)
                if cache is srv.cache:
                    for i, rid in self._live():
                        if i in self._first:
                            self.rows[rid].append(self._first.pop(i))
                        self.rows[rid].append(logits[i, -1].float().clone())
                return logits, out

            srv.step = flat_tick

    def _live(self):
        for i, slot in enumerate(self.srv.slots):
            if isinstance(slot, dict):
                yield i, slot["rid"]
            elif slot is not None and not isinstance(slot, dict) \
                    and getattr(slot, "req", None) is not None:
                yield i, slot.req

    def _settle(self) -> None:
        """A paged slot's first token sits at index pos[i], where its
        seat leaves the slot until its next step."""
        for i, rid in self._live():
            if i in self._first:
                self.rows[rid][int(self.srv.pos[i])] = self._first.pop(i)

    def close(self) -> None:
        """Unwrap: the server's own methods again."""
        for name, own in self._own.items():
            if own is None:
                delattr(self.srv, name)
            else:
                setattr(self.srv, name, own)

    def of(self, rid, t_in: int | None = None, steps: int | None = None):
        """Request `rid`'s rows, [steps, V]: in emission order (flat), or
        those of indices t_in .. t_in + steps - 1 (paged)."""
        if not self.paged:
            return self.rows[rid]
        self._settle()
        got = self.rows[rid]
        return [got[q] for q in range(t_in, t_in + steps) if q in got]


def recorded_rows(label: str, srv, reqs, outs) -> list:
    """The rows for the split check, recorded on `srv`, a fresh server
    built as the timed one was, so that the timed rate carries no
    recording: `reqs` served again through ServedRows must give the timed
    run's `outs` token for token (greedy, the same kernels, a cold radix
    cache). Prints this run's rate beside the timed one's; returns the
    rows by request."""
    import torch

    served = ServedRows(srv)
    rids = [srv.submit(p, s) for p, s in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = [done[r] for r in rids]
    check(all(a.equal(b) for a, b in zip(got, outs)),
          f"{label}: the recording run's tokens differ from the timed run's")
    rows = [served.of(r, p.shape[1], n) for r, (p, n) in zip(rids, reqs)]
    served.close()
    generated = sum(n for _, n in reqs)
    log(f"{label}: the mix again on a fresh server recording the rows each "
        f"token is picked from: token-identical, {generated} tokens in "
        f"{wall:.3f}s, {generated / wall:.1f} tokens/s with the recording")
    return rows


def served_bound(phase: str, dec, params, reqs, outs, rows: list) -> None:
    """The split greedy check (SERVED_LOGIT_BOUND): every output echoes
    its prompt and has the requested length; (1) every generated token is
    the exact argmax of the row the server picked it from (`rows[i]`,
    [steps, V], from ServedRows); (2) every such row lies within
    SERVED_LOGIT_BOUND of the f32 reference (f32_reference_logits) at
    the same position."""
    import torch

    errs, gaps = [], []
    for i, ((prompt, steps), out, got) in enumerate(zip(reqs, outs, rows)):
        t_in = prompt.shape[1]
        check(tuple(out.shape) == (1, t_in + steps),
              f"{phase} request {i}: output shape {tuple(out.shape)}")
        check(torch.equal(out[:, :t_in].cpu(), prompt),
              f"{phase} request {i}: the prompt does not come back verbatim")
        check(len(got) == steps, f"{phase} request {i}: {len(got)} served "
              f"logits rows recorded for {steps} tokens")
        served = torch.stack(got)
        toks = out[0, t_in:].long().to(served.device)
        check(torch.equal(served.argmax(-1), toks),
              f"{phase} request {i}: a token is not the argmax of the row "
              "the server picked it from")
        ref = f32_reference_logits(dec, params, out[:, :-1])[0, t_in - 1:]
        errs.append(float((served - ref).abs().max()))
        gaps.append(ref.amax(-1) - ref.gather(-1, toks[:, None])[:, 0])
    gaps = torch.cat(gaps).float().cpu()
    n_off = int((gaps > 0).sum())
    worst = max(errs)
    log(f"{phase}: every output echoes its prompt; each of {gaps.numel()} "
        f"tokens is the exact argmax of the logits row the server picked it "
        f"from, and those rows lie within {worst:.4g} of the f32 reference "
        f"(bound {SERVED_LOGIT_BOUND}; by request: "
        f"{', '.join(f'{e:.3g}' for e in errs)}); so each token's f32 logit "
        f"is within {2 * worst:.4g} of its row's max (measured: max "
        f"{float(gaps.max()):.4g}, {n_off} tokens not the f32 argmax)")
    check(worst <= SERVED_LOGIT_BOUND,
          f"{phase}: a served logits row is {worst:.4g} from the f32 "
          f"reference, beyond the bound {SERVED_LOGIT_BOUND}")


def greedy_gaps(phase: str, dec, params, reqs, outs, share: float) -> None:
    """The int8 pool's contract: every output must echo its prompt, have
    the requested length, and every generated token's logit under the
    f32 reference on the same weights (f32_reference_logits, a fresh
    full forward) must lie within `share` of its row's logit scale (its
    max |logit|) of the row's max."""
    import torch

    gaps = []
    for i, ((prompt, steps), out) in enumerate(zip(reqs, outs)):
        t_in = prompt.shape[1]
        check(tuple(out.shape) == (1, t_in + steps),
              f"{phase} request {i}: output shape {tuple(out.shape)}")
        check(torch.equal(out[:, :t_in].cpu(), prompt),
              f"{phase} request {i}: the prompt does not come back verbatim")
        rows = f32_reference_logits(dec, params, out[:, :-1])[0, t_in - 1:]
        toks = out[0, t_in:].long()
        gap = rows.amax(dim=-1) - rows.gather(-1, toks[:, None])[:, 0]
        gaps.append(gap / rows.abs().amax(dim=-1))
    gaps = torch.cat(gaps).float().cpu()
    q = torch.quantile(gaps, torch.tensor([0.5, 0.9, 0.99, 1.0])).tolist()
    n_tied = int((gaps > 0).sum())
    log(f"{phase}: every output echoes its prompt; greedy gap (f32 "
        f"reference row max - chosen token's logit, as a share of the row's "
        f"logit scale) over {gaps.numel()} tokens: median {q[0]:.4g}, p90 "
        f"{q[1]:.4g}, p99 {q[2]:.4g}, max {q[3]:.4g}; {n_tied} tokens not "
        f"the f32 reference's argmax (tolerance {share})")
    check(q[3] <= share,
          f"{phase}: a generated token is {q[3]:.4g} below the f32 reference "
          "row max")


# The long run of phase decode (reported, not gated): one greedy request
# of DRIFT_STEPS tokens, its served rows' largest gap from the f32
# forward in each DRIFT_BUCKET-token bucket.
DRIFT_STEPS, DRIFT_BUCKET = 256, 64


def long_drift(dec, params) -> list:
    """How far the served bf16 rows drift from f32 over a long greedy
    generation: one request of DRIFT_STEPS tokens on an untimed
    DecodeServer recording its rows (ServedRows), each token checked as
    its row's argmax; returns the largest |served - f32| of each bucket
    of DRIFT_BUCKET generated tokens. SERVED_LOGIT_BOUND is not applied
    here: the readings say what that bound assumes."""
    import torch

    from defer_tpu_torch import DecodeServer

    prompt = torch.randint(0, dec.cfg.vocab_size, (1, 16),
                           generator=torch.Generator().manual_seed(7))
    srv = DecodeServer(dec, params, max_batch=DECODE_SLOTS)
    served = ServedRows(srv)
    rid = srv.submit(prompt, DRIFT_STEPS)
    out = srv.run()[rid]
    rows = torch.stack(served.of(rid))
    served.close()
    check(tuple(out.shape) == (1, 16 + DRIFT_STEPS)
          and rows.shape[0] == DRIFT_STEPS,
          f"decode long run: output {tuple(out.shape)}, {rows.shape[0]} rows")
    check(torch.equal(rows.argmax(-1), out[0, 16:].long().to(rows.device)),
          "decode long run: a token is not the argmax of its served row")
    ref = f32_reference_logits(dec, params, out[:, :-1])[0, 15:]
    gap = (rows - ref).abs().amax(-1).cpu()
    buckets = [float(gap[i : i + DRIFT_BUCKET].max())
               for i in range(0, DRIFT_STEPS, DRIFT_BUCKET)]
    log(f"decode: one {DRIFT_STEPS}-token greedy generation (untimed, "
        f"reported, not gated): largest served-row gap from f32 by "
        f"{DRIFT_BUCKET}-token bucket "
        f"{', '.join(f'{b:.4g}' for b in buckets)} (SERVED_LOGIT_BOUND "
        f"{SERVED_LOGIT_BOUND}{'; a bucket reads above it' if max(buckets) > SERVED_LOGIT_BOUND else ''})")
    return buckets


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
    launches = eager_decode_launches("decode")
    generated = sum(s for _, s in reqs)
    check(len(done) == len(reqs), f"{len(done)} of {len(reqs)} served")
    check(launches["flash_decode"] >= cfg.num_layers * srv.ticks,
          f"flash_decode launched {launches['flash_decode']} times, "
          f"expected >= {cfg.num_layers} x {srv.ticks} ticks")
    log(f"decode: {len(reqs)} requests served, {generated} tokens in "
        f"{srv.ticks} ticks ({generated / srv.ticks:.2f} tokens a tick, "
        f"{srv.solo_steps} solo steps), {wall:.3f}s, "
        f"{generated / wall:.1f} tokens/s incl. admission prefills")
    log(f"decode: flash_decode launches {launches['flash_decode']} "
        f"(>= {cfg.num_layers} x {srv.ticks} ticks)")
    outs = [done[r] for r in rids]
    ticks = srv.ticks
    del srv, done
    torch.cuda.empty_cache()
    rows = recorded_rows("decode", DecodeServer(
        dec, params, max_batch=DECODE_SLOTS), reqs, outs)
    served_bound("decode", dec, params, reqs, outs, rows)
    del rows
    torch.cuda.empty_cache()
    drift = long_drift(dec, params)
    torch.cuda.empty_cache()
    depth = 150
    split = time_tick(flat_tick(dec, params, depth))
    log_split("decode", split, depth, weight_bytes)
    return {"launches": launches, "ticks": ticks, "dec": dec,
            "params": params, "weight_bytes": weight_bytes, "outs": outs,
            "tokens_per_s": generated / wall, "split": split,
            "drift": drift}


# -- phase train: the SPMD encoder stack and the trainers --------------------

# BERT-base at bench.py bench_bert's widths, and GPT-2 small at the
# widths of HF openai-community/gpt2's config.json (tanh gelu, pre-LN,
# learned positions, tied head). Params f32, compute bf16.
BERT_BASE = dict(num_layers=12, dim=768, num_heads=12, ffn_dim=3072,
                 vocab_size=30522, max_len=512)
GPT2_SMALL = dict(num_layers=12, dim=768, num_heads=12, ffn_dim=3072,
                  vocab_size=50257, max_len=1024, layer_norm_eps=1e-5,
                  norm_style="pre", causal=True)
GPT2_EOS = 50256
# bench_bert's forward: M microbatches of B x S tokens on {"stage": 1}.
FWD_M, FWD_B, FWD_S = 8, 16, 128
# The classifier: {"stage": 4} on [cuda:0] x 4, M x B x S, 8 AdamW steps
# on one fixed batch (the last 7 timed), 2 classes. Adam's first step
# moves each of the ~110M weights by about lr along its gradient's sign,
# which on one batch of 32 random sequences overshoots at lr >= 1e-5
# (step 2's loss 1.8-3.3 against 0.81 at step 1, in an f32 run of this
# width); at CLS_LR the loss falls step by step (0.81 to 0.57 there).
CLS_M, CLS_B, CLS_S, CLS_STEPS, CLS_CLASSES = 4, 8, 128, 8, 2
CLS_LR = 2e-6
# bf16 against f32 on the same weights: the classifier's step-1 loss
# within 1e-2 relative and its gradient norm within 5e-2 (bf16 keeps 8
# bits; 12 layers of rounded activations put a few 1e-3 on the loss
# and more on gradients, which sum products of two rounded factors).
CLS_LOSS_RTOL, CLS_GRAD_RTOL = 1e-2, 5e-2
# The MoE FFN: 8 experts at BERT-base widths, top-1 and top-2; a2a at a
# capacity that cannot drop (cf = E / k) against dense, and the drops at
# cf 1.25; one train step each dispatch on M x B x S.
MOE_E, MOE_M, MOE_B = 8, 2, 8
# GPT-2 small LM: lm_batches over a synthetic corpus packed to S = 512,
# M = 2, B = 4, 10 Adam steps on one block; then 4 prompts x 32 greedy
# tokens on DecodeServer from the trained tree.
LM_M, LM_B, LM_S, LM_STEPS, LM_PROMPTS, LM_GEN = 2, 4, 512, 10, 4, 32
# The pipeline's last-position logits against GptDecoder.reference_logits
# on the same (f32-stored, bf16-computed) weights: the two differ in the
# attention kernel (flash against the decoder's masked einsum) and the
# order of sums only; logits have unit scale, a bf16 ulp there is 4e-3.
LM_LOGIT_TOL = 0.1
# DPO: 3 steps on M x B pairs of a 64-token prompt and 64-token
# completions; step 1 at log 2 within 1e-3 (policy = reference).
DPO_M, DPO_B, DPO_PROMPT, DPO_STEPS = 2, 4, 64, 3
# LoRA: rank 16 on wq and wv of BERT-base, 3 steps at the classifier's
# shape.
LORA_RANK, LORA_STEPS = 16, 3


def _peak_reset() -> None:
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _peak_gb() -> float:
    import torch

    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def _train_flops(cfg, tokens: int, seq: int, vocab: bool) -> float:
    """A training step's model FLOPs: three times transformer_flops (the
    forward, and a backward of twice its products), the tied head's
    product with the LM."""
    from defer_tpu_torch.utils.flops import transformer_flops

    return 3 * transformer_flops(
        num_layers=cfg.num_layers, dim=cfg.dim, ffn_dim=cfg.ffn_dim,
        seq_len=seq, batch=tokens // seq,
        vocab_size=cfg.vocab_size if vocab else 0)


def _recording(opt_cls, **kw):
    """An optimizer factory whose optimizer records the global gradient
    norm of each step it takes (a tensor on the card, read after)."""
    import torch

    class Recording(opt_cls):
        norms: list

        def step(self, closure=None):
            grads = [p.grad for g in self.param_groups for p in g["params"]
                     if p.grad is not None]
            self.norms.append(torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads])))
            return super().step(closure)

    def factory(params):
        opt = Recording(params, **kw)
        opt.norms = []
        return opt

    return factory


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict)
            else v.detach().clone() for k, v in tree.items()}


def _tree_equal(a, b) -> bool:
    import torch

    return all(
        _tree_equal(a[k], b[k]) if isinstance(a[k], dict)
        else torch.equal(a[k], b[k]) for k in a)


def train_forward(dev) -> dict:
    """SpmdBert at bench_bert's shape: tokens/s, MFU, 96 flash_attention
    launches a step, the pooled output against an f32 forward through
    the plain attention on the same weights (TF32 off)."""
    import torch

    from defer_tpu_torch.models.bert import SpmdBert
    from defer_tpu_torch.parallel.mesh import make_mesh
    from defer_tpu_torch.parallel.transformer_stack import TransformerConfig
    from defer_tpu_torch.utils.flops import transformer_flops

    cfg = TransformerConfig(**BERT_BASE)
    mesh = make_mesh({"stage": 1}, [dev])
    sb = SpmdBert(mesh, cfg, compute_dtype=torch.bfloat16)
    params = sb.init(torch.Generator(device=dev).manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (FWD_M, FWD_B, FWD_S),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    step = sb.make_step()
    with torch.inference_mode():
        step(params, ids)  # warm-up
    torch.cuda.synchronize()
    # Outside inference mode: the card's run counters are made at their
    # first use and must stay writable.
    zero_launches()
    with torch.inference_mode():
        out = step(params, ids)
        torch.cuda.synchronize()
        launches = read_launches()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            step(params, ids)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        # The host's time to issue one step on an idle card: near the
        # step's time, the card waits on the host.
        issue_ms = host_time_us(lambda: step(params, ids), iters=3) / 1e3
    want_launches = cfg.num_layers * FWD_M
    check(launches["flash_attention"] == want_launches,
          f"train forward: flash_attention launched "
          f"{launches['flash_attention']} times a step, expected "
          f"{want_launches}")
    tokens = FWD_M * FWD_B * FWD_S
    flops = transformer_flops(num_layers=cfg.num_layers, dim=cfg.dim,
                              ffn_dim=cfg.ffn_dim, seq_len=FWD_S,
                              batch=FWD_M * FWD_B)
    mfu = flops / dt / BF16_FLOP_PER_S

    sb32 = SpmdBert(mesh, cfg, compute_dtype=torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = sb32.reference_apply(params, ids)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    got = out.float()
    rel = float((got - want).norm() / want.norm())
    check(tuple(out.shape) == (FWD_M, FWD_B, cfg.dim)
          and bool(torch.isfinite(got).all()) and rel <= ZOO_REL_L2,
          f"train forward: pooled output {rel:.3e} (relative L2) from the "
          f"f32 plain forward, tol {ZOO_REL_L2}")
    log(f"train: SpmdBert forward, BERT-base, stage 1, M {FWD_M} x B "
        f"{FWD_B} x S {FWD_S}: {dt * 1e3:.3f} ms a step ({issue_ms:.3f} ms "
        f"of host to issue one), {tokens / dt:.1f} tokens/s, MFU "
        f"{mfu:.4f}; flash_attention "
        f"{launches['flash_attention']} launches a step (= {cfg.num_layers}"
        f" x {FWD_M}); pooled bf16 vs f32 plain forward: relative L2 "
        f"{rel:.3e} (tol {ZOO_REL_L2}), max abs "
        f"{float((got - want).abs().max()):.3e}")
    return {"launches": launches["flash_attention"], "ms": dt * 1e3,
            "issue_ms": issue_ms, "tokens_per_s": tokens / dt, "mfu": mfu,
            "rel_l2": rel}


def train_classifier(dev) -> dict:
    """BERT-base classification fine-tuning on {"stage": 4} over [cuda:0]
    x 4: step 1's loss and gradient norm against an f32 plain
    computation on the same weights, the loss falling over CLS_STEPS
    AdamW steps, step ms, peak memory and launches; then one step with
    remat=True from the same init: the same loss, twice the launches,
    less peak memory."""
    import dataclasses

    import torch

    from defer_tpu_torch.models.bert import SpmdBert
    from defer_tpu_torch.parallel import train
    from defer_tpu_torch.parallel.mesh import make_mesh
    from defer_tpu_torch.parallel.transformer_stack import TransformerConfig

    cfg = TransformerConfig(**BERT_BASE)
    mesh = make_mesh({"stage": 4}, [dev] * 4)
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(0, cfg.vocab_size, (CLS_M, CLS_B, CLS_S),
                        generator=gen).to(dev)
    labels = torch.randint(0, CLS_CLASSES, (CLS_M, CLS_B),
                           generator=gen).to(dev)
    opt = _recording(torch.optim.AdamW, lr=CLS_LR, weight_decay=1e-4)

    def fresh(c):
        sb = SpmdBert(mesh, c, compute_dtype=torch.bfloat16)
        init, step = train.make_train_step(sb, opt, num_classes=CLS_CLASSES)
        return init(torch.Generator(device=dev).manual_seed(3)), step

    state, step = fresh(cfg)
    p0 = _clone_tree(state.params)
    _peak_reset()
    zero_launches()
    state, loss = step(state, ids, labels)
    torch.cuda.synchronize()
    launches1 = read_launches()["flash_attention"]
    peak = _peak_gb()
    losses = [loss]
    t0 = time.perf_counter()
    for _ in range(CLS_STEPS - 1):
        state, loss = step(state, ids, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (CLS_STEPS - 1) * 1e3
    losses = [float(x) for x in losses]
    norm1 = float(state.opt_state.norms[0])
    del state
    check(launches1 == cfg.num_layers * CLS_M,
          f"classifier: flash_attention launched {launches1} times in a "
          f"step, expected {cfg.num_layers} x {CLS_M}")
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"classifier: the loss did not fall: {losses}")

    # The f32 plain computation: the same weights, the plain attention,
    # TF32 off; loss and gradients by autograd.
    sb32 = SpmdBert(mesh, cfg, compute_dtype=torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        leaves = [t.requires_grad_() for t in train.tree_leaves(p0)]
        ref = train.classifier_loss(sb32.reference_apply, p0, p0, ids, labels)
        grads = torch.autograd.grad(ref, leaves)
        ref_norm = float(torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads])))
        ref = float(ref.detach())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del p0, leaves, grads
    loss_err = abs(losses[0] - ref) / abs(ref)
    norm_err = abs(norm1 - ref_norm) / ref_norm
    check(loss_err <= CLS_LOSS_RTOL and norm_err <= CLS_GRAD_RTOL,
          f"classifier: step 1 loss {losses[0]:.6f} / grad norm {norm1:.6f}"
          f" against f32 {ref:.6f} / {ref_norm:.6f}")

    state, step = fresh(dataclasses.replace(cfg, remat=True))
    _peak_reset()
    zero_launches()
    state, loss_r = step(state, ids, labels)
    torch.cuda.synchronize()
    launches_r = read_launches()["flash_attention"]
    peak_r = _peak_gb()
    loss_r = float(loss_r)
    del state
    check(launches_r == 2 * launches1,
          f"classifier remat: {launches_r} flash_attention launches, "
          f"expected twice {launches1} (the backward recomputes)")
    check(abs(loss_r - losses[0]) <= CLS_LOSS_RTOL * abs(losses[0])
          and peak_r < peak,
          f"classifier remat: loss {loss_r} against {losses[0]}, peak "
          f"{peak_r:.3f} GB against {peak:.3f} GB")
    tokens = CLS_M * CLS_B * CLS_S
    mfu = _train_flops(cfg, tokens, CLS_S, False) / (step_ms / 1e3) \
        / BF16_FLOP_PER_S
    log(f"train: classifier, BERT-base on {{'stage': 4}} over [cuda:0] x 4, "
        f"M {CLS_M} x B {CLS_B} x S {CLS_S}, AdamW: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; step 1 loss "
        f"{losses[0]:.6f} vs f32 plain {ref:.6f} (rel {loss_err:.2e}, tol "
        f"{CLS_LOSS_RTOL}), grad norm {norm1:.6f} vs {ref_norm:.6f} (rel "
        f"{norm_err:.2e}, tol {CLS_GRAD_RTOL}); {step_ms:.3f} ms a step "
        f"(steps 2-{CLS_STEPS}), {tokens / (step_ms / 1e3):.1f} tokens/s, "
        f"MFU {mfu:.4f}; flash_attention {launches1} launches a step; peak "
        f"{peak:.3f} GB")
    log(f"train: classifier remat=True, one step from the same init: loss "
        f"{loss_r:.6f} (vs {losses[0]:.6f}), flash_attention {launches_r} "
        f"launches (the recompute doubles them), peak {peak_r:.3f} GB "
        f"against {peak:.3f} GB")
    return {"launches": launches1, "remat_launches": launches_r,
            "step_ms": step_ms, "peak_gb": peak, "remat_peak_gb": peak_r,
            "losses": losses, "loss_rel_err": loss_err,
            "grad_norm_rel_err": norm_err, "mfu": mfu}


def train_moe(dev) -> dict:
    """MoE at BERT-base widths with MOE_E experts, top-1 and top-2: the
    a2a dispatch against dense at a capacity that cannot drop (one
    layer, bf16, the kernels' bf16 tolerance), the dropped share at cf
    1.25, and one train step of the whole model each dispatch."""
    import dataclasses

    import torch

    from defer_tpu_torch.models.bert import SpmdBert
    from defer_tpu_torch.parallel import train
    from defer_tpu_torch.parallel import transformer_stack as ts
    from defer_tpu_torch.parallel.mesh import make_mesh

    cfg = ts.TransformerConfig(**BERT_BASE, num_experts=MOE_E)
    layer = ts.init_stack(torch.Generator(device=dev).manual_seed(4),
                          dataclasses.replace(cfg, num_layers=1))
    p = {k: v[0] for k, v in layer.items()}
    x = torch.randn(MOE_B, SEQ, cfg.dim, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    x = x.to(torch.bfloat16)
    n = MOE_B * SEQ
    mesh = make_mesh({"stage": 2}, [dev] * 2)
    gen = torch.Generator().manual_seed(6)
    ids = torch.randint(0, cfg.vocab_size, (MOE_M, MOE_B, SEQ),
                        generator=gen).to(dev)
    labels = torch.randint(0, CLS_CLASSES, (MOE_M, MOE_B),
                           generator=gen).to(dev)
    res = {}
    for k in (1, 2):
        with torch.inference_mode():
            dense = ts.moe_ffn(p, x, top_k=k)
            a2a = ts.moe_ffn_a2a(p, x, capacity_factor=MOE_E / k, top_k=k)
            err = _held(f"top{k} a2a (cf {MOE_E / k:g}) vs dense", "moe_ffn",
                        a2a, dense, torch.bfloat16,
                        f"x={tuple(x.shape)} E={MOE_E}")
            idx, w = ts._route_topk(p["router"], x.reshape(n, cfg.dim), k)
            cap = ts.moe_capacity(n, MOE_E, k, 1.25)
            _, _, keep = ts.a2a_slots(idx, w, MOE_E, cap)
            dropped = 1.0 - float(keep.sum()) / (k * n)
        steps = {}
        for dispatch in ("dense", "a2a"):
            c = dataclasses.replace(cfg, moe_top_k=k, moe_dispatch=dispatch,
                                    capacity_factor=1.25)
            sb = SpmdBert(mesh, c, compute_dtype=torch.bfloat16)
            init, step = train.make_train_step(
                sb, functools.partial(torch.optim.AdamW, lr=1e-4,
                                      weight_decay=1e-4),
                num_classes=CLS_CLASSES)
            state = init(torch.Generator(device=dev).manual_seed(3))
            _peak_reset()
            zero_launches()
            t0 = time.perf_counter()
            state, loss = step(state, ids, labels)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = read_launches()["flash_attention"]
            loss = float(loss)
            check(math.isfinite(loss) and launches == cfg.num_layers * MOE_M,
                  f"moe top{k} {dispatch}: loss {loss}, {launches} "
                  "flash_attention launches")
            steps[dispatch] = {"loss": loss, "ms": ms, "launches": launches,
                               "peak_gb": _peak_gb()}
            del state, init, step, sb
        log(f"train: moe top-{k}, {MOE_E} experts at BERT-base widths: a2a "
            f"at cf {MOE_E / k:g} vs dense max_abs_err {err:.3e}; at cf 1.25 "
            f"(capacity {cap} of {k * n} slots claimed) {dropped:.4f} of "
            f"the (token, expert) pairs dropped; one train step each "
            f"(M {MOE_M} x B {MOE_B} x S {SEQ}, stage 2): "
            + "; ".join(f"{d} loss {s['loss']:.4f}, {s['ms']:.1f} ms (the "
                        f"first, allocations included), peak "
                        f"{s['peak_gb']:.3f} GB, flash_attention "
                        f"{s['launches']}" for d, s in steps.items()))
        res[f"top{k}"] = {"a2a_vs_dense_err": err, "dropped": dropped,
                          **{d: s for d, s in steps.items()}}
    return res


def synthetic_corpus(vocab: int, seed: int = 0) -> list:
    """Documents of 64-480 tokens drawn from `seed` (token ids below the
    eos id): enough to pack one LM block."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab - 1, int(rng.integers(64, 480))).tolist()
            for _ in range(48)]


def train_lm(dev) -> dict:
    """GPT-2 small next-token training on {"stage": 2} over [cuda:0] x 2:
    LM_STEPS Adam steps on one lm_batches block (the loss must fall);
    the pipeline's last-position logits against GptDecoder's
    reference_logits on the same weights; the stage stack flattened and
    served on DecodeServer at K=1, every token under the split greedy
    check, flash_decode counted."""
    import torch

    from defer_tpu_torch import DecodeServer, GptDecoder
    from defer_tpu_torch.models.bert import SpmdBert
    from defer_tpu_torch.parallel import train
    from defer_tpu_torch.parallel.mesh import make_mesh
    from defer_tpu_torch.parallel.spmd_pipeline import unstack_stages
    from defer_tpu_torch.parallel.transformer_stack import TransformerConfig
    from defer_tpu_torch.runtime.text_data import lm_batches

    cfg = TransformerConfig(**GPT2_SMALL)
    sb = SpmdBert(make_mesh({"stage": 2}, [dev] * 2), cfg,
                  compute_dtype=torch.bfloat16)
    init, step = train.make_lm_train_step(
        sb, functools.partial(torch.optim.Adam, lr=3e-4))
    state = init(torch.Generator(device=dev).manual_seed(8))
    block = next(lm_batches(synthetic_corpus(cfg.vocab_size), seq_len=LM_S,
                            batch=LM_B, num_microbatches=LM_M,
                            eos_id=GPT2_EOS, seed=0))
    ids = torch.from_numpy(block).to(dev)
    _peak_reset()
    zero_launches()
    state, loss = step(state, ids)
    torch.cuda.synchronize()
    launches = read_launches()["flash_attention"]
    peak = _peak_gb()
    losses = [loss]
    t0 = time.perf_counter()
    for _ in range(LM_STEPS - 1):
        state, loss = step(state, ids)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (LM_STEPS - 1) * 1e3
    losses = [float(x) for x in losses]
    check(launches == cfg.num_layers * LM_M,
          f"lm: flash_attention launched {launches} times in a step, "
          f"expected {cfg.num_layers} x {LM_M}")
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"lm: the loss did not fall: {losses}")
    tokens = LM_M * LM_B * LM_S
    mfu = _train_flops(cfg, tokens, LM_S, True) / (step_ms / 1e3) \
        / BF16_FLOP_PER_S
    log(f"train: lm, GPT-2 small on {{'stage': 2}} over [cuda:0] x 2, "
        f"lm_batches M {LM_M} x B {LM_B} x S {LM_S}, Adam: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; {step_ms:.3f} ms a step "
        f"(steps 2-{LM_STEPS}), {tokens / (step_ms / 1e3):.1f} tokens/s, "
        f"MFU {mfu:.4f}; flash_attention {launches} launches a step "
        f"(causal); peak {peak:.3f} GB")

    flat = {k: v.detach() for k, v in state.params.items() if k != "stack"}
    flat["stack"] = {k: v.detach()
                     for k, v in unstack_stages(state.params["stack"]).items()}
    dec = GptDecoder(cfg, compute_dtype=torch.bfloat16, device=dev)
    with torch.inference_mode():
        got = train._lm_logits(sb, state.params, ids[:1])[0, :, -1]
        want = dec.reference_logits(flat, ids[0])[:, -1]
    del state
    lm_err = float((got - want).abs().max())
    check(lm_err <= LM_LOGIT_TOL,
          f"lm: pipeline logits {lm_err:.4g} from the decoder's, tol "
          f"{LM_LOGIT_TOL}")
    params = dec.cast_params(flat)
    del flat
    reqs = [(ids[0, i : i + 1, :16].cpu(), LM_GEN) for i in range(LM_PROMPTS)]
    srv = DecodeServer(dec, params, max_batch=LM_PROMPTS)
    rids = [srv.submit(pr, s) for pr, s in reqs]
    torch.cuda.synchronize()
    zero_launches()
    done = srv.run()
    torch.cuda.synchronize()
    serve = eager_decode_launches("train serve")
    ticks = srv.ticks
    outs = [done[r] for r in rids]
    check(serve["flash_decode"] >= cfg.num_layers * ticks,
          f"train serve: flash_decode ran {serve['flash_decode']} times, "
          f"expected >= {cfg.num_layers} x {ticks} ticks")
    log(f"train: the trained tree, stack flattened, on GptDecoder: the "
        f"pipeline's last-position logits within {lm_err:.4g} of "
        f"reference_logits (tol {LM_LOGIT_TOL}); DecodeServer at K=1 served "
        f"{LM_PROMPTS} prompts x {LM_GEN} greedy tokens in {ticks} ticks, "
        f"flash_decode {serve['flash_decode']} runs on the card")
    rows = recorded_rows("train serve", DecodeServer(
        dec, params, max_batch=LM_PROMPTS), reqs, outs)
    served_bound("train serve", dec, params, reqs, outs, rows)
    return {"launches": launches, "step_ms": step_ms, "peak_gb": peak,
            "losses": losses, "mfu": mfu, "logit_err": lm_err,
            "serve_launches": serve["flash_decode"], "ticks": ticks}


def train_dpo(dev) -> dict:
    """DPO on GPT-2 small, DPO_STEPS steps: step 1 at log 2 (policy =
    reference), the reference tree bit for bit unchanged, the accuracy
    printed."""
    import torch

    from defer_tpu_torch.models.bert import SpmdBert
    from defer_tpu_torch.parallel import train
    from defer_tpu_torch.parallel.mesh import make_mesh
    from defer_tpu_torch.parallel.transformer_stack import TransformerConfig

    cfg = TransformerConfig(**GPT2_SMALL)
    sb = SpmdBert(make_mesh({"stage": 2}, [dev] * 2), cfg,
                  compute_dtype=torch.bfloat16)
    init, step = train.make_dpo_train_step(
        sb, functools.partial(torch.optim.Adam, lr=1e-5), beta=0.1)
    state = init(torch.Generator(device=dev).manual_seed(9))
    ref = _clone_tree(state.params)
    ref_copy = _clone_tree(ref)
    gen = torch.Generator().manual_seed(10)
    shape = (DPO_M, DPO_B)
    prompt = torch.randint(0, GPT2_EOS, (*shape, DPO_PROMPT), generator=gen)
    chosen = torch.cat([prompt, torch.randint(
        0, GPT2_EOS, (*shape, DPO_PROMPT), generator=gen)], -1).to(dev)
    rejected = torch.cat([prompt, torch.randint(
        0, GPT2_EOS, (*shape, DPO_PROMPT), generator=gen)], -1).to(dev)
    mask = torch.cat([torch.zeros(*shape, DPO_PROMPT),
                      torch.ones(*shape, DPO_PROMPT)], -1).to(dev)
    _peak_reset()
    zero_launches()
    out = [step(state, ref, chosen, rejected, mask, mask)[1]]
    torch.cuda.synchronize()
    launches = read_launches()["flash_attention"]
    t0 = time.perf_counter()
    for _ in range(DPO_STEPS - 1):
        out.append(step(state, ref, chosen, rejected, mask, mask)[1])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (DPO_STEPS - 1) * 1e3
    peak = _peak_gb()
    losses = [float(x) for x, _ in out]
    accs = [float(a) for _, a in out]
    del state
    check(abs(losses[0] - math.log(2.0)) <= 1e-3,
          f"dpo: step 1 loss {losses[0]} is not log 2 within 1e-3")
    check(_tree_equal(ref, ref_copy), "dpo: the reference tree changed")
    check(launches == 2 * cfg.num_layers * DPO_M,
          f"dpo: {launches} flash_attention launches in a step, expected "
          f"policy + reference = 2 x {cfg.num_layers} x {DPO_M}")
    log(f"train: dpo, GPT-2 small, M {DPO_M} x B {DPO_B} pairs of "
        f"{DPO_PROMPT}-token prompts and completions: losses "
        f"{', '.join(f'{x:.6f}' for x in losses)} (step 1 - log 2 = "
        f"{losses[0] - math.log(2.0):.2e}), accuracy "
        f"{', '.join(f'{a:.3f}' for a in accs)}; the reference tree bit for "
        f"bit unchanged; {step_ms:.3f} ms a step, peak {peak:.3f} GB, "
        f"flash_attention {launches} launches a step (policy + reference)")
    return {"launches": launches, "step_ms": step_ms, "losses": losses,
            "accs": accs, "peak_gb": peak}


def train_lora(dev) -> dict:
    """LoRA rank LORA_RANK on wq / wv of BERT-base, LORA_STEPS steps at
    the classifier's shape: the base bit for bit unchanged with no
    .grad, the trainable count printed."""
    import torch

    from defer_tpu_torch.models.bert import SpmdBert
    from defer_tpu_torch.parallel import train
    from defer_tpu_torch.parallel.lora import make_lora_train_step
    from defer_tpu_torch.parallel.mesh import make_mesh
    from defer_tpu_torch.parallel.transformer_stack import TransformerConfig

    cfg = TransformerConfig(**BERT_BASE, lora_rank=LORA_RANK,
                            lora_targets=("wq", "wv"))
    sb = SpmdBert(make_mesh({"stage": 4}, [dev] * 4), cfg,
                  compute_dtype=torch.bfloat16)
    init, step = make_lora_train_step(
        sb, functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-4),
        num_classes=CLS_CLASSES)
    state, base = init(torch.Generator(device=dev).manual_seed(11))
    base_copy = _clone_tree(base)
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(0, cfg.vocab_size, (CLS_M, CLS_B, CLS_S),
                        generator=gen).to(dev)
    labels = torch.randint(0, CLS_CLASSES, (CLS_M, CLS_B),
                           generator=gen).to(dev)
    n_train = sum(t.numel() for t in train.tree_leaves(state.params))
    n_base = sum(t.numel() for t in train.tree_leaves(base))
    _peak_reset()
    zero_launches()
    losses = [step(state, base, ids, labels)[1]]
    torch.cuda.synchronize()
    launches = read_launches()["flash_attention"]
    t0 = time.perf_counter()
    for _ in range(LORA_STEPS - 1):
        losses.append(step(state, base, ids, labels)[1])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (LORA_STEPS - 1) * 1e3
    peak = _peak_gb()
    losses = [float(x) for x in losses]
    leaves = train.tree_leaves(base)
    check(_tree_equal(base, base_copy)
          and all(t.grad is None and not t.requires_grad for t in leaves),
          "lora: a base tensor changed or holds a gradient")
    check(launches == cfg.num_layers * CLS_M and all(map(math.isfinite,
                                                         losses)),
          f"lora: losses {losses}, {launches} flash_attention launches")
    log(f"train: lora rank {LORA_RANK} on wq/wv, BERT-base on "
        f"{{'stage': 4}}: {n_train} trainable parameters (adapters + head) "
        f"over a frozen base of {n_base}; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; every base tensor bit for "
        f"bit unchanged, none holds a .grad; {step_ms:.3f} ms a step, peak "
        f"{peak:.3f} GB, flash_attention {launches} launches a step")
    return {"launches": launches, "step_ms": step_ms, "trainable": n_train,
            "losses": losses, "peak_gb": peak}


def phase_train() -> dict:
    """The SPMD encoder stack and the four trainers at full width on
    cuda:0 (each sub-path's kernel counts zeroed just before it)."""
    import torch

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    res = {}
    for name, fn in (("forward", train_forward),
                     ("classifier", train_classifier), ("moe", train_moe),
                     ("lm", train_lm), ("dpo", train_dpo),
                     ("lora", train_lora)):
        t1 = time.perf_counter()
        res[name] = fn(dev)
        torch.cuda.empty_cache()
        log(f"train: {name} done in {time.perf_counter() - t1:.1f}s")
    log(f"train: phase done in {time.perf_counter() - t0:.1f}s")
    return res


# -- phase dist: the training collectives on two ranks of cuda:0 -------------

# Two ranks share cuda:0 over gloo (NCCL refuses two ranks on one card),
# both started once for every layout, at BERT-base widths and depth: M
# microbatches of B x S tokens, bf16 compute, f32 params, 2 AdamW steps
# a layout (step 2 timed), each against the one-process {"stage": 1}
# run of the same config on the same card, weights and batch. The a2a
# layout runs at a capacity that cannot drop (cf = E / k), where it
# equals the dense dispatch and the one-process run; the CPU tests hold
# the drop set at cf 1.25 to the JAX package's. The expert layouts and
# their reference compute in f32: in bf16 the ep psum's other order of
# sums flips near-tied top-2 routes a few layers on (the pooled output
# 1.031e-01 from one process in relative L2, step-1 loss 1.7e-3, in a
# bf16 run), which is the routing's sensitivity, not the collectives'.
DIST_WORLD, DIST_M, DIST_B, DIST_S, DIST_CLASSES = 2, 2, 8, 128, 2
DIST_LR, DIST_STEPS = 1e-5, 2
# Seconds the two ranks may take, every layout included.
DIST_TIMEOUT = 600
# Step 1's loss against the one-process run's, absolute: bf16 steps of
# one config differ in the order of their sums only.
DIST_LOSS_ATOL = 1e-2
DIST_LORA = dict(lora_rank=16, lora_targets=("wq", "wv"))
DIST_MOE = dict(num_experts=8, moe_top_k=2)
# (layout, mesh axes, config overrides, SpmdBert keywords, trainer options)
DIST_LAYOUTS = [
    ("tp_lora", {"stage": 1, "model": 2}, DIST_LORA, {}, {"lora": True}),
    ("dp", {"data": 2, "stage": 1}, {}, {}, {}),
    ("dp_zero1", {"data": 2, "stage": 1}, {}, {}, {"zero1": True}),
    ("dp_fsdp", {"data": 2, "stage": 1}, {}, {"fsdp": True}, {}),
    ("ep_dense", {"stage": 1, "expert": 2}, DIST_MOE, {}, {}),
    ("ep_a2a", {"stage": 1, "expert": 2},
     dict(DIST_MOE, moe_dispatch="a2a", capacity_factor=4.0), {}, {}),
    ("seq_ring", {"stage": 1, "seq": 2}, {}, {"sp_strategy": "ring"}, {}),
    ("seq_ulysses", {"stage": 1, "seq": 2}, {},
     {"sp_strategy": "ulysses"}, {}),
    ("stage2", {"stage": 2}, {}, {}, {}),
]


def _dist_launches(axes: dict) -> int:
    """flash_attention launches a step on each rank: every layer a rank
    holds, once a microbatch step; M + S - 1 steps with the stage axis
    across ranks (the bubble steps are computed); none under sp."""
    if axes.get("seq", 1) > 1:
        return 0
    stages = axes.get("stage", 1)
    return BERT_BASE["num_layers"] // stages * (DIST_M + stages - 1)


class _ByteCount:
    """The bytes each mesh axis's collectives are handed in a step, and
    how many calls: the torch.distributed calls of
    parallel/collectives.py, wrapped in this rank process only (the
    tensor an all_reduce reduces, the output an all_gather fills, the
    input a reduce_scatter or an all_to_all sends)."""

    CALLS = {"all_reduce": 0, "all_gather_into_tensor": 0,
             "reduce_scatter_tensor": 1, "all_to_all_single": 1}

    def __init__(self):
        import torch.distributed as dist

        self.axis_of: dict = {}
        self.bytes: dict = {}
        self.calls: dict = {}
        for name, arg in self.CALLS.items():
            setattr(dist, name, self._wrap(getattr(dist, name), arg))

    def _wrap(self, fn, arg):
        def counted(*args, group=None, **kw):
            axis = self.axis_of.get(id(group), "other")
            self.bytes[axis] = self.bytes.get(axis, 0) + args[arg].nbytes
            self.calls[axis] = self.calls.get(axis, 0) + 1
            return fn(*args, group=group, **kw)

        return counted

    def start(self, mesh) -> None:
        self.axis_of = ({id(g): a for a, g in mesh.groups.items()}
                        if mesh.distributed else {})
        self.bytes = {}
        self.calls = {}


def _dist_run(over, sb_kw, opts, mesh, dev, batch, counter):
    """One layout's forward and DIST_STEPS AdamW steps on this rank."""
    import functools

    import torch

    from defer_tpu_torch.models.bert import SpmdBert
    from defer_tpu_torch.ops.flash_attention import flash_attention
    from defer_tpu_torch.parallel import lora, train
    from defer_tpu_torch.parallel.transformer_stack import TransformerConfig

    ids, labels = batch
    cfg = TransformerConfig(**BERT_BASE, **over)
    dtype = torch.float32 if cfg.num_experts else torch.bfloat16
    sb = SpmdBert(mesh, cfg, compute_dtype=dtype, **sb_kw)
    opt = functools.partial(torch.optim.AdamW, lr=DIST_LR,
                            weight_decay=1e-4)
    gen = torch.Generator(device=dev).manual_seed(5)
    if opts.get("lora"):
        init, step = lora.make_lora_train_step(sb, opt,
                                               num_classes=DIST_CLASSES)
        state, base = init(gen)
        run = functools.partial(step, state, base)
        params = lora.combine_lora(base, state.params)
    else:
        init, step = train.make_train_step(sb, opt, num_classes=DIST_CLASSES,
                                           zero1=opts.get("zero1", False))
        state = init(gen)
        run = functools.partial(step, state)
        params = state.params
    with torch.no_grad():
        pooled = sb.make_step()(params, ids).float()
    torch.cuda.synchronize()
    counter.start(mesh)
    flash_attention.launches = 0
    _, loss1 = run(ids, labels)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    moved = dict(counter.bytes)
    t0 = time.perf_counter()
    _, loss2 = run(ids, labels)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {"pooled": pooled, "loss1": float(loss1), "loss2": float(loss2),
            "ms": ms, "launches": launches, "bytes": moved,
            "params": _clone_tree(state.params)}


# The sharded legs of the dist ranks: ShardedInference's batch (BERT-base
# at seq SEQ) and its tolerance against the one-process graph (relative
# L2; the same kernels on the same rows, the shard's matrix products of
# another row count); host timing repetitions.
INFER_BATCH, INFER_REL_L2, DIST_TIMED_REPS = 32, 1e-2, 3


def _host_ms(fn, reps: int = DIST_TIMED_REPS) -> float:
    """The host ms of `fn` to its end on the card (synchronized), a
    mean of `reps` runs after one untimed: every rank runs the same
    number, so that their collectives pair up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def dist_t5(rank: int, dev, counter, dist) -> dict:
    """SpmdT5 at T5-base (phase t5's weights, seed 7) at tp 2 over the
    two ranks: encode T5_BATCH x T5_ENC, T5_STEPS greedy steps; both
    ranks' tokens equal, rank 0's rows under the split check against an
    f32 forward of the whole model (T5_LOGIT_BOUND); the encode's and a
    step's host ms over the ranks, the collectives a step and their
    bytes on the model axis; no flash_attention launch."""
    import torch

    from defer_tpu_torch.models.t5 import T5, spmd_t5, t5_config
    from defer_tpu_torch.parallel.mesh import make_mesh

    cfg = t5_config("base")
    mesh = make_mesh({"model": DIST_WORLD}, [dev] * DIST_WORLD)
    whole = T5(cfg, compute_dtype=torch.bfloat16, device=dev)
    params = whole.cast_params(
        whole.init(torch.Generator(device=dev).manual_seed(7)))
    m = spmd_t5(mesh, cfg, compute_dtype=torch.bfloat16)
    sp = m.shard_params(params)
    if rank:
        del params
        torch.cuda.empty_cache()
    enc = torch.randint(0, cfg.vocab_size, (T5_BATCH, T5_ENC),
                        generator=torch.Generator().manual_seed(8))
    step = m.make_step()
    rows = []

    def recorded(p, cache, ids):
        logits, out = step(p, cache, ids)
        rows.append(logits[:, -1].float().clone())
        return logits, out

    m._steps[True] = recorded
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = m.generate(sp, enc, T5_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()["flash_attention"]
    m._steps[True] = step
    toks = _rank_runs(out.cpu().tolist(), dist)
    check(all(t == toks[0] for t in toks),
          "dist t5: the ranks generated different tokens")
    check(launches == 0, f"dist t5: rank {rank} launched flash_attention "
          f"{launches} times")
    with torch.no_grad():
        encode_ms = _host_ms(lambda: m.encode(sp, enc))
        _, cache = m.make_encode()(sp, enc, torch.ones(enc.shape,
                                                       dtype=torch.int32))
        _, cache = m.prefill(sp, cache, out[:, :T5_STEPS // 2])
        ids = out[:, T5_STEPS // 2:T5_STEPS // 2 + 1]
        counter.start(mesh)
        step(sp, cache, ids)
        torch.cuda.synchronize()
        calls, moved = dict(counter.calls), dict(counter.bytes)
        step_ms = _host_ms(lambda: step(sp, cache, ids))
    want = 3 * cfg.dec_layers + 2
    check(calls.get("model", 0) == want,
          f"dist t5: a step made {calls} collectives, expected {want} on "
          "the model axis")
    res = {"encode_ms": encode_ms, "step_ms": step_ms, "wall_s": wall,
           "collectives_step": calls.get("model", 0),
           "bytes_step": moved.get("model", 0), "launches": launches}
    if rank == 0:
        served = torch.stack(rows, dim=1)
        check(len(rows) == T5_STEPS and torch.equal(
            served.argmax(-1), out[:, 1:].long()),
              "dist t5: a token is not the argmax of the row the step "
              "picked it from")
        m32 = T5(cfg, compute_dtype=torch.float32, device=dev)
        p32 = m32.cast_params(params)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.no_grad():
                ref = m32.forward(p32, enc, out[:, :-1])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        del p32
        res["max_err"] = float((served - ref).abs().max())
        check(res["max_err"] <= T5_LOGIT_BOUND,
              f"dist t5: a served row is {res['max_err']:.4g} from the f32 "
              f"forward, beyond the bound {T5_LOGIT_BOUND}")
    return res


def dist_checkpoint(rank: int, dev, batch, here: str, dist) -> dict:
    """A ZeRO-1 MeshOptimizer state of the BERT-base classifier on
    {"stage": 1, "data": 2}: one AdamW step, save_sharded_train_state,
    one more step (the uninterrupted run); a state from another seed
    stepped once, restore_sharded_train_state, one step: its params bit
    for bit the uninterrupted run's. Each rank's file bytes and host ms
    each way."""
    import functools

    import torch

    from defer_tpu_torch.models.bert import SpmdBert
    from defer_tpu_torch.parallel import train
    from defer_tpu_torch.parallel.mesh import make_mesh
    from defer_tpu_torch.parallel.transformer_stack import TransformerConfig
    from defer_tpu_torch.runtime import checkpoint

    mesh = make_mesh({"stage": 1, "data": DIST_WORLD}, [dev] * DIST_WORLD)
    sb = SpmdBert(mesh, TransformerConfig(**BERT_BASE),
                  compute_dtype=torch.bfloat16)
    init, step = train.make_train_step(
        sb, functools.partial(torch.optim.AdamW, lr=DIST_LR,
                              weight_decay=1e-4),
        num_classes=DIST_CLASSES, zero1=True)
    path = os.path.join(here, "ckpt")
    state = init(torch.Generator(device=dev).manual_seed(5))
    step(state, *batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_sharded_train_state(path, state, sb, save_id=1)
    save_ms = (time.perf_counter() - t0) * 1e3
    dist.barrier()
    step(state, *batch)
    straight = _clone_tree(state.params)
    sliced = len(state.opt_state.slices)
    del state
    other = init(torch.Generator(device=dev).manual_seed(6))
    step(other, *batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.restore_sharded_train_state(path, other, sb)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    step(other, *batch)
    check(sliced > 0 and _tree_equal(straight, other.params),
          f"dist checkpoint: rank {rank}'s params after the restored step "
          "are not bit for bit the uninterrupted run's")
    nbytes = os.path.getsize(os.path.join(
        path, f"shards-{rank:05d}-of-{DIST_WORLD:05d}.defer"))
    return {"bytes": nbytes, "save_ms": save_ms, "restore_ms": restore_ms,
            "sliced": sliced}


def dist_inference(rank: int, dev) -> dict:
    """ShardedInference of BERT-base (phase main's graph and weights,
    seq SEQ) over {"data": 2}: INFER_BATCH rows, each rank its half,
    every rank the whole output, within INFER_REL_L2 (relative L2) of
    the unpartitioned graph on the whole batch in this process; its
    flash_attention launches a call on each rank and its host ms."""
    import torch

    from defer_tpu_torch import DeferConfig
    from defer_tpu_torch.models import get_model
    from defer_tpu_torch.parallel.data_parallel import ShardedInference
    from defer_tpu_torch.parallel.mesh import make_mesh
    from defer_tpu_torch.parallel.pipeline import cast_params_to_storage

    model = get_model("bert_base", seq_len=SEQ)
    config = DeferConfig(compute_dtype=torch.bfloat16)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        batch_size=INFER_BATCH)
    vocab = model.graph.node_map["token_embedding"].attrs["vocab_size"]
    ids = torch.randint(0, vocab, (INFER_BATCH, SEQ),
                        generator=torch.Generator().manual_seed(1))
    mesh = make_mesh({"data": DIST_WORLD}, [dev] * DIST_WORLD)
    dp = ShardedInference(model.graph, params, mesh, config)
    torch.cuda.synchronize()
    zero_launches()
    got = dp(ids).float()
    torch.cuda.synchronize()
    launches = read_launches()["flash_attention"]
    with torch.inference_mode():
        want = model.graph.apply(cast_params_to_storage(params, config),
                                 ids.to(dev)).float()
    rel = float((got - want).norm() / want.norm())
    layers = sum(1 for n in model.graph.nodes if n.op == "mha")
    check(tuple(got.shape) == tuple(want.shape) and rel <= INFER_REL_L2
          and launches == layers,
          f"dist inference: rank {rank}: output {tuple(got.shape)}, "
          f"{rel:.3e} (relative L2, tol {INFER_REL_L2}) from the "
          f"unpartitioned graph; flash_attention {launches} launches, "
          f"expected {layers}")
    return {"rel_l2": rel, "launches": launches,
            "ms": _host_ms(lambda: dp(ids))}


def dist_rank(rank: int, port: int, out: str) -> int:
    """One of phase dist's two ranks: every layout in DIST_LAYOUTS, in
    order, on cuda:0 over gloo; rank 0 also runs the one-process
    references (rank 1 waits at a barrier) and writes the results to
    `out`. Any failure raises: the rank exits non-zero."""
    import torch
    import torch.distributed as dist

    from defer_tpu_torch.parallel import multihost
    from defer_tpu_torch.parallel.mesh import make_mesh

    multihost.initialize(f"tcp://127.0.0.1:{port}", DIST_WORLD, rank,
                         backend="gloo")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    counter = _ByteCount()
    gen = torch.Generator().manual_seed(4)
    batch = (torch.randint(0, BERT_BASE["vocab_size"],
                           (DIST_M, DIST_B, DIST_S), generator=gen).to(dev),
             torch.randint(0, DIST_CLASSES, (DIST_M, DIST_B),
                           generator=gen).to(dev))
    refs = {}
    if rank == 0:
        one = make_mesh({"stage": 1}, [dev])
        for over, opts in (({}, {}), (DIST_LORA, {"lora": True}),
                           (DIST_MOE, {}),
                           (dict(DIST_MOE, moe_dispatch="a2a",
                                 capacity_factor=4.0), {})):
            key = json.dumps([over, opts], sort_keys=True)
            refs[key] = _dist_run(over, {}, opts, one, dev, batch, counter)
            refs[key].pop("params")
            torch.cuda.empty_cache()
    dist.barrier()
    lines, report, plain = [], {}, None
    for name, axes, over, sb_kw, opts in DIST_LAYOUTS:
        mesh = make_mesh(axes, [dev] * DIST_WORLD)
        got = _dist_run(over, sb_kw, opts, mesh, dev, batch, counter)
        want = _dist_launches(axes)
        check(got["launches"] == want,
              f"dist {name}: rank {rank} launched flash_attention "
              f"{got['launches']} times a step, expected {want}")
        if name == "dp":
            plain = got["params"]
        if name == "dp_zero1":
            check(_tree_equal(plain, got["params"]),
                  f"dist dp_zero1: rank {rank}'s parameters after "
                  f"{DIST_STEPS} steps are not bit for bit plain dp's")
        if rank == 0:
            ref = refs[json.dumps([over, {k: v for k, v in opts.items()
                                          if k == "lora"}], sort_keys=True)]
            rel = float((got["pooled"] - ref["pooled"]).norm()
                        / ref["pooled"].norm())
            dloss = abs(got["loss1"] - ref["loss1"])
            check(rel <= ZOO_REL_L2 and dloss <= DIST_LOSS_ATOL
                  and math.isfinite(got["loss2"]),
                  f"dist {name}: pooled {rel:.3e} (relative L2, tol "
                  f"{ZOO_REL_L2}) and step-1 loss {got['loss1']:.6f} vs "
                  f"{ref['loss1']:.6f} (tol {DIST_LOSS_ATOL}) from the "
                  f"one-process run")
            report[name] = {"ms": got["ms"], "ref_ms": ref["ms"],
                            "launches": got["launches"],
                            "bytes": got["bytes"], "rel_l2": rel,
                            "loss1": got["loss1"], "ref_loss1": ref["loss1"]}
            lines.append(
                f"dist: {name} {axes} {sb_kw or ''}{opts or ''}: step "
                f"{got['ms']:.3f} ms against the one-process "
                f"{ref['ms']:.3f} ms; step-1 loss {got['loss1']:.6f} vs "
                f"{ref['loss1']:.6f}; pooled relative L2 {rel:.3e}; "
                f"flash_attention {got['launches']} launches a step on "
                f"each rank; bytes a step by axis {got['bytes']}")
        del got
        torch.cuda.empty_cache()
    # The sharded legs: SpmdT5, sharded checkpoints, ShardedInference.
    legs = {"t5": dist_t5(rank, dev, counter, dist)}
    torch.cuda.empty_cache()
    legs["checkpoint"] = dist_checkpoint(rank, dev, batch,
                                         os.path.dirname(out), dist)
    torch.cuda.empty_cache()
    legs["inference"] = dist_inference(rank, dev)
    legs = _rank_runs(legs, dist)
    for mod in ("jax", "defer_tpu"):
        check(mod not in sys.modules, f"dist rank {rank} imported {mod}")
    if rank == 0:
        t5, ck, inf = (legs[0][k] for k in ("t5", "checkpoint", "inference"))
        lines.append(
            f"dist: SpmdT5 T5-base tp {DIST_WORLD} (bf16, seed 7 as phase "
            f"t5): generate {T5_BATCH} x {T5_ENC} tokens, {T5_STEPS} greedy "
            f"steps, in {t5['wall_s']:.3f}s, tokens equal on both ranks; "
            f"each token the exact argmax of rank 0's row, those rows within "
            f"{t5['max_err']:.4g} of the whole model's f32 forward (bound "
            f"{T5_LOGIT_BOUND}); encode {t5['encode_ms']:.3f} ms, a cached "
            f"step at depth {T5_STEPS // 2} {t5['step_ms']:.3f} ms (host, "
            f"synchronized, over the ranks); {t5['collectives_step']} "
            f"collectives a step (an embedding psum, 3 psums a layer, the "
            f"logits all-gather), {t5['bytes_step']} B a step on the model "
            f"axis; "
            f"flash_attention launches {[r['t5']['launches'] for r in legs]}"
            " by rank")
        lines.append(
            f"dist: sharded checkpoint of a ZeRO-1 BERT-base state on "
            f"{{'stage': 1, 'data': {DIST_WORLD}}} ({ck['sliced']} leaves' "
            f"moments sliced on data): a restored step bit for bit the "
            f"uninterrupted run's on both ranks; bytes by rank "
            f"{[r['checkpoint']['bytes'] for r in legs]}; save ms "
            f"{[round(r['checkpoint']['save_ms'], 3) for r in legs]}, "
            f"restore ms "
            f"{[round(r['checkpoint']['restore_ms'], 3) for r in legs]}")
        lines.append(
            f"dist: ShardedInference BERT-base over {{'data': {DIST_WORLD}}}"
            f", batch {INFER_BATCH} x seq {SEQ}: the whole output on both "
            f"ranks, relative L2 "
            f"{[round(r['inference']['rel_l2'], 6) for r in legs]} from the "
            f"unpartitioned graph (tol {INFER_REL_L2}); flash_attention "
            f"{[r['inference']['launches'] for r in legs]} launches by rank"
            f"; {inf['ms']:.3f} ms a call (host, synchronized)")
        report["sharded_legs"] = legs
        with open(out, "w") as f:
            json.dump({"layouts": report, "lines": lines}, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def dist_nccl_ops() -> dict:
    """A world-size-1 NCCL group on cuda:0: each op of
    parallel/collectives.py once on BERT-base-sized tensors (an
    activation microbatch [B, S, D] in bf16, and one layer's FFN weight
    [D, F] in f32 for the all_gather / reduce_scatter), each the
    identity at one rank; and the refusal of two ranks on one card."""
    import torch
    import torch.distributed as dist

    from defer_tpu_torch.parallel import collectives, multihost
    from defer_tpu_torch.parallel.mesh import make_mesh

    try:
        multihost.initialize(f"tcp://127.0.0.1:{_free_port()}", 2, 1,
                             backend="nccl", local_rank=1)
    except RuntimeError as e:
        refused = str(e)
    else:
        raise SmokeError("initialize took NCCL for two ranks on one card")
    check("backend='gloo'" in refused and not dist.is_initialized(),
          f"NCCL's refusal did not name gloo: {refused}")
    multihost.initialize(f"tcp://127.0.0.1:{_free_port()}", 1, 0,
                         backend="nccl")
    try:
        mesh = make_mesh({"seq": 1})
        dev = mesh.local_device
        gen = torch.Generator(device=dev).manual_seed(6)
        act = torch.randn(DIST_B, DIST_S, BERT_BASE["dim"], generator=gen,
                          device=dev).to(torch.bfloat16)
        weight = torch.randn(BERT_BASE["dim"], BERT_BASE["ffn_dim"],
                             generator=gen, device=dev)
        with collectives.active(mesh):
            ops = {
                "all_reduce": (collectives.psum(act, "seq"), act),
                "all_to_all": (collectives.all_to_all(
                    act, "seq", split_axis=0, concat_axis=1), act),
                "all_gather": (collectives.all_gather(weight, "seq", dim=1),
                               weight),
                "reduce_scatter": (collectives.scatter_dim(
                    weight, mesh.group("seq"), 1, 1), weight),
                "ppermute": (collectives.ppermute(act, "seq", [(0, 0)]),
                             act),
            }
        torch.cuda.synchronize()
        for op, (got, want) in ops.items():
            check(torch.equal(got, want),
                  f"NCCL world 1: {op} is not the identity")
    finally:
        dist.destroy_process_group()
    log(f"dist: NCCL {torch.cuda.nccl.version()} world 1 on cuda:0: "
        f"{', '.join(ops)} each the identity on BERT-base tensors "
        f"(activation {tuple(act.shape)} bf16, weight {tuple(weight.shape)}"
        f" f32); initialize refused two NCCL ranks on one card")
    return {"ops": list(ops)}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dist(here: str) -> dict:
    """The training collectives (parallel/collectives.py) on the card:
    NCCL at world size 1, then DIST_LAYOUTS on two gloo ranks sharing
    cuda:0, started once. A rank that fails, hangs past DIST_TIMEOUT or
    exits non-zero fails the phase; every rank is stopped by its end."""
    import tempfile

    t0 = time.perf_counter()
    nccl = dist_nccl_ops()
    out = os.path.join(tempfile.mkdtemp(prefix="dist-"), "report.json")
    _start_ranks(here, "--dist-rank", DIST_WORLD, out, DIST_TIMEOUT, "dist")
    with open(out) as f:
        res = json.load(f)
    for line in res["lines"]:
        log(line)
    log("dist: gloo ranks sharing one card stage every collective through "
        "the host: these step times are not NCCL's")
    log(f"dist: phase done in {time.perf_counter() - t0:.1f}s")
    return {"nccl": nccl, **res["layouts"]}


# -- phase family: the rest of the decoder family ---------------------------

# Decode windows of the flat server (K sub-steps a captured CUDA graph),
# and the three sampled requests held identical at K=1 and K=8: (prompt
# index of the mix, steps, temperature, top_k, top_p, min_p, seed).
FAMILY_WINDOWS = (4, 8)
FAMILY_SAMPLED = [(0, 24, 0.8, 50, 1.0, 0.0, 11),
                  (1, 24, 1.0, 0, 0.9, 0.0, 12),
                  (2, 24, 0.7, 0, 1.0, 0.05, 13)]
# The rolling cache: a prompt and greedy steps that cross the window, and
# the reference's max_len (a flat cache long enough for the whole run).
ROLL_PROMPT, ROLL_STEPS, ROLL_REF_LEN = 4000, 160, 8192
# Speculation: the draft's layers (make_draft truncation), proposals a
# round, greedy steps.
SPEC_LAYERS, SPEC_K, SPEC_STEPS = 4, 4, 64
# Constrained decoding: the synthetic vocabulary's eos (its empty
# string), requests' steps, and the two grammars (the digits regex and
# tests/test_constrain.py's schema).
CONSTRAIN_EOS, CONSTRAIN_STEPS = 0, 24
CONSTRAIN_SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}}}
# Multi-LoRA: adapters in the bank (ids 1-3; 0 the base), their rank and
# targets, and the scale of their b factors.
LORA_ADAPTERS, LORA_RANK, LORA_TARGETS, LORA_B_SCALE = 3, 16, ("wq", "wv"), 0.02
# Beam search: width, steps, and the tolerance of a summed log-prob
# over the 16 steps (a beam's score against reference_logits, and the
# best beam against the greedy sequence): the scores read within 0.0436
# of the reference on the H100, so 0.2 leaves 4.6x of room, and the
# phase checks that a wrong reorder (each lane fed its neighbour beam's
# cache) lands outside it.
BEAM, BEAM_STEPS = 4, 16
BEAM_SCORE_TOL = 0.2


def synthetic_vocab(size: int) -> list:
    """A 32000-string vocabulary for the constraints: id 0 the empty
    string (the eos), then the 95 printable ASCII characters, then
    strings of 2-6 characters drawn by a seeded generator from digits,
    letters and JSON punctuation (multi-character tokens exercise the
    compiler's token lift)."""
    import random

    rng = random.Random(5)
    alphabet = "0123456789abcdefghijklmnopqrstuvwxyz{}[]\":,.-+ eE"
    vocab = [""] + [chr(c) for c in range(32, 127)]
    while len(vocab) < size:
        vocab.append("".join(rng.choice(alphabet)
                             for _ in range(rng.randint(2, 6))))
    return vocab


def window_tick(srv, mode: str = "argmax"):
    """One steady captured window of `srv` (its seated slots all live,
    budgets far off), as a closure for `time_tick`: the replay and the
    budget update `_tick_window` issues, without the drain."""
    program = srv._window_program(mode, False)
    w = srv._wbuf

    def tick():
        w["budget"].fill_(1 << 20)
        program()
        w["budget"].sub_(w["n"])

    return tick


def family_windows(dec, params, reqs, k1: dict) -> dict:
    """The 12-request mix through DecodeServer(decode_window=K): outputs
    token-identical to phase 4's K=1 outputs, timed; the flash_decode
    kernels the card ran in that run equal to (replays + capture
    warm-ups) x K x layers (the number the kernels line reports); a
    steady window's host and device split, and one window's kernels on
    the card; then three sampled requests identical at K=1 and K=8."""
    import torch

    from defer_tpu_torch import DecodeServer, SamplingParams
    from defer_tpu_torch.ops.flash_decode import card_runs

    L = dec.cfg.num_layers
    out = {}
    for K in FAMILY_WINDOWS:
        srv = DecodeServer(dec, params, max_batch=DECODE_SLOTS,
                           decode_window=K)
        rids = [srv.submit(p, s) for p, s in reqs]
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        done = srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        host, total = read_launches()["flash_decode"], card_runs()
        generated = sum(s for _, s in reqs)
        for i, (r, want) in enumerate(zip(rids, k1["outs"])):
            check(torch.equal(done[r], want),
                  f"window K={K}: request {i} differs from decode_window=1")
        replays, captures = srv.graph_replays, srv.graph_captures
        check(replays > 0 and captures >= 1,
              f"window K={K}: no captured graph replayed")
        # The wrapper runs at each capture's warm-up and capture, and not
        # at a replay; the card runs the kernels at each warm-up and
        # replay, and not at a capture.
        check(host == 2 * K * L * captures,
              f"window K={K}: flash_decode host count {host}, expected "
              f"2 x {K} x {L} x {captures} captures")
        check(total == (replays + captures) * K * L,
              f"window K={K}: the card ran {total} flash_decode kernels, "
              f"expected ({replays} replays + {captures} warm-ups) x {K} x "
              f"{L}")
        del srv, done
        # A steady window of four seated slots at depth 150.
        tsrv = DecodeServer(dec, params, max_batch=DECODE_SLOTS,
                            decode_window=K)
        gen = torch.Generator().manual_seed(K)
        for _ in range(DECODE_SLOTS):
            tsrv.submit(torch.randint(0, dec.cfg.vocab_size, (1, 150),
                                      generator=gen), dec.cfg.max_len - 150)
        tsrv._admit()
        tick = window_tick(tsrv)
        split = time_tick(tick)
        fd_kernels = split["family_launches"].get("flash_decode", 0)
        zero_launches()
        tick()
        one = card_runs()
        check(one == K * L,
              f"window K={K}: the card ran {one} flash_decode kernels in a "
              f"window, expected {K} x {L}")
        log(f"family: window K={K}: {len(reqs)} requests token-identical to "
            f"decode_window=1; {generated} tokens in {wall:.3f}s, "
            f"{generated / wall:.1f} tokens/s incl. admission prefills "
            f"(decode_window=1: {k1['tokens_per_s']:.1f}); "
            f"graph_replays {replays}; flash_decode kernels run on the card "
            f"{total} = ({replays} replays + {captures} capture warm-up) x "
            f"{K} x {L} (the kernel's own count), host launches {host}")
        log(f"family: window K={K}, one steady window of {DECODE_SLOTS} "
            f"slots from depth 150: host {split['host_ms']:.4f} ms to issue "
            f"(idle card), wall {split['wall_ms']:.4f} ms, device "
            f"{split['device_ms']:.4f} ms of kernels "
            f"({split['launches']:.1f} launches by profiler, {fd_kernels:.1f}"
            f" flash_decode against the card's count of {one}; "
            + ", ".join(
                f"{k} {v:.4f} ms" for k, v in split["family_ms"].items())
            + f"); idle share {split['idle_share']:.4f}; a token "
            f"{split['wall_ms'] / K:.4f} ms against decode_window=1's "
            f"{k1['split']['wall_ms']:.4f} ms")
        out[f"window{K}"] = {"launches": total, "split": split,
                             "tokens_per_s": generated / wall,
                             "graph_replays": replays}
        del tsrv
        torch.cuda.empty_cache()

    sreqs = [(reqs[i][0], steps) for i, steps, *_ in FAMILY_SAMPLED]
    samps = [SamplingParams(temperature=t, top_k=k, top_p=p, min_p=m,
                            seed=seed)
             for _, _, t, k, p, m, seed in FAMILY_SAMPLED]
    runs = []
    for K in (1, 8):
        srv = DecodeServer(dec, params, max_batch=DECODE_SLOTS,
                           decode_window=K)
        rids = [srv.submit(p, s, sampling=sp)
                for (p, s), sp in zip(sreqs, samps)]
        done = srv.run()
        runs.append([done[r] for r in rids])
    for i, (a, b) in enumerate(zip(*runs)):
        check(torch.equal(a, b),
              f"sampled request {i}: decode_window=8 differs from 1")
        check(tuple(a.shape) == (1, sreqs[i][0].shape[1] + sreqs[i][1]),
              f"sampled request {i}: output shape {tuple(a.shape)}")
    log(f"family: {len(sreqs)} sampled requests (seeds "
        f"{[sp.seed for sp in samps]}, top_k / top_p / min_p) "
        "token-identical at decode_window=1 and 8")
    return out


def family_rolling(dec, params) -> dict:
    """GptDecoder(rolling_cache=True) on phase 4's weights: a
    ROLL_PROMPT-token prompt and ROLL_STEPS greedy steps, crossing the
    window; every token held by the split greedy check (the rows generate
    picked them from, against the f32 forward of a flat decoder with
    max_len ROLL_REF_LEN); the cache window x rows;
    no flash_decode launch (a rolling step attends by einsum)."""
    import dataclasses

    import torch

    from defer_tpu_torch import GptDecoder

    cfg = dec.cfg
    roll = GptDecoder(cfg, compute_dtype=dec.compute_dtype,
                      rolling_cache=True)
    cache = roll.init_cache(1)
    nbytes = sum(cache[k].numel() * cache[k].element_size()
                 for k in ("k", "v"))
    row_bytes = 2 * cfg.num_layers * cfg.kv_heads * (
        cfg.dim // cfg.num_heads) * cache["k"].element_size()
    check(cache["k"].shape[3] == cfg.window
          and nbytes == cfg.window * row_bytes,
          f"rolling cache holds {cache['k'].shape[3]} rows, {nbytes} B")
    del cache
    prompt = torch.randint(0, cfg.vocab_size, (1, ROLL_PROMPT),
                           generator=torch.Generator().manual_seed(6))
    step = roll.make_step()
    rows = []

    def recorded(p, cache, ids):
        # The rows generate picks its greedy tokens from: the prefill's
        # last, then each step's (the last token needs no forward).
        logits, out = step(p, cache, ids)
        rows.append(logits[0, -1].float().clone())
        return logits, out

    roll._steps[True] = recorded
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = roll.generate(params, prompt, ROLL_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    roll._steps[True] = step
    launches = eager_decode_launches("rolling")
    check(launches["flash_decode"] == 0,
          f"rolling: flash_decode launched {launches['flash_decode']} times")
    log(f"family: rolling, GptDecoder(rolling_cache=True): a "
        f"{ROLL_PROMPT}-token prompt + {ROLL_STEPS} greedy steps "
        f"(positions to {ROLL_PROMPT + ROLL_STEPS - 1}, window "
        f"{cfg.window}) in {wall:.3f}s; cache {nbytes} B = window "
        f"{cfg.window} x {row_bytes} B a row; flash_decode launches 0")
    ref = GptDecoder(dataclasses.replace(cfg, max_len=ROLL_REF_LEN),
                     compute_dtype=dec.compute_dtype)
    served_bound("family: rolling", ref, params, [(prompt, ROLL_STEPS)],
                 [out], [rows])
    return {"launches": 0}


def family_speculative(dec, params) -> dict:
    """speculative_generate with make_draft(dec, params, layers=4): every
    token held by the split greedy check on the target rows the verify
    picked it from; acceptance and agreement with plain greedy printed;
    the draft's T=1 steps counted on flash_decode."""
    import torch

    from defer_tpu_torch.models.speculative import speculative_generate
    from defer_tpu_torch.models.transplant import make_draft

    draft, dparams = make_draft(dec, params, layers=SPEC_LAYERS)
    prompt = decode_requests(dec.cfg.vocab_size)[0][0]
    step = dec.make_step()
    by_index = {}

    def recorded(p, cache, ids):
        # The target's rows by the sequence index each predicts (row j of
        # a step at write head pos predicts index pos + j + 1); a later
        # step overwrites only indices not yet committed, so the last row
        # for an index is the one its committed token was picked from.
        pos = int(cache["pos"])
        logits, out = step(p, cache, ids)
        for j in range(ids.shape[1]):
            by_index[pos + j + 1] = logits[0, j].float().clone()
        return logits, out

    dec._steps[True] = recorded
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out, stats = speculative_generate(dec, params, draft, dparams, prompt,
                                      SPEC_STEPS, k=SPEC_K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dec._steps[True] = step
    launches = eager_decode_launches("speculative")
    check(launches["flash_decode"] > 0,
          "speculative: the draft's steps launched no flash_decode")
    plain = dec.generate(params, prompt, SPEC_STEPS)
    same = int((out[0, prompt.shape[1]:] == plain[0, prompt.shape[1]:]).sum())
    log(f"family: speculative_generate(target, make_draft(layers="
        f"{SPEC_LAYERS}), k={SPEC_K}): {SPEC_STEPS} tokens in {wall:.3f}s, "
        f"{stats['rounds']} rounds, {stats['target_steps']} target steps, "
        f"acceptance {stats['acceptance']:.4f}; {same} of {SPEC_STEPS} "
        f"tokens equal plain greedy; flash_decode launches "
        f"{launches['flash_decode']}")
    t_in = prompt.shape[1]
    served_bound("family: speculative", dec, params, [(prompt, SPEC_STEPS)],
                 [out], [[by_index[q] for q in range(t_in, t_in + SPEC_STEPS)]])
    dev_t5, dev_t1 = teacher_forced_error(dec, params, out, prompt.shape[1])
    log(f"family: speculative: the target's logits for the {SPEC_STEPS} "
        f"generated rows, teacher-forced in verify-shaped steps of "
        f"T={SPEC_K + 1} (einsum), differ from the f32 reference by up to "
        f"{dev_t5:.4g}, and in T=1 steps (flash_decode) by up to "
        f"{dev_t1:.4g}: a token picked on either is within twice that of "
        f"its reference row's max")
    return {"launches": launches["flash_decode"], "stats": stats}


def teacher_forced_error(dec, params, out, t_in: int) -> tuple:
    """The largest |logit - f32_reference_logits| over the rows that predict
    out's generated tokens, with the target fed `out` after its prompt
    in steps of SPEC_K + 1 tokens (the verify's shape) and in steps of
    one token (plain decoding's)."""
    import torch

    ref = f32_reference_logits(dec, params, out[:, :-1])[0, t_in - 1:]
    errs = []
    for width in (SPEC_K + 1, 1):
        step = dec.make_step()
        logits, cache = step(params, dec.init_cache(1), out[:, :t_in])
        rows = [logits[0, -1:]]
        for a in range(t_in, out.shape[1] - 1, width):
            b = min(a + width, out.shape[1] - 1)
            logits, cache = step(params, cache, out[:, a:b])
            rows.append(logits[0])
        got = torch.cat(rows).float()
        errs.append(float((got - ref).abs().max()))
        del cache
    return tuple(errs)


def _constrained_bound(label, dec, params, dfas, reqs, outs, rows) -> tuple:
    """The split greedy check among admissible tokens (those its DFA
    state admits; eos only in accepting states): (1) every generated
    token is admissible and the exact argmax, over the admissible
    tokens, of the row the server picked it from (`rows`, ServedRows on
    the decode_window=1 run); (2) every such row lies within
    SERVED_LOGIT_BOUND of the f32 reference. Returns (the largest row
    error, the largest f32 gap below the best admissible token)."""
    import torch

    worst, gap = 0.0, 0.0
    for (name, prompt, _), out, got in zip(reqs, outs, rows):
        dfa = dfas[name]
        t_in = prompt.shape[1]
        ref = f32_reference_logits(dec, params, out[:, :-1])[0, t_in - 1:]
        state = dfa.start
        for j, tok in enumerate(out[0, t_in:].tolist()):
            mask = torch.from_numpy(dfa.transitions[state] >= 0)
            mask[CONSTRAIN_EOS] = bool(dfa.accepting[state])
            check(bool(mask[tok]), f"{label}: token {tok} not admissible")
            row, served = ref[j].cpu(), got[j].cpu()
            pick = int(served.masked_fill(~mask, float("-inf")).argmax())
            check(pick == tok, f"{label} {name}: token {tok} is not the "
                  "admissible argmax of the row the server picked it from")
            worst = max(worst, float((served - row).abs().max()))
            gap = max(gap, float(row[mask].max() - row[tok]))
            if tok == CONSTRAIN_EOS:
                break
            state = int(dfa.transitions[state, tok])
    check(worst <= SERVED_LOGIT_BOUND, f"{label}: a served row is "
          f"{worst:.4g} from the f32 reference, beyond {SERVED_LOGIT_BOUND}")
    return worst, gap


def family_constrained(dec, params) -> dict:
    """The digits regex and the schema compiled against a synthetic
    32000-string vocabulary; two requests of each through
    DecodeServer(constraints=) at decode_window 1 and 8: every output
    matches its grammar, every token is the greedy admissible choice,
    and the two windows agree."""
    import json
    import re

    import torch

    from defer_tpu_torch import DecodeServer, SamplingParams
    from defer_tpu_torch.constrain import compile_json_schema, compile_regex
    from defer_tpu_torch.ops.flash_decode import card_runs

    vocab = synthetic_vocab(dec.cfg.vocab_size)
    t0 = time.perf_counter()
    dfas = {"digits": compile_regex("[0-9]+", vocab),
            "obj": compile_json_schema(CONSTRAIN_SCHEMA, vocab)}
    compile_s = time.perf_counter() - t0
    pattern = {"digits": "[0-9]+",
               "obj": dfas["obj"].pattern}
    mix = decode_requests(dec.cfg.vocab_size)
    reqs = [(name, mix[i][0], CONSTRAIN_STEPS)
            for i, name in enumerate(["digits", "obj", "digits", "obj"])]
    L = dec.cfg.num_layers
    runs, launches, served = [], {}, None
    for K in (1, 8):
        srv = DecodeServer(dec, params, max_batch=DECODE_SLOTS,
                           eos_id=CONSTRAIN_EOS, decode_window=K,
                           constraints=dfas)
        served = ServedRows(srv) if K == 1 else served
        rids = [srv.submit(p, s, sampling=SamplingParams(constraint=n))
                for n, p, s in reqs]
        if K == 1:
            rows = [served.of(r) for r in rids]
        torch.cuda.synchronize()
        zero_launches()
        done = srv.run()
        host, launches[K] = read_launches()["flash_decode"], card_runs()
        # K=1 runs every kernel eagerly; a window's graph runs its
        # kernels at the capture's warm-up and each replay.
        want = ((srv.graph_replays + srv.graph_captures) * K * L if K > 1
                else host)
        check(launches[K] > 0 and launches[K] == want,
              f"constrained K={K}: the card ran {launches[K]} flash_decode "
              f"kernels, expected {want} ({srv.graph_replays} replays, "
              f"{srv.graph_captures} captures, host count {host})")
        check(not srv.errors, f"constrained K={K}: errors {srv.errors}")
        runs.append([done[r] for r in rids])
    texts = []
    for (name, prompt, _), a, b in zip(reqs, *runs):
        check(torch.equal(a, b),
              f"constrained {name}: decode_window=8 differs from 1")
        text = "".join(vocab[t] for t in a[0, prompt.shape[1]:].tolist())
        texts.append(text)
        check(re.fullmatch(pattern[name], text) is not None,
              f"constrained {name}: {text!r} does not match its grammar")
        if name == "obj":
            check(json.loads(text) in ({"ok": True}, {"ok": False}),
                  f"constrained obj: {text!r}")
    err, gap = _constrained_bound("family: constrained", dec, params, dfas,
                                  reqs, runs[0], rows)
    log(f"family: constrained, {len(vocab)}-string synthetic vocabulary, "
        f"digits ({dfas['digits'].num_states} states) and schema "
        f"({dfas['obj'].num_states} states) compiled in {compile_s:.3f}s; "
        f"{len(reqs)} requests at decode_window 1 and 8 token-identical, "
        f"outputs {texts}; each token the admissible argmax of the row the "
        f"server picked it from, rows within {err:.4g} of the f32 "
        f"reference (bound {SERVED_LOGIT_BOUND}); f32 gap below the best "
        f"admissible max {gap:.4g}; flash_decode kernels run "
        f"on the card {launches[1]} (K=1, the wrapper's count), "
        f"{launches[8]} (K=8, (replays + capture warm-ups) x 8 x {L})")
    return {"launches": launches[1] + launches[8]}


def lora_bank(dec, params) -> tuple:
    """LORA_ADAPTERS random rank-LORA_RANK adapters on LORA_TARGETS from a
    seeded generator: (the adapters' config, their trees, params with
    the stacked bank; id 0 the base)."""
    import dataclasses

    import torch

    from defer_tpu_torch.parallel.lora import stack_adapters
    from defer_tpu_torch.parallel.transformer_stack import lora_target_dims

    cfg = dataclasses.replace(dec.cfg, lora_rank=LORA_RANK,
                              lora_targets=LORA_TARGETS,
                              lora_alpha=float(LORA_RANK))
    dims = lora_target_dims(cfg)
    gen = torch.Generator(device="cuda").manual_seed(7)
    trees = []
    for _ in range(LORA_ADAPTERS):
        st = {}
        for t in LORA_TARGETS:
            din, dout = dims[t]
            L = cfg.num_layers
            st[f"{t}:a"] = (torch.randn(L, din, LORA_RANK, generator=gen,
                                        device="cuda") * din**-0.5
                            ).to(dec.compute_dtype)
            st[f"{t}:b"] = (torch.randn(L, LORA_RANK, dout, generator=gen,
                                        device="cuda") * LORA_B_SCALE
                            ).to(dec.compute_dtype)
        trees.append({"stack": st})
    return cfg, trees, stack_adapters(params, trees, cfg)


def lora_bound(label: str, dec, params, cfg, trees, reqs, ids, outs,
               rows) -> None:
    """Every adapter's tokens held by the split greedy check (served_bound,
    on the rows the banked server picked them from) against the f32
    forward of its adapter's merge_lora params (one merged copy at a
    time)."""
    import torch

    from defer_tpu_torch.parallel.lora import combine_lora, merge_lora

    for a in range(LORA_ADAPTERS + 1):
        merged = params if a == 0 else merge_lora(
            combine_lora(params, trees[a - 1]), cfg)
        mine = [i for i, x in enumerate(ids) if x == a]
        served_bound(f"{label} adapter {a}", dec, merged,
                     [reqs[i] for i in mine], [outs[i] for i in mine],
                     [rows[i] for i in mine])
        del merged
        torch.cuda.empty_cache()


def family_lora(dec, params) -> dict:
    """A bank of LORA_ADAPTERS random rank-LORA_RANK adapters on wq/wv;
    the 12-request mix spread over adapter ids 0-3 through one
    DecodeServer; every token held by the split greedy check against
    its adapter's merge_lora params (lora_bound)."""
    import torch

    from defer_tpu_torch import DecodeServer

    cfg, trees, banked = lora_bank(dec, params)
    reqs = decode_requests(dec.cfg.vocab_size)
    ids = [i % (LORA_ADAPTERS + 1) for i in range(len(reqs))]
    srv = DecodeServer(dec, banked, max_batch=DECODE_SLOTS)
    served = ServedRows(srv)
    rids = [srv.submit(p, s, adapter_id=a) for (p, s), a in zip(reqs, ids)]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = eager_decode_launches("lora")
    check(launches["flash_decode"] >= dec.cfg.num_layers * srv.ticks,
          f"lora: flash_decode launched {launches['flash_decode']} times")
    log(f"family: multi-LoRA, {LORA_ADAPTERS} rank-{LORA_RANK} adapters on "
        f"{'/'.join(LORA_TARGETS)} (bank {tuple(banked['stack']['wq:a'].shape)}"
        f"), {len(reqs)} requests over adapter ids 0-{LORA_ADAPTERS} in "
        f"{srv.ticks} ticks, {wall:.3f}s; flash_decode launches "
        f"{launches['flash_decode']}")
    del banked
    lora_bound("family: lora", dec, params, cfg, trees, reqs, ids,
               [done[r] for r in rids], [served.of(r) for r in rids])
    return {"launches": launches["flash_decode"]}


class _WrongReorder:
    """A decoder whose steps see each cache lane's neighbour beam (lanes
    rolled by one along the batch axis): the beam reorder gone wrong, as
    a negative control for family_beam's score check. Everything else is
    the wrapped decoder's."""

    def __init__(self, dec):
        self._dec = dec

    def __getattr__(self, name):
        return getattr(self._dec, name)

    def make_step(self):
        step = self._dec.make_step()

        def wrong(params, cache, feed):
            cache = dict(cache, k=cache["k"].roll(1, 1),
                         v=cache["v"].roll(1, 1))
            return step(params, cache, feed)

        return wrong


def family_beam(dec, params) -> dict:
    """beam_search at beam BEAM over BEAM_STEPS steps: the best beam's
    summed log-prob at least the greedy sequence's less BEAM_SCORE_TOL,
    and every beam's score within BEAM_SCORE_TOL of reference_logits;
    the same search through _WrongReorder must miss that tolerance."""
    import torch

    from defer_tpu_torch.models.beam import beam_search

    prompt = decode_requests(dec.cfg.vocab_size)[1][0]
    t_in = prompt.shape[1]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    beams, scores = beam_search(dec, params, prompt, BEAM_STEPS,
                                beam_size=BEAM)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = eager_decode_launches("beam")
    check(launches["flash_decode"] > 0, "beam: no flash_decode launch")

    def summed(seq):
        logp = torch.log_softmax(
            dec.reference_logits(params, seq[:, :-1]).float(), -1)[0]
        toks = seq[0, t_in:].long()
        return float(logp[t_in - 1:].gather(-1, toks[:, None]).sum())

    def score_err(seqs, got):
        return max(abs(summed(seqs[i:i + 1]) - float(got[i]))
                   for i in range(BEAM))

    ref = [summed(beams[i:i + 1]) for i in range(BEAM)]
    err = score_err(beams, scores)
    greedy = summed(dec.generate(params, prompt, BEAM_STEPS))
    check(err <= BEAM_SCORE_TOL,
          f"beam: a score is {err:.4g} off reference_logits")
    check(float(scores[0]) >= greedy - BEAM_SCORE_TOL,
          f"beam: best {float(scores[0]):.4f} below greedy {greedy:.4f}")
    wrong = score_err(*beam_search(_WrongReorder(dec), params, prompt,
                                   BEAM_STEPS, beam_size=BEAM))
    check(wrong > BEAM_SCORE_TOL,
          f"beam: a wrong reorder's scores are within {wrong:.4g} of "
          f"reference_logits, inside the tolerance {BEAM_SCORE_TOL}")
    log(f"family: beam_search(beam={BEAM}, {BEAM_STEPS} steps) in "
        f"{wall:.3f}s: scores {[round(float(s), 4) for s in scores]}, "
        f"reference {[round(r, 4) for r in ref]} (max diff {err:.4g}, "
        f"tolerance {BEAM_SCORE_TOL}); a wrong reorder (lanes rolled by "
        f"one beam) reads {wrong:.4g} off; greedy's summed log-prob "
        f"{greedy:.4f}; flash_decode launches {launches['flash_decode']}")
    return {"launches": launches["flash_decode"]}


def phase_family(dec, params, k1: dict) -> dict:
    """Phase family: windows, rolling, speculative, constrained, LoRA and
    beam on phase 4's decoder and weights; each sub-path zeroes the
    kernel counts before it runs and reads them after."""
    t0 = time.perf_counter()
    reqs = decode_requests(dec.cfg.vocab_size)
    res = family_windows(dec, params, reqs, k1)
    res["rolling"] = family_rolling(dec, params)
    res["speculative"] = family_speculative(dec, params)
    res["constrained"] = family_constrained(dec, params)
    res["lora"] = family_lora(dec, params)
    res["beam"] = family_beam(dec, params)
    log(f"family: phase done in {time.perf_counter() - t0:.1f}s")
    return res


# -- phase 5 ---------------------------------------------------------------

def paged_requests(vocab: int) -> list:
    """The 12-request mix of phase 4, each prompt behind one shared
    SYSTEM_LEN-token system prompt (prompts of 80-175 tokens)."""
    import torch

    system = torch.randint(0, vocab, (1, SYSTEM_LEN),
                           generator=torch.Generator().manual_seed(2))
    return [(torch.cat([system, p], dim=1), s)
            for p, s in decode_requests(vocab)]


def paged_tick(srv, vocab: int, depth: int, steps: int = 64):
    """One steady paged tick through the server's public entry points:
    seat one request a slot, each a `depth`-token prompt from a seeded
    generator with a budget of `steps` tokens, by one `step()` (the
    admission prefills and the first tick), then return `srv.step` as
    the closure for `time_tick`. With nothing left to admit, a step is
    one tick (the step through the paged kernels, the argmax, the
    device position advance and the host bookkeeping); each advances
    every slot one row, so the timed ticks run at depths from `depth`
    up. `steps` outlasts time_tick's 19 ticks."""
    import torch

    gen = torch.Generator().manual_seed(3)
    for _ in range(srv.B):
        srv.submit(torch.randint(0, vocab, (1, depth), generator=gen), steps)
    srv.step()
    check(not srv.pending and all(s is not None for s in srv.slots),
          "the steady tick's requests did not all get a slot")
    return srv.step


def serve_mix(phase: str, dec, params, kv_dtype: str, weight_bytes: int,
              int8: bool = False) -> dict:
    """Phases 5 and 6: the 12 requests behind the shared system prompt
    through PagedDecodeServer(attention="pallas", prefix_cache=True,
    prefill_chunk=64) on a `kv_dtype` pool, checked, then one steady
    tick's split. Returns the run's launches and ticks, and the server
    with its steady-tick closure (the requests it seated for the split
    still hold budget for more ticks)."""
    import torch

    from defer_tpu_torch import PagedDecodeServer
    from defer_tpu_torch.obs import counter_deltas

    cfg = dec.cfg
    srv = PagedDecodeServer(
        dec, params, num_blocks=PAGED_BLOCKS, block_size=PAGED_BS,
        max_batch=DECODE_SLOTS, attention="pallas", prefix_cache=True,
        prefill_chunk=PAGED_CHUNK, kv_dtype=kv_dtype,
    )
    dh = cfg.dim // cfg.num_heads
    flat_bytes = (2 * cfg.num_layers * DECODE_SLOTS * cfg.kv_heads
                  * cfg.max_len * dh * 2)
    elems = cfg.num_layers * PAGED_BLOCKS * cfg.kv_heads * PAGED_BS * dh
    scales = cfg.num_layers * PAGED_BLOCKS * cfg.kv_heads
    log(f"{phase}: PagedDecodeServer(num_blocks={PAGED_BLOCKS}, block_size="
        f"{PAGED_BS}, max_batch={DECODE_SLOTS}, attention='pallas', "
        f"prefix_cache=True, prefill_chunk={PAGED_CHUNK}, kv_dtype="
        f"'{kv_dtype}'): pool {srv.pool_bytes} B (a flat {DECODE_SLOTS}-slot "
        f"bf16 cache: {flat_bytes} B)")
    if int8:
        check(srv.pool_bytes == 2 * elems + 2 * scales * 4,
              f"int8 pool of {srv.pool_bytes} B is not {2 * elems} B of "
              f"payload plus {2 * scales * 4} B of f32 scales")
    else:
        check(srv.pool_bytes == flat_bytes * PAGED_BLOCKS // (PAGED_BLOCKS
                                                              - 1),
              f"pool of {srv.pool_bytes} B is not the flat cache plus trash")
    dec_key = "paged_flash_decode_int8" if int8 else "paged_flash_decode"
    pre_key = "paged_flash_prefill_int8" if int8 else "paged_flash_prefill"
    other = ("paged_flash_decode", "paged_flash_prefill") if int8 else (
        "paged_flash_decode_int8", "paged_flash_prefill_int8")
    reqs = paged_requests(cfg.vocab_size)
    rids = [srv.submit(p, s) for p, s in reqs]
    torch.cuda.synchronize()
    zero_launches()
    with counter_deltas() as d:
        t0 = time.perf_counter()
        # srv.run(), one round at a time: after each, trash block 0 is
        # neither on the free list nor in a live slot's table up to its
        # position (host checks; they sync nothing).
        while srv.step():
            check(0 not in srv.free, "trash block 0 is on the free list")
            for i, slot in enumerate(srv.slots):
                if slot is not None:
                    row = srv.tables[i, : srv.pos[i] // srv.bs + 1]
                    check(bool((row != 0).all()),
                          f"slot {i}'s table holds trash block 0 at a live "
                          "column")
        done = srv.done
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    generated = sum(s for _, s in reqs)
    hits = d.get('defer_prefix_cache_hits_total{server="paged"}', 0)
    check(len(done) == len(reqs), f"{len(done)} of {len(reqs)} served")
    n_req = len(reqs) - 1
    check(hits == n_req * SYSTEM_LEN // PAGED_BS,
          f"{hits} radix block hits, expected {n_req} x "
          f"{SYSTEM_LEN // PAGED_BS}")
    check(srv.prefill_tokens_saved == n_req * SYSTEM_LEN,
          f"prefill_tokens_saved {srv.prefill_tokens_saved}, expected "
          f"{n_req * SYSTEM_LEN}")
    check(launches[dec_key] >= cfg.num_layers * srv.ticks,
          f"{dec_key} launched {launches[dec_key]} "
          f"times, expected >= {cfg.num_layers} x {srv.ticks} ticks")
    check(launches[pre_key] >= cfg.num_layers * srv.prefill_chunks,
          f"{pre_key} launched {launches[pre_key]} "
          f"times, expected >= {cfg.num_layers} x {srv.prefill_chunks} "
          "chunks")
    check(all(launches[k] == 0 for k in other),
          f"the {kv_dtype} pool's run launched the other pool's kernels: "
          f"{ {k: launches[k] for k in other} }")
    check(0 not in srv.free and srv.blocks_in_use == 0,
          "the pool did not drain back to the free list and the cache")
    log(f"{phase}: {len(reqs)} requests served (prompts of "
        f"{min(p.shape[1] for p, _ in reqs)}-"
        f"{max(p.shape[1] for p, _ in reqs)} tokens), {generated} tokens "
        f"in {srv.ticks} ticks ({generated / srv.ticks:.2f} tokens a tick) "
        f"and {srv.prefill_chunks} prefill chunks, {wall:.3f}s, "
        f"{generated / wall:.1f} tokens/s incl. admission prefills; peak "
        f"{srv.blocks_peak} blocks in use")
    log(f"{phase}: {hits} radix block hits, {srv.prefill_tokens_saved} "
        f"prefill tokens saved; launches {dec_key} "
        f"{launches[dec_key]} (>= {cfg.num_layers} x "
        f"{srv.ticks} ticks), {pre_key} "
        f"{launches[pre_key]} (>= {cfg.num_layers} x "
        f"{srv.prefill_chunks} chunks)")
    if int8:
        greedy_gaps(phase, dec, params, reqs, [done[r] for r in rids],
                    share=INT8_LOGIT_SHARE)
    else:
        outs = [done[r] for r in rids]
        rows = recorded_rows(phase, PagedDecodeServer(
            dec, params, num_blocks=PAGED_BLOCKS, block_size=PAGED_BS,
            max_batch=DECODE_SLOTS, attention="pallas", prefix_cache=True,
            prefill_chunk=PAGED_CHUNK), reqs, outs)
        served_bound(phase, dec, params, reqs, outs, rows)
        del rows
        torch.cuda.empty_cache()

    depth = 150
    ticks = srv.ticks
    tick = paged_tick(srv, cfg.vocab_size, depth)
    lo = int(srv.pos.min())
    split = time_tick(tick)
    log_split(phase, split, f"{lo}-{int(srv.pos.max()) - 1}",
              weight_bytes)
    return {"launches": launches, "ticks": ticks, "srv": srv, "tick": tick,
            "split": split, "outs": [done[r] for r in rids],
            "tokens_per_s": generated / wall}


def phase_paged(dec, params, weight_bytes: int) -> dict:
    return serve_mix("paged", dec, params, "fp", weight_bytes)


def phase_int8(dec, params, weight_bytes: int, fp_res: dict) -> dict:
    """Phase 6, first part: the mix on an int8 pool, then the int8 and
    float steady ticks in turns (phase 5 timed the float one first; here
    int8, int8, float), each server at the depths its seated requests
    have reached."""
    res = serve_mix("int8", dec, params, "int8", weight_bytes, int8=True)
    for label, run in (("int8", res), ("paged", fp_res)):
        srv = run.pop("srv")
        lo = int(srv.pos.min())
        split = time_tick(run.pop("tick"))
        log_split(f"int8 turns: {label}", split,
                  f"{lo}-{int(srv.pos.max()) - 1}", weight_bytes)
    return res


def spill_requests(vocab: int) -> list:
    """The spill scenario's prompts, from a seeded generator: request A
    (the shared system prompt and 16 tokens of its own), three fillers
    of 96 tokens, request B (the system prompt and 16 other tokens);
    8 steps each."""
    import torch

    gen = torch.Generator().manual_seed(4)
    system = torch.randint(0, vocab, (1, SYSTEM_LEN),
                           generator=torch.Generator().manual_seed(2))

    def own(n):
        return torch.randint(0, vocab, (1, n), generator=gen)

    a = torch.cat([system, own(16)], dim=1)
    fillers = [own(96) for _ in range(3)]
    b = torch.cat([system, own(16)], dim=1)
    return [(a, 8)] + [(f, 8) for f in fillers] + [(b, 8)]


def phase_spill(dec, params) -> dict:
    """Phase 6, second part: the host spill tier on an int8 pool at
    max_batch=1. Request A, then three fillers that make the radix
    cache evict A's parked blocks from a pool of SPILL_BLOCKS (they
    drain to host memory), then request B with A's system prompt, whose
    four system blocks come back from the spill store. The same
    requests through a pool large enough that nothing is evicted: B's
    tokens must be identical."""
    import torch

    from defer_tpu_torch import PagedDecodeServer
    from defer_tpu_torch.obs import counter_deltas

    reqs = spill_requests(dec.cfg.vocab_size)
    runs = {}
    for label, num_blocks, spill in (("spill", SPILL_BLOCKS, SPILL_BYTES),
                                     ("resident", PAGED_BLOCKS, 0)):
        srv = PagedDecodeServer(
            dec, params, num_blocks=num_blocks, block_size=PAGED_BS,
            max_batch=1, attention="pallas", prefix_cache=True,
            prefill_chunk=PAGED_CHUNK, kv_dtype="int8", spill_bytes=spill,
        )
        zero_launches()
        with counter_deltas() as d:
            t0 = time.perf_counter()
            rids = []
            for prompt, steps in reqs[:-1]:
                rids.append(srv.submit(prompt, steps))
                srv.run()
            srv.flush_spill()
            rids.append(srv.submit(*reqs[-1]))
            done = srv.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_launches()
        spilled = d.get('defer_prefix_spilled_total{server="paged"}', 0)
        evicted = d.get('defer_prefix_cache_evictions_total{server="paged"}',
                        0)
        check(launches["paged_flash_decode_int8"] > 0
              and launches["paged_flash_prefill_int8"] > 0,
              f"spill {label} run did not launch the int8 kernels")
        log(f"spill: {label} run, PagedDecodeServer(num_blocks={num_blocks}, "
            f"max_batch=1, kv_dtype='int8', spill_bytes={spill}): "
            f"{len(reqs)} requests in {wall:.3f}s; {evicted} blocks evicted, "
            f"{spilled} spilled to host memory, {srv.spill_hits_n} revived "
            f"from it; B's prefill tokens saved "
            f"{srv.prefill_tokens_saved}")
        runs[label] = (done[rids[-1]], srv, spilled)
    out_s, srv_s, spilled = runs["spill"]
    out_r, srv_r, _ = runs["resident"]
    n_sys = SYSTEM_LEN // PAGED_BS
    check(spilled >= n_sys, f"{spilled} blocks spilled, expected >= {n_sys}")
    check(srv_s.spill_hits_n == n_sys,
          f"{srv_s.spill_hits_n} spill hits, expected {n_sys}")
    check(srv_r.spill_hits_n == 0, "the resident run revived a block")
    check(torch.equal(out_s, out_r),
          "B's tokens after a spill revival differ from a resident hit's")
    log(f"spill: B revived {srv_s.spill_hits_n} system blocks from host "
        f"memory; its {reqs[-1][1]} tokens equal the resident run's")
    return {"spill_hits": srv_s.spill_hits_n, "spilled": spilled}


# -- phase paged_family: the rest of the paged server ----------------------

# Paged decode windows (K sub-steps a captured CUDA graph) by pool; the
# mixed ticks' prompt tokens a tick and concurrent prefill seats; the
# speculative server's proposals a round (SPEC_K) and its window; the
# steady window's seated depth and budget (its rows never freeze: the
# timed replays run 19 windows past the depth); the disagg worker's time
# limits.
PAGED_WINDOWS = ((4, "fp"), (8, "fp"), (4, "int8"))
MIXED_BUDGET, MIXED_LOOKAHEAD = 64, 2
SPEC_WINDOW = 4
STEADY_DEPTH, STEADY_BUDGET = 150, 400
PREFILL_WORKER_TIMEOUT_S = 300


def paged_server(dec, params, **knobs):
    """Phase 5's server (the pallas kernels, the radix cache, chunked
    prefill) with `knobs` on top."""
    from defer_tpu_torch import PagedDecodeServer

    base = dict(num_blocks=PAGED_BLOCKS, block_size=PAGED_BS,
                max_batch=DECODE_SLOTS, attention="pallas",
                prefix_cache=True, prefill_chunk=PAGED_CHUNK)
    return PagedDecodeServer(dec, params, **{**base, **knobs})


def serve_counted(label: str, srv, reqs, **submit) -> tuple:
    """Serve `reqs` through `srv` with every count zeroed just before and
    read just after: (outputs, wall s, host launches, card runs)."""
    import torch

    rids = [srv.submit(p, s, **submit) for p, s in reqs]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(done) == len(reqs), f"{label}: {len(done)} of {len(reqs)} "
          "served")
    return [done[r] for r in rids], wall, read_launches(), read_card_runs()


def steady_window(srv, vocab: int):
    """Seat every slot at STEADY_DEPTH with a far budget, run the first
    window (its capture), and return the replay closure `_tick_window`
    issues (the budget upload as a fill, the replay), without the
    drain."""
    import torch

    gen = torch.Generator().manual_seed(3)
    for _ in range(srv.B):
        srv.submit(torch.randint(0, vocab, (1, STEADY_DEPTH), generator=gen),
                   STEADY_BUDGET)
    srv.step()
    check(all(s is not None for s in srv.slots),
          "the steady window's requests did not all get a slot")
    kind = "spec" if srv.spec_k else "decode"
    program = srv._window_program(kind, "argmax", False)
    w = srv._wbuf

    def tick():
        w["budget"].fill_(1 << 20)
        program()

    return tick


def paged_windows(dec, params, reqs, outs, tps) -> dict:
    """The mix through decode_window 4 and 8 on a bf16 pool and 4 on an
    int8 pool: token-identical to phases 5 and 6; paged_flash_decode run
    on the card (replays + capture warm-ups) x K x layers times (the
    wrapper's host count: 2 x K x layers a capture, its warm-up and the
    capture itself); the prefill kernel's runs equal to its eager
    launches; then one steady window's split and its kernel runs."""
    L = dec.cfg.num_layers
    res = {}
    for K, pool in PAGED_WINDOWS:
        label = f"paged_family: window K={K} {pool}"
        int8 = pool == "int8"
        dkey = "paged_flash_decode_int8" if int8 else "paged_flash_decode"
        pkey = "paged_flash_prefill_int8" if int8 else "paged_flash_prefill"
        srv = paged_server(dec, params, decode_window=K, kv_dtype=pool)
        got, wall, host, card = serve_counted(label, srv, reqs)
        for i, (a, b) in enumerate(zip(got, outs[pool])):
            check(a.equal(b), f"{label}: request {i} differs from phase "
                  f"{'6' if int8 else '5'}'s decode_window=1 output")
        replays, caps = srv.graph_replays, srv.graph_captures
        check(replays > 0 and caps == 1, f"{label}: {replays} replays, "
              f"{caps} captures")
        check(host[dkey] == 2 * K * L * caps,
              f"{label}: {dkey} host count {host[dkey]}, expected 2 x {K} "
              f"x {L} x {caps}")
        want = (replays + caps) * K * L
        check(card["paged_flash_decode"] == want,
              f"{label}: the card ran {card['paged_flash_decode']} "
              f"paged_flash_decode kernels, expected ({replays} replays + "
              f"{caps} warm-up) x {K} x {L}")
        check(card["paged_flash_prefill"] == host[pkey] > 0,
              f"{label}: the card ran {card['paged_flash_prefill']} prefill "
              f"kernels, the wrapper launched {host[pkey]}")
        generated = sum(s for _, s in reqs)
        del srv
        tsrv = paged_server(dec, params, decode_window=K, kv_dtype=pool)
        tick = steady_window(tsrv, dec.cfg.vocab_size)
        split = time_tick(tick)
        zero_launches()
        tick()
        one = read_card_runs()["paged_flash_decode"]
        check(one == K * L, f"{label}: one replay ran {one} paged decode "
              f"kernels, expected {K} x {L}")
        log(f"{label}: {len(reqs)} requests token-identical to decode_window"
            f"=1; {generated} tokens in {wall:.3f}s, {generated / wall:.1f} "
            f"tokens/s incl. admission prefills (decode_window=1: "
            f"{tps[pool]:.1f}); graph_replays {replays}; paged_flash_decode "
            f"kernels run on the card {card['paged_flash_decode']} = "
            f"({replays} + {caps} warm-up) x {K} x {L} (host launches "
            f"{host[dkey]}); paged_flash_prefill {card['paged_flash_prefill']}"
            f" (= its eager launches)")
        log(f"{label}, one steady window of {DECODE_SLOTS} slots from depth "
            f"{STEADY_DEPTH}: host {split['host_ms']:.4f} ms to issue (idle "
            f"card), wall {split['wall_ms']:.4f} ms, device "
            f"{split['device_ms']:.4f} ms of kernels ({split['launches']:.1f}"
            f" launches by profiler, the card's paged_flash_decode count "
            f"{one}; " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                   split["family_ms"].items())
            + f"); idle share {split['idle_share']:.4f}; a token "
            f"{split['wall_ms'] / K:.4f} ms")
        res[f"window{K}_{pool}"] = {
            "decode_runs": card["paged_flash_decode"],
            "prefill_runs": card["paged_flash_prefill"], "split": split,
            "tokens_per_s": generated / wall, "graph_replays": replays}
        del tsrv
    return res


def paged_mixed(dec, params, reqs) -> dict:
    """prefill_budget=MIXED_BUDGET, prefill_lookahead=MIXED_LOOKAHEAD on
    a bf16 pool: every token held by the split greedy check (the rows
    the mixed and plain ticks picked it from); the mixed ticks, the
    stall fraction and each kernel's runs (all eager: each equals its
    wrapper's launches)."""
    label = "paged_family: mixed"
    srv = paged_server(dec, params, prefill_budget=MIXED_BUDGET,
                       prefill_lookahead=MIXED_LOOKAHEAD)
    served = ServedRows(srv)
    got, wall, host, card = serve_counted(label, srv, reqs)
    # A fresh server numbers its requests 0, 1, ... in submission order.
    rows = [served.of(r, p.shape[1], n) for r, (p, n) in enumerate(reqs)]
    for name in ("paged_flash_decode", "paged_flash_prefill"):
        check(card[name] == host[name] > 0,
              f"{label}: the card ran {card[name]} {name} kernels, the "
              f"wrapper launched {host[name]}")
    check(srv.mixed_ticks_n > 0 and srv.prefill_stall_ticks_n == 0,
          f"{label}: {srv.mixed_ticks_n} mixed ticks, "
          f"{srv.prefill_stall_ticks_n} stall ticks")
    generated = sum(s for _, s in reqs)
    log(f"{label}: prefill_budget={MIXED_BUDGET}, prefill_lookahead="
        f"{MIXED_LOOKAHEAD}: {len(reqs)} requests, {generated} tokens in "
        f"{wall:.3f}s, {generated / wall:.1f} tokens/s; {srv.ticks} "
        f"dispatches of which {srv.mixed_ticks_n} mixed, carrying "
        f"{srv.mixed_prefill_tokens_n} prompt tokens; stall ticks "
        f"{srv.prefill_stall_ticks_n}, decode stall fraction "
        f"{srv.decode_stall_fraction_last:.4f}; kernels run on the card: "
        f"paged_flash_prefill {card['paged_flash_prefill']}, "
        f"paged_flash_decode {card['paged_flash_decode']}")
    served_bound(label, dec, params, reqs, got, rows)
    return {"decode_runs": card["paged_flash_decode"],
            "prefill_runs": card["paged_flash_prefill"],
            "mixed_ticks": srv.mixed_ticks_n, "tokens_per_s": generated / wall}


def paged_speculative(dec, params, reqs) -> dict:
    """spec_k=SPEC_K with make_draft(layers=SPEC_LAYERS), at K=1 and in a
    window of SPEC_WINDOW rounds: every token held by the split greedy
    check at K=1 (the verify rows it was picked from), and the window's
    outputs token-identical to K=1's (its verify rows stay inside its
    graph); the acceptance and rounds; the verify's paged_flash_prefill runs (each
    round's one a layer, replays included) and the draft's flash_decode
    runs."""
    from defer_tpu_torch.models.transplant import make_draft

    draft, dparams = make_draft(dec, params, layers=SPEC_LAYERS)
    L = dec.cfg.num_layers
    res, k1 = {}, None
    for K in (1, SPEC_WINDOW):
        label = f"paged_family: speculative K={K}"
        srv = paged_server(dec, params, spec_k=SPEC_K, spec_draft=draft,
                           spec_params=dparams, decode_window=K)
        served = ServedRows(srv) if K == 1 else None
        got, wall, host, card = serve_counted(label, srv, reqs)
        replays, caps = srv.graph_replays, srv.graph_captures
        # The verify and the admission chunks launch the prefill kernel
        # eagerly; a window's graph runs its verify at the capture's
        # warm-up and each replay (the wrapper counts the warm-up and the
        # capture).
        eager = host["paged_flash_prefill"] - 2 * K * L * caps
        want = eager + (replays + caps) * K * L if K > 1 else eager
        check(card["paged_flash_prefill"] == want and want > 0,
              f"{label}: the card ran {card['paged_flash_prefill']} prefill "
              f"kernels, expected {want}")
        check(srv.spec_rounds_n > 0 and card["flash_decode"] > 0,
              f"{label}: {srv.spec_rounds_n} rounds, the draft ran "
              f"{card['flash_decode']} flash_decode kernels")
        check(card["paged_flash_decode"] == 0,
              f"{label}: a speculative server ran paged_flash_decode")
        generated = sum(s for _, s in reqs)
        acc = srv.spec_accepted_n / max(srv.spec_proposed_n, 1)
        log(f"{label}, spec_k={SPEC_K}, make_draft(layers={SPEC_LAYERS}): "
            f"{generated} tokens in {wall:.3f}s, {generated / wall:.1f} "
            f"tokens/s; {srv.spec_rounds_n} rounds in {srv.dispatches} "
            f"dispatches ({replays} graph replays), acceptance {acc:.4f} "
            f"({srv.spec_accepted_n} of {srv.spec_proposed_n}); kernels run "
            f"on the card: paged_flash_prefill {card['paged_flash_prefill']}"
            f" (verify and admission), the draft's flash_decode "
            f"{card['flash_decode']}")
        if served is not None:
            served_bound(label, dec, params, reqs, got,
                         [served.of(r, p.shape[1], n)  # rids 0, 1, ...
                          for r, (p, n) in enumerate(reqs)])
            k1 = got
        else:
            check(all(a.equal(b) for a, b in zip(got, k1)),
                  f"{label}: the window's outputs differ from K=1's")
            log(f"{label}: {len(got)} requests token-identical to K=1 "
                "(which took the split check)")
        res[f"spec{K}"] = {"prefill_runs": card["paged_flash_prefill"],
                           "flash_decode_runs": card["flash_decode"],
                           "acceptance": acc, "rounds": srv.spec_rounds_n,
                           "tokens_per_s": generated / wall}
        del srv
    return res


def paged_constrained(dec, params, reqs) -> dict:
    """Phase family's digits regex and JSON schema over its synthetic
    vocabulary, two requests each through the paged server at
    decode_window 1 and 8: outputs in grammar, identical at both K,
    every token the greedy admissible choice; the decode kernel's runs
    (K=8: (replays + warm-up) x 8 x layers)."""
    import json
    import re

    from defer_tpu_torch import SamplingParams
    from defer_tpu_torch.constrain import compile_json_schema, compile_regex

    vocab = synthetic_vocab(dec.cfg.vocab_size)
    dfas = {"digits": compile_regex("[0-9]+", vocab),
            "obj": compile_json_schema(CONSTRAIN_SCHEMA, vocab)}
    pattern = {"digits": "[0-9]+", "obj": dfas["obj"].pattern}
    names = ["digits", "obj", "digits", "obj"]
    creqs = [(n, p, CONSTRAIN_STEPS) for n, (p, _) in zip(names, reqs)]
    L = dec.cfg.num_layers
    runs, runs_card, served = [], {}, None
    for K in (1, 8):
        label = f"paged_family: constrained K={K}"
        srv = paged_server(dec, params, eos_id=CONSTRAIN_EOS, decode_window=K,
                           constraints=dfas)
        served = ServedRows(srv) if K == 1 else served
        rids = [srv.submit(p, s, sampling=SamplingParams(constraint=n))
                for n, p, s in creqs]
        zero_launches()
        done = srv.run()
        host, card = read_launches(), read_card_runs()
        want = ((srv.graph_replays + srv.graph_captures) * K * L if K > 1
                else host["paged_flash_decode"])
        check(card["paged_flash_decode"] == want > 0,
              f"{label}: the card ran {card['paged_flash_decode']} paged "
              f"decode kernels, expected {want}")
        check(not srv.errors, f"{label}: errors {srv.errors}")
        runs.append([done[r] for r in rids])
        runs_card[K] = card["paged_flash_decode"]
        if K == 1:
            rows = [served.of(r, p.shape[1], n)
                    for r, (_, p, n) in zip(rids, creqs)]
    texts = []
    for (name, prompt, _), a, b in zip(creqs, *runs):
        check(a.equal(b), f"paged_family: constrained {name}: "
              "decode_window=8 differs from 1")
        text = "".join(vocab[t] for t in a[0, prompt.shape[1]:].tolist())
        texts.append(text)
        check(re.fullmatch(pattern[name], text) is not None,
              f"paged_family: constrained {name}: {text!r} off its grammar")
        if name == "obj":
            check(json.loads(text) in ({"ok": True}, {"ok": False}),
                  f"paged_family: constrained obj: {text!r}")
    err, gap = _constrained_bound("paged_family: constrained", dec, params,
                                  dfas, creqs, runs[0], rows)
    log(f"paged_family: constrained, digits and schema over the "
        f"{len(vocab)}-string vocabulary: {len(creqs)} requests at "
        f"decode_window 1 and 8 token-identical, outputs {texts}; each "
        f"token the admissible argmax of the row the server picked it "
        f"from, rows within {err:.4g} of the f32 reference (bound "
        f"{SERVED_LOGIT_BOUND}); f32 gap below the best admissible max "
        f"{gap:.4g}; paged_flash_decode run on the card "
        f"{runs_card[1]} (K=1, its eager launches), {runs_card[8]} (K=8, "
        f"(replays + warm-up) x 8 x {L})")
    return {"decode_runs": runs_card[1] + runs_card[8]}


def paged_lora(dec, params, reqs) -> dict:
    """Phase family's three rank-16 adapters on the paged server (the
    radix cache off: cached prefix K/V would be adapter-dependent), the
    mix over adapter ids 0-3; every token held by the split greedy check
    against its adapter's merged weights (lora_bound)."""
    cfg, trees, banked = lora_bank(dec, params)
    ids = [i % (LORA_ADAPTERS + 1) for i in range(len(reqs))]
    label = "paged_family: lora"
    srv = paged_server(dec, banked, prefix_cache=False)
    served = ServedRows(srv)
    rids = [srv.submit(p, s, adapter_id=a) for (p, s), a in zip(reqs, ids)]
    zero_launches()
    t0 = time.perf_counter()
    done = srv.run()
    wall = time.perf_counter() - t0
    host, card = read_launches(), read_card_runs()
    for name in ("paged_flash_decode", "paged_flash_prefill"):
        check(card[name] == host[name] > 0,
              f"{label}: the card ran {card[name]} {name} kernels, the "
              f"wrapper launched {host[name]}")
    log(f"{label}: {LORA_ADAPTERS} rank-{LORA_RANK} adapters, {len(reqs)} "
        f"requests over adapter ids 0-{LORA_ADAPTERS} in {srv.ticks} ticks, "
        f"{wall:.3f}s; kernels run on the card: paged_flash_decode "
        f"{card['paged_flash_decode']}, paged_flash_prefill "
        f"{card['paged_flash_prefill']}")
    rows = [served.of(r, p.shape[1], n) for r, (p, n) in zip(rids, reqs)]
    del srv, banked, served
    lora_bound(label, dec, params, cfg, trees, reqs, ids,
               [done[r] for r in rids], rows)
    return {"decode_runs": card["paged_flash_decode"],
            "prefill_runs": card["paged_flash_prefill"]}


class PrefillWorker(WorkerProcess):
    """`python -m defer_tpu_torch.disagg.prefill_worker` on the card."""

    def __init__(self, here: str):
        super().__init__(here, 0, command=[
            "defer_tpu_torch.disagg.prefill_worker", "--listen", "0",
            "--listen-host", "127.0.0.1", "--device", CARD,
            "--accept-timeout", str(PREFILL_WORKER_TIMEOUT_S),
            "--read-timeout", str(PREFILL_WORKER_TIMEOUT_S)])


# serve_disagg's model: the decoder's first DISAGG_LAYERS layers at full
# width (make_draft: views of phase 4's weights), so that a session's
# weight dispatch takes seconds, not the 56.762-59.745 s a session of
# the whole model's 14.5 GB on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md; speeding that dispatch up is open work in ROADMAP.md).
DISAGG_LAYERS = 4


def paged_disagg(dec, params, reqs, here: str) -> dict:
    """serve_disagg over loopback, the prefill worker first in a thread
    of this process, then `python -m defer_tpu_torch.disagg.
    prefill_worker` as a process with a time limit, on DISAGG_LAYERS of
    the decoder's layers: the weights cross once a session (raw frames),
    each request's KV comes back as pool blocks. Every token held by the
    split greedy check (the delivered first row, then the decode host's
    ticks; the f32 reference of the same layers); the KV bytes on the
    wire and the ms the decode host took to seat them."""
    from defer_tpu_torch import PagedDecodeServer
    from defer_tpu_torch.disagg import serve_disagg
    from defer_tpu_torch.models.transplant import make_draft

    dec, params = make_draft(dec, params, layers=DISAGG_LAYERS)

    res = {}
    geometry = dict(num_blocks=PAGED_BLOCKS, block_size=PAGED_BS,
                    max_batch=DECODE_SLOTS, attention="pallas",
                    prefix_cache=True)
    knobs = dict(geometry, compress=False,
                 accept_timeout_s=PREFILL_WORKER_TIMEOUT_S,
                 read_timeout_s=PREFILL_WORKER_TIMEOUT_S)
    for where in ("thread", "process"):
        label = (f"paged_family: disagg ({where} worker, {DISAGG_LAYERS} "
                 "layers)")
        worker = None
        spawn = None
        if where == "process":
            worker = PrefillWorker(here)
            spawn = lambda: ("127.0.0.1", worker.port)  # noqa: E731
        # The decode host's server, built here as serve_disagg would
        # build it, so that the rows it picks its tokens from are kept.
        srv = PagedDecodeServer(dec, params, **geometry)
        served = ServedRows(srv)
        try:
            zero_launches()
            t0 = time.perf_counter()
            got, stats = serve_disagg(dec, params, reqs, spawn_worker=spawn,
                                      server=srv, **knobs)
            wall = time.perf_counter() - t0
            host, card = read_launches(), read_card_runs()
            if worker is not None:
                done = worker._expect("DONE ")
                check(done == f"DONE {len(reqs)}",
                      f"{label}: the worker printed {done!r}")
                check(worker.proc.wait(timeout=60) == 0,
                      f"{label}: the worker exited {worker.proc.returncode}")
        finally:
            if worker is not None:
                worker.stop()
        check(card["paged_flash_decode"] == host["paged_flash_decode"] > 0,
              f"{label}: the decode host ran {card['paged_flash_decode']} "
              f"paged decode kernels, the wrapper launched "
              f"{host['paged_flash_decode']}")
        check(stats["kv_bytes_recv"] > 0 and stats["worker_restarts"] == 0,
              f"{label}: {stats['kv_bytes_recv']} KV bytes, "
              f"{stats['worker_restarts']} restarts")
        log(f"{label}: {len(reqs)} requests in {wall:.3f}s (the weights' "
            f"{stats['dispatch_bytes_sent']} B dispatch included); KV on the "
            f"wire {stats['kv_bytes_recv']} B ({stats['kv_bytes_recv_per_request']:.0f}"
            f" B a request); the decode host seated it in "
            f"{stats['ingest_ms']:.3f} ms of host time; {stats['ticks']} "
            f"ticks, paged_flash_decode run on the card "
            f"{card['paged_flash_decode']}")
        served_bound(label, dec, params, reqs, got,
                     [served.of(r, p.shape[1], n)  # rids 0, 1, ...
                      for r, (p, n) in enumerate(reqs)])
        del srv, served
        res[where] = {"kv_bytes": stats["kv_bytes_recv"],
                      "ingest_ms": stats["ingest_ms"], "wall_s": wall,
                      "decode_runs": card["paged_flash_decode"]}
    return res


def phase_paged_family(dec, params, paged_res: dict, int8_res: dict,
                       here: str) -> dict:
    """Phase paged_family, on phase 5's server setup: windows, mixed
    ticks, speculation, constraints, LoRA and disaggregated prefill; each
    path zeroes the kernel counts before it runs and reads them after."""
    t0 = time.perf_counter()
    reqs = paged_requests(dec.cfg.vocab_size)
    res = paged_windows(dec, params, reqs,
                        {"fp": paged_res["outs"], "int8": int8_res["outs"]},
                        {"fp": paged_res["tokens_per_s"],
                         "int8": int8_res["tokens_per_s"]})
    res["mixed"] = paged_mixed(dec, params, reqs)
    res.update(paged_speculative(dec, params, reqs))
    res["constrained"] = paged_constrained(dec, params, reqs)
    res["lora"] = paged_lora(dec, params, reqs)
    res["disagg"] = paged_disagg(dec, params, reqs, here)
    log(f"paged_family: phase done in {time.perf_counter() - t0:.1f}s")
    return res


# -- phase fleet: fleet serving over paged replicas ------------------------

# Two replicas of phase 5's server on the one card, sharing its weights:
# the request mix of scripts/bench_fleet.py's _workload at this width (3
# system prompts of SYSTEM_LEN tokens with Zipf weights 1/(s+1), private
# suffixes of 4-23 tokens, 4-15 greedy steps), submitted in paced bursts;
# the forced migration moves one system prompt's SYSTEM_LEN // PAGED_BS
# blocks; the flood repeats the mix FLEET_FLOOD times at once.
FLEET_REPLICAS, FLEET_REQUESTS, FLEET_SYSTEMS = 2, 24, 3
FLEET_BURST, FLEET_GAP_S, FLEET_WINDOW, FLEET_FLOOD = 4, 0.02, 4, 3
FLEET_TIMEOUT_S = 300
# The frontend's allocations beyond its replicas' pools (block tables,
# positions, sampler rows): a copy of the weights would be 14.5 GB.
FLEET_SLACK = 64 << 20


def fleet_requests(vocab: int) -> tuple:
    """(requests, each one's system prompt index), from a seeded
    torch.Generator."""
    import torch

    gen = torch.Generator().manual_seed(4)
    systems = [torch.randint(0, vocab, (1, SYSTEM_LEN), generator=gen)
               for _ in range(FLEET_SYSTEMS)]
    weights = [1.0 / (s + 1) for s in range(FLEET_SYSTEMS)]
    reqs, sys_of = [], []
    for _ in range(FLEET_REQUESTS):
        u = float(torch.rand((), generator=gen)) * sum(weights)
        s, acc = 0, weights[0]
        while acc < u and s < FLEET_SYSTEMS - 1:
            s += 1
            acc += weights[s]
        t_suf = 4 + int(torch.randint(0, 20, (), generator=gen))
        steps = 4 + int(torch.randint(0, 12, (), generator=gen))
        suffix = torch.randint(0, vocab, (1, t_suf), generator=gen)
        reqs.append((torch.cat([systems[s], suffix], dim=1), steps))
        sys_of.append(s)
    return reqs, sys_of


def _hist(reg, name: str) -> dict:
    snap = reg.value(name, server="paged")
    return snap if snap else {"count": 0, "buckets": []}


def _quantile_since(before: dict, after: dict, q: float):
    """The upper bucket edge of the q-quantile of the observations made
    between two snapshots of one histogram."""
    n = after["count"] - before["count"]
    if n <= 0:
        return None
    old = {e: c for e, c in before["buckets"]}
    for edge, cum in after["buckets"]:
        if cum - old.get(edge, 0) >= q * n:
            return edge
    return None


def fleet_drive(fe, reqs, *, burst: int, paced: bool) -> tuple:
    """Submit in bursts of `burst` (FLEET_GAP_S apart; `paced` waits for
    each burst's results first, so that routing sees the cache state the
    burst made). Returns ({index: output}, shed count)."""
    from defer_tpu_torch.fleet import ShedError

    outs, pending, shed = {}, {}, 0
    for i, (p, s) in enumerate(reqs):
        try:
            pending[i] = fe.submit(p, s)
        except ShedError:
            shed += 1
        if (i + 1) % burst == 0:
            if paced:
                outs.update({j: fe.result(g, timeout=FLEET_TIMEOUT_S)
                             for j, g in pending.items()})
                pending = {}
            time.sleep(FLEET_GAP_S)
    outs.update({j: fe.result(g, timeout=FLEET_TIMEOUT_S)
                 for j, g in pending.items()})
    return outs, shed


def fleet_eager_runs(label: str, host=None, card=None) -> dict:
    """On a fleet run that replays no graph: the paged kernels' runs on
    the card (every replica's, one counter a card) equal their wrappers'
    launches, summed over the replicas' threads (read now unless
    given)."""
    host = host if host is not None else read_launches()
    card = card if card is not None else read_card_runs()
    for name in ("paged_flash_decode", "paged_flash_prefill"):
        check(card[name] == host[name], f"{label}: the card ran "
              f"{card[name]} {name} kernels, the wrappers launched "
              f"{host[name]}")
    return card


def fleet_frontend(dec, params, **knobs):
    """FLEET_REPLICAS replicas of phase 5's server on cuda:0, built while
    the card's allocation is watched: it must grow by the replicas'
    pools and no more (the weights are shared, not copied)."""
    import gc

    import torch

    from defer_tpu_torch.fleet import FleetFrontend

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fe = FleetFrontend(
        dec, params, n_replicas=FLEET_REPLICAS,
        devices=[torch.device(CARD)], num_blocks=PAGED_BLOCKS,
        block_size=PAGED_BS, max_batch=DECODE_SLOTS, attention="pallas",
        prefix_cache=True, prefill_chunk=PAGED_CHUNK, **knobs)
    torch.cuda.synchronize()
    grew = torch.cuda.memory_allocated() - before
    pools = sum(r.srv.pool_bytes for r in fe.replicas)
    shared = all(r.srv.params["token_embedding"] is params["token_embedding"]
                 and r.srv.params["stack"]["wq"] is params["stack"]["wq"]
                 for r in fe.replicas)
    if not (pools <= grew <= pools + FLEET_SLACK and shared):
        fe.close()
        check(False, f"fleet: building {FLEET_REPLICAS} replicas grew the "
              f"card's allocation by {grew} B for {pools} B of pools "
              f"(weights shared: {shared})")
    return fe, grew


def fleet_policy(dec, params, reqs, mono, policy: str, **knobs) -> dict:
    """The mix through a fresh fleet under `policy`, in paced bursts:
    token-identical to the reference paged server; the radix hit rate,
    tokens/s, TTFT p50/p99 (histogram bucket edges), routed reasons,
    migrated blocks and shed counts; the paged kernels' card runs
    against the wrappers' launches summed over the replicas (a window's:
    (replays + capture warm-ups) x K x layers)."""
    import torch

    from defer_tpu_torch.obs import get_registry

    label = f"fleet: {policy}" + (f" decode_window={knobs['decode_window']}"
                                  if "decode_window" in knobs else "")
    reg = get_registry()
    fe, grew = fleet_frontend(dec, params, policy=policy, **knobs)
    try:
        hits0 = reg.value("defer_prefix_cache_hits_total", server="paged") or 0
        miss0 = reg.value("defer_prefix_cache_misses_total",
                          server="paged") or 0
        ttft0 = _hist(reg, "defer_ttft_seconds")
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        outs, shed = fleet_drive(fe, reqs, burst=FLEET_BURST, paced=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        host, card = read_launches(), read_card_runs()
        stats = fe.stats()
        replays = sum(r.srv.graph_replays for r in fe.replicas)
        caps = [r.srv.graph_captures for r in fe.replicas]
    finally:
        fe.close()
    del fe
    hits = (reg.value("defer_prefix_cache_hits_total", server="paged")
            or 0) - hits0
    miss = (reg.value("defer_prefix_cache_misses_total", server="paged")
            or 0) - miss0
    ttft1 = _hist(reg, "defer_ttft_seconds")
    check(shed == 0 and len(outs) == len(reqs),
          f"{label}: {len(outs)} of {len(reqs)} served, {shed} shed")
    for i, want in enumerate(mono):
        check(outs[i].equal(want), f"{label}: request {i} differs from the "
              "reference paged server's output")
    L = dec.cfg.num_layers
    K = knobs.get("decode_window", 1)
    if K > 1:
        check(caps == [1] * FLEET_REPLICAS and replays > 0,
              f"{label}: captures {caps}, {replays} replays")
        want = (replays + sum(caps)) * K * L
        check(card["paged_flash_decode"] == want,
              f"{label}: the card ran {card['paged_flash_decode']} "
              f"paged_flash_decode kernels, expected {want}")
        check(card["paged_flash_prefill"] == host["paged_flash_prefill"],
              f"{label}: the card ran {card['paged_flash_prefill']} "
              f"prefill kernels, the wrappers launched "
              f"{host['paged_flash_prefill']}")
    else:
        check(caps == [0] * FLEET_REPLICAS, f"{label}: captures {caps}")
        fleet_eager_runs(label, host, card)
    check(card["paged_flash_decode"] > 0 and card["paged_flash_prefill"] > 0,
          f"{label}: a paged kernel never ran")
    generated = sum(s for _, s in reqs)
    res = {
        "hit_rate": hits / max(hits + miss, 1), "hits": hits,
        "tokens_per_s": generated / wall, "wall_s": wall,
        "ttft_p50_s": _quantile_since(ttft0, ttft1, 0.5),
        "ttft_p99_s": _quantile_since(ttft0, ttft1, 0.99),
        "routed": stats["routed"], "migrated_blocks":
        stats["migrated_blocks"], "shed": stats["shed"],
        "decode_runs": card["paged_flash_decode"],
        "prefill_runs": card["paged_flash_prefill"],
    }
    log(f"{label}: {len(reqs)} requests over {FLEET_REPLICAS} replicas on "
        f"{CARD} (allocation grew {grew} B, the pools; weights shared), "
        f"token-identical to reference paged server; {generated} tokens in "
        f"{wall:.3f}s, {res['tokens_per_s']:.1f} tokens/s incl. admission "
        f"prefills and the paced bursts' waits; radix hit rate "
        f"{res['hit_rate']:.3f} ({hits} block hits); TTFT p50 <= "
        f"{res['ttft_p50_s']} s, p99 <= {res['ttft_p99_s']} s (histogram "
        f"bucket edges); routed {res['routed']}; migrated blocks "
        f"{res['migrated_blocks']}; shed {res['shed']}; paged_flash_decode "
        f"run on the card {card['paged_flash_decode']}"
        + (f" = ({replays} replays + {sum(caps)} warm-ups) x {K} x {L}"
           if K > 1 else " (= the wrappers' launches)")
        + f", paged_flash_prefill {card['paged_flash_prefill']} (= the "
        "wrappers' launches)")
    return res


def timed_prefix_moves(fe) -> list:
    """Wrap each replica server's export_prefix_blocks and
    import_prefix_blocks (on that instance only) to record their host ms
    on the serving thread and the PrefixPayload's bytes (the K and V
    stacks and the token bytes); returns the list the wrappers fill,
    one dict a call."""
    moves = []

    def wrap(srv, name):
        own = getattr(srv, name)

        def timed(*args):
            t0 = time.perf_counter()
            out = own(*args)
            rec = {"call": name, "ms": (time.perf_counter() - t0) * 1e3}
            if name == "export_prefix_blocks" and out is not None:
                toks, k, v = out
                rec["payload_bytes"] = (k.numel() * k.element_size()
                                        + v.numel() * v.element_size()
                                        + sum(map(len, toks)))
            elif name == "import_prefix_blocks":
                rec["blocks"] = out
            moves.append(rec)
            return out

        setattr(srv, name, timed)

    for r in fe.replicas:
        for name in ("export_prefix_blocks", "import_prefix_blocks"):
            wrap(r.srv, name)
    return moves


def fleet_migration(dec, params, reqs, sys_of, mono) -> dict:
    """A forced migration, as tests/test_fleet.py forces one: a request
    seeds one replica's radix cache, a fake backlog on that replica makes
    the next request with the same system prompt migrate the chain to
    the other; it must move SYSTEM_LEN // PAGED_BS blocks and keep the
    tokens. The export and import are timed on the serving threads
    (timed_prefix_moves)."""
    first, second = [i for i, s in enumerate(sys_of) if s == 0][:2]
    fe, _ = fleet_frontend(dec, params, policy="prefix")
    moves = timed_prefix_moves(fe)
    try:
        zero_launches()
        fe.result(fe.submit(*reqs[first]), timeout=FLEET_TIMEOUT_S)
        t0 = time.monotonic()
        holder = None
        while holder is None and time.monotonic() - t0 < 30:
            holder = next((i for i, (_, dig, _) in
                           enumerate(fe.board.snapshot()) if dig), None)
            time.sleep(0.005)
        check(holder is not None, "fleet: no replica advertised its cache")
        fe.obs.queue_depth[holder].set(10)
        out = fe.result(fe.submit(*reqs[second]), timeout=FLEET_TIMEOUT_S)
        routed, moved = dict(fe.routed), fe.migrated_blocks
    finally:
        fe.close()
    del fe
    card = fleet_eager_runs("fleet: migration")
    n = SYSTEM_LEN // PAGED_BS
    check(routed["migrate"] == 1 and moved == n
          and [m["call"] for m in moves] == ["export_prefix_blocks",
                                             "import_prefix_blocks"]
          and moves[1]["blocks"] == n,
          f"fleet: migration routed {routed}, moved {moved} blocks "
          f"(expected {n}), calls {moves}")
    check(out.equal(mono[second]), "fleet: the migrated request's tokens "
          "differ from the reference paged server's")
    exp, imp = moves
    m = {"blocks": imp["blocks"], "payload_bytes": exp["payload_bytes"],
         "export_ms": exp["ms"], "import_ms": imp["ms"]}
    log(f"fleet: forced migration of a {SYSTEM_LEN}-token system prompt "
        f"off replica {holder}: {m['blocks']} blocks, PrefixPayload "
        f"{m['payload_bytes']} B (bf16 K/V stacks and token bytes), export "
        f"{m['export_ms']:.3f} host ms, import {m['import_ms']:.3f} host "
        f"ms (each on its serving thread); tokens unchanged; "
        f"paged_flash_decode / prefill run on the card "
        f"{card['paged_flash_decode']} / {card['paged_flash_prefill']}"
        " (= the wrappers' launches)")
    return m


def fleet_flood(dec, params, reqs, mono, slo_s: float) -> dict:
    """The mix FLEET_FLOOD times over, submitted at once, against
    max_queue=2 and an SLO of `slo_s`: it must shed, never hang, and
    every admitted request keeps its tokens."""
    flood = [(i, r) for i, r in enumerate(reqs) for _ in range(FLEET_FLOOD)]
    fe, _ = fleet_frontend(dec, params, policy="prefix", slo_s=slo_s,
                           max_queue=2)
    try:
        zero_launches()
        t0 = time.perf_counter()
        outs, shed = fleet_drive(fe, [r for _, r in flood],
                                 burst=len(flood), paced=False)
        wall = time.perf_counter() - t0
        p99 = [fe.controller.wait_p99(i) for i in range(FLEET_REPLICAS)]
        reasons = fe.stats()["shed"]
    finally:
        fe.close()
    del fe
    card = fleet_eager_runs("fleet: flood")
    check(shed > 0, f"fleet: the flood of {len(flood)} shed nothing")
    for j, out in outs.items():
        check(out.equal(mono[flood[j][0]]), f"fleet: flood request {j} "
              "differs from the reference paged server's output")
    log(f"fleet: overload flood of {len(flood)} requests at once "
        f"(max_queue=2, slo_s={slo_s}): {len(outs)} admitted and served "
        f"token-identical, {shed} shed {reasons} in {wall:.3f}s; admitted "
        f"queue-wait p99 by replica {[round(p, 6) for p in p99]} s; "
        f"paged_flash_decode / prefill run on the card "
        f"{card['paged_flash_decode']} / {card['paged_flash_prefill']} (= "
        "the wrappers' launches)")
    return {"admitted": len(outs), "shed": shed, "wait_p99_s": p99}


def phase_fleet(dec, params) -> dict:
    """Phase fleet, on phase 5's decoder and weights: the mix through one
    paged server (the reference; every token held by the split check,
    served_bound), then through two replicas under policy "prefix" and
    "round_robin", a forced migration, both replicas on decode_window=4
    at once (each captures while the other serves) and an overload
    flood; each path zeroes the kernel counts before it runs and reads
    them after."""
    import torch

    t0 = time.perf_counter()
    reqs, sys_of = fleet_requests(dec.cfg.vocab_size)
    srv = paged_server(dec, params)
    rids = [srv.submit(p, s) for p, s in reqs]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    mono = [done[r] for r in rids]
    generated = sum(s for _, s in reqs)
    log(f"fleet: {len(reqs)} requests ({FLEET_SYSTEMS} system prompts of "
        f"{SYSTEM_LEN} tokens used {[sys_of.count(s) for s in range(FLEET_SYSTEMS)]}"
        f" times, prompts of {min(p.shape[1] for p, _ in reqs)}-"
        f"{max(p.shape[1] for p, _ in reqs)} tokens, {generated} greedy "
        "steps) through one paged server as the reference, all submitted "
        f"at once: {wall:.3f}s, {generated / wall:.1f} tokens/s")
    del srv, done
    torch.cuda.empty_cache()
    served_bound("fleet", dec, params, reqs, mono, recorded_rows(
        "fleet", paged_server(dec, params), reqs, mono))
    res = {p: fleet_policy(dec, params, reqs, mono, p)
           for p in ("prefix", "round_robin")}
    res["migration"] = fleet_migration(dec, params, reqs, sys_of, mono)
    res["window"] = fleet_policy(dec, params, reqs, mono, "round_robin",
                                 decode_window=FLEET_WINDOW)
    slo = res["prefix"]["ttft_p50_s"]
    res["flood"] = fleet_flood(dec, params, reqs, mono, slo)
    log(f"fleet: phase done in {time.perf_counter() - t0:.1f}s")
    return res


# -- phase serve_sharded: tensor- and pipeline-parallel decode serving ------

# Two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one card): the
# "model" axis of SpmdGptDecoder and of PagedDecodeServer(mesh=), at
# Mistral-7B's width and depth.
SHARD_TP, SHARD_TIMEOUT = 2, 600
# The paged server on the model axis, on phase 5's geometry and the
# pallas kernels: (label, knobs).
SHARD_PAGED = [
    ("k1", {}),
    ("chunk64_prefix", dict(prefix_cache=True, prefill_chunk=PAGED_CHUNK)),
    ("k4", dict(prefix_cache=True, prefill_chunk=PAGED_CHUNK,
                decode_window=4)),
    ("int8_k1", dict(prefix_cache=True, prefill_chunk=PAGED_CHUNK,
                     kv_dtype="int8")),
]
# The short request (a prefill and two ticks) each rank's pool shard is
# held on against the mesh=None pool's head slice (relative L2 within
# ZOO_REL_L2, bf16: the projections are column slices and the psums add
# in another order).
SHARD_POOL_PROMPT, SHARD_POOL_STEPS, SHARD_POOL_BLOCKS = 40, 3, 9
# pp: stages on [cuda:0] * PP_STAGES, in-flight microbatch groups, and
# the window of the pipelined rounds.
PP_STAGES, PP_INFLIGHT, PP_WINDOW = 2, 2, 4


def mistral_bf16(dec):
    """Phase decode's weights, dec.cast_params(dec.init(a CUDA generator
    seeded 0)), with each drawn leaf cast as it is drawn: the same values
    at a lower peak, for a process that builds them beside other copies
    on the one card."""
    import torch

    from defer_tpu_torch.models import gpt
    from defer_tpu_torch.parallel import transformer_stack as ts

    draw = ts.normal

    def narrow(gen, shape, scale, dtype=torch.float32, device=None):
        return draw(gen, shape, scale, dtype, device).to(dec.compute_dtype)

    gpt.normal = ts.normal = narrow
    try:
        return dec.cast_params(
            dec.init(torch.Generator(device="cuda").manual_seed(0)))
    finally:
        gpt.normal = ts.normal = draw


class LogitHash:
    """A running sha256 of the logits every device program in `names` of
    `srv` returns on this rank, as the card made them: one host copy and
    one sha256 update a program, on the timed runs too (`cost_ms` times
    that work alone)."""

    def __init__(self, srv, names):
        import hashlib

        self.h = hashlib.sha256()
        for name in names:
            setattr(srv, name, self._wrap(getattr(srv, name)))

    def _wrap(self, fn):
        def hashed(*args, **kw):
            out = fn(*args, **kw)
            logits = out[0] if isinstance(out, tuple) else out
            self.h.update(logits.float().cpu().numpy().tobytes())
            self.last = logits
            return out

        return hashed

    def cost_ms(self, reps: int = 20) -> float:
        """The host ms one program's hashing takes, its copy off the card
        included, on the last logits hashed, into a throwaway sha256."""
        import hashlib

        import torch

        h = hashlib.sha256()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            h.update(self.last.float().cpu().numpy().tobytes())
        return (time.perf_counter() - t0) * 1e3 / reps

    def digest(self) -> str:
        return self.h.hexdigest()[:16]


def release() -> None:
    """Free a finished server's device memory now: its wrapped methods
    (LogitHash, ServedRows) hold it in reference cycles, which only the
    collector breaks."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _rank_runs(run: dict, dist) -> list:
    """Every rank's `run` dict, in rank order (the model group's)."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, run)
    return got


def _shard_flat(dec, params, mesh, reqs, counter, dist) -> dict:
    """SpmdGptDecoder on the flat DecodeServer at K=1, the same submits
    on every rank: rank 0's rows held by the split check; each rank's
    flash_decode runs L a tick, its logits hash rank 0's."""
    import torch

    from defer_tpu_torch import DecodeServer
    from defer_tpu_torch.models.gpt import SpmdGptDecoder

    sdec = SpmdGptDecoder(dec.cfg, compute_dtype=dec.compute_dtype,
                          mesh=mesh)
    srv = DecodeServer(sdec, sdec.shard_params(params),
                       max_batch=DECODE_SLOTS)
    hashed = LogitHash(srv, ["step"])
    served = ServedRows(srv) if mesh.rank == 0 else None
    rids = [srv.submit(p, s) for p, s in reqs]
    torch.cuda.synchronize()
    dist.barrier()
    zero_launches()
    counter.start(mesh)
    t0 = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs = _rank_runs({"card": read_card_runs(), "hash": hashed.digest(),
                       "ticks": srv.ticks}, dist)
    L, ticks = dec.cfg.num_layers, srv.ticks
    for r, run in enumerate(runs):
        check(run["card"]["flash_decode"] == L * ticks,
              f"serve_sharded flat: rank {r} ran flash_decode "
              f"{run['card']['flash_decode']} times, expected {L} x {ticks}")
        check(run["hash"] == runs[0]["hash"],
              f"serve_sharded flat: rank {r}'s logits differ from rank 0's")
    out = {"launches": runs[0]["card"]["flash_decode"], "wall_s": wall,
           "ticks": ticks, "bytes_tick": counter.bytes.get("model", 0)
           / ticks}
    if served is not None:
        outs = [done[r] for r in rids]
        served_bound("serve_sharded flat tp2", dec, params, reqs, outs,
                     [served.of(r) for r in rids])
        generated = sum(n for _, n in reqs)
        log(
            f"serve_sharded: SpmdGptDecoder tp {SHARD_TP} on DecodeServer "
            f"K=1: {generated} tokens in {ticks} ticks, {wall:.3f}s, "
            f"{generated / wall:.1f} tokens/s with the rows recorded; "
            f"flash_decode {L} a tick on each rank ({out['launches']}); "
            f"logits bit-equal on both ranks (sha256 {runs[0]['hash']}); "
            f"model-axis bytes a tick {out['bytes_tick']:.0f}")
    return out


SHARD_TICKS = 5


def _sharded_tick(srv, vocab: int, mesh, counter, hashed) -> dict:
    """Steady K=1 ticks of the controller's meshed server after its mix
    (every slot seated at depth 150, as phase 5's split): the wall ms of
    a tick (synchronized, each rank hashing its logits), the ms that
    hashing takes alone (one program a tick), and the bytes one tick
    hands the model axis's collectives and the seam."""
    import torch

    tick = paged_tick(srv, vocab, 150)
    tick()
    torch.cuda.synchronize()
    counter.start(mesh)
    seam = srv._link.bytes_sent
    t0 = time.perf_counter()
    for _ in range(SHARD_TICKS):
        tick()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / SHARD_TICKS
    return {"wall_ms": wall, "hash_ms": hashed.cost_ms(),
            "collective_bytes": counter.bytes.get("model", 0) / SHARD_TICKS,
            "seam_bytes": (srv._link.bytes_sent - seam) / SHARD_TICKS}


def _shard_paged(label, knobs, dec, params, mesh, reqs, counter, dist,
                 ref_outs) -> dict:
    """One PagedDecodeServer(mesh=) configuration: rank 0 serves the mix
    (its rows recorded for the split check; the int8 pool held to phase
    6's contract), rank 1 follows its dispatches; each rank's paged
    kernels run what the path implies, its logits hash rank 0's."""
    import torch

    from defer_tpu_torch import PagedDecodeServer
    from defer_tpu_torch.runtime.paged import server_stats

    srv = PagedDecodeServer(
        dec, params, mesh=mesh, num_blocks=PAGED_BLOCKS,
        block_size=PAGED_BS, max_batch=DECODE_SLOTS, attention="pallas",
        **knobs)
    hashed = LogitHash(srv, ["_decode", "_mt"])
    int8 = knobs.get("kv_dtype") == "int8"
    torch.cuda.synchronize()
    dist.barrier()
    zero_launches()
    counter.start(mesh)
    out = {}
    if srv.controller:
        served = None if int8 else ServedRows(srv)
        rids = [srv.submit(p, s) for p, s in reqs]
        t0 = time.perf_counter()
        done = srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows = None
        if served is not None:
            rows = [served.of(r, p.shape[1], n)
                    for r, (p, n) in zip(rids, reqs)]
            served.close()
        coll = counter.bytes.get("model", 0)
        st = server_stats(srv)
        out.update({"wall_s": wall, "mix_ticks": srv.ticks,
                    "outs": [done[r] for r in rids],
                    "tp_psums": st["tp_psums"],
                    "mesh_shape": st["mesh_shape"],
                    "seam_bytes": srv._link.bytes_sent})
        if label == "k1":
            out["tick"] = _sharded_tick(srv, dec.cfg.vocab_size, mesh,
                                        counter, hashed)
        srv.close()
        # Every tick and chunk the card ran, the steady ticks' included.
        out.update(ticks=srv.ticks, chunks=srv.prefill_chunks,
                   replays=srv.graph_replays)
    else:
        srv.run()
        torch.cuda.synchronize()
    runs = _rank_runs({"card": read_card_runs(), "hash": hashed.digest(),
                       **{k: out.get(k) for k in ("ticks", "chunks")}},
                      dist)
    L, K = dec.cfg.num_layers, knobs.get("decode_window", 1)
    ticks, chunks = runs[0]["ticks"], runs[0]["chunks"]
    for r, run in enumerate(runs):
        want = {"paged_flash_decode": L * K * ticks,
                "paged_flash_prefill": L * chunks}
        got = {k: run["card"][k] for k in want}
        check(got == want, f"serve_sharded {label}: rank {r} ran the paged "
              f"kernels {got} times on the card, expected {want}")
        check(run["hash"] == runs[0]["hash"],
              f"serve_sharded {label}: rank {r}'s logits differ from rank "
              "0's")
    if not srv.controller:
        return {}
    check(out["mesh_shape"] == f"model={SHARD_TP}" and out["replays"] == 0,
          f"serve_sharded {label}: mesh_shape {out['mesh_shape']}, "
          f"{out['replays']} graph replays")
    per_fwd = out["tp_psums"] / (2 * L + 2)
    check(per_fwd == int(per_fwd) and per_fwd > 0,
          f"serve_sharded {label}: {out['tp_psums']} psums are not a "
          f"multiple of {2 * L + 2}")
    outs = out.pop("outs")
    if int8:
        greedy_gaps(f"serve_sharded {label}", dec, params, reqs, outs,
                    share=INT8_LOGIT_SHARE)
    else:
        served_bound(f"serve_sharded {label}", dec, params, reqs, outs, rows)
    if ref_outs is not None:
        check(all(a.equal(b) for a, b in zip(outs, ref_outs)),
              f"serve_sharded {label}: the window's tokens differ from "
              "K=1's")
    generated = sum(n for _, n in reqs)
    out.update(launches=runs[0]["card"], forwards=int(per_fwd),
               outs=outs, bytes_tick=(coll + out["seam_bytes"])
               / out["mix_ticks"])
    if "tick" in out:
        t = out["tick"]
        log(
            f"serve_sharded: {label}: a steady tick, {DECODE_SLOTS} slots at "
            f"depth 150-{150 + SHARD_TICKS + 1}: {t['wall_ms']:.3f} ms wall "
            f"(mean of {SHARD_TICKS}, synchronized); the model axis's "
            f"collectives {t['collective_bytes']:.0f} B a tick, the seam's "
            f"dispatch {t['seam_bytes']:.0f} B (both ranks hashing their "
            f"logits, {t['hash_ms']:.3f} ms a tick on rank 0 timed alone)")
    log(
        f"serve_sharded: PagedDecodeServer(mesh=model {SHARD_TP}, "
        f"pallas, {knobs}): {generated} tokens in {out['mix_ticks']} ticks "
        f"and {out['chunks']} prefill chunks, {out['wall_s']:.3f}s, "
        f"{generated / out['wall_s']:.1f} tokens/s with the rows recorded; "
        f"card runs on each rank {runs[0]['card']} (= {L} x {K} x "
        f"{out['ticks']} ticks, steady ones included, {L} x chunks); "
        f"tp_psums {out['tp_psums']} = {2 * L + 2} x {int(per_fwd)} "
        f"forwards; model-axis bytes a tick over the mix, its prefills "
        f"included, {out['bytes_tick']:.0f} (collectives {coll}, the "
        f"seam's dispatches {out['seam_bytes']}); 0 graph replays; logits "
        f"bit-equal on both ranks (sha256 {runs[0]['hash']})")
    return out


def _pool_rows(srv, table, n: int) -> list:
    """The K and V rows of positions 0..n-1 of one request's `table`
    (its pool blocks), [n, L, heads, Dh] each, on the host."""
    import torch

    pos = torch.arange(n)
    blocks = torch.as_tensor(table[: -(-n // srv.bs)]).long()[pos // srv.bs]
    return [leaf[:, blocks.to(leaf.device), :, (pos % srv.bs).to(
        leaf.device)].float().cpu() for leaf in srv._leaves()]


def _shard_pool(dec, params, mesh, dist) -> dict:
    """One short request (a prefill and two ticks) on a fresh meshed
    server; each rank's pool shard at the request's written positions
    against the head slice of a mesh=None server's pool after the same
    request, on rank 0: every prompt row, and each generated token's row
    while both servers drew the same tokens (bf16: a near tie may fall
    either way)."""
    import torch

    from defer_tpu_torch import PagedDecodeServer

    knobs = dict(num_blocks=SHARD_POOL_BLOCKS, block_size=PAGED_BS,
                 max_batch=1, attention="pallas")
    prompt = torch.randint(0, dec.cfg.vocab_size, (1, SHARD_POOL_PROMPT),
                           generator=torch.Generator().manual_seed(9))
    t_in = SHARD_POOL_PROMPT

    def serve(srv):
        rid = srv.submit(prompt, SHARD_POOL_STEPS)
        srv.step()  # the admission and the first tick, the slot live
        table = srv.tables[0].copy()
        return srv.run()[rid], table

    srv = PagedDecodeServer(dec, params, mesh=mesh, **knobs)
    table = None
    if srv.controller:
        got, table = serve(srv)
        srv.close()
    else:
        srv.run()
    table = _rank_runs(table, dist)[0]
    written = t_in + SHARD_POOL_STEPS - 1
    mine = _pool_rows(srv, table, written)
    shards = _rank_runs(mine, dist)
    if not srv.controller:
        return {}
    whole = PagedDecodeServer(dec, params, **knobs)
    want, wtable = serve(whole)
    check((wtable == table).all(), "serve_sharded pool: the two servers "
          "allocated different blocks")
    same = (want[0, t_in:written] == got[0, t_in:written]).tolist() + [False]
    n = t_in + same.index(False)
    ref = _pool_rows(whole, table, n)
    errs = []
    for r, shard in enumerate(shards):
        for part, whole_part in zip(shard, ref):
            h = whole_part.shape[2] // SHARD_TP
            want_part = whole_part[:, :, r * h:(r + 1) * h]
            errs.append(float((part[:n] - want_part).norm()
                              / want_part.norm()))
    check(max(errs) <= ZOO_REL_L2,
          f"serve_sharded pool: a rank's pool shard is {max(errs):.3e} "
          f"(relative L2) from mesh=None's head slice, tol {ZOO_REL_L2}")
    log(
        f"serve_sharded: one request of {t_in} + {SHARD_POOL_STEPS} tokens "
        f"on a {SHARD_POOL_BLOCKS}-block pool: each rank's K and V shard "
        f"at its {n} written positions against mesh=None's head slice, "
        f"relative L2 {', '.join(f'{e:.3e}' for e in errs)} (tol "
        f"{ZOO_REL_L2}); tokens {'equal' if want.equal(got) else 'differ'}"
        " (bf16 psum order)")
    return {"pool_rel_l2": max(errs)}


# The fleet's tensor-parallel replicas (phase serve_sharded): the first
# SHARD_FLEET_REQUESTS requests of phase fleet's mix (Zipf reuse of its
# system prompts) through FLEET_REPLICAS replicas, each on a
# {"model": SHARD_TP} mesh over the two ranks.
SHARD_FLEET_REQUESTS = 8


def _shard_fleet(dec, params, rank: int, dist) -> dict:
    """serve_fleet's front end with model_axis_size=SHARD_TP over the two
    ranks (phase 5's knobs): rank 0 routes and serves, rank 1 follows
    both replicas in threads; rank 0's rows, recorded on each replica,
    under the split check; both replicas read mesh_shape "model=2" on
    both ranks; each rank's paged kernels ran on its head shards (card
    runs, equal on both ranks); the allocation each rank's fleet grew by
    (its pools: the replicas share the rank's one shard of the tree)."""
    import gc

    import torch

    from defer_tpu_torch.fleet import FleetFrontend

    reqs = fleet_requests(dec.cfg.vocab_size)[0][:SHARD_FLEET_REQUESTS]
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    dist.barrier()
    zero_launches()
    fe = FleetFrontend(
        dec, params, n_replicas=FLEET_REPLICAS, model_axis_size=SHARD_TP,
        devices=[torch.device(CARD)], num_blocks=PAGED_BLOCKS,
        block_size=PAGED_BS, max_batch=DECODE_SLOTS, attention="pallas",
        prefix_cache=True, prefill_chunk=PAGED_CHUNK)
    torch.cuda.synchronize()
    grew = torch.cuda.memory_allocated() - before
    shards = sum(1 for k in dec._steps
                 if isinstance(k, tuple) and k[0] == "paged_shard")
    out = {}
    if not fe.follower:
        served = [ServedRows(r.srv) for r in fe.replicas]
        where = {}
        for i, rep_ in enumerate(fe.replicas):
            def take(req, rep_=rep_, own=rep_._take, i=i):
                own(req)
                for rid, gid in rep_._gid_of.items():
                    if gid == req.gid:
                        where[gid] = (i, rid)

            rep_._take = take
        t0 = time.perf_counter()
        gids = [fe.submit(p, n) for p, n in reqs]
        outs = [fe.result(g, timeout=FLEET_TIMEOUT_S) for g in gids]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows = [served[where[g][0]].of(where[g][1], p.shape[1], n)
                for g, (p, n) in zip(gids, reqs)]
        for sv in served:
            sv.close()
        out.update(wall_s=wall, outs=outs, rows=rows,
                   per_replica=[where[g][0] for g in gids].count(0))
    fe.close()
    torch.cuda.synchronize()
    stats = fe.stats()
    runs = _rank_runs({
        "card": read_card_runs(), "grew": grew, "shards": shards,
        "mesh": [r["mesh_shape"] for r in stats["replicas"]],
        "psums": [r["tp_psums"] for r in stats["replicas"]],
        "dead": [r["dead"] for r in stats["replicas"]]}, dist)
    for r, run in enumerate(runs):
        check(run["mesh"] == [f"model={SHARD_TP}"] * FLEET_REPLICAS
              and run["dead"] == [None] * FLEET_REPLICAS
              and run["shards"] == 1,
              f"serve_sharded fleet: rank {r}: replicas' mesh shapes "
              f"{run['mesh']}, dead {run['dead']}, {run['shards']} shards")
        check(run["card"] == runs[0]["card"]
              and run["card"]["paged_flash_decode"] > 0
              and run["card"]["paged_flash_prefill"] > 0,
              f"serve_sharded fleet: rank {r} ran the paged kernels "
              f"{run['card']} times on the card, rank 0 {runs[0]['card']}")
    del fe
    release()
    if rank:
        return {}
    served_bound(f"serve_sharded fleet model_axis_size={SHARD_TP}", dec,
                 params, reqs, out.pop("outs"), out.pop("rows"))
    generated = sum(n for _, n in reqs)
    log(f"serve_sharded: serve_fleet front end, {FLEET_REPLICAS} replicas "
        f"with model_axis_size={SHARD_TP} over the two ranks (phase 5's "
        f"knobs; {out['per_replica']} of {len(reqs)} requests on replica "
        f"0): {generated} tokens in {out['wall_s']:.3f}s, "
        f"{generated / out['wall_s']:.1f} tokens/s with the rows recorded; "
        f"every replica reads mesh_shape model={SHARD_TP} on both ranks; "
        f"tp_psums by replica {runs[0]['psums']}; paged kernels run on the "
        f"card on each rank {runs[0]['card']}; the fleet grew each rank's "
        f"allocation by {[run['grew'] for run in runs]} B (its replicas' "
        f"pools: both replicas of a rank read one shard of the tree, "
        "shared with this phase's other meshed servers)")
    return {"launches": runs[0]["card"], "grew": [run["grew"] for run in runs],
            "tokens_per_s": generated / out["wall_s"],
            "tp_psums": runs[0]["psums"]}


# pp x tp (phase serve_sharded): four gloo ranks sharing cuda:0 on a
# {"stage": PP_STAGES, "model": SHARD_TP} mesh at Mistral-7B's width and
# PPTP_LAYERS of its 32 layers (four whole bf16 trees, one a rank, would
# hold 57 GB of host memory beside this process's), the first
# PPTP_REQUESTS requests of phase 5's mix, PP_INFLIGHT groups, windows
# of PP_WINDOW rounds.
PPTP_WORLD, PPTP_LAYERS, PPTP_REQUESTS = PP_STAGES * SHARD_TP, 16, 4


def pptp_rank(rank: int, port: int, out: str) -> int:
    """One of pp x tp's four ranks on cuda:0 over gloo: the weights built
    one rank at a time (phase decode's seed, PPTP_LAYERS layers), then
    PagedDecodeServer(mesh={"stage", "model"}, pp_stages=PP_STAGES) with
    phase 5's knobs, rank 0 the controller (its rows under the split
    check), the others following the chains; each rank's
    paged_flash_prefill runs equal to its stage's layers x dispatches;
    the bubble fraction, stage dispatches, tp_psums and each axis's
    bytes. Rank 0 writes its numbers to `out`."""
    import gc

    import torch
    import torch.distributed as dist

    from defer_tpu_torch import GptDecoder, PagedDecodeServer, mistral_config
    from defer_tpu_torch.parallel import multihost
    from defer_tpu_torch.parallel.mesh import make_mesh
    from defer_tpu_torch.runtime.paged import server_stats
    from defer_tpu_torch.weights import tree_to

    multihost.initialize(f"tcp://127.0.0.1:{port}", PPTP_WORLD, rank,
                         backend="gloo")
    dev = torch.device(CARD)
    torch.cuda.set_device(dev)
    dec = GptDecoder(mistral_config(num_layers=PPTP_LAYERS),
                     compute_dtype=torch.bfloat16, device=dev)
    params = None
    for r in range(PPTP_WORLD):
        if r == rank:
            params = mistral_bf16(dec)
            if rank:  # only rank 0 keeps the tree on the card (its f32
                # reference); the others shard their stage from the host
                params = tree_to(params, torch.device("cpu"))
                torch.cuda.empty_cache()
            torch.cuda.synchronize()
        dist.barrier()
    mesh = make_mesh({"stage": PP_STAGES, "model": SHARD_TP},
                     [dev] * PPTP_WORLD)
    srv = PagedDecodeServer(
        dec, params, mesh=mesh, num_blocks=PAGED_BLOCKS, block_size=PAGED_BS,
        max_batch=DECODE_SLOTS, attention="pallas", prefix_cache=True,
        prefill_chunk=PAGED_CHUNK, pp_stages=PP_STAGES,
        pp_inflight=PP_INFLIGHT, decode_window=PP_WINDOW)
    if rank:
        del params
        gc.collect()
    reqs = paged_requests(dec.cfg.vocab_size)[:PPTP_REQUESTS]
    counter = _ByteCount()
    torch.cuda.synchronize()
    dist.barrier()
    zero_launches()
    counter.start(mesh)
    res = {}
    if srv.controller:
        served = ServedRows(srv)
        rids = [srv.submit(p, n) for p, n in reqs]
        t0 = time.perf_counter()
        done = srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs = [done[r] for r in rids]
        rows = [served.of(r, p.shape[1], n) for r, (p, n) in zip(rids, reqs)]
        served.close()
        st = server_stats(srv)
        res.update(wall_s=wall, tp_psums=st["tp_psums"],
                   bubble=srv.pp_bubble_last, pp_stages=st["pp_stages"],
                   mesh_shape=st["mesh_shape"],
                   pool_bytes=st["pp_stage_pool_bytes"],
                   cuts=list(srv._pp_cut_starts))
        srv.close()
    else:
        srv.run()
    torch.cuda.synchronize()
    stage = mesh.coords["stage"]
    bounds = srv._pp_cut_starts + [dec.cfg.num_layers]
    runs = _rank_runs({
        "card": read_card_runs(), "dispatches": list(srv.pp_stage_dispatch_n),
        "layers": bounds[stage + 1] - bounds[stage],
        "bytes": dict(counter.bytes), "calls": dict(counter.calls),
        "peak": torch.cuda.max_memory_allocated()}, dist)
    for r, run in enumerate(runs):
        s = r // SHARD_TP
        want = {"flash_decode": 0, "paged_flash_decode": 0,
                "paged_flash_prefill": run["layers"]
                * run["dispatches"][s]}
        check(run["card"] == want and run["dispatches"]
              == runs[0]["dispatches"],
              f"serve_sharded pp x tp: rank {r} (stage {s}) ran "
              f"{run['card']} on the card, expected {want}; dispatches "
              f"{run['dispatches']}")
    for mod in ("jax", "defer_tpu"):
        check(mod not in sys.modules, f"pp x tp rank {rank} imported {mod}")
    if rank == 0:
        L = dec.cfg.num_layers
        check(res["pp_stages"] == PP_STAGES and res["tp_psums"] > 0
              and res["tp_psums"] % (2 * L + 2) == 0
              and res["mesh_shape"] == f"model={SHARD_TP}",
              f"serve_sharded pp x tp: pp_stages {res['pp_stages']}, "
              f"tp_psums {res['tp_psums']}, mesh_shape {res['mesh_shape']}")
        served_bound(f"serve_sharded pp {PP_STAGES} x tp {SHARD_TP}", dec,
                     params, reqs, outs, rows)
        generated = sum(n for _, n in reqs)
        res.update(runs=runs, tokens_per_s=generated / res["wall_s"])
        log(f"serve_sharded: pp {PP_STAGES} x tp {SHARD_TP} on "
            f"{PPTP_WORLD} gloo ranks sharing {CARD} (Mistral-7B width, "
            f"{L} of its 32 layers; cuts {res['cuts']}, pp_inflight "
            f"{PP_INFLIGHT}, decode_window {PP_WINDOW}, pallas, phase 5's "
            f"pool and knobs, {len(reqs)} requests): {generated} tokens in "
            f"{res['wall_s']:.3f}s, {res['tokens_per_s']:.1f} tokens/s with "
            f"the rows recorded; bubble fraction of the last window "
            f"{res['bubble']:.4f}; stage dispatches {runs[0]['dispatches']};"
            f" tp_psums {res['tp_psums']} = {2 * L + 2} x "
            f"{res['tp_psums'] // (2 * L + 2)} chains; paged_flash_prefill "
            f"run on the card by rank "
            f"{[run['card']['paged_flash_prefill'] for run in runs]} (each "
            f"= its stage's layers x dispatches, on its head shard); bytes "
            f"by axis by rank {[run['bytes'] for run in runs]}; stage pool "
            f"bytes {res['pool_bytes']}; peak allocation by rank "
            f"{[run['peak'] for run in runs]} B")
        with open(out, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharded_rank(rank: int, port: int, out: str) -> int:
    """One of phase serve_sharded's two ranks on cuda:0 over gloo: the
    Mistral-7B weights built one rank at a time (phase decode's values),
    then the flat tp decoder, each SHARD_PAGED configuration and the pool
    check, rank 0 the controller; rank 0 logs its lines (the phase echoes
    them) and writes its numbers to `out`. Any failure raises: the rank
    exits non-zero."""
    import torch
    import torch.distributed as dist

    from defer_tpu_torch import GptDecoder, mistral_config
    from defer_tpu_torch.parallel import multihost
    from defer_tpu_torch.parallel.mesh import make_mesh
    from defer_tpu_torch.weights import tree_to

    multihost.initialize(f"tcp://127.0.0.1:{port}", SHARD_TP, rank,
                         backend="gloo")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_mesh({"model": SHARD_TP}, [dev] * SHARD_TP)
    dec = GptDecoder(mistral_config(), compute_dtype=torch.bfloat16,
                     device=dev)
    params = None
    for r in range(SHARD_TP):  # one rank at a time: the init's transient
        if r == rank:
            params = mistral_bf16(dec)
            if rank:
                # Only rank 0 reads the whole tree on the card (the f32
                # reference of the split check); the others shard it
                # from host memory as each server is built.
                params = tree_to(params, torch.device("cpu"))
                torch.cuda.empty_cache()
            torch.cuda.synchronize()
        dist.barrier()
    counter = _ByteCount()
    res = {"flat": _shard_flat(dec, params, mesh,
                               decode_requests(dec.cfg.vocab_size), counter,
                               dist)}
    reqs = paged_requests(dec.cfg.vocab_size)
    for label, knobs in SHARD_PAGED:
        release()
        ref = res["chunk64_prefix"]["outs"] if label == "k4" and rank == 0 \
            else None
        res[label] = _shard_paged(label, knobs, dec, params, mesh, reqs,
                                  counter, dist, ref)
    release()
    res["pool"] = _shard_pool(dec, params, mesh, dist)
    release()
    res["fleet"] = _shard_fleet(dec, params, rank, dist)
    peaks = _rank_runs(torch.cuda.max_memory_allocated(), dist)
    for mod in ("jax", "defer_tpu"):
        check(mod not in sys.modules, f"serve_sharded rank {rank} "
              f"imported {mod}")
    if rank == 0:
        for run in res.values():
            run.pop("outs", None)
        log(f"serve_sharded: peak allocation by rank {peaks} B")
        with open(out, "w") as f:
            json.dump({"runs": res, "peaks": peaks}, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _start_ranks(here: str, flag: str, world: int, out: str, timeout: float,
                 label: str, *extra: str) -> list:
    """Run `world` ranks of this script (`flag` RANK PORT OUT, then
    `extra`) on the card and wait for them; a rank that fails, hangs past
    `timeout` or exits non-zero fails the phase, and every rank is
    stopped by the end. Returns each rank's output lines."""
    tmp = os.path.dirname(out)
    port = _free_port()
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r), str(port),
         out, *extra], cwd=here, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    check(all(p.returncode == 0 for p in procs),
          f"{label}: a rank failed or hung:\n" + "\n".join(
              f"rank {r} exit {p.returncode}: {text[-4000:]}"
              for r, (p, text) in enumerate(zip(procs, texts))))
    return [text.splitlines() for text in texts]


def shard_tp1(dec, params, ref_outs) -> dict:
    """The paged server on a one-process {"model": 1} mesh over cuda:0,
    phase 5's knobs: every program through the seam, its collectives the
    identity; tokens equal phase 5's (mesh=None), psums counted."""
    import torch

    from defer_tpu_torch.parallel.mesh import make_mesh
    from defer_tpu_torch.runtime.paged import server_stats

    srv = paged_server(dec, params, mesh=make_mesh({"model": 1},
                                                   [torch.device(CARD)]))
    reqs = paged_requests(dec.cfg.vocab_size)
    outs, wall, host, card = serve_counted("serve_sharded tp1", srv, reqs)
    st = server_stats(srv)
    check(all(a.equal(b) for a, b in zip(outs, ref_outs)),
          "serve_sharded tp1: the size-1 mesh's tokens differ from "
          "mesh=None's (phase 5)")
    L = dec.cfg.num_layers
    check(st["mesh_shape"] == "model=1" and st["tp_psums"] > 0
          and st["tp_psums"] % (2 * L + 2) == 0,
          f"serve_sharded tp1: mesh_shape {st['mesh_shape']}, tp_psums "
          f"{st['tp_psums']}")
    check(card["paged_flash_decode"] == host["paged_flash_decode"]
          == L * srv.ticks, f"serve_sharded tp1: paged_flash_decode card "
          f"{card['paged_flash_decode']}, launched "
          f"{host['paged_flash_decode']}, expected {L} x {srv.ticks}")
    generated = sum(n for _, n in reqs)
    log(f"serve_sharded: PagedDecodeServer(mesh={{'model': 1}}), phase 5's "
        f"knobs: token-identical to phase 5 (mesh=None); {generated} tokens "
        f"in {wall:.3f}s, {generated / wall:.1f} tokens/s; tp_psums "
        f"{st['tp_psums']} = {2 * L + 2} x "
        f"{st['tp_psums'] // (2 * L + 2)} forwards (each the identity); "
        f"paged_flash_decode {card['paged_flash_decode']} (= {L} x "
        f"{srv.ticks} ticks)")
    return {"tokens_per_s": generated / wall, "tp_psums": st["tp_psums"]}


def _pp_server(dec, params, **knobs):
    """Phase 5's server split into PP_STAGES stages: PP_INFLIGHT groups,
    windows of PP_WINDOW rounds."""
    return paged_server(dec, params, pp_stages=PP_STAGES,
                        pp_inflight=PP_INFLIGHT, decode_window=PP_WINDOW,
                        **knobs)


def shard_pp(dec, params, ref_outs) -> dict:
    """pp_stages=2 on [cuda:0] * 2 in this process: the split check on
    the rows the stage chain produced, the share of tokens identical to
    pp_stages=1 (phase 5; the stages take the prefill kernel at T=1
    where phase 5 takes the decode kernel, so the rounding differs:
    reported, not gated), paged_flash_prefill's card runs equal to the
    stage dispatches' layers, and the bubble fraction."""
    import torch

    srv = _pp_server(dec, params, pp_devices=[torch.device(CARD)] * 2)
    served = ServedRows(srv)
    reqs = paged_requests(dec.cfg.vocab_size)
    outs, wall, host, card = serve_counted("serve_sharded pp", srv, reqs)
    served_bound("serve_sharded pp", dec, params, reqs, outs,
                 [served.of(r, p.shape[1], n)  # rids 0, 1, ...
                  for r, (p, n) in enumerate(reqs)])
    served.close()
    layers = [b - a for a, b in zip(srv._pp_cut_starts,
                                    srv._pp_cut_starts[1:]
                                    + [dec.cfg.num_layers])]
    want = sum(n * d for n, d in zip(layers, srv.pp_stage_dispatch_n))
    check(card["paged_flash_prefill"] == want
          and card["paged_flash_decode"] == 0,
          f"serve_sharded pp: card runs {card}, expected paged_flash_prefill "
          f"{want} (stage layers {layers} x dispatches "
          f"{srv.pp_stage_dispatch_n}) and no paged_flash_decode")
    same = sum(int((a[0, p.shape[1]:] == b[0, p.shape[1]:]).sum())
               for a, b, (p, _) in zip(outs, ref_outs, reqs))
    generated = sum(n for _, n in reqs)
    log(f"serve_sharded: pp_stages={PP_STAGES} on [cuda:0] x {PP_STAGES} "
        f"(cuts {srv._pp_cut_starts}, pp_inflight={PP_INFLIGHT}, "
        f"decode_window={PP_WINDOW}, pallas): {generated} tokens in "
        f"{wall:.3f}s, {generated / wall:.1f} tokens/s with the rows "
        f"recorded; {same} of {generated} tokens identical to pp_stages=1 "
        f"(phase 5); stage dispatches {srv.pp_stage_dispatch_n}, "
        f"paged_flash_prefill run on the card {card['paged_flash_prefill']}"
        f" (= {want}); bubble fraction of the last window "
        f"{srv.pp_bubble_last:.4f}")
    out = {"outs": outs, "launches": card["paged_flash_prefill"],
           "bubble": srv.pp_bubble_last, "same": same,
           "dispatches": list(srv.pp_stage_dispatch_n),
           "cuts": list(srv._pp_cut_starts), "tokens_per_s": generated / wall}
    return out


class PPStageWorker(WorkerProcess):
    """`python -m chip_smoke --pp-stage S RESULT_PORT`: one stage of the
    pipeline behind serve_pp_stage, its results to this process's
    receiver on RESULT_PORT."""

    def __init__(self, here: str, stage: int, result_port: int):
        super().__init__(here, 0, command=[
            "chip_smoke", "--pp-stage", str(stage), str(result_port)])


def pp_stage_worker(stage: int, result_port: int) -> int:
    """A serve_pp_stage worker on cuda:0: phase decode's weights built
    here (mistral_bf16), stage `stage` of PP_STAGES equal cuts; prints
    LISTENING <port>, then DONE <microbatches> when the controller's STOP
    frame arrives."""
    import torch

    from defer_tpu_torch import GptDecoder, mistral_config
    from defer_tpu_torch.runtime.remote_stage import serve_pp_stage

    dec = GptDecoder(mistral_config(), compute_dtype=torch.bfloat16,
                     device=CARD)
    params = mistral_bf16(dec)
    per = dec.cfg.num_layers // PP_STAGES
    n = serve_pp_stage(
        dec, params, stage * per, (stage + 1) * per, num_blocks=PAGED_BLOCKS,
        block_size=PAGED_BS, attention="pallas", listen_port=0,
        listen_host="127.0.0.1", result_host="127.0.0.1",
        result_port=result_port, accept_timeout_s=WORKER_TIMEOUT_S,
        announce=lambda p: print(f"LISTENING {p}", flush=True))
    print(f"DONE {n}", flush=True)
    return 0


def shard_pp_remote(dec, params, here: str, pp_res: dict) -> dict:
    """The same stages served by two serve_pp_stage worker processes on
    cuda:0 over loopback: tokens identical to the in-process stages (the
    same programs and kernels; lossless frames), each worker's
    microbatches equal to its stage's dispatches, the host ms a round
    trip."""
    from defer_tpu_torch.runtime.transport import ArrayReceiver

    receivers = [ArrayReceiver(0, host="127.0.0.1",
                               accept_timeout_s=WORKER_TIMEOUT_S)
                 for _ in range(PP_STAGES)]
    workers = []
    try:
        for s in range(PP_STAGES):
            workers.append(PPStageWorker(here, s, receivers[s].port))
        srv = _pp_server(dec, params, pp_remote={
            s: ("127.0.0.1", w.port, receivers[s])
            for s, w in enumerate(workers)})
        reqs = paged_requests(dec.cfg.vocab_size)
        outs, wall, _, _ = serve_counted("serve_sharded pp_remote", srv,
                                         reqs)
        srv.close_pp()
        for w, n in zip(workers, srv.pp_stage_dispatch_n):
            done = w._expect("DONE ")
            check(done == f"DONE {n}", f"serve_sharded pp_remote: a worker "
                  f"printed {done!r}, its stage took {n} dispatches")
            check(w.proc.wait(timeout=60) == 0,
                  f"serve_sharded pp_remote: a worker exited "
                  f"{w.proc.returncode}")
    finally:
        for w in workers:
            w.stop()
        for r in receivers:
            r.close()
    check(all(a.equal(b) for a, b in zip(outs, pp_res["outs"])),
          "serve_sharded pp_remote: tokens differ from the in-process "
          "stages'")
    check(srv.pp_stage_dispatch_n == pp_res["dispatches"],
          f"serve_sharded pp_remote: dispatches {srv.pp_stage_dispatch_n}, "
          f"in process {pp_res['dispatches']}")
    stages = srv._pp_stage_objs
    trips = sum(st.round_trips for st in stages)
    host_ms = sum(st.host_s for st in stages) * 1e3 / trips
    generated = sum(n for _, n in reqs)
    log(f"serve_sharded: pp_remote, both stages in serve_pp_stage worker "
        f"processes on cuda:0 over loopback: token-identical to the "
        f"in-process stages; {generated} tokens in {wall:.3f}s, "
        f"{generated / wall:.1f} tokens/s; {trips} round trips, "
        f"{host_ms:.3f} host ms a round trip (six operands out, one array "
        "back)")
    return {"round_trip_ms": host_ms, "tokens_per_s": generated / wall}


# The pp 2 vs pp 1 question: the first requests of phase 5's mix (one
# slot each), served by pp_stages=1 at K=1 and by pp_stages=2 at
# pp_inflight 1 and 2, their served rows compared up to each request's
# first parting token.
PP_QUESTION_REQS = DECODE_SLOTS
# Captured mesh windows: the window of the {"model": 1} and the
# world-size-1 NCCL servers, the sync sanitizer's allowance (a steady
# window's one batched drain, which carries the valid lengths and alive
# flags when eos is set and the tokens when they stream or stop-match;
# phase 5's server has none of these) and the NCCL rank's time limit.
MESH_WINDOW, DRAIN_SYNCS, NCCL1_TIMEOUT = 4, 1, 600


def _pp_step_parts(srv) -> dict:
    """One decode step of a seated pp_stages=1 server ("pallas", an fp
    pool) four ways, each on the same tables, positions and feed: its
    own tick (paged_flash_decode); the whole stack at T=1 through the
    prefill kernel, as a pipeline stage runs it; the same cut in two
    stages at the middle layer (the boundary activation handed over as a
    stage hands it); and the whole stack over each half of the slots (a
    pp_inflight=2 group's GEMM M). The max abs differences of the
    [B, V] logits rows, and the boundary activation's dtype."""
    import torch

    from defer_tpu_torch.runtime.paged import _mt_forward

    dec, L, B = srv.dec, srv.dec.cfg.num_layers, srv.B
    tables, pos, feed = srv._tables_dev, srv._pos_dev, srv._feed
    keep = torch.ones((B,), dtype=torch.int32, device=srv.device)
    start = torch.zeros_like(keep)

    def stack(rows, first=0, last=L, x=None):
        return _mt_forward(
            dec, dec.stage_params(srv.params, first, last),
            srv.pool_k[first:last], srv.pool_v[first:last], tables[rows],
            pos[rows], feed[rows] if x is None else x, keep[rows],
            start[rows], srv.MB, "pallas", srv.bs, first=first, last=last)

    every = torch.arange(B, device=srv.device)
    with torch.no_grad():
        tick = srv._decode(tables, pos, feed, srv.MB)[:, -1]
        whole = stack(every)[:, -1]
        x = stack(every, 0, L // 2)
        split = stack(every, L // 2, L, x)[:, -1]
        halves = torch.cat([stack(every[: B // 2])[:, -1],
                            stack(every[B // 2:])[:, -1]])
    return {"kernel": float((tick - whole).abs().max()),
            "boundary": float((split - whole).abs().max()),
            "half_m": float((halves - whole).abs().max()),
            "boundary_dtype": str(x.dtype)}


def shard_pp_question(dec, params) -> dict:
    """Where pp_stages=2's rows part from pp_stages=1's: the first
    PP_QUESTION_REQS requests of the mix through pp 1 (K=1), pp 2 at
    pp_inflight=1 and at 2 (windows of PP_WINDOW), every served row
    recorded; for each pair the tokens in common and the largest row
    gap up to each request's first parting token (rows past it follow
    different prefixes); then one step of a seated pp 1 server
    decomposed (`_pp_step_parts`). The boundary must be exact and keep
    the compute dtype; the rest is reported."""
    import torch

    reqs = paged_requests(dec.cfg.vocab_size)[:PP_QUESTION_REQS]
    runs = {}
    for name, knobs in (
            ("pp1", {}),
            ("pp2_inflight1", dict(pp_stages=PP_STAGES, pp_inflight=1,
                                   decode_window=PP_WINDOW)),
            ("pp2_inflight2", dict(pp_stages=PP_STAGES, pp_inflight=2,
                                   decode_window=PP_WINDOW))):
        if "pp_stages" in knobs:
            knobs["pp_devices"] = [torch.device(CARD)] * PP_STAGES
        srv = paged_server(dec, params, **knobs)
        served = ServedRows(srv)
        outs, _, host, card = serve_counted(f"serve_sharded {name}", srv,
                                            reqs)
        rows = [torch.stack(served.of(r, p.shape[1], n))
                for r, (p, n) in enumerate(reqs)]
        served.close()
        runs[name] = {"outs": outs, "rows": rows, "card": card}
        del srv, served
        release()
    pairs = {}
    for a, b in (("pp1", "pp2_inflight1"), ("pp1", "pp2_inflight2"),
                 ("pp2_inflight1", "pp2_inflight2")):
        same = gap = 0
        for i, (p, n) in enumerate(reqs):
            ta = runs[a]["outs"][i][0, p.shape[1]:]
            tb = runs[b]["outs"][i][0, p.shape[1]:]
            diff = (ta != tb).nonzero()
            upto = int(diff[0, 0]) + 1 if diff.numel() else n
            same += int((ta == tb).sum())
            gap = max(gap, float((runs[a]["rows"][i][:upto]
                                  - runs[b]["rows"][i][:upto]).abs().max()))
        pairs[f"{a}_vs_{b}"] = {"same": same, "gap": gap}
    srv = paged_server(dec, params)
    for p, _ in reqs:
        srv.submit(p, 64)
    srv.step()
    check(all(s is not None for s in srv.slots),
          "serve_sharded pp question: the requests did not all get a slot")
    parts = _pp_step_parts(srv)
    del srv
    release()
    check(parts["boundary"] == 0.0
          and parts["boundary_dtype"] == str(dec.compute_dtype),
          f"serve_sharded pp question: the stage boundary changed the rows "
          f"or the dtype: {parts}")
    generated = sum(n for _, n in reqs)
    log("serve_sharded: the pp question, the first "
        f"{len(reqs)} requests of the mix ({generated} tokens): "
        + "; ".join(f"{k}: {v['same']} of {generated} tokens identical, "
                    f"rows up to the first parting token at most "
                    f"{v['gap']:.4g} apart" for k, v in pairs.items())
        + f" (the split check's bound 0.25). One step of the seated pp 1 "
        f"server decomposed: its paged_flash_decode tick against the whole "
        f"stack through paged_flash_prefill at T=1 (a stage's kernel) "
        f"{parts['kernel']:.4g}; two stages at layer "
        f"{dec.cfg.num_layers // 2} against one {parts['boundary']:.4g} "
        f"(the boundary activation {parts['boundary_dtype']}, the compute "
        f"dtype); the stack over each half of the slots (pp_inflight=2's "
        f"GEMM M) against all four {parts['half_m']:.4g}")
    return {"pairs": pairs, "parts": parts,
            "launches": runs["pp2_inflight1"]["card"]["paged_flash_prefill"]}


def _mesh_window_run(label: str, dec, params, mesh, ref_outs) -> dict:
    """PagedDecodeServer(mesh=) at decode_window=MESH_WINDOW on phase 5's
    knobs: a warm-up request of its own tokens (its first window
    captures), then the mix under capture_sanitizer (nothing captured),
    then the mix on the same mesh with the capture forced off (its
    windows eager); every token identical between the two and to phase
    5's (`ref_outs`; the caller checks them where it has none), replays
    counted, paged_flash_decode's card runs replays x K x layers in the
    sanitized mix; then a steady window's host and device ms and idle
    share on a fresh server. Shared by the one-process {"model": 1} mesh
    and the world-size-1 NCCL rank. (A second serve of the mix on one
    server would hit its radix cache, prefill shorter chunks and round
    differently: the warm-up shares no block with the mix.)"""
    import torch

    from defer_tpu_torch.analysis import capture_sanitizer

    K, L = MESH_WINDOW, dec.cfg.num_layers
    reqs = paged_requests(dec.cfg.vocab_size)
    srv = paged_server(dec, params, mesh=mesh, decode_window=K)
    check(srv._captures, f"{label}: the server does not capture")
    gen = torch.Generator().manual_seed(5)
    srv.submit(torch.randint(0, dec.cfg.vocab_size, (1, 24), generator=gen),
               2 * K)
    srv.run()
    caps = srv.graph_captures
    check(caps == 1 and srv.graph_replays > 0,
          f"{label}: the warm-up made {caps} captures, "
          f"{srv.graph_replays} replays")
    srv.done.clear()
    replays0 = srv.graph_replays
    with capture_sanitizer(srv) as rep:
        outs, wall, _, card = serve_counted(label, srv, reqs)
    replays = srv.graph_replays - replays0
    check(rep.captures == 0 and srv.graph_captures == caps and replays > 0,
          f"{label}: {replays} replays, captures moved under the "
          f"sanitizer: {rep.deltas}")
    check(card["paged_flash_decode"] == replays * K * L,
          f"{label}: the card ran {card['paged_flash_decode']} "
          f"paged_flash_decode kernels, expected {replays} replays x {K} "
          f"x {L}")
    del srv
    release()
    eager = paged_server(dec, params, mesh=mesh, decode_window=K)
    eager._captures = False
    plain, wall_e, _, _ = serve_counted(label + " eager", eager, reqs)
    check(eager.graph_replays == 0, f"{label}: the eager server replayed")
    del eager
    release()
    for i, (a, b) in enumerate(zip(outs, plain)):
        check(a.equal(b), f"{label}: request {i}'s tokens differ between "
              "the captured and the eager window")
    if ref_outs is not None:
        check(all(a.equal(b) for a, b in zip(outs, ref_outs)),
              f"{label}: the tokens differ from phase 5's")
    tsrv = paged_server(dec, params, mesh=mesh, decode_window=K)
    split = time_tick(steady_window(tsrv, dec.cfg.vocab_size))
    del tsrv
    release()
    generated = sum(n for _, n in reqs)
    return {"tokens_per_s": generated / wall, "eager_tokens_per_s":
            generated / wall_e, "replays": replays,
            "decode_runs": card["paged_flash_decode"],
            "prefill_runs": card["paged_flash_prefill"],
            "split": split, "generated": generated, "layers": L,
            "outs": outs}


def _log_mesh_window(label: str, run: dict, gloo_k4: float) -> None:
    K, sp = MESH_WINDOW, run["split"]
    log(f"serve_sharded: {label}, decode_window={K}, phase 5's knobs and "
        f"mix: captured windows token-identical to the eager window "
        f"(captures forced off) and to phase 5; {run['generated']} tokens "
        f"at {run['tokens_per_s']:.1f} tokens/s captured (after a warm-up "
        f"request, under capture_sanitizer: no capture), "
        f"{run['eager_tokens_per_s']:.1f} eager; {run['replays']} replays, "
        f"paged_flash_decode run on the card {run['decode_runs']} = "
        f"replays x {K} x {run['layers']}; a steady window from depth "
        f"{STEADY_DEPTH}: host {sp['host_ms']:.4f} ms to issue, device "
        f"{sp['device_ms']:.4f} ms, wall {sp['wall_ms']:.4f} ms, idle share "
        f"{sp['idle_share']:.4f}; beside tp 2 on gloo ranks at K={K}: "
        f"{gloo_k4:.1f} tokens/s (windows eager, the same depth)")


def shard_model1_windows(dec, params, paged_res: dict) -> dict:
    """Captured windows on a one-process {"model": 1} mesh
    (`_mesh_window_run`), then sync_sanitizer around one steady greedy
    window of phase 5's one-process server at K=MESH_WINDOW: it may make
    DRAIN_SYNCS synchronizing calls; the count found is printed."""
    import torch

    from defer_tpu_torch.analysis import sync_sanitizer
    from defer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"model": 1}, [torch.device(CARD)])
    run = _mesh_window_run("serve_sharded model1 captured", dec, params,
                           mesh, paged_res["outs"])
    srv = paged_server(dec, params, decode_window=MESH_WINDOW)
    window = steady_window(srv, dec.cfg.vocab_size)
    window()
    torch.cuda.synchronize()
    with sync_sanitizer(allow=DRAIN_SYNCS) as rep:
        srv.step()
    check(rep.active, "serve_sharded: the sync sanitizer did not count")
    log(f"serve_sharded: sync_sanitizer(allow={DRAIN_SYNCS}) around one "
        f"steady greedy window of phase 5's server (K={MESH_WINDOW}, no "
        f"eos, no stop, no streaming): {rep.syncs} synchronizing CUDA "
        "call(s)")
    del srv
    release()
    run["drain_syncs"] = rep.syncs
    return run


def nccl1_rank(port: int, out: str) -> int:
    """Phase serve_sharded's world-size-1 NCCL rank on cuda:0: phase
    decode's weights built here (mistral_bf16), `_mesh_window_run` on a
    {"model": 1} mesh over the NCCL group (its collectives NCCL's, inside
    the captured graphs), the tokens and numbers to `out`."""
    import torch
    import torch.distributed as dist

    from defer_tpu_torch import GptDecoder, mistral_config
    from defer_tpu_torch.parallel import multihost
    from defer_tpu_torch.parallel.mesh import make_mesh

    multihost.initialize(f"tcp://127.0.0.1:{port}", 1, 0, backend="nccl")
    dev = torch.device(CARD)
    torch.cuda.set_device(dev)
    mesh = make_mesh({"model": 1}, [dev])
    check(mesh.distributed and dist.get_backend(mesh.everyone) == "nccl",
          "serve_sharded nccl1: the mesh is not over the NCCL group")
    dec = GptDecoder(mistral_config(), compute_dtype=torch.bfloat16,
                     device=dev)
    params = mistral_bf16(dec)
    run = _mesh_window_run("serve_sharded nccl1 captured", dec, params,
                           mesh, None)
    run["outs"] = [o.tolist() for o in run["outs"]]
    for mod in ("jax", "defer_tpu"):
        check(mod not in sys.modules, f"serve_sharded nccl1 imported {mod}")
    with open(out, "w") as f:
        json.dump(run, f)
    dist.destroy_process_group()
    return 0


def phase_serve_sharded(dec, params, paged_res: dict, decode_res: dict,
                        here: str) -> dict:
    """Phase serve_sharded at Mistral-7B's width and depth on phase 4's
    weights: the paged server on a {"model": 1} mesh; SpmdGptDecoder,
    PagedDecodeServer(mesh=) (SHARD_PAGED) and the fleet's
    model_axis_size=2 replicas on two gloo ranks sharing cuda:0; pp 2 x
    tp 2 on four gloo ranks (PPTP_LAYERS layers); pp_stages=2 in this
    process; the same stages in two serve_pp_stage workers. Each part's
    seconds printed."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    release()
    res = {"tp1": shard_tp1(dec, params, paged_res["outs"])}
    log(f"serve_sharded: tp1 done in {time.perf_counter() - t0:.1f}s")
    release()
    t1 = time.perf_counter()
    out = os.path.join(tempfile.mkdtemp(prefix="sharded-"), "report.json")
    logs = _start_ranks(here, "--sharded-rank", SHARD_TP, out,
                        SHARD_TIMEOUT, "serve_sharded")
    for line in logs[0]:  # the controller's lines
        if line.startswith("serve_sharded"):
            log(line)
    with open(out) as f:
        ranks = json.load(f)
    res.update(ranks["runs"])
    res["peaks"] = ranks["peaks"]
    log(f"serve_sharded: one process: DecodeServer "
        f"{decode_res['tokens_per_s']:.1f} tokens/s (phase 4), "
        f"PagedDecodeServer {paged_res['tokens_per_s']:.1f} (phase 5), its "
        f"steady tick {paged_res['split']['wall_ms']:.3f} ms wall; gloo "
        "ranks sharing one card stage every collective through the host: "
        "these rates are not NCCL's")
    log(f"serve_sharded: tp2 done in {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    gloo_k4 = sum(n for _, n in paged_requests(dec.cfg.vocab_size)) / (
        res["k4"]["wall_s"])
    model1 = shard_model1_windows(dec, params, paged_res)
    model1.pop("outs")
    _log_mesh_window("PagedDecodeServer(mesh={'model': 1}), one process",
                     model1, gloo_k4)
    res["model1"] = model1
    out = os.path.join(tempfile.mkdtemp(prefix="nccl1-"), "report.json")
    logs = _start_ranks(here, "--nccl-rank", 1, out, NCCL1_TIMEOUT,
                        "serve_sharded nccl1")
    with open(out) as f:
        nccl1 = json.load(f)
    check(all(torch.equal(torch.tensor(a, dtype=b.dtype), b.cpu())
              for a, b in zip(nccl1.pop("outs"), paged_res["outs"])),
          "serve_sharded nccl1: the NCCL rank's tokens differ from phase 5's")
    _log_mesh_window("PagedDecodeServer(mesh={'model': 1}) over a "
                     "world-size-1 NCCL group, one spawned rank", nccl1,
                     gloo_k4)
    res["nccl1"] = nccl1
    log(f"serve_sharded: captured mesh windows done in "
        f"{time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    out = os.path.join(tempfile.mkdtemp(prefix="pptp-"), "report.json")
    logs = _start_ranks(here, "--sharded-rank", PPTP_WORLD, out,
                        SHARD_TIMEOUT, "serve_sharded pp x tp", "pptp")
    for line in logs[0]:
        if line.startswith("serve_sharded"):
            log(line)
    with open(out) as f:
        res["pptp"] = json.load(f)
    log(f"serve_sharded: pp x tp done in {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    res["pp"] = shard_pp(dec, params, paged_res["outs"])
    release()
    res["pp_question"] = shard_pp_question(dec, params)
    log(f"serve_sharded: pp done in {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    res["pp_remote"] = shard_pp_remote(dec, params, here, res["pp"])
    res["pp"].pop("outs")
    log(f"serve_sharded: pp_remote done in {time.perf_counter() - t1:.1f}s")
    log(f"serve_sharded: phase done in {time.perf_counter() - t0:.1f}s")
    return res


# -- phase t5: T5-base on the card ----------------------------------------

# T5-base's published widths (t5_config("base")): a batch of T5_BATCH
# inputs of T5_ENC tokens, T5_STEPS greedy tokens through the cached step.
T5_BATCH, T5_ENC, T5_STEPS = 8, 512, 64


def phase_t5() -> dict:
    """T5(t5_config("base")) in bf16 with random weights from T5.init on
    the card: encode a batch, generate greedy tokens with the cached step (no
    flash_attention launch: T5's biased attention is plain matmul and
    softmax), every token held by the split check against a
    teacher-forced f32 forward on the same weights (each token the exact
    argmax of the row the step picked it from, those rows within
    T5_LOGIT_BOUND of the f32 logits); then the encode's ms, one
    cached step's device ms and the host ms a step."""
    import torch

    from defer_tpu_torch.models.t5 import T5, t5_config

    t0 = time.perf_counter()
    cfg = t5_config("base")
    m = T5(cfg, compute_dtype=torch.bfloat16, device=CARD)
    params = m.cast_params(
        m.init(torch.Generator(device=CARD).manual_seed(7)))
    n_params = sum(t.numel() for t in
                   [params[k] for k in params if not k.endswith("stack")]
                   + list(params["enc_stack"].values())
                   + list(params["dec_stack"].values()))
    enc = torch.randint(0, cfg.vocab_size, (T5_BATCH, T5_ENC),
                        generator=torch.Generator().manual_seed(8))
    step = m.make_step()
    rows = []

    def recorded(p, cache, ids):
        logits, out = step(p, cache, ids)
        rows.append(logits[:, -1].float().clone())
        return logits, out

    m._steps[True] = recorded
    torch.cuda.synchronize()
    zero_launches()
    t1 = time.perf_counter()
    out = m.generate(params, enc, T5_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = read_launches()
    m._steps[True] = step
    check(tuple(out.shape) == (T5_BATCH, 1 + T5_STEPS)
          and bool((out[:, 0] == cfg.decoder_start_token_id).all()),
          f"t5: output shape {tuple(out.shape)} or start token")
    check(launches["flash_attention"] == 0,
          f"t5: flash_attention launched {launches['flash_attention']} times")
    served = torch.stack(rows, dim=1)  # [B, steps, V]
    toks = out[:, 1:].long()
    check(len(rows) == T5_STEPS and torch.equal(served.argmax(-1), toks),
          "t5: a token is not the argmax of the row the step picked it from")
    m32 = T5(cfg, compute_dtype=torch.float32, device=CARD)
    p32 = m32.cast_params(params)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            ref = m32.forward(p32, enc, out[:, :-1])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del p32
    err = float((served - ref).abs().max())
    gaps = (ref.amax(-1) - ref.gather(-1, toks[..., None])[..., 0]).flatten()
    log(f"t5: T5(t5_config('base'), bf16): {cfg.num_layers}+{cfg.dec_layers}"
        f" layers, d_model {cfg.dim}, {cfg.num_heads} heads of "
        f"{cfg.head_dim}, FFN {cfg.ffn_dim}, vocab {cfg.vocab_size}, "
        f"{cfg.rel_buckets} buckets to {cfg.rel_max_distance}, "
        f"{cfg.ffn_style}, tied head; {n_params} params; generate over "
        f"{T5_BATCH} x {T5_ENC} tokens, {T5_STEPS} greedy steps, in "
        f"{wall:.3f}s; flash_attention launches 0")
    log(f"t5: each of {toks.numel()} tokens is the exact argmax of the row "
        f"the step picked it from; those rows lie within {err:.4g} of the "
        f"teacher-forced f32 forward (bound {T5_LOGIT_BOUND}); so each "
        f"token's f32 logit is within {2 * err:.4g} of its row's max "
        f"(measured: max {float(gaps.max()):.4g}, {int((gaps > 0).sum())} "
        "tokens not the f32 argmax)")
    check(err <= T5_LOGIT_BOUND,
          f"t5: a served row is {err:.4g} from the f32 forward, beyond the "
          f"bound {T5_LOGIT_BOUND}")
    with torch.no_grad():
        # Few iterations: the host queues them all inside the card's
        # 0.1 s sleep, so the events time the kernels, not the issue.
        encode_ms = cuda_time_ms(lambda: m.encode(params, enc), iters=5,
                                 warmup=2)
        enc_out = m.encode(params, enc)
        cache = m.start_cache(params, enc_out)
        _, cache = m.prefill(params, cache, out[:, :T5_STEPS // 2])
        ids = out[:, T5_STEPS // 2:T5_STEPS // 2 + 1]
        step_ms = cuda_time_ms(lambda: step(params, cache, ids), iters=5)
        host_ms = host_time_us(lambda: step(params, cache, ids),
                               iters=20) / 1e3
    log(f"t5: encode {T5_BATCH} x {T5_ENC} tokens {encode_ms:.4f} ms "
        f"(device, CUDA events); one cached step at depth {T5_STEPS // 2} "
        f"{step_ms:.4f} ms device, {host_ms:.4f} ms host to issue it "
        f"(idle card); phase done in {time.perf_counter() - t0:.1f}s")
    return {"encode_ms": encode_ms, "step_ms": step_ms, "host_ms": host_ms,
            "max_err": err}


# -- phase examples: the example drivers on the card ------------------------

# The timed loops' length a driver (the JAX examples' defaults are 10 and
# 5 minutes); serving_batched's two sessions' seconds each.
EXAMPLE_MINUTES, EXAMPLE_VIT_MINUTES, EXAMPLE_SERVING_S = 0.1, 0.05, 2.0
# A generated token is a valid greedy choice when its teacher-forced
# logit is within this of its row's max: serve_decode --check's bf16 tie
# tolerance.
EXAMPLE_TIE_TOL = 0.08


def drive(name: str, module, *argv: str, params=None) -> tuple:
    """One driver's run() in this process, its printed lines logged under
    `examples <name>:`; returns (its result, its text, its seconds)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = module.run(module.parser().parse_args(list(argv)),
                         params=params)
    dt = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"examples {name}: {line}")
    log(f"examples {name}: {dt:.1f}s")
    return res, text, dt


def stream_gaps(dec, params, ids, start: int):
    """How far below its teacher-forced row's max each token of `ids`
    [1, T] from position `start` on lies (0 for the argmax), on the CPU."""
    logits = dec.reference_logits(params, ids[:, :-1]).float().cpu()
    rows = logits[0, start - 1:]
    return rows.amax(-1) - rows.gather(-1, ids[0, start:, None].cpu())[:, 0]


def phase_examples() -> dict:
    """Phase examples: every single-process driver of
    defer_tpu_torch/examples/ through its run(), at the JAX examples'
    default widths (module docstring), each kernel its path should reach
    counted from 0 over its run and required above 0."""
    import importlib.util

    import torch

    from defer_tpu_torch.examples import (
        distributed_infer,
        generate,
        local_infer,
        long_context,
        pretrained_infer,
        serve_decode,
        serving_batched,
    )
    from defer_tpu_torch.models import get_model
    from defer_tpu_torch.models.gpt import GptDecoder

    t0 = time.perf_counter()
    res = {}
    minutes = str(EXAMPLE_MINUTES)
    local, _, _ = drive("local_infer", local_infer, "--batch", "32",
                        "--synthetic", "--minutes", minutes)
    cuts = ",".join(get_model("resnet50").default_cuts(4))
    pipe, text, _ = drive("distributed_infer", distributed_infer,
                          "--batch", "32", "--synthetic", "--cuts", cuts,
                          "--minutes", minutes)
    check("resnet50: 4 stages over 1 device(s)" in text
          and pipe["count"] > 1,
          "examples distributed_infer: not 4 stages on the card")
    first = pipe["first_output"].float()
    base = local["output"].float()
    gap = float((first - base).abs().max())
    check(tuple(first.shape) == (32, 1000)
          and bool(torch.isfinite(first).all()) and gap <= 1e-3,
          f"examples distributed_infer: the first result is {gap:.3g} from "
          "local_infer's on the same weights (bound 1e-3)")
    # Both rates leave out set-up: local_infer times its loop after a
    # warm-up call, the pipeline's steady rate starts at its first result.
    steady = pipe["steady_images_per_sec"]
    res["resnet50"] = {"local_images_s": local["items_per_sec"],
                       "pipeline_images_s": steady,
                       "pipeline_window_images_s": pipe["images_per_sec"],
                       "ratio": steady / local["items_per_sec"], "gap": gap}
    log(f"examples: ResNet50 batch 32 on one card: local_infer "
        f"{local['items_per_sec']:.2f} images/s (after a warm-up call), "
        f"distributed_infer (4 stages on cuda:0) {steady:.2f} images/s "
        f"from its first result ({pipe['images_per_sec']:.2f} over the "
        f"whole window, set-up included), ratio "
        f"{res['resnet50']['ratio']:.4f}; first results within {gap:.3g}")

    zero_launches()
    vit, _, _ = drive("distributed_infer vit_b16", distributed_infer,
                      "--model", "vit_b16", "--synthetic", "--minutes",
                      str(EXAMPLE_VIT_MINUTES))
    launches = read_launches()["flash_attention"]
    out = vit["first_output"].float()
    check(launches > 0 and tuple(out.shape) == (1, 1000)
          and bool(torch.isfinite(out).all()),
          f"examples vit_b16: flash_attention launched {launches} times")
    res["vit_b16"] = {"images_s": vit["images_per_sec"],
                      "steady_images_s": vit.get("steady_images_per_sec"),
                      "launches": launches}

    # generate --family llama --speculate 4: the plain loop at the
    # defaults, then the speculative run, on weights the phase keeps to
    # hold both greedy streams against a teacher-forced forward.
    argv = ("--family", "llama", "--speculate", "4")
    dec = GptDecoder(generate.config(generate.parser().parse_args(argv)),
                     compute_dtype=torch.bfloat16, device="cuda")
    whole = dec.init(torch.Generator(dec.device).manual_seed(0))
    zero_launches()
    gen, text, _ = drive("generate", generate, *argv, params=whole)
    runs = read_card_runs()["flash_decode"]
    toks = gen["tokens"]
    check(runs > 0 and "steady decode" in text
          and "speculative (k=4" in text and toks.shape == (1, 65)
          and int(toks.min()) >= 0 and int(toks.max()) < 32000,
          f"examples generate: flash_decode ran {runs} times on the card")
    spec = gen["speculative"]
    prompt = gen["prompt"]
    plen = prompt.shape[1]
    params = dec.cast_params(whole)
    plain_gaps = stream_gaps(dec, params, torch.cat([prompt, toks], 1), plen)
    spec_gaps = stream_gaps(dec, params, spec["ids"], plen)
    differ = (spec["ids"][0, plen:] != toks[0, :64]).nonzero()
    same = int(differ[0, 0]) if len(differ) else 64
    parted = (f"at position {same} of 64, where the plain token lies "
              f"{float(plain_gaps[same]):.4f} and the speculative one "
              f"{float(spec_gaps[same]):.4f} below the teacher-forced max"
              if same < 64 else "nowhere")
    worst = max(float(plain_gaps.max()), float(spec_gaps.max()))
    check(worst <= EXAMPLE_TIE_TOL,
          f"examples generate: a greedy token lies {worst:.4f} below its "
          f"teacher-forced max (tie tolerance {EXAMPLE_TIE_TOL})")
    log(f"examples generate: every token of both greedy streams is a valid "
        f"greedy choice (largest gap: plain {float(plain_gaps.max()):.4f}, "
        f"speculative {float(spec_gaps.max()):.4f}; tie tolerance "
        f"{EXAMPLE_TIE_TOL}); the streams part {parted}")
    res["generate"] = {"ms_per_token": gen["ms_per_token"],
                       "spec_ms_per_token": spec["ms_per_token"],
                       "card_runs": runs, "acceptance": spec["acceptance"],
                       "same_as_plain": same, "max_gap": worst}
    del dec, whole, params

    zero_launches()
    srv, text, _ = drive("serve_decode", serve_decode, "--check")
    runs = read_card_runs()["flash_decode"]
    check(runs > 0 and "valid greedy choices" in text,
          f"examples serve_decode: flash_decode ran {runs} times on the card")
    res["serve_decode"] = {"tokens_per_s": srv["tokens_per_s"],
                           "card_runs": runs}

    batching, _, _ = drive("serving_batched", serving_batched, "--seconds",
                           str(EXAMPLE_SERVING_S))
    for mode in ("off", "on"):
        s = batching[mode]
        check(s["completed"] == s["sent"] > 0 and "warning" not in s,
              f"examples serving_batched: batching {mode} {s}")
    res["serving_batched"] = {m: batching[m]["items_per_sec"]
                              for m in ("off", "on")}

    lc, _, _ = drive("long_context", long_context, "--seq", "4096",
                     "--check")
    res["long_context"] = {"ms_per_step": lc["ms_per_step"],
                           "max_abs_err": lc["max_abs_err"]}

    # Offline: no tensorflow on this machine means no checkpoint source;
    # where tensorflow is importable a missing file keeps it offline.
    argv = (() if importlib.util.find_spec("tensorflow") is None
            else ("--weights", os.path.join(os.sep, "nonexistent.h5")))
    pre, text, _ = drive("pretrained_infer", pretrained_infer, *argv)
    check(pre["code"] == 0 and pre["skipped"] and "SKIP:" in text,
          "examples pretrained_infer: no SKIP line offline")
    for mod in ("jax", "defer_tpu"):
        check(mod not in sys.modules, f"examples imported {mod}")
    log(f"examples: phase done in {time.perf_counter() - t0:.1f}s")
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
    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"timing: phase {name} {time.perf_counter() - t0:.1f} s "
            f"(smoke at {time.perf_counter() - t_start:.1f} s)")
        return out

    try:
        card = card_line()
        timed("build", phase_build)
        kernels = timed("kernels", phase_kernels)
        main_res = timed("main", phase_main)
        cnn_res = timed("cnn", phase_cnn)
        timed("socket", phase_socket)
        timed("replicas", phase_replicas, cnn_res)
        timed("keras", phase_keras)
        timed("roofline_checkpoint", phase_roofline_checkpoint, cnn_res)
        train_res = timed("train", phase_train)
        dist_res = timed("dist", phase_dist, here)
        decode_res = timed("decode", phase_decode)
        dec, params = decode_res.pop("dec"), decode_res.pop("params")
        family_res = timed("family", phase_family, dec, params, decode_res)
        paged_res = timed("paged", phase_paged, dec, params,
                          decode_res["weight_bytes"])
        int8_res = timed("int8", phase_int8, dec, params,
                         decode_res["weight_bytes"], paged_res)
        timed("spill", phase_spill, dec, params)
        pfam_res = timed("paged_family", phase_paged_family, dec, params,
                         paged_res, int8_res, here)
        # The steady-tick servers of phases 5 and 6 end here (their
        # pools would sit beside the ranks' and workers' weights).
        for res in (paged_res, int8_res):
            res.pop("srv", None)
            res.pop("tick", None)
        fleet_res = timed("fleet", phase_fleet, dec, params)
        sharded_res = timed("serve_sharded", phase_serve_sharded, dec,
                            params, paged_res, decode_res, here)
        del dec, params
        timed("t5", phase_t5)
        examples_res = timed("examples", phase_examples)
        for name in ("jax", "defer_tpu"):
            check(name not in sys.modules, f"{name} was imported")
    except Exception as e:  # every phase failure ends the run non-zero
        log(f"FAIL: {type(e).__name__}: {e}")
        return 1
    # Each kernel's launches are those of the path that runs it.
    kernels["flash_attention"]["vit"]["launches"] = (
        cnn_res["vit_b16"]["launches"]["flash_attention"])
    kernels["flash_attention"]["gpt2_causal"]["launches"] = (
        train_res["lm"]["launches"])
    # The training paths' launches a step (phase train), the remat step's
    # recompute included.
    kernels["flash_attention"]["train"] = {
        "spmd_forward": train_res["forward"]["launches"],
        "classifier": train_res["classifier"]["launches"],
        "classifier_remat": train_res["classifier"]["remat_launches"],
        **{f"moe_top{k}_{d}": train_res["moe"][f"top{k}"][d]["launches"]
           for k in (1, 2) for d in ("dense", "a2a")},
        "lm": train_res["lm"]["launches"],
        "dpo": train_res["dpo"]["launches"],
        "lora": train_res["lora"]["launches"],
        **{f"dist_{name}": dist_res[name]["launches"]
           for name, *_ in DIST_LAYOUTS},
    }
    path_launches = {
        "flash_attention": main_res["launches"]["flash_attention"],
        "flash_decode": decode_res["launches"]["flash_decode"],
        "paged_flash_decode": paged_res["launches"]["paged_flash_decode"],
        "paged_flash_prefill": paged_res["launches"]["paged_flash_prefill"],
        "paged_flash_decode_int8":
            int8_res["launches"]["paged_flash_decode_int8"],
        "paged_flash_prefill_int8":
            int8_res["launches"]["paged_flash_prefill_int8"],
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
            **{key: k[key] for key in ("deep", "tick", "vit", "gpt2_causal",
                                       "train") if key in k},
        })
        if name == "flash_decode":
            # The decoder family's paths (phase family), each its own
            # run's launches on the card; rolling steps take none.
            report[-1]["family"] = {
                path: family_res[path]["launches"]
                for path in ("window4", "window8", "rolling", "speculative",
                             "constrained", "lora", "beam")
            }
            report[-1]["paged_family"] = {
                f"speculative{K}": pfam_res[f"spec{K}"]["flash_decode_runs"]
                for K in (1, SPEC_WINDOW)
            }
            # The trained GPT-2 small tree served at K=1 (phase train).
            report[-1]["train_serve"] = train_res["lm"]["serve_launches"]
            # The drivers' runs on the card (phase examples).
            report[-1]["examples"] = {
                label: examples_res[label]["card_runs"]
                for label in ("generate", "serve_decode")}
            # SpmdGptDecoder at tp 2, on each rank (phase serve_sharded).
            report[-1]["serve_sharded"] = {
                "flat_tp2_per_rank": sharded_res["flat"]["launches"]}
        if name == "flash_attention":
            # ViT-B/16 through the distributed_infer driver (phase
            # examples).
            report[-1]["examples"] = {
                "distributed_infer_vit_b16":
                    examples_res["vit_b16"]["launches"]}
            # ShardedInference of BERT-base over {"data": 2}, a call, by
            # rank (phase dist); SpmdT5 launches none.
            report[-1]["sharded_inference_by_rank"] = [
                leg["inference"]["launches"]
                for leg in dist_res["sharded_legs"]]
        if name in ("paged_flash_decode", "paged_flash_prefill"):
            # The paged family's paths, each its own run's kernel runs on
            # the card (float and int8 pools together; captured windows'
            # replays included).
            key = ("decode_runs" if name == "paged_flash_decode"
                   else "prefill_runs")
            paths = {f"window{K}_{pool}": pfam_res[f"window{K}_{pool}"]
                     for K, pool in PAGED_WINDOWS}
            paths.update(mixed=pfam_res["mixed"], lora=pfam_res["lora"],
                         **{f"speculative{K}": pfam_res[f"spec{K}"]
                            for K in (1, SPEC_WINDOW)})
            if key == "decode_runs":
                paths.update(constrained=pfam_res["constrained"],
                             **{f"disagg_{w}": pfam_res["disagg"][w]
                                for w in ("thread", "process")})
            paths.update({f"fleet_{p}": fleet_res[p]
                          for p in ("prefix", "round_robin")},
                         fleet_window4=fleet_res["window"])
            report[-1]["paged_family"] = {
                path: run.get(key, 0) for path, run in paths.items()}
            # Phase serve_sharded: the size-1 mesh, each tp 2 path on
            # each rank (the paged server's card runs on one rank; both
            # ranks checked equal), and pp's stages.
            shard = {f"tp2_{label}_per_rank":
                     sharded_res[label]["launches"][name]
                     for label, _ in SHARD_PAGED}
            if name == "paged_flash_prefill":
                shard["pp2"] = sharded_res["pp"]["launches"]
                shard["pp2_inflight1"] = (
                    sharded_res["pp_question"]["launches"])
            # Captured mesh windows at K=4: the one-process {"model": 1}
            # mesh and the world-size-1 NCCL rank (two serves of the mix
            # each; replays included).
            key = ("decode_runs" if name == "paged_flash_decode"
                   else "prefill_runs")
            shard["model1_captured"] = sharded_res["model1"][key]
            shard["nccl1_captured"] = sharded_res["nccl1"][key]
            # The fleet's two model_axis_size=2 replicas on each rank, and
            # pp 2 x tp 2 by rank (each its stage's layers).
            shard["fleet_tp2_per_rank"] = (
                sharded_res["fleet"]["launches"][name])
            shard["pp2_tp2_by_rank"] = [
                run["card"][name] for run in sharded_res["pptp"]["runs"]]
            report[-1]["serve_sharded"] = shard
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
    if sys.argv[1:2] == ["--dist-rank"]:  # one of phase dist's ranks
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(dist_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--sharded-rank"]:  # one of serve_sharded's ranks
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        rank_main = pptp_rank if sys.argv[5:6] == ["pptp"] else sharded_rank
        sys.exit(rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--nccl-rank"]:  # serve_sharded's NCCL rank
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(nccl1_rank(int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--pp-stage"]:  # one of serve_sharded's workers
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(pp_stage_worker(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
