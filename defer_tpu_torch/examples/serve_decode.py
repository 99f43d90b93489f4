"""Continuous-batching decode serving demo (counterpart of
examples/serve_decode.py).

A stream of generation requests with mixed prompt lengths and step
counts is served through a fixed set of batch slots: requests admit
into free slots mid-flight (bucketed prefill + K/V lane insertion)
and every decode tick advances ALL active requests through one weight
read (runtime/decode_server.py). Compare against the per-request
baseline the reference's serving model implies (one stream at a time,
reference src/test.py:30-41).

    python -m defer_tpu_torch.examples.serve_decode --family llama \\
        --requests 16 --slots 4
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from defer_tpu_torch.examples import _launch
from defer_tpu_torch.models.gpt import GptDecoder
from defer_tpu_torch.parallel.transformer_stack import (
    TransformerConfig,
    init_stack,
)
from defer_tpu_torch.runtime.decode_server import DecodeServer


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--family", choices=("gpt", "llama"), default="llama")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--ffn", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prefix", type=int, default=0,
                    help="shared system-prompt length: its K/V rows "
                    "are prefilled once and reused by every admission")
    ap.add_argument("--adapters", type=int, default=0,
                    help="multi-LoRA: attach this many random adapter "
                    "banks and round-robin requests across them "
                    "(id 0 = base model)")
    ap.add_argument("--stop-demo", action="store_true",
                    help="multi-token stop sequences: learn a 2-token "
                    "stop from request 0's greedy stream, re-serve it "
                    "with that stop and show it terminates mid-budget "
                    "with its output ending in the stop sequence")
    ap.add_argument("--check", action="store_true",
                    help="verify the echoed prompt comes back verbatim "
                    "and every generated token is a valid greedy choice "
                    "under a tie tolerance (see the comment at the "
                    "check site for why exact solo-decode equality is "
                    "ill-conditioned at this scale)")
    _launch.add_device_flag(ap)
    return ap


def config(args: argparse.Namespace) -> TransformerConfig:
    if args.family == "llama":
        from defer_tpu_torch.models.llama import llama_config

        return llama_config(
            num_layers=args.layers, dim=args.dim, num_heads=args.heads,
            num_kv_heads=max(1, args.heads // 4), ffn_dim=args.ffn,
            vocab_size=args.vocab, max_len=args.max_len,
        )
    return TransformerConfig(
        num_layers=args.layers, dim=args.dim, num_heads=args.heads,
        ffn_dim=args.ffn, vocab_size=args.vocab,
        max_len=args.max_len, norm_style="pre",
    )


def adapter_trees(cfg: TransformerConfig, n: int, dev) -> tuple:
    """n random rank-8 adapters on wq and wv: (their lora config, their
    trees). Adapter a draws from a generator seeded 100 + a: its `a`
    factors as init_stack draws them, then random `b` factors (a fresh
    adapter's are zero) in sorted key order."""
    from defer_tpu_torch.parallel.lora import is_lora_key

    lora_cfg = dataclasses.replace(
        cfg, lora_rank=8, lora_alpha=16.0, lora_targets=("wq", "wv"),
    )
    trees = []
    for a in range(n):
        gen = torch.Generator(dev).manual_seed(100 + a)
        full = init_stack(gen, lora_cfg, device=dev)
        trees.append({"stack": {
            k: (full[k] if k.endswith(":a")
                else torch.randn(full[k].shape, generator=gen,
                                 device=dev) * 0.02)
            for k in sorted(k for k in full if is_lora_key(k))
        }})
    return lora_cfg, trees


def run(args: argparse.Namespace, *, params=None,
        compute_dtype=None) -> dict:
    """Serve the mix; returns the rate, the tick counts, the requests
    ([1, T] prompts and step budgets, on the CPU), each request's output
    (on the CPU) and --check's count."""
    if args.prefix and args.adapters:
        raise SystemExit(
            "--prefix and --adapters are mutually exclusive (the "
            "shared prefix K/V would be adapter-dependent)"
        )
    dev = _launch.device(args)
    cfg = config(args)
    dec = GptDecoder(cfg, compute_dtype=compute_dtype or torch.bfloat16,
                     device=dev)
    if params is None:
        params = dec.init(torch.Generator(dev).manual_seed(0))
    params = dec.cast_params(params)

    adapter_of = lambda i: 0  # noqa: E731 — overridden below
    if args.adapters:
        from defer_tpu_torch.parallel.lora import stack_adapters

        lora_cfg, trees = adapter_trees(cfg, args.adapters, dev)
        params = stack_adapters(params, trees, lora_cfg)
        adapter_of = lambda i: i % (args.adapters + 1)  # noqa: E731

    # Mixed workload: prompt lengths 4..67, steps 8..39.
    draws = torch.Generator().manual_seed(1)
    reqs = []
    for i in range(args.requests):
        t0 = 4 + (i * 9) % 64
        steps = 8 + (i * 13) % 32
        prompt = torch.randint(0, args.vocab, (1, t0), generator=draws)
        reqs.append((prompt, steps))

    prefix = None
    if args.prefix:
        prefix = torch.randint(0, args.vocab, (1, args.prefix),
                               generator=torch.Generator().manual_seed(2))
    srv = DecodeServer(
        dec, params, max_batch=args.slots, prefix_ids=prefix
    )
    rids = [
        srv.submit(p.to(dev), s, adapter_id=adapter_of(i))
        for i, (p, s) in enumerate(reqs)
    ]
    t0 = time.perf_counter()
    done = srv.run()
    _launch.sync(dev)
    dt = time.perf_counter() - t0
    total_tokens = sum(s for _, s in reqs)
    print(
        f"{args.requests} requests / {args.slots} slots: "
        f"{total_tokens} tokens in {dt:.2f}s "
        f"({total_tokens / dt:,.1f} tok/s), {srv.ticks} batched ticks "
        f"vs {srv.solo_steps} solo steps "
        f"({srv.solo_steps / max(1, srv.ticks):.1f}x tick sharing)"
        + (
            f", {srv.prefix_len * len(reqs)} prefill tokens reused"
            if args.prefix
            else ""
        )
    )
    outs = [done[rid].cpu() for rid in rids]
    res = {"tokens_per_s": total_tokens / dt, "ticks": srv.ticks,
           "solo_steps": srv.solo_steps, "requests": reqs, "outputs": outs,
           "prefix": prefix}

    if args.stop_demo:
        p0, s0 = reqs[0]
        gen0 = outs[0][0, p0.shape[1]:]
        if len(gen0) < 4:
            print("stop-demo: request 0 too short to demo, skipping")
        else:
            # The pair at generated positions 1-2 is (one of) the
            # earliest 2-token windows, so serving with it as a stop
            # sequence must terminate at or before position 2.
            stop = [int(gen0[1]), int(gen0[2])]
            srv2 = DecodeServer(
                dec, params, max_batch=args.slots, prefix_ids=prefix
            )
            rid = srv2.submit(
                p0.to(dev), s0, adapter_id=adapter_of(0), stop=[stop]
            )
            out = srv2.run()[rid][0].cpu()
            emitted = len(out) - p0.shape[1]
            assert emitted < s0, (emitted, s0)
            assert out[-2:].tolist() == stop, (out[-2:], stop)
            print(
                f"stop-demo: stop={stop} terminated request 0 after "
                f"{emitted} of {s0} budgeted tokens, output ends "
                "with the stop sequence"
            )
            res["stop_emitted"] = emitted

    if args.check:
        res["checked"] = check_greedy(dec, params, reqs, outs, prefix, adapter_of)
    return res


def check_greedy(dec, params, reqs, outs, prefix, adapter_of) -> int:
    """Every base-model request's echoed prompt comes back verbatim and
    each generated token is a valid greedy choice.

    Token-level equality with a solo decode is ill-conditioned at this
    scale: random weights leave near-ties everywhere in a 32k-vocab
    softmax, and the bucketed/offset prefill computes the same math in
    different shapes, so low-order float bits legitimately flip argmax
    at a tie (the unit tests pin exact equality at tiny scale, where it
    is stable). The meaningful any-scale contract: every emitted token
    must be a valid greedy choice, its teacher-forced reference logit
    within a tie tolerance of the max."""
    tol = 0.08  # generous for bf16 compute
    checked = 0
    for i, ((p, s), out) in enumerate(zip(reqs, outs)):
        if adapter_of(i) != 0:
            # reference_logits carries no adapter id, so greedy validity
            # can only be checked for base-model requests (the unit
            # tests pin tenant exactness at small scale).
            continue
        # The echoed prompt must come back verbatim: greedy validity
        # below only covers the generated tail.
        assert torch.equal(out[:, : p.shape[1]], p), (
            f"request {i}: the echoed prompt differs"
        )
        full = torch.cat([prefix, out], dim=1) if prefix is not None else out
        logits = dec.reference_logits(params, full[:, :-1]).float().cpu()
        t_gen0 = full.shape[1] - s  # first generated position
        rows = logits[0, t_gen0 - 1: t_gen0 - 1 + s]
        toks = full[0, t_gen0: t_gen0 + s]
        gaps = rows.amax(-1) - rows.gather(-1, toks[:, None])[:, 0]
        j = int(gaps.argmax())
        gap = float(gaps[j])
        assert gap <= tol, (
            f"request {i}: token {j} (id {int(toks[j])}) is {gap:.3f} "
            "below the greedy max — not a valid greedy choice"
        )
        checked += s
    print(
        f"all {checked} generated tokens are valid greedy choices "
        f"(tie tolerance {tol})"
    )
    return checked


def main(argv=None) -> None:
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
