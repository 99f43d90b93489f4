"""Autoregressive generation demo: KV-cache decode, optionally
tensor-parallel (counterpart of examples/generate.py).

    # one card
    python -m defer_tpu_torch.examples.generate --steps 32
    # tensor-parallel over 4 ranks (gloo CPU ranks here)
    torchrun --nproc-per-node 4 -m defer_tpu_torch.examples.generate \\
        --tp 4 --steps 32 --device cpu

Prints prefill latency, per-token decode latency, and tokens/sec: the
numbers a serving deployment cares about. (Random weights: the tokens
are noise; the machinery is the demo.)
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from defer_tpu_torch.examples import _launch
from defer_tpu_torch.models.gpt import (
    GptDecoder,
    SpmdGptDecoder,
    repetition_penalty,
    sample_token,
    seen_tokens_mask,
)
from defer_tpu_torch.parallel.mesh import make_mesh
from defer_tpu_torch.parallel.transformer_stack import TransformerConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--ffn", type=int, default=2048)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--min-p", type=float, default=0.0)
    ap.add_argument("--rep-penalty", type=float, default=1.0)
    ap.add_argument(
        "--family",
        choices=("gpt", "llama"),
        default="gpt",
        help="llama = RMSNorm + rotary + grouped-query attention + "
        "SwiGLU (biasless), with the KV cache sized by --kv-heads",
    )
    ap.add_argument(
        "--kv-heads",
        type=int,
        default=None,
        help="GQA kv head count, any family (llama default: heads/4; "
        "gpt default: MHA)",
    )
    ap.add_argument(
        "--speculate",
        type=int,
        default=0,
        metavar="K",
        help="after the plain loop, run greedy speculative decoding "
        "with a 1-layer draft proposing K tokens per target forward "
        "(needs --tp 1 --batch 1)",
    )
    _launch.add_device_flag(ap)
    return ap


def config(args: argparse.Namespace) -> TransformerConfig:
    if args.family == "llama":
        from defer_tpu_torch.models.llama import llama_config

        return llama_config(
            num_layers=args.layers,
            dim=args.dim,
            num_heads=args.heads,
            num_kv_heads=args.kv_heads or max(1, args.heads // 4),
            ffn_dim=args.ffn,
            vocab_size=args.vocab,
            max_len=args.max_len,
        )
    # GQA is a shared-stack knob, not llama-exclusive: honor --kv-heads
    # here too instead of silently ignoring it.
    return TransformerConfig(
        num_layers=args.layers,
        dim=args.dim,
        num_heads=args.heads,
        num_kv_heads=args.kv_heads,
        ffn_dim=args.ffn,
        vocab_size=args.vocab,
        max_len=args.max_len,
        norm_style="pre",
    )


def run(args: argparse.Namespace, *, params=None,
        compute_dtype=None) -> dict:
    """The prefill, the steady decode loop and (--speculate) the
    speculative run; returns their timings, the prompt and the tokens
    (on the CPU). `params`: a whole GptDecoder tree (each rank keeps its
    shards under --tp)."""
    if args.prompt_len + args.steps + 1 > args.max_len:
        raise SystemExit(
            f"--prompt-len {args.prompt_len} + --steps {args.steps} + 1 "
            f"exceeds --max-len {args.max_len}: the cache would clamp and "
            "benchmark degenerate work"
        )
    launch = _launch.join(args.tp, args, "generate", f"--tp {args.tp}")
    say = launch.print
    dev = launch.device
    cd = compute_dtype or torch.bfloat16
    cfg = config(args)
    # Serving storage: params in the compute dtype (decode reads every
    # weight per token: fp32 storage would double the memory traffic).
    if args.tp > 1:
        mesh = make_mesh({"model": args.tp}, launch.devices)
        dec = SpmdGptDecoder(cfg, compute_dtype=cd, mesh=mesh)
        whole = (params if params is not None
                 else dec.init(torch.Generator(dev).manual_seed(0)))
        params = dec.shard_params(dec.cast_params(whole))
        say(f"tensor-parallel decode over {args.tp} ranks "
            f"({_kind(dev)})")
    else:
        dec = GptDecoder(cfg, compute_dtype=cd, device=dev)
        whole = (params if params is not None
                 else dec.init(torch.Generator(dev).manual_seed(0)))
        params = dec.cast_params(whole)
        say(f"single-device decode ({_kind(dev)})")

    prompt = torch.randint(
        0, args.vocab, (args.batch, args.prompt_len),
        generator=torch.Generator().manual_seed(1),
    ).to(dev)
    step = dec.make_step()
    cache = dec.init_cache(args.batch)

    t0 = time.perf_counter()
    logits, cache = step(params, cache, prompt)
    _launch.sync(dev)
    t_prefill = time.perf_counter() - t0

    gen = torch.Generator(dev).manual_seed(7)
    seen = (
        seen_tokens_mask(prompt, logits.shape[-1])
        if args.rep_penalty != 1.0
        else None
    )
    rows = torch.arange(args.batch, device=dev)

    def pick(logits_last, seen):
        lg = logits_last[:, -1, :]
        if seen is not None:
            lg = repetition_penalty(lg, seen, args.rep_penalty)
        tok = sample_token(
            lg,
            gen,
            args.temperature,
            top_k=args.top_k,
            top_p=args.top_p,
            min_p=args.min_p,
        )
        if seen is not None:
            seen[rows, tok] = True
        return tok[:, None].to(prompt.dtype), seen

    nxt, seen = pick(logits, seen)
    toks = [nxt]
    t0 = time.perf_counter()
    logits, cache = step(params, cache, nxt)
    _launch.sync(dev)
    t_first_decode = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(args.steps):
        nxt, seen = pick(logits, seen)
        toks.append(nxt)
        logits, cache = step(params, cache, nxt)
    _launch.sync(dev)
    dt = time.perf_counter() - t0

    per_tok = dt / args.steps
    say(
        f"prefill({args.prompt_len} tok) incl. first call: "
        f"{t_prefill * 1e3:.0f} ms; first decode call: "
        f"{t_first_decode * 1e3:.0f} ms"
    )
    say(
        f"steady decode: {per_tok * 1e3:.2f} ms/token, "
        f"{args.batch / per_tok:,.1f} tokens/sec"
        f" (batch {args.batch})"
    )
    res = {
        "prefill_ms": t_prefill * 1e3,
        "ms_per_token": per_tok * 1e3,
        "tokens_per_s": args.batch / per_tok,
        "prompt": prompt.cpu(),
        # the first pick and the --steps picks of the timed loop
        "tokens": torch.cat(toks, dim=1).cpu(),
    }

    if args.speculate and args.tp == 1 and args.batch == 1:
        res["speculative"] = speculate(args, cfg, dec, params, prompt, cd,
                                       dev)
    elif args.speculate:
        say("--speculate needs --tp 1 and --batch 1; skipped")
    return res


def speculate(args, cfg, dec, params, prompt, cd, dev) -> dict:
    """Greedy (or sampled) speculative decoding with a 1-layer random
    draft proposing --speculate tokens a target forward."""
    from defer_tpu_torch.models.speculative import speculative_generate

    if args.rep_penalty != 1.0:
        print(
            "note: --rep-penalty is not applied on the speculative "
            "path (its acceptance math covers the filtered softmax "
            "policy only), so the two decodes sample different "
            "policies"
        )
    # Draft shape: derive heads first, then round dim up to a multiple
    # so the head split always divides.
    d_heads = max(1, args.heads // 4)
    d_dim = -(-max(32, args.dim // 4) // d_heads) * d_heads
    draft_cfg = dataclasses.replace(
        cfg, num_layers=1, dim=d_dim,
        num_heads=d_heads,
        num_kv_heads=None,
        ffn_dim=max(64, args.ffn // 4),
    )
    draft = GptDecoder(draft_cfg, compute_dtype=cd, device=dev)
    dparams = draft.cast_params(draft.init(torch.Generator(dev).manual_seed(1)))
    keep = cfg.max_len - args.steps - args.speculate
    if keep < 1:
        raise SystemExit(
            f"--speculate {args.speculate} + --steps {args.steps} "
            f"leaves no prompt room in --max-len {cfg.max_len}"
        )
    short = prompt[:, : min(args.prompt_len, keep)]
    t0 = time.perf_counter()
    out, stats = speculative_generate(
        dec, params, draft, dparams, short, args.steps,
        k=args.speculate,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        min_p=args.min_p,
        generator=torch.Generator(dev).manual_seed(7),
    )
    _launch.sync(dev)
    dt = time.perf_counter() - t0
    print(
        f"speculative (k={args.speculate}, 1-layer random draft): "
        f"{stats['target_steps']} target forwards for "
        f"{stats['plain_steps']} tokens, acceptance "
        f"{stats['acceptance']:.2f}, {dt / args.steps * 1e3:.2f} "
        "ms/token incl. first calls (random drafts agree rarely; a "
        "trained draft is where the win comes from)"
    )
    return {**stats, "ms_per_token": dt / args.steps * 1e3,
            "ids": out.cpu()}


def _kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> None:
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
