"""Long-context attention demo: ring vs Ulysses sequence parallelism
(counterpart of examples/long_context.py).

The reference has no notion of a sequence axis at all (SURVEY.md §5);
this driver shows the framework's long-context path: a sequence far
too big for one device's O(S^2) score matrix, sharded over a `seq`
mesh axis of one rank a position, attended with ring attention (K/V
blocks rotating between ranks with a streaming-softmax accumulator) or
Ulysses (all_to_all to head-sharding and back), and checked against
the unsharded reference when it fits.

    # one process (a seq axis of 1)
    python -m defer_tpu_torch.examples.long_context --seq 4096 --check
    # 8 gloo CPU ranks
    torchrun --nproc-per-node 8 -m defer_tpu_torch.examples.long_context \\
        --seq 8192 --strategy ring --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from defer_tpu_torch.examples import _launch
from defer_tpu_torch.parallel.mesh import make_mesh
from defer_tpu_torch.parallel.sequence import make_sharded_attention


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--strategy", choices=["ring", "ulysses"], default="ring")
    ap.add_argument("--causal", action="store_true")
    ap.add_argument(
        "--check",
        action="store_true",
        help="compare against unsharded attention (needs the full S^2 "
        "score matrix on one device: only for small --seq)",
    )
    _launch.add_device_flag(ap)
    return ap


def run(args: argparse.Namespace, *, params=None,
        compute_dtype=None) -> dict:
    """Attention over a seq axis as wide as the process group; returns
    ms a step, tokens/s, q/k/v and the output (on the CPU) and, with
    --check, the largest error against the unsharded reference."""
    n = _launch.world_size()
    if args.seq % n:
        raise SystemExit(f"--seq {args.seq} must divide by {n} ranks")
    launch = _launch.join(n, args, "long_context", f"a seq axis of {n}")
    say, dev = launch.print, launch.device
    mesh = make_mesh({"seq": n}, launch.devices)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say(
        f"{args.strategy} attention over {n} ranks "
        f"({kind}); S={args.seq} "
        f"(S_local={args.seq // n}), H={args.heads}, Dh={args.head_dim}"
    )

    shape = (args.batch, args.heads, args.seq, args.head_dim)
    cd = compute_dtype or torch.bfloat16
    # The same draws on every rank: one CPU generator seeded 0.
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen).to(dev, cd)
               for _ in range(3))

    attn = make_sharded_attention(
        mesh, strategy=args.strategy, causal=args.causal
    )
    with torch.no_grad():
        out = attn(q, k, v)  # warm-up
        _launch.sync(dev)
        t0 = time.perf_counter()
        iters = 5
        for _ in range(iters):
            out = attn(q, k, v)
        _launch.sync(dev)
    dt = (time.perf_counter() - t0) / iters
    toks = args.batch * args.seq
    say(
        f"{dt * 1e3:.1f} ms/step, {toks / dt:,.0f} tokens/sec; "
        f"score matrix never materialized "
        f"({args.seq}^2 x {args.heads} heads would be "
        f"{args.seq**2 * args.heads * 4 / 1e9:.1f} GB in fp32)"
    )
    res = {"ms_per_step": dt * 1e3, "tokens_per_s": toks / dt,
           "q": q.cpu(), "k": k.cpu(), "v": v.cpu(), "out": out.cpu()}

    if args.check:
        from defer_tpu_torch.ops.attention import attention_reference

        with torch.no_grad():
            want = attention_reference(q.float(), k.float(), v.float(),
                                       causal=args.causal)
            err = float((out.float() - want).abs().max())
        say(f"max abs err vs unsharded reference: {err:.4f}")
        assert err < 0.05, "sequence-parallel attention diverged"
        say("matches unsharded reference")
        res["max_abs_err"] = err
    return res


def main(argv=None) -> None:
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
