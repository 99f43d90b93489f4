"""Distributed training example: one step over a dp x pp x tp mesh
(beyond the reference's inference-only scope, SURVEY.md §5; counterpart
of examples/spmd_train.py).

The model axis (and a data axis) run one rank a mesh position; a stage
axis alone runs in one process over [device] * stages:

    # the defaults (--stages 2 --tp 2) on 4 gloo CPU ranks, data = 1
    torchrun --nproc-per-node 4 -m defer_tpu_torch.examples.spmd_train \\
        --steps 5 --device cpu
    # two stages in one process
    python -m defer_tpu_torch.examples.spmd_train --tp 1 --steps 5
"""

from __future__ import annotations

import argparse
import functools
import glob
import os
import time

import torch

from defer_tpu_torch.examples import _launch
from defer_tpu_torch.models.bert import SpmdBert
from defer_tpu_torch.parallel.mesh import make_mesh
from defer_tpu_torch.parallel.train import make_train_step
from defer_tpu_torch.parallel.transformer_stack import TransformerConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument(
        "--ckpt-dir",
        default=None,
        help="save a sharded distributed checkpoint here every "
        "--ckpt-every steps and resume from it if present",
    )
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument(
        "--remat",
        action="store_true",
        help="rematerialize blocks on backward (torch.utils.checkpoint): "
        "O(1)-block activation memory per stage for one extra forward",
    )
    ap.add_argument(
        "--lm",
        action="store_true",
        help="next-token language-model objective (causal stack, "
        "weight-tied head) instead of CLS classification; the trained "
        "tree serves directly on the KV-cache decoder",
    )
    ap.add_argument(
        "--zero1",
        action="store_true",
        help="shard optimizer moments over the data axis (ZeRO-1)",
    )
    ap.add_argument(
        "--fsdp",
        action="store_true",
        help="shard stack weights over the data axis, all-gathered "
        "just in time per block (FSDP)",
    )
    _launch.add_device_flag(ap)
    return ap


def mesh_for(args: argparse.Namespace):
    """(launch, mesh, dp): data = world / (stages * tp) over a process
    group; in one process {"data": 1, "stage": S, "model": 1} over
    [device] * S."""
    world = _launch.world_size()
    per = args.stages * args.tp
    if world == 1 and args.tp == 1:
        launch = _launch.join(1, args, "spmd_train", "")
        mesh = make_mesh({"data": 1, "stage": args.stages, "model": 1},
                         [launch.device] * args.stages)
        return launch, mesh, 1
    ranks = max(world, per) // per * per
    launch = _launch.join(ranks, args, "spmd_train",
                          f"--stages {args.stages} --tp {args.tp} "
                          f"(data = ranks / {per})")
    dp = ranks // per
    mesh = make_mesh({"data": dp, "stage": args.stages, "model": args.tp},
                     launch.devices)
    return launch, mesh, dp


def run(args: argparse.Namespace, *, params=None,
        compute_dtype=None) -> dict:
    """Train --steps steps; returns the losses (floats, every step), the
    first step's batch (on the CPU), tokens/s and whether the state was
    resumed. `params`: a whole tree of the trainer's state (the stack
    stage-stacked [S, L/S, ...]), copied into the fresh state."""
    launch, mesh, dp = mesh_for(args)
    say, dev = launch.print, launch.device
    cfg = TransformerConfig(
        num_layers=args.layers,
        dim=args.dim,
        num_heads=4,
        ffn_dim=4 * args.dim,
        vocab_size=1024,
        max_len=args.seq,
        remat=args.remat,
        norm_style="pre" if args.lm else "post",
        causal=args.lm,
    )
    sb = SpmdBert(mesh, cfg, compute_dtype=compute_dtype or torch.bfloat16,
                  fsdp=args.fsdp)
    # optax.adamw's decay: torch's AdamW defaults to 1e-2.
    adamw = functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-4)
    if args.lm:
        from defer_tpu_torch.parallel.train import make_lm_train_step

        init_state, train_step = make_lm_train_step(sb, adamw,
                                                    zero1=args.zero1)
    else:
        init_state, train_step = make_train_step(
            sb, adamw, num_classes=8, zero1=args.zero1
        )
    state = init_state(torch.Generator(dev).manual_seed(0))
    if params is not None:
        _launch.load_into(state.params, sb.shard_params(params))

    resumed = False
    if args.ckpt_dir and glob.glob(
        os.path.join(args.ckpt_dir, "shards-*.defer")
    ):
        from defer_tpu_torch.runtime.checkpoint import (
            restore_sharded_train_state,
        )

        state = restore_sharded_train_state(args.ckpt_dir, state, sb)
        resumed = True
        say(f"resumed sharded state from {args.ckpt_dir}")

    num_mb = args.stages + 2
    batch = 4 * dp
    # The same draws on every rank: one CPU generator seeded 1.
    draws = torch.Generator().manual_seed(1)
    say(f"mesh dp={dp} pp={args.stages} tp={args.tp}; "
        f"{num_mb} microbatches of {batch}x{args.seq}")

    losses = []
    first = None
    t0 = time.perf_counter()
    for step in range(args.steps):
        ids = torch.randint(0, cfg.vocab_size, (num_mb, batch, args.seq),
                            generator=draws)
        labels = torch.randint(0, 8, (num_mb, batch), generator=draws)
        if first is None:
            first = (ids, labels)
        if args.lm:
            state, loss = train_step(state, ids)
        else:
            state, loss = train_step(state, ids, labels)
        losses.append(loss)
        if step in (0, args.steps - 1) or step % 10 == 0:
            say(f"step {step}: loss {float(loss):.4f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            from defer_tpu_torch.runtime.checkpoint import (
                save_sharded_train_state,
            )

            # The step is the cross-process save id: restore rejects a
            # directory where only some processes finished a save.
            save_sharded_train_state(args.ckpt_dir, state, sb, save_id=step)
            say(f"saved sharded checkpoint at step {step}")
    _launch.sync(dev)
    dt = time.perf_counter() - t0
    tokens = args.steps * num_mb * batch * args.seq
    say(f"{tokens / dt:.0f} tokens/sec over {args.steps} steps")
    res = {"losses": [float(x) for x in losses], "first_batch": first,
           "tokens_per_s": tokens / dt, "resumed": resumed, "dp": dp}
    if args.lm:
        res["served"] = serve_trained(sb, state, cfg, first[0], launch)
    return res


def serve_trained(sb, state, cfg, ids, launch) -> int | None:
    """The trained LM tree, gathered and its stage stack flattened, is
    GptDecoder's: rank 0 serves greedy tokens after a training prompt.
    Returns the tokens served (None on the other ranks)."""
    from defer_tpu_torch.models.gpt import GptDecoder
    from defer_tpu_torch.parallel.spmd_pipeline import unstack_stages

    whole = _launch.detached(sb.gather_params(state.params))
    if launch.rank != 0:
        return None
    tree = {**whole, "stack": unstack_stages(whole["stack"])}
    dec = GptDecoder(cfg, compute_dtype=sb.compute_dtype,
                     device=launch.device)
    steps = min(8, cfg.max_len // 2)
    prompt = ids[0, :1, : cfg.max_len - steps]
    with torch.no_grad():
        out = dec.generate(dec.cast_params(tree), prompt, steps)
    assert tuple(out.shape) == (1, prompt.shape[1] + steps), out.shape
    launch.print(f"served {steps} greedy tokens of the trained tree on "
                 "GptDecoder")
    return steps


def main(argv=None) -> None:
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
