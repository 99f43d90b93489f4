"""LoRA fine-tuning, end to end: freeze a base model, train adapters
only, checkpoint them, merge, and serve the merged model (counterpart of
examples/finetune_lora.py).

The full adapter lifecycle on the SPMD machinery:

  1. build a "pretrained" base (random here; swap in a transplanted
     checkpoint in practice) with a lora_rank > 0 config;
  2. train ONLY the adapter factors + task head on a synthetic
     classification task (the optimizer state is adapter-sized, the
     base tree is never touched): over a {"data": 2, "stage": 2} mesh
     of 4 ranks under torchrun, or {"stage": 1} in one process, with
     FSDP optionally sharding the frozen base weights too;
  3. save the adapter-only tree (what a fine-tune actually ships);
  4. merge w + scale * a @ b and run the merged, adapter-free model.

    python -m defer_tpu_torch.examples.finetune_lora --steps 30 --rank 8
    torchrun --nproc-per-node 4 -m defer_tpu_torch.examples.finetune_lora \\
        --steps 30 --rank 8 --fsdp --device cpu
"""

from __future__ import annotations

import argparse
import functools
import os
import tempfile
import time

import torch

from defer_tpu_torch.examples import _launch
from defer_tpu_torch.models.bert import SpmdBert
from defer_tpu_torch.parallel.lora import (
    combine_lora,
    make_lora_train_step,
    merge_lora,
)
from defer_tpu_torch.parallel.mesh import make_mesh
from defer_tpu_torch.parallel.train import tree_leaves
from defer_tpu_torch.parallel.transformer_stack import TransformerConfig
from defer_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint

# The mesh of a multi-rank run, as the JAX example's on 4 or more devices.
RANKS_AXES = {"data": 2, "stage": 2}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--ffn", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=16.0)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--fsdp", action="store_true",
                    help="shard the frozen base weights over the data "
                    "axis too (all-gathered per block)")
    _launch.add_device_flag(ap)
    return ap


def run(args: argparse.Namespace, *, params=None,
        compute_dtype=None) -> dict:
    """Fine-tune, checkpoint, merge and score; returns the losses, the
    batch (on the CPU), the parameter counts and the merged model's
    accuracy. `params`: a whole tree with the base, the adapter factors
    and the head (cls_w, cls_b), copied into the fresh state."""
    world = _launch.world_size()
    axes = RANKS_AXES if world > 1 else {"stage": 1}
    n = 4 if world > 1 else 1
    launch = _launch.join(n, args, "finetune_lora", f"the mesh {axes}")
    say, dev = launch.print, launch.device
    mesh = make_mesh(axes, launch.devices)

    cfg = TransformerConfig(
        num_layers=args.layers, dim=args.dim, num_heads=args.heads,
        ffn_dim=args.ffn, vocab_size=args.vocab, max_len=64,
        lora_rank=args.rank, lora_alpha=args.alpha,
        lora_targets=("wq", "wv", "w1", "w2"),
    )
    cd = compute_dtype or torch.float32
    sb = SpmdBert(mesh, cfg, compute_dtype=cd, fsdp=args.fsdp)
    init_state, train_step = make_lora_train_step(
        sb, functools.partial(torch.optim.Adam, lr=args.lr),
        num_classes=args.classes,
    )
    state, base = init_state(torch.Generator(dev).manual_seed(0))
    if params is not None:
        whole = sb.shard_params(params)
        _launch.load_into(state.params, whole)
        _launch.load_into(base, whole)

    def count(tree) -> int:
        return sum(t.numel() for t in tree_leaves(sb.gather_params(tree)))

    n_train, n_base = count(state.params), count(base)
    say(
        f"trainable {n_train:,} params ({100 * n_train / n_base:.2f}% "
        f"of the {n_base:,}-param frozen base), mesh={axes}"
        + (", base FSDP-sharded" if args.fsdp else "")
    )

    # Synthetic task: class = hash bucket of the first token.
    mb, b, s = 2, 4, 16
    ids = torch.randint(0, args.vocab, (mb, b, s),
                        generator=torch.Generator().manual_seed(1))
    labels = ids[..., 0] % args.classes

    t0 = time.perf_counter()
    losses = []
    for _ in range(args.steps):
        state, loss = train_step(state, base, ids, labels)
        losses.append(loss)
    losses = [float(x) for x in losses]
    dt = time.perf_counter() - t0
    say(
        f"{args.steps} adapter steps in {dt:.2f}s: loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}"
    )
    assert losses[-1] < losses[0], "fine-tune failed to reduce loss"

    # Ship the adapters: checkpoint only the trainable tree (whole: the
    # file is one rank's, a stand-in for what a fine-tune ships).
    trained = _launch.detached(sb.gather_params(state.params))
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "adapters.ckpt")
        save_checkpoint(path, trained)
        size_kb = os.path.getsize(path) / 1024
        restored = load_checkpoint(path, device=dev)
    say(f"adapter checkpoint: {size_kb:.1f} KiB (base not included)")

    # Merge for serving: adapter-free tree at base-model cost.
    tuned = combine_lora(sb.gather_params(base), restored)
    merged = merge_lora(tuned, cfg)
    cfg0 = TransformerConfig(
        num_layers=args.layers, dim=args.dim, num_heads=args.heads,
        ffn_dim=args.ffn, vocab_size=args.vocab, max_len=64,
    )
    sb0 = SpmdBert(mesh, cfg0, compute_dtype=cd)
    with torch.no_grad():
        pooled = sb0.make_step()(
            sb0.shard_params(
                {k: v for k, v in merged.items() if not k.startswith("cls_")}
            ),
            ids,
        )
        logits = pooled.float() @ restored["cls_w"] + restored["cls_b"]
    acc = float((logits.argmax(-1).cpu() == labels).float().mean())
    say(f"merged-model train accuracy: {acc:.2f}")
    assert acc > 0.5, "merged model lost the fine-tune"
    say("finetune_lora OK")
    return {"losses": losses, "batch": (ids, labels), "n_train": n_train,
            "n_base": n_base, "accuracy": acc, "checkpoint_kib": size_kb}


def main(argv=None) -> None:
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
