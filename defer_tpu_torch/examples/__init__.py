"""The example drivers on the port: one module for each of the JAX
package's `examples/*.py`, with the same name, flags and printed lines.

    python -m defer_tpu_torch.examples.local_infer --model resnet50 --minutes 1
    python -m defer_tpu_torch.examples.distributed_infer --synthetic --cuts add_2,add_4,add_6
    python -m defer_tpu_torch.examples.generate --family llama --speculate 4
    torchrun --nproc-per-node 2 -m defer_tpu_torch.examples.generate --tp 2

Every module adds one flag, `--device` (default "cuda"): without a card
a driver raises unless given `--device cpu`. Each module's work sits
behind `run(args, *, params=None, compute_dtype=None) -> dict`, which
returns the numbers it prints; `main(argv=None)` parses the flags and
calls it. `params` replaces the seeded random init (a tree in the
layout the driver builds), `compute_dtype` the JAX example's compute
dtype. A driver whose flags ask for a data, model or seq axis larger
than 1 runs under `torchrun --nproc-per-node N` (`_launch.py`).
"""

MODULES = (
    "local_infer",
    "distributed_infer",
    "serving_batched",
    "pretrained_infer",
    "generate",
    "serve_decode",
    "long_context",
    "spmd_train",
    "finetune_lora",
)
