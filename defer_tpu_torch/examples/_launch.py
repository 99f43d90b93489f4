"""What the example drivers share: the `--device` flag, the process
group of a multi-rank launch, rank-0 printing and the timing sync.

A driver runs in one process unless its flags ask for a data, model or
seq axis larger than 1; then it runs under torchrun, one rank a mesh
position:

    torchrun --nproc-per-node 2 -m defer_tpu_torch.examples.generate --tp 2

`join` reads torchrun's environment (parallel/multihost.py
`initialize`). Rank r's device is cuda:(r mod the cards of its host),
or the CPU under `--device cpu`. The backend is NCCL when every rank of
a host has a card of its own, gloo when ranks share a card or run on
the CPU. Asked for N ranks without a process group of N, a driver
raises and names the torchrun command: it never shrinks the mesh.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Mapping

import torch
import torch.distributed as dist

from defer_tpu_torch.parallel import multihost
from defer_tpu_torch.parallel.mesh import cuda_devices

# The JAX examples' image directory, examples/images at the repo root.
IMAGES = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    "examples", "images",
)


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--device",
        default="cuda",
        help='where the driver runs: "cuda" (every card for a pipeline, '
        'cuda:0 otherwise), "cuda:N", or "cpu"; without a card only '
        '"cpu" runs',
    )


def devices(args: argparse.Namespace) -> list[torch.device]:
    """The devices `--device` names: every card for "cuda", raising
    without one, else the one device given."""
    dev = torch.device(args.device)
    if dev.type != "cuda":
        return [dev]
    cards = cuda_devices()
    return cards if dev.index is None else [dev]


def device(args: argparse.Namespace) -> torch.device:
    """The one device a single-process driver runs on."""
    return devices(args)[0]


def world_size() -> int:
    """The size of this run's process group: the joined group's, else
    torchrun's WORLD_SIZE, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def torchrun_hint(module: str, world: int, args: argparse.Namespace) -> str:
    cpu = " --device cpu" if torch.device(args.device).type == "cpu" else ""
    return (f"torchrun --nproc-per-node {world} -m "
            f"defer_tpu_torch.examples.{module} ...{cpu}")


class Launch:
    """This process's place in the run: `rank` (0 alone), `world`,
    `device` (its own) and `devices` (every rank's, by rank)."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 devices: list[torch.device]):
        self.rank, self.world = rank, world
        self.device, self.devices = device, devices

    def print(self, *a: Any, **kw: Any) -> None:
        """print on rank 0 only."""
        if self.rank == 0:
            print(*a, **kw, flush=True)


def join(world: int, args: argparse.Namespace, module: str,
         why: str) -> Launch:
    """Run over `world` ranks: one process for 1, else join torchrun's
    process group of exactly `world` ranks (raising, with the torchrun
    command, when there is none). `why` names the flags that ask."""
    have = world_size()
    if world == 1 and have == 1:
        dev = device(args)
        return Launch(0, 1, dev, [dev])
    if have != world:
        raise RuntimeError(
            f"{why} asks for {world} ranks and this process runs in a "
            f"group of {have}: start it as `{torchrun_hint(module, world, args)}`"
        )
    cpu = torch.device(args.device).type == "cpu"
    if cpu:
        devs = [torch.device("cpu")] * world
        backend = "gloo"
    else:
        cards = cuda_devices()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        devs = [cards[r % len(cards)] for r in range(world)]
        # NCCL refuses two ranks on one card: ranks that share one
        # stage their collectives through the host (gloo).
        backend = "nccl" if len(cards) >= local_world else "gloo"
    if not dist.is_initialized():
        multihost.initialize(backend=backend)
    rank = dist.get_rank()
    dev = devs[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Launch(rank, world, dev, devs)


def sync(dev: torch.device) -> None:
    """Wait for the card before a timer reads the clock (nothing on the
    CPU, where every op has finished when it returns)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load_into(dst: Mapping[str, Any], src: Mapping[str, Any]) -> None:
    """Copy `src`'s leaves into the tensors of `dst` with the same keys,
    in place (the keys of `dst` that `src` has)."""
    with torch.no_grad():
        for k, v in dst.items():
            if k not in src:
                continue
            if isinstance(v, Mapping):
                load_into(v, src[k])
            else:
                v.copy_(src[k])


def detached(tree: Mapping[str, Any]) -> dict:
    """A tree of the same tensors, detached from autograd."""
    return {k: detached(v) if isinstance(v, Mapping) else v.detach()
            for k, v in tree.items()}


def require_pil(what: str) -> None:
    """Raise, naming --synthetic, when PIL is not importable: the image
    feed decodes with it, and a driver never switches feeds by itself."""
    import importlib.util

    if importlib.util.find_spec("PIL") is None:
        raise RuntimeError(
            f"{what} decodes real images with PIL, which is not "
            "importable here; pass --synthetic to feed ones instead"
        )
