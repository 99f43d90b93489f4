"""Weights and inputs drawn from a run's seed, on the device.

A configuration's reference lists its weights as (name, shape, kind)
(`reference/<config>.py` `param_specs`); the configuration file says how
each kind is drawn (`"init"`):

    {"fan_in": g}         normal, variance g / fan-in (all dims but the last)
    {"mean": m, "std": s} normal
    {"lognormal": s}      exp of a normal of std s (positive, median 1)

Every weight comes out of one `torch.randn` call on the device, scaled
in place, then cast once to the type it is served in. Names are
"<node>.<leaf>", the node names of the program's graph, so `as_tree`
hands the program its tree.

Each stream of random numbers (weights, inputs, arrival order, the
sample of results checked) has its own generator, seeded from the run's
seed through `numpy.random.SeedSequence`, so one can be drawn again
without the others: the reference gets weights and inputs drawn anew on
the device, never the tensors the program was handed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STREAMS = ("weights", "inputs", "arrivals", "sample")


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of a run; any whole-number seed."""
    ss = np.random.SeedSequence(
        [int(seed) & (2**64 - 1), int(seed) >> 64 if seed >= 2**64 else 0,
         STREAMS.index(stream)])
    lo, hi = (int(v) for v in ss.generate_state(2, dtype=np.uint32))
    return ((hi << 32) | lo) >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def draw(
    specs: list[tuple[str, tuple[int, ...], str]],
    init: dict[str, dict],
    seed: int,
    device: torch.device,
    dtype: torch.dtype,
) -> dict[str, torch.Tensor]:
    """{name: tensor} of every weight in `specs`, in `dtype` on
    `device`, the same for the same seed."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights", device),
                       device=device, dtype=torch.float32)
    at = 0
    for (_, shape, kind), n in zip(specs, sizes):
        rule = init[kind]
        part = flat[at:at + n]
        if "fan_in" in rule:
            part.mul_(math.sqrt(float(rule["fan_in"]) / math.prod(shape[:-1])))
        elif "lognormal" in rule:
            part.mul_(float(rule["lognormal"])).exp_()
        else:
            part.mul_(float(rule["std"])).add_(float(rule["mean"]))
        at += n
    served = flat.to(dtype)
    del flat
    return {
        name: piece.view(shape)
        for (name, shape, _), piece in zip(specs, torch.split(served, sizes))
    }


def as_tree(weights: dict[str, torch.Tensor]) -> dict[str, dict[str, torch.Tensor]]:
    """{"node.leaf": t} as the program's {node: {leaf: t}}."""
    tree: dict[str, dict[str, torch.Tensor]] = {}
    for name, t in weights.items():
        node, leaf = name.rsplit(".", 1)
        tree.setdefault(node, {})[leaf] = t
    return tree


def input_entries(
    seed: int, count: int, shape: tuple[int, ...], device: torch.device
) -> list[torch.Tensor]:
    """`count` float32 standard-normal tensors of `shape` on `device`,
    one `torch.randn` call each, the same for the same seed."""
    g = generator(seed, "inputs", device)
    return [torch.randn(shape, generator=g, device=device) for _ in range(count)]


def host_entries(
    seed: int, count: int, shape: tuple[int, ...], device: torch.device,
    pinned: bool,
) -> list[torch.Tensor]:
    """`input_entries` moved to host memory (page-locked if `pinned`),
    drawn one at a time so that the device holds one entry at most."""
    g = generator(seed, "inputs", device)
    out = []
    for _ in range(count):
        t = torch.randn(shape, generator=g, device=device)
        host = torch.empty(shape, dtype=t.dtype, pin_memory=pinned)
        host.copy_(t)
        out.append(host)
    return out
