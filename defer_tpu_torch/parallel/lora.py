"""LoRA adapters: fine-tuning, split, merge and multi-tenant banks.

Counterpart of `defer_tpu/parallel/lora.py`.
Adapter factors live inside the stacked param tree (`{target}:a`
[L, in, r] / `{target}:b` [L, r, out], transformer_stack.init_stack):

  * `merge_lora` folds `w + scale * a @ b` into the base weights and
    drops the factor keys, so a single fine-tuned model serves at base
    cost;
  * `stack_adapters` attaches N adapter trees as banks
    ({t}:a [L, A+1, in, r], {t}:b [L, A+1, r, out], id 0 the zero
    adapter) for multi-LoRA serving: `GptDecoder` gathers each batch
    row's bank by the slot's adapter id (`cache["adapter"]`), and
    `DecodeServer.submit(adapter_id=)` picks it.

`make_lora_train_step` fine-tunes a classifier on `SpmdBert` with the
base tree frozen (requires_grad=False, so no base gradient is ever
built) and an optimizer over the adapters and the head alone, on any
mesh SpmdBert takes (under tp the factors split like their base weights,
`transformer_stack.stack_specs`; over "data" their gradients sum as
every trainer's do, `train.MeshOptimizer`).
"""

from __future__ import annotations

from typing import Callable

import torch


def is_lora_key(name: str) -> bool:
    return name.endswith(":a") or name.endswith(":b")


def split_lora(params: dict) -> tuple[dict, dict]:
    """Partition a param tree into (frozen base, adapters): adapter
    leaves are the `{target}:a` / `{target}:b` entries of "stack"; both
    halves keep the nesting, so `combine_lora` is a dict merge."""
    base = {k: v for k, v in params.items() if k != "stack"}
    stack = params.get("stack", {})
    base["stack"] = {k: v for k, v in stack.items() if not is_lora_key(k)}
    lora = {"stack": {k: v for k, v in stack.items() if is_lora_key(k)}}
    return base, lora


def combine_lora(base: dict, lora: dict) -> dict:
    """Inverse of split_lora: one tree the stack forward consumes."""
    out = {k: v for k, v in base.items() if k != "stack"}
    out["stack"] = {**base.get("stack", {}), **lora.get("stack", {})}
    return out


def merge_lora(params: dict, cfg) -> dict:
    """Fold every adapter into its base weight, w <- w + scale * a @ b
    (in f32, cast back to w's dtype), and drop the factor keys: the
    same keys a lora_rank=0 init_stack gives."""
    scale = cfg.lora_scale
    stack = dict(params.get("stack", {}))
    for key in [k for k in stack if k.endswith(":a")]:
        target = key[:-2]
        a = stack.pop(key)
        b = stack.pop(f"{target}:b")
        w = stack[target]
        delta = torch.einsum("...ir,...ro->...io", a.float(), b.float())
        stack[target] = (w.float() + scale * delta).to(w.dtype)
    out = {k: v for k, v in params.items() if k != "stack"}
    out["stack"] = stack
    return out


def stack_adapters(params: dict, adapter_trees: list, cfg) -> dict:
    """Attach N adapter trees (split_lora halves of one lora config) as
    banks on a new adapter axis, {t}:a [L, A+1, in, r] and
    {t}:b [L, A+1, r, out], with id 0 the zero adapter (the base
    model). cfg.lora_scale is folded into the stored b factors, so a
    row's delta is exactly merge_lora's for its adapter id."""
    if not adapter_trees:
        raise ValueError("no adapter trees")
    keys = sorted(k for k in adapter_trees[0]["stack"] if k.endswith(":a"))
    if not keys:
        raise ValueError("adapter trees carry no ':a' factors")
    for tree in adapter_trees[1:]:
        if sorted(k for k in tree["stack"] if k.endswith(":a")) != keys:
            raise ValueError(
                "adapter trees disagree on targets: all tenants must "
                "come from the same lora config"
            )
    scale = cfg.lora_scale
    stack = dict(params["stack"])
    for key in keys:
        t = key[:-2]
        a = torch.stack([tree["stack"][key] for tree in adapter_trees], 1)
        b = torch.stack(
            [tree["stack"][f"{t}:b"] for tree in adapter_trees], 1
        ) * scale
        stack[key] = torch.cat([torch.zeros_like(a[:, :1]), a], 1)
        stack[f"{t}:b"] = torch.cat([torch.zeros_like(b[:, :1]), b], 1)
    return {**params, "stack": stack}


def adapter_bank_info(params: dict) -> int | None:
    """None when `params` carries no adapter factors; the bank count
    A+1 when stacked banks ([L, A+1, in, r]) are attached; a ValueError
    for unmerged 3-D training factors."""
    stack = params.get("stack", {})
    bank = next((v for k, v in stack.items() if k.endswith(":a")), None)
    if bank is None:
        return None
    if bank.ndim != 4:
        raise ValueError(
            f"params carry unmerged LoRA factors (shape "
            f"{tuple(bank.shape)}): merge_lora them for single-adapter "
            "serving, or stack_adapters for multi-tenant banks "
            "[L, A, in, r]"
        )
    return int(bank.shape[1])


def make_lora_train_step(
    sb, optimizer, *, num_classes: int
) -> tuple[Callable, Callable]:
    """LoRA counterpart of train.make_train_step. Returns
    (init_state, train_step):

      * init_state(generator) -> (state, base): state.params holds only
        the trainable leaves (adapter factors + classifier head), the
        optimizer covers just those; `base` is the frozen tree, its
        leaves requires_grad=False (reuse a pretrained checkpoint here).
      * train_step(state, base, ids [M, B, S], labels [M, B]) ->
        (state, loss): gradients flow through the whole pipelined
        forward but only into the trainable leaves.

    sb.cfg.lora_rank must be > 0 (init_stack then creates the factors
    this splits on)."""
    from defer_tpu_torch.parallel.train import (
        _new_state,
        apply_update,
        classifier_loss,
        make_classifier_params,
        tree_leaves,
    )

    if not sb.cfg.lora_rank:
        raise ValueError(
            "make_lora_train_step needs cfg.lora_rank > 0 — with no "
            "adapter keys in the stack there is nothing to train"
        )
    forward = sb.make_step()

    def init_state(generator: torch.Generator):
        base, trainable = split_lora(sb.init(generator))
        trainable.update(make_classifier_params(generator, sb, num_classes))
        for t in tree_leaves(base):
            t.requires_grad_(False)
        return _new_state(trainable, optimizer, sb), base

    def train_step(state, base: dict, ids, labels):
        loss = classifier_loss(forward, combine_lora(base, state.params),
                               state.params, ids, labels)
        apply_update(state, loss)
        return state, loss.detach()

    return init_state, train_step
