"""Training through the stage pipeline (counterpart of
`defer_tpu/parallel/train.py`): classification fine-tuning, next-token
LM training and DPO on `SpmdBert`'s forward.

The JAX package jits one step that differentiates through the whole
pipelined program and applies an optax update to a donated state. Here
a step is eager: the microbatches stream through the stages
(`parallel/spmd_pipeline.py`), their losses average, autograd runs the
backward through the same loop (flash attention's backward recomputes
through its plain version, as the JAX package's custom VJP does), and a
`torch.optim` optimizer updates the f32 master parameters in place.

  * `optimizer` is a factory over a parameter list in place of an
    `optax.GradientTransformation`, e.g.
    `functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-4)`.
    torch and optax Adam share their formula (eps outside the sqrt);
    `optax.adamw` decays with 1e-4 where `torch.optim.AdamW` defaults
    to 1e-2, and both decay every leaf they are given.
  * `train_step(state, *batch) -> (state, loss)` updates `state` in
    place and returns it (the JAX step donates its state); the loss, or
    DPO's (loss, accuracy), stays a tensor on the device: the step makes
    no host sync.
  * over a process group (one rank per mesh position) the optimizer is
    a `MeshOptimizer`: after the backward it sums each stack parameter's
    gradient over the axes that split the batch or the sequence ("data",
    "seq"), where each rank holds its share, so the update is the JAX
    package's on the global-batch loss (`reduce_gradients`).
    `zero1=True` also splits each AdamW moment over "data" as
    `zero1_shardings` does: each data rank steps its slice of every
    parameter and all-gathers the result, numerically the replicated
    update. On a mesh without a data axis larger than 1 it is the JAX
    package's no-op.

A `TrainState` checkpoints through `runtime/checkpoint.py`
(`save_train_state` / `load_train_state`): params, the optimizer's
`state_dict()` and the step; over a process group, sharded a rank
(`save_sharded_train_state` / `restore_sharded_train_state`, reading
`MeshOptimizer.state_specs`).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from defer_tpu_torch.models.bert import SpmdBert
from defer_tpu_torch.parallel import collectives
from defer_tpu_torch.parallel.transformer_stack import (
    _layer_norm,
    _rms_norm,
    first_free_divisible_dim,
    normal,
)

OptimizerFactory = Callable[[list], torch.optim.Optimizer]


class TrainState(NamedTuple):
    """params: nested dict of f32 leaf tensors (the trainable ones with
    requires_grad); opt_state: the optimizer over them; step: an int64
    count on the params' device."""

    params: Any
    opt_state: torch.optim.Optimizer
    step: torch.Tensor


def tree_leaves(tree: Any) -> list:
    """Leaves of a nested dict in sorted-key order (the JAX package's
    tree order): the order the optimizer holds the parameters in."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


@torch.no_grad()
def reduce_gradients(leaves: list, specs: list, mesh, axes) -> None:
    """Sum over the mesh axes in `axes` (those that split the batch or
    the sequence) the gradient of each leaf the pipeline reads inside
    the split region (a leaf placed on the "stage" axis: the stack) and
    that is not itself split over the axis, leaf by leaf in order. Its
    gradient on a rank is that rank's share of the global-batch loss's
    (`collectives.shard`); a leaf read outside the region (embeddings,
    heads) has a whole gradient on every rank already, and one split
    over the axis (FSDP) had its shares summed by the all-gather's
    reduce-scatter."""
    for leaf, spec in zip(leaves, specs):
        if leaf.grad is None or "stage" not in spec:
            continue
        for axis in axes:
            if axis not in spec:
                collectives.all_reduce_(leaf.grad, mesh.group(axis))


class MeshOptimizer:
    """The optimizer of a training state over a process group: the
    gradient reduction of `reduce_gradients`, then the update; with
    zero1 each leaf with a free dim that the data axis divides (the JAX
    package's `zero1_shardings` rule, first_free_divisible_dim) is
    stepped as this data rank's slice, whose moments alone the inner
    optimizer holds, and all-gathered back. The state_dict is the inner
    optimizer's."""

    def __init__(self, leaves: list, specs: list, mesh, axes,
                 optimizer: OptimizerFactory, zero1: bool):
        self.leaves, self.specs, self.mesh, self.axes = (
            leaves, specs, mesh, axes)
        self._index = {id(leaf): i for i, leaf in enumerate(leaves)}
        dp = mesh.shape.get("data", 1)
        index = mesh.coords.get("data", 0)
        self.slices = []  # (leaf, its slice that the optimizer steps, dim)
        stepped = []
        for leaf, spec in zip(leaves, specs):
            dim = (first_free_divisible_dim(spec, leaf.shape, dp)
                   if zero1 and dp > 1 and "data" not in spec else None)
            if dim is None:
                stepped.append(leaf)
                continue
            c = leaf.shape[dim] // dp
            part = leaf.detach().narrow(dim, index * c, c).clone()
            self.slices.append((leaf, part.requires_grad_(True), dim))
            stepped.append(part)
        self.inner = optimizer(stepped)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for leaf in self.leaves:
            leaf.grad = None
        self.inner.zero_grad(set_to_none=set_to_none)

    def step(self, closure=None):
        reduce_gradients(self.leaves, self.specs, self.mesh, self.axes)
        dp = self.mesh.shape.get("data", 1)
        index = self.mesh.coords.get("data", 0)
        for leaf, part, dim in self.slices:
            c = part.shape[dim]
            with torch.no_grad():  # the leaf may have been loaded since
                part.copy_(leaf.narrow(dim, index * c, c))
            part.grad = leaf.grad.narrow(dim, index * c, c).contiguous()
        self.inner.step()
        with torch.no_grad():
            group = self.mesh.group("data") if self.slices else None
            for leaf, part, dim in self.slices:
                leaf.copy_(collectives.gather_dim(part, group, dp, dim))

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    def state_specs(self) -> list:
        """The placement of each parameter the inner optimizer steps, in
        its order, so its moments checkpoint sharded
        (runtime/checkpoint.py `save_sharded_train_state`): a leaf's own
        spec, and a ZeRO-1 slice's with "data" on the dim it was cut
        along."""
        cut = {id(part): (leaf, dim) for leaf, part, dim in self.slices}
        out = []
        for p in (q for g in self.inner.param_groups for q in g["params"]):
            if id(p) in cut:
                leaf, dim = cut[id(p)]
                spec = list(self.specs[self._index[id(leaf)]])
                spec += [None] * (leaf.ndim - len(spec))
                spec[dim] = "data"
                out.append(tuple(spec))
            else:
                out.append(tuple(self.specs[self._index[id(p)]]))
        return out

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state)


def _new_state(params: dict, optimizer: OptimizerFactory, sb,
               zero1: bool = False) -> TrainState:
    """Mark every leaf trainable and build the optimizer over them: a
    MeshOptimizer when sb's mesh is over a process group."""
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    if sb.mesh.distributed:
        specs = tree_leaves(sb.param_specs(params))
        opt = MeshOptimizer(leaves, specs, sb.mesh, sb.split_axes,
                            optimizer, zero1)
    else:
        opt = optimizer(leaves)
    return TrainState(
        params=params,
        opt_state=opt,
        step=torch.zeros((), dtype=torch.int64, device=leaves[0].device),
    )


def apply_update(state: TrainState, loss: torch.Tensor) -> None:
    """One optimizer update from `loss`: backward, step, count. No host
    sync: the optimizer's own step counts stay where it keeps them."""
    state.opt_state.zero_grad(set_to_none=True)
    loss.backward()
    state.opt_state.step()
    state.step.add_(1)


def make_classifier_params(
    generator: torch.Generator, sb: SpmdBert, num_classes: int
) -> dict:
    """Classification head on the pooled output, on sb's device."""
    dev = sb.device
    return {
        "cls_w": normal(generator, (sb.cfg.dim, num_classes),
                        sb.cfg.dim**-0.5, device=dev),
        "cls_b": torch.zeros((num_classes,), device=dev),
    }


def classifier_loss(forward, params: dict, head: dict, ids, labels):
    """Mean CLS cross-entropy over [M, B]: f32 logits of the pooled
    output, `forward(params, ids)` -> [M, B, D]."""
    pooled = forward(params, ids)
    logits = pooled.float() @ head["cls_w"] + head["cls_b"]
    labels = labels.to(logits.device, torch.int64)
    return F.cross_entropy(logits.flatten(0, 1), labels.flatten())


def make_train_step(
    sb: SpmdBert,
    optimizer: OptimizerFactory,
    *,
    num_classes: int,
    zero1: bool = False,
) -> tuple[Callable, Callable]:
    """Returns (init_state, train_step).

    init_state(generator, extra_params=None) -> TrainState: sb.init
    plus the classifier head, drawn from `generator`.

    train_step(state, ids [M, B, S], labels [M, B]) -> (state, loss):
    the microbatches stream through the pipeline, their CLS losses
    average, and one optimizer update applies: M microbatches of
    gradient accumulation in one step. zero1 splits the optimizer's
    moments over "data" (module docstring)."""
    forward = sb.make_step()

    def init_state(generator: torch.Generator,
                   extra_params: dict | None = None) -> TrainState:
        params = sb.init(generator)
        params.update(make_classifier_params(generator, sb, num_classes))
        if extra_params:
            params.update(extra_params)
        return _new_state(params, optimizer, sb, zero1)

    def train_step(state: TrainState, ids, labels):
        loss = classifier_loss(forward, state.params, state.params, ids,
                               labels)
        apply_update(state, loss)
        return state, loss.detach()

    return init_state, train_step


def _init_lm_params(sb: SpmdBert, generator: torch.Generator) -> dict:
    """GptDecoder-keyed LM parameter tree from an SpmdBert init: the
    classifier pooler dropped, the final pre-LN norm the weight-tied head
    reads added; shared by the LM and DPO factories."""
    dev = sb.device
    params = {k: v for k, v in sb.init(generator).items()
              if k not in ("pooler_w", "pooler_b")}
    params["final_ln_scale"] = torch.ones((sb.cfg.dim,), device=dev)
    if sb.cfg.norm_type == "layer":
        params["final_ln_bias"] = torch.zeros((sb.cfg.dim,), device=dev)
    return params


def _lm_logits(sb: SpmdBert, params: dict, ids: torch.Tensor,
               hidden=None) -> torch.Tensor:
    """The pipelined LM forward both objectives share: hidden states ->
    final pre-LN norm -> weight-tied head, f32 logits [M, B, S, V]."""
    cfg = sb.cfg
    hidden = hidden or sb.make_hidden_step()
    h = hidden(params, ids).float()
    if cfg.norm_type == "rms":
        h = _rms_norm(h, params["final_ln_scale"], cfg.layer_norm_eps)
    else:
        h = _layer_norm(h, params["final_ln_scale"],
                        params["final_ln_bias"], cfg.layer_norm_eps)
    return h @ params["token_embedding"].float().T


def sequence_logprobs(
    sb: SpmdBert, params: dict, ids: torch.Tensor, mask: torch.Tensor,
    hidden=None,
) -> torch.Tensor:
    """Per-sequence sum of next-token log-probabilities over the masked
    region: ids [M, B, S], mask [M, B, S] (1 where position t's token,
    predicted from t-1, counts; position 0 never can). Returns [M, B]
    f32, from the same forward make_lm_train_step trains."""
    ids = ids.to(sb.device, torch.int64)
    logp = torch.log_softmax(_lm_logits(sb, params, ids, hidden)[..., :-1, :],
                             dim=-1)
    tok_lp = logp.gather(-1, ids[..., 1:, None])[..., 0]
    return (tok_lp * mask[..., 1:].to(tok_lp)).sum(dim=-1)


def _check_lm(sb: SpmdBert, name: str) -> None:
    if not sb.cfg.causal:
        raise ValueError(
            f"{name} needs cfg.causal=True — a bidirectional stack "
            "leaks each next token to the position predicting it"
        )
    if sb.cfg.norm_style != "pre":
        raise ValueError(
            f"{name} needs cfg.norm_style='pre': the final norm + "
            "weight-tied head follow GptDecoder's pre-LN convention, and "
            "a post-norm tree could not serve on the KV-cache decoder"
        )


def make_lm_train_step(
    sb: SpmdBert,
    optimizer: OptimizerFactory,
    *,
    zero1: bool = False,
) -> tuple[Callable, Callable]:
    """Next-token language-model training through the pipeline.

    train_step(state, ids [M, B, S]) -> (state, loss): hidden states ->
    final norm -> weight-tied head (token_embedding.T, GptDecoder's
    convention), shifted cross-entropy (position t predicts t+1, mean
    over the first S-1 positions). The trained tree has GptDecoder's key
    set, so with the stage stack flattened (`unstack_stages`) it serves
    on the KV-cache decoder. Needs cfg.causal and norm_style "pre"."""
    _check_lm(sb, "make_lm_train_step")
    hidden = sb.make_hidden_step()

    def init_state(generator: torch.Generator) -> TrainState:
        return _new_state(_init_lm_params(sb, generator), optimizer, sb,
                          zero1)

    def train_step(state: TrainState, ids):
        ids = ids.to(sb.device, torch.int64)
        logits = _lm_logits(sb, state.params, ids, hidden)
        loss = F.cross_entropy(logits[..., :-1, :].flatten(0, -2),
                               ids[..., 1:].flatten())
        apply_update(state, loss)
        return state, loss.detach()

    return init_state, train_step


def make_dpo_train_step(
    sb: SpmdBert,
    optimizer: OptimizerFactory,
    *,
    beta: float = 0.1,
    zero1: bool = False,
) -> tuple[Callable, Callable]:
    """Direct Preference Optimization through the pipeline.

    train_step(state, ref_params, chosen, rejected, mask_c, mask_r) ->
    (state, (loss, accuracy)): chosen/rejected are [M, B, S] id blocks
    sharing each pair's prompt, the masks mark the completions, and the
    loss is -log sigmoid(beta * ((pi_c - ref_c) - (pi_r - ref_r))). The
    reference scores come from the frozen `ref_params` under
    torch.no_grad(). Chosen and rejected stack on the batch axis, so a
    step pays two pipeline passes (policy, reference), not four.
    `accuracy` is the share of pairs the policy orders correctly."""
    _check_lm(sb, "make_dpo_train_step")
    hidden = sb.make_hidden_step()

    def init_state(generator: torch.Generator) -> TrainState:
        return _new_state(_init_lm_params(sb, generator), optimizer, sb,
                          zero1)

    def train_step(state: TrainState, ref_params, chosen, rejected,
                   mask_c, mask_r):
        b = chosen.shape[1]
        both = torch.cat([chosen, rejected], dim=1)
        mboth = torch.cat([mask_c, mask_r], dim=1).to(sb.device)
        pi = sequence_logprobs(sb, state.params, both, mboth, hidden)
        with torch.no_grad():
            ref = sequence_logprobs(sb, ref_params, both, mboth, hidden)
        margin = beta * ((pi[:, :b] - ref[:, :b]) - (pi[:, b:] - ref[:, b:]))
        loss = -F.logsigmoid(margin).mean()
        acc = (margin > 0).float().mean()
        apply_update(state, loss)
        return state, (loss.detach(), acc.detach())

    return init_state, train_step
