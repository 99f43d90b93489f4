"""The homogeneous transformer stack: config, parameters, the encoder
block and its mixture-of-experts FFN (counterpart of
`defer_tpu/parallel/transformer_stack.py`).

`TransformerConfig` with every field and validation; `init_stack` with
the JAX package's key set (GQA, biases, rms norms, swiglu, the MoE keys
router [L, D, E] / w1 [L, E, D, F] / b1 / w2 [L, E, F, D] / b2, LoRA
factors {t}:a [L, in, r] / {t}:b [L, r, out], b zero); `block_apply`
(post- and pre-LN, GQA, rope, LoRA projections, gelu / swiglu / MoE FFN)
and `layers_apply` (the blocks of one stage, each rematerialized under
`torch.utils.checkpoint` when cfg.remat); both MoE dispatches, dense
(`moe_ffn`) and capacity-bounded all-to-all (`moe_ffn_a2a`, with the
Switch-style drops), on one routing (`_route_topk`); `embed_lookup`,
the norms with f32 statistics, and rotary embeddings, which the
KV-cache decoder (`models/gpt.py`) shares. Parameters are plain nested
dicts of tensors with a leading [L] layer axis, keyed as the JAX
package keys them, so `weights.params_from_jax` maps one tree onto the
other.

Every collective of the JAX stack goes through one call
(`parallel/collectives.py`, on torch.distributed): `psum` (the tp
partial sums of wo / w2 and inside the experts, the ep sums of both
dispatches), `pvary` (the entry of a replicated value into a computation
split over "model" or "expert": JAX's implicit pvary, whose transpose is
the psum of its gradient), `all_to_all` (the a2a dispatch's two routes),
`all_gather` (FSDP's just-in-time weights), `axis_size` / `axis_index`,
and sequence-parallel attention (`multi_head_attention`'s sp_axis,
`parallel/sequence.py`). Each is the identity at an axis the model does
not shard over (passed as None). `stack_specs` gives the placement of
every leaf as a tuple of mesh axis names a dim (the JAX package's
PartitionSpecs), `fsdp_plan` / `fsdp_specs` FSDP's, and `shard_tree` /
`gather_tree` take a full tree to this rank's slices and back (the JAX
package's `device_put` on NamedShardings).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from defer_tpu_torch.ops.attention import (
    _merge_heads,
    _split_heads,
    attention_reference,
    multi_head_attention,
)
from defer_tpu_torch.parallel import collectives
from defer_tpu_torch.parallel.collectives import (
    all_gather,
    all_to_all,
    axis_index,
    axis_size,
    psum,
    pvary,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    num_layers: int = 12
    dim: int = 768
    num_heads: int = 12
    ffn_dim: int = 3072
    vocab_size: int = 30522
    max_len: int = 512
    layer_norm_eps: float = 1e-12
    # > 0 switches every block's FFN to a routed mixture of experts.
    num_experts: int = 0
    # "post" = BERT-style residual-then-norm; "pre" = GPT-style
    # norm-then-sublayer.
    norm_style: str = "post"
    # Causal (decoder-style) attention masking.
    causal: bool = False
    # Sliding-window (Mistral-style) causal attention: each position
    # attends at most `window` predecessors. None = full causal.
    window: int | None = None
    remat: bool = False
    moe_dispatch: str = "dense"
    capacity_factor: float = 1.25
    moe_top_k: int = 1
    # -- llama-family knobs -------------------------------------------
    # Grouped-query attention: K/V project to this many heads. None = MHA.
    num_kv_heads: int | None = None
    norm_type: str = "layer"  # "layer" | "rms"
    ffn_style: str = "gelu"  # "gelu" | "swiglu"
    pos_style: str = "learned"  # "learned" table | "rope"
    use_bias: bool = True
    rope_theta: float = 10000.0
    # -- LoRA ---------------------------------------------------------
    lora_rank: int = 0
    lora_targets: tuple = ("wq", "wv")
    lora_alpha: float | None = None

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def lora_scale(self) -> float:
        if not self.lora_rank:
            return 0.0
        if self.lora_alpha is None:
            return 1.0
        return self.lora_alpha / self.lora_rank

    def __post_init__(self):
        if self.num_heads % self.kv_heads:
            raise ValueError(
                f"num_kv_heads={self.kv_heads} must divide "
                f"num_heads={self.num_heads}"
            )
        if self.ffn_style == "swiglu" and self.num_experts:
            raise ValueError("swiglu MoE blocks are not supported")
        if self.window is not None and (
            self.window < 1 or not self.causal
        ):
            raise ValueError(
                f"window={self.window} needs causal=True and window >= 1"
            )
        if self.capacity_factor <= 0:
            raise ValueError(
                f"capacity_factor={self.capacity_factor} must be > 0 "
                "(non-positive values would silently drop almost every "
                "token to the residual path)"
            )
        if self.num_experts and not (
            1 <= self.moe_top_k <= self.num_experts
        ):
            raise ValueError(
                f"moe_top_k={self.moe_top_k} must be in "
                f"[1, num_experts={self.num_experts}]"
            )
        if self.lora_rank:
            if self.lora_rank < 1:
                raise ValueError(f"lora_rank={self.lora_rank} must be >= 1")
            valid = {"wq", "wk", "wv", "wo", "w1", "w2"}
            if self.ffn_style == "swiglu":
                valid.add("w3")
            if self.num_experts:
                valid -= {"w1", "w2"}
            bad = set(self.lora_targets) - valid
            if bad:
                raise ValueError(
                    f"lora_targets {sorted(bad)} not adaptable for this "
                    f"config (valid: {sorted(valid)})"
                )
            if not self.lora_targets:
                raise ValueError("lora_rank set but lora_targets is empty")
        for field, allowed in (
            ("norm_style", ("post", "pre")),
            ("norm_type", ("layer", "rms")),
            ("ffn_style", ("gelu", "swiglu")),
            ("pos_style", ("learned", "rope")),
            ("moe_dispatch", ("dense", "a2a")),
        ):
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(
                    f"{field}={v!r}: must be one of {allowed}"
                )


# Adapter targets whose base weight is row-parallel under tp.
_ROW_PARALLEL = frozenset({"wo", "w2"})


def lora_target_dims(cfg: TransformerConfig) -> dict:
    """(in_dim, out_dim) for every projection an adapter can target."""
    D, F = cfg.dim, cfg.ffn_dim
    dkv = cfg.kv_heads * (D // cfg.num_heads)
    dims = {
        "wq": (D, D),
        "wk": (D, dkv),
        "wv": (D, dkv),
        "wo": (D, D),
        "w1": (D, F),
        "w2": (F, D),
    }
    if cfg.ffn_style == "swiglu":
        dims["w3"] = (D, F)
    return dims


def normal(gen, shape, scale, dtype=torch.float32, device=None):
    """scale * N(0, 1) draws of `shape` from `gen`, on `device` (the
    generator's own when None)."""
    return torch.randn(
        shape, generator=gen, dtype=dtype, device=device or gen.device
    ).mul_(scale)


def init_stack(
    generator: torch.Generator,
    cfg: TransformerConfig,
    dtype: Any = torch.float32,
    device: torch.device | str | None = None,
) -> dict:
    """Parameters for L stacked dense blocks, leading axis = layer, drawn
    from `generator` on `device` (the generator's own device when None).

    The key set follows the config as in the JAX package: GQA narrows
    wk/wv to the KV head width, use_bias=False drops every b*,
    norm_type="rms" drops the norm biases, and ffn_style="swiglu" adds
    the w3 up-projection; lora_rank > 0 adds {t}:a [L, in, r] (scaled
    in**-0.5) and a zero {t}:b [L, r, out] per target, so a fresh
    adapter changes nothing; num_experts > 0 replaces the dense FFN
    with a router [L, D, E] and per-expert w1 [L, E, D, F], b1, w2
    [L, E, F, D] (scaled F**-0.5) and b2. The draws have the JAX
    package's distributions, not its values: torch and JAX generators
    differ."""
    device = generator.device if device is None else torch.device(device)
    L, D, F = cfg.num_layers, cfg.dim, cfg.ffn_dim
    dkv = cfg.kv_heads * (D // cfg.num_heads)
    s = D**-0.5

    def draw(shape, scale):
        return normal(generator, shape, scale, dtype, device)

    def const(value, shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    p = {
        "wq": draw((L, D, D), s),
        "wk": draw((L, D, dkv), s),
        "wv": draw((L, D, dkv), s),
        "wo": draw((L, D, D), s),
        "ln1_scale": const(1.0, (L, D)),
        "ln2_scale": const(1.0, (L, D)),
    }
    if cfg.use_bias:
        p.update(
            bq=const(0.0, (L, D)),
            bk=const(0.0, (L, dkv)),
            bv=const(0.0, (L, dkv)),
            bo=const(0.0, (L, D)),
        )
    if cfg.norm_type == "layer":
        p.update(ln1_bias=const(0.0, (L, D)), ln2_bias=const(0.0, (L, D)))
    if cfg.ffn_style == "swiglu":
        p["w3"] = draw((L, D, F), s)
    if cfg.num_experts:
        E = cfg.num_experts
        p.update(
            router=draw((L, D, E), s),
            w1=draw((L, E, D, F), s),
            b1=const(0.0, (L, E, F)),
            w2=draw((L, E, F, D), F**-0.5),
            b2=const(0.0, (L, E, D)),
        )
    else:
        p["w1"] = draw((L, D, F), s)
        p["w2"] = draw((L, F, D), F**-0.5)
        if cfg.use_bias:
            p["b1"] = const(0.0, (L, F))
            p["b2"] = const(0.0, (L, D))
    if cfg.lora_rank:
        r = cfg.lora_rank
        dims = lora_target_dims(cfg)
        for t in cfg.lora_targets:
            din, dout = dims[t]
            p[f"{t}:a"] = draw((L, din, r), din**-0.5)
            p[f"{t}:b"] = const(0.0, (L, r, dout))
    return p


def embed_lookup(
    table: Any, ids: torch.Tensor, tp_axis: str | None = None
) -> torch.Tensor:
    """Token-embedding gather. Plain [V, D] tables gather directly;
    int8 weight-only tables ({"q", "s"}, models/quant.py) gather the
    int8 rows and widen only the gathered [B, T, D] slice to f32. With
    `tp_axis` set (under the active mesh) the table is vocab-ROW sharded
    (Megatron): this rank owns rows [v0, v0 + V_local), ids outside them
    contribute zeros, and one psum assembles the full embeddings."""
    quant = isinstance(table, dict) and "q" in table
    rows = table["q"] if quant else table
    if tp_axis is None:
        emb = rows[ids]
        if quant:
            emb = emb.float() * table["s"]
        return emb
    v_local = rows.shape[0]
    local = ids - axis_index(tp_axis) * v_local
    in_range = (local >= 0) & (local < v_local)
    emb = rows[local.clamp(0, v_local - 1)]
    if quant:
        emb = emb.float() * table["s"]
    emb = torch.where(in_range[..., None], emb, torch.zeros_like(emb))
    return psum(emb, tp_axis)


def _layer_norm(x, scale, bias, eps):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _rms_norm(x, scale, eps):
    """Scale-only RMS normalization (llama), f32 statistics."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)


def norm_apply(cfg: TransformerConfig, x, p: dict, which: str):
    """The config's normalization ("ln1"/"ln2" param group)."""
    if cfg.norm_type == "rms":
        return _rms_norm(x, p[f"{which}_scale"], cfg.layer_norm_eps)
    return _layer_norm(
        x, p[f"{which}_scale"], p[f"{which}_bias"], cfg.layer_norm_eps
    )


def rope_tables(
    head_dim: int, positions: torch.Tensor, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin, (B or 1, T, 1, Dh/2) f32, for absolute `positions`
    of shape (T,) (shared by the batch) or (B, T) (one row per slot).
    A decoder step computes them once and rotates q and k of every
    layer with them."""
    half = head_dim // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device)
        * 2.0
        / head_dim
    )
    ang = positions.float()[..., None] * freqs  # (..., T, half)
    if ang.ndim == 2:  # shared positions -> add the batch axis
        ang = ang[None]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(
    x_flat: torch.Tensor, head_dim: int, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Rotate-half rotary embedding of a flat (B, T, H*Dh) projection
    with tables from `rope_tables`."""
    b, t, d = x_flat.shape
    x = x_flat.reshape(b, t, d // head_dim, head_dim)
    half = head_dim // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x_flat.dtype).reshape(b, t, d)


def apply_rope(
    x_flat: torch.Tensor,
    head_dim: int,
    positions: torch.Tensor,
    theta: float,
) -> torch.Tensor:
    """Rotary position embedding on a flat (B, T, H*Dh) projection.

    Rotate-half pairing (first half with second half), as HF's llama.
    `positions` are the absolute positions of the T tokens: (T,) shared
    across the batch, or (B, T) per batch element (continuous batching,
    where every slot sits at its own depth)."""
    return rotate(x_flat, head_dim, *rope_tables(head_dim, positions, theta))


# -- placement -----------------------------------------------------------


def stack_specs(
    stage_axis: str | None = "stage",
    tp_axis: str | None = None,
    *,
    ep_axis: str | None = None,
    moe: bool = False,
    cfg: TransformerConfig | None = None,
) -> dict:
    """Placement matching init_stack, a tuple of mesh axis names (None:
    not split) a dim: layer axis -> stage axis; q/k/v/ffn-in
    column-parallel, out/ffn-out row-parallel over tp; with moe=True the
    expert axis of the FFN weights over ep_axis. `cfg` tailors the key
    set to the config (dropped biases, rms norms, swiglu w3, LoRA
    factors: a row-parallel target's a split like its base's rows, a
    column-parallel target's b like its base's columns)."""
    st, tp, ep = stage_axis, tp_axis, ep_axis
    use_bias = cfg.use_bias if cfg is not None else True
    layer_norm = cfg.norm_type == "layer" if cfg is not None else True
    swiglu = cfg.ffn_style == "swiglu" if cfg is not None else False
    p = {
        "wq": (st, None, tp),
        "wk": (st, None, tp),
        "wv": (st, None, tp),
        "wo": (st, tp, None),
        "ln1_scale": (st, None),
        "ln2_scale": (st, None),
    }
    if use_bias:
        p.update(bq=(st, tp), bk=(st, tp), bv=(st, tp), bo=(st, None))
    if layer_norm:
        p.update(ln1_bias=(st, None), ln2_bias=(st, None))
    if swiglu:
        p["w3"] = (st, None, tp)
    if moe:
        p.update(
            router=(st, None, None),
            w1=(st, ep, None, tp),
            b1=(st, ep, tp),
            w2=(st, ep, tp, None),
            b2=(st, ep, None),
        )
    else:
        p.update(w1=(st, None, tp), w2=(st, tp, None))
        if use_bias:
            p.update(b1=(st, tp), b2=(st, None))
    if cfg is not None and cfg.lora_rank:
        for t in cfg.lora_targets:
            if t in _ROW_PARALLEL:
                p[f"{t}:a"] = (st, tp, None)
                p[f"{t}:b"] = (st, None, None)
            else:
                p[f"{t}:a"] = (st, None, None)
                p[f"{t}:b"] = (st, None, tp)
    return p


def first_free_divisible_dim(
    spec, dims, dp: int, *, offset: int = 0
) -> int | None:
    """Index (into `dims`) of the first dimension `spec` leaves unsplit
    and the axis size `dp` divides: the placement rule shared by FSDP
    weight sharding (fsdp_plan, offset=1 to skip the stacked layer axis)
    and ZeRO-1 moment sharding (parallel/train.py). None if no dim
    qualifies."""
    spec = list(spec)
    for i, dim in enumerate(dims):
        ax = spec[i + offset] if i + offset < len(spec) else None
        if ax is None and dim % dp == 0 and dim >= dp:
            return i
    return None


def fsdp_plan(cfg: TransformerConfig, per_layer_specs: dict, dp: int) -> dict:
    """FSDP placement: {param key -> per-layer dim index} to split over
    the data axis (and to all-gather back on use): for each stack leaf
    the first dim its per-layer spec leaves unsplit that dp divides.
    Shapes come from init_stack on the meta device, so every key the
    config makes is planned by the same rule; a leaf with no such dim
    stays as it is."""
    if dp <= 1:
        return {}
    shapes = init_stack(torch.Generator(), cfg, device="meta")
    plan: dict = {}
    for key, leaf in shapes.items():
        axis = first_free_divisible_dim(
            per_layer_specs[key], leaf.shape[1:], dp, offset=1
        )
        if axis is not None:
            plan[key] = axis
    return plan


def build_fsdp_plan(cfg: TransformerConfig, per_layer_specs: dict, mesh) -> dict:
    """The SPMD models' fsdp=True setup: a mesh without a "data" axis
    larger than 1 has nothing to shard the weights over (the JAX
    package's ValueError); with one, plan each leaf's placement."""
    dp = mesh.shape.get("data", 1)
    if dp <= 1:
        raise ValueError(
            "fsdp=True needs a 'data' mesh axis of size > 1 "
            "(there is nothing to shard the weights over)"
        )
    return fsdp_plan(cfg, per_layer_specs, dp)


def fsdp_specs(per_layer_specs: dict, plan: dict, data_axis: str) -> dict:
    """Apply an fsdp_plan to per-layer specs: entry plan[key]+1 (after
    the layer axis) becomes the data axis."""
    out = dict(per_layer_specs)
    for key, axis in plan.items():
        spec = list(out[key])
        while len(spec) < axis + 2:
            spec.append(None)
        spec[axis + 1] = data_axis
        out[key] = tuple(spec)
    return out


def tree_specs(tree: dict, stack: dict) -> dict:
    """Specs for a model's param tree: the "stack" leaves from `stack`
    (staged specs by key), every other leaf replicated (())."""
    return {
        k: ({kk: stack[kk] for kk in v} if k == "stack"
            else tree_specs(v, stack) if isinstance(v, dict) else ())
        for k, v in tree.items()
    }


def _split_dims(spec, mesh):
    return [(i, ax) for i, ax in enumerate(spec)
            if ax is not None and mesh.shape.get(ax, 1) > 1]


def shard_tree(tree: dict, specs: dict, mesh) -> dict:
    """This rank's slice of a full tree: each leaf's dims split over the
    mesh axes its spec names (contiguous copies). The identity on a
    one-process mesh."""
    if not mesh.distributed:
        return tree
    coords = mesh.coords

    def leaf(x, spec):
        for i, ax in _split_dims(spec, mesh):
            c = x.shape[i] // mesh.shape[ax]
            x = x.narrow(i, coords[ax] * c, c)
        return x.contiguous().clone()

    return {k: shard_tree(v, specs[k], mesh) if isinstance(v, dict)
            else leaf(v, specs[k]) for k, v in tree.items()}


@torch.no_grad()
def gather_tree(tree: dict, specs: dict, mesh) -> dict:
    """The inverse of shard_tree: every leaf whole on every rank (for
    comparisons and checkpoints). Every rank must call it on the same
    tree: it all-gathers each split dim, leaf by leaf in key order."""
    if not mesh.distributed:
        return tree

    def leaf(x, spec):
        for i, ax in reversed(_split_dims(spec, mesh)):
            x = collectives.gather_dim(x, mesh.group(ax), mesh.shape[ax], i)
        return x.contiguous()

    return {k: gather_tree(v, specs[k], mesh) if isinstance(v, dict)
            else leaf(v, specs[k]) for k in sorted(tree) for v in [tree[k]]}


class StackPlacement:
    """The placement methods of an SPMD model (SpmdBert, SpmdVit) whose
    `stack_param_specs()` places its stage-stacked stack on `self.mesh`:
    every other leaf of its trees is replicated."""

    def param_specs(self, tree: dict) -> dict:
        """The placement of a param tree of this model (init's, or a
        trainer's with its head)."""
        return tree_specs(tree, self.stack_param_specs())

    def shard_params(self, tree: dict) -> dict:
        """This rank's slice of a whole tree (the identity in one
        process)."""
        return shard_tree(tree, self.param_specs(tree), self.mesh)

    def gather_params(self, tree: dict) -> dict:
        """Every leaf whole on every rank: the inverse of shard_params."""
        return gather_tree(tree, self.param_specs(tree), self.mesh)


# -- mixture of experts -------------------------------------------------


def _route_topk(router: torch.Tensor, x: torch.Tensor, k: int):
    """Top-k routing, f32 softmax over the global expert count: returns
    (expert indices [..., k] int64, weights [..., k] f32). One definition
    for both dispatches. k=1 keeps the raw top probability (Switch); k>1
    renormalizes over the selected experts (Mixtral). Among equal
    probabilities the lower index comes first, as lax.top_k orders them:
    a stable descending sort, where torch.topk promises no order."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :k], idx[..., :k]
    if k > 1:
        w = w / w.sum(dim=-1, keepdim=True)
    return idx, w


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of `idx` over n classes, all zeros where idx is
    outside [0, n) (jax.nn.one_hot's rule; F.one_hot raises there, and
    may read the indices back to the host to check)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _dispatch_weights(idx: torch.Tensor, w: torch.Tensor, e_global: int):
    """(member [..., E] in {0, 1}, gate [..., E]) from top-k routing."""
    sel = _one_hot(idx, e_global)  # (..., k, E)
    return sel.sum(dim=-2), (sel * w[..., None]).sum(dim=-2)


def moe_ffn(
    p: dict,
    x: torch.Tensor,
    *,
    tp_axis: str | None = None,
    ep_axis: str | None = None,
    top_k: int = 1,
) -> torch.Tensor:
    """Top-k mixture-of-experts FFN on (B, S, D), dense dispatch: every
    local expert runs on every token and the top-k gate zeroes the rest
    (no capacity, no drops). Expert outputs combine in f32; one psum
    over ep closes the partition of experts."""
    dt = x.dtype
    e_local = p["w1"].shape[0]
    ep = axis_size(ep_axis)
    # Each ep rank sees only its own experts' share of the cotangents of
    # x and of the routing: the entry ops sum them over ep.
    x = pvary(x, ep_axis)
    idx, wts = _route_topk(pvary(p["router"], ep_axis), x, top_k)
    _, gate = _dispatch_weights(idx, wts, ep * e_local)  # (B, S, E)
    # This device's expert columns of the global gate matrix.
    e0 = axis_index(ep_axis) * e_local
    dispatch = gate[..., e0 : e0 + e_local]
    h = (
        torch.einsum("bsd,edf->ebsf", pvary(x, tp_axis), p["w1"].to(dt))
        + p["b1"].to(dt)[:, None, None, :]
    )
    h = F.gelu(h, approximate="tanh")
    y = torch.einsum("ebsf,efd->ebsd", h, p["w2"].to(dt))
    y = psum(y, tp_axis)
    y = y + p["b2"].to(dt)[:, None, None, :]
    out = torch.einsum("ebsd,bse->bsd", y.float(), dispatch)
    return psum(out, ep_axis).to(dt)


def moe_capacity(
    tokens: int, e_global: int, top_k: int, capacity_factor: float
) -> int:
    """The a2a dispatch's static slots an expert: each of `tokens`
    claims top_k, so C = ceil(cf * k * tokens / E), at least 1."""
    return max(1, math.ceil(capacity_factor * top_k * tokens / e_global))


def a2a_slots(idx: torch.Tensor, w: torch.Tensor, e_global: int, cap: int):
    """Capacity slots of routed tokens (n, k): (dispatch [n, E, C] f32,
    one-hot of each kept (token, expert) pair's slot; combine = dispatch
    x gate; keep [n, E] bool). A token's slot in an expert's queue is
    its arrival position (a cumsum down the tokens); positions >= cap
    are dropped, Switch-style, and fall through on the residual."""
    member, gate = _dispatch_weights(idx, w, e_global)
    member_i = member.to(torch.int64)
    pos_in_e = member_i.cumsum(dim=0) - 1  # (n, E)
    keep = (pos_in_e < cap) & (member_i > 0)
    dispatch = _one_hot(pos_in_e, cap) * keep[..., None]
    return dispatch, dispatch * gate[..., None], keep


def moe_ffn_a2a(
    p: dict,
    x: torch.Tensor,
    *,
    capacity_factor: float = 1.25,
    tp_axis: str | None = None,
    ep_axis: str | None = None,
    top_k: int = 1,
) -> torch.Tensor:
    """Top-k MoE FFN with all-to-all expert dispatch on (B, S, D).

    Each device along ep takes its own 1/ep slice of the tokens, routes
    it into a static (E, C, D) capacity buffer (`a2a_slots`), sends each
    expert's slots to that expert's device (one all_to_all), runs its
    local experts and returns the outputs by the inverse all_to_all;
    one psum reassembles the stream. Routing is moe_ffn's, so at a
    capacity that drops nothing the two dispatches agree."""
    dt = x.dtype
    b, s, d = x.shape
    n = b * s
    e_local = p["w1"].shape[0]
    ep = axis_size(ep_axis)
    e_global = ep * e_local
    if n % ep:
        raise ValueError(
            f"a2a dispatch needs tokens ({n} = {b}x{s}) divisible by "
            f"the expert axis size {ep}"
        )
    n_l = n // ep
    cap = moe_capacity(n_l, e_global, top_k, capacity_factor)
    t0 = axis_index(ep_axis) * n_l
    # Each rank routes its own tokens: the entry ops sum the cotangents
    # of x and of the router over ep.
    x_own = pvary(x, ep_axis).reshape(n, d)[t0 : t0 + n_l]  # (n_l, D)
    idx, wts = _route_topk(pvary(p["router"], ep_axis), x_own, top_k)
    dispatch, combine, _ = a2a_slots(idx, wts, e_global, cap)

    xin = torch.einsum("nd,nec->ecd", x_own.float(), dispatch)
    xin = all_to_all(xin, ep_axis, split_axis=0, concat_axis=1)
    h = torch.einsum("ecd,edf->ecf", pvary(xin.to(dt), tp_axis),
                     p["w1"].to(dt))
    h = F.gelu(h + p["b1"].to(dt)[:, None, :], approximate="tanh")
    y = torch.einsum("ecf,efd->ecd", h, p["w2"].to(dt))
    y = psum(y, tp_axis)
    y = y + p["b2"].to(dt)[:, None, :]
    y = all_to_all(y, ep_axis, split_axis=1, concat_axis=0)
    out_own = torch.einsum("ecd,nec->nd", y.float(), combine)
    if ep_axis is None:
        return out_own.to(dt).reshape(b, s, d)
    out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    out[t0 : t0 + n_l] = out_own
    return psum(out, ep_axis).to(dt).reshape(b, s, d)


# -- the encoder block ----------------------------------------------------


def repeat_kv(x_flat: torch.Tensor, head_dim: int, groups: int) -> torch.Tensor:
    """Expand a flat (B, T, H_kv*Dh) K/V projection to (B, T, H*Dh) by
    repeating each KV head for its query-head group (GQA)."""
    if groups == 1:
        return x_flat
    b, t, d = x_flat.shape
    x = x_flat.reshape(b, t, d // head_dim, head_dim)
    return x.repeat_interleave(groups, dim=2).reshape(b, t, d * groups)


def block_apply(
    p: dict,
    x: torch.Tensor,
    cfg: TransformerConfig,
    *,
    tp_axis: str | None = None,
    sp_axis: str | None = None,
    sp_strategy: str = "ring",
    ep_axis: str | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """One encoder block on (B, S, D), post- or pre-LN per
    cfg.norm_style; params have no layer axis. Each weight is cast to
    x's dtype where it is used, so gradients land on the stored (f32)
    masters. Attention goes through `multi_head_attention` (the flash
    kernel on a CUDA tensor without a window), or with plain=True
    through `attention_reference` on any device: the unpipelined
    references' path, independent of the kernel under test.

    With tp_axis set the projections arrive column-split (this rank's
    head group of q, k, v; its slice of the FFN) and wo / w2 row-split:
    the replicated input enters through `pvary`, and one psum closes
    each row-parallel product (the Megatron pattern). With sp_axis set,
    S is this rank's shard of the sequence and attention runs ring or
    Ulysses over that axis (`parallel/sequence.py`); rope positions
    start at its offset."""
    dt = x.dtype
    local_heads = cfg.num_heads // axis_size(tp_axis)
    dh = cfg.dim // cfg.num_heads
    groups = cfg.num_heads // cfg.kv_heads
    pre = cfg.norm_style == "pre"
    lora_scale = cfg.lora_scale

    def bias(h, name):
        return h + p[name].to(dt) if name in p else h

    def proj(h, name):
        """Base matmul plus the low-rank adapter path when present. Under
        tp the factor that stays replicated (a of a column-parallel
        target, b of a row-parallel one) meets a split operand, so it
        enters through pvary: its gradient sums over tp."""
        y = h @ p[name].to(dt)
        a = p.get(f"{name}:a")
        if a is not None:
            b = p[f"{name}:b"]
            if name in _ROW_PARALLEL:
                b = pvary(b, tp_axis)
            else:
                a = pvary(a, tp_axis)
            y = y + ((h @ a.to(dt)) @ b.to(dt)) * lora_scale
        return y

    a_in = norm_apply(cfg, x, p, "ln1") if pre else x
    a_in = pvary(a_in, tp_axis)
    q = bias(proj(a_in, "wq"), "bq")
    k = bias(proj(a_in, "wk"), "bk")
    v = bias(proj(a_in, "wv"), "bv")
    if cfg.pos_style == "rope":
        s_local = q.shape[1]
        positions = axis_index(sp_axis) * s_local + torch.arange(
            s_local, device=x.device
        )
        q = apply_rope(q, dh, positions, cfg.rope_theta)
        k = apply_rope(k, dh, positions, cfg.rope_theta)
    # GQA: expand the KV heads after rope, so each query head of a group
    # attends its shared rotated KV head.
    k = repeat_kv(k, dh, groups)
    v = repeat_kv(v, dh, groups)
    if plain:
        attn = _merge_heads(attention_reference(
            *(_split_heads(t, local_heads) for t in (q, k, v)),
            causal=cfg.causal, window=cfg.window,
        ))
    else:
        attn = multi_head_attention(
            q, k, v, num_heads=local_heads, causal=cfg.causal,
            window=cfg.window, sp_axis=sp_axis, sp_strategy=sp_strategy,
        )
    attn = bias(psum(proj(attn, "wo"), tp_axis), "bo")
    if pre:
        x = x + attn
        f_in = norm_apply(cfg, x, p, "ln2")
    else:
        x = norm_apply(cfg, x + attn, p, "ln1")
        f_in = x

    if "router" in p:
        if cfg.moe_dispatch == "a2a":
            h = moe_ffn_a2a(
                p, f_in, capacity_factor=cfg.capacity_factor,
                tp_axis=tp_axis, ep_axis=ep_axis, top_k=cfg.moe_top_k,
            )
        else:
            h = moe_ffn(p, f_in, tp_axis=tp_axis, ep_axis=ep_axis,
                        top_k=cfg.moe_top_k)
    elif cfg.ffn_style == "swiglu":
        # llama FFN: silu(gate) * up -> down (w1=gate, w3=up, w2=down).
        f_in = pvary(f_in, tp_axis)
        gate = F.silu(proj(f_in, "w1"))
        h = psum(proj(gate * proj(f_in, "w3"), "w2"), tp_axis)
    else:
        f_in = pvary(f_in, tp_axis)
        h = F.gelu(bias(proj(f_in, "w1"), "b1"), approximate="tanh")
        h = bias(psum(proj(h, "w2"), tp_axis), "b2")
    if pre:
        return x + h
    return norm_apply(cfg, x + h, p, "ln2")


def layers_apply(
    stacked: dict,
    x: torch.Tensor,
    cfg: TransformerConfig,
    *,
    tp_axis: str | None = None,
    sp_axis: str | None = None,
    sp_strategy: str = "ring",
    ep_axis: str | None = None,
    fsdp_axis: str | None = None,
    fsdp_gather: dict | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """Apply a [L_local, ...]-stacked group of blocks in order. With
    cfg.remat each block runs under
    `torch.utils.checkpoint.checkpoint(use_reentrant=False)`: only its
    input is kept for the backward, which recomputes the block (its
    flash_attention launches and its collectives too, with the mesh of
    the forward active again). With fsdp_axis set, each leaf named in
    fsdp_gather is all-gathered on its dim inside the block, just in
    time: only the current block's weights are ever whole, the gather's
    backward is the reduce-scatter the split gradients need, and under
    remat the backward gathers again instead of keeping them."""
    mesh = collectives.current_mesh()

    def block(p_one, h):
        with collectives.active(mesh):
            if fsdp_axis is not None and fsdp_gather:
                p_one = {
                    k: all_gather(v, fsdp_axis, dim=fsdp_gather[k])
                    if k in fsdp_gather else v
                    for k, v in p_one.items()
                }
            return block_apply(p_one, h, cfg, tp_axis=tp_axis,
                               sp_axis=sp_axis, sp_strategy=sp_strategy,
                               ep_axis=ep_axis, plain=plain)

    depth = next(iter(stacked.values())).shape[0]
    for layer in range(depth):
        p_one = {k: v[layer] for k, v in stacked.items()}
        if cfg.remat:
            x = checkpoint(block, p_one, x, use_reentrant=False)
        else:
            x = block(p_one, x)
    return x
