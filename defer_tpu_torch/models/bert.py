"""BERT-base encoder (counterpart of `defer_tpu/models/bert.py`), in two
forms:

  * IR graph (`bert_base`, `bert_tiny`): token-id input, embeddings,
    encoder blocks, CLS pooler. Cut candidates are the block outputs
    (`encoder_{i}_out`), so the pipeline cuts it at block boundaries.
  * SPMD form (`SpmdBert`): stacked encoder blocks
    (`parallel/transformer_stack.py`) on the stage pipeline
    (`parallel/spmd_pipeline.py`), the forward the trainers
    (`parallel/train.py`) differentiate. Its "stage" axis may have any
    size; the other mesh axes must be 1 until the collectives land.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.models import Model, register_model
from defer_tpu_torch.parallel.mesh import Mesh
from defer_tpu_torch.parallel.spmd_pipeline import (
    check_process_group,
    make_spmd_pipeline,
    stack_for_stages,
    staged_specs,
    unstack_stages,
)
from defer_tpu_torch.parallel.transformer_stack import (
    StackPlacement,
    TransformerConfig,
    build_fsdp_plan,
    fsdp_specs,
    init_stack,
    layers_apply,
    normal,
    stack_specs,
)


def _build_bert(
    name: str,
    *,
    num_layers: int,
    dim: int,
    num_heads: int,
    ffn_dim: int,
    vocab_size: int,
    max_len: int,
    seq_len: int,
) -> Model:
    b = GraphBuilder(name)
    ids = b.input("input_ids")
    x = b.add(
        "embedding",
        ids,
        name="token_embedding",
        vocab_size=vocab_size,
        features=dim,
    )
    x = b.add("pos_embedding", x, name="position_embedding", max_len=max_len)
    x = b.add("layer_norm", x, name="embeddings_ln")
    cuts: list[str] = []
    for i in range(num_layers):
        attn = b.add("mha", x, name=f"encoder_{i}_mha", num_heads=num_heads)
        x = b.add("add", x, attn, name=f"encoder_{i}_attn_add")
        x = b.add("layer_norm", x, name=f"encoder_{i}_attn_ln")
        h = b.add("dense", x, name=f"encoder_{i}_ffn_in", features=ffn_dim)
        h = b.add("gelu", h, name=f"encoder_{i}_ffn_gelu")
        h = b.add("dense", h, name=f"encoder_{i}_ffn_out", features=dim)
        x = b.add("add", x, h, name=f"encoder_{i}_ffn_add")
        x = b.add("layer_norm", x, name=f"encoder_{i}_out")
        cuts.append(x)
    cls = b.add("take_token", x, name="cls_token", index=0)
    pooled = b.add("dense", cls, name="pooler_dense", features=dim)
    pooled = b.add("tanh", pooled, name="pooler")
    return Model(
        name=name,
        graph=b.build(pooled),
        input_shape=(seq_len,),
        input_dtype=torch.int64,
        cut_candidates=tuple(cuts[:-1]),  # last block output == graph tail
    )


@register_model("bert_base")
def bert_base(seq_len: int = 128) -> Model:
    return _build_bert(
        "bert_base",
        num_layers=12,
        dim=768,
        num_heads=12,
        ffn_dim=3072,
        vocab_size=30522,
        max_len=512,
        seq_len=seq_len,
    )


@register_model("bert_tiny")
def bert_tiny(seq_len: int = 16) -> Model:
    """Small config for tests."""
    return _build_bert(
        "bert_tiny",
        num_layers=4,
        dim=32,
        num_heads=4,
        ffn_dim=64,
        vocab_size=128,
        max_len=64,
        seq_len=seq_len,
    )


# --------------------------------------------------------------------------
# SPMD form
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SpmdBert(StackPlacement):
    """BERT encoder on the stage pipeline: token (+ learned position)
    embedding in f32, cast to compute_dtype -> S-stage pipeline ->
    pooler. Parameters are f32 with the JAX package's keys, the stack
    stage-stacked [S, L/S, ...].

    Mesh axes (any may be size 1; "stage" must exist): "stage"
    (pipeline), "data" (batch), "model" (tensor parallel), "seq"
    (sequence parallel, ring or Ulysses by sp_strategy) and "expert"
    (the MoE FFN's experts), validated as the JAX package validates
    them. In one process only "stage" may be larger than 1 and every
    leaf is whole on the mesh's first device; over a process group each
    rank holds its slice (`param_specs`, `shard_params`), on its own
    device. fsdp=True also splits each stack weight over "data" and
    all-gathers it just in time inside the block."""

    mesh: Mesh
    cfg: TransformerConfig
    compute_dtype: Any = torch.bfloat16
    sp_strategy: str = "ring"
    fsdp: bool = False

    def __post_init__(self):
        if "stage" not in self.mesh.axis_names:
            raise ValueError(
                "SpmdBert needs a 'stage' mesh axis (size 1 is fine): "
                f"got axes {self.mesh.axis_names}"
            )
        shape = self.mesh.shape
        self.num_stages = shape.get("stage", 1)
        self.tp_axis = "model" if shape.get("model", 1) > 1 else None
        self.sp_axis = "seq" if shape.get("seq", 1) > 1 else None
        ep = shape.get("expert", 1)
        self.ep_axis = "expert" if ep > 1 else None
        if self.cfg.num_experts and self.cfg.num_experts % ep:
            raise ValueError(
                f"{self.cfg.num_experts} experts not divisible by the "
                f"expert axis size {ep}"
            )
        if ep > 1 and not self.cfg.num_experts:
            raise ValueError(
                "mesh has an expert axis but cfg.num_experts == 0"
            )
        if self.cfg.num_layers % self.num_stages:
            raise ValueError(
                f"{self.cfg.num_layers} layers not divisible by "
                f"{self.num_stages} pipeline stages"
            )
        tp = shape.get("model", 1)
        if self.cfg.num_heads % tp or self.cfg.dim % tp or self.cfg.ffn_dim % tp:
            raise ValueError(
                f"heads={self.cfg.num_heads}, dim={self.cfg.dim}, "
                f"ffn_dim={self.cfg.ffn_dim} must all divide by the model "
                f"axis size {tp} — otherwise attention silently computes "
                "with the wrong head grouping"
            )
        if self.cfg.kv_heads % tp:
            raise ValueError(
                f"num_kv_heads={self.cfg.kv_heads} must divide by the "
                f"model axis size {tp} (whole kv head groups per shard)"
            )
        self.data_axis = "data" if shape.get("data", 1) > 1 else None
        self._fsdp_plan: dict = {}
        if self.fsdp:
            self._fsdp_plan = build_fsdp_plan(
                self.cfg, self._per_layer_specs(), self.mesh
            )
        check_process_group(self.mesh)
        self.device = self.mesh.local_device

    @property
    def split_axes(self) -> tuple:
        """The mesh axes that split the batch or the sequence: a stack
        parameter's gradient is summed over them (parallel/train.py)."""
        return tuple(a for a in (self.data_axis, self.sp_axis) if a)

    def _per_layer_specs(self) -> dict:
        return stack_specs(None, self.tp_axis, ep_axis=self.ep_axis,
                           moe=bool(self.cfg.num_experts), cfg=self.cfg)

    def stack_param_specs(self) -> dict:
        """The stage-stacked stack's placement, FSDP's data axis
        included."""
        per_layer = self._per_layer_specs()
        if self._fsdp_plan:
            per_layer = fsdp_specs(per_layer, self._fsdp_plan, "data")
        return staged_specs(per_layer, "stage")

    def init(self, generator: torch.Generator) -> dict:
        """Random f32 parameters on this process's device, drawn from
        `generator` (which must live there): the JAX package's
        distributions, not its values. Every rank draws the whole tree
        from the same seed and keeps its slice, so a distributed run
        starts from the weights of {"stage": 1}."""
        cfg, dev = self.cfg, self.device
        params = {
            "token_embedding": normal(
                generator, (cfg.vocab_size, cfg.dim), 0.02, device=dev
            ),
            "pooler_w": normal(
                generator, (cfg.dim, cfg.dim), cfg.dim**-0.5, device=dev
            ),
            "pooler_b": torch.zeros((cfg.dim,), device=dev),
            "stack": stack_for_stages(
                init_stack(generator, cfg, device=dev), self.num_stages
            ),
        }
        if cfg.pos_style == "learned":
            params["pos_embedding"] = normal(
                generator, (cfg.max_len, cfg.dim), 0.02, device=dev
            )
        return self.shard_params(params)

    def _embed(self, params: dict, ids: torch.Tensor) -> torch.Tensor:
        """Token (+ learned position) embedding in f32, then the compute
        dtype: [..., S] ids -> [..., S, D]."""
        ids = ids.to(self.device)
        emb = params["token_embedding"][ids]
        if self.cfg.pos_style == "learned":
            emb = emb + params["pos_embedding"][: ids.shape[-1]]
        return emb.to(self.compute_dtype)

    def _pool(self, params: dict, ys: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return torch.tanh(
            ys[:, :, 0, :] @ params["pooler_w"].to(cd)
            + params["pooler_b"].to(cd)
        )

    def make_hidden_step(self):
        """(params, ids [M, B, S]) -> per-position hidden states
        [M, B, S, D] in compute_dtype (no pooler), whole on every rank:
        the forward a next-token LM head needs (parallel/train.py)."""
        cfg = self.cfg
        fsdp_axis = "data" if self._fsdp_plan else None

        def stage_fn(stack_local, x):
            return layers_apply(
                stack_local, x, cfg, tp_axis=self.tp_axis,
                sp_axis=self.sp_axis, sp_strategy=self.sp_strategy,
                ep_axis=self.ep_axis, fsdp_axis=fsdp_axis,
                fsdp_gather=self._fsdp_plan,
            )

        pipe = make_spmd_pipeline(self.mesh, stage_fn,
                                  data_axis=self.data_axis,
                                  seq_axis=self.sp_axis)

        def hidden(params, ids):
            return pipe(params["stack"], self._embed(params, ids))

        return hidden

    def make_step(self):
        """(params, ids [M, B, S]) -> pooled [M, B, D] in compute_dtype."""
        hidden = self.make_hidden_step()

        def step(params, ids):
            return self._pool(params, hidden(params, ids))

        return step

    def reference_apply(self, params: dict, ids: torch.Tensor) -> torch.Tensor:
        """Unpipelined reference for correctness checks: the stage stack
        flattened to [L, ...], each microbatch through every block in
        turn, attention through the plain version (`attention_reference`)
        on any device, so the kernel under test takes no part. Takes the
        whole tree (gather_params over a process group)."""
        emb = self._embed(params, ids)
        flat = unstack_stages(params["stack"])
        ys = torch.stack([
            layers_apply(flat, emb[m], self.cfg, plain=True)
            for m in range(emb.shape[0])
        ])
        return self._pool(params, ys)
