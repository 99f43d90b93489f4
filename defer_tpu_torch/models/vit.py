"""Vision Transformer builders, IR form (counterpart of `_build_vit`,
`vit_b16`, `vit_s16` and `vit_tiny` in `defer_tpu/models/vit.py`).

Pre-LN ViT (Dosovitskiy et al., arXiv 2010.11929):

    patch-embed conv (p x p, stride p) -> tokens -> [class] token ->
    learned pos embedding -> L x (LN, MHA, add, LN, MLP, add) ->
    final LN -> [class] head

Each block's `mha` runs the hand-written `flash_attention` kernel on the
card (S = (image / patch)^2 + 1, 197 at 224 / 16). Cut candidates are
the per-block residual outputs (`block_{i}_out`).

The SPMD form (`SpmdVit`) runs the same pre-LN stack on the stage
pipeline (`parallel/spmd_pipeline.py`), under the mesh rules of
`SpmdBert`.
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
    _layer_norm,
    build_fsdp_plan,
    fsdp_specs,
    init_stack,
    layers_apply,
    normal,
    stack_specs,
)


def _build_vit(
    name: str,
    *,
    image_size: int,
    patch_size: int,
    num_layers: int,
    dim: int,
    num_heads: int,
    mlp_dim: int,
    num_classes: int = 1000,
) -> Model:
    if image_size % patch_size:
        raise ValueError(
            f"image size {image_size} not divisible by patch {patch_size}"
        )
    grid = image_size // patch_size
    num_tokens = grid * grid + 1  # + [class]

    b = GraphBuilder(name)
    x = b.input()
    x = b.add(
        "conv",
        x,
        name="patch_embed",
        features=dim,
        kernel_size=(patch_size, patch_size),
        strides=(patch_size, patch_size),
        padding="VALID",
    )
    x = b.add("reshape", x, name="tokens", shape=(grid * grid, dim))
    x = b.add("cls_token", x, name="class_token")
    x = b.add(
        "pos_embedding", x, name="position_embedding", max_len=num_tokens
    )
    cuts: list[str] = []
    for i in range(num_layers):
        h = b.add("layer_norm", x, name=f"block_{i}_ln1")
        h = b.add("mha", h, name=f"block_{i}_mha", num_heads=num_heads)
        x = b.add("add", x, h, name=f"block_{i}_attn_out")
        h = b.add("layer_norm", x, name=f"block_{i}_ln2")
        h = b.add("dense", h, name=f"block_{i}_mlp_in", features=mlp_dim)
        h = b.add("gelu", h, name=f"block_{i}_mlp_gelu")
        h = b.add("dense", h, name=f"block_{i}_mlp_out", features=dim)
        x = b.add("add", x, h, name=f"block_{i}_out")
        cuts.append(x)
    x = b.add("layer_norm", x, name="final_ln")
    x = b.add("take_token", x, name="class_out", index=0)
    x = b.add("dense", x, name="head", features=num_classes)
    return Model(
        name=name,
        graph=b.build(x),
        input_shape=(image_size, image_size, 3),
        cut_candidates=tuple(cuts[:-1]),  # last block output == tail
    )


@register_model("vit_b16")
def vit_b16(image_size: int = 224) -> Model:
    """ViT-Base/16 (86M params)."""
    return _build_vit(
        "vit_b16",
        image_size=image_size,
        patch_size=16,
        num_layers=12,
        dim=768,
        num_heads=12,
        mlp_dim=3072,
    )


@register_model("vit_s16")
def vit_s16(image_size: int = 224) -> Model:
    """ViT-Small/16 (22M params)."""
    return _build_vit(
        "vit_s16",
        image_size=image_size,
        patch_size=16,
        num_layers=12,
        dim=384,
        num_heads=6,
        mlp_dim=1536,
    )


@register_model("vit_tiny")
def vit_tiny(image_size: int = 32) -> Model:
    """Small config for tests."""
    return _build_vit(
        "vit_tiny",
        image_size=image_size,
        patch_size=8,
        num_layers=4,
        dim=64,
        num_heads=4,
        mlp_dim=128,
        num_classes=10,
    )


# --------------------------------------------------------------------------
# SPMD form
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SpmdVit(StackPlacement):
    """ViT on the stage pipeline (pre-LN stack): patch embed -> S-stage
    pipeline -> final LN on the [class] token -> head. Parameters keep
    the JAX package's keys and layouts (`patch_kernel` HWIO
    [p, p, 3, D]), in f32; images are NHWC.

    Mesh axes as the JAX package's SpmdVit reads them: "stage"
    (pipeline), "data" (batch) and "model" (tensor parallel); fsdp=True
    splits the stack weights over "data" as SpmdBert's does. Any other
    axis computes replicated. In one process only "stage" may be larger
    than 1."""

    mesh: Mesh
    cfg: TransformerConfig
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    compute_dtype: Any = torch.bfloat16
    fsdp: bool = False

    def __post_init__(self):
        if "stage" not in self.mesh.axis_names:
            raise ValueError("SpmdVit needs a 'stage' mesh axis")
        if self.cfg.norm_style != "pre":
            raise ValueError("ViT uses pre-LN: cfg.norm_style must be 'pre'")
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image {self.image_size} not divisible by patch "
                f"{self.patch_size}"
            )
        self.num_stages = self.mesh.shape.get("stage", 1)
        self.tp_axis = (
            "model" if self.mesh.shape.get("model", 1) > 1 else None
        )
        if self.cfg.num_layers % self.num_stages:
            raise ValueError(
                f"{self.cfg.num_layers} layers not divisible by "
                f"{self.num_stages} stages"
            )
        self.grid = self.image_size // self.patch_size
        self.num_tokens = self.grid * self.grid + 1
        self.data_axis = (
            "data" if self.mesh.shape.get("data", 1) > 1 else None
        )
        self._fsdp_plan: dict = {}
        if self.fsdp:
            self._fsdp_plan = build_fsdp_plan(
                self.cfg, stack_specs(None, self.tp_axis, cfg=self.cfg),
                self.mesh,
            )
        check_process_group(self.mesh)
        self.device = self.mesh.local_device

    @property
    def split_axes(self) -> tuple:
        """The mesh axes that split the batch (SpmdBert.split_axes)."""
        return (self.data_axis,) if self.data_axis else ()

    def stack_param_specs(self) -> dict:
        """The stage-stacked stack's placement, FSDP's data axis
        included."""
        per_layer = stack_specs(None, self.tp_axis, cfg=self.cfg)
        if self._fsdp_plan:
            per_layer = fsdp_specs(per_layer, self._fsdp_plan, "data")
        return staged_specs(per_layer, "stage")

    def init(self, generator: torch.Generator) -> dict:
        """Random f32 parameters on this process's device, drawn from
        `generator` (which must live there); over a process group, this
        rank's slice of the whole tree every rank draws."""
        cfg, dev = self.cfg, self.device
        pp, d = self.patch_size, cfg.dim
        return self.shard_params({
            "patch_kernel": normal(
                generator, (pp, pp, 3, d), (pp * pp * 3) ** -0.5, device=dev
            ),
            "patch_bias": torch.zeros((d,), device=dev),
            "cls": normal(generator, (1, 1, d), 0.02, device=dev),
            "pos": normal(generator, (self.num_tokens, d), 0.02, device=dev),
            "final_ln_scale": torch.ones((d,), device=dev),
            "final_ln_bias": torch.zeros((d,), device=dev),
            "head_w": normal(
                generator, (d, self.num_classes), d**-0.5, device=dev
            ),
            "head_b": torch.zeros((self.num_classes,), device=dev),
            "stack": stack_for_stages(
                init_stack(generator, cfg, device=dev), self.num_stages
            ),
        })

    def _embed(self, params: dict, images: torch.Tensor) -> torch.Tensor:
        """[M, B, H, W, 3] -> [M, B, tokens, D]: the VALID stride-p patch
        conv as the product of each flattened (p, p, 3) patch with the
        HWIO kernel, then the [class] token and the position table."""
        cd = self.compute_dtype
        m, b = images.shape[:2]
        g, pp, d = self.grid, self.patch_size, self.cfg.dim
        x = images.to(self.device, cd).reshape(m * b, g, pp, g, pp, 3)
        patches = x.permute(0, 1, 3, 2, 4, 5).reshape(m * b, g * g, -1)
        x = patches @ params["patch_kernel"].to(cd).reshape(-1, d)
        x = x + params["patch_bias"].to(cd)
        cls = params["cls"].to(cd).expand(m * b, 1, d)
        x = torch.cat([cls, x], dim=1) + params["pos"].to(cd)
        return x.reshape(m, b, self.num_tokens, d)

    def _head(self, params: dict, ys: torch.Tensor) -> torch.Tensor:
        """Final LN on the [class] token + classifier head: one
        definition for the pipelined step and the reference."""
        cd = self.compute_dtype
        cls = _layer_norm(
            ys[:, :, 0, :].to(cd),
            params["final_ln_scale"],
            params["final_ln_bias"],
            self.cfg.layer_norm_eps,
        )
        return cls @ params["head_w"].to(cd) + params["head_b"].to(cd)

    def make_step(self):
        """(params, images [M, B, H, W, 3]) -> logits [M, B, C]."""
        cfg = self.cfg

        fsdp_axis = "data" if self._fsdp_plan else None

        def stage_fn(stack_local, x):
            return layers_apply(stack_local, x, cfg, tp_axis=self.tp_axis,
                                fsdp_axis=fsdp_axis,
                                fsdp_gather=self._fsdp_plan)

        pipe = make_spmd_pipeline(self.mesh, stage_fn,
                                  data_axis=self.data_axis)

        def step(params, images):
            return self._head(
                params, pipe(params["stack"], self._embed(params, images))
            )

        return step

    def reference_apply(self, params: dict, images: torch.Tensor) -> torch.Tensor:
        """Unpipelined reference, attention through the plain version, on
        the whole tree."""
        emb = self._embed(params, images)
        flat = unstack_stages(params["stack"])
        ys = torch.stack([
            layers_apply(flat, emb[i], self.cfg, plain=True)
            for i in range(emb.shape[0])
        ])
        return self._head(params, ys)
