"""The CNN ops through both registries: conv, depthwise and separable
conv, batch norm, the pools, pad, crop and Keras normalization.

Each case builds its params with the JAX op's init (for the tree's keys
and shapes), replaces every leaf with a numpy draw from a fixed seed
(N(0, 0.25); a batch norm's or normalization's `var` |N| + 0.5), and
feeds the same numpy NHWC input to `defer_tpu.ops` and
`defer_tpu_torch.ops`. The port's own init must give the same keys and
shapes, and its meta-tensor shape inference the JAX op's shape.
Tolerance: atol = rtol = 1e-5 in float32 (the packages sum in different
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.ops import get_op as jax_get_op
from defer_tpu_torch import DeferConfig, GraphBuilder
from defer_tpu_torch.ops import get_op
from defer_tpu_torch.parallel.pipeline import Stage

TOL = dict(atol=1e-5, rtol=1e-5)

# (op, attrs, input NHWC shape)
CASES = [
    # conv: kernel 1/3/7, stride 1/2, SAME / VALID / explicit padding at
    # odd and even sizes, dilation, groups, bias.
    ("conv", {"features": 6, "kernel_size": 1, "padding": "VALID"},
     (2, 7, 7, 4)),
    ("conv", {"features": 6, "kernel_size": 3}, (2, 7, 8, 4)),
    ("conv", {"features": 6, "kernel_size": 3, "strides": 2}, (2, 8, 8, 4)),
    ("conv", {"features": 6, "kernel_size": 3, "strides": 2}, (2, 9, 9, 4)),
    ("conv", {"features": 5, "kernel_size": 7, "strides": 2,
              "padding": "VALID", "use_bias": True}, (1, 15, 16, 3)),
    ("conv", {"features": 5, "kernel_size": 7, "strides": 2}, (1, 16, 15, 3)),
    ("conv", {"features": 4, "kernel_size": 3,
              "padding": ((1, 2), (0, 1))}, (2, 6, 7, 3)),
    ("conv", {"features": 6, "kernel_size": 3, "dilation": 2}, (1, 9, 10, 4)),
    ("conv", {"features": 6, "kernel_size": (1, 7)}, (1, 9, 9, 4)),
    ("conv", {"features": 6, "kernel_size": 3, "groups": 2, "strides": 2,
              "use_bias": True}, (2, 9, 8, 4)),
    # depthwise: depth_multiplier 1/2, stride 2 SAME at odd and even.
    ("depthwise_conv", {"kernel_size": 3}, (2, 8, 8, 5)),
    ("depthwise_conv", {"kernel_size": 3, "strides": 2}, (2, 9, 9, 5)),
    ("depthwise_conv", {"kernel_size": 5, "strides": 2, "use_bias": True},
     (2, 8, 10, 5)),
    ("depthwise_conv", {"kernel_size": 3, "depth_multiplier": 2}, (1, 7, 7, 3)),
    ("depthwise_conv", {"kernel_size": 3, "dilation": 2, "padding": "VALID"},
     (1, 9, 9, 3)),
    # separable: depthwise then pointwise, bias after both.
    ("separable_conv", {"features": 7, "kernel_size": 3}, (2, 8, 8, 4)),
    ("separable_conv", {"features": 7, "kernel_size": 3, "strides": 2,
                        "depth_multiplier": 2, "use_bias": False},
     (1, 9, 9, 4)),
    ("batch_norm", {}, (2, 5, 5, 6)),
    ("batch_norm", {"eps": 1.001e-5}, (2, 4, 6, 6)),
    # pools: windows 2/3, SAME / VALID / explicit, odd and even sizes.
    ("max_pool", {"window": 2}, (2, 8, 8, 3)),
    ("max_pool", {"window": 3, "strides": 2}, (2, 9, 9, 3)),
    ("max_pool", {"window": 3, "strides": 2, "padding": "SAME"}, (2, 8, 8, 3)),
    ("max_pool", {"window": 3, "strides": 2, "padding": "SAME"}, (2, 9, 9, 3)),
    ("max_pool", {"window": 3, "strides": 1, "padding": "SAME"}, (1, 7, 8, 3)),
    ("max_pool", {"window": 2, "strides": 2, "padding": "SAME"}, (1, 7, 7, 3)),
    ("max_pool", {"window": 2, "strides": 1,
                  "padding": ((0, 1), (1, 0))}, (1, 5, 6, 2)),
    ("avg_pool", {"window": 2}, (2, 8, 8, 3)),
    ("avg_pool", {"window": 3, "strides": 2}, (2, 9, 9, 3)),
    ("avg_pool", {"window": 3, "strides": 1, "padding": "SAME"}, (2, 8, 7, 3)),
    ("avg_pool", {"window": 3, "strides": 2, "padding": "SAME"}, (2, 8, 8, 3)),
    ("avg_pool", {"window": 3, "strides": 2, "padding": "SAME"}, (2, 9, 9, 3)),
    ("avg_pool", {"window": 2, "strides": 2, "padding": "SAME"}, (1, 7, 6, 3)),
    ("avg_pool", {"window": 1, "strides": 2}, (1, 7, 8, 3)),
    ("avg_pool", {"window": 3, "strides": 1,
                  "padding": ((2, 0), (1, 1))}, (1, 5, 6, 2)),
    ("global_avg_pool", {}, (2, 5, 6, 4)),
    ("global_avg_pool", {"keepdims": True}, (2, 5, 6, 4)),
    ("global_max_pool", {}, (2, 5, 6, 4)),
    ("global_max_pool", {"keepdims": True}, (2, 5, 6, 4)),
    ("zero_pad", {"padding": ((3, 3), (3, 3))}, (2, 5, 6, 3)),
    ("zero_pad", {"padding": ((0, 1), (2, 0))}, (1, 5, 5, 3)),
    ("crop", {"cropping": ((1, 0), (1, 0))}, (1, 6, 6, 3)),
    ("crop", {"cropping": ((1, 2), (0, 3))}, (2, 7, 8, 3)),
    ("normalization", {}, (2, 4, 4, 3)),
    ("normalization", {"mean": [0.5, -1.0, 2.0],
                       "variance": [4.0, 0.25, 0.0]}, (2, 4, 4, 3)),
]


def _numpy_params(jparams, rng):
    return {
        k: (np.abs(rng.standard_normal(v.shape)) + 0.5
            if k == "var"
            else rng.standard_normal(v.shape) * 0.5).astype(np.float32)
        for k, v in jparams.items()
    }


def _both(op, attrs, shape, seed=0):
    """(numpy params, numpy input) for one case, from the JAX init."""
    rng = np.random.default_rng(seed)
    jparams = jax_get_op(op).init(
        jax.random.key(0), attrs, [shape], jnp.float32
    )
    return _numpy_params(jparams, rng), rng.standard_normal(shape).astype(
        np.float32
    )


def _torch(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


@pytest.mark.parametrize(
    "op,attrs,shape", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)]
)
def test_op_matches_jax(op, attrs, shape):
    params, x = _both(op, attrs, shape)
    want = jax_get_op(op).apply(
        {k: jnp.asarray(v) for k, v in params.items()}, [jnp.asarray(x)],
        attrs,
    )
    got = get_op(op).apply(_torch(params), [torch.from_numpy(x)], attrs)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # The port's init: the same keys and shapes as the JAX op's.
    mine = get_op(op).init(
        torch.Generator().manual_seed(0), attrs, [shape], torch.float32
    )
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: v.shape for k, v in params.items()
    }
    # Shape inference on meta tensors gives the JAX op's shape.
    meta = get_op(op).apply(
        {k: v.to("meta") for k, v in _torch(params).items()},
        [torch.empty(shape, device="meta")],
        attrs,
    )
    spec = jax.eval_shape(
        lambda p, a: jax_get_op(op).apply(p, [a], attrs),
        {k: jnp.asarray(v) for k, v in params.items()},
        jax.ShapeDtypeStruct(shape, jnp.float32),
    )
    assert meta.device.type == "meta" and tuple(meta.shape) == spec.shape


PLACED = [
    ("conv", {"features": 6, "kernel_size": 3, "strides": 2}, (2, 9, 9, 4)),
    ("conv", {"features": 6, "kernel_size": 1, "use_bias": True},
     (2, 5, 5, 4)),
    ("depthwise_conv", {"kernel_size": 3, "depth_multiplier": 2},
     (1, 7, 7, 3)),
    ("separable_conv", {"features": 7, "kernel_size": 3}, (2, 8, 8, 4)),
    ("batch_norm", {"eps": 1.001e-5}, (2, 4, 6, 6)),
]


@pytest.mark.parametrize(
    "op,attrs,shape", PLACED, ids=[f"{c[0]}-{i}" for i, c in enumerate(PLACED)]
)
def test_placed_params_compute_the_same(op, attrs, shape):
    """A stage's placement form: conv kernels keep their HWIO shape, but
    their OIHW view (what cuDNN takes) is channels-last, so no call
    copies a weight; a batch norm holds one scale and shift. Either form
    gives the same output."""
    params, x = _both(op, attrs, shape)
    placed = get_op(op).place(_torch(params), attrs, torch.float32)
    for k in ("kernel", "dw_kernel", "pw_kernel"):
        if k in placed:
            assert placed[k].shape == params[k].shape
            assert placed[k].permute(3, 2, 0, 1).is_contiguous(
                memory_format=torch.channels_last
            )
    if op == "batch_norm":
        assert set(placed) == {"folded_scale", "folded_shift"}
    xt = torch.from_numpy(x)
    got = get_op(op).apply(placed, [xt], attrs)
    want = get_op(op).apply(_torch(params), [xt], attrs)
    torch.testing.assert_close(got, want, **TOL)
    assert got.is_contiguous()


@pytest.mark.parametrize("eps", [1e-3, 1.001e-5])
def test_bn_fold_rounds_as_jax(eps):
    """The bf16 scale and shift a stage holds are the JAX op's: formed
    in f32, then cast, bit for bit."""
    params, _ = _both("batch_norm", {"eps": eps}, (1, 2, 2, 64), seed=3)
    placed = get_op("batch_norm").place(
        _torch(params), {"eps": eps}, torch.bfloat16
    )
    p = {k: jnp.asarray(v) for k, v in params.items()}
    inv = jax.lax.rsqrt(p["var"] + eps)
    scale = (p["scale"] * inv).astype(jnp.bfloat16)
    shift = (p["bias"] - p["mean"] * p["scale"] * inv).astype(jnp.bfloat16)
    for mine, theirs in ((placed["folded_scale"], scale),
                         (placed["folded_shift"], shift)):
        assert mine.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            mine.float().numpy(), np.asarray(theirs, np.float32)
        )


def test_stage_holds_the_placement_form():
    """Stage (parallel/pipeline.py) places each op's params once: the
    conv's held kernel is channels-last as OIHW, the batch norm folded,
    and the stage computes what the graph does on the stored params."""
    b = GraphBuilder("cbr")
    x = b.input()
    x = b.add("conv", x, name="c", features=8, kernel_size=3, strides=2)
    x = b.add("batch_norm", x, name="bn", eps=1.001e-5)
    graph = b.build(b.add("relu", x, name="r"))
    params = graph.init(torch.Generator().manual_seed(0), (2, 9, 9, 3))
    config = DeferConfig(compute_dtype=torch.float32)
    stage = Stage(graph, params, torch.device("cpu"), config)
    held = stage._tree
    assert held["c"]["kernel"].shape == (3, 3, 3, 8)
    assert held["c"]["kernel"].permute(3, 2, 0, 1).is_contiguous(
        memory_format=torch.channels_last
    )
    assert set(held["bn"]) == {"folded_scale", "folded_shift"}
    xin = torch.randn(2, 9, 9, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        torch.testing.assert_close(
            stage(xin), graph.apply(params, xin), **TOL
        )
