"""Per-op parity: every op of BERT's graph, and the shape-free
elementwise ops beside them, through both registries.

Each case builds its params with the JAX op's init (for the tree's keys
and shapes), replaces every leaf with a numpy draw from a fixed seed,
N(0, 0.25) (so biases and norms are not trivially 0/1), and feeds the
same numpy inputs to `defer_tpu.ops` and `defer_tpu_torch.ops`. The port's own init
must produce the same keys and shapes. Tolerance: atol = rtol = 1e-5 in
float32 (the packages sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.ops import get_op as jax_get_op
from defer_tpu_torch.ops import get_op

TOL = dict(atol=1e-5, rtol=1e-5)

# (op, attrs, inputs as (shape, kind)); kind "f" = float32 normal,
# "ids" = token ids below 20, "bias" = an additive attention mask.
CASES = [
    ("dense", {"features": 12}, [((2, 5, 8), "f")]),
    ("dense", {"features": 6, "use_bias": False}, [((3, 8), "f")]),
    ("add", {}, [((2, 5, 8), "f"), ((2, 5, 8), "f")]),
    ("gelu", {}, [((2, 5, 8), "f")]),
    ("gelu", {"approximate": False}, [((2, 5, 8), "f")]),
    ("tanh", {}, [((2, 5, 8), "f")]),
    ("embedding", {"vocab_size": 20, "features": 8}, [((2, 5), "ids")]),
    ("pos_embedding", {"max_len": 16}, [((2, 5, 8), "f")]),
    ("layer_norm", {}, [((2, 5, 8), "f")]),
    ("mha", {"num_heads": 2}, [((2, 5, 8), "f")]),
    ("mha", {"num_heads": 4, "causal": True}, [((2, 9, 16), "f")]),
    ("mha", {"num_heads": 2}, [((2, 5, 8), "f"), ((2, 1, 5, 5), "bias")]),
    ("take_token", {"index": 1}, [((2, 5, 8), "f")]),
    ("cls_token", {}, [((2, 5, 8), "f")]),
    ("identity", {}, [((2, 5), "f")]),
    ("dropout", {}, [((2, 5), "f")]),
    ("multiply", {}, [((2, 5), "f"), ((2, 5), "f"), ((2, 5), "f")]),
    ("concat", {"axis": 1}, [((2, 3), "f"), ((2, 4), "f")]),
    ("relu", {}, [((2, 5), "f")]),
    ("relu6", {}, [((2, 5), "f")]),
    ("sigmoid", {}, [((2, 5), "f")]),
    ("swish", {}, [((2, 5), "f")]),
    ("softmax", {"axis": 1}, [((2, 5, 3), "f")]),
    ("scale", {"value": 0.17}, [((2, 5), "f")]),
    ("rescale", {"scale": 2.0, "offset": -1.0}, [((2, 5), "f")]),
    ("flatten", {}, [((2, 3, 4), "f")]),
    ("reshape", {"shape": (4, 3)}, [((2, 3, 4), "f")]),
]


def _inputs(specs, rng):
    out = []
    for shape, kind in specs:
        if kind == "ids":
            out.append(rng.integers(0, 20, shape))
        else:
            out.append(rng.standard_normal(shape).astype(np.float32))
    return out


@pytest.mark.parametrize(
    "op,attrs,specs",
    CASES,
    ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)],
)
def test_op_matches_jax(op, attrs, specs):
    rng = np.random.default_rng(0)
    xs = _inputs(specs, rng)
    in_shapes = [x.shape for x in xs]
    jax_params = jax_get_op(op).init(
        jax.random.key(0), attrs, in_shapes, jnp.float32
    )
    params = {
        k: (0.5 * rng.standard_normal(np.shape(v))).astype(np.float32)
        for k, v in jax_params.items()
    }
    want = jax_get_op(op).apply(
        {k: jnp.asarray(v) for k, v in params.items()},
        [jnp.asarray(x) for x in xs],
        attrs,
    )
    got = get_op(op).apply(
        {k: torch.from_numpy(v) for k, v in params.items()},
        [torch.from_numpy(x) for x in xs],
        attrs,
    )
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    ours = get_op(op).init(
        torch.Generator().manual_seed(0), attrs, in_shapes, torch.float32
    )
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(np.shape(v)) for k, v in jax_params.items()
    }
