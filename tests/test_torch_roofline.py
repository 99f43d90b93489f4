"""utils/roofline.py against the JAX package's: the same FLOPs node for
node, the same bytes under `assume_fusion=True` (the XLA picture) and
under `assume_fusion=False`, and the port's own default (unfused, as
eager PyTorch runs) with the NVIDIA bandwidth table.

Params are meta tensors in the shapes `jax.eval_shape` gives the JAX
init (nothing is computed); counts must be equal exactly.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from defer_tpu.utils import roofline as jroof
from defer_tpu.models import get_model as jax_get_model
from defer_tpu_torch.models import get_model
from defer_tpu_torch.utils.roofline import (
    bytes_by_node,
    format_report,
    peak_bandwidth,
    roofline_report,
)

H100 = "NVIDIA H100 80GB HBM3"
MODELS = [("resnet50", 2), ("mobilenetv2", 2), ("vit_tiny", 2),
          ("bert_tiny", 2)]


def _shapes(name, batch):
    jmodel = jax_get_model(name)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, batch_size=batch), jax.random.key(0)
    )
    params = {
        node: {
            k: torch.empty(v.shape, dtype=getattr(torch, v.dtype.name),
                           device="meta")
            for k, v in p.items()
        }
        for node, p in shapes.items()
    }
    return jmodel, shapes, get_model(name), params


@pytest.mark.parametrize("name,batch", MODELS)
def test_flops_and_bytes_equal_the_reference(name, batch):
    jmodel, jshapes, model, params = _shapes(name, batch)
    shape = (batch, *model.input_shape)
    # Token ids as int32 in both (the port's models default to int64).
    floating = model.input_dtype.is_floating_point
    dtype, jdtype = (torch.float32, jnp.float32) if floating else (
        torch.int32, jnp.int32
    )
    ours = roofline_report(model.graph, params, shape, H100,
                           input_dtype=dtype, top=1000, assume_fusion=True)
    theirs = jroof.roofline_report(jmodel.graph, jshapes, shape, H100,
                                   input_dtype=jdtype, top=1000)
    assert ours["total_flops"] == theirs["total_flops"]
    assert ours["total_bytes"] == theirs["total_bytes"]
    by_name = {e["name"]: e for e in theirs["top_nodes"]}
    for e in ours["top_nodes"]:
        assert (e["flops"], e["bytes"]) == (
            by_name[e["name"]]["flops"], by_name[e["name"]]["bytes"]
        )
    unfused = bytes_by_node(model.graph, params, shape, dtype)
    assert unfused == jroof.bytes_by_node(
        jmodel.graph, jshapes, shape, jdtype, assume_fusion=False
    )


def test_bandwidth_table_is_nvidia_and_never_a_tpu():
    assert peak_bandwidth(H100) == 3.35e12
    assert peak_bandwidth("NVIDIA H100 PCIe") == 2.0e12
    assert peak_bandwidth("TPU v5 lite") is None
    assert peak_bandwidth("cpu") is None


def test_unfused_default_charges_every_elementwise_pass():
    """ResNet50 at batch 32 bf16 on an H100: the default counts the
    batch-norm, relu and add passes that eager PyTorch runs, so it moves
    more bytes and predicts more time than the fused picture."""
    _, _, model, params = _shapes("resnet50", 1)
    params = {n: {k: v.to(torch.bfloat16) for k, v in p.items()}
              for n, p in params.items()}
    shape = (32, *model.input_shape)
    eager = roofline_report(model.graph, params, shape, H100,
                            input_dtype=torch.bfloat16)
    fused = roofline_report(model.graph, params, shape, H100,
                            input_dtype=torch.bfloat16, assume_fusion=True)
    assert eager["assume_fusion"] is False
    assert eager["total_flops"] == fused["total_flops"]
    assert eager["total_bytes"] > 1.5 * fused["total_bytes"]
    assert eager["t_lower_s"] > fused["t_lower_s"] > 0
    assert eager["ridge_intensity"] == round(989e12 / 3.35e12, 1)
    assert eager["time_share"]["memory"] > 0.5
    text = format_report(eager)
    assert text.startswith(f"roofline[{H100}]") and "(unfused)" in text
    assert "ms a batch" in text
    # An unknown card: no bound, nodes ranked by FLOPs.
    assert "t_lower_s" not in roofline_report(
        model.graph, params, (1, *model.input_shape), "cpu",
        input_dtype=torch.bfloat16,
    )
