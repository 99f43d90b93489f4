"""defer_tpu_torch — DEFER's pipelined inference on PyTorch and CUDA.

The port of `defer_tpu` (JAX on a TPU) to one NVIDIA H100. It keeps the
JAX package's module paths and public names, imports neither `jax` nor
`defer_tpu`, and runs on CUDA unless the caller asks for the CPU:

    from defer_tpu_torch import DEFER
    from defer_tpu_torch.models import get_model
    defer = DEFER()                       # every CUDA device
    defer.run_defer(get_model("bert_base"), ["encoder_5_out"], in_q, out_q)

and serves a KV-cache decoder with continuous batching:

    from defer_tpu_torch import DecodeServer, GptDecoder, mistral_config
    dec = GptDecoder(mistral_config(), compute_dtype=torch.bfloat16)
    srv = DecodeServer(dec, params, max_batch=4)
"""

from defer_tpu_torch.api import DEFER, run_local_inference
from defer_tpu_torch.config import DeferConfig
from defer_tpu_torch.graph.ir import Graph, GraphBuilder, OpNode
from defer_tpu_torch.models.gpt import GptDecoder, SamplingParams
from defer_tpu_torch.models.llama import llama_config, mistral_config
from defer_tpu_torch.runtime.decode_server import DecodeServer, serve_greedy
from defer_tpu_torch.graph.partition import (
    PartitionError,
    partition,
    stage_params,
    validate_cut_points,
)
from defer_tpu_torch import obs
from defer_tpu_torch.parallel import Pipeline, pipeline_devices
from defer_tpu_torch.weights import params_from_jax

__all__ = [
    "DEFER",
    "DecodeServer",
    "DeferConfig",
    "GptDecoder",
    "Graph",
    "GraphBuilder",
    "OpNode",
    "PartitionError",
    "Pipeline",
    "SamplingParams",
    "llama_config",
    "mistral_config",
    "obs",
    "params_from_jax",
    "partition",
    "pipeline_devices",
    "run_local_inference",
    "serve_greedy",
    "stage_params",
    "validate_cut_points",
]
