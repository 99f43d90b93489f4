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

or over a paged KV pool, with radix prefix sharing and chunked prefill
through the hand-written paged kernels:

    from defer_tpu_torch import PagedDecodeServer
    srv = PagedDecodeServer(dec, params, num_blocks=1025, block_size=16,
                            attention="pallas", prefix_cache=True,
                            prefill_chunk=64)
"""

from defer_tpu_torch.api import DEFER, run_local_inference
from defer_tpu_torch.config import DeferConfig
from defer_tpu_torch.graph.ir import Graph, GraphBuilder, OpNode
from defer_tpu_torch.models.gpt import GptDecoder, SamplingParams
from defer_tpu_torch.models.llama import llama_config, mistral_config
from defer_tpu_torch.ops.paged_flash_decode import paged_flash_decode
from defer_tpu_torch.ops.paged_flash_prefill import paged_flash_prefill
from defer_tpu_torch.runtime.decode_server import DecodeServer, serve_greedy
from defer_tpu_torch.runtime.paged import (
    PagedDecodeServer,
    PrefixBlockCache,
    serve_paged,
)
from defer_tpu_torch.graph.partition import (
    PartitionError,
    partition,
    stage_params,
    validate_cut_points,
)
from defer_tpu_torch import obs
from defer_tpu_torch.parallel import Pipeline, pipeline_devices
from defer_tpu_torch.weights import params_from_jax, params_to_numpy

__all__ = [
    "DEFER",
    "DecodeServer",
    "DeferConfig",
    "GptDecoder",
    "Graph",
    "GraphBuilder",
    "OpNode",
    "PagedDecodeServer",
    "PartitionError",
    "Pipeline",
    "PrefixBlockCache",
    "SamplingParams",
    "llama_config",
    "mistral_config",
    "obs",
    "paged_flash_decode",
    "paged_flash_prefill",
    "params_from_jax",
    "params_to_numpy",
    "partition",
    "pipeline_devices",
    "run_local_inference",
    "serve_greedy",
    "serve_paged",
    "stage_params",
    "validate_cut_points",
]
