"""defer_tpu_torch.disagg — disaggregated prefill/decode serving.

Counterpart of `defer_tpu/disagg/`: prefill is compute-bound and decode
is cache-read-bound, so the two phases can run on separate workers, the
seam between them finished KV state streamed as pool-shaped blocks over
the host transport:

  * `wire`            — the versioned KV-block wire format, byte for
                        byte the JAX package's
  * `prefill_worker`  — `serve_prefill()` and the
                        `python -m defer_tpu_torch.disagg.prefill_worker`
                        CLI
  * `ingest`          — `KVBlockIngest`, the decode-side drain that
                        seats received blocks in the paged pool
  * `api`             — `serve_disagg()`, the one-call split-serving
                        entry point (greedy tokens identical to
                        `serve_paged`)

`wire.PrefixPayload` carries the fleet's prefix migration
(defer_tpu_torch/fleet/).
"""

from defer_tpu_torch.disagg.api import serve_disagg
from defer_tpu_torch.disagg.ingest import IngestError, KVBlockIngest
from defer_tpu_torch.disagg.prefill_worker import (
    prefill_schedule,
    run_prefill,
    serve_prefill,
)
from defer_tpu_torch.disagg.wire import WIRE_VERSION, KVPayload, PrefixPayload

__all__ = [
    "IngestError",
    "KVBlockIngest",
    "KVPayload",
    "PrefixPayload",
    "WIRE_VERSION",
    "prefill_schedule",
    "run_prefill",
    "serve_disagg",
    "serve_prefill",
]
