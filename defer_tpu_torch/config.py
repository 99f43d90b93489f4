"""Configuration for defer_tpu_torch: the counterpart of
`defer_tpu/config.py`, with torch dtypes."""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch


@dataclasses.dataclass
class DeferConfig:
    """All knobs for a pipelined inference run.

    Attributes:
      compute_dtype: dtype floating activations and params are cast to
        for compute. bfloat16 keeps the matrix products on the tensor
        cores.
      param_dtype: dtype parameters are STORED in on device. None (the
        default) stores them in compute_dtype, which removes a cast pass
        over the weights on every microbatch. Set an explicit dtype
        (e.g. torch.float32) to keep higher-precision storage.
      max_inflight: microbatches allowed in flight before the host blocks
        on the oldest result (the backpressure of the stream loops).
      probe_every: during run_defer, measure per-stage latency
        (synchronously, draining first) every N microbatches and stash
        it on DEFER.last_stage_latencies; 0 disables probing.
      collective_timeout_s: watchdog timeout for a stage or transfer that
        never completes.
      redispatch_attempts: on a stage failure during run_defer, probe
        device health and rebuild the pipeline on the healthy devices
        up to this many times, retrying the failed microbatch (results
        in flight at failure time may be lost and the retried input
        re-runs from stage 0). 0 = fail fast.
      dynamic_batch_size: during run_defer, coalesce up to this many
        rows of adjacent input-queue items into ONE device batch
        (outputs are split back per item, order preserved). 1 disables
        (default).
      batch_wait_s: with dynamic batching, how long to wait for more
        items after a batch's first item arrives.

    The JAX package's `donate_activations` has no counterpart: eager
    PyTorch frees an inter-stage activation as soon as its last
    reference goes, with nothing to donate to a compiled program.
    """

    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = None

    @property
    def storage_dtype(self) -> Any:
        """The dtype parameters are actually stored in on device."""
        return self.param_dtype if self.param_dtype is not None else (
            self.compute_dtype
        )

    max_inflight: int = 32
    probe_every: int = 0
    collective_timeout_s: float = 120.0
    redispatch_attempts: int = 1
    dynamic_batch_size: int = 1
    batch_wait_s: float = 0.005

    def replace(self, **kw: Any) -> "DeferConfig":
        return dataclasses.replace(self, **kw)


def normalize_cuts(
    cuts: Sequence[str | Sequence[str]] | str | None,
) -> tuple[str | tuple[str, ...], ...]:
    """None -> (), "a" -> ("a",), and sequences pass through with list
    bundles frozen to tuples (multi-tensor boundaries).

    Note a top-level sequence is always a *list of cuts*: a single
    bundle must be wrapped — pass [("h2", "h1")], not ("h2", "h1")
    (the latter reads as two single-tensor cuts).
    """
    if cuts is None:
        return ()
    if isinstance(cuts, str):
        return (cuts,)
    return tuple(
        tuple(c) if isinstance(c, (list, tuple)) else c for c in cuts
    )
