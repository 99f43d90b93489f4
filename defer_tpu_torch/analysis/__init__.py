"""defer_tpu_torch.analysis — torch-aware static lint + runtime
capture and sync sanitizers: the port's counterpart of
defer_tpu/analysis/, with the same module names.

Two halves:

- Static (AST): ``python -m defer_tpu_torch.analysis --strict
  defer_tpu_torch/`` runs the rules over the package (rules.py: host
  syncs, graph captures and compiles, implicit randomness, lock
  discipline, obs naming; domains.py: cross-thread-domain writes;
  shardcheck.py: collective axes, spec arity and the psum mirror;
  budget.py with ``--budget``: perf contracts) with a lightweight
  call-graph walk that scopes the hot-path rules to the serving loops.
  Inline escape hatch: ``# analysis: ignore[rule] reason``.
- Runtime: ``sanitizer.capture_sanitizer(*targets)`` raises if a
  block captured a CUDA graph; ``sanitizer.sync_sanitizer(allow=n)``
  raises if a block made more than n synchronizing CUDA calls.

Nothing here imports jax or defer_tpu.
"""

from defer_tpu_torch.analysis.rules import Finding
from defer_tpu_torch.analysis.runner import AnalysisReport, analyze_paths
from defer_tpu_torch.analysis.sanitizer import (
    HostSyncError,
    RecaptureError,
    capture_sanitizer,
    sync_sanitizer,
)

__all__ = [
    "AnalysisReport",
    "Finding",
    "HostSyncError",
    "RecaptureError",
    "analyze_paths",
    "capture_sanitizer",
    "sync_sanitizer",
]
