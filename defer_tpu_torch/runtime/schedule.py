"""Mixed-mode prefill scheduling for the paged server.

Counterpart of `defer_tpu/runtime/schedule.py`, the same planning
arithmetic (this package keeps its own copy: it imports nothing of the
JAX package).

`PagedDecodeServer(prefill_budget=N)` stops serializing admission
prefill against decode: instead of running a seated prompt to
completion in its own dispatches while every live slot stalls, the
server gives the prompt a SEAT whose `pos` advances chunk by chunk,
and each decode dispatch carries the live decode rows PLUS up to N
prompt tokens from the seated prefills, fused into one
multi-token forward (runtime/paged.py::_tick_mixed through `_mt`, the
paged_flash_prefill step). This module owns the host-side planning half:

- `PrefillSeat` — one partially-prefilled request's progress: the
  suffix tokens still to run, the absolute position of the next row,
  and the radix `keep_from` boundary below which writes redirect to
  trash block 0 (hit blocks are other requests' memory).
- `plan_mixed_tick` — one tick's token plan. Decode rows come first
  (they always advance exactly one token; the plan never touches
  them), then prompt chunks are assigned to seats in admission order
  until the per-tick `budget` runs out. Every assignment is clamped
  by `chunk_cap` (the compile-shape bound, `prefill_chunk` when set)
  and by `t_limit`, the batch-wide bound on the fused program's T:
  the gathered path's contiguous-lane write spans positions
  [pos, pos+T) for EVERY row, so T must satisfy
  max(pos over live rows) + T <= MB * block_size or a clamped write
  would shift a live row (the same invariant submit()'s spec_k
  headroom and _prefill_paged's tail cap protect).

The returned T is pow2-bucketed (then clamped to `t_limit`), the JAX
package's shape set, so both packages run the same T tick for tick.

Seats are admitted from a bounded-lookahead window: the server caps
concurrently-prefilling seats at `prefill_lookahead`, so one giant
prompt cannot monopolize the budget N ways and admission order stays
near-FIFO.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PrefillSeat", "plan_mixed_tick"]


@dataclasses.dataclass
class PrefillSeat:
    """One admitted-but-still-prefilling request's chunk progress.

    `tokens` is the suffix actually scheduled — a radix admit walks
    its leading full blocks first and schedules only the non-shared
    tail (at least one token: the last prompt position must run so
    its logits exist to seed the first generated token). `base` is
    the absolute position of tokens[0] (global prefix length, or the
    radix reuse point); `keep_from` the boundary below which the
    fused program's writes redirect to trash block 0."""

    rid: int
    tokens: np.ndarray  # [ts] int32 suffix token ids still to run
    base: int  # absolute position of tokens[0]
    keep_from: int  # writes below this absolute position -> trash
    done: int = 0  # tokens already landed

    def __post_init__(self) -> None:
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size < 1:
            raise ValueError(
                "a prefill seat needs at least one token to run (the "
                "last prompt position seeds the first generated token)"
            )

    @property
    def remaining(self) -> int:
        return int(self.tokens.size) - self.done

    @property
    def pos(self) -> int:
        """Absolute position of the NEXT row this seat will write."""
        return self.base + self.done

    @property
    def finished(self) -> bool:
        return self.done >= int(self.tokens.size)

    def take(self, n: int) -> np.ndarray:
        """Consume the next `n` scheduled tokens (the tick's chunk)."""
        if not 1 <= n <= self.remaining:
            raise ValueError(
                f"seat rid={self.rid} asked for {n} of "
                f"{self.remaining} remaining tokens"
            )
        chunk = self.tokens[self.done : self.done + n]
        self.done += n
        return chunk


def pow2_bucket(n: int, cap: int) -> int:
    """Round `n` up to a power of two, clamped to [1, cap] — the
    compile-shape discipline every multi-token paged dispatch follows
    (prefill tails, ingest lanes, and now mixed ticks)."""
    if n < 1:
        n = 1
    t = 1 << (n - 1).bit_length()
    return max(1, min(t, cap))


def plan_mixed_tick(
    remaining: list[int],
    budget: int,
    chunk_cap: int,
    t_limit: int,
) -> tuple[int, list[int]]:
    """Plan one mixed tick's prompt-token assignments.

    `remaining[j]` is seat j's unfinished suffix length, in admission
    order. Returns `(T, ns)`: `ns[j]` prompt tokens for seat j this
    tick (0 = the seat idles behind the budget), and `T` the fused
    program's per-row token count — pow2-bucketed over the largest
    assignment and clamped to `t_limit` (never below 1: decode rows
    always ride at T >= 1).

    Decode rows are implicit: they are not planned, never preempted,
    and always advance exactly one token — the budget only rations
    the EXTRA prompt tokens a tick carries.
    """
    if budget < 1:
        raise ValueError(f"budget must be >= 1, got {budget}")
    if chunk_cap < 1:
        raise ValueError(f"chunk_cap must be >= 1, got {chunk_cap}")
    if t_limit < 1:
        raise ValueError(f"t_limit must be >= 1, got {t_limit}")
    left = budget
    ns: list[int] = []
    for rem in remaining:
        if rem < 0:
            raise ValueError(f"negative remaining {rem}")
        n = min(rem, left, chunk_cap, t_limit)
        ns.append(max(n, 0))
        left -= max(n, 0)
    top = max(ns, default=0)
    return pow2_bucket(top, t_limit), ns
