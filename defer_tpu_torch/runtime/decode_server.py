"""Continuous-batching decode server: admit requests into batch slots
mid-flight.

Counterpart of `defer_tpu/runtime/decode_server.py` at decode_window=1.
The decode batch is a set of SLOTS, each at its own depth: the cache's
write head is a (B,) position tensor on the device (models/gpt.py), so
one (B, 1) step advances every active request whatever its age, and a
finished slot is re-admitted with the next queued request at once:

  * admission = one request's prefill (prompt padded to a power-of-two
    bucket) whose K/V rows are copied into the slot's lane of the big
    cache; rows past the slot's position are stale, never attended
    (the decode kernel reads live rows only) and overwritten as the
    slot advances;
  * every decode tick is ONE weight read shared by all active slots;
  * inactive slots decode a dummy token into row 0, and their position
    is pinned back to 0 after each tick.

Host syncs are the JAX package's: a tick moves tokens to the host only
when eos, a stop sequence or the streaming callback needs them (one
batched transfer); every other per-tick update (positions, the active
mask, the next feed, sampling rows) is written on the device.

Greedy by default; `submit(..., sampling=SamplingParams(...))` routes a
slot through the batched in-tick sampler with its OWN seeded
`torch.Generator` (SlotSampler), so each sampled request reproduces the
port's solo `generate(..., generator=seeded(seed))` token for token.
Torch's stream differs from JAX's from the same seed; the distribution
does not.

Prefix caching (`prefix_ids=`): the shared prefix is prefilled once into
a one-lane cache; each admission prefills only its suffix through a
non-donating step that reads that lane in place.

Not ported yet (ROADMAP Queue 1 item 5): `decode_window > 1`,
`constraints=`, multi-LoRA adapter banks and `DraftLanes`; each raises
`NotImplementedError`.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import torch

from defer_tpu_torch.models.gpt import (
    sample_token_batched,
    sample_token_batched_nosort,
)
from defer_tpu_torch.obs.serving import ServerStats, ServingMetrics
from defer_tpu_torch.runtime.stopping import matcher_or_none, normalize_stops


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item 5)"
    )


class SlotSampler:
    """Per-slot sampling state: one generator per sampled slot plus the
    policy vectors (on the device) the batched sampler reads. A slot
    admitted with SamplingParams draws inside the shared tick from its
    OWN generator (seeded with the request's seed, one (1, V) draw per
    emitted token, the schedule solo generate follows). Greedy slots
    keep the argmax fast path and draw nothing."""

    def __init__(self, max_batch: int, device: torch.device):
        self.device = device
        self.generators: list = [None] * max_batch
        self.temp = torch.zeros((max_batch,), device=device)
        self.topk = torch.zeros((max_batch,), dtype=torch.int32,
                                device=device)
        self.topp = torch.ones((max_batch,), device=device)
        self.minp = torch.zeros((max_batch,), device=device)
        # Host mirrors: the row's temperature (a greedy admission into a
        # vacated sampled slot must reset it), whether its policy needs
        # the sorting filters (top_k/top_p; while no row does, draw()
        # takes the sort-free variant), and whether it installed any
        # filter (release() resets those rows). They keep the greedy
        # common case free of device writes.
        self.row_temp = [0.0] * max_batch
        self.row_sort = [False] * max_batch
        self.row_filters = [False] * max_batch

    def admit_first(self, i, samp, logits_row, dtype):
        """First generated token of an admission [1, 1]: greedy argmax,
        or the first draw of the request's generator, with the policy
        installed into slot i's rows."""
        if samp is None:
            self.row_sort[i] = False
            if self.row_temp[i] != 0.0:
                self.temp[i] = 0.0
                self.row_temp[i] = 0.0
            return torch.argmax(logits_row, dim=-1)[:, None].to(dtype)
        gen = torch.Generator(device=self.device).manual_seed(samp.seed)

        def one(value, dt=torch.float32):
            return torch.full((1,), value, dtype=dt, device=self.device)

        tok = sample_token_batched(
            logits_row, [gen], one(samp.temperature),
            one(samp.top_k, torch.int32), one(samp.top_p), one(samp.min_p),
        )
        self.generators[i] = gen
        self.temp[i] = samp.temperature
        self.topk[i] = samp.top_k
        self.topp[i] = samp.top_p
        self.minp[i] = samp.min_p
        self.row_temp[i] = samp.temperature
        self.row_sort[i] = samp.top_k > 0 or samp.top_p < 1.0
        self.row_filters[i] = (
            samp.top_k > 0 or samp.top_p < 1.0 or samp.min_p > 0.0
        )
        return tok[:, None].to(dtype)

    def release(self, i: int) -> None:
        """Retire slot i's policy the moment its request finishes: a
        stale row_sort would drag later ticks through the sorting
        sampler, and stale filter rows would leak into a later sampled
        admission. Greedy rows are already released."""
        self.generators[i] = None
        self.row_sort[i] = False
        if self.row_temp[i] != 0.0:
            self.temp[i] = 0.0
            self.row_temp[i] = 0.0
        if self.row_filters[i]:
            self.topk[i] = 0
            self.topp[i] = 1.0
            self.minp[i] = 0.0
            self.row_filters[i] = False

    def draw(self, logits_last):
        """One batched draw over every slot's policy (B,): sampled rows
        draw once from their generator, greedy rows take the argmax.
        While no row enables top-k/top-p, the draw takes the sort-free
        variant (the same tokens)."""
        if not any(self.row_sort):
            return sample_token_batched_nosort(
                logits_last, self.generators, self.temp, self.minp
            )
        return sample_token_batched(
            logits_last, self.generators, self.temp, self.topk,
            self.topp, self.minp,
        )


@dataclasses.dataclass
class _Slot:
    req: int | None = None
    remaining: int = 0
    last: Any = None  # next token to feed, [1, 1]
    toks: list | None = None
    sampling: bool = False  # this request runs at temperature > 0
    stop: Any = None  # per-request StopMatcher (runtime/stopping.py)


class DecodeServer:
    """Continuous-batching decoder over `max_batch` slots; greedy by
    default, per-request sampling via `submit(..., sampling=)`."""

    def __init__(
        self,
        dec: Any,
        params: dict,
        *,
        max_batch: int = 4,
        prefix_ids: torch.Tensor | None = None,
        on_token: Any = None,
        eos_id: int | None = None,
        decode_window: int = 1,
        constraints: dict | None = None,
    ):
        """`on_token(request_id, token_id, done)`: optional streaming
        callback fired for every generated token as its tick resolves
        (`done=True` on the request's final token); it runs on the
        serving thread between ticks.

        `eos_id`: stop token; a request that emits it finishes at once
        (its output ends with the eos) and its slot re-admits the next
        queued request, so num_steps is a budget, not an exact length.

        `decode_window` > 1 and `constraints` are not ported yet."""
        if decode_window < 1:
            raise ValueError(
                f"decode_window must be >= 1, got {decode_window}"
            )
        if decode_window > 1:
            raise _not_ported("decode_window > 1 (on CUDA graphs)")
        if constraints is not None:
            raise _not_ported("constrained decoding (constraints=)")
        if any(":" in k for k in params["stack"]):
            raise _not_ported("multi-LoRA adapter banks")
        self.decode_window = decode_window
        self.dec = dec
        self.params = params
        self.B = max_batch
        self.device = dec.device
        self.step = dec.make_step()  # batched ticks, in place
        cache = dec.init_cache(max_batch)
        cache["pos"] = torch.zeros((max_batch,), dtype=torch.int32,
                                   device=self.device)
        self.cache = cache
        self.prefix_len = 0
        self._prefix_cache = None
        if prefix_ids is not None:
            if prefix_ids.ndim != 2 or prefix_ids.shape[0] != 1:
                raise ValueError("prefix_ids must be [1, P]")
            self.prefix_len = int(prefix_ids.shape[1])
            if self.prefix_len >= dec.cfg.max_len:
                raise ValueError(
                    f"prefix of {self.prefix_len} leaves no room under "
                    f"max_len {dec.cfg.max_len}"
                )
            # One shared prefill; every admission reads this lane.
            _, self._prefix_cache = self.step(
                params, dec.init_cache(1), prefix_ids.to(self.device)
            )
        self.slots = [_Slot() for _ in range(max_batch)]
        # Device-side tick state, written in place: each slot's next
        # input token (row i), and which slots hold a request.
        self._feed = torch.zeros((max_batch, 1), dtype=torch.int32,
                                 device=self.device)
        self._active = torch.zeros((max_batch,), dtype=torch.bool,
                                   device=self.device)
        self._sampler = SlotSampler(max_batch, self.device)
        self.pending: collections.deque[tuple] = collections.deque()
        self.done: dict[int, torch.Tensor] = {}
        self._next_id = 0
        self.ticks = 0
        self.on_token = on_token
        self.eos_id = eos_id
        self.solo_steps = 0  # what per-request loops would have cost
        self.window_tokens = 0  # tokens the ticks emitted
        self.obs = ServingMetrics("flat")
        self._submit_t: dict[int, float] = {}
        self._last_tick_t: float | None = None

    # -- public API -------------------------------------------------------

    def submit(
        self,
        prompt_ids: torch.Tensor,
        num_steps: int,
        *,
        sampling: Any = None,
        stop: Any = None,
    ) -> int:
        """Queue a request [1, T]; returns its id (resolved in .done).
        `sampling`: an optional SamplingParams (None or temperature 0 =
        greedy). `stop`: optional multi-token stop sequences; the
        request finishes the moment its generated tail equals one of
        them, its output ending with it."""
        if prompt_ids.shape[0] != 1:
            raise ValueError("submit one request at a time ([1, T])")
        if sampling is not None:
            sampling.validate()
            if sampling.constraint is not None:
                raise _not_ported("constrained decoding (constraint=)")
            if sampling.temperature == 0:
                sampling = None  # greedy: keep the argmax fast path
        stop_seqs = normalize_stops(stop)
        t0 = prompt_ids.shape[1]
        if t0 < 1:
            raise ValueError("prompt must have at least one token")
        if num_steps < 1:
            raise ValueError(
                f"num_steps={num_steps}: need at least one generated "
                "token (a non-positive count would never complete)"
            )
        if self.prefix_len + t0 + num_steps > self.dec.cfg.max_len:
            raise ValueError(
                f"prefix {self.prefix_len} + prompt {t0} + steps "
                f"{num_steps} exceeds max_len {self.dec.cfg.max_len}"
            )
        rid = self._next_id
        self._next_id += 1
        self.pending.append(
            (rid, prompt_ids.to(self.device), num_steps, sampling, stop_seqs)
        )
        self.solo_steps += num_steps
        self._submit_t[rid] = time.perf_counter()
        return rid

    def run(self) -> dict[int, torch.Tensor]:
        """Serve until every submitted request completes; returns
        {request_id: ids [1, T0 + num_steps]} (shorter when eos or a
        stop sequence ended a request early)."""
        while self.pending or any(s.req is not None for s in self.slots):
            self._admit()
            self._tick()
        return self.done

    # -- internals --------------------------------------------------------

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.req is not None or not self.pending:
                continue
            rid, prompt, steps, samp, stop_seqs = self.pending.popleft()
            t0 = prompt.shape[1]
            self.obs.requests_admitted.inc()
            self.obs.prefill_tokens.inc(t0)
            self.obs.queue_wait.observe(
                time.perf_counter() - self._submit_t[rid]
            )
            P = self.prefix_len
            # Bucketed prefill, capped so the padded write stays inside
            # the cache (submit guarantees P + t0 <= max_len).
            pad = 1 << (t0 - 1).bit_length()
            pad = min(pad, self.dec.cfg.max_len - P)
            padded = torch.cat(
                [prompt, prompt.new_zeros((1, pad - t0))], dim=1
            )
            if self._prefix_cache is None:
                logits, small = self.step(
                    self.params, self.dec.init_cache(1), padded
                )
            else:
                # Suffix prefill through a non-donating step: the master
                # prefix lane is read, never written.
                logits, small = self.dec.make_step(donate=False)(
                    self.params, self._prefix_cache, padded
                )
            first = self._sampler.admit_first(
                i, samp, logits[:, t0 - 1, :], prompt.dtype
            )
            self._install_lane(
                i, slot, rid, steps, prompt, small, first, P + t0, samp,
                stop_seqs,
            )

    def _install_lane(
        self, i, slot, rid, steps, prompt, small, first, pos_val, samp,
        stop_seqs,
    ) -> None:
        """Copy the prefilled rows [0, pos_val) into slot i's lane (rows
        past pos_val are stale and never read), set the slot's state,
        and run the eos/streaming/finish bookkeeping."""
        self.cache["k"][:, i, :, :pos_val] = small["k"][:, 0, :, :pos_val]
        self.cache["v"][:, i, :, :pos_val] = small["v"][:, 0, :, :pos_val]
        self.cache["pos"][i] = pos_val
        self._active[i] = True
        self.obs.ttft.observe(time.perf_counter() - self._submit_t.pop(rid))
        self.obs.tokens_generated.inc()
        slot.req = rid
        slot.remaining = steps - 1
        slot.last = first
        slot.toks = [prompt, first]
        slot.sampling = samp is not None
        slot.stop = matcher_or_none(stop_seqs)
        self._feed[i, 0] = first[0, 0]
        need_host = (
            self.eos_id is not None
            or self.on_token is not None
            or slot.stop is not None
        )
        tok_host = int(first[0, 0]) if need_host else None
        if self.eos_id is not None and tok_host == self.eos_id:
            slot.remaining = 0
        if slot.stop is not None and slot.stop.push(tok_host):
            slot.remaining = 0
        if self.on_token is not None:
            self.on_token(rid, tok_host, slot.remaining == 0)
        if slot.remaining == 0:
            self._finish(i, slot)

    def _tick(self) -> None:
        active = [s.req is not None for s in self.slots]
        if not any(active):
            return
        logits, cache = self.step(self.params, self.cache, self._feed)
        self.ticks += 1
        n_active = sum(active)
        now = time.perf_counter()
        if self._last_tick_t is not None:
            self.obs.itl.observe(now - self._last_tick_t, n_active)
        self._last_tick_t = now
        self.obs.ticks.inc()
        self.obs.host_dispatches.inc()
        self.obs.tokens_per_dispatch.set(float(n_active))
        self.window_tokens += n_active
        self.obs.tokens_generated.inc(n_active)
        # Inactive slots wrote a dummy row at their position; pin them
        # back to 0 so they never creep toward max_len.
        cache["pos"] = torch.where(self._active, cache["pos"], 0)
        self.cache = cache
        ll = logits[:, -1, :]
        if any(s.req is not None and s.sampling for s in self.slots):
            nxt = self._sampler.draw(ll)
        else:
            nxt = torch.argmax(ll, dim=-1)  # (B,)
        self._feed = nxt[:, None].to(torch.int32)
        # One device->host transfer per tick, and only for a consumer
        # of host tokens (eos, stop sequences, streaming).
        need_host = (
            self.on_token is not None
            or self.eos_id is not None
            or any(
                s.req is not None and s.stop is not None
                for s in self.slots
            )
        )
        host_nxt = nxt.tolist() if need_host else None
        for i, slot in enumerate(self.slots):
            if slot.req is None:
                continue
            tok = nxt[i].reshape(1, 1).to(slot.last.dtype)
            slot.last = tok
            slot.toks.append(tok)
            slot.remaining -= 1
            if self.eos_id is not None and host_nxt[i] == self.eos_id:
                slot.remaining = 0
            if slot.stop is not None and slot.stop.push(host_nxt[i]):
                slot.remaining = 0
            if self.on_token is not None:
                self.on_token(slot.req, host_nxt[i], slot.remaining == 0)
            if slot.remaining == 0:
                self._finish(i, slot)

    def _finish(self, i: int, slot: _Slot) -> None:
        self.obs.requests_finished.inc()
        self.done[slot.req] = torch.cat(slot.toks, dim=1)
        slot.req = None
        slot.toks = None
        slot.last = None
        slot.sampling = False
        slot.stop = None
        self._active[i] = False
        self._sampler.release(i)


def serve_greedy(
    dec: Any,
    params: dict,
    requests: list[tuple[torch.Tensor, int]],
    *,
    max_batch: int = 4,
    prefix_ids: torch.Tensor | None = None,
    eos_id: int | None = None,
    sampling: list | None = None,
    decode_window: int = 1,
    constraints: dict | None = None,
) -> tuple[list[torch.Tensor], ServerStats]:
    """One-shot convenience: serve `[(prompt, steps), ...]`, returning
    outputs in submission order plus stats (`ticks` batched decode
    steps taken vs `solo_steps` a per-request loop would take;
    `saved_prefill_tokens` the prefix rows each admission reused).
    With `prefix_ids`, each prompt is the per-request suffix and outputs
    cover suffix + generation."""
    srv = DecodeServer(
        dec, params, max_batch=max_batch, prefix_ids=prefix_ids,
        eos_id=eos_id, decode_window=decode_window,
        constraints=constraints,
    )
    samps = sampling or [None] * len(requests)
    if len(samps) != len(requests):
        raise ValueError(
            f"sampling has {len(samps)} entries for "
            f"{len(requests)} requests"
        )
    rids = [
        srv.submit(p, s, sampling=sp)
        for (p, s), sp in zip(requests, samps)
    ]
    done = srv.run()
    stats = ServerStats.snapshot(
        srv.obs.registry,
        ticks=srv.ticks,
        solo_steps=srv.solo_steps,
        saved_prefill_tokens=srv.prefix_len * len(requests),
        decode_window=srv.decode_window,
        host_dispatches=srv.ticks,
        tokens_per_dispatch=(
            srv.window_tokens / srv.ticks if srv.ticks else 0.0
        ),
    )
    return [done[r] for r in rids], stats
