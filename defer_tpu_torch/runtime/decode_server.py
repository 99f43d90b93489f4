"""Continuous-batching decode server: admit requests into batch slots
mid-flight.

Counterpart of `defer_tpu/runtime/decode_server.py`. The decode batch is
a set of SLOTS, each at its own depth: the cache's write head is a (B,)
position tensor on the device (models/gpt.py), so one (B, 1) step
advances every active request whatever its age, and a finished slot is
re-admitted with the next queued request at once:

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

`decode_window=K` > 1 runs K decode sub-steps a host dispatch. Each
sub-step runs the raw T=1 step (`dec.decode_step_fn()`), pins inactive
rows' positions to 0 (with the sub-step-start mask), samples in the
window's mode ("argmax", "nosort" or "sort"), counts the token against
the row's budget and freezes rows that hit eos or their budget for the
rest of the window, all on the device; the host sees one [B, K]
transfer a window, and admissions and retirements happen at window
boundaries. On a CUDA decoder the K sub-steps are captured once per
(mode, constrained) into a `torch.cuda.CUDAGraph` kept on the server
(a graph is bound to the buffers it was captured on, so unlike the
decoder's steps it is not shared between servers), and replayed; on a
CPU decoder the same body runs eagerly. A capture that fails raises.
Every tensor the graph reads or writes keeps its address: the cache,
`pos`, the feed, the active mask, the budget, the sampler's policy rows
and the outputs are written in place. A sampled slot's uniforms are
drawn from its own generator before each replay, K (1, V) draws in the
order K ticks at decode_window=1 would draw them, into a static
[K, B, V] buffer the captured Gumbel-max step reads; greedy rows read
0.5. So a window is token-identical to K ticks, sampled slots
included. `flash_decode.launches` counts host-side launches, which a
replay does not make: the server counts `graph_replays`, and
`window_kernel_launches` is the flash_decode launches they imply
(K x layers a replay).

Constrained decoding (`constraints={name: TokenDFA}`, selected per
request with `SamplingParams(constraint=name)`): the slot's logits are
masked to its DFA's admissible tokens (eos only in accepting states)
before the argmax or draw, and the DFA state advances on the device in
the same tick or window. A hand-built DFA that dead-ends finishes its
request with an entry in `errors`, never a hang.

Multi-LoRA (params with adapter banks, `parallel/lora.py::
stack_adapters`): each slot's adapter id rides in `cache["adapter"]`,
set by `submit(..., adapter_id=)` (0 = the base model).

Prefix caching (`prefix_ids=`): the shared prefix is prefilled once into
a one-lane cache; each admission prefills only its suffix through a
non-donating step that reads that lane in place.

`DraftLanes` holds a speculative draft decoder's flat per-slot lanes and
proposes k greedy tokens a round in one catch-up step plus k-1 T=1
steps: the seam a paged server's speculative mode rides.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any

import numpy as np
import torch

from defer_tpu_torch.constrain import runtime as crt
from defer_tpu_torch.models.gpt import (
    sample_token_batched,
    sample_token_batched_nosort,
    sample_token_batched_nosort_u,
    sample_token_batched_u,
)
from defer_tpu_torch.obs.serving import ServerStats, ServingMetrics
from defer_tpu_torch.parallel.lora import adapter_bank_info
from defer_tpu_torch.runtime.batching import host_lists, window_drain_order
from defer_tpu_torch.runtime.stopping import matcher_or_none, normalize_stops

_DEAD_END = (
    "constraint dead end: DFA state admits no token and is not accepting"
)



# One lock a card: a warm-up and capture holds it, so that two servers on
# one card (fleet replicas, each on its own thread) never capture at once.
_CAPTURE_LOCKS: dict = collections.defaultdict(threading.Lock)


def capture_graph(body, device: torch.device, warm_up) -> "torch.cuda.CUDAGraph":
    """Warm `body` up with `warm_up()`, then capture it into a CUDA graph
    on `device`. Servers on other threads of the same card go on ticking
    meanwhile (allocating, copying to the host, synchronizing their own
    streams), so the capture is thread-local
    (`capture_error_mode="thread_local"`: in the default global mode
    their next such call would break it); their work runs on their own
    streams, which the capture stream, a non-blocking one, does not
    join. What no thread may do while a stream of the card captures is
    synchronize the whole device, as a warm-up ends and as a capture
    begins: so the two happen under the card's capture lock, and one
    card's captures take turns. A failed capture raises."""
    graph = torch.cuda.CUDAGraph()
    with _CAPTURE_LOCKS[device.index], torch.no_grad():
        warm_up()
        torch.cuda.synchronize(device)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            body()
    return graph

class SlotSampler:
    """Per-slot sampling state: one generator per sampled slot plus the
    policy vectors (on the device) the batched sampler reads. A slot
    admitted with SamplingParams draws inside the shared tick from its
    OWN generator (seeded with the request's seed, one (1, V) draw per
    emitted token, the schedule solo generate follows). Greedy slots
    keep the argmax fast path and draw nothing. Every device row is
    written in place, so a captured decode window reads the current
    policy at each replay."""

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
        # Constrained decoding: which stacked constraint table (cid, 0 =
        # the free row) and the current DFA state, per slot; the host
        # mirror routes ticks through the constrained variants only
        # while a constrained row is live.
        self.cid = torch.zeros((max_batch,), dtype=torch.int32,
                               device=device)
        self.cstate = torch.zeros((max_batch,), dtype=torch.int32,
                                  device=device)
        self.row_constrained = [False] * max_batch

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

    def admit_constraint(self, i: int, cid: int, state) -> None:
        """Install slot i's constraint rows: cid into the server's
        stacked tables, and the DFA state after the admission's first
        token (a device scalar, no sync)."""
        self.cid[i] = cid
        self.cstate[i] = state
        self.row_constrained[i] = True

    def release(self, i: int) -> None:
        """Retire slot i's policy the moment its request finishes: a
        stale row_sort would drag later ticks through the sorting
        sampler, and stale filter or constraint rows would leak into a
        later admission. Greedy free rows are already released."""
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
        if self.row_constrained[i]:
            self.cid[i] = 0
            self.cstate[i] = 0
            self.row_constrained[i] = False

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

    def fill_uniforms(self, u: torch.Tensor) -> None:
        """A window's uniforms into the static [K, B, V] buffer `u`:
        each sampled slot's K (1, V) draws from its own generator, in
        the order K ticks would draw them; 0.5 for rows without a
        generator (their draw is discarded)."""
        K, _, V = u.shape
        for i, gen in enumerate(self.generators):
            if gen is None:
                u[:, i].fill_(0.5)
                continue
            for s in range(K):
                u[s, i] = torch.rand((1, V), generator=gen,
                                     device=self.device)[0]

    def window_mode(self, sampling: bool) -> str:
        """The sampling mode of a window: argmax while no live slot
        samples, the sort-free draw while none needs top-k/top-p."""
        if not sampling:
            return "argmax"
        return "sort" if any(self.row_sort) else "nosort"


class DraftLanes:
    """Per-slot flat lanes for a speculative DRAFT decoder: the
    draft-side bookkeeping a paged server's speculative mode rides.

    The draft keeps a plain flat cache of max_batch lanes. Host-side
    `pos` is the truth for how many committed tokens each lane covers:
    the caller passes it down every round (idle rows pinned to 0), so
    position drift from dummy rows cannot accumulate.

    `propose()` is one round: a [B, 2] catch-up step consumes each
    slot's 1-2 committed-but-unconsumed tokens (1 after a rejection, 2
    after a full accept), then k-1 single-token greedy steps emit the
    remaining proposals, each through `flash_decode` on a CUDA draft.
    Slots with lag 1 feed their token twice and advance by 1: the
    duplicate row is written at pos+1 and overwritten by the first
    T=1 step."""

    def __init__(
        self,
        dec: Any,
        params: dict,
        max_batch: int,
        *,
        target: Any = None,
    ):
        if getattr(dec, "rolling_cache", False):
            raise ValueError(
                "a rolling-cache draft cannot rewind rejected rows"
            )
        if getattr(dec, "decode_step_fn", None) is None:
            raise ValueError(
                "the draft decoder must expose decode_step_fn() "
                f"(models/gpt.py GptDecoder); {type(dec).__name__} "
                "does not"
            )
        if target is not None:
            self._check_geometry(dec.cfg, target.cfg)
        self.dec = dec
        self.params = params
        self.B = max_batch
        cache = dec.init_cache(max_batch)
        self.ck = cache["k"]
        self.cv = cache["v"]
        self.pos = np.zeros((max_batch,), np.int32)

    def admit(self, i: int, prompt: torch.Tensor) -> None:
        """Prefill slot i's lane with the request's full prompt
        (pow2-bucketed) and copy it into the lane. Afterwards the lane
        covers the t0 prompt tokens."""
        t0 = prompt.shape[1]
        pad = min(1 << (t0 - 1).bit_length(), self.dec.cfg.max_len)
        prompt = prompt.to(self.ck.device)
        padded = torch.cat([prompt, prompt.new_zeros((1, pad - t0))], dim=1)
        _, small = self.dec.make_step()(
            self.params, self.dec.init_cache(1), padded
        )
        self.ck[:, i] = small["k"][:, 0]
        self.cv[:, i] = small["v"][:, 0]
        self.pos[i] = t0

    @staticmethod
    def _check_geometry(draft_cfg, target_cfg) -> None:
        """Draft-vs-target geometry gates, each with the fix spelled
        out: proposals are target-vocab token ids, and kv_heads and the
        position encoding must match the verifier's."""
        if draft_cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft vocab_size={draft_cfg.vocab_size} != target "
                f"vocab_size={target_cfg.vocab_size}: proposals are "
                "target-vocab token ids. Fix: build the draft from the "
                "target with models/transplant.py::make_draft (it "
                "preserves the vocabulary), or retrain the draft on "
                "the target's tokenizer."
            )
        if draft_cfg.kv_heads != target_cfg.kv_heads:
            raise ValueError(
                f"draft kv_heads={draft_cfg.kv_heads} != target "
                f"kv_heads={target_cfg.kv_heads}. Fix: carve the draft "
                "with make_draft(width=...): it prunes QUERY heads to "
                "a multiple of the target's kv_heads and never touches "
                "the KV width."
            )
        if draft_cfg.pos_style != target_cfg.pos_style:
            raise ValueError(
                f"draft pos_style={draft_cfg.pos_style!r} != target "
                f"pos_style={target_cfg.pos_style!r}: the two models "
                "would disagree about every position. Fix: make_draft "
                "keeps the target's position encoding; use it."
            )
        if (
            draft_cfg.pos_style == "rope"
            and draft_cfg.rope_theta != target_cfg.rope_theta
        ):
            raise ValueError(
                f"draft rope_theta={draft_cfg.rope_theta} != target "
                f"rope_theta={target_cfg.rope_theta}: rotary frequency "
                "bases must match. Fix: make_draft preserves rope_theta; "
                "rebuild the draft with it."
            )

    def release(self, i: int) -> None:
        """Clear lane i completely: pos back to 0 and its K/V zeroed."""
        self.pos[i] = 0
        self.ck[:, i] = 0
        self.cv[:, i] = 0

    def release_all(self) -> None:
        """Drop every lane."""
        self.pos[:] = 0
        self.ck.zero_()
        self.cv.zero_()

    def _upload(self, posm, feed2, adv):
        """Host round inputs on the lanes' device, as int32."""
        dev = self.ck.device
        return tuple(
            # analysis: ignore[host-sync-in-hot-loop] host int arrays (the
            # draft's seeds) going up, not down: np.asarray of host data syncs
            # nothing
            torch.as_tensor(np.asarray(a), dtype=torch.int32).to(dev)
            for a in (posm, feed2, adv)
        )

    def _catch_up(self, dpos, feed2, adv):
        """The [B, 2] catch-up step: (logits of the last real pending
        token [B, V], per-slot positions after it)."""
        raw = self.dec.decode_step_fn()
        logits2, _ = raw(
            self.params, {"k": self.ck, "v": self.cv, "pos": dpos}, feed2
        )
        # Row adv-1 is the prediction after the last real pending token;
        # later rows are duplicate-feed noise.
        first_l = torch.gather(
            logits2, 1,
            (adv - 1).clamp(min=0).long()[:, None, None].expand(
                -1, 1, logits2.shape[-1]),
        )[:, 0, :]
        return first_l, dpos + adv

    def _step(self, pos, tok):
        logits, out = self.dec.decode_step_fn()(
            self.params, {"k": self.ck, "v": self.cv, "pos": pos},
            tok[:, None],
        )
        return logits[:, -1, :], out["pos"]

    def propose(self, k, posm, feed2, adv):
        """One round: catch up on pending committed tokens, then emit k
        greedy proposals per slot. `posm` [B] = host-truth lane
        coverage, non-speculating rows 0; `feed2` [B, 2] pending tokens
        (lag-1 rows duplicated); `adv` [B] in {0, 1, 2} = real pending
        count. Returns device [B, k] int32 proposals (garbage rows for
        adv=0 slots: the caller masks by slot). Lane coverage afterwards
        is posm + adv + k - 1 for speculating rows."""
        return self.propose_dev(k, *self._upload(posm, feed2, adv))

    def propose_dev(self, k, dpos, feed2, adv):
        """propose() on int32 device inputs (dpos [B], feed2 [B, 2],
        adv [B]): no host value is read, so it also runs inside a
        captured CUDA graph (the paged server's speculative window)."""
        first_l, pos = self._catch_up(dpos, feed2, adv)
        tok = torch.argmax(first_l, dim=-1).to(torch.int32)
        props = [tok]
        for _ in range(k - 1):
            lg, pos = self._step(pos, tok)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            props.append(tok)
        return torch.stack(props, dim=1)

    def propose_c(self, k, posm, feed2, adv, eos, cid, cstate, ctrans,
                  cacc):
        """Constrained twin of propose(): each proposal's argmax is
        masked by the slot's DFA row, and a local DFA state walks
        forward with the proposals, so a constrained slot's draft chain
        stays inside its grammar. `cstate` is the committed per-slot
        state. Free rows (cid 0) fold an all-True mask: their proposals
        equal propose()'s. The policy is the tick's (constrain/runtime.py
        `constrained_pick`): a dead local state proposes eos."""
        return self.propose_c_dev(k, *self._upload(posm, feed2, adv), eos,
                                  cid, cstate, ctrans, cacc)

    def propose_c_dev(self, k, dpos, feed2, adv, eos, cid, cstate, ctrans,
                      cacc):
        """propose_c() on int32 device inputs, as propose_dev()."""
        every = torch.ones_like(cid, dtype=torch.bool)

        def pick(logits, cs):
            ll, _, settle, _ = crt.constrained_pick(
                ctrans, cacc, logits, cid, cs, every, eos
            )
            return settle(torch.argmax(ll, dim=-1).to(torch.int32))

        first_l, pos = self._catch_up(dpos, feed2, adv)
        tok, cs = pick(first_l, cstate)
        props = [tok]
        for _ in range(k - 1):
            lg, pos = self._step(pos, tok)
            tok, cs = pick(lg, cs)
            props.append(tok)
        return torch.stack(props, dim=1)


@dataclasses.dataclass
class _Slot:
    req: int | None = None
    remaining: int = 0
    last: Any = None  # next token to feed, [1, 1]
    toks: list | None = None
    sampling: bool = False  # this request runs at temperature > 0
    stop: Any = None  # per-request StopMatcher (runtime/stopping.py)
    cid: int = 0  # stacked-constraint index (0 = unconstrained)


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
        serving thread between ticks, in decode_window=1 order.

        `eos_id`: stop token; a request that emits it finishes at once
        (its output ends with the eos) and its slot re-admits the next
        queued request, so num_steps is a budget, not an exact length.

        `decode_window`: decode sub-steps a host dispatch (the module
        docstring); outputs stay token-identical to decode_window=1.

        `constraints`: named constraint DFAs ({name: TokenDFA},
        compiled against this decoder's vocabulary) a request selects
        with SamplingParams(constraint=name). Requires `eos_id`."""
        if decode_window < 1:
            raise ValueError(
                f"decode_window must be >= 1, got {decode_window}"
            )
        if decode_window > 1 and getattr(dec, "decode_step_fn", None) is None:
            raise ValueError(
                "decode_window > 1 needs a decoder exposing "
                "decode_step_fn() (models/gpt.py GptDecoder); "
                f"{type(dec).__name__} does not"
            )
        self.decode_window = decode_window
        self.dec = dec
        self.params = params
        self.B = max_batch
        self.device = dec.device
        self.step = dec.make_step()  # batched ticks, in place
        cache = dec.init_cache(max_batch)
        cache["pos"] = torch.zeros((max_batch,), dtype=torch.int32,
                                   device=self.device)
        # Multi-LoRA serving: adapter banks in the params make the slot
        # -> adapter assignment per-slot cache state; id 0 = base model.
        n_adapters = adapter_bank_info(params)
        self.multi_lora = n_adapters is not None
        if self.multi_lora:
            cache["adapter"] = torch.zeros((max_batch,), dtype=torch.int32,
                                           device=self.device)
            self.num_adapters = n_adapters
        self.cache = cache
        self.rolling = getattr(dec, "rolling_cache", False)
        self.prefix_len = 0
        self._prefix_cache = None
        if prefix_ids is not None:
            if self.multi_lora:
                raise ValueError(
                    "prefix caching + multi-LoRA is unsupported: the "
                    "shared prefix K/V would be adapter-dependent"
                )
            if self.rolling:
                raise ValueError(
                    "prefix caching over a rolling cache is not "
                    "supported (prefix rows would be recycled)"
                )
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
        # Constrained decoding tables: stacked [C, S_max, V] transitions
        # and [C, S_max] accepting bits, cid 0 the free row. None when
        # the feature is off: every tick then takes the path it takes
        # without constraints.
        self._ctrans = None
        self._cacc = None
        self._cnames: dict[str, int] = {}
        self._cdfas: list = [None]
        if constraints is not None:
            if eos_id is None:
                raise ValueError(
                    "constraints= requires eos_id: a satisfied "
                    "constraint stops by emitting eos"
                )
            self._cnames, self._ctrans, self._cacc = crt.stack_token_dfas(
                constraints, dec.cfg.vocab_size, self.device
            )
            self._cdfas += [
                constraints[n]
                for n in sorted(self._cnames, key=self._cnames.get)
            ]
        # Per-request constraint failures (hand-built DFA dead ends).
        self.errors: dict[int, str] = {}
        self.constrained_tokens_n = 0
        self.constraint_dead_ends_n = 0
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
        # Host dispatches of the decode program and tokens accepted from
        # them; at decode_window=1, dispatches == ticks.
        self.dispatches = 0
        self.window_tokens = 0
        # Captured windows replayed, and the flash_decode launches they
        # made on the card (K x layers a replay of a flat decoder);
        # flash_decode.launches counts host-side launches only.
        self.graph_replays = 0
        self.graph_captures = 0
        self.window_kernel_launches = 0
        self._wbuf = self._window_buffers() if decode_window > 1 else None
        # Captured windows by (mode, constrained); each graph is bound to
        # this server's buffers, so it lives and dies with the server.
        self._graphs: dict[tuple, torch.cuda.CUDAGraph] = {}
        self.obs = ServingMetrics("flat")
        self._submit_t: dict[int, float] = {}
        self._last_tick_t: float | None = None

    # -- public API -------------------------------------------------------

    def submit(
        self,
        prompt_ids: torch.Tensor,
        num_steps: int,
        *,
        adapter_id: int = 0,
        sampling: Any = None,
        stop: Any = None,
    ) -> int:
        """Queue a request [1, T]; returns its id (resolved in .done).
        `adapter_id`: the request's LoRA adapter when banks are attached
        (0 = base model). `sampling`: an optional SamplingParams (None
        or temperature 0 = greedy; its `constraint` applies either way).
        `stop`: optional multi-token stop sequences; the request
        finishes the moment its generated tail equals one of them, its
        output ending with it."""
        if prompt_ids.shape[0] != 1:
            raise ValueError("submit one request at a time ([1, T])")
        cid = 0
        if sampling is not None:
            sampling.validate()
            # The constraint survives the greedy normalization below.
            cid = self._resolve_constraint(sampling.constraint)
            if sampling.temperature == 0:
                sampling = None  # greedy: keep the argmax fast path
        stop_seqs = normalize_stops(stop)
        if adapter_id:
            if not self.multi_lora:
                raise ValueError(
                    "adapter_id set but params carry no adapter banks "
                    "(parallel/lora.py::stack_adapters)"
                )
            if not 0 <= adapter_id < self.num_adapters:
                raise ValueError(
                    f"adapter_id {adapter_id} out of range "
                    f"[0, {self.num_adapters})"
                )
        t0 = prompt_ids.shape[1]
        if t0 < 1:
            raise ValueError("prompt must have at least one token")
        if num_steps < 1:
            raise ValueError(
                f"num_steps={num_steps}: need at least one generated "
                "token (a non-positive count would never complete)"
            )
        if (
            not self.rolling
            and self.prefix_len + t0 + num_steps > self.dec.cfg.max_len
        ):
            raise ValueError(
                f"prefix {self.prefix_len} + prompt {t0} + steps "
                f"{num_steps} exceeds max_len {self.dec.cfg.max_len}"
            )
        rid = self._next_id
        self._next_id += 1
        self.pending.append(
            (rid, prompt_ids.to(self.device), num_steps, adapter_id,
             sampling, stop_seqs, cid)
        )
        self.solo_steps += num_steps
        self._submit_t[rid] = time.perf_counter()
        return rid

    def _resolve_constraint(self, name: str | None) -> int:
        return crt.resolve_constraint(
            name, self._ctrans, self._cnames, self._cdfas
        )

    def run(self) -> dict[int, torch.Tensor]:
        """Serve until every submitted request completes; returns
        {request_id: ids [1, T0 + num_steps]} (shorter when eos or a
        stop sequence ended a request early)."""
        while self.pending or any(s.req is not None for s in self.slots):
            self._admit()
            self._tick()
        return self.done

    # -- internals --------------------------------------------------------

    def _small_cache(self, adapter_id: int) -> dict:
        small = self.dec.init_cache(1)
        if self.multi_lora:
            small["adapter"] = torch.full((1,), adapter_id,
                                          dtype=torch.int32,
                                          device=self.device)
        return small

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.req is not None or not self.pending:
                continue
            (rid, prompt, steps, adapter_id, samp, stop_seqs,
             cid) = self.pending.popleft()
            t0 = prompt.shape[1]
            self.obs.requests_admitted.inc()
            self.obs.prefill_tokens.inc(t0)
            self.obs.queue_wait.observe(
                time.perf_counter() - self._submit_t[rid]
            )
            P = self.prefix_len
            win = self.dec.cfg.window if self.rolling else None
            if self.rolling and t0 > win:
                # Longer-than-window prompt: window-chunked rolling
                # prefill (padding a rolling step on a warm cache would
                # evict live slots).
                last, small = self.dec.prefill(
                    self.params, self._small_cache(adapter_id), prompt,
                    chunk=win,
                )
                first = self._first_token(i, samp, last, prompt.dtype, cid)
                self._install_lane(
                    i, slot, rid, steps, prompt, small, first, t0,
                    adapter_id, samp, stop_seqs, cid,
                )
                continue
            # Bucketed prefill, capped so the padded write stays inside
            # the cache (submit guarantees P + t0 <= max_len); a rolling
            # admission starts from a fresh lane, so its pad rows hold
            # negative positions (masked) and the window caps the bucket.
            pad = 1 << (t0 - 1).bit_length()
            pad = min(pad, win if self.rolling else self.dec.cfg.max_len - P)
            padded = torch.cat(
                [prompt, prompt.new_zeros((1, pad - t0))], dim=1
            )
            if self._prefix_cache is None:
                logits, small = self.step(
                    self.params, self._small_cache(adapter_id), padded
                )
            else:
                # Suffix prefill through a non-donating step: the master
                # prefix lane is read, never written.
                logits, small = self.dec.make_step(donate=False)(
                    self.params, self._prefix_cache, padded
                )
            first = self._first_token(
                i, samp, logits[:, t0 - 1, :], prompt.dtype, cid
            )
            self._install_lane(
                i, slot, rid, steps, prompt, small, first, P + t0,
                adapter_id, samp, stop_seqs, cid,
            )

    def _first_token(self, i, samp, lrow, dtype, cid):
        """Admission's first generated token: a constrained slot masks
        the prefill logits row with its DFA's start-state row before the
        argmax or first draw, then installs the advanced state (a device
        scalar: no sync beyond the admission's own)."""
        if cid:
            # Submit refused a dead start state, so no row is dead here.
            cidv = torch.full((1,), cid, dtype=torch.int32,
                              device=self.device)
            lrow, _, settle, frac = crt.constrained_pick(
                self._ctrans, self._cacc, lrow, cidv, torch.zeros_like(cidv),
                torch.ones((1,), dtype=torch.bool, device=self.device),
                self.eos_id,
            )
        first = self._sampler.admit_first(i, samp, lrow, dtype)
        if cid:
            _, state = settle(first[0].long())
            self._sampler.admit_constraint(i, cid, state[0])
            # analysis: ignore[host-sync-in-hot-loop] once a constrained
            # admission (its first token), not a tick
            self.obs.constrain_masked_frac.observe(float(frac[0]))
            self.obs.constrained_tokens.inc()
            self.constrained_tokens_n += 1
        return first

    def _install_lane(
        self, i, slot, rid, steps, prompt, small, first, pos_val,
        adapter_id=0, samp=None, stop_seqs=(), cid=0,
    ) -> None:
        """Copy the prefilled rows into slot i's lane (rows [0, pos_val),
        or the whole lane of a rolling cache that wrapped; rows past
        pos_val are stale and never read), set the slot's state, and
        run the eos/streaming/finish bookkeeping."""
        n = min(pos_val, self.cache["k"].shape[3])
        self.cache["k"][:, i, :, :n] = small["k"][:, 0, :, :n]
        self.cache["v"][:, i, :, :n] = small["v"][:, 0, :, :n]
        self.cache["pos"][i] = pos_val
        if self.multi_lora:
            self.cache["adapter"][i] = adapter_id
        self._active[i] = True
        if self._wbuf is not None:
            self._wbuf["budget"][i] = steps - 1
        self.obs.ttft.observe(time.perf_counter() - self._submit_t.pop(rid))
        self.obs.tokens_generated.inc()
        slot.req = rid
        slot.remaining = steps - 1
        slot.last = first
        slot.toks = [prompt, first]
        slot.sampling = samp is not None
        slot.stop = matcher_or_none(stop_seqs)
        slot.cid = cid
        self._feed[i, 0] = first[0, 0]
        need_host = (
            self.eos_id is not None
            or self.on_token is not None
            or slot.stop is not None
        )
        # analysis: ignore[host-sync-in-hot-loop] once an admission, only for
        # a consumer of host tokens (eos, stops, streaming)
        tok_host = int(first[0, 0]) if need_host else None
        if self.eos_id is not None and tok_host == self.eos_id:
            slot.remaining = 0
        if slot.stop is not None and slot.stop.push(tok_host):
            slot.remaining = 0
        if self.on_token is not None:
            self.on_token(rid, tok_host, slot.remaining == 0)
        if slot.remaining == 0:
            self._finish(i, slot)

    def _note_dispatch(self, n_active: int) -> None:
        self.ticks += 1
        self.dispatches += 1
        now = time.perf_counter()
        if self._last_tick_t is not None:
            self.obs.itl.observe(now - self._last_tick_t, n_active)
        self._last_tick_t = now
        self.obs.ticks.inc()
        self.obs.host_dispatches.inc()

    def _tick(self) -> None:
        if self.decode_window > 1:
            return self._tick_window()
        active = [s.req is not None for s in self.slots]
        if not any(active):
            return
        logits, cache = self.step(self.params, self.cache, self._feed)
        n_active = sum(active)
        self._note_dispatch(n_active)
        self.obs.tokens_per_dispatch.set(float(n_active))
        self.window_tokens += n_active
        self.obs.tokens_generated.inc(n_active)
        # Inactive slots wrote a dummy row at their position; pin them
        # back to 0 so they never creep toward max_len.
        cache["pos"] = torch.where(self._active, cache["pos"], 0)
        self.cache = cache
        ll = logits[:, -1, :]
        sm = self._sampler
        # Constrained rows: fold the DFA mask into the logits before the
        # argmax/draw, advance the states after. Guarded by the host
        # mirror, so unconstrained serving runs the ops it always ran.
        # A dead end (hand-built DFAs only; dfa.py prunes) is forced to
        # eos so the row freezes; the loop below drops the forced token
        # and surfaces the error.
        constrained = any(sm.row_constrained)
        if constrained:
            ll, dead, settle, mfrac = crt.constrained_pick(
                self._ctrans, self._cacc, ll, sm.cid, sm.cstate,
                self._active, self.eos_id,
            )
        if any(s.req is not None and s.sampling for s in self.slots):
            nxt = sm.draw(ll)
        else:
            nxt = torch.argmax(ll, dim=-1)  # (B,)
        if constrained:
            nxt, sm.cstate = settle(nxt)
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
        # One transfer of the host tokens and, only while a constrained
        # row is live, the dead-end flags; the masked fractions (floats)
        # in a second.
        got = iter(host_lists(([nxt] if need_host else [])
                              + ([dead] if constrained else [])))
        host_nxt = next(got) if need_host else None
        if constrained:
            dead_host = next(got)
            # analysis: ignore[host-sync-in-hot-loop] the masked fractions are
            # floats, so they follow the tick's int transfer in a second; only
            # while a constrained row is live
            mfrac_host = mfrac.tolist()
        for i, slot in enumerate(self.slots):
            if slot.req is None:
                continue
            if constrained and slot.cid:
                if dead_host[i]:
                    # The forced eos never enters the output: the
                    # request ends at its last admissible token.
                    self.errors[slot.req] = _DEAD_END
                    self.constraint_dead_ends_n += 1
                    self.obs.constrain_dead_ends.inc()
                    slot.remaining = 0
                    self._finish(i, slot)
                    continue
                self.constrained_tokens_n += 1
                self.obs.constrained_tokens.inc()
                self.obs.constrain_masked_frac.observe(mfrac_host[i])
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

    # -- decode windows -------------------------------------------------

    def _window_buffers(self) -> dict:
        """The window's static buffers beside the cache, the feed and
        the active mask (`_active`, which the window freezes in place):
        each row's remaining budget (written at admission, decremented
        by the window's count on the device, so a window needs no
        host-to-device copy), the per-row token count, the [B, K]
        tokens, the [K, B, V] uniforms, and the constrained outputs
        (dead-end flags, [B, K] masked fractions)."""
        B, K, dev = self.B, self.decode_window, self.device
        V = self.dec.cfg.vocab_size
        return {
            "budget": torch.zeros((B,), dtype=torch.int32, device=dev),
            "n": torch.zeros((B,), dtype=torch.int32, device=dev),
            "toks": torch.zeros((B, K), dtype=torch.int64, device=dev),
            "u": torch.full((K, B, V), 0.5, device=dev),
            "died": torch.zeros((B,), dtype=torch.bool, device=dev),
            "fracs": torch.zeros((B, K), device=dev),
        }

    def _window_body(self, mode: str, constrained: bool):
        """The K sub-steps of one window over the static buffers, in
        place: a closure the CPU runs eagerly and a CUDA decoder
        captures. Each sub-step: the raw T=1 step; inactive rows' pos
        pinned to 0 with the sub-step-start mask; the constraint fold
        (constrained windows); the draw in `mode`; the token counted
        against the budget; rows that hit eos or their budget frozen."""
        K, eos = self.decode_window, self.eos_id
        raw = self.dec.decode_step_fn()
        w = self._wbuf
        sm = self._sampler
        params, cache, feed = self.params, self.cache, self._feed
        active, n = self._active, w["n"]

        def body():
            n.zero_()
            if constrained:
                w["died"].zero_()
            for s in range(K):
                logits, out = raw(params, cache, feed)
                cache["pos"].copy_(torch.where(active, out["pos"], 0))
                ll = logits[:, -1, :]
                if constrained:
                    ll, dead, settle, frac = crt.constrained_pick(
                        self._ctrans, self._cacc, ll, sm.cid, sm.cstate,
                        active, eos,
                    )
                if mode == "argmax":
                    nxt = torch.argmax(ll, dim=-1)
                elif mode == "nosort":
                    nxt = sample_token_batched_nosort_u(
                        ll, w["u"][s], sm.temp, sm.minp
                    )
                else:
                    nxt = sample_token_batched_u(
                        ll, w["u"][s], sm.temp, sm.topk, sm.topp, sm.minp
                    )
                if constrained:
                    nxt, state = settle(nxt)
                    sm.cstate.copy_(state)
                    w["fracs"][:, s].copy_(frac)
                    w["died"].logical_or_(dead)
                n.add_(active.to(torch.int32))
                alive = active & (n < w["budget"])
                if eos is not None:
                    alive &= nxt != eos
                active.copy_(alive)
                feed.copy_(nxt[:, None])
                w["toks"][:, s].copy_(nxt)

        return body

    def _window_program(self, mode: str, constrained: bool):
        """The window for (mode, constrained): the eager body on a CPU
        decoder; on a CUDA decoder its CUDA graph, captured once and
        kept on this server (K and eos are the server's own), so it is
        freed with the buffers it was captured on."""
        if self.device.type != "cuda":
            return self._window_body(mode, constrained)
        key = (mode, constrained)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._capture(self._window_body(mode, constrained))
            self.graph_captures += 1
            self._graphs[key] = graph
        return graph.replay

    def _capture(self, body) -> torch.cuda.CUDAGraph:
        """Warm the body up, then capture it. The warm-up (lazy library
        and kernel-attribute setup, the kernels' launch plans) runs the
        K sub-steps with every row inactive at the cache's last row:
        its writes land on rows 0 and S-1 of each lane, which are saved
        before and restored after with every other state the body
        writes, so it changes nothing the server holds."""
        sm, cache = self._sampler, self.cache

        def warm_up():
            state = (cache["pos"], self._feed, self._active, sm.cstate)
            saved = [t.clone() for t in state]
            last = cache["k"].shape[3] - 1
            rows = [(t, r, t[:, :, :, r].clone())
                    for t in (cache["k"], cache["v"]) for r in (0, last)]
            self._active.zero_()
            cache["pos"].fill_(last)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                body()
            torch.cuda.current_stream(self.device).wait_stream(side)
            for t, r, old in rows:
                t[:, :, :, r] = old
            for t, old in zip(state, saved):
                t.copy_(old)

        return capture_graph(body, self.device, warm_up)

    def _tick_window(self) -> None:
        """One dispatch of up to decode_window tokens per active slot;
        one batched host transfer drains the [B, K] token buffer (plus
        the per-slot valid-length and alive vectors when eos is
        configured)."""
        active = [s.req is not None for s in self.slots]
        if not any(active):
            return
        K = self.decode_window
        sm = self._sampler
        sampling = any(s.req is not None and s.sampling for s in self.slots)
        mode = sm.window_mode(sampling)
        constrained = any(sm.row_constrained)
        budget = [
            s.remaining if s.req is not None else 0 for s in self.slots
        ]
        w = self._wbuf
        program = self._window_program(mode, constrained)
        if mode != "argmax":
            sm.fill_uniforms(w["u"])
        program()
        w["budget"].sub_(w["n"])
        if self.device.type == "cuda":
            self.graph_replays += 1
            if not self.rolling:
                self.window_kernel_launches += K * self.dec.cfg.num_layers
        toks = w["toks"].clone()  # the next window overwrites the buffer
        self._note_dispatch(sum(active))
        need_toks = self.on_token is not None or any(
            s.req is not None and s.stop is not None for s in self.slots
        )
        # ONE batched per-window transfer (K tokens amortize it): the
        # valid lengths and alive flags when eos can freeze a row
        # (without eos the device freezes rows on budget alone, which the
        # host already knows), the tokens when they stream or
        # stop-match, a constrained window's dead-end flags; its masked
        # fractions, floats, follow in a second.
        eos = self.eos_id is not None
        wanted = ([w["n"], self._active] if eos else []) + (
            [toks] if need_toks else []) + ([w["died"]] if constrained
                                            else [])
        got = iter(host_lists(wanted))
        if eos:
            emitted, alive_host = next(got), next(got)
        else:
            emitted = [min(b, K) for b in budget]
            alive_host = [b > K for b in budget]
        toks_host = next(got) if need_toks else None
        died_host = next(got) if constrained else None
        # analysis: ignore[host-sync-in-hot-loop] the window's masked
        # fractions (floats) after its one int transfer; only in a constrained
        # window
        fracs_host = w["fracs"].tolist() if constrained else None
        self._drain_window(toks, toks_host, emitted, alive_host, budget,
                           died_host, fracs_host)

    def _drain_window(
        self, toks, toks_host, emitted, alive_host, budget,
        died_host=None, fracs_host=None,
    ) -> None:
        """Host-side window drain, per-token-equivalent to the K=1 tick
        loop: stop sequences truncate the window's overshoot, budgets
        and finishes mirror the per-token bookkeeping, and streaming
        callbacks fire in tick-major order (batching.window_drain_order)
        so consumers see the K=1 interleaving."""
        K = self.decode_window
        accepted = [0] * self.B
        finishing = [False] * self.B
        for i, slot in enumerate(self.slots):
            if slot.req is None:
                continue
            n_i = emitted[i]
            a_i = n_i
            stopped = False
            dead = bool(died_host is not None and died_host[i] and slot.cid)
            if dead:
                # A dead end froze the row with a forced eos (counted in
                # n_i): drop it, so the output ends at the last
                # admissible token and the failure surfaces as an error.
                a_i = n_i - 1
            if slot.stop is not None:
                hit = slot.stop.push_window(toks_host[i][:a_i])
                if hit is not None:
                    a_i, stopped = hit, True
            accepted[i] = a_i
            if a_i < min(budget[i], K):
                self.obs.window_truncated.inc()
            slot.remaining -= a_i
            if stopped or not alive_host[i]:
                # eos froze the row on the device, a stop sequence cut it
                # on drain, or its budget ran out mid-window.
                slot.remaining = 0
            if dead:
                slot.remaining = 0
                self.errors[slot.req] = _DEAD_END
                self.constraint_dead_ends_n += 1
                self.obs.constrain_dead_ends.inc()
            if slot.cid and fracs_host is not None:
                self.constrained_tokens_n += a_i
                if a_i:
                    self.obs.constrained_tokens.inc(a_i)
                for fr in fracs_host[i][:a_i]:
                    self.obs.constrain_masked_frac.observe(fr)
            tok_block = toks[i, :a_i][None, :].to(slot.last.dtype)
            slot.toks.append(tok_block)
            if a_i:
                slot.last = tok_block[:, -1:]
            finishing[i] = slot.remaining == 0
            self.obs.tokens_generated.inc(a_i)
            self.window_tokens += a_i
        self.obs.tokens_per_dispatch.set(float(sum(accepted)))
        if self.on_token is not None:
            for t, i in window_drain_order(accepted, K):
                slot = self.slots[i]
                self.on_token(
                    slot.req, toks_host[i][t],
                    finishing[i] and t == accepted[i] - 1,
                )
        for i, slot in enumerate(self.slots):
            if finishing[i]:
                self._finish(i, slot)

    def _finish(self, i: int, slot: _Slot) -> None:
        self.obs.requests_finished.inc()
        self.done[slot.req] = torch.cat(slot.toks, dim=1)
        slot.req = None
        slot.toks = None
        slot.last = None
        slot.sampling = False
        slot.stop = None
        slot.cid = 0
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
    `saved_prefill_tokens` the prefix rows each admission reused;
    `host_dispatches` and `tokens_per_dispatch`, the mean tokens
    accepted a dispatch; `graph_replays` of captured windows on a CUDA
    decoder). With `prefix_ids`, each prompt is the per-request suffix
    and outputs cover suffix + generation. `constraints={name:
    TokenDFA}` registers grammar constraints a request selects via
    SamplingParams(constraint=name)."""
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
        host_dispatches=srv.dispatches,
        tokens_per_dispatch=(
            srv.window_tokens / srv.dispatches if srv.dispatches else 0.0
        ),
        constrained_tokens=srv.constrained_tokens_n,
        constraint_dead_ends=srv.constraint_dead_ends_n,
        graph_replays=srv.graph_replays,
    )
    return [done[r] for r in rids], stats
