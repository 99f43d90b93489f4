"""GPT-style causal decoder with a KV cache, and its sampling policies.

Counterpart of `defer_tpu/models/gpt.py` (single-device, non-rolling
cache). The design follows the JAX package:

  * static cache buffers [L, B, Hkv, S_max, Dh]; the port writes the new
    K/V rows IN PLACE (`make_step(donate=True)`, the serving
    configuration) where JAX returns a new buffer, and
    `make_step(donate=False)` works on a copy, leaving the caller's
    cache untouched;
  * one step serves prefill (T prompt tokens) and decode (T=1);
  * attention masks by cache position (j <= pos + t), so stale rows past
    the write head never contribute;
  * every T=1 step goes through `ops/flash_decode.py` (the hand-written
    kernel on CUDA tensors, its plain version on CPU tensors); a
    prefill step attends through the masked einsum over the whole
    static cache, as the JAX package computes it outside any kernel.

The cache's write head `pos` is an int32 tensor on the cache's device:
a scalar (all rows at one depth: prefill, generate) or a (B,) vector
(continuous batching, runtime/decode_server.py). A step reads it on the
device and never syncs the host on it; the write lands at
clamp(pos, 0, S - T), which is `lax.dynamic_update_slice`'s clamp, and
the callers' guards (prefill, generate, the server's submit and bucket
cap) keep every write inside the cache, so the clamp never moves one.

Sampling: torch and JAX generators give different streams from the same
seed. The contract is: greedy decoding is token-identical to the JAX
package; `truncate_logits(_batched)` are exactly equal on the same
logits; a categorical draw is the Gumbel-max argmax of the filtered
logits plus noise from one `torch.rand` of shape (B, V) per emitted
token, so the distribution is JAX's and a per-slot generator seeded `s`
reproduces a solo `generate` with a generator seeded `s`.

Not ported yet (ROADMAP Queue 1 item 5): `rolling_cache=True`,
`SpmdGptDecoder`, multi-LoRA adapter banks.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from defer_tpu_torch.models.quant import dequantize_leaf
from defer_tpu_torch.ops.flash_decode import flash_decode
from defer_tpu_torch.parallel.mesh import cuda_devices
from defer_tpu_torch.parallel.transformer_stack import (
    TransformerConfig,
    _layer_norm,
    _rms_norm,
    embed_lookup,
    init_stack,
    norm_apply,
    normal,
    rope_tables,
    rotate,
)


def seen_tokens_mask(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, V] presence mask of `ids` [B, T]. Build it once from the
    prompt, then mark each emitted token with a one-element write."""
    seen = torch.zeros((ids.shape[0], vocab), dtype=torch.bool,
                       device=ids.device)
    return seen.scatter_(1, ids.long(), True)


def repetition_penalty(
    logits: torch.Tensor, seen: torch.Tensor, penalty: float
) -> torch.Tensor:
    """HF semantics: a positive logit of a seen token divides by the
    penalty, a negative one multiplies. `seen` is a [B, V] presence
    mask (seen_tokens_mask) or a [B, T] id array."""
    if penalty == 1.0:
        return logits
    if seen.dtype != torch.bool:
        seen = seen_tokens_mask(seen, logits.shape[-1])
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """exp(x - max) / sum, the formula of jax.nn.softmax (torch's own
    kernel multiplies by the reciprocal of the sum)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _desc(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=-1, descending=True).values


def truncate_logits(
    logits: torch.Tensor,
    *,
    top_k: int = 0,
    top_p: float = 1.0,
    min_p: float = 0.0,
) -> torch.Tensor:
    """Mask logits outside the sampling support to the dtype's min.

    top_k > 0 keeps the k highest logits (ties at the k-th value all
    survive). top_p < 1 keeps the nucleus: tokens whose cumulative
    probability, in descending order, is needed to first reach top_p
    (the top token always survives). min_p > 0 keeps tokens whose
    probability is at least min_p times the top token's."""
    neg = torch.finfo(logits.dtype).min
    if top_k and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if min_p > 0.0:
        probs = _softmax(logits)
        floor = min_p * probs.amax(dim=-1, keepdim=True)
        logits = torch.where(probs < floor, neg, logits)
    if top_p < 1.0:
        desc = _desc(logits)
        probs = _softmax(desc)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        keep[..., 0] = True
        cutoff = torch.where(keep, desc, torch.inf).amin(
            dim=-1, keepdim=True
        )
        logits = torch.where(logits < cutoff, neg, logits)
    return logits


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy for the serving stack: the knobs
    `generate` takes, plus the seed of the slot's own generator.
    temperature 0 = greedy (filters unused). `constraint` names a
    server-registered constraint DFA; constrained decoding is not
    ported yet and the server raises on it."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    seed: int = 0
    constraint: str | None = None

    def validate(self) -> None:
        if self.temperature < 0:
            raise ValueError(f"temperature {self.temperature} < 0")
        if self.top_k < 0:
            raise ValueError(f"top_k {self.top_k} < 0")
        if not 0 < self.top_p <= 1:
            raise ValueError(f"top_p {self.top_p} not in (0, 1]")
        if not 0 <= self.min_p <= 1:
            raise ValueError(f"min_p {self.min_p} not in [0, 1]")


def truncate_logits_batched(
    logits: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    min_p: torch.Tensor,
) -> torch.Tensor:
    """truncate_logits with per-row (B,) parameter tensors: the same
    filters in the same order; a disabled filter (top_k <= 0 or >= V,
    top_p >= 1, min_p <= 0) reduces to a neutral threshold, so each row
    equals truncate_logits on that row with its static parameters."""
    neg = torch.finfo(logits.dtype).min
    v = logits.shape[-1]
    desc = _desc(logits)
    kth = torch.gather(desc, -1, (top_k.clamp(1, v) - 1)[:, None].long())
    kth = torch.where(((top_k > 0) & (top_k < v))[:, None], kth, -torch.inf)
    logits = torch.where(logits < kth, neg, logits)
    probs = _softmax(logits)
    floor = min_p[:, None] * probs.amax(dim=-1, keepdim=True)
    logits = torch.where(probs < floor, neg, logits)
    desc2 = _desc(logits)
    probs2 = _softmax(desc2)
    cum = torch.cumsum(probs2, dim=-1)
    keep = (cum - probs2) < top_p[:, None]
    keep[..., 0] = True
    cutoff = torch.where(keep, desc2, torch.inf).amin(dim=-1, keepdim=True)
    cutoff = torch.where((top_p < 1.0)[:, None], cutoff, -torch.inf)
    return torch.where(logits < cutoff, neg, logits)


def _gumbel_argmax(filtered: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A categorical draw from softmax(filtered) given uniforms u in
    [0, 1): argmax(filtered - log(-log(u))), the Gumbel-max form
    jax.random.categorical uses."""
    return torch.argmax(filtered - torch.log(-torch.log(u)), dim=-1)


def _row_uniforms(generators, shape, device) -> torch.Tensor:
    """(B, V) uniforms: row i from generators[i] (one (1, V) draw, the
    draw a solo generate of that request makes per token), 0.5 for rows
    without a generator (greedy rows; their draw is discarded)."""
    rows = [
        torch.rand((1, shape[1]), generator=g, device=device)
        if g is not None
        else torch.full((1, shape[1]), 0.5, device=device)
        for g in generators
    ]
    return torch.cat(rows)


def sample_token_batched(
    logits_last: torch.Tensor,
    generators: list,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    min_p: torch.Tensor,
) -> torch.Tensor:
    """sample_token with per-row (B,) policies and one generator per row
    (None for greedy rows): each sampled row draws once per emitted
    token from its own generator, so a server slot seeded `s`
    reproduces `generate(..., generator=seeded(s))`. Greedy rows
    (temperature <= 0) take argmax of the raw logits. Returns (B,)."""
    greedy = temperature <= 0
    safe_t = torch.where(greedy, 1.0, temperature)
    filtered = truncate_logits_batched(
        logits_last / safe_t[:, None], top_k, top_p, min_p
    )
    u = _row_uniforms(generators, logits_last.shape, logits_last.device)
    return torch.where(
        greedy, torch.argmax(logits_last, dim=-1), _gumbel_argmax(filtered, u)
    )


def sample_token_batched_nosort(
    logits_last: torch.Tensor,
    generators: list,
    temperature: torch.Tensor,
    min_p: torch.Tensor,
) -> torch.Tensor:
    """sample_token_batched for ticks where no row enables top-k or
    top-p: the two sorts exist only to find those thresholds, which are
    then -inf and mask nothing. Drops them and keeps every op the
    surviving rows see, so each row's token equals sample_token_batched
    with top_k=0 / top_p=1 on that row."""
    greedy = temperature <= 0
    safe_t = torch.where(greedy, 1.0, temperature)
    logits = logits_last / safe_t[:, None]
    neg = torch.finfo(logits.dtype).min
    probs = _softmax(logits)
    floor = min_p[:, None] * probs.amax(dim=-1, keepdim=True)
    filtered = torch.where(probs < floor, neg, logits)
    u = _row_uniforms(generators, logits_last.shape, logits_last.device)
    return torch.where(
        greedy, torch.argmax(logits_last, dim=-1), _gumbel_argmax(filtered, u)
    )


def sample_token(
    logits_last: torch.Tensor,
    generator: torch.Generator | None,
    temperature: float,
    *,
    top_k: int = 0,
    top_p: float = 1.0,
    min_p: float = 0.0,
) -> torch.Tensor:
    """One sampling policy for every decode loop: greedy at temperature
    0 (filters ignored, no draw), otherwise a categorical over
    logits/temperature restricted by truncate_logits, from one (B, V)
    draw of `generator`. Returns token ids (B,)."""
    if temperature <= 0:
        return torch.argmax(logits_last, dim=-1)
    b = logits_last.shape[0]
    # Divide by a tensor, as the batched sampler does: a scalar divisor
    # may be applied as a product with its reciprocal.
    t = torch.full((b, 1), temperature, dtype=logits_last.dtype,
                   device=logits_last.device)
    filtered = truncate_logits(
        logits_last / t, top_k=top_k, top_p=top_p, min_p=min_p
    )
    u = torch.rand(logits_last.shape, generator=generator,
                   device=logits_last.device)
    return _gumbel_argmax(filtered, u)


#: Host-sync cadence for eos early-stop polling: `finished.all()` waits
#: for the card, so the decode loop checks it every K tokens instead of
#: every token.
EOS_POLL_EVERY = 8


def apply_eos(
    nxt: torch.Tensor, finished: torch.Tensor, eos_id: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pin already-finished rows to eos_id BEFORE updating the mask, so
    a row finishes on its first eos emission and stays finished.
    Returns (next_tokens [B, 1], finished [B])."""
    nxt = torch.where(finished[:, None], eos_id, nxt)
    return nxt, finished | (nxt[:, 0] == eos_id)


def sampled_decode_loop(
    step,
    params: dict,
    cache,
    last: torch.Tensor,
    ids: torch.Tensor,
    num_steps: int,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    min_p: float = 0.0,
    rep_penalty: float = 1.0,
    eos_id: int | None = None,
    stop_sequences=None,
    pad_id: int | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """The host-side decode loop: sample from `last`, append to `ids`,
    feed `step(params, cache, nxt)`, with the eos machinery (pin
    finished rows, poll every EOS_POLL_EVERY steps, pad back to the
    [B, T + num_steps] shape). The final sampled token needs no forward.

    `stop_sequences`: multi-token stops (runtime/stopping.py); a row
    whose generated tail completes one stops there, later positions
    pinned to `pad_id` (default eos_id, else 0). Matching is on the
    host, so it costs one device->host token transfer per step."""
    b = ids.shape[0]
    dtype = ids.dtype
    if generator is None and temperature > 0:
        generator = torch.Generator(device=last.device).manual_seed(0)
    finished = (
        torch.zeros((b,), dtype=torch.bool, device=ids.device)
        if eos_id is not None
        else None
    )
    matchers = None
    if stop_sequences:
        from defer_tpu_torch.runtime.stopping import (
            StopMatcher,
            normalize_stops,
        )

        seqs = normalize_stops(stop_sequences)
        matchers = [StopMatcher(seqs) for _ in range(b)]
        stopped = np.zeros((b,), bool)
    pad_tok = (
        pad_id
        if pad_id is not None
        else (eos_id if eos_id is not None else 0)
    )
    seen = None
    steps_done = 0
    for i in range(num_steps):
        if rep_penalty != 1.0:
            if seen is None:
                seen = seen_tokens_mask(ids, last.shape[-1])
            last = repetition_penalty(last, seen, rep_penalty)
        nxt = sample_token(
            last, generator, temperature,
            top_k=top_k, top_p=top_p, min_p=min_p,
        )
        nxt = nxt[:, None].to(dtype)
        if eos_id is not None:
            nxt, finished = apply_eos(nxt, finished, eos_id)
        if matchers is not None:
            if stopped.any():
                # Rows that already hit a stop sequence emit padding.
                pinned = torch.as_tensor(stopped, device=nxt.device)
                nxt = torch.where(pinned[:, None], pad_tok, nxt)
            # The documented price of stop_sequences: one batched [B]
            # transfer per step.
            host_nxt = nxt[:, 0].cpu().numpy()
            # The eos mask rides the same sync: it guards the matchers
            # (an eos-finished row's padding must never stop-match).
            eos_done = (
                finished.cpu().numpy() if eos_id is not None else None
            )
            for r in range(b):
                if stopped[r] or (eos_done is not None and eos_done[r]):
                    continue
                if matchers[r].push(int(host_nxt[r])):
                    stopped[r] = True
        if seen is not None:
            seen.scatter_(1, nxt.long(), True)
        ids = torch.cat([ids, nxt], dim=1)
        steps_done = i + 1
        if matchers is not None:
            done_rows = (
                stopped if eos_done is None else (stopped | eos_done)
            )
            if done_rows.all():
                break
        elif (
            eos_id is not None
            and (i + 1) % EOS_POLL_EVERY == 0
            and bool(finished.all())
        ):
            break
        if i + 1 < num_steps:
            logits, cache = step(params, cache, nxt)
            last = logits[:, -1, :]
    if steps_done < num_steps:
        pad = torch.full(
            (b, num_steps - steps_done),
            eos_id if eos_id is not None and matchers is None else pad_tok,
            dtype=dtype,
            device=ids.device,
        )
        ids = torch.cat([ids, pad], dim=1)
    return ids


def _layer_view(stack: dict, layer: int) -> dict:
    """Layer `layer` of a stacked param tree (views, no copies); int8
    leaves slice q and s together."""
    return {
        k: {kk: vv[layer] for kk, vv in v.items()}
        if isinstance(v, dict)
        else v[layer]
        for k, v in stack.items()
    }


def _resolve_device(device) -> torch.device:
    if device is None:
        return cuda_devices()[0]
    return torch.device(device)


@dataclasses.dataclass
class GptDecoder:
    """Decoder-only transformer with a weight-tied output head (an
    untied `lm_head` is used when the params carry one).

    `device`: where `init` and `init_cache` allocate; None means the
    first CUDA device, and raises without one — pass "cpu" to run on
    the CPU."""

    cfg: TransformerConfig
    compute_dtype: Any = torch.bfloat16
    rolling_cache: bool = False
    device: Any = None
    _steps: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    def __post_init__(self):
        if self.cfg.norm_style != "pre":
            raise ValueError(
                "GptDecoder uses pre-LN blocks: cfg.norm_style must be 'pre'"
            )
        if self.cfg.num_experts:
            raise ValueError("MoE decoder blocks are not supported here")
        if self.cfg.lora_rank:
            raise ValueError(
                "GptDecoder serves merged weights only: fold adapters "
                "into the base weights and build the decoder from a "
                "lora_rank=0 config"
            )
        if self.rolling_cache:
            raise NotImplementedError(
                "rolling_cache=True is not ported yet (ROADMAP Queue 1 "
                "item 5, rolling_cache)"
            )
        self.device = _resolve_device(self.device)

    # -- params / cache ---------------------------------------------------

    def init(self, generator: torch.Generator) -> dict:
        """Random f32 parameters on `self.device`, drawn from `generator`
        (which must live there): the JAX package's distributions, not
        its values."""
        cfg = self.cfg
        dev = self.device
        p = {
            "token_embedding": normal(
                generator, (cfg.vocab_size, cfg.dim), 0.02, device=dev
            ),
            "final_ln_scale": torch.ones((cfg.dim,), device=dev),
            "stack": init_stack(generator, cfg, device=dev),
        }
        if cfg.pos_style == "learned":
            p["pos_embedding"] = normal(
                generator, (cfg.max_len, cfg.dim), 0.02, device=dev
            )
        if cfg.norm_type == "layer":
            p["final_ln_bias"] = torch.zeros((cfg.dim,), device=dev)
        return p

    def cast_params(self, params: dict) -> dict:
        """Float params re-stored in compute_dtype, the serving
        configuration: decode reads every weight once a tick, so f32
        storage costs twice bf16's bytes."""

        def cast(a):
            if isinstance(a, dict):
                return {k: cast(v) for k, v in a.items()}
            return a.to(self.compute_dtype) if a.is_floating_point() else a

        return cast(params)

    def init_cache(self, batch: int) -> dict:
        """Zeroed K/V of [L, batch, Hkv, max_len, Dh] in compute_dtype
        (GQA caches hold the KV heads only) and a scalar write head."""
        cfg = self.cfg
        dh = cfg.dim // cfg.num_heads
        shape = (cfg.num_layers, batch, cfg.kv_heads, cfg.max_len, dh)
        return {
            "k": torch.zeros(shape, dtype=self.compute_dtype,
                             device=self.device),
            "v": torch.zeros(shape, dtype=self.compute_dtype,
                             device=self.device),
            "pos": torch.zeros((), dtype=torch.int32, device=self.device),
        }

    # -- one step (prefill or decode) -------------------------------------

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        dh = self.cfg.dim // self.cfg.num_heads
        return x.reshape(b, t, d // dh, dh).transpose(1, 2)

    def _proj_fns(self, p: dict, dt):
        """The (bias, proj) closures every block stage shares; int8
        leaves ({"q","s"}) widen here."""

        def bias(h, name):
            return h + p[name].to(dt) if name in p else h

        def proj(h, name):
            return h @ dequantize_leaf(p[name], dt)

        return bias, proj

    def _attn_qkv(self, p: dict, x, rope):
        """ln1 + q/k/v projections (+ rotary with the step's tables
        `rope` = (cos, sin), None for learned positions) + head split.
        Returns (q [B,Hq,T,Dh], k, v [B,Hkv,T,Dh])."""
        cfg = self.cfg
        dh = cfg.dim // cfg.num_heads
        bias, proj = self._proj_fns(p, x.dtype)
        h = norm_apply(cfg, x, p, "ln1")
        qf = bias(proj(h, "wq"), "bq")
        kf = bias(proj(h, "wk"), "bk")
        vf = bias(proj(h, "wv"), "bv")
        if rope is not None:
            qf = rotate(qf, dh, *rope)
            kf = rotate(kf, dh, *rope)
        return (
            self._split_heads(qf),
            self._split_heads(kf),
            self._split_heads(vf),
        )

    def _attn_out(self, p: dict, x, attn):
        """wo projection, residual, ln2, FFN; `attn` is the merged
        [B, T, Hq*Dh] attention output."""
        cfg = self.cfg
        bias, proj = self._proj_fns(p, x.dtype)
        x = x + bias(proj(attn, "wo"), "bo")
        h2 = norm_apply(cfg, x, p, "ln2")
        if cfg.ffn_style == "swiglu":
            gate = F.silu(proj(h2, "w1"))
            return x + proj(gate * proj(h2, "w3"), "w2")
        ff = F.gelu(bias(proj(h2, "w1"), "b1"), approximate="tanh")
        return bias(x + proj(ff, "w2"), "b2")

    def _block(self, p: dict, x, k_cache, v_cache, pos, plan: dict):
        """One decoder block on [B, T, D]: writes its T new K/V rows into
        `k_cache`/`v_cache` ([B, Hkv, S, Dh], in place) at the rows of
        `plan` and attends over the updated cache. `plan` holds what the
        step computes once for all layers (`_plan`)."""
        cfg = self.cfg
        dt = x.dtype
        dh = cfg.dim // cfg.num_heads
        q, k, v = self._attn_qkv(p, x, plan["rope"])
        b, h_q, t, _ = q.shape
        rows = plan["rows"]
        if pos.ndim == 1:
            bidx = plan["bidx"]
            k_cache[bidx, :, rows] = k.transpose(1, 2)
            v_cache[bidx, :, rows] = v.transpose(1, 2)
        else:
            k_cache.index_copy_(2, rows, k)
            v_cache.index_copy_(2, rows, v)
        if t == 1:
            # The serving hot path: the live cache rows only, through
            # the flash-decode kernel (its plain version on the CPU).
            attn = flash_decode(q[:, :, 0, :], k_cache, v_cache, pos,
                                window=cfg.window)
            attn = attn.to(dt).reshape(b, t, h_q * dh)
        else:
            hkv = k_cache.shape[1]
            qg = q.reshape(b, hkv, h_q // hkv, t, dh)
            # bf16 products are exact in f32: this is the JAX einsum's
            # preferred_element_type=f32.
            logits = torch.einsum(
                "bkgtd,bksd->bkgts", qg.float(), k_cache.float()
            ) * (dh**-0.5)
            logits = logits.masked_fill(~plan["mask"], -torch.inf)
            weights = torch.softmax(logits, dim=-1).to(dt)
            attn = torch.einsum("bkgts,bksd->bkgtd", weights, v_cache)
            attn = attn.reshape(b, h_q, t, dh).transpose(1, 2)
            attn = attn.reshape(b, t, h_q * dh)
        return self._attn_out(p, x, attn)

    def _plan(self, pos: torch.Tensor, t: int) -> dict:
        """Per-step tensors every layer shares, computed on the device
        from `pos` (no host sync): the cache rows to write, the rotary
        tables, and for T > 1 the attention mask."""
        cfg = self.cfg
        s = cfg.max_len
        dev = pos.device
        steps = torch.arange(t, device=dev)
        # lax.dynamic_update_slice's clamp of the write start.
        start = pos.clamp(0, s - t)
        per_slot = pos.ndim == 1
        plan: dict = {"rope": None}
        if per_slot:
            plan["rows"] = (start[:, None] + steps).long()  # (B, T)
            plan["bidx"] = torch.arange(pos.shape[0], device=dev)[:, None]
        else:
            plan["rows"] = (start + steps).long()  # (T,)
        if cfg.pos_style == "rope":
            positions = pos[:, None] + steps if per_slot else pos + steps
            plan["rope"] = rope_tables(
                cfg.dim // cfg.num_heads, positions, cfg.rope_theta
            )
        if t > 1:
            j = torch.arange(s, device=dev)
            if per_slot:
                tt = pos[:, None] + steps  # (B, T)
                mask = j[None, None, :] <= tt[:, :, None]
                if cfg.window is not None:
                    mask &= j[None, None, :] > tt[:, :, None] - cfg.window
                plan["mask"] = mask[:, None, None, :, :]
            else:
                tt = pos + steps[:, None]  # (T, 1)
                mask = j[None, :] <= tt
                if cfg.window is not None:
                    mask &= j[None, :] > tt - cfg.window
                plan["mask"] = mask
        return plan

    def _step_fn(self, donate: bool):
        """The one step body: embed -> blocks (writing the cache) ->
        final norm -> head. `donate=False` writes into a copy."""

        @torch.no_grad()
        def step(params, cache, ids):
            k_all, v_all = cache["k"], cache["v"]
            if not donate:
                k_all, v_all = k_all.clone(), v_all.clone()
            t = ids.shape[1]
            pos = cache["pos"]
            plan = self._plan(pos, t)
            x = self._embed_tokens(params, ids, pos)
            stack = params["stack"]
            for layer in range(self.cfg.num_layers):
                x = self._block(
                    _layer_view(stack, layer), x, k_all[layer],
                    v_all[layer], pos, plan,
                )
            logits = self._final_logits(params, x)
            return logits, {"k": k_all, "v": v_all, "pos": pos + t}

        return step

    def _embed_tokens(self, params, ids, pos):
        """Token (+ learned position) embedding for a step at write head
        `pos` (scalar, or (B,) per-slot depths)."""
        cfg = self.cfg
        cd = self.compute_dtype
        t = ids.shape[1]
        emb = embed_lookup(params["token_embedding"], ids)
        if cfg.pos_style == "rope":
            return emb.to(cd)
        steps = torch.arange(t, device=pos.device)
        if pos.ndim == 1:
            posv = params["pos_embedding"][pos[:, None] + steps]
        else:
            # lax.dynamic_slice_in_dim's clamp of the start.
            posv = params["pos_embedding"][
                pos.clamp(0, cfg.max_len - t) + steps
            ]
        return (emb + posv).to(cd)

    def _final_logits(self, params, x):
        """Final norm + output head, in f32: tied to the embedding unless
        the params carry a distinct lm_head. The head is widened to f32
        on each call (a bf16 [V, D] table read once and written once
        more as f32); the decoder holds no f32 copy of it."""
        cfg = self.cfg
        xf = x.float()
        if cfg.norm_type == "rms":
            xn = _rms_norm(xf, params["final_ln_scale"], cfg.layer_norm_eps)
        else:
            xn = _layer_norm(
                xf,
                params["final_ln_scale"],
                params["final_ln_bias"],
                cfg.layer_norm_eps,
            )
        head = params.get("lm_head", params["token_embedding"])
        return xn @ dequantize_leaf(head, torch.float32).T

    def stage_params(self, params: dict, first: int, last: int) -> dict:
        """The param subtree a pipeline stage of layers [first, last)
        needs: its slice of the stack (views), plus the embedding tables
        when it holds layer 0 and the final norm + (tied) head when it
        holds the last layer."""
        L = self.cfg.num_layers
        if not (0 <= first < last <= L):
            raise ValueError(
                f"stage layer range [{first}, {last}) out of bounds "
                f"for {L} layers"
            )

        def cut(a):
            if isinstance(a, dict):
                return {k: cut(v) for k, v in a.items()}
            return a[first:last]

        out: dict = {"stack": cut(params["stack"])}
        if first == 0:
            out["token_embedding"] = params["token_embedding"]
            if "pos_embedding" in params:
                out["pos_embedding"] = params["pos_embedding"]
        if last == L:
            out["final_ln_scale"] = params["final_ln_scale"]
            if "final_ln_bias" in params:
                out["final_ln_bias"] = params["final_ln_bias"]
            if "lm_head" in params:
                out["lm_head"] = params["lm_head"]
            else:
                out["token_embedding"] = params["token_embedding"]
        return out

    def make_step(self, *, donate: bool = True):
        """(params, cache, ids [B, T]) -> (logits [B, T, V] f32, cache).
        donate=True (default, serving) writes the new K/V rows into the
        given cache's buffers and returns them; donate=False leaves the
        given cache untouched and returns new buffers. One step object
        per flag and decoder."""
        step = self._steps.get(donate)
        if step is None:
            step = self._steps[donate] = self._step_fn(donate)
        return step

    def decode_step_fn(self):
        """The raw single-step body, as `make_step(donate=True)`."""
        return self.make_step()

    # -- generation --------------------------------------------------------

    def prefill(
        self,
        params: dict,
        cache: dict,
        ids: torch.Tensor,
        *,
        chunk: int | None = None,
    ) -> tuple[torch.Tensor, dict]:
        """Consume a [B, T] prompt into the cache; returns
        (last_logits [B, V], cache). chunk=None runs one T-length step;
        a chunk size runs fixed-size pieces, zero-padding short and tail
        pieces while the padded write stays inside the cache (padded
        rows sit past the rewound head: never attended, later
        overwritten). Works on a warm cache."""
        t0 = ids.shape[1]
        if cache["pos"].ndim != 0:
            raise ValueError(
                "prefill needs a scalar-position cache (per-slot caches "
                "admit through runtime/decode_server.py)"
            )
        # One host sync per prefill (admission time, not per tick), to
        # guard overflow.
        base = int(cache["pos"])
        if base + t0 > self.cfg.max_len:
            raise ValueError(
                f"cache position {base} + prompt {t0} exceeds max_len "
                f"{self.cfg.max_len}"
            )
        step = self.make_step()
        if chunk is None:
            logits, cache = step(params, cache, ids)
            return logits[:, -1, :], cache
        if chunk < 1:
            raise ValueError(f"chunk={chunk} must be >= 1")
        last = None
        for start in range(0, t0, chunk):
            piece = ids[:, start : start + chunk]
            real = piece.shape[1]
            if real < chunk and base + start + chunk <= self.cfg.max_len:
                piece = torch.cat(
                    [piece, piece.new_zeros((ids.shape[0], chunk - real))],
                    dim=1,
                )
            logits, cache = step(params, cache, piece)
            last = logits[:, real - 1, :]
            if piece.shape[1] > real:
                # Rewind the write head past the padded rows.
                cache = {**cache, "pos": cache["pos"] - (chunk - real)}
        return last, cache

    def generate(
        self,
        params: dict,
        prompt_ids: torch.Tensor,
        num_steps: int,
        *,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        min_p: float = 0.0,
        rep_penalty: float = 1.0,
        eos_id: int | None = None,
        stop_sequences=None,
        pad_id: int | None = None,
        generator: torch.Generator | None = None,
        prefill_chunk: int | None = None,
    ) -> torch.Tensor:
        """Greedy (temperature 0) or sampled continuation of
        `prompt_ids` [B, T0]; returns [B, T0 + num_steps] on the
        decoder's device. With `eos_id` set, a sequence that emits it is
        finished: its remaining positions are pinned to eos_id and the
        loop stops early once every sequence has finished. A sampled
        run draws from `generator` (a fresh one seeded 0 when None)."""
        b, t0 = prompt_ids.shape
        if t0 + num_steps > self.cfg.max_len:
            raise ValueError(
                f"prompt {t0} + steps {num_steps} exceeds max_len "
                f"{self.cfg.max_len}"
            )
        prompt_ids = prompt_ids.to(self.device)
        step = self.make_step()
        cache = self.init_cache(b)
        last, cache = self.prefill(
            params, cache, prompt_ids, chunk=prefill_chunk
        )
        return sampled_decode_loop(
            step,
            params,
            cache,
            last,
            prompt_ids,
            num_steps,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            min_p=min_p,
            rep_penalty=rep_penalty,
            eos_id=eos_id,
            stop_sequences=stop_sequences,
            pad_id=pad_id,
            generator=generator,
        )

    # -- reference (no cache reuse) ---------------------------------------

    def reference_logits(self, params: dict, ids: torch.Tensor) -> torch.Tensor:
        """Full causal forward of [B, T] ids (fresh cache, the whole
        sequence in one non-donating step): the correctness oracle for
        incremental decoding."""
        cache = self.init_cache(ids.shape[0])
        logits, _ = self.make_step(donate=False)(
            params, cache, ids.to(self.device)
        )
        return logits


def tiny_gpt(seq_len: int = 32, *, device=None) -> GptDecoder:
    """Small config for tests / CPU."""
    return GptDecoder(
        TransformerConfig(
            num_layers=4,
            dim=64,
            num_heads=4,
            ffn_dim=128,
            vocab_size=128,
            max_len=seq_len,
            norm_style="pre",
        ),
        compute_dtype=torch.float32,
        device=device,
    )
