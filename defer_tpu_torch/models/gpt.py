"""GPT-style causal decoder with a KV cache, and its sampling policies.

Counterpart of `defer_tpu/models/gpt.py` (single-device). The design
follows the JAX package:

  * static cache buffers [L, B, Hkv, S, Dh]; the port writes the new
    K/V rows IN PLACE (`make_step(donate=True)`, the serving
    configuration) where JAX returns a new buffer, and
    `make_step(donate=False)` works on a copy, leaving the caller's
    cache untouched;
  * one step serves prefill (T prompt tokens) and decode (T=1);
  * attention masks by cache position (j <= pos + t), so stale rows past
    the write head never contribute;
  * every T=1 step of a flat cache goes through `ops/flash_decode.py`
    (the hand-written kernel on CUDA tensors, its plain version on CPU
    tensors); a prefill step attends through the masked einsum over the
    whole static cache, as the JAX package computes it outside any
    kernel.

`rolling_cache=True` (sliding-window models with rotary positions):
the cache holds cfg.window slots instead of cfg.max_len and position p
lands in slot p % window, so cache memory is bounded by the window and
generation length is not. The mask follows from the positions the slots
hold: after a T=1 write every slot holds the latest position <= pos
congruent to it, so only never-written slots mask out; a multi-token
step attends over [cache, this step's keys] with explicit absolute
positions, so same-step writes never evict keys a same-step query still
needs (at most `window` tokens a step; `prefill` and `generate` stream a
longer prompt in window-sized chunks). As in the JAX package, a rolling
step does NOT take `flash_decode`: its live rows wrap around the cache,
which the kernel's one contiguous live range cannot express, so every
rolling step attends through the einsum/softmax path.

Multi-LoRA serving: adapter banks attached to the params
(`parallel/lora.py::stack_adapters`) and a per-slot `cache["adapter"]`
(B,) id vector add each row's own low-rank delta to the adapted
projections; one base weight read serves every tenant.

The cache's write head `pos` is an int32 tensor on the cache's device:
a scalar (all rows at one depth: prefill, generate) or a (B,) vector
(continuous batching, runtime/decode_server.py). A step reads it on the
device and never syncs the host on it; a flat cache's write lands at
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

`SpmdGptDecoder` is the tensor-parallel decoder over a process group
(its docstring); its hooks (`_embed_tokens`, `_attn_out`,
`_final_logits`, each with `tp_axis`) are the paged server's too, which
runs them on a plain decoder under `mesh=`. With tp_axis None every hook
runs the single-device program.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from defer_tpu_torch.models.quant import dequantize_leaf
from defer_tpu_torch.ops.flash_decode import flash_decode
from defer_tpu_torch.parallel import collectives
from defer_tpu_torch.parallel.collectives import all_gather, psum
from defer_tpu_torch.parallel.mesh import cuda_devices
from defer_tpu_torch.parallel.spmd_pipeline import check_process_group
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
    shard_tree,
    stack_specs,
)
from defer_tpu_torch.weights import tree_to


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
    constraint DFA registered with the server (`constraints=`,
    defer_tpu_torch/constrain/); it applies at any temperature."""

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
    u = _row_uniforms(generators, logits_last.shape, logits_last.device)
    return sample_token_batched_u(
        logits_last, u, temperature, top_k, top_p, min_p
    )


def sample_token_batched_u(
    logits_last, u, temperature, top_k, top_p, min_p
) -> torch.Tensor:
    """sample_token_batched given the (B, V) uniforms `u` already
    drawn: the part of the draw that runs on the device alone, which a
    captured decode window replays (runtime/decode_server.py)."""
    greedy = temperature <= 0
    safe_t = torch.where(greedy, 1.0, temperature)
    filtered = truncate_logits_batched(
        logits_last / safe_t[:, None], top_k, top_p, min_p
    )
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
    u = _row_uniforms(generators, logits_last.shape, logits_last.device)
    return sample_token_batched_nosort_u(logits_last, u, temperature, min_p)


def sample_token_batched_nosort_u(
    logits_last, u, temperature, min_p
) -> torch.Tensor:
    """sample_token_batched_nosort given the (B, V) uniforms `u`."""
    greedy = temperature <= 0
    safe_t = torch.where(greedy, 1.0, temperature)
    logits = logits_last / safe_t[:, None]
    neg = torch.finfo(logits.dtype).min
    probs = _softmax(logits)
    floor = min_p[:, None] * probs.amax(dim=-1, keepdim=True)
    filtered = torch.where(probs < floor, neg, logits)
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
            # analysis: ignore[host-sync-in-hot-loop] the documented price of
            # stop_sequences: one batched [B] transfer a step, only with stops
            # set
            host_nxt = nxt[:, 0].cpu().numpy()
            # The eos mask rides the same sync: it guards the matchers
            # (an eos-finished row's padding must never stop-match).
            eos_done = (
                # analysis: ignore[host-sync-in-hot-loop] rides the same
                # step's transfer as the tokens above
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
            # analysis: ignore[host-sync-in-hot-loop] the eos poll, once every
            # EOS_POLL_EVERY steps by design
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
    the CPU. `rolling_cache=True` bounds the cache by cfg.window (the
    module docstring); it needs cfg.window and rotary positions."""

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
        if self.rolling_cache and (
            self.cfg.window is None or self.cfg.pos_style != "rope"
        ):
            raise ValueError(
                "rolling_cache needs cfg.window (sliding-window "
                "attention) and pos_style='rope' (positions are "
                "unbounded, a learned table is not)"
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
        """Zeroed K/V of [L, batch, Hkv, S, Dh] in compute_dtype (GQA
        caches hold the KV heads only; S = max_len, or cfg.window for a
        rolling cache) and a scalar write head."""
        cfg = self.cfg
        dh = cfg.dim // cfg.num_heads
        slots = cfg.window if self.rolling_cache else cfg.max_len
        shape = (cfg.num_layers, batch, cfg.kv_heads, slots, dh)
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

    def _proj_fns(self, p: dict, dt, adapter_ids=None):
        """The (bias, proj) closures every block stage shares; int8
        leaves ({"q","s"}) widen here. With adapter banks in `p`
        ({name}:a [A, in, r] / {name}:b [A, r, out], stack_adapters)
        and `adapter_ids` (B,), each row adds its own adapter's delta:
        one base weight read serves every tenant, and only the two
        skinny per-row products differ."""

        def bias(h, name):
            return h + p[name].to(dt) if name in p else h

        def proj(h, name):
            y = h @ dequantize_leaf(p[name], dt)
            a = p.get(f"{name}:a")
            if a is not None and adapter_ids is not None:
                a_sel = a[adapter_ids].to(dt)  # [B, in, r]
                b_sel = p[f"{name}:b"][adapter_ids].to(dt)
                low = torch.einsum("btd,bdr->btr", h, a_sel)
                y = y + torch.einsum("btr,bro->bto", low, b_sel)
            return y

        return bias, proj

    def _attn_qkv(self, p: dict, x, rope, adapter_ids=None):
        """ln1 + q/k/v projections (+ rotary with the step's tables
        `rope` = (cos, sin), None for learned positions) + head split.
        Returns (q [B,Hq,T,Dh], k, v [B,Hkv,T,Dh])."""
        cfg = self.cfg
        dh = cfg.dim // cfg.num_heads
        bias, proj = self._proj_fns(p, x.dtype, adapter_ids)
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

    def _attn_out(self, p: dict, x, attn, adapter_ids=None, tp_axis=None):
        """wo projection, residual, ln2, FFN; `attn` is the merged
        [B, T, Hq*Dh] attention output. With `tp_axis` the wo and w2
        products are this rank's row-parallel partial sums, psummed over
        the axis before their biases (the Megatron split)."""
        cfg = self.cfg
        bias, proj = self._proj_fns(p, x.dtype, adapter_ids)
        x = x + bias(psum(proj(attn, "wo"), tp_axis), "bo")
        h2 = norm_apply(cfg, x, p, "ln2")
        if cfg.ffn_style == "swiglu":
            gate = F.silu(proj(h2, "w1"))
            return x + psum(proj(gate * proj(h2, "w3"), "w2"), tp_axis)
        ff = F.gelu(bias(proj(h2, "w1"), "b1"), approximate="tanh")
        return bias(x + psum(proj(ff, "w2"), tp_axis), "b2")

    def _block(self, p: dict, x, k_cache, v_cache, pos, plan: dict):
        """One decoder block on [B, T, D]: writes its T new K/V rows into
        `k_cache`/`v_cache` ([B, Hkv, S, Dh], in place) at the rows of
        `plan` and attends over the updated cache (a rolling multi-token
        step attends over [cache before the write, new rows]). `plan`
        holds what the step computes once for all layers (`_plan`)."""
        cfg = self.cfg
        dt = x.dtype
        dh = cfg.dim // cfg.num_heads
        adapter_ids = plan["adapter"]
        q, k, v = self._attn_qkv(p, x, plan["rope"], adapter_ids)
        b, h_q, t, _ = q.shape
        rows = plan["rows"]
        k_att = v_att = None
        if plan["concat"]:
            k_att = torch.cat([k_cache, k], dim=2)
            v_att = torch.cat([v_cache, v], dim=2)
        if pos.ndim == 1:
            bidx = plan["bidx"]
            k_cache[bidx, :, rows] = k.transpose(1, 2)
            v_cache[bidx, :, rows] = v.transpose(1, 2)
        else:
            k_cache.index_copy_(2, rows, k)
            v_cache.index_copy_(2, rows, v)
        if k_att is None:
            k_att, v_att = k_cache, v_cache
        if t == 1 and not self.rolling_cache:
            # The serving hot path: the live cache rows only, through
            # the flash-decode kernel (its plain version on the CPU).
            attn = flash_decode(q[:, :, 0, :], k_cache, v_cache, pos,
                                window=cfg.window)
            attn = attn.to(dt).reshape(b, t, h_q * dh)
        else:
            hkv = k_att.shape[1]
            qg = q.reshape(b, hkv, h_q // hkv, t, dh)
            # bf16 products are exact in f32: this is the JAX einsum's
            # preferred_element_type=f32.
            logits = torch.einsum(
                "bkgtd,bksd->bkgts", qg.float(), k_att.float()
            ) * (dh**-0.5)
            logits = logits.masked_fill(~plan["mask"], -torch.inf)
            weights = torch.softmax(logits, dim=-1).to(dt)
            attn = torch.einsum("bkgts,bksd->bkgtd", weights, v_att)
            attn = attn.reshape(b, h_q, t, dh).transpose(1, 2)
            attn = attn.reshape(b, t, h_q * dh)
        return self._attn_out(p, x, attn, adapter_ids, plan.get("tp"))

    def _rope(self, pos: torch.Tensor, t: int):
        """The rotary tables of a T-token step at write head `pos`
        (scalar, or (B,) per-slot depths), or None for learned
        positions."""
        if self.cfg.pos_style != "rope":
            return None
        steps = torch.arange(t, device=pos.device)
        positions = pos[:, None] + steps if pos.ndim == 1 else pos + steps
        return rope_tables(
            self.cfg.dim // self.cfg.num_heads, positions, self.cfg.rope_theta
        )

    def _plan(self, pos: torch.Tensor, t: int, s: int) -> dict:
        """Per-step tensors every layer shares, computed on the device
        from `pos` (no host sync): the cache rows to write, the rotary
        tables, and the attention mask of an einsum step (T > 1, or any
        rolling step). `s` is the length of the cache the step is
        given, which need not be max_len: the paged server's gathered
        view holds max_blocks * block_size rows, as the JAX package's
        `_block` takes S from the cache."""
        cfg = self.cfg
        dev = pos.device
        steps = torch.arange(t, device=dev)
        per_slot = pos.ndim == 1
        plan: dict = {
            "rope": self._rope(pos, t), "concat": False, "adapter": None,
        }
        if per_slot:
            plan["bidx"] = torch.arange(pos.shape[0], device=dev)[:, None]
        if self.rolling_cache:
            self._plan_rolling(plan, pos, t, s, steps)
            return plan
        # lax.dynamic_update_slice's clamp of the write start.
        start = pos.clamp(0, s - t)
        if per_slot:
            plan["rows"] = (start[:, None] + steps).long()  # (B, T)
        else:
            plan["rows"] = (start + steps).long()  # (T,)
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

    def _plan_rolling(self, plan, pos, t, s, steps) -> None:
        """A rolling step's rows (position % window) and mask, from the
        positions the slots hold after (T=1) or before (T > 1, which
        attends over [cache, new rows]) the write."""
        win = s
        s_idx = torch.arange(win, device=pos.device)
        if pos.ndim == 1:
            # Continuous batching: each slot writes at its own
            # pos % win. One token a tick; admission prefills each
            # request through the scalar path before lane insertion.
            if t != 1:
                raise ValueError(
                    "per-slot rolling caches decode one token per tick; "
                    "prefill requests individually before lane insertion"
                )
            plan["rows"] = (pos % win)[:, None].long()  # (B, 1)
            held = pos[:, None] - ((pos[:, None] - s_idx) % win)
            plan["mask"] = (held >= 0)[:, None, None, None, :]
            return
        if t > win:
            raise ValueError(
                f"a rolling-cache step takes at most window={win} tokens "
                f"at once (got {t}); prefill with chunk<={win}"
            )
        plan["rows"] = ((pos + steps) % win).long()  # (T,), unique
        if t == 1:
            # After the write every slot holds the latest position
            # <= pos congruent to it, always inside the window: only
            # never-written slots mask out.
            held = pos - ((pos - s_idx) % win)
            plan["mask"] = (held >= 0)[None, :]  # (1, win)
            return
        # Slot j holds the latest position <= pos - 1 congruent to j
        # (negative: never written); the new rows carry their own.
        held = pos - 1 - ((pos - 1 - s_idx) % win)
        kpos = torch.cat([held, pos + steps])
        qpos = (pos + steps)[:, None]  # (T, 1)
        plan["mask"] = (
            (kpos[None, :] <= qpos)
            & (kpos[None, :] > qpos - win)
            & (kpos[None, :] >= 0)
        )  # (T, win + T)
        plan["concat"] = True

    def _step_fn(self, donate: bool, tp_axis: str | None = None):
        """The one step body: embed -> blocks (writing the cache) ->
        final norm -> head. `donate=False` writes into a copy. With
        `tp_axis` (SpmdGptDecoder) the params and cache are this rank's
        shards and the hooks run their collectives over the axis."""

        @torch.no_grad()
        def step(params, cache, ids):
            k_all, v_all = cache["k"], cache["v"]
            if not donate:
                k_all, v_all = k_all.clone(), v_all.clone()
            t = ids.shape[1]
            pos = cache["pos"]
            plan = self._plan(pos, t, k_all.shape[3])
            # Multi-LoRA serving: the slot -> adapter assignment is
            # per-slot state and rides in the cache.
            adapter = cache.get("adapter")
            plan["adapter"] = None if adapter is None else adapter.long()
            plan["tp"] = tp_axis
            x = self._embed_tokens(params, ids, pos, tp_axis)
            stack = params["stack"]
            for layer in range(self.cfg.num_layers):
                x = self._block(
                    _layer_view(stack, layer), x, k_all[layer],
                    v_all[layer], pos, plan,
                )
            logits = self._final_logits(params, x, tp_axis)
            out = {"k": k_all, "v": v_all, "pos": pos + t}
            if adapter is not None:
                out["adapter"] = adapter
            return logits, out

        return step

    def _embed_tokens(self, params, ids, pos, tp_axis=None):
        """Token (+ learned position) embedding for a step at write head
        `pos` (scalar, or (B,) per-slot depths); with `tp_axis` the table
        is this rank's vocab rows (embed_lookup's masked lookup + psum)."""
        cfg = self.cfg
        cd = self.compute_dtype
        t = ids.shape[1]
        emb = embed_lookup(params["token_embedding"], ids, tp_axis)
        if cfg.pos_style == "rope":
            return emb.to(cd)
        steps = torch.arange(t, device=pos.device)
        if pos.ndim == 1:
            # Clamped: a paged prefill chunk's pad rows may sit past
            # max_len (their outputs are dropped); real rows never do.
            posv = params["pos_embedding"][
                (pos[:, None] + steps).clamp(max=cfg.max_len - 1)
            ]
        else:
            # lax.dynamic_slice_in_dim's clamp of the start.
            posv = params["pos_embedding"][
                pos.clamp(0, cfg.max_len - t) + steps
            ]
        return (emb + posv).to(cd)

    def _final_logits(self, params, x, tp_axis=None):
        """Final norm + output head, in f32: tied to the embedding unless
        the params carry a distinct lm_head. The head is widened to f32
        on each call (a bf16 [V, D] table read once and written once
        more as f32); the decoder holds no f32 copy of it. With `tp_axis`
        the head is this rank's vocab rows: the [B, T, Vpad/tp] slices
        all-gather on the axis and the pad rows are sliced off, so every
        rank holds the same whole logits."""
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
        logits = xn @ dequantize_leaf(head, torch.float32).T
        if tp_axis is None:
            return logits
        return all_gather(logits, tp_axis, dim=-1)[..., : cfg.vocab_size]

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
        """The raw single-step body, as `make_step(donate=True)`: the
        step a decode window repeats K times (runtime/decode_server.py
        captures the K sub-steps into one CUDA graph on a CUDA
        decoder)."""
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
        # analysis: ignore[host-sync-in-hot-loop] one scalar sync a prefill,
        # at admission, to refuse a write past max_len
        base = int(cache["pos"])
        if self.rolling_cache:
            # No end to overflow (slots recycle), but one step takes at
            # most a window of tokens: long prompts auto-chunk.
            if chunk is None and t0 > self.cfg.window:
                chunk = self.cfg.window
        elif base + t0 > self.cfg.max_len:
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
            # Rolling caches never pad: a pad row would evict the live
            # slot at its position % window.
            if (
                real < chunk
                and not self.rolling_cache
                and base + start + chunk <= self.cfg.max_len
            ):
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
        if not self.rolling_cache and t0 + num_steps > self.cfg.max_len:
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
        incremental decoding. A rolling decoder streams the sequence in
        window-sized pieces (one step takes at most a window)."""
        cache = self.init_cache(ids.shape[0])
        ids = ids.to(self.device)
        step = self.make_step(donate=False)
        win = self.cfg.window
        if not self.rolling_cache or ids.shape[1] <= win:
            logits, _ = step(params, cache, ids)
            return logits
        outs = []
        for start in range(0, ids.shape[1], win):
            logits, cache = step(params, cache, ids[:, start : start + win])
            outs.append(logits)
        return torch.cat(outs, dim=1)


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


@dataclasses.dataclass
class SpmdGptDecoder(GptDecoder):
    """Tensor-parallel KV-cache decoding over a "model" mesh axis (the
    JAX package's SpmdGptDecoder), over a process group: one process a
    mesh position, every rank calling the same step on the same operands
    and holding its shards.

    Each rank holds its head group's column-split q/k/v (and w1/w3)
    projections and a cache of ONLY its local heads ([L, B, Hkv/tp, S,
    Dh]); attention needs no collective, the wo and w2 row-parallel
    products psum over the axis, and the embedding / tied head is
    vocab-row split (masked lookup + psum in, this rank's logits slice
    all-gathered out), so every weight matrix is read 1/tp a rank. A
    vocab that does not divide by tp is padded with zero rows, never
    looked up and sliced off the logits. `dp_axis` splits the cache's
    batch rows over a data axis too (dp x tp): each rank runs its rows
    and the logits all-gather on the batch.

    `shard_params` takes the WHOLE tree (the same tree on every rank)
    and keeps this rank's slices; `init_cache` allocates this rank's
    shard directly. `device` defaults to the mesh's device for this
    rank. A one-process mesh serves only a model axis of size 1 (every
    collective the identity); larger axes need
    `parallel/multihost.py` `initialize` in every rank first."""

    mesh: Any = None
    tp_axis: str = "model"
    # Optional batch sharding over a second mesh axis (dp x tp).
    dp_axis: str | None = None

    def __post_init__(self):
        if self.mesh is None or self.tp_axis not in self.mesh.axis_names:
            raise ValueError(
                f"SpmdGptDecoder needs a mesh with a {self.tp_axis!r} axis"
            )
        if self.device is None:
            self.device = self.mesh.local_device
        super().__post_init__()
        if self.dp_axis is not None:
            if self.dp_axis not in self.mesh.axis_names:
                raise ValueError(
                    f"dp_axis {self.dp_axis!r} is not a mesh axis "
                    f"({self.mesh.axis_names})"
                )
            if self.dp_axis == self.tp_axis:
                raise ValueError(
                    f"dp_axis and tp_axis must differ (both "
                    f"{self.dp_axis!r})"
                )
        tp = self.mesh.shape[self.tp_axis]
        cfg = self.cfg
        if cfg.num_heads % tp or cfg.dim % tp or cfg.ffn_dim % tp:
            raise ValueError(
                f"heads={cfg.num_heads}, dim={cfg.dim}, "
                f"ffn_dim={cfg.ffn_dim} must all divide by tp={tp}"
            )
        if cfg.kv_heads % tp:
            raise ValueError(
                f"num_kv_heads={cfg.kv_heads} must divide by tp={tp} "
                "(each shard needs whole kv head groups)"
            )
        check_process_group(self.mesh)
        self.tp = tp
        self._vocab_padded = -(-cfg.vocab_size // tp) * tp
        self._quantized_keys: frozenset = frozenset()
        self._quantized_emb = False

    def _specs(self) -> dict:
        """The placement of a param tree (the JAX package's PartitionSpecs
        as tuples of axis names): the stack's Megatron column / row split
        from `stack_specs`, the embedding's vocab rows over tp, the norms
        and positions replicated; an int8 leaf's scale splits its last
        (channel) axis as its payload does."""
        tp = self.tp_axis
        stack = stack_specs(None, tp, cfg=self.cfg)
        for k in self._quantized_keys:
            spec = stack[k]
            n = len(spec)
            s_spec = ((spec[0], *([None] * (n - 2)), spec[-1]) if n >= 3
                      else (None, spec[-1]))
            stack[k] = {"q": spec, "s": s_spec}
        emb_spec: Any = (tp, None)
        if self._quantized_emb:
            emb_spec = {"q": (tp, None), "s": (None, None)}
        specs = {"token_embedding": emb_spec, "final_ln_scale": (),
                 "stack": stack}
        if self.cfg.pos_style == "learned":
            specs["pos_embedding"] = ()
        if self.cfg.norm_type == "layer":
            specs["final_ln_bias"] = ()
        return specs

    def shard_params(self, params: dict) -> dict:
        """This rank's slices of a WHOLE param tree, on this rank's
        device: the column / row split stack, the vocab rows of the
        embedding and tied head (padded to a tp multiple), the norms and
        positions whole. int8 weight-only trees (models/quant.py) split
        as their float counterparts."""
        local = shard_tree(self.prepare_params(params), self._specs(),
                           self.mesh)
        return tree_to(local, self.device)

    def prepare_params(self, params: dict) -> dict:
        """A WHOLE tree as `_specs` places it: the int8 leaves noted (their
        scales split as their payloads) and the embedding's vocab rows
        padded to a tp multiple. A pipeline stage shards its slice of it
        (runtime/paged.py `_pp_stage_specs`)."""
        if "lm_head" in params:
            raise NotImplementedError(
                "untied output heads are not supported under tensor "
                "parallelism yet — the single-device GptDecoder serves "
                "untied checkpoints"
            )
        self._quantized_keys = frozenset(
            k for k, v in params["stack"].items()
            if isinstance(v, dict) and "q" in v
        )
        emb = params["token_embedding"]
        self._quantized_emb = isinstance(emb, dict) and "q" in emb
        rows = emb["q"] if self._quantized_emb else emb
        pad = self._vocab_padded - rows.shape[0]
        if pad:
            padded = F.pad(rows, (0, 0, 0, pad))
            params = {
                **params,
                "token_embedding": ({"q": padded, "s": emb["s"]}
                                    if self._quantized_emb else padded),
            }
        return params

    def _cache_spec(self) -> dict:
        """The cache's placement: batch rows over dp (axis 1), heads over
        tp (axis 2) of [L, B, Hkv, S, Dh]; the write head replicated."""
        tp, dp = self.tp_axis, self.dp_axis
        return {"k": (None, dp, tp, None, None),
                "v": (None, dp, tp, None, None), "pos": ()}

    def init_cache(self, batch: int) -> dict:
        """This rank's shard of the zeroed cache, allocated as the shard
        (never whole first: a whole cache would need tp x the memory):
        [L, batch/dp, Hkv/tp, S, Dh] and a scalar write head."""
        dp = self.mesh.shape[self.dp_axis] if self.dp_axis else 1
        if batch % dp:
            raise ValueError(
                f"batch {batch} does not divide over dp_axis "
                f"{self.dp_axis!r} of size {dp}"
            )
        cfg = self.cfg
        dh = cfg.dim // cfg.num_heads
        slots = cfg.window if self.rolling_cache else cfg.max_len
        shape = (cfg.num_layers, batch // dp, cfg.kv_heads // self.tp,
                 slots, dh)
        return {
            "k": torch.zeros(shape, dtype=self.compute_dtype,
                             device=self.device),
            "v": torch.zeros(shape, dtype=self.compute_dtype,
                             device=self.device),
            "pos": torch.zeros((), dtype=torch.int32, device=self.device),
        }

    def make_step(self, *, donate: bool = True):
        """(params, cache, ids [B, T]) -> (logits [B, T, V] f32, cache):
        the decoder's step on this rank's shards under the mesh, the
        psums and the logits gather inside; the logits come back whole
        (pad vocab rows dropped) and bitwise equal on every rank. With
        dp_axis the rank runs its batch rows of `ids` (and of a per-slot
        write head) and the logits gather on the batch."""
        step = self._steps.get(donate)
        if step is not None:
            return step
        inner = self._step_fn(donate, tp_axis=self.tp_axis)
        dp, mesh = self.dp_axis, self.mesh

        def step(params, cache, ids):
            with collectives.active(mesh):
                if dp is None:
                    return inner(params, cache, ids)
                local = dict(cache)
                for key in ("pos", "adapter"):
                    if key in local and local[key].ndim == 1:
                        local[key] = collectives.shard(local[key], dp, 0)
                logits, out = inner(params, local,
                                    collectives.shard(ids, dp, 0))
                out["pos"] = cache["pos"] + ids.shape[1]
                if "adapter" in cache:
                    out["adapter"] = cache["adapter"]
                return collectives.unshard(logits, dp, 0), out

        self._steps[donate] = step
        return step

    def decode_step_fn(self):
        # A decode window would repeat the raw body without the mesh's
        # collectives: the flat server asked for decode_window > 1 calls
        # this at construction and fails fast.
        raise NotImplementedError(
            "decode_window > 1 is not supported under shard_map "
            "tensor parallelism: the fused window step would bypass "
            "SpmdGptDecoder's sharded make_step — serve with "
            "decode_window=1"
        )

