"""T5 encoder-decoder on one device.

Counterpart of `defer_tpu/models/t5.py` (`T5Config`,
`relative_position_bucket`, `T5`, `t5_config`, `tiny_t5`,
`from_hf_state_dict`). The design is the JAX package's:

  * both stacks keep the house layout, params stacked on a leading [L]
    layer axis, applied layer by layer;
  * the relative position bias lives in ONE [num_buckets, H] table a
    stack (T5 computes it in block 0 and shares it; here it is a
    top-level param), materialized once a forward as a [1, H, Tq, Tk]
    additive bias;
  * T5 does NOT scale attention logits by 1/sqrt(dh) (the scale is
    folded into its initialization);
  * incremental decoding keeps static [L, B, H, max_len, Dh] self
    attention buffers written IN PLACE at the cache's write head (a
    device tensor, no host sync a step) and masked by cache position,
    plus each decoder layer's cross-attention K/V, projected ONCE from
    the encoder output at cache start;
  * decoding starts from `cfg.decoder_start_token_id`; "relu" (v1.0)
    and "gated-gelu" (v1.1) FFNs; a tied head scales the decoder output
    by dim**-0.5 before it, an untied `lm_head` does not.

The attention is plain `torch.matmul` / softmax in float32 logits, on
every path: T5's attention carries an additive bias, which the port's
`flash_attention` does not take, and the JAX package sends it to XLA
too (no Pallas kernel computes it there). `from_hf_state_dict` maps a
HuggingFace `T5ForConditionalGeneration.state_dict()` onto the params,
held against transformers' own forward in tests/test_torch_t5.py.

`SpmdT5` / `spmd_t5` serve T5 tensor-parallel over a "model" mesh axis
of a process group (one rank a mesh position, as `SpmdGptDecoder`):
every body above takes the JAX package's `tp_axis` hooks, so one head
group a rank in both stacks (local-width splits, the rel-bias tables
sliced on their head axis, caches of local heads), column / row split
FFNs and attention outputs closed by a psum, and a vocab-row split
embedding and head (padded to a tp multiple) whose logits slices
all-gather on the way out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F

from defer_tpu_torch.models.gpt import _layer_view, _resolve_device
from defer_tpu_torch.models.gpt import sampled_decode_loop
from defer_tpu_torch.parallel import collectives
from defer_tpu_torch.parallel.collectives import all_gather, psum
from defer_tpu_torch.parallel.mesh import cuda_devices
from defer_tpu_torch.parallel.spmd_pipeline import check_process_group
from defer_tpu_torch.parallel.transformer_stack import (
    _rms_norm,
    embed_lookup,
    normal,
    shard_tree,
)
from defer_tpu_torch.weights import tree_to


@dataclasses.dataclass(frozen=True)
class T5Config:
    num_layers: int = 6  # encoder depth; decoder depth below
    num_decoder_layers: int | None = None  # None = num_layers
    dim: int = 512
    num_heads: int = 8
    head_dim: int = 64  # T5 decouples head_dim from dim/num_heads
    ffn_dim: int = 2048
    vocab_size: int = 32128
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    ffn_style: str = "relu"  # "relu" (v1.0) | "gated-gelu" (v1.1)
    # v1.0 ties the LM head to the shared embedding (and scales the
    # decoder output by dim**-0.5 before it); v1.1 ships a separate
    # lm_head and does not scale.
    tie_word_embeddings: bool = True
    max_len: int = 512  # decoder KV-cache bound
    decoder_start_token_id: int = 0  # T5 starts decoding from <pad>

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def dec_layers(self) -> int:
        return self.num_decoder_layers or self.num_layers

    def __post_init__(self):
        if self.ffn_style not in ("relu", "gated-gelu"):
            raise ValueError(
                f"ffn_style={self.ffn_style!r}: must be 'relu' or "
                "'gated-gelu'"
            )
        if self.rel_buckets < 4 or self.rel_buckets % 2:
            raise ValueError(
                f"rel_buckets={self.rel_buckets} must be even and >= 4 "
                "(bidirectional bucketing halves it)"
            )
        if self.rel_max_distance <= self.rel_buckets // 2:
            # Causal bucketing's log range divides by
            # log(max_distance / (num_buckets // 2)); a ratio <= 1 makes
            # that zero or negative and the bucket indices NaN.
            raise ValueError(
                f"rel_max_distance={self.rel_max_distance} must exceed "
                f"rel_buckets // 2 = {self.rel_buckets // 2}"
            )


def relative_position_bucket(
    rel: torch.Tensor,
    *,
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """T5's log-spaced relative-position bucketing.

    `rel` = key_position - query_position (any integer shape). Half the
    buckets cover exact small distances, the other half log-spaced
    distances out to max_distance; bidirectional mode splits the range
    again by sign. The JAX package's function and HF transformers'
    `T5Attention._relative_position_bucket`, bucket for bucket."""
    rel = rel.to(torch.int32)
    n = num_buckets
    ret = torch.zeros_like(rel)
    if bidirectional:
        n //= 2
        ret = ret + (rel > 0).to(torch.int32) * n
        rel = rel.abs()
    else:
        rel = -rel.clamp(max=0)
    max_exact = n // 2
    is_small = rel < max_exact
    # Clamp before the log: rel=0 falls in the is_small branch, but a
    # log(0) in the untaken branch would still poison the int cast.
    val_large = max_exact + (
        torch.log(rel.clamp(min=1).float() / max_exact)
        / math.log(max_distance / max_exact)
        * (n - max_exact)
    ).to(torch.int32)
    val_large = val_large.clamp(max=n - 1)
    return ret + torch.where(is_small, rel, val_large)


def _rel_bias(table, qpos, kpos, *, bidirectional: bool, num_buckets: int,
              max_distance: int) -> torch.Tensor:
    """[1, H, Tq, Tk] f32 additive attention bias from a [num_buckets, H]
    table and absolute positions."""
    rel = kpos[None, :] - qpos[:, None]  # (Tq, Tk)
    buckets = relative_position_bucket(
        rel, bidirectional=bidirectional, num_buckets=num_buckets,
        max_distance=max_distance,
    )
    return table[buckets.long()].permute(2, 0, 1)[None].float()


def _attend(q, k, v, bias) -> torch.Tensor:
    """Unscaled softmax attention on (B, H, T, Dh) q and (B, H, S, Dh)
    k/v: f32 logits plus the additive `bias` (which carries every mask),
    f32 softmax, probabilities in v's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        logits = logits + bias
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


@dataclasses.dataclass
class T5:
    """T5 encoder-decoder with KV-cached incremental decoding.

    encode / decode_logits are the full-sequence paths (the correctness
    oracle for the cached step); start_cache + make_step + generate are
    the serving path. `device`: where `init` and the caches allocate;
    None means the first CUDA device, and raises without one (pass
    "cpu" to run on the CPU)."""

    cfg: T5Config
    compute_dtype: Any = torch.bfloat16
    device: Any = None
    _steps: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    def __post_init__(self):
        self.device = _resolve_device(self.device)

    # -- params -----------------------------------------------------------

    def init(self, generator: torch.Generator) -> dict:
        """Random f32 parameters on `self.device`, drawn from `generator`
        (which must live there): the JAX package's distributions, not
        its values, but for the query projections (`wq`, `cq`). Those
        are drawn at T5's own scale, (d_model * head_dim)**-0.5 (as HF
        transformers' T5 initializes them), which folds in the
        1/sqrt(head_dim) that T5 leaves out of its attention logits; at
        the JAX package's d_model**-0.5 the q.k logits have a std of
        about sqrt(head_dim), the softmax is near one-hot, and bf16
        rounding moves whole logit rows."""
        cfg = self.cfg
        D, I, Fd = cfg.dim, cfg.inner_dim, cfg.ffn_dim
        dev = self.device

        def rnd(shape, scale=1.0):
            return normal(generator, shape, scale, device=dev)

        def stack(L: int, cross: bool) -> dict:
            s, sq = D**-0.5, (D * cfg.head_dim) ** -0.5
            p = {
                "wq": rnd((L, D, I), sq),
                "wk": rnd((L, D, I), s),
                "wv": rnd((L, D, I), s),
                "wo": rnd((L, I, D), I**-0.5),
                "ln1_scale": torch.ones((L, D), device=dev),
                "ln2_scale": torch.ones((L, D), device=dev),
                "w1": rnd((L, D, Fd), s),
                "w2": rnd((L, Fd, D), Fd**-0.5),
            }
            if cfg.ffn_style == "gated-gelu":
                p["w3"] = rnd((L, D, Fd), s)
            if cross:
                p.update({
                    "cq": rnd((L, D, I), sq),
                    "ck": rnd((L, D, I), s),
                    "cv": rnd((L, D, I), s),
                    "co": rnd((L, I, D), I**-0.5),
                    "lnx_scale": torch.ones((L, D), device=dev),
                })
            return p

        p = {
            "token_embedding": rnd((cfg.vocab_size, D)),
            "enc_stack": stack(cfg.num_layers, cross=False),
            "dec_stack": stack(cfg.dec_layers, cross=True),
            "enc_rel_bias": rnd((cfg.rel_buckets, cfg.num_heads), 0.1),
            "dec_rel_bias": rnd((cfg.rel_buckets, cfg.num_heads), 0.1),
            "enc_final_ln": torch.ones((D,), device=dev),
            "dec_final_ln": torch.ones((D,), device=dev),
        }
        if not cfg.tie_word_embeddings:
            p["lm_head"] = rnd((cfg.vocab_size, D), D**-0.5)
        return p

    def cast_params(self, params: dict) -> dict:
        """Float params re-stored in compute_dtype (the serving
        configuration), as GptDecoder.cast_params."""

        def cast(a):
            if isinstance(a, dict):
                return {k: cast(v) for k, v in a.items()}
            return a.to(self.compute_dtype) if a.is_floating_point() else a

        return cast(params)

    # -- shared pieces ----------------------------------------------------

    def _ffn(self, p: dict, x: torch.Tensor,
             tp_axis: str | None = None) -> torch.Tensor:
        dt = x.dtype
        if self.cfg.ffn_style == "gated-gelu":
            # T5 v1.1: gelu(wi_0) * wi_1 -> wo; HF's "gated-gelu" is
            # gelu_new, the tanh approximation.
            h = F.gelu(x @ p["w1"].to(dt), approximate="tanh") * (
                x @ p["w3"].to(dt)
            )
        else:
            h = torch.relu(x @ p["w1"].to(dt))
        # Under tp, w1/w3 are column- and w2 row-split: partial sums.
        return psum(h @ p["w2"].to(dt), tp_axis)

    def _rms(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return _rms_norm(x, scale, self.cfg.layer_norm_eps)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H*Dh) -> (B, H, T, Dh)."""
        b, t, _ = x.shape
        dh = self.cfg.head_dim
        return x.reshape(b, t, -1, dh).transpose(1, 2)

    @staticmethod
    def _merge(x: torch.Tensor) -> torch.Tensor:
        b, h, t, dh = x.shape
        return x.transpose(1, 2).reshape(b, t, h * dh)

    def _embed(self, params: dict, ids: torch.Tensor,
               tp_axis: str | None = None) -> torch.Tensor:
        """Token embedding in the compute dtype; under tp the table is
        this rank's vocab rows (embed_lookup's masked lookup + psum)."""
        ids = ids.to(self.device)
        return embed_lookup(params["token_embedding"], ids, tp_axis).to(
            self.compute_dtype)

    def _local_heads(self, params: dict) -> int:
        """Heads this rank computes: all of them, or its head group
        under tp (read from the projections' width)."""
        return params["dec_stack"]["wk"].shape[-1] // self.cfg.head_dim

    @staticmethod
    def _key_mask_bias(mask) -> torch.Tensor | None:
        """[B, S] validity mask (1 = real token) -> [B, 1, 1, S] f32
        additive bias masking pad KEY positions. A large finite constant,
        not -inf (HF's convention): an ALL-pad row then softmaxes to
        uniform garbage instead of NaN that would poison the forward."""
        if mask is None:
            return None
        keep = torch.as_tensor(mask).bool()[:, None, None, :]
        return torch.where(keep, 0.0, -1e9).float()

    def _bias(self, table, t_q: int, t_k: int, *, bidirectional: bool):
        cfg = self.cfg
        qpos = torch.arange(t_q, device=self.device)
        kpos = torch.arange(t_k, device=self.device)
        return _rel_bias(table, qpos, kpos, bidirectional=bidirectional,
                         num_buckets=cfg.rel_buckets,
                         max_distance=cfg.rel_max_distance)

    # -- encoder ----------------------------------------------------------

    def encode(self, params: dict, ids: torch.Tensor,
               tp_axis: str | None = None, *, mask=None) -> torch.Tensor:
        """[B, S] token ids -> [B, S, D] encoder output (final-LN'd).
        `mask` [B, S] (1 = real token) excludes pad KEY positions from
        every self-attention (pad rows of the output are garbage; the
        decoder paths mask them when given the same mask). With tp_axis
        (under the active mesh) the projections are this rank's head
        group, the rel-bias table's local width picks the matching
        heads, and wo / w2 are row-split with a psum."""
        x = self._embed(params, ids, tp_axis)
        s = ids.shape[1]
        bias = self._bias(params["enc_rel_bias"], s, s, bidirectional=True)
        kb = self._key_mask_bias(mask)
        if kb is not None:
            bias = bias + kb.to(self.device)
        for layer in range(self.cfg.num_layers):
            p = _layer_view(params["enc_stack"], layer)
            dt = x.dtype
            h = self._rms(x, p["ln1_scale"])
            attn = _attend(self._split(h @ p["wq"].to(dt)),
                           self._split(h @ p["wk"].to(dt)),
                           self._split(h @ p["wv"].to(dt)), bias)
            x = x + psum(self._merge(attn) @ p["wo"].to(dt), tp_axis)
            x = x + self._ffn(p, self._rms(x, p["ln2_scale"]), tp_axis)
        return self._rms(x, params["enc_final_ln"])

    # -- decoder (full sequence: the oracle) --------------------------------

    def decode_logits(self, params: dict, enc_out: torch.Tensor,
                      dec_ids: torch.Tensor, tp_axis: str | None = None, *,
                      enc_mask=None) -> torch.Tensor:
        """Teacher-forced decoder: [B, Senc, D] x [B, Tdec] -> [B, Tdec, V]
        f32 logits (this rank's vocab slice under tp). `enc_mask`
        [B, Senc] excludes pad encoder positions from every
        cross-attention (pass the mask given to encode)."""
        x = self._embed(params, dec_ids, tp_axis)
        enc_out = enc_out.to(self.device, self.compute_dtype)
        cross_bias = self._key_mask_bias(enc_mask)
        if cross_bias is not None:
            cross_bias = cross_bias.to(self.device)
        t = dec_ids.shape[1]
        causal = torch.ones((t, t), dtype=torch.bool,
                            device=self.device).tril()
        self_bias = self._bias(params["dec_rel_bias"], t, t,
                               bidirectional=False)
        self_bias = self_bias.masked_fill(~causal, float("-inf"))
        for layer in range(self.cfg.dec_layers):
            p = _layer_view(params["dec_stack"], layer)
            dt = x.dtype
            h = self._rms(x, p["ln1_scale"])
            attn = _attend(self._split(h @ p["wq"].to(dt)),
                           self._split(h @ p["wk"].to(dt)),
                           self._split(h @ p["wv"].to(dt)), self_bias)
            x = x + psum(self._merge(attn) @ p["wo"].to(dt), tp_axis)
            h = self._rms(x, p["lnx_scale"])
            cross = _attend(self._split(h @ p["cq"].to(dt)),
                            self._split(enc_out @ p["ck"].to(dt)),
                            self._split(enc_out @ p["cv"].to(dt)),
                            cross_bias)
            x = x + psum(self._merge(cross) @ p["co"].to(dt), tp_axis)
            x = x + self._ffn(p, self._rms(x, p["ln2_scale"]), tp_axis)
        return self._head(params, self._rms(x, params["dec_final_ln"]))

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The LM head in f32 (tied: the decoder output scaled by
        dim**-0.5 first). Under tp the head rows are this rank's vocab
        slice, so this is the local logits slice."""
        xf = x.float()
        if self.cfg.tie_word_embeddings:
            xf = xf * self.cfg.dim**-0.5
        head = params.get("lm_head", params["token_embedding"])
        return xf @ head.float().T

    def forward(self, params: dict, enc_ids: torch.Tensor,
                dec_ids: torch.Tensor, *, enc_mask=None) -> torch.Tensor:
        """encode + teacher-forced decode in one call: [B, S] x [B, T] ->
        [B, T, V] logits."""
        enc_out = self.encode(params, enc_ids, mask=enc_mask)
        return self.decode_logits(params, enc_out, dec_ids,
                                  enc_mask=enc_mask)

    # -- incremental decoding --------------------------------------------

    def start_cache(self, params: dict, enc_out: torch.Tensor,
                    enc_mask=None) -> dict:
        """Serving cache for one encoded batch: empty self-attention K/V
        buffers, plus the cross-attention K/V of every decoder layer,
        projected ONCE from the encoder output (constant for the whole
        generation). `enc_mask` [B, Senc] bakes the pad-key exclusion
        into the cache as an additive cross-attention bias."""
        cfg = self.cfg
        cd = self.compute_dtype
        b, s_enc, _ = enc_out.shape
        enc_out = enc_out.to(self.device, cd)
        cross_bias = self._key_mask_bias(enc_mask)
        if cross_bias is None:
            cross_bias = torch.zeros((b, 1, 1, s_enc))
        # Local heads: under tp a rank caches only its head group.
        shape = (cfg.dec_layers, b, self._local_heads(params), cfg.max_len,
                 cfg.head_dim)
        cross_k, cross_v = self._project_cross(params, enc_out)
        return {
            "k": torch.zeros(shape, dtype=cd, device=self.device),
            "v": torch.zeros(shape, dtype=cd, device=self.device),
            "cross_k": cross_k,
            "cross_v": cross_v,
            "cross_bias": cross_bias.to(self.device),
            "pos": torch.zeros((), dtype=torch.int32, device=self.device),
        }

    def _project_cross(self, params: dict, enc_out: torch.Tensor):
        """[L, B, H, Senc, Dh] cross K/V for all decoder layers, one
        batched einsum a projection (H the local heads under tp)."""
        cfg = self.cfg
        cd = enc_out.dtype
        b, s_enc, _ = enc_out.shape
        shape = (cfg.dec_layers, b, s_enc, self._local_heads(params),
                 cfg.head_dim)
        out = []
        for name in ("ck", "cv"):
            proj = torch.einsum("bsd,ldi->lbsi", enc_out,
                                params["dec_stack"][name].to(cd))
            out.append(proj.reshape(shape).transpose(2, 3).contiguous())
        return out[0], out[1]

    def make_encode(self):
        """(params, enc_ids, enc_mask) -> (enc_out, fresh serving cache):
        the encoder and the per-layer cross-K/V projection in one call
        (the JAX package's jitted encode program). `enc_mask` is a
        concrete [B, Senc] validity mask (all ones when nothing is
        padded)."""

        def fn(params, ids, mask):
            enc_out = self.encode(params, ids, mask=mask)
            return enc_out, self.start_cache(params, enc_out, mask)

        return fn

    def prefill(self, params: dict, cache: dict, ids: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
        """Consume [B, T] decoder ids into the cache; returns (last_logits
        [B, V], cache). The GUARDED entry for multi-token steps: the step
        clamps nothing, so a write past max_len is refused here (one
        host sync a prefill, at admission)."""
        # analysis: ignore[host-sync-in-hot-loop] one scalar sync a prefill,
        # at admission, to refuse a write past max_len
        base = int(cache["pos"])
        t = ids.shape[1]
        if base + t > self.cfg.max_len:
            raise ValueError(
                f"cache position {base} + {t} tokens exceeds max_len "
                f"{self.cfg.max_len}"
            )
        logits, cache = self.make_step()(params, cache, ids)
        return logits[:, -1, :], cache

    def _step_fn(self, donate: bool, tp_axis: str | None = None):
        """The ONE incremental-step body of the single-device and the
        tensor-parallel paths: under tp each rank holds one head group
        (local-width splits, the head-sliced rel-bias table, head-group
        caches), psums close the wo / co / w2 row-parallel products and
        the embedding is vocab-row split."""
        cfg = self.cfg

        def step(params, cache, ids):
            ids = ids.to(self.device)
            b, t = ids.shape
            pos = cache["pos"]
            kc_all, vc_all = cache["k"], cache["v"]
            if not donate:
                kc_all, vc_all = kc_all.clone(), vc_all.clone()
            x = self._embed(params, ids, tp_axis)
            qpos = pos + torch.arange(t, device=self.device)
            kpos = torch.arange(cfg.max_len, device=self.device)
            self_bias = _rel_bias(
                params["dec_rel_bias"], qpos, kpos, bidirectional=False,
                num_buckets=cfg.rel_buckets,
                max_distance=cfg.rel_max_distance,
            )
            # Causal by position over the static cache: query at absolute
            # pos + i sees slot j iff j <= pos + i.
            mask = kpos[None, :] <= qpos[:, None]  # (T, S_max)
            self_bias = self_bias.masked_fill(~mask, float("-inf"))
            rows = qpos.long()
            for layer in range(cfg.dec_layers):
                p = _layer_view(params["dec_stack"], layer)
                kc, vc = kc_all[layer], vc_all[layer]
                dt = x.dtype
                h = self._rms(x, p["ln1_scale"])
                q = self._split(h @ p["wq"].to(dt))
                kc.index_copy_(2, rows, self._split(h @ p["wk"].to(dt)))
                vc.index_copy_(2, rows, self._split(h @ p["wv"].to(dt)))
                attn = _attend(q, kc, vc, self_bias)
                x = x + psum(self._merge(attn) @ p["wo"].to(dt), tp_axis)
                # Cross-attention against the precomputed encoder K/V;
                # cross_bias (baked at cache start) excludes pad keys.
                h = self._rms(x, p["lnx_scale"])
                cross = _attend(self._split(h @ p["cq"].to(dt)),
                                cache["cross_k"][layer],
                                cache["cross_v"][layer],
                                cache["cross_bias"])
                x = x + psum(self._merge(cross) @ p["co"].to(dt), tp_axis)
                x = x + self._ffn(p, self._rms(x, p["ln2_scale"]), tp_axis)
            x = self._rms(x, params["dec_final_ln"])
            out = {**cache, "k": kc_all, "v": vc_all, "pos": pos + t}
            return self._head(params, x), out

        return step

    def make_step(self, *, donate: bool = True):
        """(params, cache, ids [B, T]) -> (logits [B, T, V] f32, cache):
        the incremental decode step (prefill T >= 1 or decode T=1).
        donate=True (serving) writes the new K/V rows into the given
        cache's buffers; donate=False leaves them untouched and returns
        new ones. The caller keeps pos + T <= max_len (`prefill` is the
        guarded multi-token entry)."""
        step = self._steps.get(donate)
        if step is None:
            step = self._steps[donate] = self._step_fn(donate)
        return step

    def generate(
        self,
        params: dict,
        enc_ids: torch.Tensor,
        num_steps: int,
        *,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        min_p: float = 0.0,
        rep_penalty: float = 1.0,
        eos_id: int | None = None,
        generator: torch.Generator | None = None,
        enc_mask=None,
    ) -> torch.Tensor:
        """Encode once, then greedy (or sampled) decoding from the start
        token: [B, Senc] -> [B, 1 + num_steps] decoder ids, the leading
        start token included. Pass `enc_mask` [B, Senc] (1 = real token)
        when the batch was padded to a common length."""
        cfg = self.cfg
        if num_steps + 1 > cfg.max_len:
            raise ValueError(
                f"{num_steps} steps + start token exceeds max_len "
                f"{cfg.max_len}"
            )
        b = enc_ids.shape[0]
        if enc_mask is None:
            enc_mask = torch.ones(enc_ids.shape, dtype=torch.int32)
        _, cache = self.make_encode()(params, enc_ids, enc_mask)
        ids = torch.full((b, 1), cfg.decoder_start_token_id,
                         dtype=torch.int32, device=self.device)
        last, cache = self.prefill(params, cache, ids)
        return sampled_decode_loop(
            self.make_step(), params, cache, last, ids, num_steps,
            temperature=temperature, top_k=top_k, top_p=top_p,
            min_p=min_p, rep_penalty=rep_penalty, eos_id=eos_id,
            generator=generator,
        )


def t5_config(name: str = "small", **overrides: Any) -> T5Config:
    """Named T5 shapes ("small", "base", "large") with overrides."""
    shapes = {
        "small": dict(num_layers=6, dim=512, num_heads=8, ffn_dim=2048),
        "base": dict(num_layers=12, dim=768, num_heads=12, ffn_dim=3072),
        "large": dict(num_layers=24, dim=1024, num_heads=16, ffn_dim=4096),
    }
    if name not in shapes:
        raise KeyError(f"unknown t5 size {name!r}; have {sorted(shapes)}")
    kw: dict[str, Any] = dict(shapes[name])
    kw.update(overrides)
    return T5Config(**kw)


def tiny_t5(*, device=None, **overrides: Any) -> T5:
    """Small config for tests / CPU, in float32."""
    kw: dict[str, Any] = dict(
        num_layers=2, dim=32, num_heads=4, head_dim=8, ffn_dim=64,
        vocab_size=96, rel_buckets=8, rel_max_distance=20, max_len=32,
    )
    kw.update(overrides)
    return T5(T5Config(**kw), compute_dtype=torch.float32, device=device)


def from_hf_state_dict(cfg: T5Config, state_dict: Mapping[str, Any],
                       device: torch.device | str | None = None) -> dict:
    """Map a HuggingFace `T5ForConditionalGeneration.state_dict()` onto
    the T5 params, on `device`, each leaf in the checkpoint's dtype
    (torch Linear stores [out, in]; the stacks compute x @ W with
    [in, out], so projections transpose). A head tying that disagrees
    with `cfg.tie_word_embeddings` raises: the tied-only dim**-0.5
    scaling would put every logit off by sqrt(dim) silently. `device`
    None is the first CUDA device (the JAX package's default device);
    it raises without a card: pass device="cpu" to load on the CPU."""
    device = device if device is not None else cuda_devices()[0]

    def t(name: str) -> torch.Tensor:
        return torch.as_tensor(state_dict[name]).detach().to(device)

    def attn(side: str, i: int, layer: int, which: str) -> torch.Tensor:
        mod = "SelfAttention" if layer == 0 else "EncDecAttention"
        return t(f"{side}.block.{i}.layer.{layer}.{mod}.{which}.weight").T

    def ffn(side: str, i: int, layer: int, which: str) -> torch.Tensor:
        return t(
            f"{side}.block.{i}.layer.{layer}.DenseReluDense.{which}.weight"
        ).T

    def ln(side: str, i: int, layer: int) -> torch.Tensor:
        return t(f"{side}.block.{i}.layer.{layer}.layer_norm.weight")

    gated = cfg.ffn_style == "gated-gelu"
    wi = "wi_0" if gated else "wi"

    def stack(side: str, L: int, cross: bool) -> dict:
        f = 2 if cross else 1  # the FFN sub-layer's index

        def each(fn, *a):
            return torch.stack([fn(side, i, *a) for i in range(L)]) \
                .contiguous()

        p = {
            "wq": each(attn, 0, "q"), "wk": each(attn, 0, "k"),
            "wv": each(attn, 0, "v"), "wo": each(attn, 0, "o"),
            "ln1_scale": each(ln, 0), "ln2_scale": each(ln, f),
            "w1": each(ffn, f, wi), "w2": each(ffn, f, "wo"),
        }
        if gated:
            p["w3"] = each(ffn, f, "wi_1")
        if cross:
            p.update({
                "cq": each(attn, 1, "q"), "ck": each(attn, 1, "k"),
                "cv": each(attn, 1, "v"), "co": each(attn, 1, "o"),
                "lnx_scale": each(ln, 1),
            })
        return p

    bias = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    params = {
        "token_embedding": t("shared.weight"),
        "enc_stack": stack("encoder", cfg.num_layers, cross=False),
        "dec_stack": stack("decoder", cfg.dec_layers, cross=True),
        "enc_rel_bias": t(f"encoder.{bias}"),
        "dec_rel_bias": t(f"decoder.{bias}"),
        "enc_final_ln": t("encoder.final_layer_norm.weight"),
        "dec_final_ln": t("decoder.final_layer_norm.weight"),
    }
    if "lm_head.weight" in state_dict:
        head = t("lm_head.weight")
        if not torch.equal(head, params["token_embedding"]):
            params["lm_head"] = head
    if cfg.tie_word_embeddings and "lm_head" in params:
        raise ValueError(
            "checkpoint carries a distinct lm_head but "
            "cfg.tie_word_embeddings=True — load it with a v1.1-style "
            "config (tie_word_embeddings=False)"
        )
    if not cfg.tie_word_embeddings and "lm_head" not in params:
        raise ValueError(
            "cfg.tie_word_embeddings=False but the checkpoint has no "
            "distinct lm_head — load it with tie_word_embeddings=True"
        )
    return params


@dataclasses.dataclass
class SpmdT5(T5):
    """Tensor-parallel T5 over a "model" mesh axis (the JAX package's
    SpmdT5), over a process group: one process a mesh position, every
    rank calling the same programs on the same operands and holding its
    shards. One head group a rank in BOTH stacks (self- and
    cross-attention caches of local heads only, the rel-bias tables
    split on their head axis so each group reads just its own biases),
    column / row split FFNs with a psum, and a Megatron vocab-row split
    embedding / head, padded to a tp multiple: every weight matrix is
    read 1/tp a rank, as under SpmdGptDecoder.

    `shard_params` takes the WHOLE tree (the same on every rank) and
    keeps this rank's slices. The programs (`make_encode`,
    `make_forward`, `make_step`, and `encode` / `decode_logits` /
    `forward` / `generate` called directly) run with the mesh active
    and return whole values, bitwise equal on every rank: the encoder
    output after its psums, the logits all-gathered with the pad vocab
    rows sliced off; `make_encode`'s cache holds this rank's heads.
    `device` defaults to the mesh's device for this rank. A one-process
    mesh serves only a model axis of size 1 (every collective the
    identity)."""

    mesh: Any = None
    tp_axis: str = "model"

    def __post_init__(self):
        if self.mesh is None or self.tp_axis not in self.mesh.axis_names:
            raise ValueError(
                f"SpmdT5 needs a mesh with a {self.tp_axis!r} axis"
            )
        cfg = self.cfg
        tp = self.mesh.shape[self.tp_axis]
        if cfg.num_heads % tp or cfg.ffn_dim % tp:
            raise ValueError(
                f"num_heads={cfg.num_heads} and ffn_dim={cfg.ffn_dim} "
                f"must divide by tp={tp}"
            )
        if self.device is None:
            self.device = self.mesh.local_device
        super().__post_init__()
        check_process_group(self.mesh)
        self._vocab_padded = -(-cfg.vocab_size // tp) * tp

    def _specs(self) -> dict:
        """The placement of a param tree (the JAX package's
        PartitionSpecs as tuples of axis names)."""
        tp = self.tp_axis
        col, row, rep = (None, None, tp), (None, tp, None), (None, None)

        def stack(cross: bool) -> dict:
            p = {"wq": col, "wk": col, "wv": col, "wo": row,
                 "ln1_scale": rep, "ln2_scale": rep, "w1": col, "w2": row}
            if self.cfg.ffn_style == "gated-gelu":
                p["w3"] = col
            if cross:
                p.update(cq=col, ck=col, cv=col, co=row, lnx_scale=rep)
            return p

        specs = {
            "token_embedding": (tp, None),
            "enc_stack": stack(False),
            "dec_stack": stack(True),
            # Head axis split: each group reads only its own biases.
            "enc_rel_bias": (None, tp),
            "dec_rel_bias": (None, tp),
            "enc_final_ln": (None,),
            "dec_final_ln": (None,),
        }
        if not self.cfg.tie_word_embeddings:
            specs["lm_head"] = (tp, None)
        return specs

    def shard_params(self, params: dict) -> dict:
        """This rank's slices of a WHOLE param tree, on this rank's
        device; the vocab rows of the embedding (and an untied head)
        padded to a tp multiple with zero rows, which no lookup reaches
        and the logits drop."""
        pad = self._vocab_padded - params["token_embedding"].shape[0]
        if pad:
            params = dict(params)
            for key in ("token_embedding", "lm_head"):
                if key in params:
                    params[key] = F.pad(params[key], (0, 0, 0, pad))
        return tree_to(shard_tree(params, self._specs(), self.mesh),
                       self.device)

    def _cache_spec(self) -> dict:
        """The serving cache's placement: self and cross K/V at heads /
        tp of [L, B, H, S, Dh]; the cross bias and write head whole."""
        kv = (None, None, self.tp_axis, None, None)
        return {"k": kv, "v": kv, "cross_k": kv, "cross_v": kv,
                "cross_bias": (None, None, None, None), "pos": ()}

    def _whole_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's [..., Vpad/tp] logits slice -> the whole [..., V]
        logits on every rank (the shard_map's out_specs concatenation,
        then the pad rows sliced off: zeros could win an argmax)."""
        return all_gather(logits, self.tp_axis, dim=-1)[
            ..., : self.cfg.vocab_size]

    def encode(self, params: dict, ids: torch.Tensor,
               tp_axis: str | None = None, *, mask=None) -> torch.Tensor:
        """The encoder on this rank's shards under the mesh; the output
        is whole (every block ends in a psum)."""
        with collectives.active(self.mesh):
            return super().encode(params, ids, self.tp_axis, mask=mask)

    def decode_logits(self, params: dict, enc_out: torch.Tensor,
                      dec_ids: torch.Tensor, tp_axis: str | None = None, *,
                      enc_mask=None) -> torch.Tensor:
        """Teacher-forced logits on this rank's shards under the mesh,
        whole [B, T, V] (gathered, pad vocab rows dropped)."""
        with collectives.active(self.mesh):
            out = super().decode_logits(params, enc_out, dec_ids,
                                        self.tp_axis, enc_mask=enc_mask)
            return self._whole_logits(out)

    def make_forward(self):
        """(params, enc_ids, dec_ids, enc_mask) -> [B, T, V] f32 logits:
        the tensor-parallel teacher-forced forward (encode +
        decode_logits under the mesh, the vocab slices gathered and the
        pad rows dropped)."""
        return lambda params, enc_ids, dec_ids, mask: self.forward(
            params, enc_ids, dec_ids, enc_mask=mask)

    def make_step(self, *, donate: bool = True):
        """The incremental step on this rank's shards and cache under
        the mesh; the logits come back whole on every rank."""
        step = self._steps.get(donate)
        if step is not None:
            return step
        inner = self._step_fn(donate, tp_axis=self.tp_axis)

        def step(params, cache, ids):
            with collectives.active(self.mesh):
                logits, cache = inner(params, cache, ids)
                return self._whole_logits(logits), cache

        self._steps[donate] = step
        return step


def spmd_t5(
    mesh: Any,
    cfg: T5Config,
    *,
    compute_dtype: Any = torch.bfloat16,
    tp_axis: str = "model",
) -> SpmdT5:
    """Tensor-parallel T5 serving (mirrors models/llama.spmd_llama)."""
    return SpmdT5(cfg, compute_dtype=compute_dtype, mesh=mesh,
                  tp_axis=tp_axis)
