"""Speculative decoding: draft-model proposal + target verification.

Counterpart of `defer_tpu/models/speculative.py`. A small DRAFT decoder
proposes k tokens autoregressively (T=1 steps through `flash_decode` on
a CUDA draft), then the TARGET verifies all k in one T = k or k+1 step
(the einsum path, as every multi-token step). Greedy acceptance keeps
the output exactly the target's greedy decode while the target takes
(accepted + 1) tokens a weight read instead of one.

A rejection is a position rewind: the cache masks attention by absolute
position (models/gpt.py), so K/V rows past `pos` are never attended and
the next write overwrites them; rollback costs a scalar update. The
accept rule is `runtime/batching.py::accept_lengths`, the rule a paged
server's speculative mode shares.

Sampled mode (temperature > 0) is speculative sampling (Leviathan/Chen):
the draft samples from its filtered distribution q, token x_j is
accepted with probability min(1, p_j(x_j)/q_j(x_j)), and the first
rejection resamples from the normalized residual max(p_j - q_j, 0), so
the output distribution is the target's. Its draws come from one torch
generator (Gumbel-max over the filtered logits, as `sample_token`); the
stream is not `generate`'s with the same seed, since the accept test
and the bonus token draw too.
"""

from __future__ import annotations

from typing import Any

import torch

from defer_tpu_torch.models.gpt import _gumbel_argmax, truncate_logits
from defer_tpu_torch.obs.serving import ServingMetrics
from defer_tpu_torch.runtime.batching import accept_lengths


def speculative_generate(
    target: Any,
    target_params: dict,
    draft: Any,
    draft_params: dict,
    prompt_ids: torch.Tensor,
    num_steps: int,
    *,
    k: int = 4,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    min_p: float = 0.0,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, dict]:
    """Speculative continuation of `prompt_ids` [1, T0] on the target's
    device.

    temperature 0 (default): greedy acceptance; ids equal
    `target.generate(target_params, prompt_ids, num_steps)` up to ties
    between the T=1 and T>1 attention paths' rounding (exactly in f32).

    Returns (ids [1, T0 + num_steps], stats): `target_steps` (target
    forwards, prefill included) vs `plain_steps`, `rounds`, and
    `acceptance` (the fraction of proposed tokens accepted).

    Invariant across rounds: the target cache covers `ids` except at
    most one trailing token; the draft cache covers `ids` except one
    trailing token, two right after a full-accept round, whose bonus
    token (free from the verify step's last logits) is fed to neither
    model in-round."""
    if prompt_ids.shape[0] != 1:
        raise ValueError(
            "speculative_generate is batch-1 (scalar rewind); batched "
            "speculation rides runtime/decode_server.py::DraftLanes"
        )
    for dec, name in ((target, "target"), (draft, "draft")):
        if getattr(dec, "rolling_cache", False):
            raise ValueError(
                f"{name} uses a rolling cache: rejected tokens have "
                "already overwritten live window slots, so a position "
                "rewind cannot undo them; use flat windowed caches "
                "for speculative decoding"
            )
    if prompt_ids.shape[1] < 1:
        raise ValueError("prompt must have at least one token")
    if k < 1:
        raise ValueError(f"k={k}: need at least one proposed token")
    t0 = prompt_ids.shape[1]
    for dec, name in ((target, "target"), (draft, "draft")):
        # +k: a verify round may overshoot num_steps before trimming.
        if t0 + num_steps + k > dec.cfg.max_len:
            raise ValueError(
                f"prompt {t0} + steps {num_steps} + k {k} exceeds the "
                f"{name} max_len {dec.cfg.max_len}"
            )
    dev = target.device
    prompt_ids = prompt_ids.to(dev)
    sampled = temperature > 0
    if sampled and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    obs = ServingMetrics("speculative")

    def filt(raw_logits):
        """Raw logits -> filtered logits (temperature, then top-k/top-p/
        min-p), applied alike to the target's p and the draft's q."""
        return truncate_logits(
            raw_logits.float() / temperature,
            top_k=top_k, top_p=top_p, min_p=min_p,
        )

    def draw(logits):
        u = torch.rand(logits.shape, generator=generator, device=dev)
        return _gumbel_argmax(logits, u)

    tstep = target.make_step()
    dstep = draft.make_step()
    tcache = target.init_cache(1)
    dcache = draft.init_cache(1)
    # Prefill: the target on the whole prompt (its last logits predict
    # the first new token); the draft on all but the last token.
    tlogits, tcache = tstep(target_params, tcache, prompt_ids)
    last_logits = tlogits[:, -1, :]
    if t0 > 1:
        _, dcache = dstep(draft_params, dcache, prompt_ids[:, :-1])
    # Host mirrors of the two write heads (the caches' pos tensors stay
    # on the device; every rewind below is computed on the host).
    t_pos = t0
    d_pos = t0 - 1

    ids = prompt_ids
    target_steps = 1
    rounds = 0
    accepted_total = 0
    while ids.shape[1] - t0 < num_steps:
        n0 = ids.shape[1]
        # 1. The draft proposes k tokens, starting from the tokens it
        #    has not seen: one normally, two after a full accept.
        assert n0 - d_pos in (1, 2), (n0, d_pos)
        feed = ids[:, d_pos:]
        proposals, q_dists = [], []
        for _ in range(k):
            dlg, dcache = dstep(draft_params, dcache, feed)
            d_pos += feed.shape[1]
            if sampled:
                qlog = filt(dlg[:, -1, :])
                feed = draw(qlog)[:, None].to(ids.dtype)
                q_dists.append(torch.softmax(qlog, dim=-1))
            else:
                feed = torch.argmax(dlg[:, -1, :], dim=-1)[:, None]
                feed = feed.to(ids.dtype)
            proposals.append(feed)
        prop = torch.cat(proposals, dim=1)  # [1, k]

        # 2. The target verifies in one step: the pending accepted token
        #    (0 or 1 of them) and the k proposals.
        t_missing = n0 - t_pos
        assert t_missing in (0, 1), t_missing
        verify_in = (
            torch.cat([ids[:, n0 - t_missing:], prop], dim=1)
            if t_missing else prop
        )
        vlogits, tcache = tstep(target_params, tcache, verify_in)
        t_pos += verify_in.shape[1]
        target_steps += 1
        base = last_logits if t_missing == 0 else vlogits[:, 0, :]

        def p_raw(j):
            """Target logits predicting proposal j (0-indexed)."""
            return base if j == 0 else vlogits[:, t_missing + j - 1, :]

        if sampled:
            p_all = torch.softmax(
                filt(torch.cat([p_raw(j) for j in range(k)])), dim=-1
            )  # [k, V]
            q_all = torch.cat(q_dists, dim=0)
            u_vec = torch.rand((k,), generator=generator, device=dev)
            sel = torch.arange(k, device=dev)
            # One batched transfer of (u, p, q) a round.
            u_h, p_h, q_h = (
                # analysis: ignore[host-sync-in-hot-loop] one batched transfer
                # of (u, p, q) a round: the accept test runs on the host
                t.tolist() for t in (
                    u_vec, p_all[sel, prop[0].long()],
                    q_all[sel, prop[0].long()],
                )
            )
            a = k
            replacement = None
            for j in range(k):
                if u_h[j] < min(1.0, p_h[j] / max(q_h[j], 1e-38)):
                    continue
                a = j
                residual = (p_all[j] - q_all[j]).clamp(min=0.0)
                total = residual.sum()
                src = torch.where(total > 0, residual / total, p_all[j])
                replacement = draw(
                    torch.log(src.clamp(min=1e-38))[None]
                )[:, None].to(ids.dtype)
                break
        else:
            preds = torch.cat(
                [
                    torch.argmax(base, dim=-1)[:, None],
                    torch.argmax(
                        vlogits[:, t_missing : t_missing + k - 1, :],
                        dim=-1,
                    ),
                ],
                dim=1,
            ).to(ids.dtype)  # [1, k]
            # One batched transfer of (props, preds) a round, into the
            # accept rule the paged speculative mode shares.
            # analysis: ignore[host-sync-in-hot-loop] one batched transfer of
            # (proposals, predictions) a round
            both = torch.cat([prop, preds]).tolist()
            a = int(accept_lengths([both[0]], [both[1]])[0])
            replacement = None if a == k else preds[:, a : a + 1]
        rounds += 1
        accepted_total += a
        obs.spec_rounds.inc()
        obs.spec_proposed.inc(k)
        if a:
            obs.spec_accepted.inc(a)
        obs.spec_acceptance.observe(a)

        if a == k:
            # Bonus token: the verify step's last logits already
            # predict the token after p_k. Neither model has seen it,
            # so the target pends it and the draft starts two behind.
            fin = vlogits[:, t_missing + k - 1, :]
            if sampled:
                bonus = draw(filt(fin))[:, None].to(ids.dtype)
            else:
                bonus = torch.argmax(fin, dim=-1)[:, None].to(ids.dtype)
            new = torch.cat([prop, bonus], dim=1)
        else:
            # The corrected token replaces the first rejection and
            # becomes the target's pending token.
            new = torch.cat([prop[:, :a], replacement], dim=1)
        ids = torch.cat([ids, new], dim=1)
        n1 = ids.shape[1]

        # 3. Rewind the write heads past rejected rows (masked by
        #    position, overwritten on the next write). The target covers
        #    n1 (full accept) or n0 + a; the draft ends one token behind.
        if a < k:
            t_pos = n0 + a
            tcache = {**tcache, "pos": torch.full_like(tcache["pos"], t_pos)}
        if d_pos > n1 - 1:
            d_pos = n1 - 1
            dcache = {**dcache, "pos": torch.full_like(dcache["pos"], d_pos)}

    ids = ids[:, : t0 + num_steps]
    stats = {
        "target_steps": target_steps,
        "plain_steps": num_steps,
        "rounds": rounds,
        "acceptance": accepted_total / max(1, rounds * k),
    }
    return ids, stats
