"""Device-side constraint runtime helpers: the mask fold on tensors.

Counterpart of `defer_tpu/constrain/runtime.py`. A server built with
`constraints={name: TokenDFA}` stacks every DFA (plus one synthetic
accept-everything DFA at index 0, the FREE row) into two padded tables
on its device:

    trans_all: int32 [C, S_max, V]   (-1 = inadmissible / padding)
    acc_all:   bool  [C, S_max]

Each slot carries two int32 policy rows in SlotSampler, `cid` (which
constraint; 0 = free) and `cstate` (current DFA state), and the
per-token mask fold is one gather plus one where:

    row  = trans_all[cid, cstate]            # [B, V]
    mask = row >= 0; mask[:, eos] = acc      # eos iff accepting
    ll   = where(mask, ll, finfo.min)
    state' = max(row[nxt], 0)                # after sampling nxt

For a FREE row the mask is all-True, so the fold is an exact no-op on
that row. Every helper here runs on the device without a host sync, so
it runs inside a captured decode window as well as in an eager tick.
"""

from __future__ import annotations

import numpy as np
import torch

from defer_tpu_torch.constrain.dfa import ConstraintError, TokenDFA

#: cid value of an unconstrained slot (row 0 of the stacked tables).
FREE_CID = 0


def stack_token_dfas(
    constraints: dict[str, TokenDFA], vocab_size: int, device=None
) -> tuple[dict[str, int], torch.Tensor, torch.Tensor]:
    """Validate + stack named DFAs into the padded tables on `device`.
    Returns (name -> cid, trans_all [C, S_max, V], acc_all [C, S_max]);
    cid 0 is the synthetic free row, names take 1..C-1 sorted."""
    if not constraints:
        raise ConstraintError("constraints= given but empty")
    for name, dfa in constraints.items():
        if not isinstance(dfa, TokenDFA):
            raise ConstraintError(
                f"constraint {name!r} is {type(dfa).__name__}, "
                "expected a constrain.TokenDFA"
            )
        if dfa.vocab_size != vocab_size:
            raise ConstraintError(
                f"constraint {name!r} compiled for vocab "
                f"{dfa.vocab_size}, model vocab is {vocab_size}"
            )
    names = sorted(constraints)
    s_max = max([1] + [constraints[n].num_states for n in names])
    C = len(names) + 1
    trans = np.full((C, s_max, vocab_size), -1, np.int32)
    acc = np.zeros((C, s_max), bool)
    # Free row: one state, every token loops, always accepting.
    trans[FREE_CID, 0, :] = 0
    acc[FREE_CID, 0] = True
    cids = {}
    for k, name in enumerate(names, start=1):
        dfa = constraints[name]
        trans[k, : dfa.num_states] = dfa.transitions
        acc[k, : dfa.num_states] = dfa.accepting
        cids[name] = k
    return (
        cids,
        torch.from_numpy(trans).to(device),
        torch.from_numpy(acc).to(device),
    )


def resolve_constraint(name, ctrans, cnames, cdfas) -> int:
    """Constraint name -> stacked-table cid, validated at submit time
    (unknown names and start-state dead ends fail the caller and never
    wedge a slot)."""
    if name is None:
        return FREE_CID
    if ctrans is None:
        raise ValueError(
            f"sampling requests constraint {name!r} but the "
            "server was built without constraints="
        )
    cid = cnames.get(name)
    if cid is None:
        raise ValueError(
            f"unknown constraint {name!r}; registered: {sorted(cnames)}"
        )
    dfa = cdfas[cid]
    if not dfa.accepting[dfa.start] and not (
        dfa.transitions[dfa.start] >= 0
    ).any():
        raise ValueError(
            f"constraint {name!r} admits no first token (dead "
            "start state: compile via constrain.compile_regex "
            "to get dead states pruned at build time)"
        )
    return cid


def constrain_rows(trans_all, acc_all, cid, cstate):
    """Per-slot transition row + accepting bit: ([B, V], [B])."""
    cid, cstate = cid.long(), cstate.long()
    return trans_all[cid, cstate], acc_all[cid, cstate]


def constrain_mask(row, acc, eos_id: int):
    """Admissibility mask [B, V]: the table says yes, except the eos
    column, which is admitted exactly in accepting states."""
    mask = row >= 0
    mask[:, eos_id] = acc
    return mask


def fold_mask(ll, mask):
    """Mask-fold into the logits; finfo.min (not -inf) so a sampled
    row's softmax stays NaN-free even near a dead end."""
    return torch.where(mask, ll, torch.finfo(ll.dtype).min)


def advance_state(row, cstate, nxt, advance):
    """Post-sample state update: rows with `advance` move to row[nxt]
    (clamped: the eos or a forced column may be -1), others keep their
    state."""
    new = torch.gather(row, 1, nxt[:, None].long())[:, 0]
    return torch.where(advance, new.clamp(min=0), cstate)


def masked_frac(mask, active):
    """Fraction of the vocabulary the constraint masked off, per row
    (float32 [B]); inactive rows report 0."""
    frac = 1.0 - mask.float().mean(dim=-1)
    return torch.where(active, frac, 0.0)


def constrained_pick(trans_all, acc_all, ll, cid, cstate, active, eos_id):
    """The grammar policy of one constrained pick, shared by the K=1
    tick, the decode window, admission's first token and the draft's
    proposals: mask the logits `ll` [B, V] to each row's admissible
    tokens (eos only in accepting states); flag the dead ends (an
    `active` constrained row with no admissible token); and report the
    masked fraction. Returns (masked logits, dead [B], settle, frac [B]),
    where `settle(nxt)` takes the sampled tokens and returns
    (nxt with every dead row forced to eos, the advanced states): a
    dead row keeps its state and its forced eos freezes it. Free rows
    (cid 0) pass through unmasked and keep state 0."""
    crow, acc = constrain_rows(trans_all, acc_all, cid, cstate)
    mask = constrain_mask(crow, acc, eos_id)
    cvec = cid > 0
    live = cvec & active
    dead = live & ~mask.any(-1)

    def settle(nxt):
        nxt = torch.where(dead, eos_id, nxt)
        return nxt, advance_state(crow, cstate, nxt, cvec & ~dead)

    return fold_mask(ll, mask), dead, settle, masked_frac(mask, live)
