"""Multi-token stop sequences: host-side suffix matching on streamed
tokens.

A copy of `defer_tpu/runtime/stopping.py` (pure Python), kept in the port
so that it imports nothing of the JAX package.

A single stop TOKEN (eos_id) is a per-row equality in the decode step
(models/gpt.py apply_eos). A stop SEQUENCE spans ticks, so it is matched
on the host where streamed tokens already surface (the server's tick
drain and `sampled_decode_loop`'s per-token host sync): each stream
keeps the last max_stop tokens and compares suffixes per emitted token.

Matching covers GENERATED tokens only: a stop sequence never triggers on
prompt content, and the emitted output ENDS WITH the stop sequence,
mirroring eos.
"""

from __future__ import annotations


def normalize_stops(stop_sequences) -> tuple[tuple[int, ...], ...]:
    """Validate and canonicalize `stop_sequences` (an iterable of
    non-empty int sequences) to a tuple of int tuples."""
    if stop_sequences is None:
        return ()
    seqs = []
    for s in stop_sequences:
        t = tuple(int(x) for x in s)
        if not t:
            raise ValueError("empty stop sequence")
        seqs.append(t)
    return tuple(seqs)


def matcher_or_none(seqs: tuple[tuple[int, ...], ...]):
    """One StopMatcher per request when stop sequences were given,
    else None — the construction every server admission shares."""
    return StopMatcher(seqs) if seqs else None


class StopMatcher:
    """Suffix matcher for ONE token stream: push() each generated
    token; returns True the moment the stream's tail equals any stop
    sequence. Keeps only the longest-stop-minus-one history."""

    __slots__ = ("seqs", "keep", "hist")

    def __init__(self, seqs: tuple[tuple[int, ...], ...]):
        if not seqs:
            raise ValueError("StopMatcher needs at least one sequence")
        self.seqs = seqs
        self.keep = max(len(s) for s in seqs)
        self.hist: list[int] = []

    def push(self, tok: int) -> bool:
        self.hist.append(int(tok))
        if len(self.hist) > self.keep:
            del self.hist[: len(self.hist) - self.keep]
        h = self.hist
        n = len(h)
        for s in self.seqs:
            if n >= len(s) and tuple(h[n - len(s):]) == s:
                return True
        return False

    def push_window(self, toks) -> int | None:
        """Window drain: push a whole window's worth of one stream's
        tokens and return the ACCEPTED count — index of the first
        match plus one, so the output ends with the stop sequence —
        or None if nothing matched. Tokens past the match are never
        pushed: they are window overshoot (the device ran the rest of
        the window blind to stop sequences) and must not pollute the
        history a later window matches against."""
        for j, tok in enumerate(toks):
            if self.push(tok):
                return j + 1
        return None
