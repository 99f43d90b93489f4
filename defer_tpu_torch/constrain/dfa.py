"""Host-side constraint compiler: regex -> token-level DFA.

The port's own copy of `defer_tpu/constrain/dfa.py` (numpy and the
standard library only): the same pipeline builds the same tables.

The serving runtime wants ONE dense table per constraint —
`transitions: int32 [S, V]` (-1 = token inadmissible) plus
`accepting: bool [S]` — because that shape folds into the batched
logits path as a single gather + mask (`transitions[state] >= 0`)
with zero host involvement per tick. Everything string-shaped
happens here, offline, once per (pattern, vocab) pair:

    1. parse the regex dialect below into an AST;
    2. Thompson-construct an NFA over CHARACTER sets, with the
       concrete alphabet = every character that appears in any vocab
       token string (so `.` and negated classes are exact over what
       the model can actually emit);
    3. subset-construct the character DFA;
    4. lift to tokens: token t maps state s to the state reached by
       running t's characters from s, or -1 if any step dies;
    5. prune by TOKEN co-reachability: any transition into a state
       that cannot reach an accepting state via token transitions is
       cut to -1. After this pass a compiled DFA can NEVER dead-end
       at runtime — every admissible token keeps an accepting state
       reachable — and an unsatisfiable (pattern, vocab) pair fails
       here, at compile time, instead of wedging a decode slot.

The dialect is a strict subset of Python `re` syntax (literals,
`.`, `[...]`/`[^...]` classes with ranges, `|`, groups, `*` `+` `?`
`{m}` `{m,}` `{m,n}`, and `\\d \\D \\w \\W \\s \\S` plus escaped
punctuation), so a test can re-validate emitted strings with
`re.fullmatch(pattern, text)` directly.

EOS is deliberately NOT part of the table: the runtime admits the
server's `eos_id` exactly in accepting states (the mask overwrites
that one column), and empty-string vocab entries are always
inadmissible — emitting one would advance the decode position
without advancing the constraint.
"""

from __future__ import annotations

import dataclasses
import string

import numpy as np


class ConstraintError(ValueError):
    """Raised for unparseable patterns and for (pattern, vocab) pairs
    whose token DFA cannot reach an accepting state — the compile-time
    surfacing of what would otherwise be a runtime dead-end."""


# -- pattern AST -------------------------------------------------------

_DIGITS = frozenset(string.digits)
_WORD = frozenset(string.ascii_letters + string.digits + "_")
_SPACE = frozenset(" \t\n\r\f\v")
_SPECIAL = frozenset("()[]{}|*+?.\\")


@dataclasses.dataclass(frozen=True)
class _CharSet:
    """A character predicate deferred until the alphabet is known:
    `chars` minus nothing (negate=False) or alphabet minus `chars`
    (negate=True). `.` is alphabet minus newline, per `re` default."""

    chars: frozenset
    negate: bool = False

    def resolve(self, alphabet: frozenset) -> frozenset:
        if self.negate:
            return alphabet - self.chars
        return self.chars & alphabet


_ANY = _CharSet(frozenset("\n"), negate=True)


@dataclasses.dataclass(frozen=True)
class _Lit:
    cs: _CharSet


@dataclasses.dataclass(frozen=True)
class _Cat:
    parts: tuple


@dataclasses.dataclass(frozen=True)
class _Alt:
    parts: tuple


@dataclasses.dataclass(frozen=True)
class _Rep:
    node: object
    lo: int
    hi: int | None  # None = unbounded


class _Parser:
    """Recursive-descent parser for the dialect above."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def _err(self, msg: str) -> ConstraintError:
        return ConstraintError(
            f"bad pattern at index {self.i}: {msg} (in {self.p!r})"
        )

    def _peek(self) -> str | None:
        return self.p[self.i] if self.i < len(self.p) else None

    def _take(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise self._err(f"unexpected {self.p[self.i]!r}")
        return node

    def _alt(self):
        parts = [self._cat()]
        while self._peek() == "|":
            self._take()
            parts.append(self._cat())
        return parts[0] if len(parts) == 1 else _Alt(tuple(parts))

    def _cat(self):
        parts = []
        while self._peek() not in (None, "|", ")"):
            parts.append(self._repeat())
        if not parts:
            return _Cat(())  # empty branch matches ""
        return parts[0] if len(parts) == 1 else _Cat(tuple(parts))

    def _repeat(self):
        node = self._atom()
        while True:
            c = self._peek()
            if c == "*":
                self._take()
                node = _Rep(node, 0, None)
            elif c == "+":
                self._take()
                node = _Rep(node, 1, None)
            elif c == "?":
                self._take()
                node = _Rep(node, 0, 1)
            elif c == "{":
                node = _Rep(node, *self._braces())
            else:
                return node

    def _braces(self) -> tuple[int, int | None]:
        self._take()  # '{'
        lo = self._int("repeat lower bound")
        hi: int | None = lo
        if self._peek() == ",":
            self._take()
            hi = None if self._peek() == "}" else self._int(
                "repeat upper bound"
            )
        if self._peek() != "}":
            raise self._err("expected '}'")
        self._take()
        if hi is not None and hi < lo:
            raise self._err(f"repeat bounds {{{lo},{hi}}} inverted")
        return lo, hi

    def _int(self, what: str) -> int:
        digits = ""
        while self._peek() is not None and self._peek().isdigit():
            digits += self._take()
        if not digits:
            raise self._err(f"expected {what}")
        return int(digits)

    def _atom(self):
        c = self._peek()
        if c is None:
            raise self._err("pattern ended early")
        if c == "(":
            self._take()
            node = self._alt()
            if self._peek() != ")":
                raise self._err("unclosed group")
            self._take()
            return node
        if c == "[":
            return _Lit(self._char_class())
        if c == ".":
            self._take()
            return _Lit(_ANY)
        if c == "\\":
            return _Lit(self._escape())
        if c in _SPECIAL:
            raise self._err(f"unescaped {c!r}")
        self._take()
        return _Lit(_CharSet(frozenset(c)))

    def _escape(self) -> _CharSet:
        self._take()  # backslash
        if self._peek() is None:
            raise self._err("dangling backslash")
        e = self._take()
        table = {
            "d": _CharSet(_DIGITS),
            "D": _CharSet(_DIGITS, negate=True),
            "w": _CharSet(_WORD),
            "W": _CharSet(_WORD, negate=True),
            "s": _CharSet(_SPACE),
            "S": _CharSet(_SPACE, negate=True),
            "n": _CharSet(frozenset("\n")),
            "t": _CharSet(frozenset("\t")),
            "r": _CharSet(frozenset("\r")),
        }
        if e in table:
            return table[e]
        return _CharSet(frozenset(e))  # escaped punctuation/literal

    def _char_class(self) -> _CharSet:
        self._take()  # '['
        negate = self._peek() == "^"
        if negate:
            self._take()
        chars: set = set()
        negsets: list[_CharSet] = []
        if self._peek() == "]":  # leading ']' is a literal, as in re
            chars.add(self._take())
        while self._peek() not in (None, "]"):
            if self._peek() == "\\":
                cs = self._escape()
                if cs.negate:
                    negsets.append(cs)
                else:
                    chars |= cs.chars
                continue
            lo = self._take()
            if self._peek() == "-" and self.p[self.i + 1 : self.i + 2] not in (
                "", "]"
            ):
                self._take()
                hi = self._take()
                if ord(hi) < ord(lo):
                    raise self._err(f"range {lo}-{hi} inverted")
                chars |= {chr(o) for o in range(ord(lo), ord(hi) + 1)}
            else:
                chars.add(lo)
        if self._peek() != "]":
            raise self._err("unclosed character class")
        self._take()
        if negsets:
            # e.g. [\D...]: fold by De Morgan into one deferred set.
            if len(negsets) > 1 or chars or negate:
                raise self._err(
                    "negated escapes may not be combined inside a class"
                )
            return negsets[0]
        return _CharSet(frozenset(chars), negate=negate)


# -- NFA / DFA construction -------------------------------------------


class _NFA:
    """Thompson NFA: eps edges plus char-set edges, one accept."""

    def __init__(self):
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[frozenset, int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def build(self, node, alphabet: frozenset) -> tuple[int, int]:
        """Returns (start, accept) fragment for `node`."""
        if isinstance(node, _Lit):
            s, a = self.state(), self.state()
            self.edges[s].append((node.cs.resolve(alphabet), a))
            return s, a
        if isinstance(node, _Cat):
            s = a = self.state()
            for part in node.parts:
                ps, pa = self.build(part, alphabet)
                self.eps[a].append(ps)
                a = pa
            return s, a
        if isinstance(node, _Alt):
            s, a = self.state(), self.state()
            for part in node.parts:
                ps, pa = self.build(part, alphabet)
                self.eps[s].append(ps)
                self.eps[pa].append(a)
            return s, a
        if isinstance(node, _Rep):
            s = a = self.state()
            for _ in range(node.lo):
                ps, pa = self.build(node.node, alphabet)
                self.eps[a].append(ps)
                a = pa
            if node.hi is None:
                ps, pa = self.build(node.node, alphabet)
                self.eps[a].append(ps)
                self.eps[pa].append(ps)
                end = self.state()
                self.eps[a].append(end)
                self.eps[pa].append(end)
                return s, end
            for _ in range(node.hi - node.lo):
                ps, pa = self.build(node.node, alphabet)
                self.eps[a].append(ps)
                end = self.state()
                self.eps[a].append(end)
                self.eps[pa].append(end)
                a = end
            return s, a
        raise AssertionError(f"unknown node {node!r}")

    def closure(self, states: frozenset) -> frozenset:
        seen = set(states)
        stack = list(states)
        while stack:
            for t in self.eps[stack.pop()]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)


def _char_dfa(
    pattern: str, alphabet: frozenset
) -> tuple[dict[tuple[int, str], int], set[int], int]:
    """Subset construction: (transitions, accepting states, count)."""
    ast_root = _Parser(pattern).parse()
    nfa = _NFA()
    start, accept = nfa.build(ast_root, alphabet)
    d0 = nfa.closure(frozenset([start]))
    ids: dict[frozenset, int] = {d0: 0}
    order = [d0]
    trans: dict[tuple[int, str], int] = {}
    i = 0
    while i < len(order):
        cur = order[i]
        # Group the outgoing char sets once per state, then move per
        # char — alphabets are small (chars the vocab can emit).
        chars: set = set()
        for st in cur:
            for cs, _ in nfa.edges[st]:
                chars |= cs
        for c in sorted(chars):
            nxt = frozenset(
                t
                for st in cur
                for cs, t in nfa.edges[st]
                if c in cs
            )
            nxt = nfa.closure(nxt)
            if nxt not in ids:
                ids[nxt] = len(order)
                order.append(nxt)
            trans[(ids[cur], c)] = ids[nxt]
        i += 1
    accepting = {ids[s] for s in order if accept in s}
    return trans, accepting, len(order)


# -- the token-level artifact -----------------------------------------


@dataclasses.dataclass
class TokenDFA:
    """Dense token-level DFA over a fixed vocabulary.

    `transitions[s, t]` is the state after emitting token t from
    state s, or -1 when t is inadmissible there; `accepting[s]` marks
    states where the constraint is satisfied (the runtime admits eos
    exactly there). `start` is always a valid row index. `pattern`
    is carried for error messages and for tests to re-validate
    emitted strings against the source regex."""

    transitions: np.ndarray  # int32 [S, V]
    accepting: np.ndarray  # bool [S]
    start: int = 0
    pattern: str = ""

    def __post_init__(self):
        self.transitions = np.asarray(self.transitions, np.int32)
        self.accepting = np.asarray(self.accepting, bool)
        if self.transitions.ndim != 2:
            raise ConstraintError(
                f"transitions must be [S, V], got shape "
                f"{self.transitions.shape}"
            )
        if self.accepting.shape != (self.transitions.shape[0],):
            raise ConstraintError(
                f"accepting shape {self.accepting.shape} does not "
                f"match {self.transitions.shape[0]} states"
            )
        if not 0 <= self.start < self.transitions.shape[0]:
            raise ConstraintError(f"start state {self.start} out of range")

    @property
    def num_states(self) -> int:
        return int(self.transitions.shape[0])

    @property
    def vocab_size(self) -> int:
        return int(self.transitions.shape[1])

    def step(self, state: int, token: int) -> int:
        """Host-side single step (tests/validation): -1 = rejected."""
        return int(self.transitions[state, token])

    def admissible(self, state: int) -> np.ndarray:
        """Host-side mask row [V] (eos column NOT special-cased)."""
        return self.transitions[state] >= 0

    def walk(self, tokens) -> int:
        """Run a token sequence from start; returns the final state or
        -1 the moment any step is inadmissible."""
        s = self.start
        for t in tokens:
            s = int(self.transitions[s, int(t)])
            if s < 0:
                return -1
        return s


def prune_dead_states(
    transitions: np.ndarray, accepting: np.ndarray
) -> np.ndarray:
    """Cut every transition into a state that cannot reach an
    accepting state through token transitions (backward co-
    reachability fixpoint). Returns the pruned copy; the caller
    decides what a dead start state means."""
    trans = np.array(transitions, np.int32, copy=True)
    live = set(np.flatnonzero(accepting).tolist())
    changed = True
    while changed:
        changed = False
        for s in range(trans.shape[0]):
            if s in live:
                continue
            tgt = trans[s]
            if any(int(t) in live for t in tgt[tgt >= 0]):
                live.add(s)
                changed = True
    for s in range(trans.shape[0]):
        row = trans[s]
        bad = (row >= 0) & ~np.isin(row, list(live) or [-1])
        row[bad] = -1
    return trans


def compile_regex(pattern: str, vocab: list[str]) -> TokenDFA:
    """Lower `pattern` against a token-string vocabulary (index =
    token id) into a TokenDFA. Raises ConstraintError when the
    pattern cannot match any token sequence from this vocabulary —
    the unsatisfiable case a runtime must never be handed."""
    if not vocab:
        raise ConstraintError("empty vocabulary")
    alphabet = frozenset(c for tok in vocab for c in tok)
    ctrans, caccept, n_states = _char_dfa(pattern, alphabet)
    V = len(vocab)
    trans = np.full((n_states, V), -1, np.int32)
    for tid, tok in enumerate(vocab):
        if not tok:
            continue  # empty-string tokens never admissible
        for s in range(n_states):
            cur = s
            for c in tok:
                nxt = ctrans.get((cur, c))
                if nxt is None:
                    cur = -1
                    break
                cur = nxt
            trans[s, tid] = cur
    accepting = np.zeros((n_states,), bool)
    accepting[list(caccept)] = True
    trans = prune_dead_states(trans, accepting)
    if not accepting[0] and not (trans[0] >= 0).any():
        raise ConstraintError(
            f"pattern {pattern!r} is unsatisfiable with this "
            f"vocabulary: no token sequence can reach an accepting "
            "state"
        )
    return TokenDFA(trans, accepting, start=0, pattern=pattern)
