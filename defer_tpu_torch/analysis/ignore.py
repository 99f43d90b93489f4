"""Inline suppression comments: ``# analysis: ignore[rule] reason``.

Grammar (one comment suppresses one line):

    x = np.asarray(y)  # analysis: ignore[host-sync-in-hot-loop] final drain
    # analysis: ignore[lock-discipline] frame writes must serialize
    self._sock.sendall(buf)

- ``ignore[a, b]`` lists the rules it silences; ``ignore`` with no
  bracket silences every rule (discouraged — strict mode wants intent).
- A trailing comment covers its own line; a comment alone on a line
  covers the next CODE line — intervening comment/blank lines don't
  break the link, so justifications may wrap over several lines.
- Everything after the bracket is the justification. ``--strict``
  treats a reason-less ignore as a finding itself: the escape hatch
  must document why the hazard is safe, not just mute it.

Comments are found with `tokenize`, not a regex over raw lines, so a
string literal containing the marker text can never suppress anything.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import re
import tokenize

_MARKER = re.compile(
    r"#\s*analysis:\s*ignore"
    r"(?:\[(?P<rules>[a-z0-9_\-,\s]*)\])?"
    r"\s*[-—:]*\s*(?P<reason>.*)$"
)


@dataclasses.dataclass(frozen=True)
class Ignore:
    line: int  # the source line this ignore suppresses
    comment_line: int  # where the comment itself lives
    rules: frozenset[str]  # empty = suppress all rules
    reason: str

    def covers(self, rule: str) -> bool:
        return not self.rules or rule in self.rules


@functools.lru_cache(maxsize=512)
def comments(source: str) -> tuple[tuple[str, int, int], ...]:
    """(text, row, col) of every comment token of a file, tokenized once
    for the ignore and the domain annotations; () when the file does not
    tokenize (the runner reports unparsable files anyway)."""
    try:
        return tuple(
            (tok.string, *tok.start)
            for tok in tokenize.generate_tokens(io.StringIO(source).readline)
            if tok.type == tokenize.COMMENT
        )
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return ()


class IgnoreMap:
    """All ignore comments of one file, queryable by (rule, line)."""

    def __init__(self, source: str):
        self.ignores: list[Ignore] = []
        self._by_line: dict[int, list[Ignore]] = {}
        lines = source.splitlines()
        for text, row, col in comments(source):
            m = _MARKER.match(text)
            if m is None:
                continue
            rules = frozenset(
                r.strip()
                for r in (m.group("rules") or "").split(",")
                if r.strip()
            )
            own_line = not lines[row - 1][:col].strip()
            target = row
            if own_line:
                # Next code line: skip the justification's own wrapped
                # comment lines and any blanks.
                target = row + 1
                while target <= len(lines):
                    text = lines[target - 1].strip()
                    if text and not text.startswith("#"):
                        break
                    target += 1
            ign = Ignore(
                line=target,
                comment_line=row,
                rules=rules,
                reason=m.group("reason").strip(),
            )
            self.ignores.append(ign)
            self._by_line.setdefault(ign.line, []).append(ign)

    def match(self, rule: str, line: int) -> Ignore | None:
        for ign in self._by_line.get(line, ()):
            if ign.covers(rule):
                return ign
        return None
