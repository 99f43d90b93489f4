"""Pass 1 — mutation-domain race detector (`cross-domain-write`); the
reference's pass (defer_tpu/analysis/domains.py), same model, same
annotation syntax.

The serving stack's thread story is a set of single-writer invariants:
the module docstrings say the pool, the radix `PrefixBlockCache`,
`SlotSampler` rows and the fleet adverts are touched by exactly one
thread, while drain/transport threads only ever park work in queues for
the serving thread to pump. This pass turns that prose into a checked
contract. The port's threads carry the reference's annotations: the
spill and ingest drains `domain(drain)`, the fleet replica's loop and a
follower replica's thread `domain(serving)`, the obs dumper and the
disagg prefill worker `domain(transport)`, `serve_pp_stage`
`domain(pp-stage-worker)`, the input prefetcher `domain(prefetch)`.

Model
-----
Every function gets a set of THREAD DOMAINS — names for "which thread
runs this":

- the serving roots (callgraph.DEFAULT_ROOTS) seed domain ``serving``;
- an annotation comment on (or immediately above) a ``def`` pins a
  domain explicitly::

      # analysis: domain(drain) device->host copies live here
      def _drain_loop(self):

- any function passed as ``threading.Thread(target=...)`` that carries
  no annotation is inferred to start its OWN domain, named after the
  Thread's ``name=`` kwarg when that is a string literal (else
  ``thread:<funcname>``) — a conservative default that forces either an
  annotation or a justification the first time it shares state;
- domains flow through the same open-world callgraph the host-sync
  rule uses (a call through a library module, `torch.cuda.stream(s)`,
  links no corpus function). An annotated function is a propagation
  barrier: its declared domain wins over whatever domain its callers
  run in.

``domain(any)`` marks a function whose writes are deliberately
cross-thread-safe (a test seam, an Event-mediated handoff); its writes
never count toward a race.

Finding
-------
For every ``self``-rooted attribute/subscript write (``self.x = ...``,
``self.x[i] = ...``, ``self.x += ...``) outside ``__init__``, writes to
the same (class, attribute) slot are grouped. If the writers span two
or more concrete domains, each write NOT lexically inside a
``with <lock>:`` block is flagged. Queue ``put``/``get`` and Event
``set`` are method calls, not attribute writes, so the sanctioned
park/pump handoff pattern (disagg/ingest.py, `HostKVSpill`) is clean
by construction — exactly the point of the convention.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Iterator

from defer_tpu_torch.analysis.callgraph import FuncInfo
from defer_tpu_torch.analysis.ignore import comments
from defer_tpu_torch.analysis.rules import (
    RULES,
    Context,
    Finding,
    _FUNC_NODES,
    _mentions_lock,
)

SERVING_DOMAIN = "serving"
ANY_DOMAIN = "any"

_DOMAIN_MARKER = re.compile(
    r"#\s*analysis:\s*domain\(\s*(?P<name>[a-z0-9_\-:]+)\s*\)"
    r"\s*[-—:]*\s*(?P<reason>.*)$"
)

_CONSTRUCTORS = {"__init__", "__post_init__", "__new__"}


@dataclasses.dataclass(frozen=True)
class DomainAnnot:
    line: int  # the code line (def line) this annotation covers
    domain: str
    reason: str


class DomainMap:
    """All ``# analysis: domain(...)`` annotations of one file,
    attached the same way ignore.py attaches suppressions: a trailing
    comment covers its own line, a comment alone on a line covers the
    next code line (comment/blank lines between don't break the
    link)."""

    def __init__(self, source: str):
        self.by_line: dict[int, DomainAnnot] = {}
        lines = source.splitlines()
        for text, row, col in comments(source):
            m = _DOMAIN_MARKER.match(text)
            if m is None:
                continue
            target = row
            if not lines[row - 1][:col].strip():
                target = row + 1
                while target <= len(lines):
                    text = lines[target - 1].strip()
                    if text and not text.startswith("#"):
                        break
                    target += 1
            self.by_line[target] = DomainAnnot(
                line=target,
                domain=m.group("name"),
                reason=m.group("reason").strip(),
            )


@dataclasses.dataclass(frozen=True)
class _Write:
    attr: str  # dotted chain after self: "slots", "radix.lru"
    line: int
    col: int
    locked: bool


def _self_chain(node: ast.AST) -> str | None:
    """Dotted attribute chain rooted at `self` for a write target:
    `self.slots[i]` -> "slots", `self._store` -> "_store",
    `self.radix.generation` -> "radix.generation". None for anything
    not rooted at a bare `self` name."""
    while isinstance(node, ast.Subscript):
        node = node.value
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self" and parts:
        return ".".join(reversed(parts))
    return None


def _write_targets(stmt: ast.AST) -> Iterator[ast.AST]:
    if isinstance(stmt, ast.Assign):
        for tgt in stmt.targets:
            if isinstance(tgt, (ast.Tuple, ast.List)):
                yield from tgt.elts
            else:
                yield tgt
    elif isinstance(stmt, ast.AugAssign):
        yield stmt.target
    elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        yield stmt.target


def _collect_writes(fn_node: ast.AST) -> list[_Write]:
    """Self-rooted writes of one function body (nested defs are their
    own analysis units), each tagged with whether a lock-mentioning
    `with` block encloses it lexically."""
    out: list[_Write] = []

    def walk(node: ast.AST, locked: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNC_NODES):
                continue
            inner = locked
            if isinstance(child, (ast.With, ast.AsyncWith)) and any(
                _mentions_lock(item.context_expr)
                for item in child.items
            ):
                inner = True
            for tgt in _write_targets(child):
                chain = _self_chain(tgt)
                if chain is not None:
                    out.append(
                        _Write(
                            chain, child.lineno, child.col_offset, inner
                        )
                    )
            walk(child, inner)

    walk(fn_node, False)
    return out


def _annot_for(
    annots: dict[str, DomainMap], fi: FuncInfo
) -> DomainAnnot | None:
    dm = annots.get(fi.path)
    if dm is None:
        return None
    return dm.by_line.get(fi.node.lineno)


def infer_domains(
    ctx: Context, annots: dict[str, DomainMap]
) -> dict[int, set[str]]:
    """id(FuncInfo.node) -> set of thread domains that reach it."""
    graph = ctx.graph
    domains: dict[int, set[str]] = {}
    entries: list[tuple[FuncInfo, str]] = []

    annotated: set[int] = set()
    for fi in graph.functions:
        ann = _annot_for(annots, fi)
        if ann is not None:
            annotated.add(id(fi.node))
            entries.append((fi, ann.domain))

    for root in ctx.roots:
        for fi in graph.root_functions(root):
            if id(fi.node) not in annotated:
                entries.append((fi, SERVING_DOMAIN))

    for site in graph.thread_sites:
        for fi in graph.resolve_thread_target(site):
            if id(fi.node) in annotated:
                continue
            inferred = site.thread_name or f"thread:{fi.name}"
            entries.append((fi, inferred))

    for entry, dom in entries:
        frontier = [entry]
        while frontier:
            fi = frontier.pop()
            seen = domains.setdefault(id(fi.node), set())
            if dom in seen:
                continue
            seen.add(dom)
            for bare, calls in (
                (True, fi.calls_bare),
                (False, fi.calls_attr),
            ):
                for callee in calls:
                    for c in graph.resolve_call(fi, callee, bare):
                        # Annotated callees keep their declared
                        # domain — the annotation is a barrier.
                        if id(c.node) in annotated:
                            continue
                        if dom not in domains.get(id(c.node), ()):
                            frontier.append(c)
    return domains


def rule_cross_domain_write(ctx: Context) -> list[Finding]:
    annots = {m.path: DomainMap(m.source) for m in ctx.modules}
    domains = infer_domains(ctx, annots)

    # (class, attr-chain) -> [(write, fi, writer-domains)]
    groups: dict[
        tuple[str, str], list[tuple[_Write, FuncInfo, set[str]]]
    ] = {}
    for fi in ctx.graph.functions:
        if fi.owner_class is None or fi.name in _CONSTRUCTORS:
            continue
        doms = domains.get(id(fi.node))
        if not doms:
            continue  # unreachable from any entry: unattributable
        for w in _collect_writes(fi.node):
            groups.setdefault((fi.owner_class, w.attr), []).append(
                (w, fi, doms)
            )

    out: list[Finding] = []
    for (cls, attr), writers in groups.items():
        concrete: set[str] = set()
        for _, _, doms in writers:
            concrete |= doms - {ANY_DOMAIN}
        if len(concrete) < 2:
            continue
        for w, fi, doms in writers:
            own = doms - {ANY_DOMAIN}
            if not own or w.locked:
                continue
            others = sorted(concrete - own)
            if not others:
                continue  # every foreign writer was domain(any)
            other_site = next(
                (
                    f"{ofi.path}:{ow.line}"
                    for ow, ofi, odoms in writers
                    if (odoms - {ANY_DOMAIN}) - own
                ),
                "elsewhere",
            )
            out.append(
                Finding(
                    "cross-domain-write",
                    fi.path,
                    w.line,
                    w.col,
                    f"`self.{attr}` ({cls}) is written here in "
                    f"domain({'/'.join(sorted(own))}) and from "
                    f"domain({'/'.join(others)}) at {other_site} "
                    "with no lock held — single-writer invariant "
                    "broken; take the lock, hand off through a "
                    "park/pump queue, or annotate the entry points "
                    "(# analysis: domain(...)) / justify with an "
                    "ignore",
                )
            )
    return out


# Registration lives with the rule (rules.py's convention); runner.py
# imports this module so the pass is always on.
RULES["cross-domain-write"] = rule_cross_domain_write
