"""Lightweight name-based call graph for hot-path scoping (the port's
copy of defer_tpu/analysis/callgraph.py, which imports nothing of JAX).

The host-sync rule must only fire inside code that runs per decode
tick / per pipeline step — `.tolist()` in a one-shot admission path
is the sanctioned batched barrier (utils/sync.py), not a regression.
Precise Python call resolution is undecidable; serving loops don't
need it. This graph resolves calls *by name*:

- ``self.f(...)`` / ``obj.f(...)`` / ``f(...)`` all link to every
  analyzed function or method named ``f``.

That open-world rule over-approximates (recall over precision — a
missed hot function is a missed hazard, a spurious edge at worst asks
for one justified ignore), and it is robust to the repo's style of
passing callables around (builders, samplers, sync hooks).

Hot set = everything reachable from the serving roots: ``_tick``
(both decode servers), ``generate`` / ``speculative_generate`` (model
decode loops), ``stream`` / ``throughput`` / ``_stream_loop`` (the
pipeline step loops; ``run_defer`` itself is construction, its loop
half is the root). The port adds three roots that no name-resolved
call reaches:

- ``_follow``: a follower rank's serving loop under ``mesh=``; it
  dispatches each program by ``getattr(self, name)(...)``, so nothing
  links it, and it runs once a controller dispatch;
- ``Pipeline.__call__`` and ``Stage.forward`` (parallel/pipeline.py):
  the DEFER stage loop, one call a microbatch, entered as ``self(x)``
  and ``stage(x)``, which name no function.

A dotted root (``Class.method``) names one class's method, so adding
the stage loop does not mark every ``__call__`` / ``forward`` hot.
``_tick_window`` and ``_tick_pp`` need no root of their own: ``_tick``
calls both by name.
"""

from __future__ import annotations

import ast
import dataclasses

DEFAULT_ROOTS = (
    "_tick",
    "generate",
    "speculative_generate",
    "stream",
    "throughput",
    "_stream_loop",
    "_follow",
    "Pipeline.__call__",
    "Stage.forward",
)

# Attribute calls to these names resolve to dict/queue/socket methods
# far more often than to repo functions; linking them would mark the
# whole codebase hot through e.g. `input_stream.get()` →
# `KerasWeights.get`. Bare-name calls still resolve normally.
_GENERIC_ATTRS = frozenset(
    "get put set add pop update append extend clear copy close items "
    "keys values read write flush start run acquire release encode "
    "decode strip format sort index count insert remove".split()
)

# Libraries: an attribute call through a name a module binds by
# importing one (`torch.cuda.stream(side)`, `F.gelu(x)`, `dist.
# all_reduce(t)`) runs library code, never a function of the analyzed
# corpus, so it links nothing; without this `torch.cuda.stream` would
# link every repo method named `stream`.
_LIBRARIES = frozenset(
    "torch numpy math os sys time threading socket json pickle hashlib "
    "collections functools itertools dataclasses typing contextlib queue "
    "struct zlib subprocess re random warnings jax einops scipy".split()
)


def library_aliases(tree: ast.AST) -> frozenset[str]:
    """Names a module binds to a library module or its members."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] in _LIBRARIES:
                    out.add(a.asname or a.name.split(".")[0])
        elif (isinstance(node, ast.ImportFrom) and not node.level
              and (node.module or "").split(".")[0] in _LIBRARIES):
            out.update(a.asname or a.name for a in node.names)
    return frozenset(out)


def _receiver_root(node: ast.AST) -> str | None:
    """`torch` for `torch.cuda.stream`: the Name an attribute chain
    starts from."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


@dataclasses.dataclass
class FuncInfo:
    name: str  # bare name ("_tick")
    qualname: str  # "runtime/paged.py:PagedDecodeServer._tick"
    path: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    # Bare `f(...)` calls are lexically scoped: they resolve within the
    # same module, plus corpus-wide for names this module from-imports.
    # `obj.f(...)` attribute calls resolve corpus-wide (methods cross
    # modules through dispatch), minus _GENERIC_ATTRS.
    calls_bare: set[str] = dataclasses.field(default_factory=set)
    calls_attr: set[str] = dataclasses.field(default_factory=set)
    # Enclosing FUNCTION name chain at the def site, outermost first;
    # () for module-level functions and class methods. A nested def is
    # only bare-callable where it is lexically visible, and is never a
    # valid `obj.name(...)` target — both resolutions use this.
    scope: tuple[str, ...] = ()
    # Innermost enclosing CLASS at the def site (None for plain
    # functions). `self.x` writes in a method mutate an instance of
    # this class — the race detector keys shared state on it.
    owner_class: str | None = None

    @property
    def in_function(self) -> bool:
        return bool(self.scope)


@dataclasses.dataclass(frozen=True)
class ThreadSite:
    """One ``threading.Thread(target=...)`` spawn: a thread edge. The
    target function runs on a NEW thread, so the hot set must not flow
    through it, but the mutation-domain pass (domains.py) roots a
    thread domain at every resolvable target."""

    path: str
    line: int
    target_bare: str | None  # Thread(target=feed)
    target_attr: str | None  # Thread(target=self._drain_loop)
    thread_name: str | None  # the name= kwarg, when a string literal
    in_func: str | None  # bare name of the spawning function


def _thread_target(call: ast.Call) -> tuple[str | None, str | None] | None:
    """(bare, attr) target names of a threading.Thread(...) call, or
    None if this call is not a Thread construction / has no target."""
    f = call.func
    name = (
        f.id if isinstance(f, ast.Name)
        else f.attr if isinstance(f, ast.Attribute)
        else None
    )
    if name != "Thread":
        return None
    tgt = next(
        (k.value for k in call.keywords if k.arg == "target"), None
    )
    if isinstance(tgt, ast.Name):
        return tgt.id, None
    if isinstance(tgt, ast.Attribute):
        return None, tgt.attr
    return None


class _Collector(ast.NodeVisitor):
    def __init__(
        self,
        path: str,
        out: list[FuncInfo],
        threads: list[ThreadSite] | None = None,
        libraries: frozenset[str] = frozenset(),
    ):
        self.path = path
        self.out = out
        self.libraries = libraries
        self.threads = threads if threads is not None else []
        self.stack: list[str] = []  # class/function name chain
        self.kinds: list[str] = []  # "class" | "func", parallel to stack

    def _visit_func(self, node: ast.AST) -> None:
        qual = ".".join([*self.stack, node.name])
        classes = [
            n for n, k in zip(self.stack, self.kinds) if k == "class"
        ]
        info = FuncInfo(
            name=node.name,
            qualname=f"{self.path}:{qual}",
            path=self.path,
            node=node,
            scope=tuple(
                n
                for n, k in zip(self.stack, self.kinds)
                if k == "func"
            ),
            owner_class=classes[-1] if classes else None,
        )
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                f = sub.func
                if isinstance(f, ast.Name):
                    info.calls_bare.add(f.id)
                elif (
                    isinstance(f, ast.Attribute)
                    and f.attr not in _GENERIC_ATTRS
                    and _receiver_root(f.value) not in self.libraries
                ):
                    info.calls_attr.add(f.attr)
                # shard_map(body, mesh, ...) runs `body` per tick just
                # as surely as body() would: link the wrapped function
                # so the hot set flows THROUGH the wrapper. The port has
                # no shard_map; the edge keeps the hot set equal to the
                # reference pass's on the same corpus. Generic
                # function-valued arguments (scan bodies, a captured
                # window's body) must NOT create edges.
                callee = (
                    f.id if isinstance(f, ast.Name)
                    else f.attr if isinstance(f, ast.Attribute)
                    else None
                )
                if callee == "shard_map":
                    tgt = sub.args[0] if sub.args else next(
                        (k.value for k in sub.keywords if k.arg == "f"),
                        None,
                    )
                    if isinstance(tgt, ast.Name):
                        info.calls_bare.add(tgt.id)
                    elif (
                        isinstance(tgt, ast.Attribute)
                        and tgt.attr not in _GENERIC_ATTRS
                    ):
                        info.calls_attr.add(tgt.attr)
        self.out.append(info)
        self.stack.append(node.name)
        self.kinds.append("func")
        self.generic_visit(node)
        self.stack.pop()
        self.kinds.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_func(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_func(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.kinds.append("class")
        self.generic_visit(node)
        self.stack.pop()
        self.kinds.pop()

    def visit_Call(self, node: ast.Call) -> None:
        tgt = _thread_target(node)
        if tgt is not None:
            name_kw = next(
                (k.value for k in node.keywords if k.arg == "name"),
                None,
            )
            funcs = [
                n for n, k in zip(self.stack, self.kinds) if k == "func"
            ]
            self.threads.append(
                ThreadSite(
                    path=self.path,
                    line=node.lineno,
                    target_bare=tgt[0],
                    target_attr=tgt[1],
                    thread_name=(
                        name_kw.value
                        if isinstance(name_kw, ast.Constant)
                        and isinstance(name_kw.value, str)
                        else None
                    ),
                    in_func=funcs[-1] if funcs else None,
                )
            )
        self.generic_visit(node)


class CallGraph:
    """Functions of the analyzed file set + name-resolved call edges."""

    def __init__(self) -> None:
        self.functions: list[FuncInfo] = []
        self.by_name: dict[str, list[FuncInfo]] = {}
        self.imports: dict[str, set[str]] = {}  # path -> imported names
        self.libraries: dict[str, frozenset[str]] = {}  # path -> aliases
        self.thread_sites: list[ThreadSite] = []

    def add_module(self, path: str, tree: ast.AST) -> None:
        found: list[FuncInfo] = []
        libs = library_aliases(tree)
        self.libraries[path] = libs
        _Collector(path, found, self.thread_sites, libs).visit(tree)
        self.functions.extend(found)
        for fi in found:
            self.by_name.setdefault(fi.name, []).append(fi)
        names = self.imports.setdefault(path, set())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                names.update(a.asname or a.name for a in node.names)
        names -= libs

    def _resolve(self, fi: FuncInfo, callee: str, bare: bool):
        cands = self.by_name.get(callee, [])
        if bare:
            chain = (*fi.scope, fi.name)
            out = [
                c
                for c in cands
                if c.path == fi.path
                and c.scope == chain[: len(c.scope)]
            ]
            if callee in self.imports.get(fi.path, ()):
                out += [
                    c
                    for c in cands
                    if c.path != fi.path and not c.in_function
                ]
            return out
        return [c for c in cands if not c.in_function]

    def resolve_call(
        self, fi: FuncInfo | None, callee: str, bare: bool
    ) -> list[FuncInfo]:
        """Public name resolution for passes that walk call sites
        themselves (lock-discipline helper lookup, domain propagation).
        `fi` scopes bare-call resolution; None means module-level
        resolution is impossible, so only corpus-wide attr resolution
        applies. Generic attr names (get/put/start/...) resolve to
        nothing, same as edge collection."""
        if not bare and callee in _GENERIC_ATTRS:
            return []
        if fi is None:
            if bare:
                return []
            return [
                c
                for c in self.by_name.get(callee, [])
                if not c.in_function
            ]
        return self._resolve(fi, callee, bare)

    def resolve_thread_target(self, site: ThreadSite) -> list[FuncInfo]:
        """FuncInfos a Thread(target=...) site may start. Bare targets
        resolve within the spawning module (plus from-imports, e.g.
        Thread(target=serve_prefill)); attr targets corpus-wide."""
        if site.target_bare is not None:
            cands = self.by_name.get(site.target_bare, [])
            out = [c for c in cands if c.path == site.path]
            if site.target_bare in self.imports.get(site.path, ()):
                out += [
                    c
                    for c in cands
                    if c.path != site.path and not c.in_function
                ]
            return out
        if site.target_attr is not None:
            cands = [
                c
                for c in self.by_name.get(site.target_attr, [])
                if not c.in_function
            ]
            # `Thread(target=self._drain_loop)` names a method of the
            # spawning class — prefer same-module candidates and only
            # fall back corpus-wide when the module defines none, so a
            # common method name (`_loop`) doesn't seed a thread
            # domain on every unrelated class that uses it.
            local = [c for c in cands if c.path == site.path]
            return local or cands
        return []

    def root_functions(self, root: str) -> list[FuncInfo]:
        """The functions a root names: every function of that bare
        name, or for a dotted ``Class.method`` root that class's
        method only."""
        if "." not in root:
            return list(self.by_name.get(root, []))
        cls, name = root.rsplit(".", 1)
        return [fi for fi in self.by_name.get(name, [])
                if fi.owner_class == cls and not fi.in_function]

    def hot_set(self, roots: tuple[str, ...] = DEFAULT_ROOTS) -> set[int]:
        """ids of FuncInfo.node for every function reachable by name
        from any root. Nested defs are separate nodes: a closure is hot
        only if something hot calls it by name."""
        seen: set[int] = set()
        frontier = [fi for r in roots for fi in self.root_functions(r)]
        while frontier:
            fi = frontier.pop()
            if id(fi.node) in seen:
                continue
            seen.add(id(fi.node))
            for bare, calls in (
                (True, fi.calls_bare),
                (False, fi.calls_attr),
            ):
                for callee in calls:
                    frontier.extend(
                        c
                        for c in self._resolve(fi, callee, bare)
                        if id(c.node) not in seen
                    )
        return seen
