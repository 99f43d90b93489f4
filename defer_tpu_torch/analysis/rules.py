"""The five static rules, with torch meanings. Each is a pure function
over the parsed corpus; adding a rule = one function + one RULES entry.

- ``host-sync-in-hot-loop``: a call that waits for the card on a hot
  path: the reference's host transfers (``np.asarray`` / ``np.array`` /
  ``device_get``), ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.to("cpu")``, any ``.synchronize()`` (device, event,
  stream), and ``int()`` / ``float()`` / ``bool()`` of a tensor
  expression.
- ``capture-in-hot-path`` (the reference's ``fresh-closure-jit``): a
  CUDA graph capture (``torch.cuda.graph``, ``capture_begin``,
  ``capture_graph``, ``make_graphed_callables``) or ``torch.compile``
  reached from a hot root outside a memo keyed on the server; and
  ``torch.compile(f)(...)``, whose compiled callable dies at once.
- ``implicit-randomness`` (the reference's ``prng-key-reuse``): a
  sampling call on a hot path that draws from the global generator (no
  ``generator=``), or ``manual_seed`` with the same value inside a loop.
- ``lock-discipline`` and ``obs-name-drift``: the reference's rules,
  unchanged.

Design bias: these guard a serving codebase, so rules prefer recall on
the hot paths and keep cold paths quiet — `.tolist()` is only a
finding where it runs per decode tick, a capture is only a finding
where it runs per call. Anything intentional gets an inline
``# analysis: ignore[rule] reason`` (ignore.py) instead of a rule
carve-out, so the justification lives next to the hazard.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import re
from typing import Callable, Iterator

from defer_tpu_torch.analysis.callgraph import (
    DEFAULT_ROOTS,
    CallGraph,
    FuncInfo,
    _receiver_root,
)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.rule}: {self.message}"
        )


@dataclasses.dataclass
class Module:
    path: str
    source: str
    tree: ast.AST

    @functools.cached_property
    def nodes(self) -> list[ast.AST]:
        """Every node of the module, walked once for the rules that read
        a whole module."""
        return list(ast.walk(self.tree))


@dataclasses.dataclass
class Context:
    modules: list[Module]
    graph: CallGraph
    roots: tuple[str, ...] = DEFAULT_ROOTS

    def hot(self) -> set[int]:
        """ids of the functions that run on every tick or step: the hot
        set walked without crossing a call inside a memo guard (what
        runs once a key, a capture and its warm-up, is not per tick)."""
        return self._hot

    @functools.cached_property
    def _hot(self) -> set[int]:
        return _unguarded_hot(self)

    @functools.cached_property
    def host_funcs(self) -> frozenset[str]:
        """Bare names of corpus functions whose every `return` gives host
        data (a list they build, a host transfer): a value such a call
        returns is not read from the card again."""
        return frozenset(fi.name for fi in self.graph.functions
                         if _returns_host(fi.node))

    @functools.cached_property
    def tensor_attrs(self) -> dict[str, frozenset[str]]:
        """By module path, the attribute names it assigns a torch tensor
        to (``self.x = torch.zeros(...)``, ``... .to(dev)``,
        ``... .clone()``): subscripting one reads the card."""
        return {m.path: frozenset(_tensor_attr_names(m))
                for m in self.modules}


def _dotted(node: ast.AST) -> str | None:
    """'torch.cuda.synchronize' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


# id(node) -> (node, its shallow walk): every rule walks the same
# function bodies, so each walk is made once a run (runner.py clears it;
# the node kept beside its walk stops a reused id from matching).
_SHALLOW: dict[int, tuple[ast.AST, list[ast.AST]]] = {}


def _walk_shallow(node: ast.AST) -> Iterator[ast.AST]:
    """Document-order walk of one function's own body: nested defs and
    lambdas are separate analysis units (the call graph decides if
    *they* are hot), so their bodies are not yielded here."""
    hit = _SHALLOW.get(id(node))
    if hit is None or hit[0] is not node:
        out: list[ast.AST] = []
        stack = list(ast.iter_child_nodes(node))[::-1]
        while stack:
            child = stack.pop()
            if isinstance(child, _FUNC_NODES):
                continue
            out.append(child)
            stack.extend(list(ast.iter_child_nodes(child))[::-1])
        hit = _SHALLOW[id(node)] = (node, out)
    return iter(hit[1])


def _root_name(node: ast.AST) -> str | None:
    """Base Name of a Name/Subscript chain: `host[i]` -> 'host'."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


# -- host-sync-in-hot-loop --------------------------------------------

_NP_MODULES = {"np", "numpy", "onp"}
# Method calls that copy a tensor to the host or wait for the card.
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# Producers of tensors: a call of torch.<f>, or a method that returns a
# tensor of the same device; int()/float()/bool() of one reads the card.
_TENSOR_METHODS = {
    "sum", "max", "min", "amax", "amin", "argmax", "argmin", "any",
    "all", "mean", "prod", "count_nonzero", "norm", "abs", "eq", "ne",
    "gt", "lt", "ge", "le", "equal", "isfinite", "float", "long",
    "int", "clone", "contiguous",
}
# Calls whose result is host data: names bound from them are not read
# back from the card again.
_HOST_RESULT_ATTRS = {"tolist", "cpu", "numpy", "item"}


def _tensor_attr_names(mod: Module) -> set[str]:
    out: set[str] = set()
    for node in mod.nodes:
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        if value is None or not _tensor_producer(value):
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [
            node.target]
        for tgt in targets:
            if (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                out.add(tgt.attr)
    return out


def _tensor_producer(value: ast.AST) -> bool:
    """A torch.<f>(...) call, or a .to(<device>) / .clone() of one:
    the value is a tensor."""
    if not isinstance(value, ast.Call):
        return False
    dotted = _dotted(value.func) or ""
    if dotted.startswith("torch.") and not dotted.startswith(
            ("torch.device", "torch.Generator", "torch.cuda.Stream",
             "torch.cuda.Event", "torch.dtype")):
        return True
    f = value.func
    return (isinstance(f, ast.Attribute) and f.attr in ("to", "clone")
            and _tensor_producer(f.value))


def _host_transfer_call(call: ast.Call) -> str | None:
    """Name the host transfer if this call is one, else None."""
    f = call.func
    dotted = _dotted(f)
    if dotted in ("jax.device_get", "device_get"):
        return dotted
    if (
        isinstance(f, ast.Attribute)
        and isinstance(f.value, ast.Name)
        and f.value.id in _NP_MODULES
        and f.attr in ("asarray", "array")
    ):
        return f"{f.value.id}.{f.attr}"
    return None


def _is_cpu(node: ast.AST) -> bool:
    """'cpu', torch.device('cpu'), device='cpu' forms."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and _dotted(node.func) in (
            "torch.device", "device"):
        return bool(node.args) and _is_cpu(node.args[0])
    return False


def _torch_sync_call(call: ast.Call) -> str | None:
    """Name the torch sync if this call is one, else None. A call on the
    result of a sync (`t.cpu().numpy()`) waits for nothing more: the
    inner call is the finding."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if isinstance(f.value, ast.Call) and (
            _torch_sync_call(f.value) or _host_transfer_call(f.value)):
        return None
    if f.attr in _SYNC_ATTRS:
        return f".{f.attr}()"
    if f.attr == "to":
        dev = [a for a in call.args[:1]] + [
            k.value for k in call.keywords if k.arg == "device"]
        if any(_is_cpu(d) for d in dev):
            return '.to("cpu")'
    return None


def _host_exprs(value: ast.AST) -> Iterator[ast.AST]:
    """Unwrap conditional assigns: `np.asarray(x) if c else None`."""
    if isinstance(value, ast.IfExp):
        yield from _host_exprs(value.body)
        yield from _host_exprs(value.orelse)
    else:
        yield value


def _host_value(value: ast.AST, host_names: set[str] | frozenset = frozenset(),
                host_funcs: frozenset[str] = frozenset()) -> bool:
    """A value that is host data: a host transfer, a torch sync's
    result (.tolist(), .cpu(), ...), a numpy call, a list, a name or
    subscript of one already known to be host data (`host_names`), a
    call of a corpus function that returns host data (`host_funcs`), or
    iter / next / list of host data."""
    for v in _host_exprs(value):
        if isinstance(v, ast.ListComp):
            return True
        if isinstance(v, (ast.List, ast.Tuple)) and all(
                isinstance(e, ast.Constant)
                or _host_value(e, host_names, host_funcs) for e in v.elts):
            return True  # [], (0, 1), [host, host]; not (tensor, tensor)
        if isinstance(v, (ast.Name, ast.Subscript)) and (
                _root_name(v) in host_names):
            return True
        if isinstance(v, ast.Call) and (
                (isinstance(v.func, ast.Name) and (
                    v.func.id in host_funcs
                    or (v.func.id in ("iter", "next", "list", "tuple")
                        and v.args and _host_value(v.args[0], host_names,
                                                   host_funcs))))
                or (isinstance(v.func, ast.Attribute)
                    and isinstance(v.func.value, ast.Name)
                    and v.func.value.id == "self"
                    and v.func.attr in host_funcs)):
            return True
        if (isinstance(v, ast.BinOp) and isinstance(v.op, ast.Mult)
                and isinstance(v.left, ast.List)):
            return True  # [0] * n
        if not isinstance(v, ast.Call):
            continue
        if _host_transfer_call(v):
            return True
        f = v.func
        if isinstance(f, ast.Attribute) and f.attr in _HOST_RESULT_ATTRS:
            return True
        if _call_chain_root(f) in _NP_MODULES:
            return True  # np.where(...), np.zeros(...).astype(...)
        if isinstance(f, ast.Name) and f.id in ("range", "len"):
            return True
    return False


def _call_chain_root(node: ast.AST) -> str | None:
    """`np` for `np.where(a, b, c).astype`: the Name a chain of
    attributes, calls and subscripts starts from."""
    while isinstance(node, (ast.Attribute, ast.Call, ast.Subscript)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _target_names(targets: list) -> set[str]:
    """Names an assignment binds, tuple targets and starred ones
    included."""
    out: set[str] = set()
    for tgt in targets:
        elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [tgt]
        for e in elts:
            if isinstance(e, ast.Starred):
                e = e.value
            name = _root_name(e)
            if name:
                out.add(name)
    return out


def _returns_host(fn_node: ast.AST) -> bool:
    names: set[str] = set()
    returns = []
    for node in _walk_shallow(fn_node):
        if isinstance(node, ast.Assign) and _host_value(node.value, names):
            names.update(_target_names(node.targets))
        elif isinstance(node, ast.Return):
            returns.append(node.value)
    return bool(returns) and all(
        r is not None and _host_value(r, names) for r in returns)


def _self_attr_root(node: ast.AST) -> str | None:
    """`self.x[i]` -> 'x' (the attribute a subscript chain reads)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _tensor_expr(arg: ast.AST, host_names: set[str],
                 tensor_attrs: frozenset[str]) -> bool:
    """A statically evident tensor value: a subscript of a name not
    known to hold host data (the reference's form) or of a tensor
    attribute of self; a torch.<f>(...) call; a tensor method
    (.sum(), .argmax(), ...) of a non-host name or a tensor attribute."""
    if isinstance(arg, ast.Subscript):
        name = _root_name(arg)
        if name is not None:
            return name not in host_names
        return _self_attr_root(arg) in tensor_attrs
    if isinstance(arg, ast.Call):
        if _tensor_producer(arg):
            return True
        f = arg.func
        if isinstance(f, ast.Attribute) and f.attr in _TENSOR_METHODS:
            base = f.value
            if isinstance(base, ast.Name):
                return base.id not in host_names and base.id != "np"
            return _tensor_expr(base, host_names, tensor_attrs) or (
                _self_attr_root(base) in tensor_attrs)
    return False


def rule_host_sync(ctx: Context) -> list[Finding]:
    out: list[Finding] = []
    hot = ctx.hot()
    for fi in ctx.graph.functions:
        if id(fi.node) not in hot:
            continue
        tensor_attrs = ctx.tensor_attrs.get(fi.path, frozenset())
        # Names assigned from an (already flagged) host transfer are
        # host data: `int(host_nxt[i])` after `host_nxt = x.tolist()`
        # costs nothing extra and is not re-flagged.
        host_names: set[str] = set()
        host_funcs = ctx.host_funcs
        for node in _walk_shallow(fi.node):
            if isinstance(node, ast.Assign) and _host_value(
                    node.value, host_names, host_funcs):
                host_names |= _target_names(node.targets)
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            what = _host_transfer_call(node) or _torch_sync_call(node)
            if what is not None and what.startswith(("np.", "numpy.")) and (
                    node.args and _host_value(node.args[0], host_names,
                                              host_funcs)):
                # np.asarray(t.tolist()) syncs in the inner call, and
                # np.asarray(host[r]) not at all.
                what = None

            if what is None and isinstance(f, ast.Name):
                if (f.id in ("int", "float", "bool") and len(node.args) == 1
                        and _tensor_expr(node.args[0], host_names,
                                         tensor_attrs)):
                    what = f"{f.id}() of a tensor expression"
            if what is not None:
                out.append(
                    Finding(
                        "host-sync-in-hot-loop",
                        fi.path,
                        node.lineno,
                        node.col_offset,
                        f"{what} in `{fi.qualname.split(':', 1)[1]}`, "
                        f"which is reachable from serving roots "
                        f"{ctx.roots} — the host waits for the card once "
                        "a tick/step; fold it into the tick's one "
                        "batched transfer or justify with an ignore",
                    )
                )
    return out


# -- capture-in-hot-path ------------------------------------------------

_CAPTURE_DOTTED = {
    "torch.cuda.graph": "torch.cuda.graph",
    "torch.cuda.make_graphed_callables": "make_graphed_callables",
    "torch.compile": "torch.compile",
}
_CAPTURE_BARE = {"capture_graph", "make_graphed_callables"}


def _capture_call(call: ast.Call) -> str | None:
    f = call.func
    dotted = _dotted(f)
    if dotted in _CAPTURE_DOTTED:
        return _CAPTURE_DOTTED[dotted]
    if isinstance(f, ast.Name) and f.id in _CAPTURE_BARE:
        return f.id
    if isinstance(f, ast.Attribute) and f.attr == "capture_begin":
        return ".capture_begin()"
    return None


def _memo_guard(node: ast.If) -> bool:
    """`if key not in self.graphs: ... self.graphs[key] = ...` and the
    `g = self.graphs.get(key); if g is None: ...` form: a branch taken
    once a key, which fills a dict the server holds."""
    test = node.test
    guard = (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], (ast.NotIn, ast.Is))
    ) or (isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not))
    if not guard:
        return False
    for sub in ast.walk(node):
        for tgt in getattr(sub, "targets", []):
            if (isinstance(tgt, ast.Subscript)
                    and _self_attr_root(tgt) is not None):
                return True
    return False


def _guarded_calls(fn_node: ast.AST) -> set[int]:
    """ids of the Call nodes of a function (nested defs included, as the
    call graph's edges include them) that sit inside a memo guard."""
    out: set[int] = set()
    for node in ast.walk(fn_node):
        if isinstance(node, ast.If) and _memo_guard(node):
            for stmt in node.body:
                out.update(id(sub) for sub in ast.walk(stmt)
                           if isinstance(sub, ast.Call))
    return out


def _unguarded_hot(ctx: Context) -> set[int]:
    """The hot set, walked without crossing a call that sits in a memo
    guard (`Context.hot`)."""
    graph = ctx.graph
    seen: set[int] = set()
    frontier = [fi for r in ctx.roots for fi in graph.root_functions(r)]
    while frontier:
        fi = frontier.pop()
        if id(fi.node) in seen:
            continue
        seen.add(id(fi.node))
        guarded = _guarded_calls(fi.node)
        libs = graph.libraries.get(fi.path, frozenset())
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call) or id(node) in guarded:
                continue
            f = node.func
            bare = isinstance(f, ast.Name)
            if bare:
                name = f.id
            elif (isinstance(f, ast.Attribute)
                  and _receiver_root(f.value) not in libs):
                name = f.attr
            else:
                continue
            frontier.extend(
                c for c in graph.resolve_call(fi, name, bare)
                if id(c.node) not in seen)
    return seen


def rule_capture_in_hot_path(ctx: Context) -> list[Finding]:
    out: list[Finding] = []
    live = ctx.hot()
    for fi in ctx.graph.functions:
        in_live = id(fi.node) in live
        guarded = _guarded_calls(fi.node) if in_live else set()
        for node in _walk_shallow(fi.node):
            if not isinstance(node, ast.Call):
                continue
            # torch.compile(f)(x): the compiled callable dies after one
            # call, so its cache never hits, wherever it sits.
            if (isinstance(node.func, ast.Call)
                    and _capture_call(node.func) == "torch.compile"):
                out.append(Finding(
                    "capture-in-hot-path", fi.path, node.lineno,
                    node.col_offset,
                    "torch.compile(f)(...) discards the compiled callable "
                    "after one call, so it compiles every time — bind it "
                    "once (module level or a memo on the server)",
                ))
                continue
            what = _capture_call(node)
            if what is None or not in_live or id(node) in guarded:
                continue
            out.append(Finding(
                "capture-in-hot-path", fi.path, node.lineno,
                node.col_offset,
                f"{what} in `{fi.qualname.split(':', 1)[1]}`, which a "
                f"serving root {ctx.roots} reaches outside a memo keyed "
                "on the server — it captures or compiles again on every "
                "call; capture once a key (`if key not in self._graphs: "
                "self._graphs[key] = ...`) and replay",
            ))
    return out


# -- implicit-randomness -----------------------------------------------

_RANDOM_FUNCS = {
    "rand", "rand_like", "randn", "randn_like", "randint",
    "randint_like", "randperm", "multinomial", "bernoulli", "normal",
    "poisson",
}
_RANDOM_METHODS = {
    "multinomial", "bernoulli", "bernoulli_", "normal_", "uniform_",
    "exponential_", "random_", "geometric_", "cauchy_", "log_normal_",
}


def _random_call(call: ast.Call) -> str | None:
    f = call.func
    dotted = _dotted(f) or ""
    parts = dotted.split(".")
    if len(parts) == 2 and parts[0] == "torch" and parts[1] in _RANDOM_FUNCS:
        return dotted
    if isinstance(f, ast.Attribute) and f.attr in _RANDOM_METHODS and not (
            dotted.startswith(("np.", "numpy.", "random.", "rng."))):
        return f".{f.attr}()"
    return None


def _loop_bound_names(loop: ast.AST) -> set[str]:
    """Names a loop rebinds each iteration: its targets and every name
    assigned in its body."""
    out: set[str] = set()
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        out |= {n.id for n in ast.walk(loop.target)
                if isinstance(n, ast.Name)}
    for sub in ast.walk(loop):
        if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            tgts = (sub.targets if isinstance(sub, ast.Assign)
                    else [sub.target])
            for t in tgts:
                out |= {n.id for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(sub, (ast.For, ast.comprehension)):
            out |= {n.id for n in ast.walk(sub.target)
                    if isinstance(n, ast.Name)}
    return out


def _loop_invariant(expr: ast.AST, bound: set[str]) -> bool:
    names = {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}
    return not (names & bound) and not any(
        isinstance(n, ast.Call) for n in ast.walk(expr))


def rule_implicit_randomness(ctx: Context) -> list[Finding]:
    out: list[Finding] = []
    hot = ctx.hot()
    for fi in ctx.graph.functions:
        if id(fi.node) in hot:
            for node in _walk_shallow(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                what = _random_call(node)
                if what is None or any(k.arg == "generator"
                                       for k in node.keywords):
                    continue
                out.append(Finding(
                    "implicit-randomness", fi.path, node.lineno,
                    node.col_offset,
                    f"{what} without generator= in "
                    f"`{fi.qualname.split(':', 1)[1]}`, which is reachable "
                    "from serving roots: it draws from the process's global "
                    "generator, so a request's draws depend on every other "
                    "request's — pass the slot's own torch.Generator",
                ))
        for loop in _walk_shallow(fi.node):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            bound = _loop_bound_names(loop)
            for node in _walk_shallow(loop):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "manual_seed"
                        and node.args):
                    continue
                if _loop_invariant(node.args[0], bound):
                    out.append(Finding(
                        "implicit-randomness", fi.path, node.lineno,
                        node.col_offset,
                        "manual_seed with the same value on every pass of "
                        "a loop: each pass replays the same draws — seed "
                        "once outside the loop, or seed with what the "
                        "pass changes",
                    ))
    # A loop nested in a loop is walked once a level: keep one finding a
    # site.
    return list(dict.fromkeys(out))


# -- lock-discipline --------------------------------------------------

_BLOCKING = {
    "join",
    "accept",
    "recv",
    "recv_into",
    "recvfrom",
    "sendall",
    "connect",
    "create_connection",
    "predict",
    "sleep",
}


def _mentions_lock(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return "lock" in node.id.lower()
    if isinstance(node, ast.Attribute):
        return "lock" in node.attr.lower()
    if isinstance(node, ast.Call):  # e.g. `with lock_for(x):`
        return _mentions_lock(node.func)
    return False


def _first_blocking_call(fn_node: ast.AST) -> tuple[str, int] | None:
    """(name, line) of the first blocking call in a function's own
    body (nested defs excluded), else None."""
    for sub in _walk_shallow(fn_node):
        if not isinstance(sub, ast.Call):
            continue
        f = sub.func
        name = (
            f.attr
            if isinstance(f, ast.Attribute)
            else f.id
            if isinstance(f, ast.Name)
            else None
        )
        if name in _BLOCKING:
            return name, sub.lineno
    return None


def _lock_body_calls(
    node: ast.With | ast.AsyncWith,
) -> Iterator[ast.Call]:
    for stmt in node.body:
        for sub in [stmt, *_walk_shallow(stmt)]:
            if isinstance(sub, ast.Call):
                yield sub


def rule_lock_discipline(ctx: Context) -> list[Finding]:
    out: list[Finding] = []

    def check_with(node: ast.AST, fi: FuncInfo | None, path: str) -> None:
        if not any(
            _mentions_lock(item.context_expr) for item in node.items
        ):
            return
        for sub in _lock_body_calls(node):
            f = sub.func
            bare = isinstance(f, ast.Name)
            name = (
                f.attr
                if isinstance(f, ast.Attribute)
                else f.id
                if bare
                else None
            )
            if name is None:
                continue
            if name in _BLOCKING:
                out.append(
                    Finding(
                        "lock-discipline",
                        path,
                        sub.lineno,
                        sub.col_offset,
                        f"blocking call .{name}() while holding "
                        "a lock — every other thread touching "
                        "this lock stalls behind the I/O; move "
                        "the wait outside the critical section",
                    )
                )
                continue
            # One level through the callgraph: a helper whose own body
            # blocks is the same stall, just hidden behind a call. Any
            # name-resolved candidate blocking is a finding (open-world
            # recall bias, same as the hot set); a call through a
            # library module reaches no helper of the corpus.
            if not bare and _receiver_root(f.value) in (
                    ctx.graph.libraries.get(path, frozenset())):
                continue
            for cand in ctx.graph.resolve_call(fi, name, bare):
                hit = _first_blocking_call(cand.node)
                if hit is not None:
                    out.append(
                        Finding(
                            "lock-discipline",
                            path,
                            sub.lineno,
                            sub.col_offset,
                            f"`{name}()` called under a lock blocks "
                            f"inside (.{hit[0]}() at "
                            f"{cand.path}:{hit[1]}) — the critical "
                            "section stalls behind that I/O exactly "
                            "as if it were inline; move the call "
                            "outside the lock",
                        )
                    )
                    break

    # With blocks inside functions: resolved with lexical scope so
    # bare helper calls link right. Module-level withs (no enclosing
    # function) still get direct + attr-helper checks.
    seen: set[int] = set()
    for fi in ctx.graph.functions:
        for node in _walk_shallow(fi.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                seen.add(id(node))
                check_with(node, fi, fi.path)
    for mod in ctx.modules:
        for node in mod.nodes:
            if (
                isinstance(node, (ast.With, ast.AsyncWith))
                and id(node) not in seen
            ):
                check_with(node, None, mod.path)
    return out


# -- obs-name-drift ---------------------------------------------------

_OBS_KINDS = {"counter", "gauge", "histogram"}
_NAME_RE = re.compile(r"^defer_[a-z0-9_]+$")


def rule_obs_name_drift(ctx: Context) -> list[Finding]:
    out: list[Finding] = []
    first_kind: dict[str, tuple[str, str, int]] = {}  # name -> kind,at
    for mod in ctx.modules:
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (
                isinstance(f, ast.Attribute) and f.attr in _OBS_KINDS
            ):
                continue
            if not node.args or not (
                isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                continue  # dynamic names can't be checked statically
            name = node.args[0].value
            kind = f.attr
            loc = (mod.path, node.lineno, node.col_offset)
            if not _NAME_RE.match(name):
                out.append(
                    Finding(
                        "obs-name-drift",
                        *loc,
                        f"metric name {name!r} breaks the registry "
                        "convention ^defer_[a-z0-9_]+$ — dashboards "
                        "key on the defer_ prefix",
                    )
                )
            elif kind == "counter" and not name.endswith("_total"):
                out.append(
                    Finding(
                        "obs-name-drift",
                        *loc,
                        f"counter {name!r} must end in _total "
                        "(Prometheus counter convention)",
                    )
                )
            elif kind != "counter" and name.endswith("_total"):
                out.append(
                    Finding(
                        "obs-name-drift",
                        *loc,
                        f"{kind} {name!r} ends in _total, which marks "
                        "counters — rename or change the instrument",
                    )
                )
            seen = first_kind.setdefault(name, (kind, mod.path, node.lineno))
            if seen[0] != kind:
                out.append(
                    Finding(
                        "obs-name-drift",
                        *loc,
                        f"{name!r} registered as a {kind} here but as "
                        f"a {seen[0]} at {seen[1]}:{seen[2]} — one "
                        "name, one instrument kind",
                    )
                )
    return out


RULES: dict[str, Callable[[Context], list[Finding]]] = {
    "host-sync-in-hot-loop": rule_host_sync,
    "capture-in-hot-path": rule_capture_in_hot_path,
    "implicit-randomness": rule_implicit_randomness,
    "lock-discipline": rule_lock_discipline,
    "obs-name-drift": rule_obs_name_drift,
}
