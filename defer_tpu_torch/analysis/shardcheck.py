"""Pass 2 — collective and placement-spec consistency (`shard-spec`),
over the port's collectives.

The reference checks `shard_map` call sites. The port has none: its
sharded forwards call the collectives of parallel/collectives.py
(`psum`, `all_gather`, `all_to_all`, `ppermute`, `shard`, `unshard`,
`pvary`, `axis_size`, `axis_index`) with a mesh axis name, and its
placements are spec tuples, one mesh axis name (or None) a dim of a
leaf (`stack_specs`, a decoder's `_specs`). Three statically checkable
contracts:

1. **Axis names**: a string-literal axis passed to a collective, or to
   `stack_specs` / `_specs`, must exist on the mesh built nearby from
   literal axis names (`make_mesh({"model": 2}, ...)` in the same
   function). Axes passed as variables (`tp_axis`) and meshes built
   elsewhere are skipped; the fixtures pin the check.
2. **Arity**: a spec tuple names one axis a dim, so its length is the
   rank of the leaf it places. Each key of a spec function's dict
   literal (`"wq": (st, None, tp)` in a function whose name ends in
   `specs`) is compared with the shape tuple the same module's
   `init*` function draws that key with (`"wq": draw((L, D, D), s)`).
   Exclusive arms may give one key several ranks (a dense and an MoE
   `w1`): a spec is wrong when its length is none of them.
3. **psum mirror**: the host-side `defer_tp_psum_total` counter is
   driven by a mirror constant (`_psums_per_fwd = A * num_layers + B`
   in runtime/paged.py). The pass re-derives A and B from the port's
   own collective sites: A = branch-collapsed `psum` sites across the
   decoder's per-layer trio `_block` / `_attn_qkv` / `_attn_out`, B =
   the `psum` sites of `embed_lookup` (the embedding) plus the
   `all_gather` sites of `_final_logits` (the logits); and flags the
   mirror when the code moved out from under it. (Branch-collapsed:
   exclusive if/else arms count once, an early-`return` arm does not
   see later sites.)
"""

from __future__ import annotations

import ast

from defer_tpu_torch.analysis.callgraph import FuncInfo
from defer_tpu_torch.analysis.rules import (
    RULES,
    Context,
    Finding,
    _FUNC_NODES,
    _walk_shallow,
)

# parallel/collectives.py: the axis is the second positional argument
# (`axis=` as a keyword), or the first for axis_size / axis_index.
COLLECTIVES = {
    "psum": 1, "pvary": 1, "all_gather": 1, "all_to_all": 1,
    "ppermute": 1, "shard": 1, "unshard": 1, "axis_size": 0,
    "axis_index": 0,
}
# Spec builders whose arguments are axis names.
SPEC_BUILDERS = ("stack_specs", "_specs")

# The psum-mirror convention (check 3): the mirror attribute, the
# decoder class and its per-layer functions whose psum sites the A
# coefficient counts, and the per-forward functions for B.
MIRROR_ATTR = "_psums_per_fwd"
DECODER_CLASS = "GptDecoder"
PER_LAYER_FUNCS = ("_block", "_attn_qkv", "_attn_out")
CONST_PSUM_FUNC = "embed_lookup"
CONST_GATHER_FUNC = "_final_logits"


def _callee_name(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _kwarg(call: ast.Call, name: str) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _literal_axes(expr: ast.AST) -> frozenset[str] | None:
    """Axis names of `make_mesh({"a": 2, ...}, ...)`, when literal."""
    if not (isinstance(expr, ast.Call) and _callee_name(expr) == "make_mesh"
            and expr.args and isinstance(expr.args[0], ast.Dict)):
        return None
    keys = [k.value for k in expr.args[0].keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)]
    return frozenset(keys) if len(keys) == len(expr.args[0].keys) else None


def _mesh_axes(fi: FuncInfo) -> frozenset[str] | None:
    """The axes of every literal mesh the function builds, or None when
    it builds none."""
    found: set[str] | None = None
    for node in _walk_shallow(fi.node):
        if isinstance(node, ast.Call):
            axes = _literal_axes(node)
            if axes is not None:
                found = (found or set()) | axes
    return None if found is None else frozenset(found)


def _axis_literals(call: ast.Call) -> list[tuple[str, ast.AST]]:
    """String-literal axis names a collective or spec-builder call
    passes."""
    name = _callee_name(call)
    cands: list[ast.AST] = []
    if name in COLLECTIVES:
        pos = COLLECTIVES[name]
        if len(call.args) > pos:
            cands.append(call.args[pos])
        kw = _kwarg(call, "axis")
        if kw is not None:
            cands.append(kw)
    elif name in SPEC_BUILDERS:
        cands = list(call.args) + [k.value for k in call.keywords
                                   if k.arg and k.arg.endswith("axis")]
    return [(c.value, c) for c in cands
            if isinstance(c, ast.Constant) and isinstance(c.value, str)]


def _check_axes(ctx: Context) -> list[Finding]:
    out: list[Finding] = []
    for fi in ctx.graph.functions:
        axes = _mesh_axes(fi)
        if axes is None:
            continue
        for node in _walk_shallow(fi.node):
            if not isinstance(node, ast.Call):
                continue
            for axis, at in _axis_literals(node):
                if axis not in axes:
                    out.append(Finding(
                        "shard-spec", fi.path, at.lineno, at.col_offset,
                        f"`{_callee_name(node)}` names mesh axis {axis!r} "
                        f"but the mesh built here has only {sorted(axes)} "
                        "— a collective or a spec must name an axis of "
                        "the mesh it runs on",
                    ))
    return out


# -- arity (check 2) ----------------------------------------------------


def _dict_entries(fn_node: ast.AST):
    """(key, value node, at) of a function body's dict literals,
    `d[key] = value` stores and `d.update(key=value)` calls, for string
    keys."""
    for node in _walk_shallow(fn_node):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    yield k.value, v, k
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Subscript)
                        and isinstance(tgt.slice, ast.Constant)
                        and isinstance(tgt.slice.value, str)):
                    yield tgt.slice.value, node.value, tgt
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "update"):
            for kw in node.keywords:
                if kw.arg is not None:
                    yield kw.arg, kw.value, kw.value


def _spec_len(v: ast.AST) -> int | None:
    """Length of a spec tuple: a tuple of names, None and strings."""
    if not isinstance(v, ast.Tuple) or not v.elts:
        return None
    ok = all(isinstance(e, ast.Name)
             or (isinstance(e, ast.Constant)
                 and (e.value is None or isinstance(e.value, str)))
             for e in v.elts)
    return len(v.elts) if ok else None


def _shape_len(v: ast.AST) -> int | None:
    """Rank of a leaf an init draws: the tuple first argument of a call
    (`draw((L, D, D), s)`, `torch.zeros((L, D))`) or the second of
    `const(value, (L, D))`."""
    if not isinstance(v, ast.Call):
        return None
    for a in v.args[:2]:
        if isinstance(a, ast.Tuple) and a.elts and not any(
                isinstance(e, ast.Starred) for e in a.elts):
            return len(a.elts)
    return None


def _check_arity(ctx: Context) -> list[Finding]:
    out: list[Finding] = []
    for mod in ctx.modules:
        funcs = [fi for fi in ctx.graph.functions if fi.path == mod.path]
        ranks: dict[str, set[int]] = {}
        for fi in funcs:
            if fi.name.lstrip("_").startswith("init"):
                for key, v, _ in _dict_entries(fi.node):
                    n = _shape_len(v)
                    if n is not None:
                        ranks.setdefault(key, set()).add(n)
        if not ranks:
            continue
        for fi in funcs:
            if not fi.name.endswith("specs"):
                continue
            for key, v, at in _dict_entries(fi.node):
                n = _spec_len(v)
                if n is None or key not in ranks or n in ranks[key]:
                    continue
                want = "/".join(str(r) for r in sorted(ranks[key]))
                out.append(Finding(
                    "shard-spec", fi.path, at.lineno, at.col_offset,
                    f"spec of {key!r} names {n} dim(s) but the leaf it "
                    f"places has rank {want} (this module's init draws "
                    "it so) — one mesh axis or None a dim",
                ))
    return out


# -- psum mirror (check 3) --------------------------------------------


def _count_calls_pathmax(stmts: list[ast.stmt], attr: str) -> int:
    """Max number of `attr`-named calls along any single execution
    path through `stmts`. Exclusive if/else arms take the max arm; an
    arm ending in return/raise/break/continue does not flow into the
    statements after the If. Loops count their body once."""

    def terminates(body: list[ast.stmt]) -> bool:
        return bool(body) and isinstance(
            body[-1],
            (ast.Return, ast.Raise, ast.Break, ast.Continue),
        )

    def calls_in(node: ast.AST) -> int:
        # shallow walk: nested def/lambda bodies are their own units
        n = (
            1
            if isinstance(node, ast.Call) and _callee_name(node) == attr
            else 0
        )
        stack = list(ast.iter_child_nodes(node))
        while stack:
            sub = stack.pop()
            if isinstance(sub, _FUNC_NODES):
                continue
            if isinstance(sub, ast.Call) and _callee_name(sub) == attr:
                n += 1
            stack.extend(ast.iter_child_nodes(sub))
        return n

    def block(body: list[ast.stmt]) -> int:
        if not body:
            return 0
        head, rest = body[0], body[1:]
        if isinstance(head, (*_FUNC_NODES, ast.ClassDef)):
            return block(rest)
        if isinstance(head, ast.If):
            r = block(rest)
            v_then = block(head.body) + (
                0 if terminates(head.body) else r
            )
            v_else = block(head.orelse) + (
                0 if terminates(head.orelse) else r
            )
            return calls_in(head.test) + max(v_then, v_else)
        if isinstance(head, (ast.For, ast.AsyncFor, ast.While)):
            return (
                calls_in(
                    head.iter
                    if isinstance(head, (ast.For, ast.AsyncFor))
                    else head.test
                )
                + block(head.body)
                + block(head.orelse)
                + block(rest)
            )
        if isinstance(head, (ast.With, ast.AsyncWith)):
            n = sum(calls_in(i.context_expr) for i in head.items)
            return n + block(head.body) + block(rest)
        if isinstance(head, ast.Try):
            n = block(head.body) + max(
                [0] + [block(h.body) for h in head.handlers]
            )
            return (
                n
                + block(head.orelse)
                + block(head.finalbody)
                + block(rest)
            )
        if isinstance(head, ast.Return):
            return calls_in(head)
        return calls_in(head) + block(rest)

    return block(stmts)


def _pathmax_for_name(ctx: Context, name: str, attr: str,
                      owner: str | None) -> int | None:
    """Branch-collapsed `attr`-call count for the function(s) named
    `name` (the methods of class `owner` when it is given; max across
    same-named candidates); None when there is none."""
    cands = [c for c in ctx.graph.by_name.get(name, [])
             if owner is None or c.owner_class == owner]
    if not cands:
        return None
    return max(
        _count_calls_pathmax(list(c.node.body), attr) for c in cands
    )


def _mirror_terms(expr: ast.AST) -> tuple[int, int] | None:
    """(A, B) of a mirror expression `A * <...num_layers...> + B`
    (either operand order; IfExp takes the then-arm)."""
    if isinstance(expr, ast.IfExp):
        expr = expr.body
    if not (
        isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add)
    ):
        return None
    const: int | None = None
    mult: ast.BinOp | None = None
    for side in (expr.left, expr.right):
        if isinstance(side, ast.Constant) and isinstance(
            side.value, int
        ):
            const = side.value
        elif isinstance(side, ast.BinOp) and isinstance(
            side.op, ast.Mult
        ):
            mult = side
    if const is None or mult is None:
        return None
    for side in (mult.left, mult.right):
        if isinstance(side, ast.Constant) and isinstance(
            side.value, int
        ):
            return side.value, const
    return None


def _check_psum_mirror(ctx: Context) -> list[Finding]:
    mirror: tuple[str, ast.Assign] | None = None
    for mod in ctx.modules:
        for node in mod.nodes:
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Attribute)
                    and tgt.attr == MIRROR_ATTR
                ):
                    mirror = (mod.path, node)
    if mirror is None:
        return []
    per_layer_actual = 0
    seen_any = False
    for name in PER_LAYER_FUNCS:
        n = _pathmax_for_name(ctx, name, "psum", DECODER_CLASS)
        if n is not None:
            seen_any = True
            per_layer_actual += n
    if not seen_any:
        return []  # partial corpus (mirror without the model): skip
    const_actual = (
        (_pathmax_for_name(ctx, CONST_PSUM_FUNC, "psum", None) or 0)
        + (_pathmax_for_name(ctx, CONST_GATHER_FUNC, "all_gather",
                             DECODER_CLASS) or 0)
    )
    path, node = mirror
    terms = _mirror_terms(node.value)
    if terms is None:
        return [
            Finding(
                "shard-spec",
                path,
                node.lineno,
                node.col_offset,
                f"`{MIRROR_ATTR}` mirror is not of the checkable "
                "form `A * num_layers + B` — keep the "
                "defer_tp_psum_total mirror a statically auditable "
                "affine formula",
            )
        ]
    a, b = terms
    out: list[Finding] = []
    if a != per_layer_actual:
        out.append(
            Finding(
                "shard-spec",
                path,
                node.lineno,
                node.col_offset,
                f"`{MIRROR_ATTR}` claims {a} collectives per layer "
                f"but {DECODER_CLASS}.{'/'.join(PER_LAYER_FUNCS)} "
                f"contain {per_layer_actual} branch-collapsed psum "
                "site(s) — the defer_tp_psum_total mirror drifted from "
                "the sharded forward",
            )
        )
    if b != const_actual:
        out.append(
            Finding(
                "shard-spec",
                path,
                node.lineno,
                node.col_offset,
                f"`{MIRROR_ATTR}` claims {b} per-forward collectives "
                f"outside the layer stack but {CONST_PSUM_FUNC} + "
                f"{DECODER_CLASS}.{CONST_GATHER_FUNC} contain "
                f"{const_actual} (psum + all_gather) site(s) — the "
                "defer_tp_psum_total mirror drifted",
            )
        )
    return out


def rule_shard_spec(ctx: Context) -> list[Finding]:
    return _check_axes(ctx) + _check_arity(ctx) + _check_psum_mirror(ctx)


RULES["shard-spec"] = rule_shard_spec
