"""Pass 3 — static perf-contract gate (`perf-contract`).

The port's contracts are DECLARED state, as the reference's are:
``defer_tpu_torch/analysis/budgets.toml`` names each contract, the obs
counter that accounts for it, the hot functions that must feed that
counter, and a numeric bound on a bench-artifact metric.
``python -m defer_tpu_torch.analysis --budget FILE`` enforces both
halves:

Static half (always runs)
    - the contract's counter is registered somewhere in the corpus
      (``reg.counter("defer_..."...)`` with a literal name);
    - every function the contract names exists AND reaches — through
      the same open-world callgraph the host-sync rule uses — at least
      one touch of the counter's pre-bound handle attribute
      (``self.obs.host_dispatches.inc()``). A hot loop that stops
      feeding its accounting counter is exactly the silent-regression
      failure mode: the bench metric would go stale while still
      looking green.

Measured half (only with ``--bench FILE``)
    - the contract's ``bench_metric`` dotted path is read out of the
      JSON file given (or the in-memory result dict a caller passes)
      and checked against ``max``/``min``. A section the file does not
      hold is ``no-data``; so is every contract when no file is given.
      Only a present-and-violated bound fails. Nothing is read by
      default: the JAX package's ``BENCH_*.json`` rounds at the repo
      root are TPU numbers, not the port's.

Both halves report through the normal Finding stream (rule
``perf-contract``), so ``--strict --json`` consumers see budget state
next to lint state.

``tomllib`` parses the file where it exists (Python >= 3.11); a strict
subset parser (tables, strings, numbers, booleans, flat arrays) backs
it elsewhere, so the gate needs nothing the container doesn't have.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Any

from defer_tpu_torch.analysis.rules import Context, Finding

_OBS_KINDS = {"counter", "gauge", "histogram"}


class BudgetError(ValueError):
    """Malformed budgets file: bad TOML, or a contract missing/
    mistyping a required key."""


# -- TOML subset ------------------------------------------------------

_SECTION_RE = re.compile(r"^\[(?P<name>[A-Za-z0-9_.\-]+)\]$")
_KEY_RE = re.compile(r"^(?P<key>[A-Za-z0-9_\-]+)\s*=\s*(?P<val>.+)$")


def _strip_comment(line: str) -> str:
    """Drop a trailing # comment (quote-aware enough for this file's
    grammar: # inside a double-quoted string is kept)."""
    out = []
    in_str = False
    for ch in line:
        if ch == '"':
            in_str = not in_str
        elif ch == "#" and not in_str:
            break
        out.append(ch)
    return "".join(out).strip()


def _parse_value(raw: str, where: str) -> Any:
    raw = raw.strip()
    if raw.startswith('"') and raw.endswith('"') and len(raw) >= 2:
        return raw[1:-1]
    if raw in ("true", "false"):
        return raw == "true"
    if raw.startswith("[") and raw.endswith("]"):
        inner = raw[1:-1].strip()
        if not inner:
            return []
        return [
            _parse_value(part.strip(), where)
            for part in inner.split(",")
            if part.strip()
        ]
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        raise BudgetError(
            f"{where}: unparseable value {raw!r} (the built-in TOML "
            "subset takes strings, numbers, booleans and flat arrays)"
        ) from None


def _parse_toml(text: str, path: str) -> dict[str, Any]:
    """budgets.toml -> nested dict, with a ``__line__`` entry per
    table so findings can point at the contract's declaration."""
    try:
        import tomllib  # Python >= 3.11

        data = tomllib.loads(text)
        # tomllib gives no line info; findings fall back to line 1.
        return data
    except ModuleNotFoundError:
        pass
    except Exception as e:  # malformed under the real parser
        raise BudgetError(f"{path}: {e}") from None
    root: dict[str, Any] = {}
    table = root
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = _strip_comment(raw)
        if not line:
            continue
        m = _SECTION_RE.match(line)
        if m:
            table = root
            for part in m.group("name").split("."):
                table = table.setdefault(part, {})
                if not isinstance(table, dict):
                    raise BudgetError(
                        f"{path}:{lineno}: table {m.group('name')!r} "
                        "collides with a value"
                    )
            table["__line__"] = lineno
            continue
        m = _KEY_RE.match(line)
        if m:
            table[m.group("key")] = _parse_value(
                m.group("val"), f"{path}:{lineno}"
            )
            continue
        raise BudgetError(f"{path}:{lineno}: unparseable line {raw!r}")
    return root


# -- contracts --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Contract:
    name: str
    counter: str  # obs metric accounting for this contract
    functions: tuple[str, ...]  # hot functions that must feed it
    line: int  # declaration line in budgets.toml (1 if unknown)
    description: str = ""
    max_value: float | None = None  # bound on the bench metric
    min_value: float | None = None
    bench_section: str | None = None  # key in the bench result dict
    bench_metric: str | None = None  # dotted path inside the section


def load_budgets(path: str) -> list[Contract]:
    with open(path, encoding="utf-8") as fh:
        data = _parse_toml(fh.read(), path)
    tables = data.get("contract")
    if not isinstance(tables, dict) or not any(
        isinstance(v, dict) for v in tables.values()
    ):
        raise BudgetError(
            f"{path}: no [contract.<name>] tables — nothing to enforce"
        )
    out: list[Contract] = []
    for name, tab in tables.items():
        if not isinstance(tab, dict):
            continue
        where = f"{path}: [contract.{name}]"
        counter = tab.get("counter")
        if not isinstance(counter, str) or not counter:
            raise BudgetError(f"{where}: missing `counter` (a string)")
        funcs = tab.get("functions")
        if not isinstance(funcs, list) or not all(
            isinstance(f, str) for f in funcs
        ):
            raise BudgetError(
                f"{where}: missing `functions` (array of strings)"
            )
        bounds = {}
        for key in ("max", "min"):
            v = tab.get(key)
            if v is not None and not isinstance(v, (int, float)):
                raise BudgetError(f"{where}: `{key}` must be numeric")
            bounds[key] = float(v) if v is not None else None
        if (
            bounds["max"] is not None or bounds["min"] is not None
        ) and not (
            isinstance(tab.get("bench_section"), str)
            and isinstance(tab.get("bench_metric"), str)
        ):
            raise BudgetError(
                f"{where}: a max/min bound needs `bench_section` and "
                "`bench_metric` naming what it bounds"
            )
        out.append(
            Contract(
                name=name,
                counter=counter,
                functions=tuple(funcs),
                line=int(tab.get("__line__", 1)),
                description=str(tab.get("description", "")),
                max_value=bounds["max"],
                min_value=bounds["min"],
                bench_section=tab.get("bench_section"),
                bench_metric=tab.get("bench_metric"),
            )
        )
    return out


# -- static half ------------------------------------------------------


def _metric_handles(ctx: Context) -> dict[str, set[str]]:
    """metric name -> attribute names its pre-bound handles are stored
    under (``self.host_dispatches = reg.counter("defer_host_..."``
    maps the metric to {"host_dispatches"})."""
    out: dict[str, set[str]] = {}
    for mod in ctx.modules:
        for node in mod.nodes:
            if not isinstance(node, ast.Assign):
                continue
            calls = [node.value]
            # handles built in comprehensions/dicts still carry the
            # literal name; find any obs-kind call in the value expr
            calls = [
                c
                for c in ast.walk(node.value)
                if isinstance(c, ast.Call)
                and isinstance(c.func, ast.Attribute)
                and c.func.attr in _OBS_KINDS
            ]
            for call in calls:
                if not (
                    call.args
                    and isinstance(call.args[0], ast.Constant)
                    and isinstance(call.args[0].value, str)
                ):
                    continue
                metric = call.args[0].value
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute):
                        out.setdefault(metric, set()).add(tgt.attr)
                    elif isinstance(tgt, ast.Name):
                        out.setdefault(metric, set()).add(tgt.id)
    return out


def _touches(fn_node: ast.AST, attrs: set[str]) -> bool:
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Attribute) and node.attr in attrs:
            return True
    return False


def check_static(
    ctx: Context, contracts: list[Contract], budget_path: str
) -> list[Finding]:
    """Registration + reachable-touch checks; findings point at the
    contract declaration in budgets.toml."""
    handles = _metric_handles(ctx)
    out: list[Finding] = []
    for c in contracts:
        attrs = handles.get(c.counter)
        if not attrs:
            out.append(
                Finding(
                    "perf-contract",
                    budget_path,
                    c.line,
                    0,
                    f"[contract.{c.name}] accounts through "
                    f"{c.counter!r} but no analyzed module registers "
                    "that metric — the contract can never be measured",
                )
            )
            continue
        for fname in c.functions:
            cands = ctx.graph.by_name.get(fname, [])
            if not cands:
                out.append(
                    Finding(
                        "perf-contract",
                        budget_path,
                        c.line,
                        0,
                        f"[contract.{c.name}] names hot function "
                        f"{fname!r}, which does not exist in the "
                        "analyzed corpus",
                    )
                )
                continue
            # BFS from the named functions; ANY candidate chain
            # touching the handle satisfies the contract (both decode
            # servers define `_tick`; each feeds the shared metric).
            seen: set[int] = set()
            frontier = list(cands)
            found = False
            while frontier and not found:
                fi = frontier.pop()
                if id(fi.node) in seen:
                    continue
                seen.add(id(fi.node))
                if _touches(fi.node, attrs):
                    found = True
                    break
                for bare, calls in (
                    (True, fi.calls_bare),
                    (False, fi.calls_attr),
                ):
                    for callee in calls:
                        frontier.extend(
                            r
                            for r in ctx.graph.resolve_call(
                                fi, callee, bare
                            )
                            if id(r.node) not in seen
                        )
            if not found:
                out.append(
                    Finding(
                        "perf-contract",
                        budget_path,
                        c.line,
                        0,
                        f"[contract.{c.name}]: nothing reachable from "
                        f"`{fname}` touches the {c.counter!r} handle "
                        f"({'/'.join(sorted(attrs))}) — the hot loop "
                        "stopped feeding its accounting counter, so "
                        "the budget would go stale while looking green",
                    )
                )
    return out


# -- measured half ----------------------------------------------------


def _bench_sections(data: dict) -> dict:
    """The dict bench sections live in: at top level, or nested under
    `parsed` as the driver's round artifacts hold them."""
    parsed = data.get("parsed")
    if isinstance(parsed, dict):
        return parsed
    return data


def _navigate(section: Any, dotted: str) -> Any:
    """`windows.8.dispatches_per_token` through a JSON round-trip:
    integer-looking segments try both the int and str key."""
    cur = section
    for part in dotted.split("."):
        if not isinstance(cur, dict):
            return None
        if part in cur:
            cur = cur[part]
            continue
        try:
            ipart = int(part)
        except ValueError:
            return None
        if ipart in cur:
            cur = cur[ipart]
        else:
            return None
    return cur


def evaluate_bench(
    contracts: list[Contract], bench: dict, source: str
) -> list[dict[str, Any]]:
    """Per-contract measured verdicts: status pass|fail|no-data plus
    the observed value and the violated bound, JSON-ready."""
    sections = _bench_sections(bench)
    out: list[dict[str, Any]] = []
    for c in contracts:
        rec: dict[str, Any] = {
            "contract": c.name,
            "counter": c.counter,
            "bench_section": c.bench_section,
            "bench_metric": c.bench_metric,
            "source": source,
            "status": "no-data",
            "value": None,
        }
        if c.bench_section is None or c.bench_metric is None:
            rec["status"] = "static-only"
            out.append(rec)
            continue
        section = sections.get(c.bench_section)
        value = (
            _navigate(section, c.bench_metric)
            if isinstance(section, dict)
            else None
        )
        if not isinstance(value, (int, float)) or isinstance(
            value, bool
        ):
            out.append(rec)
            continue
        rec["value"] = value
        rec["status"] = "pass"
        if c.max_value is not None and value > c.max_value:
            rec["status"] = "fail"
            rec["bound"] = {"max": c.max_value}
        elif c.min_value is not None and value < c.min_value:
            rec["status"] = "fail"
            rec["bound"] = {"min": c.min_value}
        out.append(rec)
    return out


def bench_findings(
    verdicts: list[dict[str, Any]],
    contracts: list[Contract],
    budget_path: str,
) -> list[Finding]:
    by_name = {c.name: c for c in contracts}
    out: list[Finding] = []
    for v in verdicts:
        if v["status"] != "fail":
            continue
        c = by_name[v["contract"]]
        bound_kind, bound_val = next(iter(v["bound"].items()))
        cmp = ">" if bound_kind == "max" else "<"
        out.append(
            Finding(
                "perf-contract",
                budget_path,
                c.line,
                0,
                f"[contract.{c.name}] violated by {v['source']}: "
                f"{c.bench_section}.{c.bench_metric} = {v['value']} "
                f"{cmp} {bound_kind} {bound_val} — the measured hot "
                "path regressed past its declared budget",
            )
        )
    return out
