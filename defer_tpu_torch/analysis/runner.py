"""Corpus collection, rule dispatch, suppression, CLI.

``python -m defer_tpu_torch.analysis --strict defer_tpu_torch/`` holds
the port to its rules (tests/test_torch_analysis.py runs it): exit 0
means every rule is clean or carries a justified inline ignore, 1 that
a finding stands, 2 a usage or configuration error. The port's obs
registry gets ``defer_analysis_findings_total{rule=...}`` so ``--json``
consumers can track finding counts over time (0 on the shipped tree).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import sys
from typing import Any, Sequence

from defer_tpu_torch.analysis.callgraph import DEFAULT_ROOTS, CallGraph
from defer_tpu_torch.analysis.ignore import Ignore, IgnoreMap
from defer_tpu_torch.analysis.rules import (
    _SHALLOW,
    RULES,
    Context,
    Finding,
    Module,
)

# Self-registering passes: importing them adds their rules to RULES
# (cross-domain-write, shard-spec). The budget pass is not a RULES
# entry — it only runs when --budget names a contracts file.
import defer_tpu_torch.analysis.domains  # noqa: E402,F401
import defer_tpu_torch.analysis.shardcheck  # noqa: E402,F401
from defer_tpu_torch.analysis.budget import (  # noqa: E402
    BudgetError,
    bench_findings,
    check_static,
    evaluate_bench,
    load_budgets,
)


@dataclasses.dataclass
class AnalysisReport:
    findings: list[Finding]  # active (unsuppressed) findings
    suppressed: list[tuple[Finding, Ignore]]
    files: int
    # Per-contract verdicts when the run carried a budgets file
    # ({"path": ..., "bench": ..., "contracts": [...]}); None otherwise.
    budget: dict[str, Any] | None = None

    @property
    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    @property
    def suppressed_by_rule(self) -> dict[str, int]:
        """Suppression counts per rule — the growth signal --strict
        prints so an ignore-sprawl trend is visible in CI output."""
        out: dict[str, int] = {}
        for f, _ in self.suppressed:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_dict(self) -> dict[str, Any]:
        out = {
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "counts": self.counts,
            "suppressed": len(self.suppressed),
            "suppressed_by_rule": self.suppressed_by_rule,
            "files": self.files,
        }
        if self.budget is not None:
            out["budget"] = self.budget
        return out


def _collect_files(paths: Sequence[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                files.extend(
                    os.path.join(root, n)
                    for n in names
                    if n.endswith(".py")
                )
        else:
            files.append(p)
    return sorted(set(files))


def analyze_paths(
    paths: Sequence[str],
    *,
    rules: Sequence[str] | None = None,
    roots: Sequence[str] = DEFAULT_ROOTS,
    strict: bool = False,
    budget: str | None = None,
    bench: str | dict | None = None,
) -> AnalysisReport:
    """Run the (selected) rules over every .py file under `paths`.

    `budget` names a contracts file (budgets.toml) to enforce; `bench`
    optionally supplies measured numbers for its cross-check — a path
    to a JSON file, or an in-memory result dict. With `budget` set and
    `bench` unset, every measured bound is no-data.
    Raises BudgetError (a ValueError) on a malformed contracts file.
    """
    unknown = set(rules or ()) - set(RULES)
    if unknown:
        raise ValueError(f"unknown rules: {sorted(unknown)}")
    modules: list[Module] = []
    ignores: dict[str, IgnoreMap] = {}
    raw: list[Finding] = []
    files = _collect_files(paths)
    graph = CallGraph()
    for path in files:
        try:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError, ValueError) as e:
            raw.append(Finding("parse-error", path, 1, 0, str(e)))
            continue
        modules.append(Module(path, source, tree))
        ignores[path] = IgnoreMap(source)
        graph.add_module(path, tree)
    ctx = Context(modules, graph, tuple(roots))
    for name, fn in RULES.items():
        if rules and name not in rules:
            continue
        raw.extend(fn(ctx))

    budget_state: dict[str, Any] | None = None
    if budget is not None:
        contracts = load_budgets(budget)  # raises BudgetError
        raw.extend(check_static(ctx, contracts, budget))
        bench_data: dict | None = None
        source_name = ""
        if isinstance(bench, dict):
            bench_data, source_name = bench, "<in-memory bench result>"
        elif isinstance(bench, str):
            with open(bench, encoding="utf-8") as fh:
                bench_data = json.load(fh)
            source_name = bench
        verdicts = (
            evaluate_bench(contracts, bench_data, source_name)
            if bench_data is not None
            else evaluate_bench(contracts, {}, "<no bench data>")
        )
        raw.extend(bench_findings(verdicts, contracts, budget))
        budget_state = {
            "path": budget,
            "bench": source_name or None,
            "contracts": verdicts,
        }

    active: list[Finding] = []
    suppressed: list[tuple[Finding, Ignore]] = []
    for f in raw:
        imap = ignores.get(f.path)
        ign = imap.match(f.rule, f.line) if imap else None
        if ign is None:
            active.append(f)
        elif strict and not ign.reason:
            # Strict tier: the escape hatch must say WHY.
            active.append(
                dataclasses.replace(
                    f,
                    rule="ignore-without-reason",
                    message=(
                        f"ignore[{f.rule}] suppresses a finding but "
                        "gives no justification — add a reason after "
                        "the bracket"
                    ),
                )
            )
        else:
            suppressed.append((f, ign))
    active.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    _SHALLOW.clear()
    return AnalysisReport(active, suppressed, len(modules), budget_state)


def record_findings(report: AnalysisReport, registry: Any = None) -> None:
    """Publish per-rule finding counts to the port's obs registry (0 on
    the shipped tree; --json consumers watch the trend)."""
    from defer_tpu_torch.obs.metrics import get_registry

    reg = registry if registry is not None else get_registry()
    counts = report.counts
    for rule in list(RULES) + sorted(set(counts) - set(RULES)):
        reg.counter(
            "defer_analysis_findings_total",
            "Unsuppressed static-analysis findings, by rule",
            {"rule": rule},
        ).inc(counts.get(rule, 0))


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m defer_tpu_torch.analysis",
        description=(
            "torch-aware static lint for defer_tpu_torch: host syncs on "
            "hot paths, graph captures and compiles on hot paths, "
            "implicit randomness, lock discipline, obs naming, thread "
            "domains, collective axes and spec arity"
        ),
    )
    ap.add_argument(
        "paths", nargs="*", default=["defer_tpu_torch"],
        help="files or directories to analyze (default: defer_tpu_torch)",
    )
    ap.add_argument(
        "--strict", action="store_true",
        help="also fail on ignore comments without a justification",
    )
    ap.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit a single JSON object instead of text findings",
    )
    ap.add_argument(
        "--rules", default=None,
        help=f"comma list to run a subset of {', '.join(RULES)}",
    )
    ap.add_argument(
        "--roots", default=None,
        help=(
            "comma list of hot-path root function names "
            f"(default: {', '.join(DEFAULT_ROOTS)})"
        ),
    )
    ap.add_argument(
        "--list-rules", action="store_true",
        help="print rule names and exit",
    )
    ap.add_argument(
        "--budget", default=None, metavar="BUDGETS_TOML",
        help=(
            "enforce the perf contracts declared in this file "
            "(static counter-touch checks always; measured bounds "
            "against --bench, no-data without it)"
        ),
    )
    ap.add_argument(
        "--bench", default=None, metavar="BENCH_JSON",
        help="bench artifact for the --budget measured cross-check",
    )
    args = ap.parse_args(argv)
    if args.list_rules:
        print("\n".join(RULES))
        return 0
    try:
        report = analyze_paths(
            args.paths,
            rules=args.rules.split(",") if args.rules else None,
            roots=(
                tuple(args.roots.split(",")) if args.roots
                else DEFAULT_ROOTS
            ),
            strict=args.strict,
            budget=args.budget,
            bench=args.bench,
        )
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        record_findings(report)
    except Exception:  # noqa: BLE001 — lint must not die on obs wiring
        pass
    if args.as_json:
        print(json.dumps(report.to_dict(), indent=2, sort_keys=True))
    else:
        for f in report.findings:
            print(f.format())
        if args.strict and report.suppressed:
            # The ignore ledger: per-rule suppression counts, so CI
            # output shows growth even while the gate stays green.
            print("suppressions by rule:", file=sys.stderr)
            for rule, n in sorted(report.suppressed_by_rule.items()):
                print(f"  {rule:24s} {n:3d}", file=sys.stderr)
        if report.budget is not None:
            bench_src = report.budget["bench"] or "none found"
            print(f"budget: {report.budget['path']} "
                  f"(bench: {bench_src})", file=sys.stderr)
            for v in report.budget["contracts"]:
                val = "" if v["value"] is None else f" = {v['value']}"
                print(
                    f"  {v['contract']:28s} {v['status']}{val}",
                    file=sys.stderr,
                )
        print(
            f"{len(report.findings)} finding(s), "
            f"{len(report.suppressed)} suppressed, "
            f"{report.files} file(s) analyzed",
            file=sys.stderr,
        )
    return 1 if report.findings else 0
