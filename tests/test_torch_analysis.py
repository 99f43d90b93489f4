"""defer_tpu_torch.analysis: the torch rules and passes on fixtures of
their own (tests/torch_analysis_fixtures/), the neutral rules, the
ignore parser and the hot set held finding for finding to
defer_tpu.analysis on the reference's fixtures (tests/analysis_fixtures/,
read in place), the CLI, the budget pass, the capture and sync
sanitizers on the CPU, and the strict pass over defer_tpu_torch/ in a
subprocess that never imports jax."""

import ast
import json
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from defer_tpu.analysis import analyze_paths as ref_analyze
from defer_tpu.analysis.callgraph import CallGraph as RefCallGraph
from defer_tpu.analysis.ignore import IgnoreMap as RefIgnoreMap
from defer_tpu_torch.analysis import (
    RecaptureError,
    analyze_paths,
    capture_sanitizer,
    sync_sanitizer,
)
from defer_tpu_torch.analysis.budget import BudgetError
from defer_tpu_torch.analysis.callgraph import DEFAULT_ROOTS, CallGraph
from defer_tpu_torch.analysis.ignore import IgnoreMap
from defer_tpu_torch.analysis.runner import main, record_findings
from defer_tpu_torch.obs.metrics import MetricsRegistry

HERE = pathlib.Path(__file__).resolve().parent
FIXTURES = HERE / "torch_analysis_fixtures"
REF_FIXTURES = HERE / "analysis_fixtures"
REPO = HERE.parent

# (rule, fixture stem, expected positive-finding count), as each
# fixture's docstring states.
CASES = [
    ("host-sync-in-hot-loop", "host_sync", 10),
    ("capture-in-hot-path", "capture", 3),
    ("implicit-randomness", "randomness", 4),
    ("lock-discipline", "lock", 2),
    ("obs-name-drift", "obs_drift", 3),
    ("cross-domain-write", "domain_race", 2),
    ("shard-spec", "shard_spec", 3),
    ("shard-spec", "psum_mirror", 1),
]
# The framework-neutral rules, held to the reference pass.
NEUTRAL = ["lock-discipline", "obs-name-drift", "cross-domain-write"]


def _run(path, rule, **kw):
    return analyze_paths([str(path)], rules=[rule], **kw)


@pytest.mark.parametrize("rule,stem,n", CASES)
def test_rule_catches_positive_fixture(rule, stem, n):
    rep = _run(FIXTURES / f"{stem}_pos.py", rule)
    assert len(rep.findings) == n, [f.format() for f in rep.findings]
    assert all(f.rule == rule for f in rep.findings)


@pytest.mark.parametrize("rule,stem,n", CASES)
def test_rule_passes_negative_fixture(rule, stem, n):
    rep = _run(FIXTURES / f"{stem}_neg.py", rule, strict=True)
    assert rep.findings == [], [f.format() for f in rep.findings]


def test_host_sync_names_each_torch_form():
    rep = _run(FIXTURES / "host_sync_pos.py", "host-sync-in-hot-loop")
    said = " ".join(f.message.split(" in `")[0] for f in rep.findings)
    for form in (".item()", ".tolist()", ".cpu()", '.to("cpu")',
                 ".synchronize()", "int() of a tensor",
                 "bool() of a tensor", "float() of a tensor",
                 "np.asarray"):
        assert form in said, (form, said)
    # t.cpu().numpy() is one sync: the inner call alone is flagged.
    assert ".numpy()" not in said
    src = (FIXTURES / "host_sync_pos.py").read_text().splitlines()
    assert {f.line for f in rep.findings if ".synchronize()" in f.message} \
        == {i + 1 for i, line in enumerate(src) if "synchronize()" in line}


def test_seeded_item_in_a_copy_of_tick_is_caught(tmp_path):
    """A copy of the paged server's `_tick` with one `.item()` seeded in:
    the pass flags that line and nothing else."""
    src = (REPO / "defer_tpu_torch/runtime/paged.py").read_text()
    tree = ast.parse(src)
    tick = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == "_tick")
    body = textwrap.dedent(ast.get_source_segment(src, tick))
    lines = body.splitlines()
    seed_at = next(i for i, line in enumerate(lines)
                   if "self._feed.copy_(" in line)
    indent = lines[seed_at][: len(lines[seed_at]) - len(
        lines[seed_at].lstrip())]
    lines.insert(seed_at + 1, f"{indent}first = nxt[0].item()")
    copy = tmp_path / "tick_copy.py"
    copy.write_text("import torch\n\n\nclass PagedDecodeServer:\n"
                    + textwrap.indent("\n".join(lines), "    ") + "\n")
    rep = analyze_paths([str(copy)], rules=["host-sync-in-hot-loop"],
                        strict=True)
    assert [(f.rule, ".item()" in f.message) for f in rep.findings] == [
        ("host-sync-in-hot-loop", True)], [f.format() for f in rep.findings]


# -- parity with the reference pass --------------------------------------


def _ref_fixture_files():
    return sorted(str(p) for p in REF_FIXTURES.glob("*.py"))


def _key(findings):
    return sorted((f.rule, f.path, f.line, f.col) for f in findings)


@pytest.mark.parametrize("rule", NEUTRAL)
def test_neutral_rule_matches_the_reference_on_its_fixtures(rule):
    """Every neutral rule over every reference fixture, one file at a
    time as the reference's own tests run them and all together: the
    same (rule, path, line, column) findings."""
    files = _ref_fixture_files()
    assert files
    for batch in [[f] for f in files] + [files]:
        ours = analyze_paths(batch, rules=[rule])
        theirs = ref_analyze(batch, rules=[rule])
        assert _key(ours.findings) == _key(theirs.findings), batch
        assert _key(f for f, _ in ours.suppressed) == _key(
            f for f, _ in theirs.suppressed), batch
    hits = analyze_paths([str(REF_FIXTURES / f"{stem}_pos.py") for stem in (
        "lock_discipline", "obs_drift", "domain_race")], rules=[rule])
    assert hits.findings  # the comparison saw findings, not only silence


def test_ignore_parser_matches_the_reference():
    paths = _ref_fixture_files() + [str(REPO / "defer_tpu/runtime/paged.py")]
    for path in paths:
        src = pathlib.Path(path).read_text()
        ours = [(i.line, i.comment_line, i.rules, i.reason)
                for i in IgnoreMap(src).ignores]
        theirs = [(i.line, i.comment_line, i.rules, i.reason)
                  for i in RefIgnoreMap(src).ignores]
        assert ours == theirs, path
    assert any(RefIgnoreMap(pathlib.Path(p).read_text()).ignores
               for p in paths)


def test_hot_set_matches_the_reference():
    """The reference's fixtures have none of the port's extra roots, so
    the hot sets (by qualified name) agree file for file."""
    for path in _ref_fixture_files():
        tree = ast.parse(pathlib.Path(path).read_text())
        ours, theirs = CallGraph(), RefCallGraph()
        ours.add_module(path, tree)
        theirs.add_module(path, tree)
        hot = {f.qualname for f in ours.functions
               if id(f.node) in ours.hot_set()}
        ref_hot = {f.qualname for f in theirs.functions
                   if id(f.node) in theirs.hot_set()}
        assert hot == ref_hot, path


def test_port_roots_reach_the_stage_loop_and_the_follower():
    """The roots the port adds: the DEFER stage loop (entered as
    `self(x)` / `stage(x)`) and a follower rank's `_follow` are hot; a
    dotted root does not make every `__call__` hot."""
    graph = CallGraph()
    for rel in ("parallel/pipeline.py", "runtime/paged.py"):
        path = REPO / "defer_tpu_torch" / rel
        graph.add_module(str(path), ast.parse(path.read_text()))
    graph.add_module("other.py", ast.parse(
        "class Other:\n    def __call__(self, x):\n        return x\n"))
    hot = {f.qualname.split(":")[1] for f in graph.functions
           if id(f.node) in graph.hot_set(DEFAULT_ROOTS)}
    assert {"Pipeline.__call__", "Stage.forward",
            "PagedDecodeServer._follow",
            "PagedDecodeServer._tick_window",
            "PagedDecodeServer._tick_pp"} <= hot
    assert "Other.__call__" not in hot


# -- ignores, CLI and obs --------------------------------------------------


def _ticky(marker):
    return textwrap.dedent(
        f"""
        class S:
            def _tick(self):
                {marker}
                h = self.nxt.tolist()
                return h
        """
    )


def test_ignore_with_reason_suppresses(tmp_path):
    p = tmp_path / "ok.py"
    p.write_text(_ticky("# analysis: ignore[host-sync-in-hot-loop] the "
                        "tick's one batched transfer"))
    rep = analyze_paths([str(p)], strict=True)
    assert rep.findings == [] and len(rep.suppressed) == 1


def test_strict_flags_reasonless_ignore(tmp_path):
    p = tmp_path / "bare.py"
    p.write_text(_ticky("# analysis: ignore[host-sync-in-hot-loop]"))
    assert analyze_paths([str(p)]).findings == []
    strict = analyze_paths([str(p)], strict=True)
    assert [f.rule for f in strict.findings] == ["ignore-without-reason"]
    assert main([str(p), "--strict"]) == 1


def test_unknown_rule_and_parse_error(tmp_path):
    with pytest.raises(ValueError, match="unknown rules"):
        analyze_paths([str(FIXTURES)], rules=["fresh-closure-jit"])
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n")
    assert [f.rule for f in analyze_paths([str(p)]).findings] == [
        "parse-error"]


def test_cli_exit_codes_and_json(capsys):
    pos = str(FIXTURES / "randomness_pos.py")
    assert main([pos, "--rules", "implicit-randomness", "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["counts"] == {"implicit-randomness": 4}
    assert set(out) == {"findings", "counts", "suppressed",
                        "suppressed_by_rule", "files"}
    assert set(out["findings"][0]) == {"rule", "path", "line", "col",
                                       "message"}
    neg = str(FIXTURES / "randomness_neg.py")
    assert main([neg, "--rules", "implicit-randomness"]) == 0
    assert main(["--list-rules"]) == 0
    rules = capsys.readouterr().out.split()
    assert rules == ["host-sync-in-hot-loop", "capture-in-hot-path",
                     "implicit-randomness", "lock-discipline",
                     "obs-name-drift", "cross-domain-write", "shard-spec"]
    assert main([pos, "--rules", "bogus"]) == 2


def test_findings_metric_recorded():
    rep = analyze_paths([str(FIXTURES / "obs_drift_pos.py")],
                        rules=["obs-name-drift"])
    reg = MetricsRegistry()
    record_findings(rep, registry=reg)
    assert reg.value("defer_analysis_findings_total",
                     rule="obs-name-drift") == 3
    assert reg.value("defer_analysis_findings_total",
                     rule="implicit-randomness") == 0


# -- the perf-contract budget pass ----------------------------------------

BUDGET = FIXTURES / "budget"
CONTRACTS = {"dispatches_per_token_w8", "kv_rows_per_shard_tp2",
             "window_drain_b_k"}


def test_budget_static_and_measured_pass():
    rep = analyze_paths([str(BUDGET / "hot.py")],
                        budget=str(BUDGET / "budgets.toml"),
                        bench=str(BUDGET / "bench_ok.json"))
    assert rep.findings == [], [f.format() for f in rep.findings]
    assert {c["contract"]: c["status"] for c in rep.budget["contracts"]} \
        == dict.fromkeys(CONTRACTS, "pass")


def test_budget_measured_violation_fails_the_cli(capsys):
    rc = main([str(BUDGET / "hot.py"), "--budget",
               str(BUDGET / "budgets.toml"), "--bench",
               str(BUDGET / "bench_bad.json"), "--json"])
    assert rc == 1
    out = json.loads(capsys.readouterr().out)
    assert out["counts"] == {"perf-contract": 3}
    assert {c["status"] for c in out["budget"]["contracts"]} == {"fail"}


def test_budget_static_violation_needs_no_bench():
    rep = analyze_paths([str(BUDGET / "cold.py")],
                        budget=str(BUDGET / "budgets.toml"))
    assert [f.rule for f in rep.findings] == ["perf-contract"] * 4
    assert all("nothing reachable" in f.message for f in rep.findings)


def test_budget_without_bench_is_no_data_and_passes(tmp_path, monkeypatch):
    """No --bench: every measured bound is no-data and nothing fails,
    even beside a BENCH_*.json in the working directory (the JAX
    package's rounds are not the port's numbers, so none is read)."""
    (tmp_path / "BENCH_r99.json").write_text(
        (BUDGET / "bench_bad.json").read_text())
    monkeypatch.chdir(tmp_path)
    rep = analyze_paths([str(BUDGET / "hot.py")],
                        budget=str(BUDGET / "budgets.toml"))
    assert rep.findings == []
    assert {c["status"] for c in rep.budget["contracts"]} == {"no-data"}
    assert rep.budget["bench"] is None
    sparse = analyze_paths([str(BUDGET / "hot.py")],
                           budget=str(BUDGET / "budgets.toml"),
                           bench={"decode_window": {}})
    assert {c["status"] for c in sparse.budget["contracts"]} == {"no-data"}


def test_budget_malformed_toml_rejected(tmp_path, capsys):
    bad = tmp_path / "budgets.toml"
    bad.write_text('[contract.x]\ncounter = 5\nfunctions = ["_tick"]\n')
    with pytest.raises(BudgetError, match="counter"):
        analyze_paths([str(BUDGET / "hot.py")], budget=str(bad))
    assert main([str(BUDGET / "hot.py"), "--budget", str(bad)]) == 2
    assert "counter" in capsys.readouterr().err


def test_budget_subset_parser_without_tomllib(monkeypatch):
    """The strict TOML subset parser (where tomllib is missing) reads
    the port's contracts file as tomllib does, with line numbers."""
    import builtins

    from defer_tpu_torch.analysis import budget

    path = REPO / "defer_tpu_torch/analysis/budgets.toml"
    want = budget.load_budgets(str(path))
    real_import = builtins.__import__

    def no_tomllib(name, *args, **kw):
        if name == "tomllib":
            raise ModuleNotFoundError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tomllib)
    got = budget.load_budgets(str(path))
    strip = [c.__class__(**{**c.__dict__, "line": 1}) for c in got]
    assert strip == want
    assert [c.line for c in got] == sorted(c.line for c in got)
    assert all(c.line > 1 for c in got)


# -- the runtime sanitizers --------------------------------------------------


class _FakeServer:
    """A server's capture state as the paged server keeps it."""

    def __init__(self):
        self.graph_captures = 0
        self._graphs = {}

    def capture(self, key):
        self._graphs[key] = object()
        self.graph_captures += 1


class _Fleet:
    def __init__(self):
        self.replicas = {0: _FakeServer(), 1: _FakeServer()}


def test_capture_sanitizer_clean_block():
    srv = _FakeServer()
    srv.capture(("decode", "argmax", False))
    with capture_sanitizer(srv) as rep:
        srv._graphs[("decode", "argmax", False)]  # a replay's lookup
    assert rep.captures == 0 and rep.watched == ["_FakeServer"]


def test_capture_sanitizer_raises_on_a_recapture():
    srv = _FakeServer()
    with pytest.raises(RecaptureError, match="nosort"):
        with capture_sanitizer(srv):
            srv.capture(("decode", "nosort", False))


def test_capture_sanitizer_allow_and_one_level_scan():
    fleet = _Fleet()
    with capture_sanitizer(fleet, allow=1) as rep:
        fleet.replicas[1].capture(("spec", "argmax", False))
    assert rep.captures == 1
    assert list(rep.deltas) == ["_Fleet.replicas[1]"]
    with pytest.raises(RecaptureError):
        with capture_sanitizer(fleet, allow=1):
            fleet.replicas[0].capture(("decode", "argmax", False))
            fleet.replicas[1].capture(("decode", "argmax", True))


def test_capture_sanitizer_counts_an_object_once():
    srv = _FakeServer()
    with capture_sanitizer(srv, allow=1) as rep:
        srv.capture(("decode", "argmax", False))  # counter and dict both
    assert rep.captures == 1


def test_capture_sanitizer_does_not_mask_block_errors():
    srv = _FakeServer()
    with pytest.raises(RuntimeError, match="boom"):
        with capture_sanitizer(srv):
            srv.capture(("decode", "argmax", False))
            raise RuntimeError("boom")


def test_capture_sanitizer_refuses_to_watch_nothing():
    with pytest.raises(ValueError, match="no graph_captures"):
        with capture_sanitizer(object()):
            pass


def test_capture_sanitizer_on_a_cpu_paged_server():
    """A real server on the CPU captures nothing (windows run eagerly
    there): the sanitizer watches it and stays clean."""
    from defer_tpu_torch.models.llama import llama_config
    from defer_tpu_torch.models.gpt import GptDecoder
    from defer_tpu_torch.runtime.paged import PagedDecodeServer

    cfg = llama_config(num_layers=1, dim=32, num_heads=2, num_kv_heads=1,
                       ffn_dim=64, vocab_size=64, max_len=32)
    dec = GptDecoder(cfg, compute_dtype=torch.float32, device="cpu")
    params = dec.init(torch.Generator().manual_seed(0))
    srv = PagedDecodeServer(dec, params, num_blocks=8, block_size=4,
                            max_batch=2, decode_window=2, device="cpu")
    srv.submit(torch.tensor([[3, 5, 7]]), 5)
    with capture_sanitizer(srv) as rep:
        srv.run()
    assert rep.captures == 0 and srv.graph_replays == 0


def test_sync_sanitizer_is_a_noop_without_a_card(monkeypatch):
    """Without a CUDA device the block runs, nothing is counted, and the
    report says why; the guard has no switch that turns it off where a
    card is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with sync_sanitizer(allow=0) as rep:
        torch.arange(4).tolist()
        torch.ones(2).sum().item()
    assert not rep.active and rep.syncs == 0 and "no CUDA" in rep.note
    with pytest.raises(TypeError):
        sync_sanitizer(allow=0, device="cpu").__enter__()


# -- the shipped tree --------------------------------------------------------


@pytest.fixture(scope="module")
def strict_pass():
    """The strict pass over defer_tpu_torch/ (with the port's budgets),
    once, in a process that imports no jax: its exit code, JSON report
    and whether jax got imported."""
    code = textwrap.dedent(
        """
        import json, sys
        from defer_tpu_torch.analysis.runner import main
        rc = main(["--strict", "--json", "--budget",
                   "defer_tpu_torch/analysis/budgets.toml",
                   "defer_tpu_torch/"])
        print(json.dumps({"rc": rc, "jax": "jax" in sys.modules,
                          "defer_tpu": "defer_tpu" in sys.modules}))
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    text = proc.stdout
    tail = json.loads(text.strip().splitlines()[-1])
    report = json.loads(text[: text.rindex("\n", 0, len(text) - 1)])
    return tail, report


def test_port_is_strict_clean_without_jax(strict_pass):
    tail, report = strict_pass
    assert tail == {"rc": 0, "jax": False, "defer_tpu": False}
    assert report["findings"] == [], report["findings"]
    assert report["files"] > 90


def test_port_suppressions_all_carry_reasons_and_are_counted(strict_pass):
    _, report = strict_pass
    ledger = report["suppressed_by_rule"]
    assert sum(ledger.values()) == report["suppressed"] > 0
    assert set(ledger) <= {"host-sync-in-hot-loop", "lock-discipline"}
    assert {c["contract"]: c["status"]
            for c in report["budget"]["contracts"]} == dict.fromkeys(
        ["dispatches_per_token_w8", "kv_rows_per_shard_tp2", "pp", "mixed",
         "window_drain_b_k"], "no-data")


# -- the drains the pass turned up -------------------------------------------


def _count_tolist(monkeypatch):
    calls = []
    real = torch.Tensor.tolist

    def counted(self):
        calls.append(tuple(self.shape))
        return real(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counted)
    return calls


@pytest.mark.parametrize("server,window", [
    ("paged", 4), ("paged", 1), ("paged_spec", 4), ("flat", 4),
    ("flat", 1)])
def test_a_tick_drains_in_one_transfer(monkeypatch, server, window):
    """A steady tick or window with eos set and streaming on (the
    drain's widest case) reads the card back in ONE transfer
    (`host_lists`), where a window took two to ten `.tolist()` calls
    before: the paged server's tick, window and speculative window, and
    the flat server's tick and window."""
    from defer_tpu_torch.models.gpt import GptDecoder
    from defer_tpu_torch.models.llama import llama_config
    from defer_tpu_torch.runtime.decode_server import DecodeServer
    from defer_tpu_torch.runtime.paged import PagedDecodeServer

    cfg = llama_config(num_layers=1, dim=32, num_heads=2, num_kv_heads=1,
                       ffn_dim=64, vocab_size=64, max_len=64)
    dec = GptDecoder(cfg, compute_dtype=torch.float32, device="cpu")
    params = dec.init(torch.Generator().manual_seed(0))
    streamed = []
    knobs = dict(max_batch=2, decode_window=window, eos_id=63,
                 on_token=lambda *a: streamed.append(a))
    if server == "flat":
        srv = DecodeServer(dec, params, **knobs)
    else:
        spec = dict(spec_k=2, spec_draft=dec, spec_params=params) \
            if server == "paged_spec" else {}
        srv = PagedDecodeServer(dec, params, num_blocks=16, block_size=4,
                                device="cpu", **knobs, **spec)
    for n in (3, 5):
        srv.submit(torch.arange(1, n + 1)[None], 20)
    srv._admit()  # both servers' admission, then steady ticks
    srv._tick()
    calls = _count_tolist(monkeypatch)
    srv._tick()
    assert len(calls) == 1, calls
    assert streamed


@pytest.mark.parametrize("dtypes,cats", [
    (("int64",), 0), (("int32", "int32"), 1), (("bool", "bool"), 1),
    (("int64", "bool", "int32"), 1)])
def test_host_lists_gives_each_tolist(monkeypatch, dtypes, cats):
    """`host_lists` gives each tensor's own `.tolist()`, nesting and
    bools included; one tensor goes down as it is (no concatenation or
    cast before the transfer), and several in one concatenation."""
    from defer_tpu_torch.runtime import batching

    rng = np.random.default_rng(0)
    shapes = [(3,), (2, 3), (4,)]
    tensors = [torch.as_tensor(rng.integers(0, 2 if d == "bool" else 9,
                                            size=s)).to(getattr(torch, d))
               for d, s in zip(dtypes, shapes)]
    want = [t.tolist() for t in tensors]
    real, seen = torch.cat, []
    monkeypatch.setattr(batching.torch, "cat",
                        lambda ts, *a, **k: seen.append(ts) or real(ts, *a,
                                                                    **k))
    assert batching.host_lists(tensors) == want
    assert len(seen) == cats
    assert batching.host_lists([]) == []


def test_spill_drain_never_reaches_the_radix_refcounts():
    """The `PrefixBlockCache.ref` finding the reference pass reports on
    the port: its drain reached the radix cache only through a
    `torch.cuda.stream(side)` call name-resolved to a corpus `stream`
    method. In the port's pass the drain is `domain(drain)` and reaches
    no writer of the refcounts, which run in the serving domain only."""
    from defer_tpu_torch.analysis.domains import DomainMap, infer_domains
    from defer_tpu_torch.analysis.rules import Context, Module

    path = REPO / "defer_tpu_torch/runtime/paged.py"
    src = path.read_text()
    tree = ast.parse(src)
    graph = CallGraph()
    graph.add_module(str(path), tree)
    ctx = Context([Module(str(path), src, tree)], graph)
    doms = infer_domains(ctx, {str(path): DomainMap(src)})
    by = {f.qualname.split(":")[1]: doms.get(id(f.node), set())
          for f in graph.functions}
    assert by["HostKVSpill._drain_loop"] == {"drain"}
    for name in ("register", "release", "walk", "evict"):
        assert "drain" not in by[f"PrefixBlockCache.{name}"], name
    assert by["PrefixBlockCache.register"] == {"serving"}
    ref = analyze_paths([str(path)], rules=["cross-domain-write"])
    assert ref.findings == []
