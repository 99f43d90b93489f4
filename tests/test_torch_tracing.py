"""The stream path's host-time counters and spans (utils/profiling.py,
`Pipeline.__call__`, `DEFER._stream_loop`), on the CPU.

`run_defer` streams a two-stage dense chain cut at `tanh`. A card is
stood in for by results that complete a few ms after they were enqueued
(`LatePending`), so that the `Retirer` takes real barriers: on the CPU
every result is ready at once and the stream thread would never wait on
the card. The counters must grow at every boundary; the spans must be
kept only while recording, nest stage under microbatch, and share the
profiler's clock in the Chrome trace `trace()` writes.
"""

import json
import queue
import threading
import time

import pytest
import torch

from defer_tpu_torch import DEFER, DeferConfig, GraphBuilder, obs
from defer_tpu_torch.parallel import pipeline
from defer_tpu_torch.utils import profiling
from defer_tpu_torch.utils.profiling import SPANS, annotate
from defer_tpu_torch.utils.sync import Pending

CPU = torch.device("cpu")
N = 6
STAGE = "defer_stage_host_seconds_total"
WAIT = "defer_stream_wait_seconds_total"
MICROBATCHES = "defer_pipeline_microbatches_total"


class LatePending(Pending):
    """A result that completes `LATE_S` after it was enqueued."""

    LATE_S = 0.003

    def __init__(self, value):
        super().__init__(value)
        self.due = time.perf_counter() + self.LATE_S

    def is_ready(self):
        return time.perf_counter() >= self.due


@pytest.fixture
def late_card(monkeypatch):
    monkeypatch.setattr(pipeline, "Pending", LatePending)


@pytest.fixture(scope="module")
def chain():
    b = GraphBuilder("two_stage")
    h = b.add("dense", b.input("x"), features=8)
    g = b.build(b.add("dense", b.add("tanh", h), features=4))
    return g, g.init(torch.Generator().manual_seed(0), (2, 6))


def _config(gather):
    extra = {"dynamic_batch_size": 4, "batch_wait_s": 0.001} if gather else {}
    return DeferConfig(compute_dtype=torch.float32, max_inflight=2, **extra)


def _stream(chain, gather=False, gap_s=0.0, before_feed=None):
    """run_defer over N inputs put `gap_s` apart, after one warm-up item
    whose result is taken first; `before_feed` runs between the two.
    Returns the outputs of the N."""
    g, params = chain
    in_q: "queue.Queue" = queue.Queue()
    out_q: "queue.Queue" = queue.Queue()
    t = threading.Thread(
        target=DEFER(devices=[CPU], config=_config(gather)).run_defer,
        args=(g, ["tanh"], in_q, out_q), kwargs={"params": params},
        daemon=True,
    )
    t.start()
    in_q.put(torch.zeros(2, 6))
    out_q.get(timeout=60)
    if before_feed is not None:
        before_feed()
    for i in range(N):
        if gap_s:
            time.sleep(gap_s)
        in_q.put(torch.full((2, 6), float(i)))
    outs = [out_q.get(timeout=60) for _ in range(N)]
    in_q.put(None)
    t.join(timeout=60)
    assert not t.is_alive()
    return outs


def _grown(d, name, **labels):
    return d.get(obs.export.sample_name(name, labels), 0)


@pytest.mark.parametrize("gather", [False, True], ids=["queue", "gather"])
def test_every_boundary_counts(chain, late_card, gather):
    with obs.counter_deltas() as d:
        outs = _stream(chain, gather)
    assert len(outs) == N
    for stage in ("0", "1"):
        for phase in ("place", "launch"):
            assert _grown(d, STAGE, stage=stage, phase=phase) > 0
    assert _grown(d, WAIT, on="input") > 0
    assert _grown(d, WAIT, on="card") > 0
    # The warm-up item is one more; a gatherer may merge the rest.
    n = _grown(d, MICROBATCHES)
    assert n == N + 1 if not gather else 2 <= n <= N + 1


@pytest.mark.parametrize("gather", [False, True], ids=["queue", "gather"])
def test_starved_input_is_counted_as_input_wait(chain, gather):
    """Inputs 20 ms apart: the stream thread waits for each."""
    snap = {}

    def mark():
        snap["input"] = obs.get_registry().value(WAIT, on="input")
        snap["n"] = obs.get_registry().value(MICROBATCHES)

    _stream(chain, gather, gap_s=0.02, before_feed=mark)
    reg = obs.get_registry()
    waited = reg.value(WAIT, on="input") - snap["input"]
    assert reg.value(MICROBATCHES) - snap["n"] >= 1
    assert waited / N >= 0.015


@pytest.mark.parametrize("name", ["defer:submit", "defer:stage0"])
def test_recording_off_keeps_no_span(chain, late_card, name):
    SPANS.stop()
    assert annotate(name) is annotate("other")  # the shared no-op
    _stream(chain)
    with annotate(name):
        pass
    assert SPANS.stop() == []


def test_recording_on_nests_stages_under_their_microbatch(chain, late_card):
    SPANS.start()
    try:
        _stream(chain)
    finally:
        spans = SPANS.stop()
    by_id = {s.span_id: s for s in spans}
    names = {s.name for s in spans}
    assert {"defer:submit", "defer:stage0", "defer:stage1", "defer:place",
            "defer:launch", "defer:input_wait", "defer:card_wait"} <= names
    submits = [s for s in spans if s.name == "defer:submit"]
    assert len({s.seq for s in submits}) == len(submits) >= N
    stages = [s for s in spans if s.name.startswith("defer:stage")]
    assert len(stages) == 2 * len(submits)
    for s in stages:
        parent = by_id[s.parent]
        assert parent.name == "defer:submit" and s.seq == parent.seq
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert s.thread == parent.thread
    for s in spans:
        if s.name in ("defer:place", "defer:launch"):
            parent = by_id[s.parent]
            assert parent.name.startswith("defer:stage")
            assert s.seq == parent.seq


def _events(path, name):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("name") == name and e.get("ph") == "X"]


def _on_row(path, tid, cat):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and e.get("tid") == tid
                and e.get("cat") in cat]


@pytest.mark.parametrize("size", [64, 512])
def test_spans_share_the_profilers_clock(tmp_path, size):
    """A span around a matmul holds the profiler's record of it, on the
    thread's row: the op on the CPU, the kernel's launch call on a card
    (the trace records CUDA activity alone there)."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    a = torch.randn(size, size, device=dev)
    torch.mm(a, a)
    with profiling.trace(str(tmp_path)):
        with annotate("defer:mm"):
            torch.mm(a, a)
    (path,) = tmp_path.glob("trace_*.json")
    (span,) = _events(path, "defer:mm")
    if dev == "cpu":
        assert span["tid"] == threading.get_native_id()
        inner = [e for e in _on_row(path, span["tid"], ("cpu_op",))
                 if e["name"] == "aten::mm"]
    else:
        inner = [e for e in _on_row(path, span["tid"],
                                    ("cuda_runtime", "cuda_driver"))
                 if "Launch" in e["name"]]
    assert inner
    slack = 20.0  # us
    for e in inner:
        assert span["ts"] - slack <= e["ts"]
        assert e["ts"] + e["dur"] <= span["ts"] + span["dur"] + slack
    assert not SPANS.on


def test_env_trace_of_run_defer_holds_the_stream_spans(
    chain, late_card, tmp_path, monkeypatch
):
    monkeypatch.setenv(profiling.TRACE_ENV, str(tmp_path))
    _stream(chain)
    (path,) = tmp_path.glob("trace_*.json")
    stages = _events(path, "defer:stage1")
    submits = {e["args"]["span"]: e for e in _events(path, "defer:submit")}
    assert len(stages) >= N
    for e in stages:
        parent = submits[e["args"]["parent"]]
        assert e["tid"] == parent["tid"]
        assert e["args"]["microbatch"] == parent["args"]["microbatch"]
        assert parent["ts"] <= e["ts"]
    assert not SPANS.on


def _x(cat, tid, ts, dur=1.0):
    return {"ph": "X", "cat": cat, "tid": tid, "ts": ts, "dur": dur}


@pytest.mark.parametrize("recorded,row", [
    ("ops", 4321),  # CPU activity: the thread's native id
    ("cuda", 0x6C801940),  # CUDA calls alone, under CUPTI's id
    ("nothing", 4321),
])
def test_spans_take_the_row_the_profiler_gave_their_thread(recorded, row):
    """Spans of native thread 4321 over [100, 200) and [300, 400) us;
    another thread's CUDA calls (row 55) fall outside them."""
    spans = [_x("defer", 4321, 100.0, 100.0), _x("defer", 4321, 150.0, 10.0),
             _x("defer", 4321, 300.0, 100.0)]
    events = {
        "ops": [_x("cpu_op", 4321, 120.0)],
        "cuda": [_x("cuda_runtime", 0x6C801940, t) for t in (110, 155, 310)]
        + [_x("cuda_runtime", 55, t) for t in (20, 250, 390)],
        "nothing": [_x("kernel", 7, 120.0)],
    }[recorded]
    assert profiling._rows(events, spans) == {4321: row}
