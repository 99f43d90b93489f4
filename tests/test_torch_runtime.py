"""defer_tpu_torch's runtime around the stage chain, on the CPU: the
windowed retire, the stream loop's batching, recovery, probing and
metrics, each held to what the JAX package's runtime does (its own
tests: tests/test_sync.py, tests/test_batching.py, tests/test_api.py).
Float32 throughout; outputs are compared with the unpartitioned graph
at atol = rtol = 1e-5.
"""

import queue
import threading

import numpy as np
import pytest
import torch

from defer_tpu_torch import DEFER, DeferConfig, GraphBuilder, obs
from defer_tpu_torch.models import get_model
from defer_tpu_torch.ops.registry import op_names, register_op
from defer_tpu_torch.parallel.pipeline import Pipeline
from defer_tpu_torch.runtime.batching import BatchGatherer, split_output
from defer_tpu_torch.utils.sync import (
    Pending,
    Retirer,
    hard_sync,
    hard_sync_timeout,
)

CPU = torch.device("cpu")
F32 = DeferConfig(compute_dtype=torch.float32)
TOL = dict(atol=1e-5, rtol=1e-5)


class FakeFuture:
    def __init__(self, ready=False):
        self._ready = ready

    def is_ready(self):
        return self._ready


def test_retirer_ready_prefix_and_pressure():
    done = [FakeFuture(True), FakeFuture(True), FakeFuture(False)]
    r = Retirer(depth=10, sync=lambda a: None)
    out = []
    for f in done:
        out.extend(r.add(f))
    assert out == done[:2] and list(r.pending) == [done[2]]

    synced = []
    r = Retirer(depth=4, sync=synced.append)
    futs = [FakeFuture(False) for _ in range(4)]
    out = []
    for f in futs:
        out.extend(r.add(f))
    # At depth, one barrier on the middle of the window retires the
    # prefix through the synced item.
    assert synced == [futs[2]]
    assert out == futs[:3] and list(r.pending) == [futs[3]]
    assert r.flush() == [futs[3]] and r.flush() == []


def test_retirer_spills_completed_work_on_a_failed_barrier():
    a, b, c, d = FakeFuture(True), FakeFuture(), FakeFuture(), FakeFuture()

    def failing(target):
        raise TimeoutError("stuck")

    r = Retirer(depth=2, sync=failing)
    r.pending.extend([a, b, c])
    with pytest.raises(TimeoutError):
        r.add(d)  # retires `a`, then the barrier on `c` raises
    assert r.collect() == [a]  # the completed prefix was parked, not lost
    b._ready = True
    assert r.collect() == [b]
    assert r.discard() == 2 and len(r) == 0


def test_pending_on_cpu_is_ready_and_timeout_polls():
    p = Pending(torch.ones(3))
    assert p.event is None and p.is_ready()
    hard_sync(p, (torch.zeros(2), torch.zeros(1)))
    assert hard_sync_timeout(p, 0.0) is True
    assert hard_sync_timeout(torch.zeros(2), 0.0) is True
    assert hard_sync_timeout(FakeFuture(False), 0.01) is False


def test_gatherer_stacks_and_split_inverts():
    q: "queue.Queue" = queue.Queue()
    items = [torch.full((1, 3), float(i)) for i in range(3)]
    for x in items:
        q.put(x)
    q.put(None)
    g = BatchGatherer(batch_size=8, max_wait_s=0.5)
    batch, sizes, eos = g.gather(q)
    assert eos and sizes == [1, 1, 1]
    assert batch.shape == (3, 3)  # no pad rows: eager torch needs none
    parts = split_output(batch, sizes)
    for x, part in zip(items, parts):
        torch.testing.assert_close(part, x)


def _stream(defer, model, cuts, params, inputs, timeout=60):
    in_q: "queue.Queue" = queue.Queue()
    out_q: "queue.Queue" = queue.Queue()
    for x in inputs:
        in_q.put(x)
    in_q.put(None)
    t = threading.Thread(
        target=defer.run_defer,
        args=(model, cuts, in_q, out_q),
        kwargs={"params": params},
        daemon=True,
    )
    t.start()
    outs = [out_q.get(timeout=timeout) for _ in inputs]
    t.join(timeout=timeout)
    assert not t.is_alive()
    return outs


@pytest.fixture(scope="module")
def tiny():
    model = get_model("bert_tiny", seq_len=8)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.integers(0, 128, (1, 8))) for _ in range(6)]
    return model, params, xs


def test_dynamic_batching_end_to_end(tiny, monkeypatch):
    model, params, xs = tiny
    dispatched = []
    orig = Pipeline.submit

    def counting(self, x):
        dispatched.append(int(x.shape[0]))
        return orig(self, x)

    monkeypatch.setattr(Pipeline, "submit", counting)
    cfg = F32.replace(dynamic_batch_size=4, batch_wait_s=0.2)
    outs = _stream(DEFER(devices=[CPU], config=cfg), model,
                   ["encoder_1_out"], params, xs)
    for x, out in zip(xs, outs):
        np.testing.assert_allclose(
            out.numpy(), model.graph.apply(params, x).numpy(), **TOL
        )
    assert len(dispatched) < len(xs) and max(dispatched) == 4


def test_probe_and_metrics(tiny):
    model, params, xs = tiny
    reg = obs.get_registry()
    before = {
        n: reg.value(n) or 0
        for n in ("defer_pipeline_microbatches_total",
                  "defer_stream_items_total")
    }
    defer = DEFER(devices=[CPU], config=F32.replace(probe_every=2))
    _stream(defer, model, ["encoder_0_out", "encoder_2_out"], params, xs)
    lat = defer.last_stage_latencies
    assert [s["stage"] for s in lat] == [0, 1, 2]
    assert all(s["p50_s"] > 0 for s in lat)
    assert reg.value("defer_stream_items_total") - before[
        "defer_stream_items_total"] == len(xs)
    assert reg.value("defer_pipeline_microbatches_total") - before[
        "defer_pipeline_microbatches_total"] >= len(xs)
    text = reg.to_prometheus()
    assert "# TYPE defer_stream_items_total counter" in text
    assert "defer_stage_p50_seconds{stage=\"2\"}" in text


FLAKY = {"failures": 0}


def _flaky_graph():
    if "flaky" not in op_names():

        @register_op("flaky")
        def flaky_apply(params, inputs, attrs):
            if FLAKY["failures"] > 0:
                FLAKY["failures"] -= 1
                raise RuntimeError("transient stage failure")
            return inputs[0]

    b = GraphBuilder("flaky_chain")
    x = b.input("x")
    h = b.add("dense", x, features=8)
    h = b.add("flaky", h)
    h = b.add("tanh", h)
    return b.build(b.add("dense", h, features=4))


def test_redispatch_recovers_from_a_stage_failure():
    g = _flaky_graph()
    params = g.init(torch.Generator().manual_seed(0), (2, 6))
    xs = [torch.full((2, 6), float(i)) for i in range(4)]
    reg = obs.get_registry()
    before = reg.value("defer_redispatch_total") or 0
    FLAKY["failures"] = 1
    outs = _stream(DEFER(devices=[CPU], config=F32), g, ["flaky"],
                   params, xs)
    assert (reg.value("defer_redispatch_total") or 0) == before + 1
    for x, out in zip(xs, outs):
        np.testing.assert_allclose(
            out.numpy(), g.apply(params, x).numpy(), **TOL
        )


def test_stop_unblocks_run_defer(tiny):
    model, params, xs = tiny
    defer = DEFER(devices=[CPU], config=F32)
    in_q: "queue.Queue" = queue.Queue()
    out_q: "queue.Queue" = queue.Queue()
    t = threading.Thread(
        target=defer.run_defer,
        args=(model, ["encoder_1_out"], in_q, out_q),
        kwargs={"params": params},
        daemon=True,
    )
    t.start()
    in_q.put(xs[0])
    out_q.get(timeout=60)
    defer.stop()
    t.join(timeout=30)
    assert not t.is_alive()


def test_pipeline_throughput_on_cpu(tiny):
    model, params, xs = tiny
    pipe, _ = DEFER(devices=[CPU], config=F32).build_pipeline(
        model, ["encoder_1_out"], params=params
    )
    res = pipe.throughput(xs[0], num_microbatches=3)
    assert res["microbatches"] == 3 and res["items_per_sec"] > 0
    outs = list(pipe.stream(xs, max_inflight=2))
    for x, out in zip(xs, outs):
        np.testing.assert_allclose(
            out.numpy(), model.graph.apply(params, x).numpy(), **TOL
        )


def test_run_local_inference_on_cpu(tiny):
    from defer_tpu_torch import run_local_inference

    model, params, xs = tiny
    res = run_local_inference(model, params=params, duration_s=0.2,
                              compute_dtype=torch.float32, example=xs[0],
                              device=CPU)
    assert res["count"] >= 1 and res["items_per_sec"] > 0
