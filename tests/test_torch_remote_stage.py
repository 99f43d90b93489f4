"""runtime/remote_stage.py: the reference's compute node, in the port,
on the JAX package's wire.

A JAX-package dispatcher (`dispatch_stage` + `send_activation`) drives a
port worker (`serve_stage(device="cpu")`) and gets the reference stage's
outputs; port chains keep the tail-first contract. Workers run in
threads of the test process (one subprocess run is in
tests/test_torch_cli.py). Weights are the JAX package's random init;
inputs are numpy draws from a fixed seed; everything is float32 on the
CPU, outputs within atol 1e-5 of the reference stage (the packages sum
the same layers in different orders). Accept timeouts are at most 30 s
and every thread is joined with a timeout.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from defer_tpu.graph.partition import partition as jax_partition
from defer_tpu.graph.partition import stage_params as jax_stage_params
from defer_tpu.models import get_model as jax_get_model
from defer_tpu.runtime import remote_stage as jremote
from defer_tpu.runtime import transport as jtransport
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.graph.ir import GraphBuilder, GraphError
from defer_tpu_torch.graph.partition import partition, stage_params
from defer_tpu_torch.graph.serialize import graph_to_json
from defer_tpu_torch.models import get_model
from defer_tpu_torch.runtime import codec
from defer_tpu_torch.runtime.remote_stage import (
    dispatch_stage,
    recv_results,
    send_activation,
    serve_stage,
)
from defer_tpu_torch.runtime.transport import ArrayReceiver, ArraySender

ATOL = 1e-5
TIMEOUT = 30.0
HOST = "127.0.0.1"


class Worker:
    """A port worker session in a thread; `port` is its listen port."""

    def __init__(self, next_port: int, **kwargs):
        self.result: dict = {}
        bound = threading.Event()
        ports: list[int] = []

        def run():
            try:
                self.result["n"] = serve_stage(
                    0, HOST, next_port, listen_host=HOST,
                    accept_timeout_s=TIMEOUT, device="cpu",
                    announce=lambda p: (ports.append(p), bound.set()),
                    **kwargs,
                )
            except BaseException as e:  # relayed to the test
                self.result["error"] = e
                bound.set()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert bound.wait(TIMEOUT)
        self.port = ports[0] if ports else None

    def join(self):
        self.thread.join(timeout=TIMEOUT)
        assert not self.thread.is_alive()
        return self.result


def _collect(receiver, n_out=1):
    got: list = []
    t = threading.Thread(
        target=lambda: got.extend(recv_results(receiver, n_out)), daemon=True
    )
    t.start()
    return got, t


@pytest.fixture(scope="module")
def bert():
    jmodel = jax_get_model("bert_tiny", seq_len=16)
    jparams = jmodel.init(jax.random.key(0), batch_size=2)
    return jmodel, jparams


def test_reference_dispatcher_drives_a_port_worker(bert):
    jmodel, jparams = bert
    st0, st1 = jax_partition(jmodel.graph, ["encoder_1_out"])
    p0, p1 = jax_stage_params(jparams, st0), jax_stage_params(jparams, st1)
    results = ArrayReceiver(0, host=HOST, accept_timeout_s=TIMEOUT)
    worker = Worker(results.port)
    got, t = _collect(results)
    send = jtransport.ArraySender(HOST, worker.port)
    jremote.dispatch_stage(send, st1, p1)
    rng = np.random.default_rng(0)
    ids = [rng.integers(0, 128, (2, 16)).astype(np.int32) for _ in range(3)]
    acts = [np.asarray(st0.apply(p0, x)) for x in ids]
    for a in acts:
        jremote.send_activation(send, a)
    send.close()
    assert worker.join() == {"n": 3}
    t.join(timeout=TIMEOUT)
    results.close()
    assert len(got) == 3
    assert results.schemes == {(1,): 3}
    for a, out in zip(acts, got):
        np.testing.assert_allclose(
            out.numpy(), np.asarray(st1.apply(p1, a)), atol=ATOL
        )


def test_port_dispatcher_drives_a_reference_worker(bert):
    """The other way round: the port ships a stage (JSON + weights as
    tensors) to the JAX package's worker."""
    jmodel, jparams = bert
    st0, st1 = partition(
        get_model("bert_tiny", seq_len=16).graph, ["encoder_2_out"]
    )
    params = params_from_jax(jparams, device="cpu")
    results = ArrayReceiver(0, host=HOST, accept_timeout_s=TIMEOUT)
    ports, bound, res = [], threading.Event(), {}

    def run():
        res["n"] = jremote.serve_stage(
            0, HOST, results.port, listen_host=HOST,
            accept_timeout_s=TIMEOUT,
            announce=lambda p: (ports.append(p), bound.set()),
        )

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert bound.wait(TIMEOUT)
    got, t = _collect(results)
    send = ArraySender(HOST, ports[0])
    dispatch_stage(send, st1, stage_params(params, st1))
    ids = torch.from_numpy(
        np.random.default_rng(1).integers(0, 128, (2, 16)).astype(np.int32)
    )
    with torch.inference_mode():
        act = st0.apply(params, ids)
        want = st1.apply(params, act)
    send_activation(send, act)
    send.close()
    th.join(timeout=TIMEOUT)
    t.join(timeout=TIMEOUT)
    results.close()
    assert res == {"n": 1} and len(got) == 1
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), atol=ATOL)


def _skip_graph():
    gb = GraphBuilder("skip")
    v = gb.input()
    h_prev = gb.add("dense", v, name="h0", features=16)
    h = gb.add("dense", h_prev, name="h1", features=16)
    for i in range(2, 6):
        nxt = gb.add("add", h, h_prev, name=f"mix{i}")
        nxt = gb.add("dense", nxt, name=f"h{i}", features=16)
        h_prev, h = h, nxt
    return gb.build(gb.add("dense", h, name="head", features=4))


def _inputs(n, shape=(2, 16)):
    rng = np.random.default_rng(2)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(n)]


def test_two_worker_chain_dispatched_tail_first():
    """Driver -> worker A (stage 1, a bundle in and out) -> worker B
    (stage 2) -> driver: the reference's node chain, tail-first."""
    g = _skip_graph()
    params = g.init(torch.Generator().manual_seed(0), (2, 16))
    st0, st1, st2 = partition(g, [("h2", "h1"), ("h4", "h3")])
    results = ArrayReceiver(0, host=HOST, accept_timeout_s=TIMEOUT)
    b = Worker(results.port, expect_activation_peer=True)
    sb = ArraySender(HOST, b.port)
    dispatch_stage(sb, st2, stage_params(params, st2))
    sb.close()  # B's dispatch stream ends; its activations come from A
    a = Worker(b.port)
    got, t = _collect(results)
    sa = ArraySender(HOST, a.port)
    dispatch_stage(sa, st1, stage_params(params, st1))
    xs = _inputs(4)
    for x in xs:
        send_activation(sa, st0.apply(params, x))
    sa.close()
    assert a.join() == {"n": 4} and b.join() == {"n": 4}
    t.join(timeout=TIMEOUT)
    results.close()
    assert len(got) == 4
    for x, out in zip(xs, got):
        torch.testing.assert_close(out, g.apply(params, x), rtol=0, atol=ATOL)


def test_head_first_dispatch_raises_graph_error():
    """Dispatching the head first lets its activation stream reach the
    tail worker before the tail's dispatch: the tail refuses it with the
    ordering contract in its error."""
    g = _skip_graph()
    params = g.init(torch.Generator().manual_seed(0), (2, 16))
    _, st1, _ = partition(g, [("h2", "h1"), ("h4", "h3")])
    results = ArrayReceiver(0, host=HOST, accept_timeout_s=TIMEOUT)
    tail = Worker(results.port)
    head = Worker(tail.port)
    s = ArraySender(HOST, head.port)
    dispatch_stage(s, st1, stage_params(params, st1))
    send_activation(s, (torch.ones(2, 16), torch.ones(2, 16)))
    s.close()
    err = tail.join().get("error")
    assert isinstance(err, GraphError) and "tail-first" in str(err)
    head.join()
    results.close()


def test_handoff_without_peer_exits_or_raises():
    g = _skip_graph()
    params = g.init(torch.Generator().manual_seed(0), (2, 16))
    st = partition(g, [("h2", "h1")])[1]
    for expect in (False, True):
        results = ArrayReceiver(0, host=HOST, accept_timeout_s=TIMEOUT)
        w = Worker(results.port, handoff_timeout_s=0.3,
                   expect_activation_peer=expect)
        s = ArraySender(HOST, w.port)
        dispatch_stage(s, st, stage_params(params, st))
        s.close()
        res = w.join()
        results.close()
        if expect:
            assert "expected an upstream activation peer" in str(res["error"])
        else:
            assert res == {"n": 0}


def test_weights_go_lossless_on_a_quantized_link():
    g = _skip_graph()
    params = g.init(torch.Generator().manual_seed(0), (2, 16))
    st0, st1 = partition(g, [("h2", "h1")])
    results = ArrayReceiver(0, host=HOST, accept_timeout_s=TIMEOUT)
    w = Worker(results.port)
    got, t = _collect(results)
    s = ArraySender(HOST, w.port, quantize="int8")
    dispatch_stage(s, st1, stage_params(params, st1))
    assert s.quantize == "int8"
    x = _inputs(1)[0]
    act = st0.apply(params, x)
    send_activation(s, act)
    s.close()
    w.join()
    t.join(timeout=TIMEOUT)
    results.close()
    # Only the activations were quantized: the weights arrived exact.
    want = st1.apply(params, tuple(
        codec.decode(codec.encode(a, quantize="int8")) for a in act
    ))
    torch.testing.assert_close(got[0], want, rtol=0, atol=ATOL)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the worker uses it")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_stage(0, HOST, 1, listen_host=HOST, accept_timeout_s=1.0)


def test_truncated_dispatch_errors_cleanly():
    results = ArrayReceiver(0, host=HOST, accept_timeout_s=TIMEOUT)
    w = Worker(results.port)
    s = ArraySender(HOST, w.port)
    s.send(np.frombuffer(graph_to_json(_skip_graph()).encode(), np.uint8))
    s.close()
    assert "fully dispatched" in str(w.join()["error"])
    results.close()
