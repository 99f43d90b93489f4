"""The port's disaggregated prefill/decode serving (defer_tpu_torch/disagg/,
PagedDecodeServer.submit_prefilled/deliver_kv) against the JAX package's.

The wire is the JAX package's: the same dispatch and result streams
(hello, decoder, params, prefill requests, KV payloads) must be the same
bytes on a loopback socket for the same arrays, lossless and int8. A
`defer_tpu` prefill worker must feed a `defer_tpu_torch` decode host and
a `defer_tpu_torch` worker a `defer_tpu` host, both over loopback, with
the JAX package's tokens. `serve_disagg` must give the JAX package's
tokens with the same knobs and `serve_paged`'s (fp pools; the int8 pool
against JAX's int8 split), over attention x prefix_cache x window x
speculation. Ingest refuses a wrong wire version and a wrong geometry,
and a worker that drops its session mid-stream is replaced. Float32 on
the CPU (the JAX codec writes a bfloat16 array's frame as '<V2', which
the port refuses by name; tests/test_torch_codec.py), every socket
timeout at most 30 s.
"""

import os
import queue
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.disagg import api as japi
from defer_tpu.disagg import prefill_worker as jworker
from defer_tpu.disagg import wire as jwire
from defer_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from defer_tpu.runtime import transport as jtransport
from defer_tpu.runtime.paged import serve_paged as jax_serve_paged
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.disagg import IngestError, KVBlockIngest, wire
from defer_tpu_torch.disagg import prefill_worker as worker
from defer_tpu_torch.disagg.api import serve_disagg, thread_worker_spawner
from defer_tpu_torch.models.gpt import tiny_gpt
from defer_tpu_torch.runtime import transport
from defer_tpu_torch.runtime.paged import PagedDecodeServer, serve_paged

CPU = torch.device("cpu")
KNOBS = dict(num_blocks=32, block_size=4, max_batch=2)
TIMEOUTS = dict(accept_timeout_s=30.0, read_timeout_s=30.0,
                connect_timeout_s=30.0)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_jax_runs: dict = {}


@pytest.fixture(scope="module")
def model():
    jdec = jax_tiny_gpt(64)
    jparams = jdec.init(jax.random.key(0))
    return (tiny_gpt(64, device=CPU), params_from_jax(jparams, CPU), jdec,
            jparams)


def _requests():
    """A shared 8-token prefix on the first two (radix hits), a prompt
    across a block boundary, a one-token prompt."""
    rng = np.random.default_rng(21)
    base = rng.integers(1, 128, size=(1, 8))
    return [(base, 6),
            (np.concatenate([base, rng.integers(1, 128, (1, 3))], 1), 5),
            (rng.integers(1, 128, size=(1, 5)), 7),
            (rng.integers(1, 128, size=(1, 1)), 4)]


def _port_reqs():
    return [(torch.tensor(p), s) for p, s in _requests()]


def _jax_reqs():
    return [(jnp.asarray(p, jnp.int32), s) for p, s in _requests()]


def _same(outs, want, msg=""):
    assert len(outs) == len(want)
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                      err_msg=msg)


def _jax_disagg(model, **knobs):
    key = repr(sorted(knobs.items()))
    if key not in _jax_runs:
        _, _, jdec, jparams = model
        outs, stats = japi.serve_disagg(jdec, jparams, _jax_reqs(),
                                        **TIMEOUTS, **knobs)
        _jax_runs[key] = ([np.asarray(o) for o in outs], stats)
    return _jax_runs[key]


# -- the wire -----------------------------------------------------------------

def _captured(send, sender_cls, **sender_kw) -> bytes:
    """Every byte one sender of `sender_cls` writes for `send(sender)`
    (then its STOP frame), read off a raw loopback socket."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(30)
    got = queue.Queue()

    def read():
        conn, _ = srv.accept()
        conn.settimeout(30)
        buf = b""
        while chunk := conn.recv(1 << 16):
            buf += chunk
        conn.close()
        got.put(buf)

    t = threading.Thread(target=read, daemon=True)
    t.start()
    sender = sender_cls("127.0.0.1", srv.getsockname()[1],
                        connect_timeout_s=30.0, **sender_kw)
    send(sender)
    sender.close()
    t.join(30)
    srv.close()
    return got.get(timeout=1)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_wire_streams_are_the_jax_bytes(model, quantize):
    dec, params, jdec, jparams = model
    rng = np.random.default_rng(4)
    k = rng.standard_normal((4, 3, 4, 4, 16)).astype(np.float32)
    v = rng.standard_normal((4, 3, 4, 4, 16)).astype(np.float32)
    logits = rng.standard_normal((1, 128)).astype(np.float32)
    prompt = rng.integers(1, 128, size=(1, 9))

    def stream(w, d, p, kv_k, kv_v, kv_l, pr):
        def send(sender):
            w.send_hello(sender, result_host="127.0.0.1", result_port=5,
                         block_size=4, chunk_len=3)
            w.send_blob(sender, {"kind": "decoder",
                                 "version": w.WIRE_VERSION,
                                 **w.decoder_to_wire(d)})
            w.send_params(sender, p)
            w.send_prefill_request(sender, 7, pr)
            w.send_kv_payload(sender, w.KVPayload(
                rid=7, t0=9, k=kv_k, v=kv_v, logits=kv_l))
        return send

    port = _captured(
        stream(wire, dec, params, torch.from_numpy(k), torch.from_numpy(v),
               torch.from_numpy(logits), torch.from_numpy(prompt)),
        transport.ArraySender, quantize=quantize)
    ref = _captured(stream(jwire, jdec, jparams, k, v, logits, prompt),
                    jtransport.ArraySender, quantize=quantize)
    assert len(port) > 10_000 and port == ref


def test_wire_reads_both_ways(model):
    """A payload framed by either package reads back in the other, the
    int8 K/V frames decoded alike."""
    rng = np.random.default_rng(5)
    k = rng.standard_normal((2, 2, 4, 4, 16)).astype(np.float32)
    for send_mod, send_cls, recv_mod, recv_cls in (
        (wire, transport.ArraySender, jwire, jtransport.ArrayReceiver),
        (jwire, jtransport.ArraySender, wire, transport.ArrayReceiver),
    ):
        recv = recv_cls(0, host="127.0.0.1", accept_timeout_s=30.0,
                        read_timeout_s=30.0)
        out = queue.Queue()
        t = threading.Thread(target=lambda: out.put(
            list(recv_mod.iter_kv_payloads(recv))), daemon=True)
        t.start()
        sender = send_cls("127.0.0.1", recv.port, quantize="int8",
                          connect_timeout_s=30.0)
        send_mod.send_kv_payload(sender, send_mod.KVPayload(
            rid=3, t0=7, k=k, v=k * 2, logits=k[0, 0, 0, :1, :]))
        sender.close()
        (got,) = out.get(timeout=30)
        recv.close()
        assert (got.rid, got.t0, got.quantized) == (3, 7, True)
        err = np.abs(np.asarray(got.k, np.float64) - k).max()
        assert err <= np.abs(k).max() / 127  # one int8 step
        np.testing.assert_array_equal(np.asarray(got.logits),
                                      k[0, 0, 0, :1, :])


def test_run_prefill_matches_jax(model):
    """The worker's blocks and logits row against the JAX worker's, on
    the same weights, plain and chunked (f32: within 1e-5)."""
    dec, params, jdec, jparams = model
    prompt = np.random.default_rng(6).integers(1, 128, size=(1, 11))
    for chunk in (None, 4):
        got = worker.run_prefill(dec, params, prompt, block_size=4,
                                 chunk_len=chunk)
        want = jworker.run_prefill(jdec, jparams, prompt, block_size=4,
                                   chunk_len=chunk)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
    assert worker.prefill_schedule(11, 4) == jworker.prefill_schedule(11, 4)


# -- serving ----------------------------------------------------------------------

@pytest.mark.parametrize(
    "attention,prefix_cache,window,spec,kv_dtype",
    [("gathered", False, 1, 0, "fp"), ("pallas", True, 1, 0, "fp"),
     ("pallas", True, 4, 0, "int8"), ("gathered", True, 1, 3, "fp"),
     ("pallas", False, 4, 3, "fp")],
)
def test_serve_disagg_matches_jax_and_serve_paged(
        model, attention, prefix_cache, window, spec, kv_dtype):
    dec, params, jdec, jparams = model
    knobs = dict(KNOBS, prefix_cache=prefix_cache, decode_window=window,
                 kv_dtype=kv_dtype)
    jspec = pspec = {}
    if spec:
        pspec = dict(spec_k=spec, spec_draft=dec, spec_params=params)
        jspec = dict(spec_k=spec, spec_draft=jdec, spec_params=jparams)
    outs, stats = serve_disagg(dec, params, _port_reqs(), attention=attention,
                               **TIMEOUTS, **pspec, **knobs)
    jatt = "blockwise" if attention == "pallas" else attention
    jouts, jstats = _jax_disagg(model, attention=jatt, **jspec, **knobs)
    msg = f"{attention} prefix_cache={prefix_cache} K={window} spec={spec}"
    _same(outs, jouts, msg)
    if kv_dtype == "fp":
        mono, _ = serve_paged(dec, params, _port_reqs(), attention=attention,
                              **pspec, **knobs)
        _same(outs, mono, msg)
    # The same frames of arrays that differ in their last bits (each
    # package's f32 prefill): zstd packs them to within a few bytes.
    assert stats["kv_bytes_recv"] == pytest.approx(jstats["kv_bytes_recv"],
                                                   rel=1e-2)
    # Admissions follow the payloads' arrival, so tick counts are the
    # run's own; what the pool ends up caching is not.
    for key in ("worker_restarts", "cached_blocks", "spec_k"):
        assert stats[key] == jstats[key], (key, msg)
    assert stats["disagg"] and stats["ingest_ms"] > 0


def test_jax_worker_feeds_the_port_host(model):
    dec, params, _, _ = model

    def spawn():
        ports = queue.Queue()
        threading.Thread(target=jworker.serve_prefill, kwargs=dict(
            listen_port=0, announce=ports.put, accept_timeout_s=30.0,
            read_timeout_s=30.0), daemon=True).start()
        return "127.0.0.1", ports.get(timeout=30)

    outs, stats = serve_disagg(dec, params, _port_reqs(), spawn_worker=spawn,
                               prefix_cache=True, attention="pallas",
                               **TIMEOUTS, **KNOBS)
    jouts, _ = _jax_disagg(model, prefix_cache=True, attention="blockwise",
                           **KNOBS)
    _same(outs, jouts)
    assert stats["kv_bytes_recv"] > 0


def test_port_worker_feeds_the_jax_host(model):
    _, _, jdec, jparams = model
    spawn = thread_worker_spawner(device="cpu", accept_timeout_s=30.0,
                                  read_timeout_s=30.0)
    outs, stats = japi.serve_disagg(jdec, jparams, _jax_reqs(),
                                    spawn_worker=spawn, **TIMEOUTS, **KNOBS)
    want, _ = jax_serve_paged(jdec, jparams, _jax_reqs(), **KNOBS)
    _same(outs, want)
    assert stats["kv_bytes_recv"] > 0


def test_the_worker_cli_serves_a_session(model):
    """`python -m defer_tpu_torch.disagg.prefill_worker` as a process:
    it announces its port, serves the session, reports DONE."""
    dec, params, _, _ = model
    proc = subprocess.Popen(
        [sys.executable, "-m", "defer_tpu_torch.disagg.prefill_worker",
         "--listen", "0", "--listen-host", "127.0.0.1", "--device", "cpu",
         "--accept-timeout", "30", "--read-timeout", "30"],
        cwd=ROOT, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("LISTENING "), line
        port = int(line.split()[1])
        outs, _ = serve_disagg(dec, params, _port_reqs(),
                               spawn_worker=lambda: ("127.0.0.1", port),
                               **TIMEOUTS, **KNOBS)
        assert proc.stdout.readline().strip() == f"DONE {len(outs)}"
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    mono, _ = serve_paged(dec, params, _port_reqs(), **KNOBS)
    _same(outs, mono)


# -- ingest errors ----------------------------------------------------------------

def _ingest_of(model):
    """A decode server with one prefilled request (rid 0, a 9-token
    prompt) and an ingest on a fresh receiver, its drain thread
    started."""
    dec, params, _, _ = model
    srv = PagedDecodeServer(dec, params, **KNOBS)
    rid = srv.submit_prefilled(np.arange(1, 10)[None], 3)
    recv = transport.ArrayReceiver(0, host="127.0.0.1",
                                   accept_timeout_s=30.0,
                                   read_timeout_s=30.0)
    ingest = KVBlockIngest(srv, recv)
    ingest.start()
    sender = transport.ArraySender("127.0.0.1", recv.port,
                                   connect_timeout_s=30.0)
    return srv, rid, recv, ingest, sender


def test_ingest_refuses_a_wrong_version(model):
    srv, rid, recv, ingest, sender = _ingest_of(model)
    wire.send_blob(sender, {"kind": "kv", "version": 99, "rid": rid})
    sender.close()
    assert ingest.failed.wait(30)
    assert isinstance(ingest.error, transport.TransportError)
    assert "wire version 99" in str(ingest.error)
    ingest.close()
    recv.close()


def test_ingest_refuses_a_wrong_geometry(model):
    srv, rid, recv, ingest, sender = _ingest_of(model)
    bad = torch.zeros((4, 2, 4, 4, 16))  # 2 blocks for a 9-token prompt
    wire.send_kv_payload(sender, wire.KVPayload(
        rid=rid, t0=9, k=bad, v=bad, logits=torch.zeros((1, 128))))
    sender.close()
    assert ingest.failed.wait(30)
    with pytest.raises(IngestError, match="geometry"):
        ingest.pump()
    ingest.close()
    recv.close()
    with pytest.raises(ValueError, match="KV block stack shape"):
        srv.deliver_kv(rid, bad, bad, torch.zeros((1, 128)))


def test_a_dropped_session_is_replaced(model):
    """Workers that drop their session after one payload: serve_disagg
    replaces them and re-requests what was not delivered; with no
    retries left it raises."""
    dec, params, _, _ = model
    spawn = thread_worker_spawner(device="cpu", fail_after_requests=1,
                                  accept_timeout_s=30.0,
                                  read_timeout_s=30.0)
    outs, stats = serve_disagg(dec, params, _port_reqs(), spawn_worker=spawn,
                               worker_retries=5, **TIMEOUTS, **KNOBS)
    assert stats["worker_restarts"] >= 1
    _same(outs, serve_paged(dec, params, _port_reqs(), **KNOBS)[0])
    with pytest.raises(transport.TransportError, match="restart"):
        serve_disagg(dec, params, _port_reqs(), spawn_worker=spawn,
                     worker_retries=0, **TIMEOUTS, **KNOBS)
