"""`serve_disagg()`: disaggregated prefill/decode serving, one call.

Counterpart of `defer_tpu/disagg/api.py`. Runs a `PagedDecodeServer`
locally and ships every request's prefill to a prefill worker
(`disagg/prefill_worker.py`) over the transport seam; finished KV blocks
stream back through `disagg/ingest.py` straight into the paged pool.
Greedy outputs are token-identical to monolithic `serve_paged` (the
worker's default prefill schedule is the monolithic admission's), and
with `prefix_cache=True` ingested blocks register in the radix cache, so
requests prefilled on another host seed local prefix sharing.

Session lifecycle (each step unblocks the next):

    1. bind the result receiver (ephemeral port)
    2. start the ingest drain thread (it owns the blocking accept)
    3. start the worker (it binds and announces its dispatch port)
    4. dispatch hello/decoder/params and every request
    5. decode loop: pump ingest -> admit -> tick
    6. worker death mid-stream: drop the peer, start a fresh worker,
       re-dispatch the undelivered tail (at most `worker_retries` times)

The default worker is an in-process thread on the decode server's
device. Pass `spawn_worker` to place it anywhere else (another process
or host): it returns (host, port) of a listening `serve_prefill`, of
either package (the wire is the JAX package's, byte for byte).
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Any

from defer_tpu_torch.disagg import wire
from defer_tpu_torch.disagg.ingest import IngestError, KVBlockIngest
from defer_tpu_torch.disagg.prefill_worker import serve_prefill
from defer_tpu_torch.obs.serving import DisaggMetrics, ServerStats
from defer_tpu_torch.runtime.paged import PagedDecodeServer, server_stats
from defer_tpu_torch.runtime.transport import (
    ArrayReceiver,
    ArraySender,
    TransportError,
)
from defer_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def thread_worker_spawner(**serve_kwargs):
    """A spawn_worker that runs `serve_prefill` on an in-process daemon
    thread at an ephemeral port; returns ("127.0.0.1", port) once the
    worker listens."""

    def spawn() -> tuple[str, int]:
        ports: "queue_mod.Queue[int]" = queue_mod.Queue()
        t = threading.Thread(
            target=serve_prefill,
            kwargs={"listen_port": 0, "announce": ports.put, **serve_kwargs},
            name="prefill-worker",
            daemon=True,
        )
        t.start()
        return "127.0.0.1", ports.get(timeout=30.0)

    return spawn


class _Session:
    """One worker session: the dispatch sender and its byte count."""

    def __init__(self, host, port, *, result_port, dec, params, block_size,
                 chunk_len, compress, level, quantize, connect_timeout_s):
        self.sender = ArraySender(
            host, port, compress=compress, level=level, quantize=quantize,
            connect_timeout_s=connect_timeout_s,
        )
        self.dispatch_bytes = wire.send_hello(
            self.sender, result_host="127.0.0.1", result_port=result_port,
            block_size=block_size, chunk_len=chunk_len,
        )
        self.dispatch_bytes += wire.send_blob(
            self.sender,
            {"kind": "decoder", "version": wire.WIRE_VERSION,
             **wire.decoder_to_wire(dec)},
        )
        self.dispatch_bytes += wire.send_params(self.sender, params)

    def send_request(self, rid: int, prompt) -> None:
        self.dispatch_bytes += wire.send_prefill_request(
            self.sender, rid, prompt
        )

    def close(self) -> None:
        self.sender.close()


def serve_disagg(
    dec: Any,
    params: dict,
    requests: list,
    *,
    num_blocks: int,
    block_size: int = 16,
    max_batch: int = 4,
    eos_id: int | None = None,
    prefix_cache: bool = False,
    attention: str = "gathered",
    kv_dtype: str = "fp",
    decode_window: int = 1,
    spec_k: int = 0,
    spec_draft: Any = None,
    spec_params: dict | None = None,
    sampling: list | None = None,
    stop: list | None = None,
    quantize: str | None = None,
    compress: bool = True,
    level: int = 3,
    chunk_len: int | None = None,
    worker_retries: int = 1,
    spawn_worker: Any = None,
    server: PagedDecodeServer | None = None,
    accept_timeout_s: float = 60.0,
    read_timeout_s: float | None = 60.0,
    connect_timeout_s: float = 30.0,
    constraints: dict | None = None,
) -> tuple[list, ServerStats]:
    """Disaggregated serving, `serve_paged`'s contract (outputs in
    submission order + stats) with the prefill phase on a worker.
    `quantize="int8"` makes the K/V transfer lossy (codec SCHEME_Q8; the
    logits row stays lossless). `server=` reuses a PagedDecodeServer so
    ingested prefix blocks survive into later local serving.
    `worker_retries` bounds mid-stream worker replacements. `spec_k > 0`
    speculates on the decode side (each admission re-prefills the
    draft lane locally); `constraints=` registers grammars on the decode
    side (the worker ships plain K/V). Stats add the wire's totals:
    `kv_bytes_recv` (per request too), `dispatch_bytes_sent`,
    `ingest_ms` (host ms the server spent seating delivered KV: upload,
    scatter into the pool, first token) and `worker_restarts`."""
    srv = server
    if srv is None:
        srv = PagedDecodeServer(
            dec, params, num_blocks=num_blocks, block_size=block_size,
            max_batch=max_batch, eos_id=eos_id, prefix_cache=prefix_cache,
            attention=attention, kv_dtype=kv_dtype,
            decode_window=decode_window, spec_k=spec_k,
            spec_draft=spec_draft, spec_params=spec_params,
            constraints=constraints,
        )
    samps = sampling or [None] * len(requests)
    stops = stop or [None] * len(requests)
    if len(samps) != len(requests) or len(stops) != len(requests):
        raise ValueError(
            "sampling/stop must have one entry per request when given"
        )
    obs = DisaggMetrics("decode")
    recv = ArrayReceiver(0, host="127.0.0.1",
                         accept_timeout_s=accept_timeout_s,
                         read_timeout_s=read_timeout_s)
    if spawn_worker is None:
        spawn_worker = thread_worker_spawner(
            read_timeout_s=read_timeout_s,
            connect_timeout_s=connect_timeout_s,
            device=srv.device,
        )
    ingest = KVBlockIngest(srv, recv, obs=obs)
    session: _Session | None = None
    restarts = 0
    dispatch_bytes_total = 0

    def open_session() -> _Session:
        host, port = spawn_worker()
        return _Session(
            host, port, result_port=recv.port, dec=srv.dec,
            params=srv.params, block_size=srv.bs, chunk_len=chunk_len,
            compress=compress, level=level, quantize=quantize,
            connect_timeout_s=connect_timeout_s,
        )

    try:
        ingest.start()  # it owns the accept the worker connects to
        session = open_session()
        rids = [
            srv.submit_prefilled(p, s, sampling=sp, stop=st)
            for (p, s), sp, st in zip(requests, samps, stops)
        ]
        for rid, (p, _) in zip(rids, requests):
            session.send_request(rid, p)

        while srv.pending_prefilled or srv.pending or any(srv.slots):
            if ingest.failed.is_set():
                err = ingest.error
                if isinstance(err, IngestError):
                    # A protocol or configuration skew: a fresh worker
                    # would ship the same bad payload.
                    raise err
                if restarts >= worker_retries:
                    raise TransportError(
                        f"prefill worker died and {restarts} "
                        f"restart(s) were already spent: {err}"
                    )
                restarts += 1
                obs.worker_restarts.inc()
                log.warning("prefill worker session died (%s); restarting "
                            "(%d/%d)", err, restarts, worker_retries)
                # Deliver what the dead session did land before working
                # out the re-request set (the drain thread is parked).
                ingest.pump()
                missing = ingest.undelivered()
                dispatch_bytes_total += session.dispatch_bytes
                session.close()
                # Drop the dead peer BEFORE resuming the drain thread,
                # so its fresh accept lands the new worker's connection.
                recv.next_peer()
                ingest.resume()
                session = open_session()
                by_rid = dict(zip(rids, requests))
                for rid in missing:
                    session.send_request(rid, by_rid[rid][0])
            ingest.pump()
            srv._admit()
            if any(s is not None for s in srv.slots):
                srv._tick()
            else:
                # Nothing seated: waiting on the wire, not the card.
                time.sleep(1e-3)
        done = srv.done
    finally:
        if session is not None:
            dispatch_bytes_total += session.dispatch_bytes
            session.close()
        ingest.close()
        recv.close()

    n_req = max(len(requests), 1)
    stats = server_stats(
        srv,
        disagg=True,
        quantize=quantize,
        kv_bytes_recv=recv.rx_frame_bytes,
        kv_bytes_recv_per_request=recv.rx_frame_bytes / n_req,
        dispatch_bytes_sent=dispatch_bytes_total,
        ingest_ms=srv.prefilled_admit_s * 1e3,
        worker_restarts=restarts,
    )
    return [done[r] for r in rids], stats
