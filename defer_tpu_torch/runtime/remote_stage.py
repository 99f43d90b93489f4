"""Remote stage worker: the reference's compute node, as a process
(counterpart of the graph-stage half of `defer_tpu/runtime/remote_stage.py`,
on the same wire: a dispatcher of either package drives a worker of the
other).

The reference's deployment unit is `python node.py` on another machine:
it receives architecture JSON (port 5001), weights (port 5002), its
successor's address, then relays activations (port 5000) through
`model.predict` forever (reference src/node.py:135-152). This module is
that capability for the IR over the transport seam — ONE stream carries
the whole session:

    frame 1      uint8 bytes of the stage's graph JSON
                 (graph/serialize.py)
    frame 2      uint8 bytes of the param manifest (JSON list of
                 'node/param' paths)
    frames 3..   one array per manifest entry (the weights wire,
                 reference src/dispatcher.py:75-88)
    then         activation frames — len(input_names) frames per
                 microbatch for bundle boundaries; results stream to
                 the --next peer as len(output_names) frames
    STOP         ends the session (the shutdown the reference lacks)

The worker places the stage's params on its device once, through the
pipeline's placement (parallel/pipeline.py `Stage`: storage dtype, then
each op's `place` form), computing in the dtype the floating params
arrived in, and runs the stage under `torch.inference_mode()`. Its
device is the first CUDA device unless the caller asks for another
(`device="cpu"`); without a card and without that request it raises.

Worker CLI (the `node.py` analogue; chain wiring via --next replaces
the reference's nextNode message, src/dispatcher.py:54-58):

    python -m defer_tpu_torch serve-stage --listen 0 --next 10.0.0.2:5000

Dispatcher side: `dispatch_stage(sender, stage, params)` then
`send_activation(sender, x)` per microbatch.

`serve_pp_stage` serves one stage of a pipeline-parallel paged decode
server (`PagedDecodeServer(pp_remote=...)`) the same way: six operands
in a microbatch, one array out, until the STOP frame; the worker is
handed its decoder and weights rather than receiving them.

CHAIN ORDERING CONTRACT: a worker identifies the FIRST accepted
connection as its dispatch stream, so chains must be dispatched
tail-first (last stage's worker first) — each worker only connects to
its --next peer after its own dispatch completes, which guarantees the
downstream worker has already consumed its dispatch. Dispatching
head-first lets an upstream worker's activation connection win the
downstream accept race; the worker then fails fast with a GraphError
naming this contract.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from defer_tpu_torch.config import DeferConfig
from defer_tpu_torch.graph.ir import GraphError
from defer_tpu_torch.graph.serialize import (
    frames_to_params,
    graph_from_json,
    graph_to_json,
    params_to_frames,
)
from defer_tpu_torch.parallel.mesh import cuda_devices
from defer_tpu_torch.parallel.pipeline import Stage, resolve_device
from defer_tpu_torch.runtime.transport import (
    ArrayReceiver,
    ArraySender,
    TransportError,
)
from defer_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _num_inputs(stage: Any) -> int:
    return len(getattr(stage, "input_names", ("x",)))


def _num_outputs(stage: Any) -> int:
    return len(getattr(stage, "output_names", ("y",)))


def _send_blob(sender: ArraySender, data: bytes) -> None:
    sender.send(np.frombuffer(data, np.uint8))


def _blob_text(t: torch.Tensor) -> str:
    return t.numpy().tobytes().decode()


def dispatch_stage(sender: ArraySender, stage: Any, params: Any) -> None:
    """Ship a stage (architecture + weights) to a worker — the
    reference's `_dispatchModels` for one node (src/dispatcher.py:47-73).

    Weights always go LOSSLESS: a sender's quantize mode is an
    activation-transfer optimization; int8-roundtripping parameters
    would silently skew every result the worker ever produces."""
    saved_quant = sender.quantize
    sender.quantize = None
    try:
        _send_blob(sender, graph_to_json(stage).encode())
        pairs = params_to_frames(params)
        _send_blob(sender, json.dumps([p for p, _ in pairs]).encode())
        for _, arr in pairs:
            sender.send(arr)
    finally:
        sender.quantize = saved_quant


def send_activation(sender: ArraySender, x: Any) -> None:
    """One microbatch: a single array, or a tuple for bundle cuts."""
    xs = x if isinstance(x, (tuple, list)) else (x,)
    for t in xs:
        sender.send(t)


def _read_bundle(it, n: int):
    """Read one microbatch's n frames; None at a clean stream end,
    RuntimeError if the stream dies mid-bundle."""
    frames = []
    for i in range(n):
        try:
            frames.append(next(it))
        except StopIteration:
            if i:
                raise RuntimeError(
                    "stream ended mid-microbatch (partial bundle)"
                ) from None
            return None
    return tuple(frames)


def recv_results(receiver: ArrayReceiver, num_outputs: int = 1):
    """Iterate per-microbatch results arriving from the chain's last
    worker (the reference's `_result_server`, src/dispatcher.py:105-118).
    Yields CPU tensors, or tuples when the final boundary is a bundle."""
    it = iter(receiver)
    while True:
        outs = _read_bundle(it, num_outputs)
        if outs is None:
            return
        yield outs if num_outputs > 1 else outs[0]


def _compute_dtype(params: dict) -> torch.dtype:
    """The dtype the floating params arrived in (float32 when the stage
    has none): the worker computes in what the dispatcher shipped."""
    for node in params.values():
        for t in node.values():
            if t.is_floating_point():
                return t.dtype
    return torch.float32


def serve_stage(
    listen_port: int,
    next_host: str,
    next_port: int,
    *,
    listen_host: str = "0.0.0.0",
    accept_timeout_s: float = 120.0,
    handoff_timeout_s: float = 60.0,
    expect_activation_peer: bool = False,
    announce=None,
    device: Any = None,
    report=None,
) -> int:
    """Run one worker session to completion; returns microbatches
    relayed. `announce(port)` is called once the listen socket is bound
    (drivers/tests use it to learn an ephemeral port). `device`: where
    the stage runs (default: the first CUDA device; raises without one).
    `report(stats)` is called once the
    session ends cleanly, with what the worker received: frames by codec
    scheme and wire bytes (`ArrayReceiver.schemes`, `rx_frame_bytes`).

    ``expect_activation_peer=True`` declares this worker mid-chain: an
    upstream hop WILL connect, so a handoff-accept timeout is a hard
    error instead of a clean zero-work exit — without it a slow
    upstream start would make the chain silently produce zero results
    with rc=0."""
    dev = resolve_device(device) if device is not None else cuda_devices()[0]
    recv = ArrayReceiver(
        listen_port, host=listen_host, accept_timeout_s=accept_timeout_s
    )
    if announce is not None:
        announce(recv.port)
    it = iter(recv)
    try:
        try:
            first = next(it)
            try:
                stage = graph_from_json(_blob_text(first))
            except Exception as e:  # noqa: BLE001 — re-raise with context
                raise GraphError(
                    "first frame on the dispatch stream is not a stage "
                    "graph — if this worker is mid-chain, the chain was "
                    "probably dispatched head-first; dispatch tail-first "
                    "(see module docstring)"
                ) from e
            manifest = json.loads(_blob_text(next(it)))
            # Explicit loop, not a generator fed to frames_to_params: a
            # StopIteration inside a generator becomes PEP 479's opaque
            # RuntimeError and would never reach the except below.
            pairs = [(path, next(it)) for path in manifest]
        except StopIteration:
            raise RuntimeError(
                "peer closed before the stage was fully dispatched"
            ) from None
    except BaseException:
        recv.close()
        raise
    params = frames_to_params(pairs)
    n_in, n_out = _num_inputs(stage), _num_outputs(stage)
    try:
        module = Stage(
            stage, params, dev,
            DeferConfig(compute_dtype=_compute_dtype(params)),
        )
        log.info(
            "remote stage %r ready on %s (%d params, %d->%d tensors); "
            "relaying to %s:%d",
            stage.name, dev, len(manifest), n_in, n_out, next_host, next_port,
        )
        sender = ArraySender(next_host, next_port)
    except BaseException:
        recv.close()
        raise
    count = 0
    # Two session shapes (the reference used separate ports per role,
    # src/node.py:18; here roles share the listen socket):
    #   * single-peer: the dispatcher keeps streaming activations on
    #     the dispatch connection (the simple two-process case);
    #   * chained: the dispatch stream ENDS after the weights, and the
    #     activation stream arrives as a SECOND connection from the
    #     previous chain hop.
    accepted_second = False
    try:
        while True:
            try:
                acts = _read_bundle(it, n_in)
            except TransportError:
                if accepted_second and count == 0 and recv._conn is None:
                    # The HANDOFF ACCEPT timed out with no peer ever
                    # connecting. (A peer that connected and died
                    # mid-frame leaves recv._conn set — that is a real
                    # failure and re-raises.)
                    if expect_activation_peer:
                        raise RuntimeError(
                            f"remote stage {stage.name!r}: expected an "
                            f"upstream activation peer but none "
                            f"connected within {handoff_timeout_s:.0f}s"
                        ) from None
                    log.info(
                        "remote stage %r: no activation peer arrived; "
                        "dispatch-only session",
                        stage.name,
                    )
                    break
                raise
            if acts is None:
                if count == 0 and not accepted_second:
                    log.info(
                        "remote stage %r: dispatch stream closed; "
                        "awaiting the activation peer (<= %.0fs)",
                        stage.name,
                        handoff_timeout_s,
                    )
                    recv.next_peer()
                    # Bound the handoff wait separately: a dispatch-only
                    # session should exit in seconds, not the full
                    # accept timeout; chains must connect their next hop
                    # within this budget.
                    recv._server.settimeout(handoff_timeout_s)
                    it = iter(recv)
                    accepted_second = True
                    continue
                break
            with torch.inference_mode():
                xs = tuple(a.to(dev) for a in acts)
                out = module(xs if n_in > 1 else xs[0])
            for t in out if isinstance(out, tuple) else (out,):
                sender.send(t)
            count += 1
    finally:
        sender.close()
        recv.close()
    if report is not None:
        report({
            "relayed": count,
            "rx_schemes": {
                ",".join(map(str, k)): v for k, v in recv.schemes.items()
            },
            "rx_frame_bytes": recv.rx_frame_bytes,
        })
    return count


# analysis: domain(pp-stage-worker) the whole session — stage pools and
# the result stream — is owned by this worker thread; the controller
# only ever talks to it through the framed transport
def serve_pp_stage(
    dec: Any,
    params: Any,
    first: int,
    last: int,
    *,
    num_blocks: int,
    block_size: int,
    attention: str = "gathered",
    listen_port: int = 0,
    result_host: str = "127.0.0.1",
    result_port: int = 5000,
    listen_host: str = "0.0.0.0",
    accept_timeout_s: float = 120.0,
    announce=None,
) -> int:
    """Serve ONE pipeline stage of a paged decode server
    (PagedDecodeServer(pp_remote=...)) to a remote controller: the
    decode-time sibling of `serve_stage`, one stream in, one out. Each
    microbatch is the SIX stage-boundary operands (tables, pos, xin,
    n_keep, keep_from, adapter_ids) and the reply is one array, the
    boundary activation (or, on the last stage, the logits), sent to
    result_host:result_port.

    The worker wraps the same `_PPLocalStage` the in-process stages are:
    its layer slice of the params and its own slice of the KV pool live
    here. The decoder is not shipped over the wire (it is not a graph):
    the worker is handed `(dec, params)`, made from the same checkpoint
    or seed as the controller's. It runs on the decoder's device until
    the controller's STOP frame, and returns the microbatches served."""
    from defer_tpu_torch.runtime.paged import _PPLocalStage

    stage = _PPLocalStage(
        dec, params, first, last, num_blocks=num_blocks,
        block_size=block_size, attention=attention,
        device=dec.device,
    )
    recv = ArrayReceiver(
        listen_port, host=listen_host, accept_timeout_s=accept_timeout_s
    )
    if announce is not None:
        announce(recv.port)
    it = iter(recv)
    log.info(
        "pp stage worker ready (layers [%d, %d), pool %d bytes); "
        "results to %s:%d",
        first, last, stage.pool_bytes, result_host, result_port,
    )
    sender = ArraySender(result_host, result_port)
    count = 0
    try:
        while True:
            bundle = _read_bundle(it, 6)
            if bundle is None:
                return count
            # The framing of the result is the stage boundary here.
            sender.send(stage.pp_dispatch(*bundle))
            count += 1
    finally:
        sender.close()
        recv.close()
        stage.close()


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--listen", type=int, default=5000)
    ap.add_argument(
        "--next", required=True, help="host:port of the next chain hop"
    )
    ap.add_argument("--accept-timeout", type=float, default=120.0)
    ap.add_argument("--handoff-timeout", type=float, default=60.0)
    ap.add_argument(
        "--expect-peer",
        action="store_true",
        help="this worker is mid-chain: treat a missing upstream "
        "activation peer as a hard error, never a clean zero-work exit",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="where the stage runs, e.g. cuda:1 or cpu (default: the "
        "first CUDA device; without a card the worker raises)",
    )
    args = ap.parse_args(argv)
    host, _, port = args.next.rpartition(":")
    n = serve_stage(
        args.listen,
        host or "127.0.0.1",
        int(port),
        accept_timeout_s=args.accept_timeout,
        handoff_timeout_s=args.handoff_timeout,
        expect_activation_peer=args.expect_peer,
        announce=lambda p: print(f"LISTENING {p}", flush=True),
        device=args.device,
        report=_print_stats,
    )
    print(f"DONE {n}", flush=True)


def _print_stats(stats: dict) -> None:
    """The worker's STATS line: what it received, and what its codec
    encoded (the results it relayed) from the process counters."""
    from defer_tpu_torch.obs.metrics import get_registry

    reg = get_registry()
    stats["codec_raw_bytes"] = reg.value("defer_codec_raw_bytes_total")
    stats["codec_encoded_bytes"] = reg.value(
        "defer_codec_encoded_bytes_total"
    )
    print(f"STATS {json.dumps(stats)}", flush=True)


if __name__ == "__main__":
    main()
