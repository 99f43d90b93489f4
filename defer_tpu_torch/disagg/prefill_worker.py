"""Prefill worker: the compute-bound half of disaggregated serving.

Counterpart of `defer_tpu/disagg/prefill_worker.py`. Runs as its own
process (the CLI below) or an in-process thread: it receives a decoder
architecture and weights over the dispatch stream, then for each
prefill request runs the (optionally chunked) prefill on its device and
streams the finished KV blocks and the first-token logits row back to
the decode host's ingest (`disagg/ingest.py`), which seats them in the
paged pool. The session shape is `runtime/remote_stage.py`'s (listen,
then connect back); the payload format is `disagg/wire.py`.

Parity: with `chunk_len=None` the worker prefills a prompt in ONE
pow2-padded step, the monolithic server's admission schedule, so the
K/V rows and the last-position logits are the ones `serve_paged` would
compute locally and greedy decode is token-identical end to end.
Chunked prefill (`chunk_len=C`) runs full chunks of exactly C tokens
and pow2-pads only the tail (a padded mid-chunk would move the cache's
write head past real content).

    python -m defer_tpu_torch.disagg.prefill_worker --listen 0 [--device cpu]

prints `LISTENING <port>` once bound, then `DONE <n>` when the dispatch
stream ends. `fail_after_requests=N` (tests) hard-closes the result
socket after N payloads without the STOP frame: a mid-stream peer death
for the decode side's retry path.
"""

from __future__ import annotations

import numpy as np
import torch

from defer_tpu_torch.disagg import wire
from defer_tpu_torch.obs.serving import DisaggMetrics
from defer_tpu_torch.runtime.transport import ArrayReceiver, ArraySender
from defer_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def prefill_schedule(t0: int, chunk_len: int | None) -> list[int]:
    """Chunk lengths covering t0 tokens: full chunks of exactly
    chunk_len, then a 1..chunk_len tail (the only chunk that may be
    padded). chunk_len=None: one chunk, the monolithic schedule."""
    if t0 < 1:
        raise ValueError("need at least one prompt token")
    if chunk_len is None or chunk_len >= t0:
        return [t0]
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    n_full = (t0 - 1) // chunk_len
    tail = t0 - n_full * chunk_len
    return [chunk_len] * n_full + [tail]


@torch.no_grad()
def run_prefill(dec, params: dict, prompt, *, block_size: int,
                chunk_len: int | None = None):
    """Prefill one prompt [1, t0] on the decoder's device and cut its
    cache into pool-shaped blocks. Returns (k_blocks, v_blocks,
    logits_row) as CPU tensors: [L, n_blocks, Hkv, bs, Dh] stacks of rows
    0..t0-1 (tail rows zero; the decode server masks them and its first
    write lands at row t0) and the [1, V] f32 logits row of the last
    real prompt position."""
    ids = torch.as_tensor(np.asarray(prompt) if not isinstance(
        prompt, torch.Tensor) else prompt).to(dec.device, torch.int32)
    t0 = int(ids.shape[1])
    max_len = dec.cfg.max_len
    if t0 >= max_len:
        raise ValueError(
            f"prompt of {t0} leaves no room under max_len {max_len}")
    cache = dec.init_cache(1)
    step = dec.make_step()
    logits_row = None
    pos = 0
    chunks = prefill_schedule(t0, chunk_len)
    for ci, chunk in enumerate(chunks):
        piece = ids[:, pos : pos + chunk]
        if ci == len(chunks) - 1:
            # The tail pads to a power of two like the monolithic
            # admission (pad rows sit past t0, masked until the first
            # decode write overwrites row t0).
            pad = min(1 << (chunk - 1).bit_length(), max_len - pos)
            if pad > chunk:
                piece = torch.cat([piece, piece.new_zeros((1, pad - chunk))],
                                  dim=1)
        logits, cache = step(params, cache, piece)
        logits_row = logits[:, chunk - 1, :]
        pos += chunk
    cfg = dec.cfg
    L, hkv, dh = cfg.num_layers, cfg.kv_heads, cfg.dim // cfg.num_heads
    n_blocks = -(-t0 // block_size)
    out = []
    for lane in (cache["k"], cache["v"]):
        rows = lane[:, 0, :, :t0].cpu()  # [L, Hkv, t0, Dh]
        rows = torch.nn.functional.pad(
            rows, (0, 0, 0, n_blocks * block_size - t0))
        out.append(rows.reshape(L, hkv, n_blocks, block_size, dh)
                   .transpose(1, 2).contiguous())
    return out[0], out[1], logits_row.float().cpu()


def _to_device(tree: dict, device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, dict)
            else v.to(device) for k, v in tree.items()}


# analysis: domain(transport) one worker session per thread; all state is
# session-local, results cross by wire only
def serve_prefill(
    listen_port: int = 0,
    *,
    listen_host: str = "127.0.0.1",
    accept_timeout_s: float = 120.0,
    read_timeout_s: float | None = None,
    connect_timeout_s: float = 30.0,
    announce=None,
    fail_after_requests: int | None = None,
    device=None,
) -> int:
    """Run one prefill-worker session to completion; returns requests
    served. `announce(port)` fires once the listen socket is bound.
    Architecture, weights and every prompt arrive over the wire; the
    worker builds its decoder on `device` (the first CUDA device when
    None)."""
    recv = ArrayReceiver(
        listen_port,
        host=listen_host,
        accept_timeout_s=accept_timeout_s,
        read_timeout_s=read_timeout_s,
    )
    if announce is not None:
        announce(recv.port)
    obs = DisaggMetrics("prefill")
    sender = None
    count = 0
    try:
        it = iter(recv)
        hello = wire.expect_hello(it)
        dec = wire.decoder_from_wire(wire.expect_blob(it, "decoder"),
                                     device=device)
        params = _to_device(wire.read_params(it), dec.device)
        block_size = int(hello["block_size"])
        chunk_len = hello.get("chunk_len")
        log.info(
            "prefill worker ready: %d layers on %s, block_size=%d, "
            "results -> %s:%d", dec.cfg.num_layers, dec.device, block_size,
            hello["result_host"], hello["result_port"],
        )
        sender = ArraySender(
            hello["result_host"],
            hello["result_port"],
            compress=hello.get("compress", True),
            level=hello.get("level", 3),
            quantize=hello.get("quantize"),
            connect_timeout_s=connect_timeout_s,
        )
        while True:
            req = wire.read_blob(it)
            if req is None:
                break  # clean STOP from the dispatcher
            if req.get("kind") != "prefill":
                raise wire.TransportError(
                    f"expected 'prefill' blob, got {req.get('kind')!r}"
                )
            prompt = wire.next_frame(it, "prompt frame")
            if prompt.ndim == 1:
                prompt = prompt[None]
            k_blocks, v_blocks, logits_row = run_prefill(
                dec, params, prompt, block_size=block_size,
                chunk_len=chunk_len,
            )
            wire.send_kv_payload(
                sender,
                wire.KVPayload(rid=int(req["rid"]), t0=int(prompt.shape[-1]),
                               k=k_blocks, v=v_blocks, logits=logits_row),
                obs=obs,
            )
            count += 1
            if (fail_after_requests is not None
                    and count >= fail_after_requests):
                # A simulated crash: the socket closes with no STOP.
                log.info("prefill worker: injected failure after %d "
                         "request(s)", count)
                sender._sock.close()
                sender = None
                return count
        sender.close()
        sender = None
        return count
    finally:
        if sender is not None:
            sender.close()
        recv.close()


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="A disaggregated-serving prefill worker (one session)."
    )
    ap.add_argument("--listen", type=int, default=5100)
    ap.add_argument("--listen-host", default="0.0.0.0")
    ap.add_argument("--accept-timeout", type=float, default=120.0)
    ap.add_argument(
        "--read-timeout", type=float, default=None,
        help="per-recv timeout on the dispatch stream (None = block)",
    )
    ap.add_argument(
        "--device", default=None,
        help="where the worker prefills (default: the first CUDA device)",
    )
    args = ap.parse_args(argv)
    n = serve_prefill(
        args.listen,
        listen_host=args.listen_host,
        accept_timeout_s=args.accept_timeout,
        read_timeout_s=args.read_timeout,
        announce=lambda p: print(f"LISTENING {p}", flush=True),
        device=args.device,
    )
    print(f"DONE {n}", flush=True)


if __name__ == "__main__":
    main()
