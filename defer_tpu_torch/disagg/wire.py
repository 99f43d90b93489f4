"""KV-block wire format: finished prefill state as a transport payload.

Counterpart of `defer_tpu/disagg/wire.py`, byte-compatible with it: the
same blobs (JSON in a uint8 frame), the same frames in the same order,
through `runtime/transport.py`'s framing and `runtime/codec.py`'s
frames, which both packages read. So a prefill worker of either package
feeds a decode host of the other.

One dispatch stream (decode host -> prefill worker):

    blob   hello       {magic, version, result_host/port, block_size,
                        codec knobs, chunk_len}
    blob   decoder     TransformerConfig + compute_dtype (the worker
                       rebuilds its own GptDecoder, no pickle)
    blob   params      manifest: [[path, dtype_token], ...]
    frames              one array per manifest entry, ALWAYS lossless
    then   per request: blob {kind: prefill, rid} + prompt frame
    STOP               ends the session

One result stream (worker -> decode host), per request:

    blob   kv meta     {kind: kv, version, rid, t0, n_blocks, layers,
                        block_size, kv_heads, head_dim, dtype,
                        quantized}
    frame  logits      the last prompt position's [1, V] logits row,
                       ALWAYS lossless (the first token is drawn from it)
    frames K/V         2 * layers frames, layer-major K-then-V, each
                       [n_blocks, kv_heads, block_size, head_dim], in
                       the sender's quantize mode

One prefix chain (fleet migration, replica -> replica):

    blob   prefix      {kind: prefix, version, n_blocks, layers,
                        block_size, kv_heads, head_dim, dtype, toks}
    frames K/V         2 * layers frames, layer-major K-then-V, ALWAYS
                       lossless

bfloat16 tensors cross as uint16 views plus the dtype token "bfloat16"
(the JAX package's convention), so the int8 quantized mode applies to
real float dtypes and bf16 ships lossless. Every blob carries `version`;
readers refuse a mismatch. Arrays arrive as CPU tensors.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterator

import numpy as np
import torch

from defer_tpu_torch.runtime.transport import (
    ArrayReceiver,
    ArraySender,
    TransportError,
)

WIRE_VERSION = 1
MAGIC = "defer-disagg"

_BF16 = "bfloat16"
_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
}


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's wire name, numpy's (and the JAX package's)."""
    return str(dtype).removeprefix("torch.")


def to_wire_array(arr: Any) -> tuple[np.ndarray, str]:
    """(codec-safe numpy array on the host, dtype token). bfloat16,
    which numpy lacks, travels as its uint16 bit pattern."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
    else:
        a = np.asarray(arr)
        if a.dtype.name == _BF16:
            return a.view(np.uint16), _BF16
    return a, a.dtype.name


def from_wire_array(arr: torch.Tensor, token: str) -> torch.Tensor:
    if token == _BF16:
        return arr.view(torch.int16).view(torch.bfloat16)
    got = arr.numpy().dtype.name
    if got != token:
        # The codec restores the original dtype (after int8 quantization
        # too); a mismatch means sender and receiver disagree about what
        # was shipped.
        raise TransportError(f"frame dtype {got} != declared {token}")
    return arr


def send_blob(sender: ArraySender, obj: dict) -> int:
    """JSON dict -> one uint8 frame, always lossless. Returns wire
    bytes."""
    saved = sender.quantize
    sender.quantize = None
    try:
        return sender.send(
            np.frombuffer(json.dumps(obj).encode(), np.uint8)
        )
    finally:
        sender.quantize = saved


def read_blob(it: Iterator[torch.Tensor]) -> dict | None:
    """Next frame as a JSON dict; None at a clean stream end."""
    try:
        frame = next(it)
    except StopIteration:
        return None
    try:
        return json.loads(frame.numpy().tobytes().decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise TransportError(f"expected a JSON blob frame: {e}") from None


def expect_blob(it: Iterator[torch.Tensor], kind: str) -> dict:
    blob = read_blob(it)
    if blob is None:
        raise TransportError(f"stream ended awaiting {kind!r} blob")
    got = blob.get("kind")
    if got != kind:
        raise TransportError(f"expected {kind!r} blob, got {got!r}")
    if blob.get("version") != WIRE_VERSION:
        raise TransportError(
            f"wire version {blob.get('version')} != {WIRE_VERSION}"
        )
    return blob


def next_frame(it: Iterator[torch.Tensor], what: str) -> torch.Tensor:
    """next() that turns a mid-payload stream end into a TransportError
    (inside a generator a StopIteration would become a RuntimeError)."""
    try:
        return next(it)
    except StopIteration:
        raise TransportError(f"stream ended awaiting {what}") from None


# -- decoder + params ------------------------------------------------------


def decoder_to_wire(dec: Any) -> dict:
    """GptDecoder -> a JSON-able architecture blob body: the config's
    fields (the JAX package's TransformerConfig has the same ones)."""
    return {
        "cfg": dataclasses.asdict(dec.cfg),
        "compute_dtype": dtype_name(dec.compute_dtype),
        "rolling_cache": bool(getattr(dec, "rolling_cache", False)),
    }


def decoder_from_wire(body: dict, device=None) -> Any:
    """The worker's own GptDecoder from a decoder blob, on `device`
    (the first CUDA device when None)."""
    from defer_tpu_torch.models.gpt import GptDecoder
    from defer_tpu_torch.parallel.transformer_stack import TransformerConfig

    cfg_d = dict(body["cfg"])
    # JSON has no tuples; the frozen config declares one.
    cfg_d["lora_targets"] = tuple(cfg_d.get("lora_targets", ()))
    name = body["compute_dtype"]
    if name not in _DTYPES:
        raise TransportError(f"unknown compute dtype {name!r}")
    return GptDecoder(
        TransformerConfig(**cfg_d),
        compute_dtype=_DTYPES[name],
        rolling_cache=body.get("rolling_cache", False),
        device=device,
    )


def flatten_params(tree: dict, prefix: str = "") -> list[tuple[str, Any]]:
    """Nested dict of arrays -> sorted (slash-path, array) pairs."""
    out: list[tuple[str, Any]] = []
    for key in sorted(tree):
        if "/" in key:
            raise ValueError(f"param key {key!r} contains the path separator")
        val = tree[key]
        if isinstance(val, dict):
            out.extend(flatten_params(val, f"{prefix}{key}/"))
        else:
            out.append((f"{prefix}{key}", val))
    return out


def unflatten_params(pairs: list[tuple[str, Any]]) -> dict:
    tree: dict = {}
    for path, arr in pairs:
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def send_params(sender: ArraySender, params: dict) -> int:
    """Manifest blob + one frame per leaf, ALWAYS lossless (quantized
    weights would skew every token the worker prefills). Returns wire
    bytes."""
    manifest = []
    frames = []
    for path, arr in flatten_params(params):
        wired, token = to_wire_array(arr)
        manifest.append([path, token])
        frames.append(wired)
    n = send_blob(
        sender,
        {"kind": "params", "version": WIRE_VERSION, "manifest": manifest},
    )
    saved = sender.quantize
    sender.quantize = None
    try:
        for wired in frames:
            n += sender.send(wired)
    finally:
        sender.quantize = saved
    return n


def read_params(it: Iterator[torch.Tensor]) -> dict:
    """The params tree of CPU tensors a `send_params` stream carries."""
    blob = expect_blob(it, "params")
    pairs = []
    for path, token in blob["manifest"]:
        arr = next_frame(it, f"param frame {path!r}")
        pairs.append((path, from_wire_array(arr, token)))
    return unflatten_params(pairs)


# -- dispatch stream (decode host -> prefill worker) -----------------------


def send_hello(
    sender: ArraySender,
    *,
    result_host: str,
    result_port: int,
    block_size: int,
    chunk_len: int | None = None,
) -> int:
    """First dispatch frame: where results go and how to block them; the
    worker mirrors the codec knobs onto its result sender."""
    return send_blob(
        sender,
        {
            "kind": "hello",
            "version": WIRE_VERSION,
            "magic": MAGIC,
            "result_host": result_host,
            "result_port": result_port,
            "block_size": block_size,
            "chunk_len": chunk_len,
            "compress": sender.compress,
            "level": sender.level,
            "quantize": sender.quantize,
        },
    )


def expect_hello(it: Iterator[torch.Tensor]) -> dict:
    hello = expect_blob(it, "hello")
    if hello.get("magic") != MAGIC:
        raise TransportError(
            f"dispatch stream magic {hello.get('magic')!r} != {MAGIC!r} "
            "— is a non-disagg peer connected to this worker?"
        )
    return hello


def send_prefill_request(sender: ArraySender, rid: int, prompt) -> int:
    n = send_blob(
        sender, {"kind": "prefill", "version": WIRE_VERSION, "rid": rid}
    )
    saved = sender.quantize
    sender.quantize = None  # token ids are exact or useless
    try:
        ids = prompt.cpu().numpy() if isinstance(prompt, torch.Tensor) \
            else prompt
        n += sender.send(np.asarray(ids, np.int32))
    finally:
        sender.quantize = saved
    return n


# -- result stream (prefill worker -> decode host) -------------------------


@dataclasses.dataclass
class KVPayload:
    """One request's finished prefill state, decode-server-shaped:
    `k`/`v` are [layers, n_blocks, kv_heads, block_size, head_dim] block
    stacks (the pool layout minus the pool axis), `logits` the [1, V]
    last-prompt-position row the first token is drawn from. Tensors or
    numpy arrays, on the host."""

    rid: int
    t0: int
    k: Any
    v: Any
    logits: Any
    wire_bytes: int = 0
    quantized: bool = False


def send_kv_payload(sender: ArraySender, payload: KVPayload,
                    obs: Any = None) -> int:
    """Frame one payload onto the result stream. K/V frames ride the
    sender's quantize mode; meta and the logits row are pinned lossless.
    `obs`: an optional obs.serving.DisaggMetrics to account blocks and
    bytes against. Returns wire bytes sent."""
    L, n_blocks, hkv, bs, dh = payload.k.shape
    k_w, token = to_wire_array(payload.k)
    v_w, _ = to_wire_array(payload.v)
    quant = sender.quantize is not None and token != _BF16
    n = send_blob(
        sender,
        {
            "kind": "kv",
            "version": WIRE_VERSION,
            "rid": payload.rid,
            "t0": payload.t0,
            "n_blocks": n_blocks,
            "layers": L,
            "block_size": bs,
            "kv_heads": hkv,
            "head_dim": dh,
            "dtype": token,
            "quantized": quant,
        },
    )
    logits_w, ltoken = to_wire_array(payload.logits)
    saved = sender.quantize
    sender.quantize = None
    try:
        n += sender.send(logits_w)
    finally:
        sender.quantize = saved
    if ltoken == _BF16:
        raise ValueError("logits row must be a real float dtype")
    for layer in range(L):
        n += sender.send(k_w[layer])
        n += sender.send(v_w[layer])
    if obs is not None:
        obs.kv_blocks_shipped.inc(n_blocks)
        obs.kv_bytes_sent.inc(n)
    return n


def iter_kv_payloads(receiver: ArrayReceiver,
                     obs: Any = None) -> Iterator[KVPayload]:
    """Yield payloads off the result stream until the worker's STOP. A
    stream that dies mid-payload raises TransportError with nothing
    partial yielded: delivery is atomic, so "undelivered" is exactly
    what a retry must re-request. `obs`: optional DisaggMetrics for
    received-byte accounting."""
    it = iter(receiver)
    while True:
        start = receiver.rx_frame_bytes
        meta = read_blob(it)
        if meta is None:
            return
        if meta.get("kind") != "kv":
            raise TransportError(
                f"expected 'kv' blob on the result stream, got "
                f"{meta.get('kind')!r}"
            )
        if meta.get("version") != WIRE_VERSION:
            raise TransportError(
                f"wire version {meta.get('version')} != {WIRE_VERSION}"
            )
        logits = next_frame(it, "logits frame")
        token = meta["dtype"]
        ks, vs = [], []
        for layer in range(meta["layers"]):
            ks.append(from_wire_array(
                next_frame(it, f"layer {layer} K frame"), token))
            vs.append(from_wire_array(
                next_frame(it, f"layer {layer} V frame"), token))
        nbytes = receiver.rx_frame_bytes - start
        if obs is not None:
            obs.kv_bytes_recv.inc(nbytes)
        yield KVPayload(
            rid=meta["rid"],
            t0=meta["t0"],
            k=torch.stack(ks),
            v=torch.stack(vs),
            logits=logits,
            wire_bytes=nbytes,
            quantized=meta.get("quantized", False),
        )


# -- prefix chains (fleet migration) ---------------------------------------


@dataclasses.dataclass
class PrefixPayload:
    """A root-anchored radix prefix chain lifted out of one replica's
    pool for fleet migration: per-block OWN-token bytes (int64, the
    radix cache's tok_of encoding) plus [layers, n, kv_heads,
    block_size, head_dim] K/V block stacks (tensors or numpy arrays on
    the host). Carries token bytes and NOT digests: the importer
    recomputes the chained keys itself
    (runtime/paged.py::import_prefix_blocks), so a corrupted payload
    mis-keys into digests nothing looks up instead of aliasing a
    resident chain."""

    toks: list[bytes]
    k: Any
    v: Any
    wire_bytes: int = 0


def send_prefix_payload(sender: ArraySender, payload: PrefixPayload) -> int:
    """Frame one prefix chain onto a stream: a "prefix" blob, then
    2 * layers frames, layer-major K-then-V. Pinned LOSSLESS end to end
    (bf16 as its 2-byte pattern): a migrated block becomes long-lived
    shared cache state on the importer, so a lossy copy would skew every
    future sharer. Returns wire bytes sent."""
    L, n_blocks, hkv, bs, dh = payload.k.shape
    if len(payload.toks) != n_blocks:
        raise ValueError(
            f"{len(payload.toks)} token blobs for {n_blocks} blocks"
        )
    k_w, token = to_wire_array(payload.k)
    v_w, _ = to_wire_array(payload.v)
    n = send_blob(
        sender,
        {
            "kind": "prefix",
            "version": WIRE_VERSION,
            "n_blocks": n_blocks,
            "layers": L,
            "block_size": bs,
            "kv_heads": hkv,
            "head_dim": dh,
            "dtype": token,
            "toks": [t.hex() for t in payload.toks],
        },
    )
    saved = sender.quantize
    sender.quantize = None
    try:
        for layer in range(L):
            n += sender.send(k_w[layer])
            n += sender.send(v_w[layer])
    finally:
        sender.quantize = saved
    return n


def read_prefix_payload(
    it: Iterator[torch.Tensor], receiver: ArrayReceiver | None = None
) -> PrefixPayload | None:
    """Next prefix chain off a stream as CPU tensors (None at a clean
    end). Pass the receiver to account wire bytes on the payload."""
    start = receiver.rx_frame_bytes if receiver is not None else 0
    meta = read_blob(it)
    if meta is None:
        return None
    if meta.get("kind") != "prefix":
        raise TransportError(
            f"expected 'prefix' blob, got {meta.get('kind')!r}"
        )
    if meta.get("version") != WIRE_VERSION:
        raise TransportError(
            f"wire version {meta.get('version')} != {WIRE_VERSION}"
        )
    token = meta["dtype"]
    ks, vs = [], []
    for layer in range(meta["layers"]):
        ks.append(from_wire_array(
            next_frame(it, f"layer {layer} prefix K frame"), token))
        vs.append(from_wire_array(
            next_frame(it, f"layer {layer} prefix V frame"), token))
    nbytes = receiver.rx_frame_bytes - start if receiver is not None else 0
    return PrefixPayload(
        toks=[bytes.fromhex(t) for t in meta["toks"]],
        k=torch.stack(ks),
        v=torch.stack(vs),
        wire_bytes=nbytes,
    )
