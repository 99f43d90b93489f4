"""Paged KV cache: a shared block pool instead of per-slot max_len lanes.

Counterpart of `defer_tpu/runtime/paged.py` on one device with a
compute-dtype ("fp") pool. The contiguous continuous-batching cache
(runtime/decode_server.py) reserves max_batch x max_len K/V rows even
when every request is short; here the cache is a pool of fixed-size
BLOCKS, [L, num_blocks, Hkv, block_size, Dh], each slot holds a BLOCK
TABLE of pool indices, and memory scales with the sum of the requests'
budgets. The design is the JAX package's:

  * block tables are a fixed [B, max_blocks] shape; unallocated entries
    point at the reserved TRASH block 0 (never allocated), so idle slots
    and dropped rows write scrap there and garbage reads sit past the
    position mask;
  * allocation is host-side and exact: a request's need is known at
    submit (prompt + step budget), admission takes ceil(total / bs)
    blocks from the free list and finishing returns them; when the pool
    is exhausted, requests wait;
  * the decode tick runs one of three attention paths (`attention=`):
    "gathered" gathers each slot's blocks into the contiguous
    [B, Hkv, MB * bs, Dh] view and runs GptDecoder._block on it (the
    reference), then scatters the new row back; "blockwise" writes the
    new row into the pool first and folds pool blocks through the table
    (plain PyTorch, reads stop at the deepest live block of the batch);
    "pallas" does the same through the hand-written paged kernels
    (ops/paged_flash_decode.py for the tick, ops/paged_flash_prefill.py
    for a prefill chunk), each slot reading only its own live blocks.
    The mode keeps the JAX package's name, so knobs map one to one;
  * `prefix_cache=True` shares full prompt blocks between requests
    through the radix `PrefixBlockCache`; constructor `prefix_ids`
    shares one system prompt's blocks; `prefill_chunk=` runs admission
    prefill pool-native, chunk by chunk through the multi-token step;
  * `kv_dtype="int8"` stores the pool as symmetric int8 with one f32
    scale per (layer, block, KV head): a {"q": int8, "s": f32} pair per
    K and V, never-written blocks at q=0, s=1 (zeros). A row write
    requantizes its block (`_pool_write_rows`), a prefill insert
    quantizes blocks as they land, the gathered reads dequantize in the
    compute dtype, and "pallas" hands the int8 payload and the scales to
    the kernels, which read them as they are;
  * `spill_bytes=` adds the host-RAM tier `HostKVSpill` under the radix
    cache: an evicted prefix block's stored bytes (int8 payload and
    scales, or fp rows) drain to host memory off the serving thread, and
    a later walk miss revives them verbatim into a fresh block.

What differs from JAX, and why:

  * the pool is written IN PLACE (`index_put_`), the port's answer to the
    JAX package's donated pool. Repeated destinations (trash block 0)
    are allowed and race over garbage; a live slot never writes block 0,
    and a radix hit's rows redirect to it. So a block handed to the
    spill tier is cloned on the serving stream first: a view would read
    the next tenant's rows by the time the drain thread copies it;
  * an int8 multi-token write lands the rows of a chunk in at most
    block_size rounds (one per row-in-block) instead of one per token;
    each block sees its rows in the same order, so the pool is
    bit-identical to the JAX package's token-by-token loop;
  * block tables, positions and the active mask live on the device and
    change only at admission and finish; idle slots sit at position 0
    with an all-trash table, and a tick advances the live positions on
    the device, so a steady tick makes no host sync. Host mirrors serve
    the accounting (rows read) and the blockwise fold's bound, a host
    int where the JAX package traces `jnp.max(pos)`;
  * there is no jit, so no program memo: each step runs eagerly.

Not ported yet (each raises NotImplementedError, naming its ROADMAP
Queue 1 item): `decode_window > 1`, `spec_k`, `prefill_budget`,
`mesh=`/`device=`, `constraints=`, `pp_*`, multi-LoRA adapter banks and
`adapter_id != 0`, and the disagg/fleet seams (`submit_prefilled`,
`deliver_kv`, `export_prefix_blocks`, `import_prefix_blocks`).
"""

from __future__ import annotations

import collections
import functools
import hashlib
import queue
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from defer_tpu_torch.models.gpt import _layer_view
from defer_tpu_torch.models.quant import (
    dequantize_symmetric,
    quantize_symmetric,
)
from defer_tpu_torch.obs.serving import ServerStats, ServingMetrics
from defer_tpu_torch.ops.paged_flash_decode import (
    _decode_lo_hi,
    paged_flash_decode,
    paged_flash_decode_plain,
)
from defer_tpu_torch.ops.paged_flash_prefill import (
    _prefill_lo_hi,
    paged_flash_prefill,
    paged_flash_prefill_plain,
)
from defer_tpu_torch.runtime.decode_server import SlotSampler
from defer_tpu_torch.runtime.stopping import matcher_or_none, normalize_stops


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})"
    )


def _pool_layer(pool, layer: int):
    """One layer of the pool, as views: the fp tensor [NB, Hkv, bs, Dh],
    or the int8 pair {"q": [NB, Hkv, bs, Dh], "s": [NB, Hkv]}."""
    if isinstance(pool, dict):
        return {"q": pool["q"][layer], "s": pool["s"][layer]}
    return pool[layer]


def _pool_arr(pool):
    """The tensor carrying the pool geometry: the int8 payload of a
    quantized pair, or the fp pool itself."""
    return pool["q"] if isinstance(pool, dict) else pool


def _pool_scale(pool):
    """The int8 pool's per-(block, head) scales; None for an fp pool."""
    return pool["s"] if isinstance(pool, dict) else None


def _pool_write_rows(pool_l, dest, rowi, val) -> None:
    """Scatter one fresh K/V row per entry into a per-layer pool slice IN
    PLACE: dest [N] block ids, rowi [N] rows-in-block, val [N, Hkv, Dh]
    (`_pool_write_rows_mt` takes [B, T] ones). Duplicate destinations (trash block 0) race over garbage, the module
    invariant; never accumulate.

    An int8 pool keeps ONE scale per (block, head), so landing a row
    re-derives its block's scale, as the JAX package's `_pool_write_rows`
    does: gather the touched blocks, dequantize in f32, insert the row,
    ZERO the rows past it (a previous tenant's garbage would inflate the
    scale and crush the live rows' precision), requantize over
    (bs, Dh), and scatter payload and scale back."""
    if not isinstance(pool_l, dict):
        pool_l[dest, :, rowi, :] = val
        return
    q, s = pool_l["q"], pool_l["s"]
    n, bs = dest.shape[0], q.shape[2]
    blk = dequantize_symmetric(q[dest], s[dest][..., None, None])
    blk[torch.arange(n, device=q.device), :, rowi, :] = val.float()
    live = torch.arange(bs, device=q.device)[None, :] <= rowi[:, None]
    blk = blk * live[:, None, :, None]
    qn, sn = quantize_symmetric(blk, axis=(-2, -1))
    q[dest] = qn
    s[dest] = sn


def _pool_write_rows_mt(pool_l, dest, rowi, val) -> None:
    """The multi-token write: dest/rowi [B, T], val [B, T, Hkv, Dh] (T
    fresh rows a slot, at consecutive positions). An fp pool takes one
    scatter. An int8 pool lands the rows in order, each write seeing the
    previous one's payload and scale (consecutive rows of a slot share a
    block), as the JAX package's `_pool_write_rows_mt` loop over the T
    columns does. With T > bs the port groups that sequence by
    row-in-block instead: round r writes every entry whose row is r,
    with the same single-row write. A block's rows are consecutive
    positions, so each block still sees its rows land in the same order,
    and no two live entries of a round share a block: the pool is
    bit-identical to the column loop's, in bs rounds instead of T."""
    if not isinstance(pool_l, dict):
        pool_l[dest, :, rowi, :] = val
        return
    b, t = dest.shape
    bs = pool_l["q"].shape[2]
    if t <= bs:
        for j in range(t):
            _pool_write_rows(pool_l, dest[:, j], rowi[:, j], val[:, j])
        return
    # Row r of a slot's rows sits at columns j = (r - rowi[:, 0]) % bs +
    # k * bs; entries past T redirect to trash block 0.
    dev = dest.device
    span = torch.arange(-(-t // bs), device=dev) * bs
    slots = torch.arange(b, device=dev)[:, None]
    for r in range(bs):
        cols = ((r - rowi[:, :1]) % bs + span).long()  # [B, K]
        keep = cols < t
        cols = cols.clamp(max=t - 1)
        d = torch.where(keep, dest.gather(1, cols), 0).reshape(-1)
        _pool_write_rows(pool_l, d, torch.full_like(d, r),
                         val[slots, cols].flatten(0, 1))


def _quantize_blocks(blocks: torch.Tensor):
    """[L, n, Hkv, bs, Dh] block stack -> (int8 payload, [L, n, Hkv] f32
    scales), the int8 pool's storage convention."""
    return quantize_symmetric(blocks.float(), axis=(-2, -1))


class HostKVSpill:
    """Bounded host-RAM spill tier for evicted prefix blocks; the JAX
    package's class, for torch tensors. Under pool pressure
    `PrefixBlockCache.evict` forgets warm blocks, and a later radix hit
    would become a full re-prefill; this store keeps each evicted block's
    stored bytes (int8 payload + scales, or the fp rows) keyed by its
    chained digest, so a spill hit revives the block with its EXACT bytes,
    token-identical to a resident hit.

    The serving thread only offers clones of the block (made on its
    stream, with an event recorded after them) and reads the store under
    `_lock` (`get`). The drain thread owns every device->host copy and
    all store mutation: on the card it copies on a stream of its own,
    after the event, into pinned host memory, and polls for the copy's
    end, so neither the serving stream nor the serving thread ever waits
    for it and no synchronizing CUDA call is made. The store is
    byte-bounded, trimmed oldest-first (`get` re-inserts on a hit, so it
    is LRU); the offer queue is bounded too and sheds under a burst. A
    revival that looks up a block not yet drained simply misses (a
    normal re-prefill)."""

    def __init__(self, cap_bytes: int, obs: Any = None):
        self.cap = int(cap_bytes)
        self._q: queue.Queue = queue.Queue(maxsize=256)
        # key -> (own-block token bytes, host tensors, nbytes)
        self._store: dict[bytes, tuple] = {}
        self._bytes = 0
        self._lock = threading.Lock()
        self._obs = obs
        self._stream = None  # the drain thread's copy stream (CUDA)
        self._thread = threading.Thread(
            target=self._drain_loop, name="kv-spill-drain", daemon=True
        )
        self._thread.start()

    def offer(self, key: bytes, tok: bytes, arrays: tuple,
              ready: Any = None) -> None:
        """Serving thread: hand over clones of an evicted block and the
        CUDA event that marks them written (None on the CPU). Never
        blocks; a full queue sheds the spill."""
        try:
            self._q.put_nowait((key, tok, arrays, ready))
        except queue.Full:
            pass

    def _to_host(self, arrays: tuple, ready: Any) -> tuple:
        """Drain thread: the block's tensors in host memory. CPU clones
        already are; CUDA ones are copied on the drain stream after
        `ready`, into pinned buffers, and the copy's end is polled."""
        if ready is None:
            return arrays
        dev = arrays[0].device
        with torch.cuda.device(dev):
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            side = self._stream
            side.wait_event(ready)
            host = []
            with torch.cuda.stream(side):
                for a in arrays:
                    a.record_stream(side)  # the clone lives on until then
                    h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                    h.copy_(a, non_blocking=True)
                    host.append(h)
            done = torch.cuda.Event()
            done.record(side)
        while not done.query():
            time.sleep(1e-4)
        return tuple(host)

    def _drain_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            key, tok, arrays, ready = item
            host = self._to_host(arrays, ready)
            nbytes = sum(a.numel() * a.element_size() for a in host)
            with self._lock:
                old = self._store.pop(key, None)
                if old is not None:
                    self._bytes -= old[2]
                self._store[key] = (tok, host, nbytes)
                self._bytes += nbytes
                while self._bytes > self.cap and self._store:
                    k0 = next(iter(self._store))
                    _, _, nb0 = self._store.pop(k0)
                    self._bytes -= nb0
                stored_bytes = self._bytes
            if self._obs is not None:
                self._obs.prefix_spilled.inc()
                self._obs.spill_bytes.set(stored_bytes)
            self._q.task_done()

    def get(self, key: bytes, tok: bytes) -> tuple | None:
        """Serving thread: the spill lookup on a radix walk miss, guarded
        by the block's own token bytes like every radix hit; a hit is
        LRU-touched and its host tensors returned for re-upload. The
        entry stays resident."""
        with self._lock:
            ent = self._store.get(key)
            if ent is None or ent[0] != tok:
                return None
            self._store[key] = self._store.pop(key)  # LRU touch
            return ent[1]

    def flush(self) -> None:
        """Block until every offered block has drained into the store
        (tests, stats; never on the tick path)."""
        self._q.join()

    @property
    def stored_blocks(self) -> int:
        with self._lock:
            return len(self._store)

    @property
    def stored_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=5)


class PrefixBlockCache:
    """Host-side EXACT radix cache over pool blocks (the vLLM/SGLang
    automatic-prefix-caching idea, block-granular); a copy of the JAX
    package's class, which this module must not import.

    A K/V block's content is a pure function of the token ANCESTRY it
    covers, so the cache keys each block by that ancestry: lookups walk
    a request's leading full prompt blocks and stop at the first miss.
    Blocks referenced by active requests carry a refcount; at refcount 0
    a block is RETAINED in LRU order and revived on a later hit, evicted
    (key dropped, block returned to the caller's free list) only under
    allocation pressure. Only full blocks whose rows are all prompt
    content are registered.

    Keys are CHAINED digests: block j's key is blake2b(key_{j-1} ||
    block_j's own bs tokens), so a walk over n full blocks hashes
    O(n * bs) bytes. Every hit is guarded by an exact comparison of the
    block's own token bytes (`tok_of`); along a sequential walk the
    ancestors were already verified, so a false hit would need a
    blake2b-128 collision AND identical own-block tokens.

    `obs`: optional ServingMetrics whose prefix-cache counters (parks,
    revivals, evictions) this cache drives; hits and misses are the
    admitting server's to count."""

    def __init__(self, obs: Any = None, on_evict: Any = None):
        # `on_evict(key, tok, blk)`: optional hook called before a block
        # is forgotten, while its pool payload is still addressable.
        self._on_evict = on_evict
        self.by_key: dict[bytes, int] = {}
        self.ref: dict[int, int] = {}
        self.key_of: dict[int, bytes] = {}
        self.tok_of: dict[int, bytes] = {}  # own-block tokens (guard)
        self.lru: dict[int, None] = {}  # refcount-0 blocks, dict=LRU
        self._obs = obs
        # `generation` bumps on every change to the resident key set
        # (register / evict / displacement), never on refcount churn;
        # the lock covers only key-set mutation and snapshotting.
        self.generation = 0
        self._lock = threading.Lock()

    @staticmethod
    def _hash(prev_key: bytes, block_bytes: bytes) -> bytes:
        """One chain link: key_j = H(key_{j-1} || block_j bytes)."""
        return hashlib.blake2b(
            prev_key + block_bytes, digest_size=16
        ).digest()

    def walk(
        self, tokens: np.ndarray, n_full: int, bs: int
    ) -> tuple[list[int], list[bytes], list[bytes]]:
        """Leading-hit walk over the n_full full prompt blocks: returns
        (hit pool blocks for blocks 0..k-1 where k is the first miss,
        the chained key of EVERY full block, each block's own token
        bytes). Bumps refcounts on hits (reviving LRU entries); a digest
        hit whose own-block tokens mismatch is treated as a miss."""
        flat = tokens[: n_full * bs].astype(np.int64)
        keys: list[bytes] = []
        toks: list[bytes] = []
        prev = b""
        for j in range(n_full):
            bb = flat[j * bs : (j + 1) * bs].tobytes()
            prev = self._hash(prev, bb)
            keys.append(prev)
            toks.append(bb)
        hits: list[int] = []
        for j in range(n_full):
            blk = self.by_key.get(keys[j])
            if blk is None or self.tok_of[blk] != toks[j]:
                break
            if self.ref[blk] == 0:
                self.lru.pop(blk, None)
                if self._obs is not None:
                    self._obs.prefix_revivals.inc()
            self.ref[blk] += 1
            hits.append(blk)
        return hits, keys, toks

    def register(
        self, key: bytes, block_bytes: bytes, blk: int
    ) -> int | None:
        """Publish a freshly prefilled full prompt block under its
        chained `key`, with refcount 1 held by the registrant. Returns a
        DISPLACED block to free if this key was still cached from an
        earlier, partially evicted chain (always refcount 0: an active
        holder of a deeper block holds the whole chain above it, which
        would have made this key a hit)."""
        displaced = self.by_key.get(key)
        if displaced is not None:
            if self.ref[displaced] != 0:
                raise RuntimeError(
                    f"prefix-cache invariant violated: key "
                    f"{key.hex()} would displace block {displaced} "
                    f"which still has {self.ref[displaced]} live "
                    f"reference(s) — an active chain holder should "
                    f"have made this key a hit"
                )
            del self.lru[displaced]
            del self.ref[displaced]
            del self.key_of[displaced]
            del self.tok_of[displaced]
        with self._lock:
            self.by_key[key] = blk
            self.generation += 1
        self.ref[blk] = 1
        self.key_of[blk] = key
        self.tok_of[blk] = block_bytes
        return displaced

    def release(self, blk: int) -> None:
        """Drop one reference; at 0 the block parks in LRU (still
        cached) rather than returning to the free list."""
        self.ref[blk] -= 1
        if self.ref[blk] == 0:
            self.lru[blk] = None
            if self._obs is not None:
                self._obs.prefix_parks.inc()

    def evict(self, n: int) -> list[int]:
        """Forget up to n least-recently-parked blocks; returns them
        for the free list."""
        out = []
        while self.lru and len(out) < n:
            blk = next(iter(self.lru))
            if self._on_evict is not None:
                self._on_evict(self.key_of[blk], self.tok_of[blk], blk)
            del self.lru[blk]
            with self._lock:
                del self.by_key[self.key_of.pop(blk)]
                self.generation += 1
            del self.ref[blk]
            del self.tok_of[blk]
            out.append(blk)
        if out and self._obs is not None:
            self._obs.prefix_evictions.inc(len(out))
        return out

    def resident_digests(self) -> tuple[int, frozenset[bytes]]:
        """(generation, resident chained digests): the routing
        advertisement, a shallow snapshot of the key set."""
        with self._lock:
            return self.generation, frozenset(self.by_key)

    @property
    def cached_blocks(self) -> int:
        return len(self.by_key)


class PagedDecodeServer:
    """Continuous batching over a paged KV pool; greedy by default,
    per-request sampling via `submit(..., sampling=)`.

    Protocol-compatible with runtime/decode_server.DecodeServer (submit
    -> run -> {rid: ids}), with the pool replacing per-slot max_len
    lanes. `num_blocks` INCLUDES the reserved trash block 0. The server
    runs on `dec.device` (CUDA unless the decoder was built on the CPU),
    where `params` must live."""

    def __init__(
        self,
        dec: Any,
        params: dict,
        *,
        num_blocks: int,
        block_size: int = 16,
        max_batch: int = 4,
        eos_id: int | None = None,
        on_token: Any = None,
        prefix_ids: torch.Tensor | None = None,
        prefix_cache: bool = False,
        attention: str = "gathered",
        kv_dtype: str = "fp",
        spill_bytes: int = 0,
        decode_window: int = 1,
        spec_draft: Any = None,
        spec_params: dict | None = None,
        spec_k: int = 0,
        prefill_chunk: int | None = None,
        prefill_budget: int | None = None,
        prefill_lookahead: int = 2,
        mesh: Any = None,
        model_axis: str = "model",
        device: Any = None,
        constraints: dict | None = None,
        pp_stages: int = 1,
        pp_inflight: int | None = None,
        pp_cuts: Any = None,
        pp_devices: Any = None,
        pp_remote: dict | None = None,
        pp_balance: str = "equal",
        pp_stage_axis: str = "stage",
    ):
        """The JAX package's knobs, validated in its order.

        `attention`: "gathered" (contiguous-view reference), "blockwise"
        (block-native plain PyTorch, reads stop at the deepest live
        block), or "pallas" (the hand-written paged kernels, each slot
        reading its own live blocks). `prefix_cache=True`: per-request
        radix prefix sharing (PrefixBlockCache). `prefix_ids` [1, P]:
        one system prompt's blocks, allocated once, P a block_size
        multiple; exclusive with prefix_cache. `prefill_chunk`: admission
        prefill runs pool-native through the multi-token step in chunks
        of this many tokens. `kv_dtype`: "fp" (the compute dtype) or
        "int8" (symmetric int8 with one f32 scale per layer, block and KV
        head: about half an fp16 pool's bytes). `spill_bytes`: a host-RAM
        spill tier of this many bytes for evicted prefix blocks (needs
        prefix_cache). `on_token(request_id, token_id, done)`: streaming
        callback; `eos_id`: stop token. The knobs this slice does not
        port raise NotImplementedError where the JAX package would
        accept them."""
        if getattr(dec, "rolling_cache", False):
            raise ValueError("paged serving does not support rolling caches")
        if any(":" in k for k in params["stack"]):
            raise _not_ported("multi-LoRA adapter banks", "6 (h)")
        if block_size < 1 or num_blocks < 2:
            raise ValueError(
                f"need block_size >= 1 and num_blocks >= 2 (one trash "
                f"block + one usable), got {block_size}/{num_blocks}"
            )
        if attention not in ("gathered", "blockwise", "pallas"):
            raise ValueError(
                f"attention must be 'gathered', 'blockwise' or "
                f"'pallas', got {attention!r}"
            )
        if kv_dtype not in ("fp", "int8"):
            raise ValueError(
                f"kv_dtype must be 'fp' or 'int8', got {kv_dtype!r}"
            )
        if spill_bytes < 0:
            raise ValueError(
                f"spill_bytes must be >= 0, got {spill_bytes}"
            )
        if spill_bytes and not prefix_cache:
            raise ValueError(
                "spill_bytes > 0 needs prefix_cache=True — the spill "
                "tier stores evicted PREFIX blocks keyed by the radix "
                "cache's chain digests"
            )
        if decode_window < 1:
            raise ValueError(
                f"decode_window must be >= 1, got {decode_window}"
            )
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if (spec_draft is not None or spec_params is not None) and not spec_k:
            raise ValueError(
                "spec_draft/spec_params provided but spec_k == 0 — "
                "pass spec_k >= 1 to turn speculation on"
            )
        if spec_k:
            if spec_draft is None or spec_params is None:
                raise ValueError(
                    "spec_k > 0 needs both spec_draft and spec_params "
                    "(the proposal model and its weights)"
                )
            raise _not_ported("speculative decoding (spec_k > 0)", "6 (e)")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}"
            )
        if prefill_lookahead < 1:
            raise ValueError(
                f"prefill_lookahead must be >= 1, got {prefill_lookahead}"
            )
        if prefill_budget is not None:
            if prefill_budget < 1:
                raise ValueError(
                    f"prefill_budget must be >= 1 prompt tokens per "
                    f"tick, got {prefill_budget}"
                )
            raise _not_ported(
                "stall-free mixed batching (prefill_budget=)", "6 (g)"
            )
        if mesh is not None and device is not None:
            raise ValueError(
                "mesh= and device= are mutually exclusive: a mesh "
                "already pins the server to its devices"
            )
        if pp_stages < 1:
            raise ValueError(f"pp_stages must be >= 1, got {pp_stages}")
        if pp_stages == 1 and (
            pp_inflight is not None
            or pp_cuts is not None
            or pp_devices is not None
            or pp_remote is not None
        ):
            raise ValueError(
                "pp_inflight/pp_cuts/pp_devices/pp_remote only apply "
                "with pp_stages > 1"
            )
        if pp_stages > 1:
            raise _not_ported(
                "pipeline-parallel serving (pp_stages > 1)", "7"
            )
        if pp_balance not in ("equal", "probe"):
            raise ValueError(
                f"pp_balance must be 'equal' or 'probe', got {pp_balance!r}"
            )
        if mesh is not None:
            raise _not_ported("tensor-parallel serving (mesh=)", "7")
        if device is not None:
            raise _not_ported(
                "pinning a server to a device (device=; it runs on "
                "dec.device)", "7"
            )
        if decode_window > 1:
            raise _not_ported("decode_window > 1", "6 (d)")
        if constraints is not None:
            if eos_id is None:
                raise ValueError(
                    "constraints= requires eos_id: a satisfied "
                    "constraint stops by emitting eos"
                )
            raise _not_ported("constrained decoding (constraints=)", "6 (h)")
        cfg = dec.cfg
        self.decode_window = decode_window
        self.attention = attention
        self.kv_dtype = kv_dtype
        self.dec = dec
        self.params = params
        self.device = dec.device
        self.B = max_batch
        self.bs = block_size
        self.eos_id = eos_id
        self.on_token = on_token
        # Max logical blocks any sequence can span.
        self.MB = -(-cfg.max_len // block_size)
        self.num_blocks = num_blocks
        dh = cfg.dim // cfg.num_heads
        pool_shape = (cfg.num_layers, num_blocks, cfg.kv_heads, block_size, dh)
        # An int8 pool is a {"q", "s"} pair per K and V: int8 rows and one
        # f32 scale per (layer, block, KV head), at 1.0 so a never-written
        # block dequantizes to the zeros an fp pool holds.
        scale_shape = pool_shape[:3]
        pools = []
        for _ in range(2):
            if kv_dtype == "int8":
                pools.append({
                    "q": torch.zeros(pool_shape, dtype=torch.int8,
                                     device=self.device),
                    "s": torch.ones(scale_shape, dtype=torch.float32,
                                    device=self.device),
                })
            else:
                pools.append(torch.zeros(pool_shape, dtype=dec.compute_dtype,
                                         device=self.device))
        self.pool_k, self.pool_v = pools
        self.pool_bytes = sum(
            t.numel() * t.element_size()
            for pool in pools
            for t in (pool.values() if isinstance(pool, dict) else [pool])
        )
        # Block 0 is trash: unallocated table entries point at it.
        self.free = list(range(1, num_blocks))
        # Host mirrors (accounting, the blockwise fold's bound) and their
        # device copies (what the steps read); both change only at
        # admission and finish, except the positions a tick advances.
        self.tables = np.zeros((max_batch, self.MB), np.int32)
        self.pos = np.zeros((max_batch,), np.int32)
        self._tables_dev = torch.zeros((max_batch, self.MB),
                                       dtype=torch.int32, device=self.device)
        self._pos_dev = torch.zeros((max_batch,), dtype=torch.int32,
                                    device=self.device)
        self._active = torch.zeros((max_batch,), dtype=torch.int32,
                                   device=self.device)
        self._rows = torch.arange(max_batch, device=self.device)
        self.slots: list[dict | None] = [None] * max_batch
        # Persistent tick feed: each slot's next input token in row i.
        self._feed = torch.zeros((max_batch, 1), dtype=torch.int32,
                                 device=self.device)
        self._sampler = SlotSampler(max_batch, self.device)
        self.pending: collections.deque[tuple] = collections.deque()
        self.done: dict[int, torch.Tensor] = {}
        self._next_id = 0
        self.ticks = 0
        self.blocks_peak = 0
        self.dispatches = 0
        self.window_tokens = 0
        # Prefill chunks run through the multi-token step (host count).
        self.prefill_chunks = 0
        self.obs = ServingMetrics("paged")
        self.obs.kv_pool_bytes.set(self.pool_bytes)
        self._submit_t: dict[int, float] = {}
        self._last_tick_t: float | None = None
        self.prefill_chunk = prefill_chunk
        # Stall accounting: admission-prefill dispatches issued while a
        # decode slot sat waiting.
        self.prefill_stall_ticks_n = 0
        self.decode_stall_fraction_last = 0.0
        self.prefix_len = 0
        self.shared_blocks: list[int] = []
        self._prefix_cache = None
        self.radix: PrefixBlockCache | None = None
        self.prefill_tokens_saved = 0
        self._spill: HostKVSpill | None = None
        self.spill_hits_n = 0
        if prefix_cache:
            if prefix_ids is not None:
                raise ValueError(
                    "prefix_cache=True subsumes the global prefix_ids "
                    "— pass the system prompt as part of each "
                    "request's prompt and it shares automatically"
                )
            if spill_bytes:
                self._spill = HostKVSpill(spill_bytes, obs=self.obs)
            self.radix = PrefixBlockCache(
                obs=self.obs,
                on_evict=(
                    self._spill_block if self._spill is not None else None
                ),
            )
        if prefix_ids is not None:
            if prefix_ids.ndim != 2 or prefix_ids.shape[0] != 1:
                raise ValueError("prefix_ids must be [1, P]")
            P = int(prefix_ids.shape[1])
            if P % block_size:
                raise ValueError(
                    f"shared-prefix paging needs the prefix length "
                    f"({P}) to be a block_size ({block_size}) multiple "
                    "— otherwise a suffix write would land in a "
                    "SHARED block and corrupt every other request"
                )
            if P >= cfg.max_len:
                raise ValueError(
                    f"prefix of {P} leaves no room under max_len "
                    f"{cfg.max_len}"
                )
            n_shared = P // block_size
            if n_shared > len(self.free):
                raise ValueError(
                    f"prefix needs {n_shared} blocks but the pool has "
                    f"{len(self.free)} usable"
                )
            # One prefix prefill through the flat path; its rows become
            # the pool's single shared copy, and the contiguous lane stays
            # for suffix admissions (the suffix prefill attends it at
            # offset P).
            pre = dec.init_cache(1)
            _, pre = dec.make_step()(params, pre, prefix_ids.to(self.device))
            self.shared_blocks = [self.free.pop() for _ in range(n_shared)]
            shared_row = np.zeros((self.MB,), np.int32)
            shared_row[:n_shared] = self.shared_blocks
            self._insert(pre["k"], pre["v"], shared_row, 0, n_shared)
            self._prefix_cache = pre
            self.prefix_len = P

    # -- public API -------------------------------------------------------

    def submit(
        self,
        prompt_ids: torch.Tensor,
        num_steps: int,
        *,
        adapter_id: int = 0,
        sampling: Any = None,
        stop: Any = None,
    ) -> int:
        """Queue a request [1, T]; returns its id (resolved in .done).
        `sampling`: an optional SamplingParams (None or temperature 0 =
        greedy); the slot samples inside the shared tick from its own
        seeded generator. `stop`: optional multi-token stop sequences;
        the request finishes the moment its generated tail equals one,
        freeing its blocks mid-budget."""
        if prompt_ids.ndim != 2 or prompt_ids.shape[0] != 1:
            raise ValueError("submit one request at a time ([1, T])")
        if sampling is not None:
            sampling.validate()
            if sampling.constraint is not None:
                raise _not_ported("constrained decoding (constraint=)", "6 (h)")
            if sampling.temperature == 0:
                sampling = None  # greedy: keep the argmax fast path
        stop_seqs = normalize_stops(stop)
        if adapter_id:
            raise _not_ported("multi-LoRA adapters (adapter_id != 0)", "6 (h)")
        t0 = prompt_ids.shape[1]
        if t0 < 1 or num_steps < 1:
            raise ValueError("need at least 1 prompt token and 1 step")
        if self.prefix_len + t0 + num_steps > self.dec.cfg.max_len:
            raise ValueError(
                f"prefix {self.prefix_len} + prompt {t0} + steps "
                f"{num_steps} exceeds max_len {self.dec.cfg.max_len}"
            )
        need = self._own_need(t0, num_steps)
        usable = self.num_blocks - 1 - len(self.shared_blocks)
        if need > usable:
            # Not even an empty pool could hold it — waiting would
            # deadlock the queue.
            raise ValueError(
                f"request needs {need} own blocks but the pool has "
                f"{usable} usable beyond the shared prefix"
            )
        rid = self._next_id
        self._next_id += 1
        # The host copy feeds the radix walk; the device copy, the steps
        # and the output.
        self.pending.append(
            (rid, prompt_ids.cpu(), prompt_ids.to(self.device), num_steps,
             sampling, stop_seqs)
        )
        self._submit_t[rid] = time.perf_counter()
        return rid

    def _own_need(self, t0: int, steps: int) -> int:
        """Blocks a request must own: its total span minus the shared
        prefix blocks its table merely points at."""
        total = -(-(self.prefix_len + t0 + steps) // self.bs)
        return total - len(self.shared_blocks)

    def submit_prefilled(self, *args, **kwargs):
        raise _not_ported("disaggregated prefill (submit_prefilled)", "6, disagg/")

    def deliver_kv(self, *args, **kwargs):
        raise _not_ported("disaggregated prefill (deliver_kv)", "6, disagg/")

    def export_prefix_blocks(self, *args, **kwargs):
        raise _not_ported("prefix migration (export_prefix_blocks)", "6, fleet/")

    def import_prefix_blocks(self, *args, **kwargs):
        raise _not_ported("prefix migration (import_prefix_blocks)", "6, fleet/")

    def run(self) -> dict[int, torch.Tensor]:
        """Serve until every submitted request completes; returns
        {request_id: ids [1, T0 + num_steps]} (shorter when eos or a
        stop sequence ended a request early)."""
        while self.step():
            pass
        return self.done

    def step(self) -> bool:
        """One round of `run`: admit what the pool and the free slots
        take, then one decode tick over the live slots. Returns False,
        doing nothing, once every submitted request has completed. With
        nothing to admit, a round is exactly one tick, so a caller can
        drive and time steady ticks through it."""
        if not (self.pending or any(self.slots)):
            return False
        self._admit()
        if any(s is not None for s in self.slots):
            self._tick()
        return True

    @property
    def blocks_in_use(self) -> int:
        if self.radix is not None:
            # Everything neither free nor parked at refcount 0 is held
            # by an active request (shared blocks counted once).
            return (
                (self.num_blocks - 1)
                - len(self.free)
                - len(self.radix.lru)
            )
        return sum(len(s["blocks"]) for s in self.slots if s)

    def resident_digests(self) -> tuple[int, frozenset[bytes]]:
        """The radix cache's routing advertisement; (0, empty) without
        prefix_cache=True."""
        if self.radix is None:
            return 0, frozenset()
        return self.radix.resident_digests()

    def flush_spill(self) -> None:
        """Block until every block evicted so far has drained into the
        host spill store, so that a later admission can revive it (a
        block still in flight would miss and re-prefill). A no-op
        without spill_bytes."""
        if self._spill is not None:
            self._spill.flush()

    # -- pool programs ----------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host int array on the device, as int32 (the kernels' table
        type), without a host sync: on CUDA through a fresh pinned
        buffer that is never written again, so the asynchronous copy
        cannot race a later host write."""
        t = torch.from_numpy(np.array(arr, dtype=np.int32))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _insert(self, small_k, small_v, table_row, skip: int, n: int,
                valid: int | None = None):
        """Scatter a contiguous single-request cache [L, 1, Hkv, S, Dh]
        into the pool blocks table_row[skip:n]. Rows past the prompt
        are garbage the position mask hides. The leading `skip` blocks
        (a shared prefix, or radix hits: other requests' memory) are
        never written; neither is trash, which the JAX package writes
        with garbage, so the pool's live content is the same.

        An int8 pool quantizes the blocks as they land. `valid` (a radix
        admission's prompt length) zeroes the lane rows at and past it
        first: that lane was gathered from the pool, so those rows are a
        previous tenant's garbage, which would inflate the block scales.
        The fp pool ignores it."""
        if n <= skip:
            return
        bs = self.bs
        dest = self._upload(table_row[skip:n])
        for pool, small in ((self.pool_k, small_k), (self.pool_v, small_v)):
            rows = small[:, 0, :, : n * bs]  # [L, Hkv, <=n*bs, Dh]
            if rows.shape[2] < n * bs:
                rows = F.pad(rows, (0, 0, 0, n * bs - rows.shape[2]))
            L, hkv, _, dh = rows.shape
            if isinstance(pool, dict) and valid is not None:
                live = torch.arange(n * bs, device=rows.device) < valid
                rows = rows * live[None, None, :, None].to(rows.dtype)
            blocks = rows.reshape(L, hkv, n, bs, dh).transpose(1, 2)
            if isinstance(pool, dict):
                qb, sb = _quantize_blocks(blocks[:, skip:])
                pool["q"][:, dest] = qb
                pool["s"][:, dest] = sb
            else:
                pool[:, dest] = blocks[:, skip:]

    def _gather(self, table_row: torch.Tensor):
        """The flat single-lane K/V [L, 1, Hkv, MB * bs, Dh] of a table
        row in the compute dtype (an int8 pool dequantized), the inverse
        layout of `_insert`: radix admissions hand cached prefix blocks
        to the flat suffix prefill this way."""
        out = []
        for pool in (self.pool_k, self.pool_v):
            if isinstance(pool, dict):
                kc = dequantize_symmetric(
                    pool["q"][:, table_row],
                    pool["s"][:, table_row][..., None, None],
                    self.dec.compute_dtype,
                )
            else:
                kc = pool[:, table_row]  # [L, MB, Hkv, bs, Dh]
            L, mb, hkv, bs, dh = kc.shape
            out.append(
                kc.transpose(1, 2).reshape(L, hkv, mb * bs, dh)[:, None]
            )
        return out

    def _gathered_view(self, pool_l, idx):
        """A layer's contiguous [B, Hkv, MB * bs, Dh] view of the
        slots' tables (a copy) in the compute dtype: an int8 pool
        dequantizes at the gather, the multiply in that dtype."""
        if isinstance(pool_l, dict):
            kc = dequantize_symmetric(
                pool_l["q"][idx], pool_l["s"][idx][..., None, None],
                self.dec.compute_dtype,
            )
        else:
            kc = pool_l[idx]  # [B, MB, Hkv, bs, Dh]
        b, mb, hkv, bs, dh = kc.shape
        return kc.transpose(1, 2).reshape(b, hkv, mb * bs, dh)

    @torch.no_grad()
    def _step(self, nb_live: int) -> torch.Tensor:
        """One decode tick over every slot: feed [B, 1] at the device
        positions through the slots' tables. Idle slots sit at position
        0 with an all-trash table, so their write lands in trash block 0
        row 0. Returns logits [B, 1, V] in f32."""
        dec, bs = self.dec, self.bs
        params = self.params
        window = dec.cfg.window
        tables, pos = self._tables_dev, self._pos_dev
        x = dec._embed_tokens(params, self._feed, pos)
        blk_w = tables.gather(1, (pos // bs).long()[:, None])[:, 0].long()
        row_w = (pos % bs).long()
        stack = params["stack"]
        if self.attention == "gathered":
            plan = dec._plan(pos, 1, self.MB * bs)
            idx = tables.long()
            posl = pos.long()
            for layer in range(dec.cfg.num_layers):
                pk_l = _pool_layer(self.pool_k, layer)
                pv_l = _pool_layer(self.pool_v, layer)
                kc = self._gathered_view(pk_l, idx)
                vc = self._gathered_view(pv_l, idx)
                x = dec._block(_layer_view(stack, layer), x, kc, vc, pos, plan)
                # Scatter ONLY the new row back to its page.
                _pool_write_rows(pk_l, blk_w, row_w, kc[self._rows, :, posl])
                _pool_write_rows(pv_l, blk_w, row_w, vc[self._rows, :, posl])
            return dec._final_logits(params, x)
        # "blockwise" folds table columns 0..nb_live-1 in plain PyTorch
        # (the JAX package's `_blockwise_attend`); "pallas" launches the
        # kernel, each slot reading its own live blocks.
        attend = (
            functools.partial(paged_flash_decode_plain, num_blocks=nb_live)
            if self.attention == "blockwise" else paged_flash_decode
        )
        rope = dec._rope(pos, 1)
        for layer in range(dec.cfg.num_layers):
            p = _layer_view(stack, layer)
            pk_l = _pool_layer(self.pool_k, layer)
            pv_l = _pool_layer(self.pool_v, layer)
            q, k_new, v_new = dec._attn_qkv(p, x, rope)
            # Write-then-attend, on one stream.
            _pool_write_rows(pk_l, blk_w, row_w, k_new[:, :, 0, :])
            _pool_write_rows(pv_l, blk_w, row_w, v_new[:, :, 0, :])
            b, hq, _, dh = q.shape
            # An int8 pool goes to the kernel as it is: payload + scales.
            attn = attend(
                q[:, :, 0, :], _pool_arr(pk_l), _pool_arr(pv_l), tables, pos,
                window=window, scale_k=_pool_scale(pk_l),
                scale_v=_pool_scale(pv_l),
            ).to(x.dtype).reshape(b, 1, hq * dh)
            x = dec._attn_out(p, x, attn)
        return dec._final_logits(params, x)

    @torch.no_grad()
    def _mt(self, tables, pos, ids, n_keep, keep_from, nb_live):
        """The multi-token paged step: ids [B, T], row t of slot b at
        absolute position pos[b] + t, K/V read through the tables and
        all T new rows scattered back. A row's write redirects to trash
        block 0 when the slot does not keep it: row index >= n_keep[b]
        (a prefill tail's pad rows) or position < keep_from[b] (radix
        hit rows, other requests' memory). Returns logits [B, T, V]."""
        dec, bs, mb = self.dec, self.bs, self.MB
        params = self.params
        window = dec.cfg.window
        b, t = ids.shape
        steps = torch.arange(t, device=self.device)
        pvec = pos[:, None] + steps  # [B, T]
        # The column clamp keeps headroom rows past the table (dead
        # writes only) in range.
        blk = tables.long().gather(1, (pvec // bs).clamp(max=mb - 1))
        keep = (steps[None, :] < n_keep[:, None]) & (
            pvec >= keep_from[:, None]
        )
        dest = torch.where(keep, blk, 0)
        rowi = pvec % bs
        x = dec._embed_tokens(params, ids, pos)
        stack = params["stack"]
        if self.attention == "gathered":
            plan = dec._plan(pos, t, mb * bs)
            idx = tables.long()
            rows = torch.arange(b, device=self.device)[:, None]
            for layer in range(dec.cfg.num_layers):
                pk_l = _pool_layer(self.pool_k, layer)
                pv_l = _pool_layer(self.pool_v, layer)
                kc = self._gathered_view(pk_l, idx)
                vc = self._gathered_view(pv_l, idx)
                x = dec._block(_layer_view(stack, layer), x, kc, vc, pos, plan)
                # Multi-row scatter-back: T fresh rows per slot.
                _pool_write_rows_mt(pk_l, dest, rowi, kc[rows, :, pvec])
                _pool_write_rows_mt(pv_l, dest, rowi, vc[rows, :, pvec])
            return dec._final_logits(params, x)
        # The multi-token sibling of `_step`'s choice (the JAX package's
        # `_blockwise_attend_mt` fold, or the prefill kernel).
        attend = (
            functools.partial(paged_flash_prefill_plain, num_blocks=nb_live)
            if self.attention == "blockwise" else paged_flash_prefill
        )
        rope = dec._rope(pos, t)
        for layer in range(dec.cfg.num_layers):
            p = _layer_view(stack, layer)
            pk_l = _pool_layer(self.pool_k, layer)
            pv_l = _pool_layer(self.pool_v, layer)
            q, k_new, v_new = dec._attn_qkv(p, x, rope)
            # Write-then-attend, on one stream.
            _pool_write_rows_mt(pk_l, dest, rowi, k_new.transpose(1, 2))
            _pool_write_rows_mt(pv_l, dest, rowi, v_new.transpose(1, 2))
            _, hq, _, dh = q.shape
            attn = attend(
                q, _pool_arr(pk_l), _pool_arr(pv_l), tables, pos,
                window=window, scale_k=_pool_scale(pk_l),
                scale_v=_pool_scale(pv_l),
            ).transpose(1, 2).reshape(b, t, hq * dh).to(x.dtype)
            x = dec._attn_out(p, x, attn)
        return dec._final_logits(params, x)

    def _prefill_paged(self, prompt, table_row, *, base, keep_from):
        """Chunked POOL-NATIVE prefill: run `prompt` [1, T0] (on the
        device) through the multi-token step in prefill_chunk-token
        chunks, writing K/V straight into the allocated blocks through
        the table. `base`: absolute position of prompt[:, 0]; positions
        below `keep_from` write to trash block 0 (radix hit rows). Tail
        chunks pad to a power of two, as the JAX package's do (so the
        chunk boundaries and shapes match), capped so the deepest write
        stays inside the table span. Returns the [1, V] logits row of
        the last real prompt position."""
        C = self.prefill_chunk
        t0 = prompt.shape[1]
        dev = self.device
        tab = self._upload(table_row[None, :])
        kf = torch.full((1,), keep_from, dtype=torch.int32, device=dev)
        limit = self.MB * self.bs
        logits_row = None
        start = 0
        while start < t0:
            real = min(C, t0 - start)
            pos0 = base + start
            pad_t = 1 << (real - 1).bit_length()
            pad_t = min(max(pad_t, 1), min(C, limit - pos0))
            chunk = prompt[:, start : start + real]
            if pad_t > real:
                chunk = torch.cat(
                    [chunk, chunk.new_zeros((1, pad_t - real))], dim=1
                )
            nb_live = min((pos0 + pad_t - 1) // self.bs + 1, self.MB)
            logits = self._mt(
                tab,
                torch.full((1,), pos0, dtype=torch.int32, device=dev),
                chunk,
                torch.full((1,), real, dtype=torch.int32, device=dev),
                kf,
                nb_live,
            )
            self.prefill_chunks += 1
            self._account_kv_rows_prefill(pos0, pad_t)
            self._note_prefill_stall(1)
            logits_row = logits[:, real - 1, :]
            start += real
        return logits_row

    # -- accounting -------------------------------------------------------

    def _account_kv_rows(self, rows_read: int, baseline: int) -> None:
        """Publish one dispatch's KV-row traffic (obs/serving.py units:
        one K+V row pair of one slot, layer-agnostic)."""
        self.obs.kv_rows_read.inc(rows_read)
        self.obs.kv_rows_gathered.inc(baseline)
        self.obs.kv_rows_last.set(rows_read)

    def _account_kv_rows_prefill(self, pos0: int, t: int) -> None:
        """Pool rows one prefill chunk's attention read: a B=1
        multi-token step whose deepest row attends at pos0 + t - 1.
        Derived from max_len and the chunk's live span, never from pool
        size."""
        bs = self.bs
        baseline = self.MB * bs
        if self.attention == "gathered":
            rows_read = baseline
        elif self.attention == "blockwise":
            rows_read = ((pos0 + t - 1) // bs + 1) * bs
        else:  # pallas
            lo, hi = _prefill_lo_hi(pos0, t, bs, self.dec.cfg.window)
            rows_read = (hi - lo + 1) * bs
        self._account_kv_rows(rows_read, baseline)

    def _note_prefill_stall(self, n_dispatches: int) -> None:
        """Account admission-prefill dispatches: each one issued while a
        decode slot is live is a stall tick."""
        if any(s is not None for s in self.slots):
            self.prefill_stall_ticks_n += n_dispatches
            self.obs.prefill_stall_ticks.inc(n_dispatches)
        self._update_stall_fraction()

    def _update_stall_fraction(self) -> None:
        """decode_stall_fraction = stall ticks / (decode ticks + stall
        ticks)."""
        denom = self.ticks + self.prefill_stall_ticks_n
        frac = self.prefill_stall_ticks_n / denom if denom else 0.0
        self.decode_stall_fraction_last = frac
        self.obs.decode_stall_fraction.set(frac)

    def _update_pool_gauges(self) -> None:
        self.obs.pool_blocks_free.set(len(self.free))
        self.obs.pool_blocks_used.set(self.blocks_in_use)

    # -- the spill tier ---------------------------------------------------

    def _spill_block(self, key: bytes, tok: bytes, blk: int) -> None:
        """PrefixBlockCache on_evict hook (serving thread): clone the
        evicted block's stored bytes on the serving stream and hand the
        clones to the drain thread with an event recorded after them.
        The pool is written in place and the block is about to be
        reused, so a view would read its next tenant's rows; the clone
        is ordered before any later write on the stream. Nothing here
        waits for the card."""
        arrays = tuple(t[:, blk : blk + 1].clone() for t in self._leaves())
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        self._spill.offer(key, tok, arrays, ready)

    def _leaves(self) -> tuple:
        """The pool's tensors, [L, NB, ...] each: K's int8 payload and
        scales then V's, or the fp K and V."""
        if isinstance(self.pool_k, dict):
            return (self.pool_k["q"], self.pool_k["s"],
                    self.pool_v["q"], self.pool_v["s"])
        return (self.pool_k, self.pool_v)

    def _revive_spilled(self, hits: list[int], keys: list[bytes],
                        toks: list[bytes], n_full: int) -> list[int]:
        """Extend a radix walk's leading hit run from the spill tier: for
        each miss, look the chain digest up in the store and, on a
        (token-guarded) hit, upload the stored bytes VERBATIM into a
        fresh block and register it. No dequantize/requantize round
        trip, so a revived block is bit-identical to the parked block it
        was spilled from, and a spill hit is token-identical to a
        resident one. Stops at the first store miss (block j is
        meaningless without 0..j-1) or when the pool yields no block.
        The upload reads pinned host tensors that the store keeps (and
        the host allocator holds until the copy has run)."""
        j = len(hits)
        while j < n_full:
            got = self._spill.get(keys[j], toks[j])
            if got is None:
                break
            if not self.free:
                self.free.extend(self.radix.evict(1))
                if not self.free:
                    break
            blk = self.free.pop()
            for dst, src in zip(self._leaves(), got):
                dst[:, blk].copy_(src[:, 0], non_blocking=True)
            displaced = self.radix.register(keys[j], toks[j], blk)
            if displaced is not None:
                self.free.append(displaced)
            hits.append(blk)
            self.spill_hits_n += 1
            self.obs.prefix_spill_hits.inc()
            j += 1
        return hits

    # -- admission --------------------------------------------------------

    def _flat_prefill(self, small, suffix, base):
        """Contiguous prefill of `suffix` [1, ts] at offset `base` on the
        flat lane `small`, bucketed to a power of two and capped inside
        max_len, as the flat server's admission: returns (the last real
        logits row, the lane)."""
        ts = suffix.shape[1]
        pad = 1 << (ts - 1).bit_length()
        pad = min(pad, self.dec.cfg.max_len - base)
        padded = torch.cat([suffix, suffix.new_zeros((1, pad - ts))], dim=1)
        logits, small = self.dec.make_step(
            donate=self._prefix_cache is None
        )(self.params, small, padded)
        self._note_prefill_stall(1)
        return logits[:, ts - 1, :], small

    def _admit_radix(self, i, rid, prompt, prompt_dev, steps, samp,
                     stop_seqs) -> bool:
        """Admission through the PrefixBlockCache: walk leading full
        prompt blocks for hits (refcount++), allocate the rest (evicting
        parked blocks only under pressure), prefill ONLY the suffix,
        then publish this request's fresh full prompt blocks. Returns
        False (the request waits, refcounts rolled back) when even
        eviction cannot cover the need."""
        bs = self.bs
        t0 = prompt.shape[1]
        n_full = t0 // bs
        total = -(-(t0 + steps) // bs)
        hits, keys, toks = self.radix.walk(prompt[0].numpy(), n_full, bs)
        if self._spill is not None and len(hits) < n_full:
            hits = self._revive_spilled(hits, keys, toks, n_full)
        need = total - len(hits)
        if need > len(self.free):
            self.free.extend(self.radix.evict(need - len(self.free)))
        if need > len(self.free):
            for blk in hits:
                self.radix.release(blk)
            return False
        own = [self.free.pop() for _ in range(need)]
        self.obs.requests_admitted.inc()
        self.obs.prefix_hits.inc(len(hits))
        self.obs.prefix_misses.inc(n_full - len(hits))
        self.obs.queue_wait.observe(
            time.perf_counter() - self._submit_t[rid]
        )
        table_row = np.zeros((self.MB,), np.int32)
        table_row[:total] = hits + own
        # Reuse at most t0 - 1 cached positions: the LAST prompt token
        # goes through the step so that its logits exist.
        suffix_pos = min(len(hits) * bs, t0 - 1)
        suffix = prompt_dev[:, suffix_pos:]
        self.obs.prefill_tokens.inc(suffix.shape[1])
        if self.prefill_chunk is not None:
            # Pool-native: hit blocks are read through the table, fresh
            # rows scatter into this request's blocks chunk by chunk,
            # and rows below keep_from (hit rows) redirect to trash.
            logits_row = self._prefill_paged(
                suffix, table_row, base=suffix_pos, keep_from=len(hits) * bs
            )
        else:
            if hits:
                gk, gv = self._gather(self._upload(table_row))
                small = {
                    "k": gk,
                    "v": gv,
                    "pos": torch.full((), suffix_pos, dtype=torch.int32,
                                      device=self.device),
                }
            else:
                small = self.dec.init_cache(1)
            logits_row, small = self._flat_prefill(small, suffix, suffix_pos)
            # Hit blocks are never rewritten: their recomputed rows are
            # equivalent, not guaranteed identical, and they belong to
            # every holder of the chain.
            self._insert(small["k"], small["v"], table_row, len(hits), total,
                         valid=t0)
        for j in range(len(hits), n_full):
            displaced = self.radix.register(keys[j], toks[j],
                                            int(table_row[j]))
            if displaced is not None:
                self.free.append(displaced)
        shared = hits + [int(table_row[j]) for j in range(len(hits), n_full)]
        owned = [int(table_row[j]) for j in range(n_full, total)]
        self.prefill_tokens_saved += suffix_pos
        self.blocks_peak = max(self.blocks_peak, self.blocks_in_use)
        self._seat(i, rid, prompt_dev, steps, samp, stop_seqs, table_row,
                   t0, logits_row, owned, shared)
        return True

    def _admit(self) -> None:
        for i in range(self.B):
            if self.slots[i] is not None or not self.pending:
                continue
            rid, prompt, prompt_dev, steps, samp, stop_seqs = self.pending[0]
            if self.radix is not None:
                if not self._admit_radix(i, rid, prompt, prompt_dev, steps,
                                         samp, stop_seqs):
                    return  # pool exhausted even after eviction
                self.pending.popleft()
                continue
            t0 = prompt.shape[1]
            P = self.prefix_len
            n_shared = len(self.shared_blocks)
            need = self._own_need(t0, steps)
            if need > len(self.free):
                return  # pool exhausted: wait for a finisher
            self.pending.popleft()
            blocks = [self.free.pop() for _ in range(need)]
            self.obs.requests_admitted.inc()
            self.obs.prefill_tokens.inc(t0)
            self.obs.queue_wait.observe(
                time.perf_counter() - self._submit_t[rid]
            )
            self.blocks_peak = max(self.blocks_peak,
                                   self.blocks_in_use + need)
            table_row = np.zeros((self.MB,), np.int32)
            table_row[:n_shared] = self.shared_blocks
            table_row[n_shared : n_shared + need] = blocks
            if self.prefill_chunk is not None:
                # A global shared prefix (base=P) is read from its pool
                # blocks by the block-table attention.
                logits_row = self._prefill_paged(
                    prompt_dev, table_row, base=P, keep_from=0
                )
            else:
                # Contiguous prefill through the flat decoder, then page
                # the rows in; with a shared prefix the suffix prefills
                # at offset P on a copy of the prefix lane, and only the
                # rows past the shared blocks are paged.
                small = (
                    self.dec.init_cache(1)
                    if self._prefix_cache is None
                    else self._prefix_cache
                )
                logits_row, small = self._flat_prefill(small, prompt_dev, P)
                self._insert(small["k"], small["v"], table_row, n_shared,
                             n_shared + need)
            self._seat(i, rid, prompt_dev, steps, samp, stop_seqs, table_row,
                       P + t0, logits_row, blocks, None)

    def _seat(self, i, rid, prompt_dev, steps, samp, stop_seqs, table_row,
              pos_val, logits_row, owned, shared) -> None:
        """Install an admitted request in slot i: its first token, its
        table and position (host and device), and the eos/streaming/
        finish bookkeeping."""
        first = self._sampler.admit_first(i, samp, logits_row,
                                          prompt_dev.dtype)
        self.tables[i] = table_row
        self.pos[i] = pos_val
        self._tables_dev[i] = self._upload(table_row)
        self._pos_dev[i] = pos_val
        self._active[i] = 1
        slot = {
            "rid": rid,
            "remaining": steps - 1,
            "last": first,
            "toks": [prompt_dev, first],
            "blocks": owned,
            "sampling": samp is not None,
            "stop": matcher_or_none(stop_seqs),
        }
        if shared is not None:
            slot["shared"] = shared
        self.slots[i] = slot
        self._feed[i, 0] = first[0, 0]
        # ttft spans queue + prefill (popped here, the drain point).
        self.obs.ttft.observe(time.perf_counter() - self._submit_t.pop(rid))
        self._update_pool_gauges()
        need_host = (
            self.eos_id is not None
            or self.on_token is not None
            or slot["stop"] is not None
        )
        self._emit_token(i, slot, int(first[0, 0]) if need_host else None)

    # -- the tick ---------------------------------------------------------

    def _tick(self) -> None:
        live = [s is not None for s in self.slots]
        if not any(live):
            return
        posm = np.where(live, self.pos, 0)
        nb_live = int(posm.max()) // self.bs + 1
        logits = self._step(nb_live)
        self.ticks += 1
        self.dispatches += 1
        n_live = sum(live)
        now = time.perf_counter()
        if self._last_tick_t is not None:
            self.obs.itl.observe(now - self._last_tick_t, n_live)
        self._last_tick_t = now
        self.obs.ticks.inc()
        self.obs.host_dispatches.inc()
        self._update_stall_fraction()
        self.obs.tokens_per_dispatch.set(float(n_live))
        self.window_tokens += n_live
        # K/V rows the attention path read this tick vs the gathered
        # baseline: "blockwise" reads every slot to the batch's deepest
        # live block, "pallas" each slot's own live span.
        baseline = self.B * self.MB * self.bs
        if self.attention == "gathered":
            rows_read = baseline
        elif self.attention == "blockwise":
            rows_read = self.B * nb_live * self.bs
        else:  # pallas
            spans = (_decode_lo_hi(int(p), self.bs, self.dec.cfg.window)
                     for p in posm)
            rows_read = sum(hi - lo + 1 for lo, hi in spans) * self.bs
        self._account_kv_rows(rows_read, baseline)
        ll = logits[:, -1, :]
        if any(s is not None and s["sampling"] for s in self.slots):
            nxt = self._sampler.draw(ll)
        else:
            nxt = torch.argmax(ll, dim=-1)
        self._feed = nxt[:, None].to(torch.int32)
        # Live slots advance one row, on the device; idle ones stay at 0.
        self._pos_dev += self._active
        # One device->host transfer per tick, and only for a consumer of
        # host tokens (eos, stop sequences, streaming).
        need_host = (
            self.eos_id is not None
            or self.on_token is not None
            or any(s is not None and s["stop"] is not None
                   for s in self.slots)
        )
        host_nxt = nxt.tolist() if need_host else None
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            tok = nxt[i].reshape(1, 1).to(slot["last"].dtype)
            slot["last"] = tok
            slot["toks"].append(tok)
            slot["remaining"] -= 1
            self.pos[i] += 1
            self._emit_token(i, slot,
                             host_nxt[i] if host_nxt is not None else None)

    def _emit_token(self, i: int, slot: dict, tok: int | None) -> None:
        """Shared eos/streaming/finish bookkeeping for one emitted token:
        `tok` is the host-side value, or None when no consumer needed
        the transfer."""
        self.obs.tokens_generated.inc()
        if self.eos_id is not None and tok is not None and tok == self.eos_id:
            slot["remaining"] = 0
        if (
            slot["stop"] is not None
            and tok is not None
            and slot["stop"].push(tok)
        ):
            slot["remaining"] = 0
        if self.on_token is not None:
            self.on_token(slot["rid"], tok, slot["remaining"] == 0)
        if slot["remaining"] == 0:
            self._finish(i)

    def _finish(self, i: int) -> None:
        slot = self.slots[i]
        self.obs.requests_finished.inc()
        self.done[slot["rid"]] = torch.cat(slot["toks"], dim=1)
        if self.radix is not None:
            # Shared blocks deref (parking at refcount 0), DEEPEST-FIRST
            # so LRU eviction reclaims a chain's deep end first; only
            # privately owned blocks free at once.
            for blk in reversed(slot.get("shared", ())):
                self.radix.release(blk)
        self.free.extend(slot["blocks"])
        self.tables[i] = 0
        self.pos[i] = 0
        self._tables_dev[i] = 0
        self._pos_dev[i] = 0
        self._active[i] = 0
        self.slots[i] = None
        self._sampler.release(i)
        self._update_pool_gauges()


def serve_paged(
    dec: Any,
    params: dict,
    requests: list[tuple[torch.Tensor, int]],
    *,
    num_blocks: int,
    block_size: int = 16,
    max_batch: int = 4,
    eos_id: int | None = None,
    adapter_ids: list | None = None,
    prefix_ids: torch.Tensor | None = None,
    prefix_cache: bool = False,
    sampling: list | None = None,
    attention: str = "gathered",
    kv_dtype: str = "fp",
    spill_bytes: int = 0,
    decode_window: int = 1,
    spec_draft: Any = None,
    spec_params: dict | None = None,
    spec_k: int = 0,
    prefill_chunk: int | None = None,
    prefill_budget: int | None = None,
    prefill_lookahead: int = 2,
    mesh: Any = None,
    model_axis: str = "model",
    constraints: dict | None = None,
    pp_stages: int = 1,
    pp_inflight: int | None = None,
    pp_cuts: Any = None,
    pp_devices: Any = None,
    pp_remote: dict | None = None,
    pp_balance: str = "equal",
) -> tuple[list[torch.Tensor], ServerStats]:
    """One-shot paged serving: returns (outputs in submission order,
    stats incl. peak pool usage, `kv_dtype`, `pool_bytes` and the spill
    tier's totals). The knobs are PagedDecodeServer's;
    `adapter_ids` and `sampling` assign an adapter (not ported: only 0)
    and a SamplingParams per request."""
    srv = PagedDecodeServer(
        dec,
        params,
        num_blocks=num_blocks,
        block_size=block_size,
        max_batch=max_batch,
        eos_id=eos_id,
        prefix_ids=prefix_ids,
        prefix_cache=prefix_cache,
        attention=attention,
        kv_dtype=kv_dtype,
        spill_bytes=spill_bytes,
        decode_window=decode_window,
        spec_draft=spec_draft,
        spec_params=spec_params,
        spec_k=spec_k,
        prefill_chunk=prefill_chunk,
        prefill_budget=prefill_budget,
        prefill_lookahead=prefill_lookahead,
        mesh=mesh,
        model_axis=model_axis,
        constraints=constraints,
        pp_stages=pp_stages,
        pp_inflight=pp_inflight,
        pp_cuts=pp_cuts,
        pp_devices=pp_devices,
        pp_remote=pp_remote,
        pp_balance=pp_balance,
    )
    aids = adapter_ids or [0] * len(requests)
    if len(aids) != len(requests):
        raise ValueError(
            f"adapter_ids has {len(aids)} entries for "
            f"{len(requests)} requests"
        )
    samps = sampling or [None] * len(requests)
    if len(samps) != len(requests):
        raise ValueError(
            f"sampling has {len(samps)} entries for "
            f"{len(requests)} requests"
        )
    rids = [
        srv.submit(p, s, adapter_id=a, sampling=sp)
        for (p, s), a, sp in zip(requests, aids, samps)
    ]
    done = srv.run()
    # Drain pending spill copies so that the stats read a settled store.
    srv.flush_spill()
    stats = ServerStats.snapshot(
        srv.obs.registry,
        ticks=srv.ticks,
        attention=attention,
        peak_blocks=srv.blocks_peak,
        pool_blocks=srv.num_blocks - 1,
        block_size=block_size,
        flat_equivalent_rows=max_batch * dec.cfg.max_len,
        shared_prefix_blocks=len(srv.shared_blocks),
        prefill_tokens_saved=srv.prefill_tokens_saved,
        cached_blocks=(
            srv.radix.cached_blocks if srv.radix is not None else 0
        ),
        prefill_chunk=srv.prefill_chunk,
        kv_dtype=srv.kv_dtype,
        pool_bytes=srv.pool_bytes,
        spilled_blocks=(
            srv._spill.stored_blocks if srv._spill is not None else 0
        ),
        spill_hits=srv.spill_hits_n,
        spill_stored_bytes=(
            srv._spill.stored_bytes if srv._spill is not None else 0
        ),
        prefill_stall_ticks=srv.prefill_stall_ticks_n,
        decode_stall_fraction=srv.decode_stall_fraction_last,
        decode_window=srv.decode_window,
        host_dispatches=srv.dispatches,
        tokens_per_dispatch=(
            srv.window_tokens / srv.dispatches if srv.dispatches else 0.0
        ),
    )
    if srv._spill is not None:
        srv._spill.close()  # one-shot: the drain thread ends with the run
    return [done[r] for r in rids], stats
