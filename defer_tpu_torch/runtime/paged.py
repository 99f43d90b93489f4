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
    a later walk miss revives them verbatim into a fresh block;
  * `decode_window=K` runs K decode sub-steps a host dispatch. Each
    sub-step zeroes frozen rows' position and table row (their writes
    land in trash block 0 row 0, where an idle slot writes), runs the T=1
    paged step, samples on the device, counts the token against the
    row's budget and freezes rows that hit eos or their budget; the host
    drains one [B, K] transfer a window, and admissions, finishes and
    block allocation happen at window boundaries only (a slot's table
    already holds every block its request can reach). On a CPU server
    the body runs eagerly; on a CUDA server it is one
    `torch.cuda.CUDAGraph` per (mode, constrained), captured once and
    kept on the server, every input a fixed device tensor written in
    place (positions, the feed, the active mask, the budgets, the block
    tables, the sampler rows). The "blockwise" fold reads the table's
    whole span MB in a window (its host bound cannot move inside a
    graph; the extra columns are fully masked and add nothing), and the
    gathered path's plan is worked out on the device;
  * `prefill_budget=N`: stall-free mixed ticks (runtime/schedule.py).
    A new request takes a SEAT and its prompt rides inside the decode
    dispatches, up to N prompt tokens a tick beside every decode row, in
    one multi-token step (`_mt`, the prefill kernel); a mixed tick runs
    eagerly, its T a pow2 bucket that changes from tick to tick;
  * `spec_k=k`: speculative decoding. `DraftLanes` proposes k greedy
    tokens a slot, the target verifies all k + 1 in one `_mt` step whose
    candidate rows land in the slot's blocks, and the accept test keeps
    the target's own chain. `decode_window > 1` fuses W whole rounds into
    one dispatch, a captured graph on the card like a decode window;
  * `constraints=` (grammar DFAs) and multi-LoRA adapter banks
    (`adapter_id=`) ride every step body, as on the flat server;
  * `submit_prefilled` / `deliver_kv` seat K/V prefilled elsewhere
    (defer_tpu_torch/disagg/).

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
  * block tables, positions, adapters and the active mask live on the
    device and change only at admission and finish; idle slots sit at
    position 0 with an all-trash table, and a tick advances the live
    positions on the device, so a steady tick makes no host sync. Host
    mirrors serve the accounting (rows read) and the blockwise fold's
    bound, a host int where the JAX package traces `jnp.max(pos)`;
  * there is no jit, so no program memo: each step runs eagerly, except
    the captured windows, which belong to their server;
  * the draft proposes eos at a dead DFA state where the JAX package's
    proposes a garbage argmax; the verify accepts neither, so the
    committed tokens are the same.

The fleet seams (defer_tpu_torch/fleet/): `device=` pins a server and
its pool to one device (params move with `.to`, so replicas on one card
share one set of weights), `resident_digests` is the routing
advertisement, and `export_prefix_blocks` / `import_prefix_blocks` move
a parked prefix chain between pools, on the serving thread only.

Tensor-parallel serving, `mesh=` / `model_axis`: the weights split
Megatron-style (the server's own `SpmdGptDecoder` view shards the whole
tree it is given) and the pool on its KV-head axis, every mesh position
one process of a `torch.distributed` group (`parallel/multihost.py`).
A mesh axis other than the model axis is replicated, as the JAX
package's shard_map replicates what its specs do not name: the ranks
along it hold the same shards and run the same programs, their psums
over their own model-axis line (no batch splits over a data axis; the
JAX package has none). The JAX package drives its mesh from one
controller, "host-side mechanics stay single-writer and unsharded";
here the rank at position 0 of every axis is that controller: it alone
holds the host state (admission, block tables, radix cache, sampling,
obs), takes `submit` / `submit_prefilled` / `deliver_kv`, and samples
from the logits every rank holds whole after the vocab all-gather.
Every device program of the server (`_program`: the tick and window
sub-step `_decode`, `_mt`, the flat prefills and their inserts, spill
down and up, import, export, the seating of delivered KV, a pipeline
chain) goes through one seam: the controller broadcasts the program's
name and its replicated host-fed operands to every rank of the mesh
(`_ModelLink`, over the mesh's own group), and every rank runs it on
its own shards, the psums inside on its model-axis line; the other
ranks run that loop in `run()` until the controller's `close()`.
Replicas of one decoder and one tree on one rank (the fleet's
`model_axis_size=` replicas over the same ranks) share one shard of the
tree, memoized on the decoder as the JAX package memoizes its sharded
view there. Full-head host K/V
crosses ranks only there: split on its head axis as it lands (ingest,
import, spill revival), gathered whole to the controller as it leaves
(export, spill snapshots, which the controller's `HostKVSpill` holds
whole). Which meshes capture their windows (`window_captures`): a
one-process mesh, which serves a model axis of size 1 (its collectives
the identity), and a mesh whose every group (each axis line and
`everyone`) is NCCL. There each rank captures its own window program on
first use, warmed up outside the capture (the warm-up runs the window's
collectives once, so NCCL's communicators exist before a capture), and
the controller sends ONE window program a window through the seam
(`_window_run`, with the window's inputs), not K sub-step programs;
every rank replays its own graph, and `graph_replays` counts on each. A
gloo collective cannot be captured in a CUDA graph, and ranks sharing
one card are gloo: on a mesh with a gloo group a window runs its K
sub-steps eagerly (the same sub-steps, the same tokens), each a program
through the seam, and `graph_replays` stays 0. A speculative window
runs the draft on the controller alone, so over a process group it
stays eager too. Counters: `tp_psums` (2L + 2 a sharded forward, a
replay's forwards included), KV rows per shard (1 / tp).

Pipeline-parallel serving, `pp_stages=S`: the layers cut into S
contiguous stages (`pp_cuts`, or balanced: equal counts, or
`pp_balance="probe"` from each layer's measured step), each stage its
params and its own slice of the pool (`_PPLocalStage` on `pp_devices`,
round-robin, a device may repeat; or `_PPTransportStage`, a
`runtime/remote_stage.py` `serve_pp_stage` worker over the framed
transport, `pp_remote`). Admission prefills through the stage chain; a
window runs `decode_window` rounds of `pp_inflight` microbatch groups
round-major (the GPipe schedule, `_tick_pp`), the bubble fraction
measured at the schedule level.

pp x tp, `mesh=` with `pp_stages=S`: a mesh with a stage axis OUTERMOST
(`make_multihost_mesh({"stage": S, "model": tp})`) splits into one
submesh a stage (`stage_submeshes`); each stage's ranks hold its layer
slice sharded over their model-axis line (the port of
`_pp_stage_specs`) and its slice of the pool on the KV-head axis. A
chain is one program: every rank receives the operands, the ranks of a
stage run it when the activation reaches them, and the [B, T, D]
boundary activation (the [B, T, V] logits after the last stage) hops
along each rank's stage-axis line to the next stage (to stage 0 from
the last) in one `all_to_all_single` with empty splits toward every
other rank, as `collectives.ppermute` does, so gloo on CUDA tensors
carries it. The controller at (0, 0) reads the logits there; the GPipe
schedule and its bubble accounting are the one-process server's.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import math
import pickle
import queue
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from defer_tpu_torch.constrain import runtime as crt
from defer_tpu_torch.models.gpt import (
    SpmdGptDecoder,
    _layer_view,
    sample_token_batched_nosort_u,
    sample_token_batched_u,
)
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
from defer_tpu_torch.parallel import collectives
from defer_tpu_torch.parallel.lora import adapter_bank_info
from defer_tpu_torch.parallel.mesh import cuda_devices
from defer_tpu_torch.parallel.multihost import stage_submeshes
from defer_tpu_torch.parallel.pipeline import balance_stage_cuts, probe_latency
from defer_tpu_torch.parallel.spmd_pipeline import check_process_group
from defer_tpu_torch.parallel.transformer_stack import shard_tree
from defer_tpu_torch.runtime.batching import (
    accept_lengths,
    host_lists,
    microbatch_groups,
    pp_schedule_occupancy,
    window_drain_order,
)
from defer_tpu_torch.runtime.decode_server import (
    _DEAD_END,
    DraftLanes,
    SlotSampler,
    capture_graph,
)
from defer_tpu_torch.runtime.schedule import PrefillSeat, plan_mixed_tick
from defer_tpu_torch.runtime.stopping import matcher_or_none, normalize_stops
from defer_tpu_torch.runtime.transport import ArraySender
from defer_tpu_torch.weights import tree_to


class _Wire:
    """A tensor operand crossing to the model group's other ranks: a host
    copy, placed on the receiving rank's device on arrival."""

    __slots__ = ("t",)

    def __init__(self, t: torch.Tensor):
        t = t.detach().cpu()
        # A view would pickle its whole storage.
        self.t = t.clone() if t._base is not None or not t.is_contiguous() \
            else t


def _to_wire(x):
    if isinstance(x, torch.Tensor):
        return _Wire(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_to_wire(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_wire(v) for k, v in x.items()}
    return x


def window_captures(device: torch.device, mesh) -> bool:
    """Whether a server on `device` under `mesh` runs its windows as
    captured CUDA graphs: on a card, without a mesh, on a one-process
    mesh, or on a mesh over a process group whose every group is NCCL (a
    gloo collective cannot be captured)."""
    if device.type != "cuda":
        return False
    if mesh is None or not mesh.distributed:
        return True
    groups = [*mesh.groups.values(), mesh.everyone]
    return all(dist.get_backend(g) == "nccl" for g in groups)


def _from_wire(x, device: torch.device):
    if isinstance(x, _Wire):
        return x.t.to(device)
    if isinstance(x, (list, tuple)):
        return type(x)(_from_wire(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _from_wire(v, device) for k, v in x.items()}
    return x


class _ModelLink:
    """The seam between a sharded server's controller (the rank at
    position 0 of every mesh axis) and the mesh's other ranks: the
    controller broadcasts each device program's name and operands
    (`send`, one `broadcast_object_list` on the mesh's own group of all
    its ranks), the other ranks receive them in
    `PagedDecodeServer._follow` and run the same program on their
    shards; `stop` ends their loop. `bytes_sent` adds up the pickled
    messages the controller sent."""

    def __init__(self, mesh):
        self.group = mesh.everyone
        self.src = mesh.origin
        self.controller = mesh.rank == self.src
        self.depth = 0
        self.stopped = False
        self.bytes_sent = 0

    def send(self, name: str, args: tuple, kw: dict) -> None:
        msg = pickle.dumps((name, _to_wire(args), _to_wire(kw)))
        self.bytes_sent += len(msg)
        dist.broadcast_object_list([msg], src=self.src, group=self.group)

    def recv(self):
        msg = [None]
        dist.broadcast_object_list(msg, src=self.src, group=self.group)
        return None if msg[0] is None else pickle.loads(msg[0])

    def stop(self) -> None:
        if not self.stopped:
            self.stopped = True
            dist.broadcast_object_list([None], src=self.src,
                                       group=self.group)


def _program(fn):
    """Mark a device program of the server: everything that touches the
    sharded params or pool goes through here. Under `mesh=` it runs with
    the mesh active (the tp collectives of its forward find their
    group), and over a process group the controller first broadcasts the
    program's name and its replicated host-fed operands to the mesh's
    ranks, which run the same program on their own shards. A program
    called from inside another runs as part of it, unsent."""

    @functools.wraps(fn)
    def run(self, *args, **kw):
        link = self._link
        if self.mesh is None:
            return fn(self, *args, **kw)
        if link is not None and link.controller and link.depth == 0:
            link.send(fn.__name__, args, kw)
        if link is not None:
            link.depth += 1
        try:
            with collectives.active(self.mesh), torch.no_grad():
                return fn(self, *args, **kw)
        finally:
            if link is not None:
                link.depth -= 1

    return run


def _shared_shard(dec, sdec, params: dict) -> dict:
    """This rank's shard of `params` under `sdec`'s mesh, made once a
    (decoder, tree, model-axis position, device): servers of one decoder
    and one tree at the same place (the fleet's replicas on a rank)
    share it. Memoized on the decoder, which keeps the tree alive beside
    its shard, so the tree's id is never reused while it is cached."""
    mesh = sdec.mesh
    if not mesh.distributed:
        return sdec.shard_params(params)
    key = ("paged_shard", id(params), sdec.tp_axis,
           mesh.shape[sdec.tp_axis], mesh.coords[sdec.tp_axis], sdec.device)
    hit = dec._steps.get(key)
    if hit is None:
        hit = dec._steps[key] = (params, sdec.shard_params(params))
    else:
        # The view's bookkeeping (int8 leaves) as shard_params sets it.
        sdec.prepare_params(params)
    return hit[1]


def pinned_device(device) -> torch.device:
    """`device=` as a torch.device that exists in this process, with a
    CUDA index made explicit; raises for a card that is not there (a
    server never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device={dev}: the port serves on cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={dev}: this process sees no CUDA device")
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx >= torch.cuda.device_count():
        raise ValueError(
            f"device={dev}: only {torch.cuda.device_count()} CUDA "
            "device(s) here"
        )
    return torch.device("cuda", idx)


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


def _gathered_view(pool_l, idx, dtype):
    """A layer's contiguous [B, Hkv, MB * bs, Dh] view of the slots'
    tables `idx` (a copy) in the compute dtype `dtype`: an int8 pool
    dequantizes at the gather, the multiply in that dtype."""
    if isinstance(pool_l, dict):
        kc = dequantize_symmetric(pool_l["q"][idx],
                                  pool_l["s"][idx][..., None, None], dtype)
    else:
        kc = pool_l[idx]  # [B, MB, Hkv, bs, Dh]
    b, mb, hkv, bs, dh = kc.shape
    return kc.transpose(1, 2).reshape(b, hkv, mb * bs, dh)


def _mt_forward(dec, params, pool_k, pool_v, tables, pos, xin, n_keep,
                keep_from, nb_live, attention, bs, *, first=0, last=None,
                adapter=None, tp=None):
    """The multi-token paged forward over layers [first, last) (all of
    them by default) of `params` and of the pools, whose layer axes hold
    exactly those layers: xin [B, T] ids when first == 0, else the
    previous stage's [B, T, D] activations; row t of slot b at position
    pos[b] + t, K/V read through the tables and the T new rows of every
    layer scattered into its pool slice (a row the slot does not keep,
    n_keep / keep_from, redirects to trash block 0). Returns the logits
    [B, T, V] when last is the model's last layer, else the activations.
    `attention`: "gathered", "blockwise" (the plain fold over nb_live
    table columns) or "pallas" (the prefill kernel, T = 1 included).
    The server's `_mt` is the whole stack; a pipeline stage
    (`_PPLocalStage`) is its slice."""
    L = dec.cfg.num_layers
    last = L if last is None else last
    window = dec.cfg.window
    aid = adapter.long() if adapter is not None else None
    b, t = xin.shape[:2]
    mb = tables.shape[1]
    dev = tables.device
    steps = torch.arange(t, device=dev)
    pvec = pos[:, None] + steps  # [B, T]
    # The column clamp keeps headroom rows past the table (dead writes
    # only) in range.
    blk = tables.long().gather(1, (pvec // bs).clamp(max=mb - 1))
    keep = (steps[None, :] < n_keep[:, None]) & (pvec >= keep_from[:, None])
    dest = torch.where(keep, blk, 0)
    rowi = pvec % bs
    x = dec._embed_tokens(params, xin, pos, tp) if first == 0 else xin
    stack = params["stack"]
    if attention == "gathered":
        plan = dec._plan(pos, t, mb * bs)
        plan["adapter"] = aid
        plan["tp"] = tp
        idx = tables.long()
        rows = torch.arange(b, device=dev)[:, None]
        for layer in range(last - first):
            pk_l = _pool_layer(pool_k, layer)
            pv_l = _pool_layer(pool_v, layer)
            kc = _gathered_view(pk_l, idx, dec.compute_dtype)
            vc = _gathered_view(pv_l, idx, dec.compute_dtype)
            x = dec._block(_layer_view(stack, layer), x, kc, vc, pos, plan)
            # Multi-row scatter-back: T fresh rows per slot.
            _pool_write_rows_mt(pk_l, dest, rowi, kc[rows, :, pvec])
            _pool_write_rows_mt(pv_l, dest, rowi, vc[rows, :, pvec])
    else:
        # The multi-token sibling of `_decode`'s choice (the JAX package's
        # `_blockwise_attend_mt` fold, or the prefill kernel).
        attend = (
            functools.partial(paged_flash_prefill_plain, num_blocks=nb_live)
            if attention == "blockwise" else paged_flash_prefill
        )
        rope = dec._rope(pos, t)
        for layer in range(last - first):
            p = _layer_view(stack, layer)
            pk_l = _pool_layer(pool_k, layer)
            pv_l = _pool_layer(pool_v, layer)
            q, k_new, v_new = dec._attn_qkv(p, x, rope, aid)
            # Write-then-attend, on one stream.
            _pool_write_rows_mt(pk_l, dest, rowi, k_new.transpose(1, 2))
            _pool_write_rows_mt(pv_l, dest, rowi, v_new.transpose(1, 2))
            _, hq, _, dh = q.shape
            attn = attend(
                q, _pool_arr(pk_l), _pool_arr(pv_l), tables, pos,
                window=window, scale_k=_pool_scale(pk_l),
                scale_v=_pool_scale(pv_l),
            ).transpose(1, 2).reshape(b, t, hq * dh).to(x.dtype)
            x = dec._attn_out(p, x, attn, aid, tp)
    if last == L:
        return dec._final_logits(params, x, tp)
    return x


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

    # analysis: domain(drain) owns every device->host copy of an evicted block
    # and all store mutation (under _lock); the serving thread only offers and
    # gets
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


# -- pipeline-parallel stages (PagedDecodeServer pp_stages=) ---------------


def _pp_stage_specs(full_specs: dict, first: int, last: int, cfg) -> dict:
    """The placement subtree matching GptDecoder.stage_params(params,
    first, last) (the JAX package's shard_map in_specs for a stage):
    stack leaf specs are layer-leading (slicing the layer axis never
    changes them), the boundary stages add the embedding / final-norm /
    tied-head specs their extra params carry."""
    out = {"stack": full_specs["stack"]}
    if first == 0:
        out["token_embedding"] = full_specs["token_embedding"]
        if "pos_embedding" in full_specs:
            out["pos_embedding"] = full_specs["pos_embedding"]
    if last == cfg.num_layers:
        out["final_ln_scale"] = full_specs["final_ln_scale"]
        if "final_ln_bias" in full_specs:
            out["final_ln_bias"] = full_specs["final_ln_bias"]
        if "token_embedding" not in out:
            out["token_embedding"] = full_specs["token_embedding"]
    return out


class _PPLocalStage:
    """One pipeline stage in this process: the stage's params
    (GptDecoder.stage_params, views of the server's tree when the stage
    sits on their device) and its [last - first, num_blocks, kv_heads,
    block_size, Dh] slice of the paged pool, on one device; a device may
    carry several stages (`[cuda:0] * 2` is two stages on one card). On
    a tensor-parallel `submesh` (pp x tp: this rank's stage of a joint
    {stage, model} mesh) the stage holds this rank's shard of its slice,
    placed by `_pp_stage_specs`, and its kv_heads / tp heads of the
    pool, and runs with the submesh active, so its psums stay on the
    stage's own model-axis line. `pp_dispatch` is the stage-boundary
    interface it shares with `_PPTransportStage`: the six replicated
    operands in, the boundary activation (or, on the last stage, the
    logits) out. Every stage recomputes the write destinations from the
    tables and positions, so each scatters its layers' K/V rows into its
    own pool slice; only the [B, T, D] activation crosses a stage
    boundary. A decode round rides it at T = 1 (n_keep 1, keep_from 0),
    a prefill chunk at T = chunk; "pallas" takes the prefill kernel at
    T = 1 too, as the JAX package's stage step does."""

    def __init__(self, dec, params, first, last, *, num_blocks, block_size,
                 attention, device=None, submesh=None, model_axis="model"):
        tp = 1
        if submesh is not None:
            device = submesh.local_device
            tp = submesh.shape[model_axis]
        device = torch.device(device)
        if device != dec.device:
            dec = dataclasses.replace(dec, device=device)
        self.dec = dec
        self.first = first
        self.last = last
        self.device = device
        self.bs = block_size
        self.attention = attention
        self.submesh = submesh
        self.tp_axis = model_axis if submesh is not None else None
        cfg = dec.cfg
        if submesh is None:
            sp = dec.stage_params(params, first, last)
        else:
            sdec = SpmdGptDecoder(cfg, compute_dtype=dec.compute_dtype,
                                  mesh=submesh, tp_axis=model_axis,
                                  device=device)
            # Slice the whole tree first (views), then keep this rank's
            # shard of the slice: no shard of another stage's layers is
            # ever made.
            whole = sdec.prepare_params(params)
            sp = shard_tree(dec.stage_params(whole, first, last),
                            _pp_stage_specs(sdec._specs(), first, last, cfg),
                            submesh)
        self.params = tree_to(sp, device)
        shape = (last - first, num_blocks, cfg.kv_heads // tp, block_size,
                 cfg.dim // cfg.num_heads)
        self.pk = torch.zeros(shape, dtype=dec.compute_dtype, device=device)
        self.pv = torch.zeros(shape, dtype=dec.compute_dtype, device=device)
        # The stage's whole pool slice (every shard's under a submesh).
        self.pool_bytes = 2 * tp * self.pk.numel() * self.pk.element_size()

    def _put(self, a: torch.Tensor) -> torch.Tensor:
        """An operand on this stage's device (the in-process activation
        handoff; a no-op for a tensor already there)."""
        return a.to(self.device, non_blocking=True)

    @torch.no_grad()
    def pp_dispatch(self, tables, pos, xin, n_keep, keep_from, adapter_ids):
        tables = self._put(tables)
        with collectives.active(self.submesh):
            # The blockwise fold reads the table's whole span, as in a
            # window: the positions stay on the device (the extra
            # columns are fully masked and add nothing).
            return _mt_forward(
                self.dec, self.params, self.pk, self.pv, tables,
                self._put(pos), self._put(xin), self._put(n_keep),
                self._put(keep_from), tables.shape[1], self.attention,
                self.bs, first=self.first, last=self.last, tp=self.tp_axis,
            )

    def close(self) -> None:  # the interface _PPTransportStage shares
        pass


class _PPRankStage:
    """A stage of a pp x tp mesh held by OTHER ranks (the stages of this
    rank's chain it does not run): its layer range and the bytes of its
    pool slice, for the accounting; the chain hands it the activation
    over the stage axis instead of dispatching."""

    def __init__(self, *, first, last, pool_bytes):
        self.first = first
        self.last = last
        self.pool_bytes = pool_bytes

    def close(self) -> None:
        pass


def _stage_hop(x, shape, dtype, group, n: int, index: int, src: int,
               dst: int, device) -> torch.Tensor:
    """The pp x tp boundary: the activation `x` of the ranks at stage
    `src` (this rank's stage-axis line, `index` its position on it) to
    the rank at stage `dst`, as raw bytes in one all_to_all_single whose
    splits are empty toward every other rank (`collectives.ppermute`'s
    call, which gloo carries on CUDA tensors too). Returns the [shape]
    `dtype` tensor on the receiving rank, `x` on every other."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    sends, recvs = [0] * n, [0] * n
    if index == src:
        send = x.contiguous().view(-1).view(torch.uint8)
        sends[dst] = nbytes
    else:
        send = torch.empty((0,), dtype=torch.uint8, device=device)
    if index == dst:
        recvs[src] = nbytes
    out = torch.empty((recvs[src],), dtype=torch.uint8, device=device)
    dist.all_to_all_single(out, send, recvs, sends, group=group)
    return out.view(dtype).reshape(shape) if index == dst else x


class _PPTransportStage:
    """A pipeline stage served by ANOTHER process over the framed
    transport (runtime/transport.py): `pp_dispatch` ships the six
    operands through an ArraySender to the stage worker
    (runtime/remote_stage.py serve_pp_stage, which wraps a
    _PPLocalStage) and blocks on its one result array from the paired
    ArrayReceiver. The round trip is synchronous a dispatch: this
    placement is the cross-host tier, not an overlap win. `spec` is
    (host, port, result_receiver): the worker's listen address and the
    caller's ArrayReceiver its results arrive on. `host_s` adds up the
    host seconds of the round trips."""

    def __init__(self, spec, *, first, last, pool_bytes=0):
        host, port, receiver = spec
        self.first = first
        self.last = last
        self.pool_bytes = pool_bytes
        self._send = ArraySender(host, port)
        self._it = iter(receiver)
        self.host_s = 0.0
        self.round_trips = 0

    def pp_dispatch(self, tables, pos, xin, n_keep, keep_from, adapter_ids):
        t0 = time.perf_counter()
        for a in (tables, pos, xin, n_keep, keep_from, adapter_ids):
            # The stage boundary is a host transport here: framing an
            # operand copies it to the host.
            self._send.send(a)
        out = next(self._it)
        self.host_s += time.perf_counter() - t0
        self.round_trips += 1
        return out

    def close(self) -> None:
        """Send the STOP frame, so the worker's serve loop exits."""
        self._send.close()


class PagedDecodeServer:
    """Continuous batching over a paged KV pool; greedy by default,
    per-request sampling via `submit(..., sampling=)`.

    Protocol-compatible with runtime/decode_server.DecodeServer (submit
    -> run -> {rid: ids}), with the pool replacing per-slot max_len
    lanes. `num_blocks` INCLUDES the reserved trash block 0. The server
    runs on `device=` when given (params are moved there), else on
    `dec.device` (CUDA unless the decoder was built on the CPU), where
    `params` must live."""

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
        callback; `eos_id`: stop token.

        `decode_window=K`: K decode sub-steps a host dispatch (the module
        docstring). `spec_k=k` with `spec_draft`/`spec_params`: a draft
        proposes k greedy tokens a round for every greedy slot and the
        target verifies all k + 1 in one multi-token step; greedy output
        is token-identical to spec_k=0. `prefill_budget=N`: stall-free
        mixed ticks, each carrying the decode rows plus up to N prompt
        tokens of at most `prefill_lookahead` seated prefills
        (runtime/schedule.py). `constraints={name: TokenDFA}`: grammars a
        request selects with SamplingParams(constraint=name); needs
        `eos_id`. Params with adapter banks (parallel/lora.py
        `stack_adapters`) serve a LoRA adapter per request
        (`submit(adapter_id=)`, 0 = the base model).

        `device=`: the one device the server, its pool and its params
        live on (default: `dec.device`); a device this process does not
        have raises. `mesh=` / `model_axis`: tensor-parallel serving
        over the mesh's model axis, every rank of it constructing the
        server with the same arguments and the WHOLE params (the module
        docstring); `run()` on any rank but the controller follows the
        controller's dispatches. `pp_stages` / `pp_inflight` /
        `pp_cuts` / `pp_devices` / `pp_remote` / `pp_balance`: pipeline-
        parallel serving (the module docstring); with `mesh=`, pp x tp
        over the mesh's `pp_stage_axis`. The JAX package's refusals,
        word for word and in its order."""
        if getattr(dec, "rolling_cache", False):
            raise ValueError("paged serving does not support rolling caches")
        # Multi-LoRA: adapter banks make the slot -> adapter assignment
        # per-slot state, as on the flat server; id 0 = base model.
        n_adapters = adapter_bank_info(params)
        self.multi_lora = n_adapters is not None
        if self.multi_lora:
            self.num_adapters = n_adapters
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
            if prefix_ids is not None:
                raise ValueError(
                    "spec_k > 0 does not compose with constructor "
                    "prefix_ids (the draft lane has no shared-prefix "
                    "plumbing); use prefix_cache=True"
                )
            if self.multi_lora:
                raise ValueError(
                    "spec_k > 0 with multi-LoRA is unsupported: one "
                    "draft model cannot propose for per-slot adapters"
                )
            if spec_draft.cfg.max_len < dec.cfg.max_len:
                raise ValueError(
                    f"draft max_len {spec_draft.cfg.max_len} < target "
                    f"max_len {dec.cfg.max_len}: the draft lane must "
                    "cover every position the target can reach"
                )
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
            if spec_k:
                raise ValueError(
                    "prefill_budget does not compose with spec_k > 0 "
                    "yet: the verify forward already owns the "
                    "multi-token rows a mixed tick would budget, and "
                    "fusing draft catch-up with mid-prefill seats "
                    "needs a draft-side seat lifecycle. Fix: serve "
                    "speculation on a prefill_budget=None server, or "
                    "set spec_k=0 here."
                )
            if pp_stages > 1:
                raise ValueError(
                    "prefill_budget does not compose with pp_stages "
                    "> 1 yet: the pipelined window schedules whole "
                    "microbatch groups and a mixed tick would need "
                    "per-stage budget accounting across the in-flight "
                    "groups. Fix: run mixed-mode admission on a "
                    "pp_stages=1 server (tensor-parallel via mesh= "
                    "composes), or set prefill_budget=None here."
                )
        if mesh is not None and device is not None:
            raise ValueError(
                "mesh= and device= are mutually exclusive: a mesh "
                "already pins the server to its devices"
            )
        if pp_stages < 1:
            raise ValueError(f"pp_stages must be >= 1, got {pp_stages}")
        self.pp = pp_stages
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
        pp_m = 1
        if pp_stages > 1:
            pp_m = self._check_pp(
                dec, pp_stages, pp_inflight, max_batch, spec_k=spec_k,
                constraints=constraints, prefix_ids=prefix_ids,
                spill_bytes=spill_bytes, kv_dtype=kv_dtype, device=device,
                pp_balance=pp_balance,
            )
        self.mesh = mesh
        self.model_axis = model_axis
        self.pp_stage_axis = pp_stage_axis
        self.tp = 1
        self._sdec = None
        self._pp_submeshes: list = []
        # The seam exists once construction is done: construction runs
        # the same programs on every rank by itself.
        self._link = None
        link = None
        if mesh is not None:
            self.tp = self._check_mesh(dec, mesh, model_axis, pp_stages,
                                       pp_stage_axis)
            device = mesh.local_device
            if pp_stages > 1:
                # pp x tp: each stage shards its own slice (_build_pp).
                self._pp_submeshes = stage_submeshes(mesh, pp_stage_axis)
            else:
                # The server's own sharded view of the decoder: the param
                # placement, the vocab padding and the sharded flat
                # prefill.
                self._sdec = SpmdGptDecoder(
                    dec.cfg, compute_dtype=dec.compute_dtype, mesh=mesh,
                    tp_axis=model_axis, device=device,
                )
                params = _shared_shard(dec, self._sdec, params)
            if mesh.distributed and mesh.devices.size > 1:
                link = _ModelLink(mesh)
        # The rank that holds the host state: every rank but the model
        # group's followers.
        self.controller = link is None or link.controller
        if device is not None:
            # Pin the server, its pool and its params to `device`: the
            # decoder (and a draft) is replaced by one placed there, so
            # every step of this server reads this device, and params
            # move with .to(), a no-op for a tensor already there (two
            # replicas on one card share one set of weights).
            device = pinned_device(device)
            if device != dec.device:
                dec = dataclasses.replace(dec, device=device)
            if pp_stages == 1:  # pp x tp stages place their own slices
                params = tree_to(params, device)
            if spec_k and device != spec_draft.device:
                spec_draft = dataclasses.replace(spec_draft, device=device)
            if spec_k:
                spec_params = tree_to(spec_params, device)
        cfg = dec.cfg
        self.decode_window = decode_window
        self.attention = attention
        self.kv_dtype = kv_dtype
        self.dec = dec
        self.params = params
        self.device = dec.device
        # The fleet's per-replica stats read it.
        self.mesh_label = f"{model_axis}={self.tp}" if mesh is not None \
            else None
        # Collectives one sharded forward issues: an attention and an FFN
        # psum a layer, the embedding psum and the logits all_gather
        # (the defer_tp_psum_total mirror; 0 without a mesh).
        self._psums_per_fwd = (2 * dec.cfg.num_layers + 2
                               if mesh is not None else 0)
        self.tp_psums = 0
        self.B = max_batch
        self.bs = block_size
        self.eos_id = eos_id
        self.on_token = on_token
        # Max logical blocks any sequence can span.
        self.MB = -(-cfg.max_len // block_size)
        self.num_blocks = num_blocks
        dh = cfg.dim // cfg.num_heads
        # Under a mesh this rank's shard: its kv_heads / tp heads of every
        # block, allocated as the shard.
        pool_shape = (cfg.num_layers, num_blocks, cfg.kv_heads // self.tp,
                      block_size, dh)
        # An int8 pool is a {"q", "s"} pair per K and V: int8 rows and one
        # f32 scale per (layer, block, KV head), at 1.0 so a never-written
        # block dequantizes to the zeros an fp pool holds.
        scale_shape = pool_shape[:3]
        pools = []
        # Pipeline-parallel: the pool never exists whole; each stage
        # allocates its own layer slice (built below), and a path that
        # would touch a whole pool fails on the None.
        for _ in range(2 if self.pp == 1 else 0):
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
        self.pool_k, self.pool_v = pools or (None, None)
        # The whole pool's bytes (every shard's under a mesh).
        self.pool_bytes = self.tp * sum(
            t.numel() * t.element_size()
            for pool in pools
            for t in (pool.values() if isinstance(pool, dict) else [pool])
        )
        # Block 0 is trash: unallocated table entries point at it.
        self.free = list(range(1, num_blocks))
        # Host mirrors (accounting, the blockwise fold's bound) and their
        # device copies (what the steps read); both change only at
        # admission and finish, except the positions a tick advances.
        # Every device tensor here keeps its address for the server's
        # life (written in place), so a captured window reads the
        # current values at each replay.
        self.tables = np.zeros((max_batch, self.MB), np.int32)
        self.pos = np.zeros((max_batch,), np.int32)
        self.adapter = np.zeros((max_batch,), np.int32)
        self._tables_dev = torch.zeros((max_batch, self.MB),
                                       dtype=torch.int32, device=self.device)
        self._pos_dev = torch.zeros((max_batch,), dtype=torch.int32,
                                    device=self.device)
        self._active = torch.zeros((max_batch,), dtype=torch.int32,
                                   device=self.device)
        self._adapter_dev = torch.zeros((max_batch,), dtype=torch.int32,
                                        device=self.device)
        self._rows = torch.arange(max_batch, device=self.device)
        self.slots: list[dict | None] = [None] * max_batch
        # Persistent tick feed: each slot's next input token in row i.
        self._feed = torch.zeros((max_batch, 1), dtype=torch.int32,
                                 device=self.device)
        self._sampler = SlotSampler(max_batch, self.device)
        self.pending: collections.deque[tuple] = collections.deque()
        # Externally prefilled admissions (disagg/): rid -> entry whose
        # "kv" field `deliver_kv` fills in from another thread; the pool
        # itself is touched by `_admit` on the serving thread only.
        self.pending_prefilled: dict[int, dict] = {}
        self._prefilled_order: list[int] = []
        # Host seconds spent seating delivered KV (`_admit_prefilled`).
        self.prefilled_admit_s = 0.0
        self.done: dict[int, torch.Tensor] = {}
        self._next_id = 0
        self.ticks = 0
        self.blocks_peak = 0
        self.dispatches = 0
        self.window_tokens = 0
        # Captured windows replayed, and how many were captured; each
        # graph (with its body) is bound to this server's buffers, so it
        # lives and dies with the server, keyed by (kind, mode,
        # constrained).
        self.graph_replays = 0
        self.graph_captures = 0
        # Windows are captured CUDA graphs on a card, under a mesh too
        # unless a group of it is gloo, which cannot be captured: such a
        # window runs its K sub-steps eagerly (the same sub-steps, the
        # same tokens), one dispatch of each program to the model group.
        self._captures = window_captures(self.device, mesh)
        self._graphs: dict[tuple, Any] = {}
        self._wbuf: dict | None = None
        # Prefill chunks run through the multi-token step (host count).
        self.prefill_chunks = 0
        self.obs = ServingMetrics("paged", mesh_shape=self.mesh_label)
        # The stage chain (pp_stages > 1): resolve the cuts, build one
        # stage per contiguous layer range, and account the pool as the
        # sum of the stages' slices.
        self._pp_stage_objs: list = []
        self._pp_cut_starts: list[int] = [0]
        self._pp_inflight = pp_m
        self._pp_groups: list[list[int]] = []
        self.pp_stage_pool_bytes: list[int] = []
        self.pp_stage_dispatch_n: list[int] = []
        self.pp_bubble_last = 0.0
        self.pp_occupancy_last: list[float] = []
        if self.pp > 1:
            self._build_pp(pp_cuts, pp_balance, pp_remote, pp_devices)
            self.obs.bind_pp(self.pp)
            self.obs.pp_inflight.set(float(pp_m))
        self.obs.kv_pool_bytes.set(self.pool_bytes)
        self._submit_t: dict[int, float] = {}
        self._last_tick_t: float | None = None
        # Constrained decoding tables: stacked [C, S_max, V] transitions
        # and [C, S_max] accepting bits, cid 0 the free row; None when
        # the feature is off, and every tick then runs the ops it runs
        # without constraints.
        self._ctrans = None
        self._cacc = None
        self._cnames: dict[str, int] = {}
        self._cdfas: list = [None]
        if constraints is not None:
            if eos_id is None:
                raise ValueError(
                    "constraints= requires eos_id: a satisfied "
                    "constraint stops by emitting eos"
                )
            self._cnames, self._ctrans, self._cacc = crt.stack_token_dfas(
                constraints, cfg.vocab_size, self.device
            )
            self._cdfas += [
                constraints[n]
                for n in sorted(self._cnames, key=self._cnames.get)
            ]
        # Per-request constraint failures (hand-built DFA dead ends).
        self.errors: dict[int, str] = {}
        self.constrained_tokens_n = 0
        self.constraint_dead_ends_n = 0
        self.spec_k = spec_k
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = prefill_budget
        self.prefill_lookahead = prefill_lookahead
        # Stall accounting: admission-prefill dispatches issued while a
        # decode slot sat waiting (0 in mixed mode); mixed tokens are the
        # prompt tokens fused mixed ticks carried.
        self.prefill_stall_ticks_n = 0
        self.mixed_prefill_tokens_n = 0
        self.mixed_ticks_n = 0
        self.decode_stall_fraction_last = 0.0
        # The draft's flat lanes (runtime/decode_server.py DraftLanes), a
        # whole replicated model the controller alone runs under a mesh.
        self._draft = (
            DraftLanes(spec_draft, spec_params, max_batch, target=dec)
            if spec_k and self.controller
            else None
        )
        self.spec_rounds_n = 0
        self.spec_proposed_n = 0
        self.spec_accepted_n = 0
        self.spec_draft_tokens_n = 0
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
            if self.multi_lora:
                raise ValueError(
                    "prefix_cache + multi-LoRA is unsupported: cached "
                    "prefix K/V would be adapter-dependent"
                )
            if spill_bytes and self.controller:
                # The controller holds the store whole under a mesh.
                self._spill = HostKVSpill(spill_bytes, obs=self.obs)
            self.radix = PrefixBlockCache(
                obs=self.obs,
                on_evict=(
                    self._spill_block if self._spill is not None else None
                ),
            )
        if prefix_ids is not None:
            if self.multi_lora:
                raise ValueError(
                    "prefix caching + multi-LoRA is unsupported: the "
                    "shared prefix K/V would be adapter-dependent"
                )
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
            self.shared_blocks = [self.free.pop() for _ in range(n_shared)]
            shared_row = np.zeros((self.MB,), np.int32)
            shared_row[:n_shared] = self.shared_blocks
            self._prefill_prefix(prefix_ids.to(self.device), shared_row,
                                 n_shared)
            self.prefix_len = P
        self._link = link

    def _build_pp(self, pp_cuts, pp_balance, pp_remote, pp_devices) -> None:
        """The stage chain: cuts (explicit, probed or equal), then one
        stage a range, local (`pp_devices`, round-robin; every CUDA
        device by default) or behind the transport (`pp_remote`)."""
        cfg = self.dec.cfg
        L = cfg.num_layers
        if self.mesh is not None:
            devs = [self.device]
        else:
            devs = (list(pp_devices) if pp_devices is not None
                    else cuda_devices())
        if pp_cuts is not None:
            starts = [int(c) for c in pp_cuts]
            if (
                len(starts) != self.pp
                or starts[0] != 0
                or any(b <= a for a, b in zip(starts, starts[1:]))
                or starts[-1] >= L
            ):
                raise ValueError(
                    f"pp_cuts={starts} must be {self.pp} strictly "
                    f"increasing stage START layers beginning at 0 "
                    f"and below num_layers={L} (e.g. [0, "
                    f"{L // 2}] for 2 stages). Fix: pass valid "
                    "cut starts, or drop pp_cuts for balanced "
                    "ones."
                )
        elif pp_balance == "probe":
            starts = balance_stage_cuts(
                self._probe_pp_layer_costs(devs[0]), self.pp)
        else:
            # Equal layer counts: the min-max split of unit costs.
            starts = balance_stage_cuts([1.0] * L, self.pp)
        if self._pp_submeshes and self.mesh.distributed:
            # One set of cuts for every rank: the controller's (a probe
            # times each rank's layers apart).
            box = [starts]
            dist.broadcast_object_list(box, src=self.mesh.origin,
                                       group=self.mesh.everyone)
            starts = box[0]
        bounds = starts + [L]
        remote = pp_remote or {}
        if any(s not in range(self.pp) for s in remote):
            raise ValueError(
                f"pp_remote stage indices {sorted(remote)} must "
                f"lie in [0, {self.pp})"
            )
        itemsize = torch.tensor([], dtype=self.dec.compute_dtype
                                ).element_size()
        for s in range(self.pp):
            first, last = bounds[s], bounds[s + 1]
            # The bytes of a slice another process holds, accounted here
            # so that the per-stage pool stays inspectable.
            pool_bytes = (2 * (last - first) * self.num_blocks * cfg.kv_heads
                          * self.bs * (cfg.dim // cfg.num_heads) * itemsize)
            sub = self._pp_submeshes[s] if self._pp_submeshes else None
            if s in remote:
                stage = _PPTransportStage(
                    remote[s], first=first, last=last, pool_bytes=pool_bytes,
                )
            elif sub is not None and sub.distributed and sub.rank is None:
                stage = _PPRankStage(first=first, last=last,
                                     pool_bytes=pool_bytes)
            elif sub is not None:
                stage = _PPLocalStage(
                    self.dec, self.params, first, last,
                    num_blocks=self.num_blocks, block_size=self.bs,
                    attention=self.attention, submesh=sub,
                    model_axis=self.model_axis,
                )
            else:
                stage = _PPLocalStage(
                    self.dec, self.params, first, last,
                    num_blocks=self.num_blocks, block_size=self.bs,
                    attention=self.attention, device=devs[s % len(devs)],
                )
            self._pp_stage_objs.append(stage)
        self._pp_cut_starts = starts
        self._pp_groups = microbatch_groups(self.B, self._pp_inflight)
        self.pp_stage_pool_bytes = [st.pool_bytes
                                    for st in self._pp_stage_objs]
        self.pool_bytes = sum(self.pp_stage_pool_bytes)
        self.pp_stage_dispatch_n = [0] * self.pp

    def _probe_pp_layer_costs(self, device) -> list[float]:
        """Per-layer step cost for pp_balance="probe"
        (parallel/pipeline.py probe_latency): each layer in a throwaway
        one-layer stage with a 2-block pool, timed on a [1, 1] decode
        round; layer 0 carries the embedding and the last layer the
        final norm and head, the work a stage holding them runs."""
        cfg = self.dec.cfg
        dev = torch.device(device)
        i32 = dict(dtype=torch.int32, device=dev)
        tab = torch.zeros((1, self.MB), **i32)
        pos = torch.zeros((1,), **i32)
        nk = torch.ones((1,), **i32)
        kf = torch.zeros((1,), **i32)
        ids = torch.zeros((1, 1), **i32)
        act = torch.zeros((1, 1, cfg.dim), dtype=self.dec.compute_dtype,
                          device=dev)
        costs = []
        for layer in range(cfg.num_layers):
            stage = _PPLocalStage(
                self.dec, self.params, layer, layer + 1, num_blocks=2,
                block_size=self.bs, attention=self.attention, device=dev,
            )
            xin = ids if layer == 0 else act
            sample = probe_latency(stage.pp_dispatch, tab, pos, xin, nk, kf,
                                   kf, iters=3)
            costs.append(sample["amortized_s"])
        return costs

    def _check_pp(self, dec, pp_stages, pp_inflight, max_batch, *, spec_k,
                  constraints, prefix_ids, spill_bytes, kv_dtype, device,
                  pp_balance) -> int:
        """The JAX package's pp_stages > 1 refusals, in its order;
        returns the in-flight microbatch count M."""
        if pp_stages > dec.cfg.num_layers:
            raise ValueError(
                f"pp_stages={pp_stages} exceeds num_layers="
                f"{dec.cfg.num_layers}: every stage needs at least "
                "one layer. Fix: lower pp_stages (or serve a "
                "deeper model)."
            )
        if spec_k:
            raise ValueError(
                "spec_k > 0 does not compose with pp_stages > 1 "
                "yet: the draft lane proposes against a monolithic "
                "pool and the verify forward would have to thread "
                "k+1 candidate rows through every stage boundary. "
                "Fix: serve speculation on a pp_stages=1 server, "
                "or set spec_k=0 here."
            )
        if constraints is not None:
            raise ValueError(
                "constraints= does not compose with pp_stages > 1 "
                "yet: the DFA advance is fused into the monolithic "
                "window program. Fix: serve constrained requests "
                "on a pp_stages=1 server."
            )
        if self.multi_lora:
            raise ValueError(
                "multi-LoRA does not compose with pp_stages > 1: "
                "adapter banks are not stage-sliced. Fix: merge "
                "the adapter (parallel/lora.py) or serve adapters "
                "on pp_stages=1."
            )
        if prefix_ids is not None:
            raise ValueError(
                "constructor prefix_ids does not compose with "
                "pp_stages > 1: the one-shot prefix insert runs "
                "through the monolithic flat path. Fix: use "
                "prefix_cache=True (shares prefixes per request, "
                "pool-native) instead."
            )
        if spill_bytes:
            raise ValueError(
                "spill_bytes > 0 does not compose with "
                "pp_stages > 1 yet: spill snapshots slice a "
                "monolithic pool. Fix: set spill_bytes=0 (evicted "
                "prefix blocks are then re-prefilled)."
            )
        if kv_dtype != "fp":
            raise ValueError(
                f"kv_dtype={kv_dtype!r} does not compose with "
                "pp_stages > 1 yet: the per-stage pool slices are "
                "compute-dtype only. Fix: use kv_dtype='fp' with "
                "pp, or int8 on a pp_stages=1 server."
            )
        if device is not None:
            raise ValueError(
                "device= pins ONE device but pp_stages > 1 places "
                "each stage on its own. Fix: pass the stage "
                "placement as pp_devices=[dev0, dev1, ...] "
                "instead."
            )
        if pp_balance not in ("equal", "probe"):
            raise ValueError(
                f"pp_balance must be 'equal' or 'probe', got "
                f"{pp_balance!r}"
            )
        pp_m = (pp_inflight if pp_inflight is not None
                else min(pp_stages, max_batch))
        if pp_m < 1:
            raise ValueError(f"pp_inflight must be >= 1, got {pp_m}")
        if max_batch % pp_m:
            raise ValueError(
                f"max_batch={max_batch} does not divide into "
                f"pp_inflight={pp_m} equal microbatch slot "
                "groups. Fix: pick max_batch a multiple of "
                "pp_inflight (or pass pp_inflight= a divisor of "
                "max_batch)."
            )
        return pp_m

    def _check_mesh(self, dec, mesh, model_axis, pp_stages,
                    pp_stage_axis) -> int:
        """The JAX package's mesh= refusals, in its order, then the one
        of a one-process mesh (only the stage axis may be larger than 1
        there); returns the model axis size."""
        if getattr(dec, "mesh", None) is not None:
            raise ValueError(
                "pass the plain single-device decoder together "
                "with mesh= — the server builds its own sharded "
                "step (an SpmdGptDecoder here would double-wrap "
                "shard_map)"
            )
        if model_axis not in mesh.axis_names:
            raise ValueError(
                f"model_axis {model_axis!r} is not an axis of the "
                f"mesh (axes: {mesh.axis_names}); build the mesh "
                f"with parallel.mesh.make_mesh({{{model_axis!r}: "
                "N})"
            )
        tp = int(mesh.shape[model_axis])
        kvh = dec.cfg.kv_heads
        if kvh < tp:
            raise ValueError(
                f"GQA num_kv_heads={kvh} is smaller than the "
                f"{model_axis!r} axis size {tp}: the paged pool "
                "shards whole KV heads, so some devices would own "
                "none. Fix: serve on a mesh whose model axis has "
                f"at most {kvh} devices (put the rest on a data "
                "axis), or replicate KV heads in the checkpoint."
            )
        if kvh % tp:
            fit = max(d for d in range(1, kvh + 1)
                      if kvh % d == 0 and d <= tp)
            raise ValueError(
                f"num_kv_heads={kvh} does not divide by the "
                f"{model_axis!r} axis size {tp}: each device must "
                "own an equal whole-head slice of the paged pool. "
                f"Fix: use a model axis size that divides {kvh} "
                f"(largest that fits: {fit}), or pad kv_heads to "
                f"a multiple of {tp} in the checkpoint."
            )
        if self.multi_lora:
            raise ValueError(
                "mesh= with multi-LoRA is unsupported: the adapter "
                "banks are not sharded — serve adapters on "
                "mesh=None"
            )
        if pp_stages > 1:
            if pp_stage_axis not in mesh.axis_names:
                raise ValueError(
                    f"pp_stages={pp_stages} with mesh= needs a "
                    f"{pp_stage_axis!r} mesh axis for the stage "
                    f"dimension (axes: {mesh.axis_names}). Fix: "
                    "build the mesh with parallel.multihost."
                    f"make_multihost_mesh({{{pp_stage_axis!r}: "
                    f"{pp_stages}, {model_axis!r}: tp}})."
                )
            if int(mesh.shape[pp_stage_axis]) != pp_stages:
                raise ValueError(
                    f"mesh {pp_stage_axis!r} axis has size "
                    f"{int(mesh.shape[pp_stage_axis])} but "
                    f"pp_stages={pp_stages}; the two must match"
                )
        check_process_group(mesh, pp_stage_axis)
        return tp

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
        `adapter_id`: the request's LoRA adapter when banks are attached
        (0 = base model). `sampling`: an optional SamplingParams (None or
        temperature 0 = greedy; its `constraint` applies either way); the
        slot samples inside the shared tick from its own seeded
        generator. `stop`: optional multi-token stop sequences; the
        request finishes the moment its generated tail equals one,
        freeing its blocks mid-budget."""
        self._controller_only("submit")
        if prompt_ids.ndim != 2 or prompt_ids.shape[0] != 1:
            raise ValueError("submit one request at a time ([1, T])")
        cid = 0
        if sampling is not None:
            sampling.validate()
            # The constraint survives the greedy normalization below.
            cid = self._resolve_constraint(sampling.constraint)
            if sampling.temperature == 0:
                sampling = None  # greedy: keep the argmax fast path
        stop_seqs = normalize_stops(stop)
        if adapter_id:
            if not self.multi_lora:
                raise ValueError(
                    "adapter_id set but params carry no adapter banks "
                    "(parallel/lora.py::stack_adapters)"
                )
            if not 0 <= adapter_id < self.num_adapters:
                raise ValueError(
                    f"adapter_id {adapter_id} out of range "
                    f"[0, {self.num_adapters})"
                )
        t0 = prompt_ids.shape[1]
        if t0 < 1 or num_steps < 1:
            raise ValueError("need at least 1 prompt token and 1 step")
        # spec_k rows of write headroom: a verify at position p writes
        # candidate rows through p + spec_k.
        if (
            self.prefix_len + t0 + num_steps + self.spec_k
            > self.dec.cfg.max_len
        ):
            extra = (
                f" + spec_k {self.spec_k} headroom" if self.spec_k else ""
            )
            raise ValueError(
                f"prefix {self.prefix_len} + prompt {t0} + steps "
                f"{num_steps}{extra} exceeds max_len "
                f"{self.dec.cfg.max_len}"
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
            # analysis: ignore[host-sync-in-hot-loop] submit takes host
            # prompts (a no-op copy then); a prompt already on the card is
            # read to the host once a request, for the radix walk
            (rid, prompt_ids.cpu(), prompt_ids.to(self.device), num_steps,
             adapter_id, sampling, stop_seqs, cid)
        )
        self._submit_t[rid] = time.perf_counter()
        return rid

    def _resolve_constraint(self, name: str | None) -> int:
        return crt.resolve_constraint(
            name, self._ctrans, self._cnames, self._cdfas
        )

    def _own_need(self, t0: int, steps: int) -> int:
        """Blocks a request must own: its total span minus the shared
        prefix blocks its table merely points at."""
        total = -(-(self.prefix_len + t0 + steps) // self.bs)
        return total - len(self.shared_blocks)

    def submit_prefilled(
        self,
        prompt_ids: Any,
        num_steps: int,
        *,
        sampling: Any = None,
        stop: Any = None,
    ) -> int:
        """Register a request whose prefill runs elsewhere (a disagg
        prefill worker): it waits in `pending_prefilled` until
        `deliver_kv` hands over its finished KV blocks, then admission
        seats those blocks in the pool with no local prefill step. Same
        sampling/stop semantics as `submit`. The base model only, and no
        constructor `prefix_ids` (prefix_cache=True composes: ingested
        full prompt blocks register in the radix cache; spec_k > 0
        composes: the draft lane re-prefills locally from the prompt
        ids)."""
        self._controller_only("submit_prefilled")
        if self.pp > 1:
            raise ValueError(
                "disagg ingest (submit_prefilled/deliver_kv) does not "
                "compose with pp_stages > 1 yet: delivered KV blocks "
                "target a monolithic pool, not per-stage slices. Fix: "
                "point the prefill worker at a pp_stages=1 decode "
                "server, or submit() so prefill runs through the "
                "stage chain."
            )
        if self.shared_blocks or self.prefix_len:
            raise ValueError(
                "externally prefilled admission does not compose with "
                "constructor-level prefix_ids; use prefix_cache=True"
            )
        if self.multi_lora:
            raise ValueError(
                "externally prefilled admission supports the base "
                "model only (adapter-specific K/V would need the "
                "worker to run the same adapter banks)"
            )
        prompt = np.asarray(
            prompt_ids.cpu() if isinstance(prompt_ids, torch.Tensor)
            else prompt_ids
        )
        if prompt.ndim != 2 or prompt.shape[0] != 1:
            raise ValueError("submit one request at a time ([1, T])")
        cid = 0
        if sampling is not None:
            sampling.validate()
            cid = self._resolve_constraint(sampling.constraint)
            if sampling.temperature == 0:
                sampling = None
        stop_seqs = normalize_stops(stop)
        t0 = prompt.shape[1]
        if t0 < 1 or num_steps < 1:
            raise ValueError("need at least 1 prompt token and 1 step")
        if t0 + num_steps + self.spec_k > self.dec.cfg.max_len:
            extra = (
                f" + spec_k {self.spec_k} headroom" if self.spec_k else ""
            )
            raise ValueError(
                f"prompt {t0} + steps {num_steps}{extra} exceeds "
                f"max_len {self.dec.cfg.max_len}"
            )
        need = self._own_need(t0, num_steps)
        usable = self.num_blocks - 1
        if need > usable:
            raise ValueError(
                f"request needs {need} blocks but the pool has "
                f"{usable} usable"
            )
        rid = self._next_id
        self._next_id += 1
        self.pending_prefilled[rid] = {
            "prompt": prompt.astype(np.int32),
            "steps": num_steps,
            "samp": sampling,
            "stop": stop_seqs,
            "cid": cid,
            "kv": None,
        }
        self._prefilled_order.append(rid)
        self._submit_t[rid] = time.perf_counter()
        return rid

    def deliver_kv(self, rid: int, k_blocks, v_blocks, first_logits) -> None:
        """Hand a pending_prefilled request its finished KV state:
        [L, n_blocks, Hkv, bs, Dh] K/V block stacks covering the prompt
        rows (tensors or numpy arrays, on the host), and the [1, V]
        logits row of the last prompt position (the first generated
        token is drawn from it). Thread-safe against the serving loop:
        this only assigns the entry's "kv" field; the pool is touched by
        `_admit` on the serving thread alone."""
        self._controller_only("deliver_kv")
        entry = self.pending_prefilled.get(rid)
        if entry is None:
            raise KeyError(f"no pending prefilled request {rid}")
        t0 = entry["prompt"].shape[1]
        n_need = -(-t0 // self.bs)
        cfg = self.dec.cfg
        expect = (
            cfg.num_layers,
            n_need,
            cfg.kv_heads,
            self.bs,
            cfg.dim // cfg.num_heads,
        )
        if tuple(k_blocks.shape) != expect or tuple(v_blocks.shape) != expect:
            raise ValueError(
                f"KV block stack shape {tuple(k_blocks.shape)}/"
                f"{tuple(v_blocks.shape)} != expected {expect} for "
                f"rid {rid} (t0={t0}, block_size={self.bs})"
            )
        if tuple(first_logits.shape) != (1, cfg.vocab_size):
            raise ValueError(
                f"first_logits shape {tuple(first_logits.shape)} != "
                f"(1, {cfg.vocab_size})"
            )
        entry["kv"] = (k_blocks, v_blocks, first_logits)

    def export_prefix_blocks(
        self, keys: list[bytes]
    ) -> tuple[list[bytes], torch.Tensor, torch.Tensor] | None:
        """Copy a resident prefix chain OUT of the pool for migration:
        `keys` is a root-anchored run of chained digests (the router's
        walk order); returns (own-block token bytes per block,
        [L, n, Hkv, bs, Dh] K and V block stacks as CPU tensors in the
        compute dtype; an int8 pool dequantizes first) or None if a key
        was evicted since the advertisement the caller routed on.

        SERVING-THREAD ONLY: a tick writes the pool in place (a captured
        window replays into the same storage), so a reader on another
        thread could copy rows mid-write. Fleet replicas run this as an
        ops-queue command between ticks. The copy is self-contained:
        once returned, eviction here cannot hurt the importer."""
        self._controller_only("export_prefix_blocks")
        if self.radix is None:
            raise ValueError("export needs prefix_cache=True")
        blks: list[int] = []
        toks: list[bytes] = []
        for key in keys:
            blk = self.radix.by_key.get(key)
            if blk is None:
                return None  # evicted since the advert; stale route
            blks.append(blk)
            toks.append(self.radix.tok_of[blk])
        k, v = self._export_blocks(blks)
        return toks, k, v

    @_program
    def _export_blocks(self, blks: list[int]) -> list:
        """K and V [L, n, Hkv, bs, Dh] stacks of pool blocks `blks` as CPU
        tensors in the compute dtype, every head (gathered under a mesh);
        an int8 pool dequantizes first."""
        idx = self._upload(blks).long()
        out = []
        for pool in (self.pool_k, self.pool_v):
            if isinstance(pool, dict):
                # Widened in f32 and rounded once to the compute dtype
                # (the JAX package multiplies in the compute dtype): the
                # importer's requantization then gives back the payload.
                blocks = dequantize_symmetric(
                    pool["q"][:, idx], pool["s"][:, idx][..., None, None],
                ).to(self.dec.compute_dtype)
            else:
                blocks = pool[:, idx]
            # analysis: ignore[host-sync-in-hot-loop] the copy to host memory
            # IS the operation: a migration ships the payload over a host wire
            out.append(self._all_heads(blocks).cpu())
        return out

    def import_prefix_blocks(self, toks: list[bytes], k_blocks,
                             v_blocks) -> int:
        """Seat a migrated prefix chain (an export_prefix_blocks payload;
        tensors or numpy arrays) in this pool as PARKED radix entries:
        the next admission sharing the prefix revives them through the
        normal walk, with no re-prefill. Chained digests are recomputed
        HERE from the token bytes (never trusted from the wire), so a
        corrupted payload mis-keys into digests nothing looks up.
        Already-resident leading blocks are skipped; allocation evicts
        parked LRU blocks under pressure and truncates the (deep) tail
        when the pool still cannot cover it. The blocks land with one
        indexed write a pool (an int8 pool quantizes them per (layer,
        block, head) as they land). Returns the blocks imported.

        SERVING-THREAD ONLY, as export. The JAX package pads the span to
        a power of two for its compile shapes; eager writes need no pad,
        and the count and the radix state are the same."""
        self._controller_only("import_prefix_blocks")
        if self.radix is None:
            raise ValueError("import needs prefix_cache=True")
        n = len(toks)
        cfg = self.dec.cfg
        expect = (cfg.num_layers, n, cfg.kv_heads, self.bs,
                  cfg.dim // cfg.num_heads)
        if tuple(k_blocks.shape) != expect or tuple(v_blocks.shape) != expect:
            raise ValueError(
                f"prefix block stack shape {tuple(k_blocks.shape)}/"
                f"{tuple(v_blocks.shape)} != expected {expect}"
            )
        keys: list[bytes] = []
        prev = b""
        for bb in toks:
            prev = PrefixBlockCache._hash(prev, bb)
            keys.append(prev)
        # Skip the already-resident leading run (tok-guarded, as walk()).
        m = 0
        while m < n:
            blk = self.radix.by_key.get(keys[m])
            if blk is None or self.radix.tok_of[blk] != toks[m]:
                break
            m += 1
        if m == n:
            return 0
        need = n - m
        if need > len(self.free):
            self.free.extend(self.radix.evict(need - len(self.free)))
        take = min(need, len(self.free))
        if take == 0:
            return 0
        own = [self.free.pop() for _ in range(take)]
        self._import_blocks(own, k_blocks[:, m : m + take],
                            v_blocks[:, m : m + take])
        for j, blk in enumerate(own):
            displaced = self.radix.register(keys[m + j], toks[m + j], blk)
            if displaced is not None:
                self.free.append(displaced)
        # Park deepest-first (as _finish): LRU then evicts the deep end
        # of the chain before its shallow prerequisites.
        for blk in reversed(own):
            self.radix.release(blk)
        self._update_pool_gauges()
        return take

    @_program
    def _import_blocks(self, own: list[int], k_blocks, v_blocks) -> None:
        """Write full migrated K/V block stacks [L, n, Hkv, bs, Dh] into
        pool blocks `own` with one indexed write a pool, this rank's
        heads under a mesh; an int8 pool quantizes them per (layer,
        block, head) as they land."""
        dest = self._upload(own).long()
        for pool, arr in ((self.pool_k, k_blocks), (self.pool_v, v_blocks)):
            blocks = self._heads(torch.as_tensor(arr)).to(
                self.device, self.dec.compute_dtype
            )
            if isinstance(pool, dict):
                q, sc = _quantize_blocks(blocks)
                pool["q"][:, dest] = q
                pool["s"][:, dest] = sc
            else:
                pool[:, dest] = blocks

    def run(self) -> dict[int, torch.Tensor]:
        """Serve until every submitted request completes; returns
        {request_id: ids [1, T0 + num_steps]} (shorter when eos or a
        stop sequence ended a request early). On a follower rank of a
        mesh, run the controller's dispatches until it closes, and
        return an empty dict."""
        if not self.controller:
            self._follow()
            return {}
        while self.step():
            pass
        return self.done

    def step(self) -> bool:
        """One round of `run`: admit what the pool and the free slots
        take, then one decode dispatch over the live slots (a tick, a
        window, a mixed tick or a speculative round). Returns False,
        doing nothing, once every submitted request has completed. With
        nothing to admit, a round is exactly one dispatch, so a caller
        can drive and time steady ticks through it. A round with nothing
        seated while externally prefilled requests wait for their KV
        yields for a millisecond instead of spinning."""
        self._controller_only("step")
        if not (self.pending or self.pending_prefilled or any(self.slots)):
            return False
        self._admit()
        if any(s is not None for s in self.slots):
            self._tick()
        elif self.pending_prefilled:
            time.sleep(1e-3)
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

    # -- the mesh ---------------------------------------------------------

    def _tp_axis(self):
        """The tp axis the bodies thread through the decoder's hooks: the
        mesh's model axis when serving sharded, None otherwise (with None
        every body runs exactly the single-device program)."""
        return self.model_axis if self.mesh is not None else None

    def _flat_dec(self):
        """The decoder of the flat (contiguous-lane) prefill programs:
        under a mesh the server's SpmdGptDecoder view, whose lanes hold
        this rank's heads; otherwise the server's decoder."""
        return self._sdec if self._sdec is not None else self.dec

    def _account_psums(self, n_forwards: int) -> None:
        """Count the collectives `n_forwards` sharded forwards issue (2L
        + 2 each: the host mirror of defer_tp_psum_total); a no-op
        without a mesh."""
        # A capture records its forwards without running them; the
        # window's replays count them (`_tick_window`).
        if self._psums_per_fwd and not (
                self._captures and torch.cuda.is_current_stream_capturing()):
            n = self._psums_per_fwd * n_forwards
            self.tp_psums += n
            self.obs.tp_psums.inc(n)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's heads (axis 2, shared by the [L, n, Hkv, bs, Dh]
        block stacks, the [L, 1, Hkv, S, Dh] lanes and the [L, n, Hkv]
        int8 scales) of a whole-head tensor; the tensor itself without a
        mesh. Full-head K/V from the host lands sharded this way."""
        if self.tp == 1:
            return t
        h = t.shape[2] // self.tp
        return t.narrow(2, collectives.axis_index(self.model_axis) * h, h)

    def _all_heads(self, t: torch.Tensor) -> torch.Tensor:
        """The inverse of `_heads`: every rank's heads, gathered on axis
        2 (on every rank of the model group)."""
        if self.tp == 1:
            return t
        return collectives.all_gather(t.contiguous(), self.model_axis, dim=2)

    def _follow(self) -> None:
        """A follower rank's serving loop: run each program the
        controller dispatches, on this rank's shards, until it closes."""
        link = self._link
        while True:
            msg = link.recv()
            if msg is None:
                return
            name, args, kw = msg
            getattr(self, name)(*_from_wire(args, self.device),
                                **_from_wire(kw, self.device))

    def close(self) -> None:
        """Release the model group: the controller's STOP ends the
        followers' loops (their `run` returns). Idempotent; a no-op
        without a process group."""
        if self._link is not None and self.controller:
            self._link.stop()

    def _controller_only(self, what: str) -> None:
        if not self.controller:
            raise RuntimeError(
                f"{what} runs on the controller (the rank at index 0 of "
                f"the {self.model_axis!r} axis); this rank follows its "
                "dispatches in run()"
            )

    # -- pool programs ----------------------------------------------------

    def _upload(self, arr) -> torch.Tensor:
        """A host int array on the device, as int32 (the kernels' table
        type), without a host sync: on CUDA through a fresh pinned
        buffer that is never written again, so the asynchronous copy
        cannot race a later host write."""
        # analysis: ignore[host-sync-in-hot-loop] host ints going up through a
        # pinned buffer: np.array of host data syncs nothing
        t = torch.from_numpy(np.array(arr, dtype=np.int32))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _adapters(self):
        """The slots' adapter ids for the bank gather, or None without
        adapter banks (the steps then run the base-model ops only)."""
        return self._adapter_dev.long() if self.multi_lora else None

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

    @torch.no_grad()
    def _step(self, nb_live: int) -> torch.Tensor:
        """One decode tick over every slot: the feed [B, 1] at the
        device positions through the slots' tables. Idle slots sit at
        position 0 with an all-trash table, so their write lands in
        trash block 0 row 0. Returns logits [B, 1, V] in f32."""
        return self._decode(self._tables_dev, self._pos_dev, self._feed,
                            nb_live)

    @_program
    @torch.no_grad()
    def _decode(self, tables, pos, feed, nb_live: int) -> torch.Tensor:
        """The T=1 paged step on explicit device inputs: the K=1 tick
        runs it on the server's tables and positions, a decode window on
        the per-sub-step masked copies (frozen rows at position 0 with an
        all-trash table). `nb_live` bounds the "blockwise" fold: a host
        int, the batch's deepest live block at K=1 and the table's span
        MB in a window, whose positions move on the device (the extra
        columns are fully masked and add exactly nothing)."""
        dec, bs = self.dec, self.bs
        params = self.params
        window = dec.cfg.window
        aid = self._adapters()
        tp = self._tp_axis()
        self._account_psums(1)
        x = dec._embed_tokens(params, feed, pos, tp)
        blk_w = tables.gather(1, (pos // bs).long()[:, None])[:, 0].long()
        row_w = (pos % bs).long()
        stack = params["stack"]
        if self.attention == "gathered":
            plan = dec._plan(pos, 1, self.MB * bs)
            plan["adapter"] = aid
            plan["tp"] = tp
            idx = tables.long()
            posl = pos.long()
            for layer in range(dec.cfg.num_layers):
                pk_l = _pool_layer(self.pool_k, layer)
                pv_l = _pool_layer(self.pool_v, layer)
                kc = _gathered_view(pk_l, idx, dec.compute_dtype)
                vc = _gathered_view(pv_l, idx, dec.compute_dtype)
                x = dec._block(_layer_view(stack, layer), x, kc, vc, pos, plan)
                # Scatter ONLY the new row back to its page.
                _pool_write_rows(pk_l, blk_w, row_w, kc[self._rows, :, posl])
                _pool_write_rows(pv_l, blk_w, row_w, vc[self._rows, :, posl])
            return dec._final_logits(params, x, tp)
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
            q, k_new, v_new = dec._attn_qkv(p, x, rope, aid)
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
            x = dec._attn_out(p, x, attn, aid, tp)
        return dec._final_logits(params, x, tp)

    @_program
    @torch.no_grad()
    def _mt(self, tables, pos, ids, n_keep, keep_from, nb_live,
            adapter=None):
        """The multi-token paged step: ids [B, T], row t of slot b at
        absolute position pos[b] + t, K/V read through the tables and
        all T new rows scattered back. A row's write redirects to trash
        block 0 when the slot does not keep it: row index >= n_keep[b]
        (a prefill tail's pad rows, a sampled slot's candidates in a
        speculative round, a frozen row's) or position < keep_from[b]
        (radix hit rows, other requests' memory). `adapter` [B]: the
        rows' LoRA adapter ids (None without banks). Serves chunked
        prefill, mixed ticks and the speculative verify. Returns logits
        [B, T, V]."""
        self._account_psums(1)
        return _mt_forward(
            self.dec, self.params, self.pool_k, self.pool_v, tables, pos,
            ids, n_keep, keep_from, nb_live, self.attention, self.bs,
            adapter=adapter, tp=self._tp_axis(),
        )

    def _prefill_paged(self, prompt, table_row, *, base, keep_from,
                       adapter_id=0):
        """Chunked POOL-NATIVE prefill: run `prompt` [1, T0] (on the
        device) through the multi-token step in prefill_chunk-token
        chunks, writing K/V straight into the allocated blocks through
        the table. `base`: absolute position of prompt[:, 0]; positions
        below `keep_from` write to trash block 0 (radix hit rows). Tail
        chunks pad to a power of two, as the JAX package's do (so the
        chunk boundaries and shapes match), capped so the deepest write
        stays inside the table span. Returns the [1, V] logits row of
        the last real prompt position.

        A pipeline-parallel server always admits this way: each chunk
        flows through the stage chain, every stage writing its layers'
        rows into its pool slice, and without prefill_chunk the whole
        prompt rides one chunk (capped by the table span)."""
        C = (self.prefill_chunk if self.prefill_chunk is not None
             else self.MB * self.bs)
        t0 = prompt.shape[1]
        dev = self.device
        tab = self._upload(table_row[None, :])
        kf = torch.full((1,), keep_from, dtype=torch.int32, device=dev)
        adapter = (torch.full((1,), adapter_id, dtype=torch.int32,
                              device=dev) if self.multi_lora else None)
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
            pos_a = torch.full((1,), pos0, dtype=torch.int32, device=dev)
            nk = torch.full((1,), real, dtype=torch.int32, device=dev)
            if self.pp > 1:
                logits = self._pp_chain(tab, pos_a, chunk.to(torch.int32),
                                        nk, kf, torch.zeros_like(kf))
                logits = logits.to(dev)
            else:
                logits = self._mt(tab, pos_a, chunk, nk, kf, nb_live,
                                  adapter)
            self.prefill_chunks += 1
            self._account_kv_rows_prefill(pos0, pad_t)
            self._note_prefill_stall(1)
            logits_row = logits[:, real - 1, :]
            start += real
        return logits_row

    # -- accounting -------------------------------------------------------

    def _account_kv_rows(self, rows_read: int, baseline: int) -> None:
        """Publish one dispatch's KV-row traffic (obs/serving.py units:
        one K+V row pair of one slot, layer-agnostic). Under a mesh both
        counters are PER SHARD: a rank reads its kv_heads / tp heads, so
        rows scale by 1 / tp while dispatch counts do not."""
        tp = self.tp
        self.obs.kv_rows_read.inc(rows_read // tp)
        self.obs.kv_rows_gathered.inc(baseline // tp)
        self.obs.kv_rows_last.set(rows_read // tp)

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

    def _rows_read_multi(self, posm, t: int, lo_first: bool) -> int:
        """Pool rows one [B, T] multi-token step read: row b attends
        through posm[b] + t - 1. The window's edge is the first row's
        (`lo_first`, the speculative verify's accounting) or the last
        row's (a mixed tick's), as in the JAX package. Derived from
        max_len and live spans, never pool size."""
        bs = self.bs
        if self.attention == "gathered":
            return self.B * self.MB * bs
        if self.attention == "blockwise":
            # analysis: ignore[host-sync-in-hot-loop] posm is the host
            # position mirror (numpy): no card read
            return self.B * ((int(posm.max()) + t - 1) // bs + 1) * bs
        win = self.dec.cfg.window
        hi = (posm + t - 1) // bs
        if win is None:
            lo = np.zeros_like(posm)
        else:
            edge = posm - win + 1 if lo_first else posm + t - win
            lo = np.maximum(edge, 0) // bs
        return int(np.sum(hi - lo + 1)) * bs

    def _rows_read_decode(self, posm) -> int:
        """Pool rows one T=1 step read over the positions `posm` (idle
        and frozen rows at 0): "blockwise" every slot to the batch's
        deepest live block, "pallas" each slot its own live span."""
        bs = self.bs
        if self.attention == "gathered":
            return self.B * self.MB * bs
        if self.attention == "blockwise":
            return self.B * (int(max(posm)) // bs + 1) * bs
        spans = (_decode_lo_hi(int(p), bs, self.dec.cfg.window)
                 for p in posm)
        return sum(hi - lo + 1 for lo, hi in spans) * bs

    def _account_kv_rows_window(self, posm, emitted) -> None:
        """A window's rows, sub-step by sub-step: a row active at
        sub-step t (t < emitted[i]) reads at depth posm[i] + t; frozen
        and idle rows sit at position 0, as the window's masking puts
        them."""
        K = self.decode_window
        pos_l = [int(p) for p in posm]
        rows_read = sum(
            self._rows_read_decode(
                [p + t if t < e else 0 for p, e in zip(pos_l, emitted)]
            )
            for t in range(K)
        )
        self._account_kv_rows(rows_read, K * self.B * self.MB * self.bs)

    def _note_prefill_stall(self, n_dispatches: int) -> None:
        """Account admission-prefill dispatches of the serialized path:
        each one issued while a decode slot (not a prefill seat) is live
        is a stall tick."""
        if any(s is not None and "prefill" not in s for s in self.slots):
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

    def _note_dispatch(self, n_live: int, n_dispatches: int = 1,
                       stall: bool = True) -> None:
        """A decode dispatch's tick, dispatch and inter-token accounting;
        `stall` republishes the stall fraction (a speculative round does
        not, as in the JAX package)."""
        self.ticks += 1
        self.dispatches += n_dispatches
        now = time.perf_counter()
        if self._last_tick_t is not None and n_live:
            self.obs.itl.observe(now - self._last_tick_t, n_live)
        self._last_tick_t = now
        self.obs.ticks.inc()
        self.obs.host_dispatches.inc(n_dispatches)
        if stall:
            self._update_stall_fraction()

    # -- the spill tier ---------------------------------------------------

    def _spill_block(self, key: bytes, tok: bytes, blk: int) -> None:
        """PrefixBlockCache on_evict hook (serving thread): clone the
        evicted block's stored bytes on the serving stream and hand the
        clones to the drain thread with an event recorded after them.
        The pool is written in place and the block is about to be
        reused, so a view would read its next tenant's rows; the clone
        is ordered before any later write on the stream. Nothing here
        waits for the card."""
        arrays = self._block_rows(blk)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        self._spill.offer(key, tok, arrays, ready)

    @_program
    def _block_rows(self, blk: int) -> tuple:
        """Copies of pool block `blk`'s stored bytes, [L, 1, ...] a leaf,
        with every head (gathered to the controller's whole-head store
        under a mesh)."""
        return tuple(self._all_heads(t[:, blk : blk + 1].clone())
                     for t in self._leaves())

    @_program
    def _write_block(self, blk: int, arrays) -> None:
        """Upload stored block bytes (whole-head [L, 1, ...] leaves)
        VERBATIM into pool block `blk`, this rank's heads of them."""
        for dst, src in zip(self._leaves(), arrays):
            dst[:, blk].copy_(self._heads(src)[:, 0], non_blocking=True)

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
            self._write_block(blk, got)
            displaced = self.radix.register(keys[j], toks[j], blk)
            if displaced is not None:
                self.free.append(displaced)
            hits.append(blk)
            self.spill_hits_n += 1
            self.obs.prefix_spill_hits.inc()
            j += 1
        return hits

    # -- admission --------------------------------------------------------

    def _flat_prefill(self, small, suffix, base, adapter_id=0):
        """Contiguous prefill of `suffix` [1, ts] at offset `base` on the
        flat lane `small`, bucketed to a power of two and capped inside
        max_len, as the flat server's admission: returns (the last real
        logits row, the lane)."""
        ts = suffix.shape[1]
        pad = 1 << (ts - 1).bit_length()
        pad = min(pad, self.dec.cfg.max_len - base)
        padded = torch.cat([suffix, suffix.new_zeros((1, pad - ts))], dim=1)
        if self.multi_lora:
            small = {**small, "adapter": torch.full(
                (1,), adapter_id, dtype=torch.int32, device=self.device)}
        logits, small = self._flat_dec().make_step(
            donate=self._prefix_cache is None
        )(self.params, small, padded)
        self._account_psums(1)
        self._note_prefill_stall(1)
        return logits[:, ts - 1, :], small

    @_program
    def _prefill_prefix(self, prefix_ids, shared_row, n_shared) -> None:
        """The constructor's `prefix_ids`: one flat prefill whose rows
        become the pool's single shared copy; the lane stays for suffix
        admissions (the suffix prefill attends it at offset P)."""
        fdec = self._flat_dec()
        _, pre = fdec.make_step()(self.params, fdec.init_cache(1),
                                  prefix_ids)
        self._account_psums(1)
        self._insert(pre["k"], pre["v"], shared_row, 0, n_shared)
        self._prefix_cache = pre

    @_program
    def _prefill_flat(self, prompt_dev, table_row, n_shared, n_end,
                      adapter_id):
        """A non-radix admission's contiguous prefill through the flat
        decoder, its rows then paged into table_row[n_shared:n_end]; with
        a shared prefix the prompt prefills at offset P on a copy of the
        prefix lane. Returns the last real logits row."""
        small = (self._flat_dec().init_cache(1)
                 if self._prefix_cache is None else self._prefix_cache)
        logits_row, small = self._flat_prefill(small, prompt_dev,
                                               self.prefix_len, adapter_id)
        self._insert(small["k"], small["v"], table_row, n_shared, n_end)
        return logits_row

    @_program
    def _prefill_radix_flat(self, table_row, n_hits, suffix, suffix_pos,
                            adapter_id, total, t0):
        """A radix admission's flat prefill of the suffix on a lane
        gathered from its hit blocks, its fresh rows then paged into
        table_row[n_hits:total]. Hit blocks are never rewritten: their
        recomputed rows are equivalent, not guaranteed identical, and
        they belong to every holder of the chain."""
        if n_hits:
            gk, gv = self._gather(self._upload(table_row))
            small = {
                "k": gk,
                "v": gv,
                "pos": torch.full((), suffix_pos, dtype=torch.int32,
                                  device=self.device),
            }
        else:
            small = self._flat_dec().init_cache(1)
        logits_row, small = self._flat_prefill(small, suffix, suffix_pos,
                                               adapter_id)
        self._insert(small["k"], small["v"], table_row, n_hits, total,
                     valid=t0)
        return logits_row

    @_program
    def _seat_kv(self, k_blocks, v_blocks, table_row, skip, total,
                 valid) -> None:
        """Page delivered full-head K/V block stacks (disagg) into
        table_row[skip:total], this rank's heads of them under a mesh."""
        self._insert(self._blocks_to_lane(k_blocks),
                     self._blocks_to_lane(v_blocks), table_row, skip, total,
                     valid=valid)

    def _walk(self, tokens: np.ndarray, n_full: int, total: int):
        """A radix admission's block plan: the walk's leading hits
        (spill revivals included), the chain keys and own-token bytes of
        every full prompt block, and `total - hits` fresh blocks (parked
        blocks evicted only under pressure). None, with the hits' refs
        rolled back, when even eviction cannot cover the need."""
        bs = self.bs
        hits, keys, toks = self.radix.walk(tokens, n_full, bs)
        if self._spill is not None and len(hits) < n_full:
            hits = self._revive_spilled(hits, keys, toks, n_full)
        need = total - len(hits)
        if need > len(self.free):
            self.free.extend(self.radix.evict(need - len(self.free)))
        if need > len(self.free):
            for blk in hits:
                self.radix.release(blk)
            return None
        own = [self.free.pop() for _ in range(need)]
        self.obs.requests_admitted.inc()
        self.obs.prefix_hits.inc(len(hits))
        self.obs.prefix_misses.inc(n_full - len(hits))
        return hits, keys, toks, own

    def _register(self, table_row, keys, toks, lo: int, hi: int) -> list:
        """Publish a request's fresh full prompt blocks lo..hi-1 in the
        radix cache (every row written); returns them."""
        out = []
        for j in range(lo, hi):
            # analysis: ignore[host-sync-in-hot-loop] table_row is the host
            # block table (numpy): no card read
            blk = int(table_row[j])
            displaced = self.radix.register(keys[j], toks[j], blk)
            if displaced is not None:
                self.free.append(displaced)
            out.append(blk)
        return out

    def _admit_radix(self, i, rid, prompt, prompt_dev, steps, adapter_id,
                     samp, stop_seqs, cid) -> bool:
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
        # analysis: ignore[host-sync-in-hot-loop] the host copy submit keeps
        # (a CPU tensor): .numpy() is a view, no sync
        plan = self._walk(prompt[0].numpy(), n_full, total)
        if plan is None:
            return False
        hits, keys, toks, own = plan
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
        if self.prefill_chunk is not None or self.pp > 1:
            # Pool-native: hit blocks are read through the table, fresh
            # rows scatter into this request's blocks chunk by chunk,
            # and rows below keep_from (hit rows) redirect to trash.
            logits_row = self._prefill_paged(
                suffix, table_row, base=suffix_pos, keep_from=len(hits) * bs,
                adapter_id=adapter_id,
            )
        else:
            logits_row = self._prefill_radix_flat(
                table_row, len(hits), suffix, suffix_pos, adapter_id, total,
                t0)
        shared = hits + self._register(table_row, keys, toks, len(hits),
                                       n_full)
        owned = [int(table_row[j]) for j in range(n_full, total)]
        self.prefill_tokens_saved += suffix_pos
        self.blocks_peak = max(self.blocks_peak, self.blocks_in_use)
        self._seat(i, rid, prompt_dev, steps, samp, stop_seqs, table_row,
                   t0, logits_row, owned, shared, adapter_id=adapter_id,
                   cid=cid)
        return True

    def _blocks_to_lane(self, blocks) -> torch.Tensor:
        """[L, n, Hkv, bs, Dh] host block stack (a tensor or a numpy
        array) -> the flat [L, 1, Hkv, n * bs, Dh] lane `_insert` takes,
        on the device in the compute dtype."""
        # analysis: ignore[host-sync-in-hot-loop] delivered KV arrives as host
        # arrays (disagg, import, spill): np.asarray of host data syncs nothing
        t = self._heads(torch.as_tensor(np.asarray(blocks) if not isinstance(
            blocks, torch.Tensor) else blocks))
        L, n, hkv, bs, dh = t.shape
        lane = t.transpose(1, 2).reshape(L, hkv, n * bs, dh)[:, None]
        lane = lane.to(self.dec.compute_dtype)
        if self.device.type == "cuda":
            return lane.pin_memory().to(self.device, non_blocking=True)
        return lane.to(self.device)

    def _admit_prefilled(self, i: int, rid: int, entry: dict) -> bool:
        """Seat a request whose KV arrived from a prefill worker: no
        prefill step runs here. The delivered blocks scatter straight
        into the allocated pool blocks (radix HIT blocks never
        rewritten), the first token is drawn from the shipped logits
        row, and fresh full prompt blocks register in the radix cache
        like locally prefilled ones. False when the pool cannot cover
        the request even after eviction (it stays pending)."""
        prompt = entry["prompt"]
        steps = entry["steps"]
        samp = entry["samp"]
        k_blocks, v_blocks, first_logits = entry["kv"]
        bs = self.bs
        t0 = prompt.shape[1]
        n_full = t0 // bs
        total = -(-(t0 + steps) // bs)
        if self.radix is not None:
            plan = self._walk(prompt[0].astype(np.int64), n_full, total)
            if plan is None:
                return False
            hits, keys, toks, own = plan
        else:
            need = total
            if need > len(self.free):
                return False
            hits = []
            own = [self.free.pop() for _ in range(need)]
            self.obs.requests_admitted.inc()
        self.obs.queue_wait.observe(
            time.perf_counter() - self._submit_t[rid]
        )
        table_row = np.zeros((self.MB,), np.int32)
        table_row[:total] = hits + own
        self._seat_kv(k_blocks, v_blocks, table_row, len(hits), total, t0)
        if self.radix is not None:
            shared = hits + self._register(table_row, keys, toks, len(hits),
                                           n_full)
            owned = [int(table_row[j]) for j in range(n_full, total)]
            self.blocks_peak = max(self.blocks_peak, self.blocks_in_use)
        else:
            shared = None
            owned = own
            self.blocks_peak = max(self.blocks_peak,
                                   self.blocks_in_use + total)
        # analysis: ignore[host-sync-in-hot-loop] the delivered first-token
        # logits row is host data: no card read
        lrow = torch.as_tensor(np.asarray(first_logits) if not isinstance(
            first_logits, torch.Tensor) else first_logits)
        lrow = lrow.to(self.device, torch.float32)
        prompt_dev = torch.from_numpy(prompt).to(self.device)
        self._seat(i, rid, prompt_dev, steps, samp, entry["stop"], table_row,
                   t0, lrow, owned, shared, cid=entry["cid"])
        return True

    def _admit_prefilled_ready(self, i: int) -> bool | None:
        """Seat the oldest DELIVERED prefilled request in slot i. True =
        seated; False = one was ready but the pool cannot cover it (wait
        for a finisher); None = nothing deliverable now."""
        for rid in self._prefilled_order:
            entry = self.pending_prefilled[rid]
            if entry["kv"] is None:
                continue
            t0 = time.perf_counter()
            seated = self._admit_prefilled(i, rid, entry)
            self.prefilled_admit_s += time.perf_counter() - t0
            if not seated:
                return False
            self._prefilled_order.remove(rid)
            del self.pending_prefilled[rid]
            return True
        return None

    def _admit(self) -> None:
        if self.prefill_budget is not None:
            # Mixed mode: new prompts take SEATS and prefill inside the
            # decode dispatches; the serialized path below never runs.
            return self._admit_mixed()
        for i in range(self.B):
            if self.slots[i] is not None:
                continue
            # Externally prefilled requests seat first: their compute is
            # already spent, so every tick they wait is added TTFT.
            seated = self._admit_prefilled_ready(i)
            if seated:
                continue
            if seated is False:
                return  # pool exhausted even after eviction
            if not self.pending:
                continue
            (rid, prompt, prompt_dev, steps, adapter_id, samp, stop_seqs,
             cid) = self.pending[0]
            if self.radix is not None:
                if not self._admit_radix(i, *self.pending[0]):
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
            if self.prefill_chunk is not None or self.pp > 1:
                # A global shared prefix (base=P) is read from its pool
                # blocks by the block-table attention.
                logits_row = self._prefill_paged(
                    prompt_dev, table_row, base=P, keep_from=0,
                    adapter_id=adapter_id,
                )
            else:
                # Contiguous prefill through the flat decoder, then page
                # the rows in; with a shared prefix the suffix prefills
                # at offset P on a copy of the prefix lane, and only the
                # rows past the shared blocks are paged.
                logits_row = self._prefill_flat(
                    prompt_dev, table_row, n_shared, n_shared + need,
                    adapter_id)
            self._seat(i, rid, prompt_dev, steps, samp, stop_seqs, table_row,
                       P + t0, logits_row, blocks, None,
                       adapter_id=adapter_id, cid=cid)

    def _first_token(self, i, samp, lrow, dtype, cid):
        """Admission's first generated token: a constrained slot masks
        the prefill logits row with its DFA's start-state row before the
        argmax or first draw, then installs the advanced state (a device
        scalar: no sync beyond the admission's own)."""
        if cid:
            # Submit refused a dead start state, so no row is dead here.
            cidv = torch.full((1,), cid, dtype=torch.int32,
                              device=self.device)
            lrow, _, settle, frac = crt.constrained_pick(
                self._ctrans, self._cacc, lrow, cidv, torch.zeros_like(cidv),
                torch.ones((1,), dtype=torch.bool, device=self.device),
                self.eos_id,
            )
        first = self._sampler.admit_first(i, samp, lrow, dtype)
        if cid:
            _, state = settle(first[0].long())
            self._sampler.admit_constraint(i, cid, state[0])
            # analysis: ignore[host-sync-in-hot-loop] once a constrained
            # admission (its first token), not a tick
            self.obs.constrain_masked_frac.observe(float(frac[0]))
            self.obs.constrained_tokens.inc()
            self.constrained_tokens_n += 1
        return first

    def _seat(self, i, rid, prompt_dev, steps, samp, stop_seqs, table_row,
              pos_val, logits_row, owned, shared, *, adapter_id=0,
              cid=0) -> None:
        """Install an admitted request in slot i: its first token, its
        table, position and adapter (host and device), its draft lane
        (speculation), and the eos/streaming/finish bookkeeping."""
        first = self._first_token(i, samp, logits_row, prompt_dev.dtype, cid)
        self.tables[i] = table_row
        self.pos[i] = pos_val
        self.adapter[i] = adapter_id
        self._tables_dev[i] = self._upload(table_row)
        self._pos_dev[i] = pos_val
        self._active[i] = 1
        if self.multi_lora:
            self._adapter_dev[i] = adapter_id
        slot = {
            "rid": rid,
            "remaining": steps - 1,
            "last": first,
            "toks": [prompt_dev, first],
            "blocks": owned,
            "sampling": samp is not None,
            "stop": matcher_or_none(stop_seqs),
            "cid": cid,
        }
        if shared is not None:
            slot["shared"] = shared
        self.slots[i] = slot
        spec = self._draft is not None and samp is None
        need_host = (
            spec
            or self.eos_id is not None
            or self.on_token is not None
            or slot["stop"] is not None
        )
        # One host read of the first token, where anything needs it.
        # analysis: ignore[host-sync-in-hot-loop] once an admission, and only
        # for a consumer of the host token (the draft lane, eos, stops,
        # streaming)
        first_host = int(first[0, 0]) if need_host else None
        if spec:
            # The first token is the slot's first pending draft token;
            # the draft lane prefills the FULL prompt (radix hits are a
            # pool concept the draft does not share).
            slot["pend"] = [first_host]
            self._draft.admit(i, prompt_dev)
        self._feed[i, 0] = first[0, 0]
        # ttft spans queue + prefill (popped here, the drain point).
        self.obs.ttft.observe(time.perf_counter() - self._submit_t.pop(rid))
        self._update_pool_gauges()
        self._emit_token(i, slot, first_host)

    # -- mixed ticks (prefill_budget=) --------------------------------------

    def _seat_slots(self) -> list[int]:
        """Slots holding a PREFILL SEAT (admitted, mid-prefill, not yet
        decoding), in admission order."""
        return [i for i, s in enumerate(self.slots)
                if s is not None and "prefill" in s]

    def _admit_mixed(self) -> None:
        """Seat-only admission for `prefill_budget=` servers: a new
        request claims a free slot and its blocks at once, but no
        prefill runs here; its prompt tokens ride inside later mixed
        dispatches (`_tick_mixed`) until the last chunk lands and the
        seat flips to decoding (`_flip_seat`). Externally prefilled
        requests bypass the budget: their compute is already spent."""
        for i in range(self.B):
            if self.slots[i] is not None:
                continue
            seated = self._admit_prefilled_ready(i)
            if seated:
                continue
            if seated is False:
                return  # pool exhausted even after eviction
            if not self.pending:
                continue
            if len(self._seat_slots()) >= self.prefill_lookahead:
                # Bounded lookahead keeps admission near-FIFO.
                return
            seat = (self._seat_radix if self.radix is not None
                    else self._seat_plain)
            if not seat(i, *self.pending[0]):
                return  # pool exhausted: wait for a finisher
            self.pending.popleft()

    def _seat_common(self, i, rid, prompt_dev, steps, adapter_id, samp,
                     stop_seqs, cid, seat, table_row, blocks, shared,
                     meta_extra=None) -> None:
        """Install a mid-prefill seat: its table (host and device) and
        base position. Sampling, stop and constraint state install at
        flip time, where `_seat` reseeds the sampler row, so sampled
        streams match the stall path draw for draw."""
        self.blocks_peak = max(self.blocks_peak, self.blocks_in_use)
        self.adapter[i] = adapter_id
        if self.multi_lora:
            self._adapter_dev[i] = adapter_id
        self.tables[i] = table_row
        self._tables_dev[i] = self._upload(table_row)
        self.pos[i] = seat.base
        meta = {"prompt_dev": prompt_dev, "steps": steps, "samp": samp,
                "stop": stop_seqs, "cid": cid, **(meta_extra or {})}
        self.slots[i] = {
            "rid": rid,
            "prefill": seat,
            "meta": meta,
            "blocks": blocks,
            "shared": shared,
            "sampling": samp is not None,
            "stop": None,
            "cid": 0,
        }
        self._update_pool_gauges()

    def _seat_plain(self, i, rid, prompt, prompt_dev, steps, adapter_id,
                    samp, stop_seqs, cid) -> bool:
        """Seat a request on a non-radix server: its blocks (plus the
        global shared prefix's), the whole prompt scheduled at
        base=prefix_len. False = the pool cannot cover it yet."""
        t0 = prompt.shape[1]
        need = self._own_need(t0, steps)
        if need > len(self.free):
            return False
        blocks = [self.free.pop() for _ in range(need)]
        self.obs.requests_admitted.inc()
        self.obs.prefill_tokens.inc(t0)
        self.obs.queue_wait.observe(
            time.perf_counter() - self._submit_t[rid]
        )
        n_shared = len(self.shared_blocks)
        table_row = np.zeros((self.MB,), np.int32)
        table_row[:n_shared] = self.shared_blocks
        table_row[n_shared : n_shared + need] = blocks
        seat = PrefillSeat(rid=rid, tokens=prompt[0].numpy(),
                           base=self.prefix_len, keep_from=0)
        self._seat_common(i, rid, prompt_dev, steps, adapter_id, samp,
                          stop_seqs, cid, seat, table_row, blocks, [])
        return True

    def _seat_radix(self, i, rid, prompt, prompt_dev, steps, adapter_id,
                    samp, stop_seqs, cid) -> bool:
        """Seat a request through the PrefixBlockCache: its hits pinned
        (refcount++) while the seat prefills, the rest allocated, and
        ONLY the non-shared suffix scheduled. Its own full prompt blocks
        register at flip time, once every row is written."""
        bs = self.bs
        t0 = prompt.shape[1]
        tokens = prompt[0].numpy()
        n_full = t0 // bs
        total = -(-(t0 + steps) // bs)
        plan = self._walk(tokens, n_full, total)
        if plan is None:
            return False
        hits, keys, toks, own = plan
        self.obs.queue_wait.observe(
            time.perf_counter() - self._submit_t[rid]
        )
        table_row = np.zeros((self.MB,), np.int32)
        table_row[:total] = hits + own
        # Reuse at most t0 - 1 cached positions: the LAST prompt token
        # runs so that its logits seed the first generated token.
        suffix_pos = min(len(hits) * bs, t0 - 1)
        self.obs.prefill_tokens.inc(t0 - suffix_pos)
        self.prefill_tokens_saved += suffix_pos
        seat = PrefillSeat(rid=rid, tokens=tokens[suffix_pos:],
                           base=suffix_pos, keep_from=len(hits) * bs)
        self._seat_common(
            i, rid, prompt_dev, steps, adapter_id, samp, stop_seqs, cid,
            seat, table_row, own, list(hits),
            {"keys": keys, "toks": toks, "n_full": n_full,
             "n_hits": len(hits)},
        )
        return True

    def _flip_seat(self, i: int, slot: dict, lrow) -> None:
        """The seat's last chunk just landed: its final logits row
        `lrow` [1, V] (the row the stall path draws from at admission)
        seeds the first generated token, and the seat becomes a decoding
        slot. A radix server publishes the request's fresh full prompt
        blocks now that every row is written."""
        meta = slot.pop("meta")
        del slot["prefill"]
        if self.radix is not None:
            fresh = []
            for j in range(meta["n_hits"], meta["n_full"]):
                if meta["keys"][j] in self.radix.by_key:
                    # A concurrent seat with the same prefix flipped
                    # first and published this key: our duplicate block
                    # stays privately owned and frees at finish.
                    continue
                fresh += self._register(self.tables[i], meta["keys"],
                                        meta["toks"], j, j + 1)
            slot["shared"] = slot["shared"] + fresh
            slot["blocks"] = [b for b in slot["blocks"] if b not in fresh]
        self._seat(i, slot["rid"], meta["prompt_dev"], meta["steps"],
                   meta["samp"], meta["stop"], self.tables[i].copy(),
                   int(self.pos[i]), lrow, slot["blocks"], slot["shared"],
                   adapter_id=int(self.adapter[i]), cid=meta["cid"])

    def _tick_mixed(self) -> None:
        """One MIXED dispatch: every live decode row advances exactly one
        token AND up to `prefill_budget` prompt tokens of the seats ride
        along, in one multi-token step (`_mt`, through
        paged_flash_prefill). It runs eagerly: its T changes from tick to
        tick (pow2 buckets). Decode rows feed their last token at pos
        with n_keep 1; seat rows their next chunk at base + done; idle
        rows keep nothing and write trash. Sampling, eos and stop apply
        to decode rows only; a seat's logits are used once, when its
        last chunk lands and it flips."""
        seats = self._seat_slots()
        decode_live = [s is not None and "prefill" not in s
                       for s in self.slots]
        limit = self.MB * self.bs
        # The gathered step writes T rows at EVERY row's position, so T
        # is bounded by the deepest live row (submit's spec headroom
        # and _prefill_paged's tail cap keep the same invariant).
        max_pos = max(int(self.pos[i]) for i, s in enumerate(self.slots)
                      if s is not None)
        chunk_cap = (self.prefill_chunk if self.prefill_chunk is not None
                     else limit)
        T, ns = plan_mixed_tick(
            [self.slots[i]["prefill"].remaining for i in seats],
            self.prefill_budget, chunk_cap, limit - max_pos,
        )
        ids_np = np.zeros((self.B, T), np.int32)
        n_keep = np.zeros((self.B,), np.int32)
        keep_from = np.zeros((self.B,), np.int32)
        posm = np.zeros((self.B,), np.int32)
        emit_idx = np.zeros((self.B,), np.int32)
        for i in range(self.B):
            if decode_live[i]:
                n_keep[i] = 1
                posm[i] = self.pos[i]
        planned: list[tuple[int, int]] = []
        total_new = 0
        for i, n in zip(seats, ns):
            if n <= 0:
                continue  # budget exhausted: the seat idles (trash)
            seat = self.slots[i]["prefill"]
            posm[i] = seat.pos
            keep_from[i] = seat.keep_from
            ids_np[i, :n] = seat.take(n)
            n_keep[i] = n
            emit_idx[i] = n - 1
            planned.append((i, n))
            total_new += n
        # Decode rows' input token is the device feed, merged on the
        # device so the host never reads it.
        ids = self._upload(ids_np)
        dec_mask = self._upload(decode_live).bool()
        ids[:, :1] = torch.where(dec_mask[:, None], self._feed, ids[:, :1])
        nb_live = min((int(posm.max()) + T - 1) // self.bs + 1, self.MB)
        logits = self._mt(self._tables_dev, self._upload(posm), ids,
                          self._upload(n_keep), self._upload(keep_from),
                          nb_live, self._adapter_dev if self.multi_lora
                          else None)
        self.mixed_ticks_n += 1
        n_live = sum(decode_live)
        self._note_dispatch(n_live)
        self.obs.mixed_prefill_tokens.inc(total_new)
        self.mixed_prefill_tokens_n += total_new
        self._account_kv_rows(self._rows_read_multi(posm, T, False),
                              self.B * self.MB * self.bs)
        # Each row's emit position: 0 for decode rows, the chunk's last
        # real token for seats (used only when the seat flips).
        ll = logits[self._rows, self._upload(emit_idx).long()]
        ll_raw = ll
        sm = self._sampler
        constrained = any(sm.row_constrained)
        if constrained:
            ll, dead, settle, mfrac = crt.constrained_pick(
                self._ctrans, self._cacc, ll, sm.cid, sm.cstate, dec_mask,
                self.eos_id,
            )
        # Seat rows never steer the draw-vs-argmax choice: their sampler
        # rows install at flip.
        if any(s is not None and "prefill" not in s and s["sampling"]
               for s in self.slots):
            nxt = sm.draw(ll)
        else:
            nxt = torch.argmax(ll, dim=-1)
        if constrained:
            nxt, state = settle(nxt)
            sm.cstate.copy_(state)
        self._feed.copy_(nxt[:, None])
        # Decode rows advance one row on the device (seats are not
        # active; a flip installs its own position).
        self._pos_dev += self._active
        need_host = (
            self.eos_id is not None
            or self.on_token is not None
            or any(s is not None and s.get("stop") is not None
                   for s in self.slots)
        )
        # One transfer of the host tokens and the dead-end flags, the
        # masked fractions (floats) in a second while constrained.
        got = iter(host_lists(([nxt] if need_host else [])
                              + ([dead] if constrained else [])))
        host_nxt = next(got) if need_host else None
        if constrained:
            dead_host = next(got)
            # analysis: ignore[host-sync-in-hot-loop] the masked fractions are
            # floats, so they follow the tick's int transfer in a second; only
            # while a constrained row is live
            mfrac_host = mfrac.tolist()
        accepted = 0
        for i, slot in enumerate(self.slots):
            if slot is None or not decode_live[i]:
                continue
            if constrained and slot["cid"]:
                if dead_host[i]:
                    self._dead_end(i, slot)
                    continue
                self.constrained_tokens_n += 1
                self.obs.constrained_tokens.inc()
                self.obs.constrain_masked_frac.observe(mfrac_host[i])
            tok = nxt[i].reshape(1, 1).to(slot["last"].dtype)
            slot["last"] = tok
            slot["toks"].append(tok)
            slot["remaining"] -= 1
            self.pos[i] += 1
            accepted += 1
            self._emit_token(i, slot,
                             host_nxt[i] if host_nxt is not None else None)
        # Seats advance after the decode drain; a seat whose last chunk
        # just landed flips to decoding this very tick.
        for i, _ in planned:
            slot = self.slots[i]
            seat = slot["prefill"]
            self.pos[i] = seat.pos
            if seat.finished:
                self._flip_seat(i, slot, ll_raw[i : i + 1])
                accepted += 1
        self.obs.tokens_per_dispatch.set(float(accepted))
        self.window_tokens += accepted

    # -- the tick ---------------------------------------------------------

    def _tick(self) -> None:
        if self.pp > 1:
            return self._tick_pp()
        if self.spec_k:
            if self.decode_window > 1:
                return self._tick_spec_window()
            return self._tick_spec()
        if self._seat_slots():
            # Mixed mode engages only while a seat is mid-prefill;
            # pure-decode stretches run the plain tick or window.
            return self._tick_mixed()
        if self.decode_window > 1:
            return self._tick_window()
        live = [s is not None for s in self.slots]
        if not any(live):
            return
        posm = np.where(live, self.pos, 0)
        nb_live = int(posm.max()) // self.bs + 1
        logits = self._step(nb_live)
        n_live = sum(live)
        self._note_dispatch(n_live)
        self.obs.tokens_per_dispatch.set(float(n_live))
        self.window_tokens += n_live
        # K/V rows the attention path read this tick vs the gathered
        # baseline.
        self._account_kv_rows(self._rows_read_decode(posm),
                              self.B * self.MB * self.bs)
        ll = logits[:, -1, :]
        sm = self._sampler
        # Constrained rows: the DFA mask folds into the logits before the
        # argmax or draw and the states advance after, guarded by the
        # host mirror (unconstrained serving runs the ops it always ran).
        # A dead end (hand-built DFAs only) is forced to eos; the loop
        # below drops the forced token and records the error.
        constrained = any(sm.row_constrained)
        if constrained:
            ll, dead, settle, mfrac = crt.constrained_pick(
                self._ctrans, self._cacc, ll, sm.cid, sm.cstate,
                self._active != 0, self.eos_id,
            )
        if any(s is not None and s["sampling"] for s in self.slots):
            nxt = sm.draw(ll)
        else:
            nxt = torch.argmax(ll, dim=-1)
        if constrained:
            nxt, state = settle(nxt)
            sm.cstate.copy_(state)
        self._feed.copy_(nxt[:, None])
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
        # One transfer of the host tokens and, only while a constrained
        # row is live, the dead-end flags; the masked fractions (floats)
        # in a second.
        got = iter(host_lists(([nxt] if need_host else [])
                              + ([dead] if constrained else [])))
        host_nxt = next(got) if need_host else None
        if constrained:
            dead_host = next(got)
            # analysis: ignore[host-sync-in-hot-loop] the masked fractions are
            # floats, so they follow the tick's int transfer in a second; only
            # while a constrained row is live
            mfrac_host = mfrac.tolist()
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            if constrained and slot["cid"]:
                if dead_host[i]:
                    self._dead_end(i, slot)
                    continue
                self.constrained_tokens_n += 1
                self.obs.constrained_tokens.inc()
                self.obs.constrain_masked_frac.observe(mfrac_host[i])
            tok = nxt[i].reshape(1, 1).to(slot["last"].dtype)
            slot["last"] = tok
            slot["toks"].append(tok)
            slot["remaining"] -= 1
            self.pos[i] += 1
            self._emit_token(i, slot,
                             host_nxt[i] if host_nxt is not None else None)

    def _dead_end(self, i: int, slot: dict) -> None:
        """A constrained row reached a DFA state that admits nothing: the
        forced eos never enters the output, the request ends at its last
        admissible token with an error, not a hang."""
        self.errors[slot["rid"]] = _DEAD_END
        self.constraint_dead_ends_n += 1
        self.obs.constrain_dead_ends.inc()
        slot["remaining"] = 0
        self._finish(i)

    # -- decode windows -----------------------------------------------------

    def _window_state(self) -> dict:
        """The windows' static buffers, made once: each row's budget
        (uploaded before each window) and token count, the alive mask
        the window freezes in place, the [B, K] tokens, the [K, B, V]
        uniforms, and the constrained outputs (dead-end flags, [B, K]
        masked fractions). A speculative window adds its round inputs
        and per-round outputs (`_spec_state`)."""
        if self._wbuf is None:
            B, K, dev = self.B, self.decode_window, self.device
            V = self.dec.cfg.vocab_size
            self._wbuf = {
                "budget": torch.zeros((B,), dtype=torch.int32, device=dev),
                "n": torch.zeros((B,), dtype=torch.int32, device=dev),
                "alive": torch.zeros((B,), dtype=torch.bool, device=dev),
                "toks": torch.zeros((B, K), dtype=torch.int64, device=dev),
                "u": torch.full((K, B, V), 0.5, device=dev),
                "died": torch.zeros((B,), dtype=torch.bool, device=dev),
                "fracs": torch.zeros((B, K), device=dev),
            }
        return self._wbuf

    def _window_body(self, mode: str, constrained: bool):
        """The K sub-steps of one paged window over the static buffers,
        in place: a closure the CPU runs eagerly and a CUDA server
        captures. The alive mask starts as the slots' active mask; each
        sub-step zeroes frozen rows' position and table row (their writes
        land in trash block 0 row 0, the idle-slot invariant), runs the
        T=1 paged step, folds the constraint (constrained windows), draws
        in `mode`, counts the token against the row's budget, and freezes
        rows that hit eos or their budget for the rest of the window.
        Live rows' positions advance on the device."""
        K, eos, mb = self.decode_window, self.eos_id, self.MB
        w = self._window_state()
        sm = self._sampler
        tables, pos, feed = self._tables_dev, self._pos_dev, self._feed
        alive, n = w["alive"], w["n"]

        def body():
            n.zero_()
            alive.copy_(self._active != 0)
            if constrained:
                w["died"].zero_()
            for s in range(K):
                pos_eff = torch.where(alive, pos, 0)
                tab_eff = torch.where(alive[:, None], tables, 0)
                ll = self._decode(tab_eff, pos_eff, feed, mb)[:, -1, :]
                if constrained:
                    ll, dead, settle, frac = crt.constrained_pick(
                        self._ctrans, self._cacc, ll, sm.cid, sm.cstate,
                        alive, eos,
                    )
                nxt = self._pick(mode, ll, w["u"][s])
                if constrained:
                    nxt, state = settle(nxt)
                    sm.cstate.copy_(state)
                    w["fracs"][:, s].copy_(frac)
                    w["died"].logical_or_(dead)
                adv = alive.to(torch.int32)
                pos.add_(adv)
                n.add_(adv)
                still = alive & (n < w["budget"])
                if eos is not None:
                    still &= nxt != eos
                alive.copy_(still)
                feed.copy_(nxt[:, None])
                w["toks"][:, s].copy_(nxt)

        return body

    def _pick(self, mode: str, ll, u, rows=None):
        """One batched token choice in a window's mode: the argmax, or
        the sampler's draw (with or without the sorting filters) from the
        uniforms `u` [B, V] drawn before the replay. `rows` (a pipelined
        window's microbatch group) selects the sampler rows of `ll`'s."""
        sm = self._sampler
        if mode == "argmax":
            return torch.argmax(ll, dim=-1)
        pol = [sm.temp, sm.topk, sm.topp, sm.minp]
        if rows is not None:
            pol = [v[rows] for v in pol]
        temp, topk, topp, minp = pol
        if mode == "nosort":
            return sample_token_batched_nosort_u(ll, u, temp, minp)
        return sample_token_batched_u(ll, u, temp, topk, topp, minp)

    def _window_program(self, kind: str, mode: str, constrained: bool):
        """A window of `kind` ("decode" or "spec") for (mode,
        constrained): the eager body on a CPU server; on a CUDA server
        its CUDA graph, captured once and kept on this server (bound to
        its buffers, it is freed with them) together with the body, whose
        closure owns tensors the graph reads (a freed one's memory would
        be reused under the graph). A capture that fails raises."""
        build = (self._window_body if kind == "decode"
                 else self._spec_window_body)
        if not self._window_captured(kind):
            return build(mode, constrained)
        key = (kind, mode, constrained)
        if key not in self._graphs:
            body = build(mode, constrained)
            self._graphs[key] = (self._capture(body, kind), body)
            self.graph_captures += 1
        return self._graphs[key][0].replay

    def _window_captured(self, kind: str) -> bool:
        """Whether windows of `kind` replay a captured graph: on a
        capturing server, except a speculative window over a process
        group, whose draft runs on the controller alone."""
        return self._captures and (kind == "decode" or self._link is None)

    def _window_buffers(self) -> dict:
        """The buffers a decode window reads that the controller writes
        between windows, by name."""
        sm, w = self._sampler, self._window_state()
        return {"tables": self._tables_dev, "pos": self._pos_dev,
                "feed": self._feed, "active": self._active,
                "budget": w["budget"], "u": w["u"], "temp": sm.temp,
                "topk": sm.topk, "topp": sm.topp, "minp": sm.minp,
                "cid": sm.cid, "cstate": sm.cstate,
                "adapter": self._adapter_dev}

    def _window_inputs(self, mode: str, constrained: bool) -> dict:
        """Those of the buffers a (mode, constrained) window reads, for
        the other ranks to copy in before their replay: the tables,
        positions, feed, active mask and budgets; the sampling policy and
        uniforms of a sampled window, the constraint rows of a
        constrained one, and the adapter ids with adapter banks."""
        names = ["tables", "pos", "feed", "active", "budget"]
        if mode != "argmax":
            names += ["u", "temp", "topk", "topp", "minp"]
        if constrained:
            names += ["cid", "cstate"]
        if self.multi_lora:
            names.append("adapter")
        own = self._window_buffers()
        return {name: own[name] for name in names}

    @_program
    def _window_run(self, mode: str, constrained: bool, inputs: dict) -> None:
        """One captured decode window on every rank of a process group:
        the other ranks copy the controller's `inputs` into their own
        buffers (the controller's are the inputs), then each rank
        replays its own graph of (mode, constrained), capturing it on
        first use (the capture's warm-up runs the window's collectives
        on every rank together)."""
        if not self.controller:
            own = self._window_buffers()
            for name, t in inputs.items():
                own[name].copy_(t)
        self._window_program("decode", mode, constrained)()
        self.graph_replays += 1

    def _capture(self, body, kind: str):
        """Warm the body up, then capture it. The warm-up (the kernels'
        launch plans and cluster fits, which query the card, and lazy
        library setup) runs the body with every row inactive: the target
        pool's writes then land in trash block 0, and every other state
        it writes (positions, the feed, the DFA states, and a speculative
        window's draft-lane rows 0..k+1 and round inputs) is saved
        before and restored after, so it changes nothing the server
        holds."""
        sm = self._sampler
        dev = self.device

        def warm_up():
            state = [self._pos_dev, self._feed, self._active, sm.cstate]
            if kind == "spec":
                sw = self._spec_state()
                state += [sw[k] for k in ("pos", "dpos", "feed2", "adv",
                                          "alive", "samp")]
                head = self.spec_k + 2
                state += [self._draft.ck[:, :, :, :head],
                          self._draft.cv[:, :, :, :head]]
            saved = [t.clone() for t in state]
            self._active.zero_()
            if kind == "spec":
                sw["alive"].zero_()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), torch.no_grad():
                body()
            torch.cuda.current_stream(dev).wait_stream(side)
            for t, old in zip(state, saved):
                t.copy_(old)

        return capture_graph(body, dev, warm_up)

    def _tick_window(self) -> None:
        """One dispatch of up to decode_window tokens per live slot; one
        batched host transfer drains the [B, K] token buffer (plus the
        per-slot valid-length and alive vectors when eos is set)."""
        live = [s is not None for s in self.slots]
        if not any(live):
            return
        K = self.decode_window
        sm = self._sampler
        sampling = any(s is not None and s["sampling"] for s in self.slots)
        mode = sm.window_mode(sampling)
        constrained = any(sm.row_constrained)
        budget = [s["remaining"] if s is not None else 0
                  for s in self.slots]
        posm = np.where(live, self.pos, 0)
        w = self._window_state()
        w["budget"].copy_(self._upload(budget))
        if mode != "argmax":
            sm.fill_uniforms(w["u"])
        if self._captures and self._link is not None:
            # One program a window through the seam; every rank replays.
            self._window_run(mode, constrained,
                             self._window_inputs(mode, constrained))
        else:
            self._window_program("decode", mode, constrained)()
            if self._captures:
                self.graph_replays += 1
        if self._captures:
            self._account_psums(K)
        toks = w["toks"].clone()  # the next window overwrites the buffer
        self._note_dispatch(sum(live))
        need_toks = self.on_token is not None or any(
            s is not None and s["stop"] is not None for s in self.slots
        )
        # ONE batched per-window transfer (K tokens amortize it) of what
        # the host needs: the valid lengths and alive flags when eos can
        # freeze a row (without eos the device freezes rows on budget
        # alone, which the host already knows), the [B, K] tokens when
        # they stream or stop-match, the dead-end flags of a constrained
        # window; its masked fractions, floats, follow in a second.
        eos = self.eos_id is not None
        wanted = ([w["n"], w["alive"]] if eos else []) + (
            [toks] if need_toks else []) + ([w["died"]] if constrained
                                            else [])
        got = iter(host_lists(wanted))
        if eos:
            emitted, alive_host = next(got), next(got)
        else:
            emitted = [min(b, K) for b in budget]
            alive_host = [b > K for b in budget]
        toks_host = next(got) if need_toks else None
        died_host = next(got) if constrained else None
        # analysis: ignore[host-sync-in-hot-loop] the window's masked
        # fractions (floats) after its one int transfer; only in a constrained
        # window
        fracs_host = w["fracs"].tolist() if constrained else None
        self._account_kv_rows_window(posm, emitted)
        self._drain_window(toks, toks_host, emitted, alive_host, budget,
                           died_host, fracs_host)

    # -- pipeline-parallel windows (pp_stages > 1) ----------------------------

    @_program
    def _pp_chain(self, tables, pos, xin, n_keep, keep_from, adapter):
        """One microbatch through every stage in turn, each stage
        dispatch counted; returns the last stage's logits. Over a pp x
        tp process group every rank runs it: the ranks of a stage run
        their shard of it, and each boundary hops along the stage axis
        (`_stage_hop`), the logits from the last stage back to stage 0,
        where the controller reads them."""
        ranks = bool(self._pp_submeshes) and self.mesh.distributed
        if ranks:
            axis = self.pp_stage_axis
            line = (self.mesh.group(axis), self.pp, self.mesh.coords[axis])
            b, t = xin.shape[:2]
            cfg = self.dec.cfg
        x = xin
        for s, stage in enumerate(self._pp_stage_objs):
            if not isinstance(stage, _PPRankStage):
                x = stage.pp_dispatch(tables, pos, x, n_keep, keep_from,
                                      adapter)
            if ranks:
                last = s == self.pp - 1
                shape, dtype = (((b, t, cfg.vocab_size), torch.float32)
                                if last else
                                ((b, t, cfg.dim), self.dec.compute_dtype))
                x = _stage_hop(x, shape, dtype, *line, s,
                               0 if last else s + 1, self.device)
            self.pp_stage_dispatch_n[s] += 1
            self.obs.pp_stage_dispatches[s].inc()
        return x

    def _tick_pp(self) -> None:
        """One PIPELINED decode window: decode_window rounds for each of
        the M in-flight microbatch slot groups, chained through the S
        stages round-major (the GPipe schedule). Each (round, group)
        chain is the window sub-step of `_window_body` with the paged
        step split over the stages: frozen rows at position 0 with an
        all-trash table, the same pick, the same budget and eos freeze,
        so greedy output is token-identical to pp_stages=1. Local stages'
        dispatches queue on their devices without a host sync, so the
        chains of different groups overlap where the stages sit on
        different cards.

        Occupancy is measured at the schedule level, independent of
        placement: dispatch (round k, group g) enters stage s at slot
        k * M_live + g + s, each stage is busy for `chains` of the span's
        `chains + S - 1` slots, and the bubble fraction published a
        window is 1 - the mean occupancy, (S-1)/(K*M_live + S-1), with
        groups that have no live slot at the window boundary skipped."""
        live = [s is not None for s in self.slots]
        if not any(live):
            return
        K, S, dev = self.decode_window, self.pp, self.device
        sm = self._sampler
        mode = sm.window_mode(any(s is not None and s["sampling"]
                                  for s in self.slots))
        budget = [s["remaining"] if s is not None else 0
                  for s in self.slots]
        posm = np.where(live, self.pos, 0).astype(np.int32)
        u = None
        if mode != "argmax":
            u = torch.full((K, self.B, self.dec.cfg.vocab_size), 0.5,
                           device=dev)
            sm.fill_uniforms(u)
        bg = len(self._pp_groups[0])
        i32 = dict(dtype=torch.int32, device=dev)
        nk1 = torch.ones((bg,), **i32)
        kf0 = torch.zeros((bg,), **i32)
        st: list[dict | None] = []
        for idx in self._pp_groups:
            if not any(live[i] for i in idx):
                st.append(None)
                continue
            ia = torch.tensor(idx, device=dev)
            active = self._upload([live[i] for i in idx]).bool()
            tables = self._tables_dev[ia]
            pos = self._upload(posm[idx])
            st.append({
                "idx": idx, "ia": ia, "tables": tables, "pos": pos,
                "active": active, "n": torch.zeros((bg,), **i32),
                "budget": self._upload([budget[i] for i in idx]),
                "feed": self._feed[ia],
                "tab_eff": torch.where(active[:, None], tables, 0),
                "pos_eff": torch.where(active, pos, 0), "toks": [],
            })
        chains = 0
        for k in range(K):
            for state in st:
                if state is None:
                    continue
                ll = self._pp_chain(state["tab_eff"], state["pos_eff"],
                                    state["feed"], nk1, kf0, kf0)
                chains += 1
                nxt = self._pick(mode, ll[:, -1, :].to(dev),
                                 None if u is None else u[k][state["ia"]],
                                 state["ia"])
                adv = state["active"].to(torch.int32)
                pos = state["pos"] + adv
                n = state["n"] + adv
                alive = state["active"] & (n < state["budget"])
                if self.eos_id is not None:
                    alive &= nxt != self.eos_id
                state.update(
                    pos=pos, n=n, active=alive,
                    feed=nxt[:, None].to(torch.int32),
                    pos_eff=torch.where(alive, pos, 0),
                    tab_eff=torch.where(alive[:, None], state["tables"], 0),
                )
                state["toks"].append(nxt)
        toks = torch.zeros((self.B, K), dtype=torch.int64, device=dev)
        for state in st:
            if state is not None:
                ia = state["ia"]
                self._feed[ia] = state["feed"]
                self._pos_dev[ia] = state["pos"]
                toks[ia] = torch.stack(state["toks"], dim=1).long()
        self._note_dispatch(sum(live))
        # Every chain is one whole forward spread over the stages.
        self._account_psums(chains)
        occ, bubble = pp_schedule_occupancy([chains] * S, chains + S - 1)
        self.pp_occupancy_last = occ
        self.pp_bubble_last = bubble
        self.obs.pp_bubble_fraction.set(bubble)
        for s, o in enumerate(occ):
            self.obs.pp_stage_occupancy[s].set(o)
        need_toks = self.on_token is not None or any(
            s is not None and s["stop"] is not None for s in self.slots
        )
        # One batched per-window transfer, as _tick_window's: each
        # group's valid lengths and alive flags when eos is set, the
        # tokens when they stream or stop-match.
        eos = self.eos_id is not None
        ran = [state for state in st if state is not None] if eos else []
        wanted = [t for state in ran for t in (state["n"], state["active"])]
        wanted += [toks] if need_toks else []
        got = iter(host_lists(wanted))
        if eos:
            emitted, alive_host = [0] * self.B, [False] * self.B
            for state in ran:
                for i, e, a in zip(state["idx"], next(got), next(got)):
                    emitted[i], alive_host[i] = e, a
        else:
            emitted = [min(b, K) for b in budget]
            alive_host = [b > K for b in budget]
        toks_host = next(got) if need_toks else None
        self._account_kv_rows_window(posm, emitted)
        self._drain_window(toks, toks_host, emitted, alive_host, budget)

    def close_pp(self) -> None:
        """Release the stage chain: transport stages send their STOP
        frame, so remote workers' serve loops exit (local stages hold
        nothing to release)."""
        for stage in self._pp_stage_objs:
            stage.close()

    def _drain_window(self, toks, toks_host, emitted, alive_host, budget,
                      died_host=None, fracs_host=None) -> None:
        """Host-side window drain, per-token-equivalent to the K=1 tick
        loop: stop sequences truncate the window's overshoot, budgets
        and finishes mirror the per-token bookkeeping, streaming fires in
        tick-major order (batching.window_drain_order), and block
        release (`_finish`) happens at the window boundary."""
        K = self.decode_window
        accepted = [0] * self.B
        finishing = [False] * self.B
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            n_i = emitted[i]
            a_i = n_i
            stopped = False
            dead = bool(died_host is not None and died_host[i]
                        and slot["cid"])
            if dead:
                # A dead end froze the row with a forced eos (counted in
                # n_i): drop it, so the output ends at the last
                # admissible token and the failure surfaces as an error.
                a_i = n_i - 1
            if slot["stop"] is not None:
                hit = slot["stop"].push_window(toks_host[i][:a_i])
                if hit is not None:
                    a_i, stopped = hit, True
            accepted[i] = a_i
            if a_i < min(budget[i], K):
                self.obs.window_truncated.inc()
            slot["remaining"] -= a_i
            if stopped or not alive_host[i]:
                # eos froze the row on the device, a stop sequence cut it
                # on drain, or its budget ran out mid-window.
                slot["remaining"] = 0
            if dead:
                slot["remaining"] = 0
                self.errors[slot["rid"]] = _DEAD_END
                self.constraint_dead_ends_n += 1
                self.obs.constrain_dead_ends.inc()
            if slot["cid"] and fracs_host is not None:
                self.constrained_tokens_n += a_i
                if a_i:
                    self.obs.constrained_tokens.inc(a_i)
                for fr in fracs_host[i][:a_i]:
                    self.obs.constrain_masked_frac.observe(fr)
            if a_i:
                tok_block = toks[i, :a_i][None, :].to(slot["last"].dtype)
                slot["toks"].append(tok_block)
                slot["last"] = tok_block[:, -1:]
            self.pos[i] += a_i
            finishing[i] = slot["remaining"] == 0
            self.obs.tokens_generated.inc(a_i)
            self.window_tokens += a_i
        self.obs.tokens_per_dispatch.set(float(sum(accepted)))
        if self.on_token is not None:
            for t, i in window_drain_order(accepted, K):
                slot = self.slots[i]
                self.on_token(slot["rid"], toks_host[i][t],
                              finishing[i] and t == accepted[i] - 1)
        for i in range(self.B):
            if finishing[i]:
                self._finish(i)

    # -- speculative decoding (spec_k > 0) -----------------------------------

    def _draft_seeds(self):
        """Round-0 draft inputs from host truth: per greedy slot its
        pending tokens (emitted, not yet in its draft lane: 1 after a
        partial accept, 2 after a full one; a lone token is fed twice),
        their count, and the lane's write head pos + 1 - len(pend).
        Idle and sampled rows stay 0, the idle-lane idiom."""
        feed2 = np.zeros((self.B, 2), np.int32)
        adv = np.zeros((self.B,), np.int32)
        dposm = np.zeros((self.B,), np.int32)
        for i, slot in enumerate(self.slots):
            if slot is None or slot["sampling"]:
                continue
            pend = slot["pend"]
            adv[i] = len(pend)
            feed2[i, 0] = pend[0]
            feed2[i, 1] = pend[-1]
            dposm[i] = self.pos[i] + 1 - len(pend)
        return feed2, adv, dposm

    def _constrained_preds(self, logits, props, k, active=None):
        """The target's constrained greedy walk of one round: position
        j's pred is the masked argmax at state s_j, where s_{j+1} =
        trans[s_j, props_j] follows the PROPOSAL chain, so the accept
        test stops at the first proposal the target's mask rejects and
        the output is the spec_k=0 constrained chain. A dead state makes
        pred -1 (never accepted). Device ops only. Returns (preds
        [B, k+1], crow0, cmask0, post-states [B, k+1] (the state after
        committing pred_j), dead [B, k+1], masked fractions [B, k+1]);
        `active` masks the fractions (a window's frozen rows)."""
        sm = self._sampler
        cvec = sm.cid > 0
        live = cvec if active is None else cvec & active
        s = sm.cstate
        preds, posts, deads, fracs = [], [], [], []
        crow0 = cmask0 = None
        for j in range(k + 1):
            crow, acc = crt.constrain_rows(self._ctrans, self._cacc, sm.cid, s)
            cmask = crt.constrain_mask(crow, acc, self.eos_id)
            if j == 0:
                crow0, cmask0 = crow, cmask
            dead_j = cvec & ~cmask.any(-1)
            p = torch.argmax(crt.fold_mask(logits[:, j, :], cmask), dim=-1)
            p = torch.where(dead_j, -1, p.to(torch.int32))
            preds.append(p)
            posts.append(crt.advance_state(crow, s, p.clamp(min=0),
                                           cvec & ~dead_j))
            deads.append(dead_j)
            fracs.append(crt.masked_frac(cmask, live))
            if j < k:
                s = crt.advance_state(crow, s, props[:, j], cvec)
        return (torch.stack(preds, 1), crow0, cmask0, torch.stack(posts, 1),
                torch.stack(deads, 1), torch.stack(fracs, 1))

    def _propose(self, k, dpos, feed2, adv, constrained):
        """The draft's k proposals [B, k] int32 from device round inputs:
        the constrained twin while a constrained row is live."""
        sm = self._sampler
        if constrained:
            return self._draft.propose_c_dev(
                k, dpos, feed2, adv, self.eos_id, sm.cid, sm.cstate,
                self._ctrans, self._cacc,
            )
        return self._draft.propose_dev(k, dpos, feed2, adv)

    def _tick_spec(self) -> None:
        """One speculative round: the draft proposes k greedy tokens for
        every greedy slot (`DraftLanes`), the target verifies all k + 1
        positions in ONE multi-token step (`_mt`, through
        paged_flash_prefill, T = k + 1) whose candidate rows land in the
        slots' blocks in the same call (sampled slots keep row 0 only,
        idle slots none), and one batched transfer feeds the accept test
        (batching.accept_lengths): slot i emits props[:a] and the
        target's own token at the first mismatch (or the bonus row), so
        the greedy chain is the target's, token for token. Rejected rows
        sit stale behind the position mask until the next round rewrites
        them. Sampled slots advance one token a round, drawn from the
        verify's row 0."""
        live = [s is not None for s in self.slots]
        if not any(live):
            return
        k = self.spec_k
        feed2, adv, dposm = self._draft_seeds()
        sm = self._sampler
        constrained = any(sm.row_constrained)
        props = self._propose(k, self._upload(dposm), self._upload(feed2),
                              self._upload(adv), constrained)
        verify_in = torch.cat([self._feed, props], dim=1)
        n_keep = np.zeros((self.B,), np.int32)
        for i, slot in enumerate(self.slots):
            if slot is not None:
                n_keep[i] = 1 if slot["sampling"] else k + 1
        posm = np.where(live, self.pos, 0).astype(np.int32)
        nb_live = min((int(posm.max()) + k) // self.bs + 1, self.MB)
        logits = self._mt(self._tables_dev, self._upload(posm), verify_in,
                          self._upload(n_keep),
                          torch.zeros_like(self._pos_dev), nb_live)
        if constrained:
            (preds, crow0, cmask0, post_states, dead_all,
             fracs) = self._constrained_preds(logits, props, k)
        else:
            preds = torch.argmax(logits, dim=-1).to(torch.int32)
        draw = None
        if any(s is not None and s["sampling"] for s in self.slots):
            ll0 = logits[:, 0, :]
            if constrained:
                ll0 = crt.fold_mask(ll0, cmask0)
            draw = sm.draw(ll0)
        n_live = sum(live)
        self._note_dispatch(n_live, 2, stall=False)
        self._account_kv_rows(self._rows_read_multi(posm, k + 1, True),
                              self.B * self.MB * self.bs)
        # The ONE batched transfer of the round (the masked fractions,
        # floats, in a second while constrained).
        got = iter(host_lists([preds, props]
                               + ([draw] if draw is not None else [])
                               + ([dead_all] if constrained else [])))
        preds_host, props_host = np.asarray(next(got)), np.asarray(next(got))
        draw_host = next(got) if draw is not None else None
        if constrained:
            dead_host = next(got)
            # analysis: ignore[host-sync-in-hot-loop] the round's masked
            # fractions (floats) after its one int transfer; only while
            # constrained
            fracs_host = fracs.tolist()
        a_vec = accept_lengths(props_host, preds_host[:, :k])
        proposed = accepted_draft = draft_toks = 0
        accepted = [0] * self.B
        finishing = [False] * self.B
        toks_host: list = [None] * self.B
        feedv = np.zeros((self.B,), np.int32)
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            dead_i = False
            if slot["sampling"]:
                emitted = [int(draw_host[i])]
                if constrained and slot["cid"] and dead_host[i][0]:
                    dead_i, emitted = True, []
            else:
                a = int(a_vec[i])
                proposed += k
                accepted_draft += a
                draft_toks += int(adv[i]) + k - 1
                self.obs.spec_acceptance.observe(a)
                emitted = [int(t) for t in props_host[i, :a]]
                emitted.append(int(preds_host[i, a]))
                if constrained and slot["cid"] and dead_host[i][a]:
                    # The correction hit a dead DFA state: its pred is
                    # the -1 sentinel, dropped here with an error.
                    dead_i = True
                    emitted = emitted[:-1]
            kept, stopped = self._keep(slot, emitted)
            if kept < len(emitted):
                self.obs.window_truncated.inc()
            slot["remaining"] -= kept
            if stopped:
                slot["remaining"] = 0
            if dead_i and kept == len(emitted) and not stopped:
                slot["remaining"] = 0
                self.errors[slot["rid"]] = _DEAD_END
                self.constraint_dead_ends_n += 1
                self.obs.constrain_dead_ends.inc()
            if constrained and slot["cid"]:
                self.constrained_tokens_n += kept
                if kept:
                    self.obs.constrained_tokens.inc(kept)
                for j in range(kept):
                    self.obs.constrain_masked_frac.observe(fracs_host[i][j])
            self._append_tokens(slot, emitted[:kept])
            self.pos[i] += kept
            accepted[i] = kept
            toks_host[i] = emitted[:kept]
            finishing[i] = slot["remaining"] == 0
            self.obs.tokens_generated.inc(kept)
            self.window_tokens += kept
            feedv[i] = emitted[-1] if emitted else 0
            if not slot["sampling"] and not finishing[i]:
                # kept == a + 1 here (a truncation finishes the slot):
                # a partial accept leaves the correction token pending,
                # a full one also the never-consumed k-th proposal.
                if a < k:
                    slot["pend"] = [emitted[-1]]
                else:
                    slot["pend"] = [int(props_host[i, k - 1]), emitted[-1]]
                self._draft.pos[i] = self.pos[i] + 1 - len(slot["pend"])
        if constrained:
            # Commit DFA states for rows continuing past the round:
            # greedy rows take the post-state at their accept length,
            # sampled rows advance one step by their draw.
            sel = np.zeros((self.B,), np.int32)
            use_post = np.zeros((self.B,), bool)
            use_draw = np.zeros((self.B,), bool)
            for i, slot in enumerate(self.slots):
                if slot is None or not slot["cid"] or finishing[i]:
                    continue
                if slot["sampling"]:
                    use_draw[i] = True
                else:
                    use_post[i] = True
                    sel[i] = int(a_vec[i])
            new_c = post_states.gather(1, self._upload(sel).long()[:, None])
            cst = torch.where(self._upload(use_post).bool(), new_c[:, 0],
                              sm.cstate)
            if draw is not None:
                cst = crt.advance_state(crow0, cst, draw,
                                        self._upload(use_draw).bool())
            sm.cstate.copy_(cst)
        self._feed.copy_(self._upload(feedv[:, None]))
        self._note_spec(1, proposed, accepted_draft, draft_toks)
        # Mean per-dispatch yield: a round is two dispatches.
        self.obs.tokens_per_dispatch.set(float(sum(accepted)) / 2.0)
        if self.on_token is not None:
            for t, i in window_drain_order(accepted, k + 1):
                slot = self.slots[i]
                self.on_token(slot["rid"], toks_host[i][t],
                              finishing[i] and t == accepted[i] - 1)
        for i in range(self.B):
            if finishing[i]:
                self._finish(i)

    def _keep(self, slot: dict, emitted: list) -> tuple[int, bool]:
        """The per-token drain of a round, K=1-equivalent: budget, then
        eos, then stop; the first terminator wins and what follows it is
        discarded. Returns (tokens kept, whether eos or a stop ended the
        request)."""
        kept = 0
        for tok in emitted:
            if kept >= slot["remaining"]:
                break
            kept += 1
            if self.eos_id is not None and tok == self.eos_id:
                return kept, True
            if slot["stop"] is not None and slot["stop"].push(tok):
                return kept, True
        return kept, False

    def _append_tokens(self, slot: dict, toks: list) -> None:
        """Append host tokens to a slot's output (uploaded, no fetch)."""
        if not toks:
            return
        block = self._upload([toks]).to(slot["last"].dtype)
        slot["toks"].append(block)
        slot["last"] = block[:, -1:]

    def _note_spec(self, rounds, proposed, accepted, draft_toks) -> None:
        self.spec_rounds_n += rounds
        self.spec_proposed_n += proposed
        self.spec_accepted_n += accepted
        self.spec_draft_tokens_n += draft_toks
        self.obs.spec_rounds.inc(rounds)
        if proposed:
            self.obs.spec_proposed.inc(proposed)
        if accepted:
            self.obs.spec_accepted.inc(accepted)
        if draft_toks:
            self.obs.spec_draft_tokens.inc(draft_toks)

    def _spec_state(self) -> dict:
        """A speculative window's static buffers beside `_window_state`'s
        (budget, n, alive, uniforms): the round inputs written before
        each replay (positions, draft write heads, pending tokens and
        their counts, the sampled rows) and the [W, B, ...] per-round
        outputs the drain reads."""
        w = self._window_state()
        if "dpos" not in w:
            B, W, k, dev = self.B, self.decode_window, self.spec_k, self.device
            i32 = dict(dtype=torch.int32, device=dev)
            w.update(
                pos=torch.zeros((B,), **i32),
                dpos=torch.zeros((B,), **i32),
                feed2=torch.zeros((B, 2), **i32),
                adv=torch.zeros((B,), **i32),
                samp=torch.zeros((B,), dtype=torch.bool, device=dev),
                zero=torch.zeros((B,), **i32),
                rtoks=torch.zeros((W, B, k + 1), **i32),
                kept=torch.zeros((W, B), **i32),
                a=torch.zeros((W, B), **i32),
                greedy=torch.zeros((W, B), dtype=torch.bool, device=dev),
                advu=torch.zeros((W, B), **i32),
                rfracs=torch.zeros((W, B, k + 1), device=dev),
            )
        return w

    def _spec_window_body(self, mode: str, constrained: bool):
        """W = decode_window whole speculative rounds over the static
        buffers, in place: a closure the CPU runs eagerly and a CUDA
        server captures. Each round: the draft proposes (frozen, idle
        and sampled lanes pinned to position 0 with nothing pending),
        the target verifies the k + 1 candidates in one `_mt` step (a
        frozen row keeps nothing, at position 0 with an all-trash
        table), the accept test runs on the device (first
        proposal/prediction mismatch, then the bonus row; a constrained
        round walks the target's masked predictions along the proposals,
        a dead state forcing an eos that freezes the row), sampled rows
        draw one token from row 0, eos and budgets freeze rows as in a
        decode window, and the pending-token recurrence of `_tick_spec`
        runs on the device between rounds."""
        k, W, eos, mb = self.spec_k, self.decode_window, self.eos_id, self.MB
        w = self._spec_state()
        sm = self._sampler
        tables, feed = self._tables_dev, self._feed
        pos, dpos, feed2, adv = w["pos"], w["dpos"], w["feed2"], w["adv"]
        alive, samp, n, budget = w["alive"], w["samp"], w["n"], w["budget"]
        dev = self.device
        steps = torch.arange(k + 1, device=dev)

        def body():
            n.zero_()
            if constrained:
                w["died"].zero_()
            for r in range(W):
                greedy = alive & ~samp
                dpos_eff = torch.where(greedy, dpos, 0)
                adv_eff = torch.where(greedy, adv, 0)
                props = self._propose(k, dpos_eff, feed2, adv_eff,
                                      constrained)
                verify_in = torch.cat([feed, props], dim=1)
                n_keep = torch.where(
                    alive, torch.where(samp, 1, k + 1), 0
                ).to(torch.int32)
                pos_eff = torch.where(alive, pos, 0)
                tab_eff = torch.where(alive[:, None], tables, 0)
                logits = self._mt(tab_eff, pos_eff, verify_in, n_keep,
                                  w["zero"], mb)
                if constrained:
                    (preds, crow0, cmask0, postm, deadm,
                     fracm) = self._constrained_preds(logits, props, k,
                                                      alive)
                else:
                    preds = torch.argmax(logits, dim=-1).to(torch.int32)
                mismatch = props != preds[:, :k]
                a = torch.where(
                    mismatch.any(dim=1),
                    torch.argmax(mismatch.to(torch.int32), dim=1), k,
                ).to(torch.int32)
                bonus = preds.gather(1, a.long()[:, None])[:, 0]
                if constrained:
                    dead_at = deadm.gather(1, a.long()[:, None])[:, 0]
                    # The -1 sentinel never enters the stream: a dead
                    # correction becomes a forced eos that freezes the
                    # row; the drain drops it.
                    bonus = torch.where(dead_at, eos, bonus)
                props_pad = torch.cat(
                    [props, torch.zeros_like(props[:, :1])], dim=1)
                toks = torch.where(steps[None, :] < a[:, None], props_pad,
                                   bonus[:, None])
                ll = logits[:, 0, :]
                if constrained:
                    ll = crt.fold_mask(ll, cmask0)
                nxt = self._pick(mode, ll, w["u"][r]).to(torch.int32)
                if constrained:
                    nxt = torch.where(deadm[:, 0], eos, nxt)
                toks = torch.where(samp[:, None], nxt[:, None], toks)
                cand = torch.where(alive, torch.where(samp, 1, a + 1), 0)
                kept = torch.minimum(cand, (budget - n).clamp(min=0))
                still = alive.clone()
                if eos is not None:
                    hit = (toks == eos) & (steps[None, :] < kept[:, None])
                    any_eos = hit.any(dim=1)
                    kept = torch.where(
                        any_eos,
                        torch.argmax(hit.to(torch.int32), dim=1) + 1, kept,
                    ).to(torch.int32)
                    still &= ~any_eos
                if constrained:
                    # Died only when the forced eos made the kept prefix
                    # (an earlier natural eos or a budget cut ends the
                    # row without the error).
                    fpos = torch.where(samp, 0, a)
                    died_now = torch.where(samp, deadm[:, 0], dead_at)
                    died_now = died_now & alive & (kept == fpos + 1)
                n.add_(kept)
                still &= n < budget
                last = toks.gather(
                    1, (kept - 1).clamp(min=0).long()[:, None])[:, 0]
                feed.copy_(torch.where((kept > 0)[:, None], last[:, None],
                                       feed))
                pos.add_(kept)
                full = a == k
                adv_next = torch.where(full, 2, 1).to(torch.int32)
                f2a = torch.where(full, props_pad[:, k - 1], last)
                upd = still & ~samp
                adv.copy_(torch.where(upd, adv_next, adv))
                feed2.copy_(torch.where(upd[:, None],
                                        torch.stack([f2a, last], dim=1),
                                        feed2))
                dpos.copy_(torch.where(upd, pos + 1 - adv_next, dpos))
                if constrained:
                    # Commit DFA states for rows continuing past the
                    # round: the post-state at the accept length, or one
                    # step by a sampled row's draw.
                    post_a = postm.gather(1, a.long()[:, None])[:, 0]
                    cvec = sm.cid > 0
                    cst = torch.where(upd & cvec, post_a, sm.cstate)
                    cst = crt.advance_state(crow0, cst, nxt,
                                            still & samp & cvec)
                    sm.cstate.copy_(cst)
                    w["died"].logical_or_(died_now)
                    w["rfracs"][r].copy_(fracm)
                w["rtoks"][r].copy_(toks)
                w["kept"][r].copy_(kept)
                w["a"][r].copy_(a)
                w["greedy"][r].copy_(greedy)
                w["advu"][r].copy_(adv_eff)
                alive.copy_(still)

        return body

    def _tick_spec_window(self) -> None:
        """decode_window speculative rounds in ONE dispatch
        (`_spec_window_body`, a captured graph on the card): one batched
        sync a window where unfused rounds cost two dispatches and one
        sync each. Greedy output is token-identical to spec_k=0; stop
        sequences cut on drain, the overshoot discarded."""
        live = [s is not None for s in self.slots]
        if not any(live):
            return
        k, W = self.spec_k, self.decode_window
        sm = self._sampler
        sampling_rows = [s is not None and s["sampling"] for s in self.slots]
        mode = sm.window_mode(any(sampling_rows))
        constrained = any(sm.row_constrained)
        feed2, adv, dposm = self._draft_seeds()
        budget = [s["remaining"] if s is not None else 0
                  for s in self.slots]
        posm = np.where(live, self.pos, 0).astype(np.int32)
        w = self._spec_state()
        for key, val in (("pos", posm), ("dpos", dposm), ("feed2", feed2),
                         ("adv", adv), ("budget", budget)):
            w[key].copy_(self._upload(val))
        w["alive"].copy_(self._upload(live).bool())
        w["samp"].copy_(self._upload(sampling_rows).bool())
        program = self._window_program("spec", mode, constrained)
        if mode != "argmax":
            sm.fill_uniforms(w["u"])
        program()
        if self._window_captured("spec"):
            self.graph_replays += 1
            self._account_psums(W)
        self._note_dispatch(sum(live), stall=False)
        # The ONE batched sync of the window.
        (toks_h, kept_h, a_h, greedy_h, advu_h, alive_h, feed2_h, adv_h,
         *died) = host_lists(
            [w[n] for n in ("rtoks", "kept", "a", "greedy", "advu", "alive",
                            "feed2", "adv")] + ([w["died"]] if constrained
                                                else []))
        if constrained:
            died_h = died[0]
            # analysis: ignore[host-sync-in-hot-loop] the window's masked
            # fractions (floats) after its one int transfer; only in a
            # constrained window
            fracs_h = w["rfracs"].tolist()
        # The verify's rows, round by round: active rows read through
        # pos_r + k, frozen rows sit at position 0.
        pos_l = posm.copy()
        rows_read = 0
        for r in range(W):
            kept_r = np.asarray(kept_h[r], np.int32)
            rows_read += self._rows_read_multi(
                np.where(kept_r > 0, pos_l, 0), k + 1, True)
            pos_l = pos_l + kept_r
        self._account_kv_rows(rows_read, W * self.B * self.MB * self.bs)
        proposed = accepted_draft = draft_toks = rounds_run = 0
        kept_rounds = [[0] * self.B for _ in range(W)]
        total = [0] * self.B
        finishing = [False] * self.B
        stream_toks: list = [None] * self.B
        for r in range(W):
            ran = False
            for i, slot in enumerate(self.slots):
                if slot is None:
                    continue
                if greedy_h[r][i]:
                    ran = True
                    proposed += k
                    accepted_draft += a_h[r][i]
                    draft_toks += advu_h[r][i] + k - 1
                    self.obs.spec_acceptance.observe(a_h[r][i])
                n_r = kept_h[r][i]
                if n_r == 0:
                    continue
                row = toks_h[r][i][:n_r]
                if finishing[i]:
                    row = []  # overshoot past a stop cut
                elif slot["stop"] is not None:
                    hit = slot["stop"].push_window(row)
                    if hit is not None:
                        row = row[:hit]
                        finishing[i] = True
                        self.obs.window_truncated.inc()
                kept_rounds[r][i] = len(row)
                total[i] += len(row)
                if stream_toks[i] is None:
                    stream_toks[i] = [[] for _ in range(W)]
                stream_toks[i][r] = row
            rounds_run += ran
        for i, slot in enumerate(self.slots):
            if slot is None or not constrained:
                continue
            if slot["cid"] and died_h[i] and not finishing[i]:
                # A dead DFA state mid-window: the device froze the row
                # with a forced eos, its last kept token; drop it, so the
                # output ends at the last admissible token.
                for r in range(W - 1, -1, -1):
                    if kept_rounds[r][i]:
                        kept_rounds[r][i] -= 1
                        stream_toks[i][r].pop()
                        total[i] -= 1
                        break
                self.errors[slot["rid"]] = _DEAD_END
                self.constraint_dead_ends_n += 1
                self.obs.constrain_dead_ends.inc()
            if slot["cid"]:
                for r in range(W):
                    kr = kept_rounds[r][i]
                    self.constrained_tokens_n += kr
                    if kr:
                        self.obs.constrained_tokens.inc(kr)
                    for j in range(kr):
                        self.obs.constrain_masked_frac.observe(
                            fracs_h[r][i][j])
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            n_i = total[i]
            slot["remaining"] -= n_i
            if finishing[i] or not alive_h[i]:
                slot["remaining"] = 0
            self._append_tokens(slot, [t for r in range(W)
                                       for t in (stream_toks[i][r]
                                                 if stream_toks[i] else [])])
            self.pos[i] += n_i
            finishing[i] = slot["remaining"] == 0
            self.obs.tokens_generated.inc(n_i)
            self.window_tokens += n_i
            if not slot["sampling"] and not finishing[i]:
                # Continuing greedy rows: pend from the device
                # recurrence's final (feed2, adv), the next window's
                # round-0 seed.
                av = adv_h[i]
                slot["pend"] = feed2_h[i][2 - av:]
                self._draft.pos[i] = self.pos[i] + 1 - len(slot["pend"])
        self._note_spec(rounds_run, proposed, accepted_draft, draft_toks)
        self.obs.tokens_per_dispatch.set(float(sum(total)))
        if self.on_token is not None:
            last_r = [max((r for r in range(W) if kept_rounds[r][i]),
                          default=0) for i in range(self.B)]
            for r in range(W):
                for t, i in window_drain_order(kept_rounds[r], k + 1):
                    slot = self.slots[i]
                    self.on_token(
                        slot["rid"], stream_toks[i][r][t],
                        finishing[i] and r == last_r[i]
                        and t == kept_rounds[r][i] - 1,
                    )
        for i in range(self.B):
            if finishing[i]:
                self._finish(i)

    # -- emission and release -------------------------------------------------

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
        self.adapter[i] = 0
        self._tables_dev[i] = 0
        self._pos_dev[i] = 0
        self._active[i] = 0
        if self.multi_lora:
            self._adapter_dev[i] = 0
        self.slots[i] = None
        if self._draft is not None:
            self._draft.release(i)
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
    stats). The knobs are PagedDecodeServer's; `adapter_ids` and
    `sampling` assign a LoRA adapter and a SamplingParams per request.
    Stats carry the pool's (peak blocks, `kv_dtype`, `pool_bytes`, the
    spill tier's totals), the windows' (`decode_window`,
    `host_dispatches`, `tokens_per_dispatch`, `graph_replays`), the
    speculation's (`spec_*`), the mixed ticks' (`prefill_budget`,
    `prefill_stall_ticks`, `mixed_ticks`, `mixed_prefill_tokens`,
    `decode_stall_fraction`), the constraints' totals, the mesh's
    (`mesh_shape`, `tp_psums`) and the pipeline's (`pp_stages`,
    `pp_inflight`, `pp_bubble_fraction`, `pp_stage_occupancy`,
    `pp_stage_dispatches`, `pp_stage_pool_bytes`, `pp_cut_starts`).

    Under `mesh=` over a process group every rank of the model group
    calls serve_paged with the same arguments: the controller serves
    and returns the outputs; the other ranks run its dispatches and
    return an empty list (with their stats)."""
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
    try:
        return _serve_paged(srv, requests, adapter_ids, sampling)
    finally:
        srv.close()
        srv.close_pp()


def _serve_paged(srv, requests, adapter_ids, sampling):
    if not srv.controller:
        srv.run()
        return [], server_stats(srv)
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
    stats = server_stats(srv)
    if srv._spill is not None:
        srv._spill.close()  # one-shot: the drain thread ends with the run
    return [done[r] for r in rids], stats


def server_stats(srv: PagedDecodeServer, **extra) -> ServerStats:
    """A PagedDecodeServer's stats snapshot (serve_paged's, and
    serve_disagg's with its wire totals in `extra`)."""
    return ServerStats.snapshot(
        srv.obs.registry,
        ticks=srv.ticks,
        attention=srv.attention,
        peak_blocks=srv.blocks_peak,
        pool_blocks=srv.num_blocks - 1,
        block_size=srv.bs,
        flat_equivalent_rows=srv.B * srv.dec.cfg.max_len,
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
        decode_window=srv.decode_window,
        host_dispatches=srv.dispatches,
        tokens_per_dispatch=(
            srv.window_tokens / srv.dispatches if srv.dispatches else 0.0
        ),
        graph_replays=srv.graph_replays,
        spec_k=srv.spec_k,
        spec_rounds=srv.spec_rounds_n,
        spec_proposed=srv.spec_proposed_n,
        spec_accepted=srv.spec_accepted_n,
        spec_acceptance=(
            srv.spec_accepted_n / srv.spec_proposed_n
            if srv.spec_proposed_n else 0.0
        ),
        spec_draft_tokens=srv.spec_draft_tokens_n,
        prefill_budget=srv.prefill_budget,
        prefill_stall_ticks=srv.prefill_stall_ticks_n,
        mixed_ticks=srv.mixed_ticks_n,
        mixed_prefill_tokens=srv.mixed_prefill_tokens_n,
        decode_stall_fraction=srv.decode_stall_fraction_last,
        constrained_tokens=srv.constrained_tokens_n,
        constraint_dead_ends=srv.constraint_dead_ends_n,
        mesh_shape=srv.mesh_label,
        tp_psums=srv.tp_psums,
        pp_stages=srv.pp,
        pp_inflight=srv._pp_inflight if srv.pp > 1 else 0,
        pp_bubble_fraction=srv.pp_bubble_last,
        pp_stage_occupancy=list(srv.pp_occupancy_last),
        pp_stage_dispatches=list(srv.pp_stage_dispatch_n),
        pp_stage_pool_bytes=list(srv.pp_stage_pool_bytes),
        pp_cut_starts=list(srv._pp_cut_starts),
        **extra,
    )
