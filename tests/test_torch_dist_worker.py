"""One rank of the distributed tests (tests/test_torch_dist*.py and the
card's tests/test_torch_cuda.py). Holds no tests; imports torch and
defer_tpu_torch only, never jax.

    python tests/test_torch_dist_worker.py RANK WORLD PORT JOB OUT

joins a process group of WORLD ranks on tcp://127.0.0.1:PORT (the job's
backend: gloo unless it names nccl), reads the job (a pickle the test
wrote: the backend, the device every rank runs on, and a list of cases,
each a layout, a config, the whole weights and the batches as numpy),
runs every case in order on every rank, and writes this rank's results
to OUT.RANK as a pickle. A case's "run" names what it does:

  * "train": the trainer's forward (pooled), then `steps` AdamW steps
    (step 1's reduced gradients recorded, gathered whole); with "zero1"
    the same steps again on a zero1 state from the same weights;
  * "vit": SpmdVit's logits;
  * "moe": one MoE FFN at the layout's expert axis, and the a2a drop
    set of every rank's tokens;
  * "attention": `make_sharded_attention` on whole q, k, v and the
    gradients of a fixed projection of its output;
  * "ops": each op of parallel/collectives.py over the "seq" axis, its
    output and the gradient of a fixed cotangent;
  * "card": SpmdBert in bf16 from a seeded init: the pooled forward, its
    flash_attention launches, and one AdamW step's loss;
  * "decode": SpmdGptDecoder on the whole weights: a prefill step's and
    each decode step's logits, this rank's cache shard, `generate`, and
    (with "requests") serve_greedy's tokens on the flat DecodeServer,
    every rank submitting the same requests;
  * "paged": PagedDecodeServer(mesh=) over the case's mesh (a model
    axis, a data axis beside it, or a stage axis around it with
    pp_stages). The controller (position 0 of every axis) serves the
    case's phases of requests (the first
    phase's with the case's "sampling", SamplingParams keywords, and its
    delivered disagg blocks), flushing the spill tier after each, and
    with "migrate" exports a prefix chain, closes, and imports it into
    a second server that serves one more request; the other ranks follow
    each server's dispatches in run(). Every rank returns its pool shard
    (its stage's, under pp) and the sharded forwards it ran (the
    `_final_logits` calls with a tp axis); the controller also its
    tokens and counters;
  * "fleet": serve_fleet with `model_axis_size` on every rank (the
    controller's outputs, every rank's per-replica mesh shapes and psum
    counts, and how many shards of the tree its replicas made);
  * "restore": restore_sharded of the case's directory into this rank's
    shards of the case's specs; "save": save_sharded of this rank's
    shards of the case's whole tree into the case's directory;
  * "resume": a ZeRO-1 SpmdBert state stepped `steps` times without a
    break, and again from a save_sharded_train_state after `at` steps
    restored into a state from another seed; both final param trees;
  * "infer": ShardedInference of the residual chain over the mesh's
    data axis on the case's batches.
  * "t5": SpmdT5 on the whole weights: `generate`'s tokens, the
    incremental step's logits from `make_encode`'s cache, the
    teacher-forced `make_forward` and direct `forward`, and this rank's
    embedding shard and cache shard shapes.

`spawn(job, world, tmp)` is the tests' side: it starts the WORLD ranks,
waits at most JOIN_TIMEOUT seconds for all of them, kills every rank
still running then, raises unless every rank exited 0, and returns the
ranks' results in rank order.
"""

from __future__ import annotations

import functools
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from defer_tpu_torch import params_from_jax, params_to_numpy
from defer_tpu_torch.models.bert import SpmdBert
from defer_tpu_torch.models.gpt import SpmdGptDecoder
from defer_tpu_torch.models.llama import llama_config
from defer_tpu_torch.models.vit import SpmdVit
from defer_tpu_torch.parallel import collectives, lora, multihost, train
from defer_tpu_torch.parallel import transformer_stack as ts
from defer_tpu_torch.parallel.mesh import make_mesh
from defer_tpu_torch.parallel.sequence import make_sharded_attention

CPU = torch.device("cpu")
# Seconds a spawn may take, all its cases included; a hang fails the
# test well inside the suite's own limit.
JOIN_TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(job: dict, world: int, tmp) -> list:
    """Run `job` ({"cases": [...]}, optionally "backend" and "device") on
    `world` ranks; returns each rank's results, in rank order."""
    path, out = os.path.join(tmp, "job.pkl"), os.path.join(tmp, "out.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    port = _free_port()
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), path, out], cwd=root, env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + JOIN_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tails = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        tails.append(f"rank {r} exit {p.returncode}:\n{log.read()[-3000:]}")
        log.close()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("a rank failed or hung:\n" + "\n".join(tails))
    results = []
    for r in range(world):
        with open(f"{out}.{r}", "rb") as f:
            results.append(pickle.load(f))
    return results


def _config(case):
    make = llama_config if case.get("llama") else ts.TransformerConfig
    return make(**case["cfg"])


class _Recording(torch.optim.AdamW):
    """AdamW that keeps the gradients its first step is given."""

    first: list

    def step(self, closure=None):
        if not self.first:
            self.first.append([p.grad.clone() for g in self.param_groups
                               for p in g["params"]])
        return super().step(closure)


def _adamw(case):
    def factory(leaves):
        opt = _Recording(leaves, lr=case["lr"], weight_decay=case["wd"])
        opt.first = []
        return opt

    return factory


def _load(state_params, full, sb):
    """Copy the whole numpy tree's slices into a state's params."""
    src = sb.shard_params(params_from_jax(full, device=CPU))

    def copy(dst, s):
        for k in dst:
            if isinstance(dst[k], dict):
                copy(dst[k], s[k])
            else:
                dst[k].copy_(s[k])

    with torch.no_grad():
        copy(state_params, src)


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(tree):
        return {k: build(tree[k]) if isinstance(tree[k], dict) else next(it)
                for k in sorted(tree)}

    return build(like)


def _train(case, mesh):
    cfg = _config(case)
    sb = SpmdBert(mesh, cfg, compute_dtype=torch.float32,
                  sp_strategy=case.get("sp_strategy", "ring"),
                  fsdp=case.get("fsdp", False))
    ids = torch.from_numpy(case["ids"]).long()
    labels = torch.from_numpy(case["labels"]).long()
    out = {}
    runs = [False] + ([True] if case.get("zero1") else [])
    for zero1 in runs:
        gen = torch.Generator().manual_seed(0)
        if case.get("lora"):
            init, step = lora.make_lora_train_step(
                sb, _adamw(case), num_classes=case["classes"])
            state, base = init(gen)
            full_base, full_lora = lora.split_lora(case["params"])
            full_lora.update({k: case["params"][k]
                              for k in ("cls_w", "cls_b")})
            full_base = {k: v for k, v in full_base.items()
                         if k not in ("cls_w", "cls_b")}
            _load(state.params, full_lora, sb)
            _load(base, full_base, sb)
            run = functools.partial(step, state, base)
        else:
            init, step = train.make_train_step(
                sb, _adamw(case), num_classes=case["classes"], zero1=zero1)
            state = init(gen)
            _load(state.params, case["params"], sb)
            base = None
            run = functools.partial(step, state)
        if not zero1:
            params = (lora.combine_lora(base, state.params) if base
                      else state.params)
            with torch.no_grad():
                out["forward"] = sb.make_step()(params, ids).numpy()
                if sb.sp_axis:  # refused on every rank, before a collective
                    try:
                        sb.make_step()(params, ids[..., :7])
                    except ValueError as e:
                        out["indivisible"] = str(e)
        losses = []
        for _ in range(case["steps"]):
            _, loss = run(ids, labels)
            losses.append(float(loss))
        key = "zero1" if zero1 else "plain"
        out[f"{key}_losses"] = losses
        out[f"{key}_params"] = params_to_numpy(
            sb.gather_params(state.params))
        opt = state.opt_state
        inner = opt.inner if isinstance(opt, train.MeshOptimizer) else opt
        if not zero1:
            grads = _unflatten(state.params, inner.first[0])
            out["grads"] = params_to_numpy(sb.gather_params(grads))
    return out


def _vit(case, mesh):
    sv = SpmdVit(mesh, ts.TransformerConfig(**case["cfg"]),
                 compute_dtype=torch.float32, fsdp=case.get("fsdp", False),
                 **case["vit"])
    params = sv.shard_params(params_from_jax(case["params"], device=CPU))
    with torch.no_grad():
        logits = sv.make_step()(params, torch.from_numpy(case["images"]))
    return {"forward": logits.numpy()}


def _moe(case, mesh):
    p = params_from_jax(case["expert_params"], device=CPU)
    ep = mesh.shape["expert"]
    e_local = p["w1"].shape[0] // ep
    index = mesh.coords["expert"]
    local = {k: (v if k == "router"
                 else v[index * e_local:(index + 1) * e_local])
             for k, v in p.items()}
    x = torch.from_numpy(case["x"])
    fn = ts.moe_ffn_a2a if case["dispatch"] == "a2a" else ts.moe_ffn
    kw = ({"capacity_factor": case["cf"]} if case["dispatch"] == "a2a"
          else {})
    with collectives.active(mesh):
        y = fn(local, x, ep_axis="expert", top_k=case["k"], **kw)
        n_l = x.shape[0] * x.shape[1] // ep
        x_own = x.reshape(-1, x.shape[-1])[index * n_l:(index + 1) * n_l]
        idx, w = ts._route_topk(p["router"], x_own, case["k"])
        cap = ts.moe_capacity(n_l, ep * e_local, case["k"], case["cf"])
        _, _, keep = ts.a2a_slots(idx, w, ep * e_local, cap)
        keep = collectives.gather_dim(keep.to(torch.int64),
                                      mesh.group("expert"), ep, 0)
    return {"forward": y.numpy(), "keep": keep.numpy().astype(bool)}


def _attention(case, mesh):
    q, k, v = (torch.from_numpy(case[n]).requires_grad_(True)
               for n in ("q", "k", "v"))
    attn = make_sharded_attention(mesh, strategy=case["strategy"],
                                  causal=case["causal"])
    out = attn(q, k, v)
    (out * torch.from_numpy(case["proj"])).sum().backward()
    return {"forward": out.detach().numpy(),
            "grads": [t.grad.numpy() for t in (q, k, v)]}


def _ops(case, mesh):
    """Each collective over "seq" on x = (rank + 1) x arange, and the
    gradient its backward gives the cotangent (rank + 1) x cot."""
    n, r = mesh.shape["seq"], mesh.coords["seq"]
    base = torch.from_numpy(case["x"]).to(mesh.local_device)
    cot = torch.from_numpy(case["cot"]).to(mesh.local_device)
    shift = [(i, (i + 1) % n) for i in range(n)]
    ops = {
        "psum": lambda x: collectives.psum(x, "seq"),
        "pvary": lambda x: collectives.pvary(x, "seq"),
        "all_gather": lambda x: collectives.all_gather(x, "seq", dim=1),
        "all_to_all": lambda x: collectives.all_to_all(
            x, "seq", split_axis=0, concat_axis=1),
        "ppermute": lambda x: collectives.ppermute(x, "seq", shift),
        "shard": lambda x: collectives.shard(x, "seq", 0),
        "unshard": lambda x: collectives.unshard(x, "seq", 1),
    }
    out = {}
    with collectives.active(mesh):
        for name, op in ops.items():
            x = ((r + 1) * base).requires_grad_(True)
            y = op(x)
            c = (r + 1) * cot[tuple(slice(0, d) for d in y.shape)]
            (y * c).sum().backward()
            out[name] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    return out


def _card(case, mesh):
    """SpmdBert in bf16 from a seeded init on this rank's device: the
    pooled forward, the flash_attention launches it made, and one AdamW
    step's loss."""
    from defer_tpu_torch.ops.flash_attention import flash_attention

    dev = mesh.local_device
    sb = SpmdBert(mesh, ts.TransformerConfig(**case["cfg"]),
                  compute_dtype=torch.bfloat16, fsdp=case.get("fsdp", False))
    init, step = train.make_train_step(
        sb, functools.partial(torch.optim.AdamW, lr=1e-5), num_classes=2)
    state = init(torch.Generator(device=dev).manual_seed(0))
    ids = torch.from_numpy(case["ids"]).to(dev, torch.int64)
    labels = torch.from_numpy(case["labels"]).to(dev, torch.int64)
    flash_attention.launches = 0
    with torch.no_grad():
        pooled = sb.make_step()(state.params, ids)
    launches = flash_attention.launches
    _, loss = step(state, ids, labels)
    return {"forward": pooled.float().cpu().numpy(), "launches": launches,
            "loss": float(loss)}


def _decode(case, mesh):
    dec = SpmdGptDecoder(_config(case), compute_dtype=torch.float32,
                         mesh=mesh, dp_axis=case.get("dp_axis"))
    params = dec.shard_params(params_from_jax(case["params"], device=CPU))
    ids = torch.from_numpy(case["ids"]).long()
    t0 = case["t0"]
    step = dec.make_step(donate=False)
    out = {}
    with torch.no_grad():
        logits, cache = step(params, dec.init_cache(ids.shape[0]),
                             ids[:, :t0])
        out["prefill"] = logits.numpy()
        steps = []
        for t in range(t0, ids.shape[1]):
            logits, cache = step(params, cache, ids[:, t:t + 1])
            steps.append(logits[:, 0].numpy())
    out["steps"] = np.stack(steps, axis=1)
    out["k"], out["v"] = cache["k"].numpy(), cache["v"].numpy()
    g0, gsteps = case["generate"]
    out["generate"] = dec.generate(params, ids[:, :g0], gsteps).numpy()
    if case.get("requests"):
        from defer_tpu_torch.runtime.decode_server import serve_greedy

        reqs = [(torch.from_numpy(p).long(), n) for p, n in case["requests"]]
        outs, _ = serve_greedy(dec, params, reqs, max_batch=2)
        out["served"] = [o.numpy() for o in outs]
    return out


def _chain_keys(prompt, n_blocks, bs):
    from defer_tpu_torch.runtime.paged import PrefixBlockCache

    flat = np.asarray(prompt)[0, : n_blocks * bs].astype(np.int64)
    keys, prev = [], b""
    for j in range(n_blocks):
        prev = PrefixBlockCache._hash(prev, flat[j * bs:(j + 1) * bs]
                                      .tobytes())
        keys.append(prev)
    return keys


def _paged(case, mesh):
    from defer_tpu_torch.models.gpt import GptDecoder
    from defer_tpu_torch.runtime.paged import PagedDecodeServer

    from defer_tpu_torch.ops import paged_flash_decode as pfd
    from defer_tpu_torch.ops import paged_flash_prefill as pfp

    dev = (mesh.local_device if mesh is not None
           else torch.device(case.get("device", "cpu")))
    cfg = _config(case)
    dec = GptDecoder(cfg, compute_dtype=torch.float32, device=dev)
    params = params_from_jax(case["params"], device=dev)
    knobs = dict(case["knobs"])
    if case.get("draft") is not None:
        knobs.update(spec_draft=dec, spec_params=params_from_jax(
            case["draft"], device=dev))
    forwards = [0]
    final = GptDecoder._final_logits

    def counted(self, params, x, tp_axis=None):
        forwards[0] += tp_axis is not None
        return final(self, params, x, tp_axis)

    GptDecoder._final_logits = counted
    if dev.type == "cuda":
        pfd.reset_card_runs()
        pfp.reset_card_runs()
    out = {}
    try:
        srv = PagedDecodeServer(dec, params, mesh=mesh, **knobs)
        if case.get("seam_window"):
            _seam_windows(srv)
        if not srv.controller:
            srv.run()
            if case.get("migrate"):
                srv = PagedDecodeServer(dec, params, mesh=mesh, **knobs)
                srv.run()
        else:
            srv = _control(case, srv, dec, params, mesh, knobs, out)
    finally:
        GptDecoder._final_logits = final
    out["forwards"] = forwards[0]
    out["captures"] = srv._captures
    if srv.pp == 1:
        out["pool"] = [t.cpu().numpy().copy() for t in srv._leaves()]
    else:
        out["pool"] = [[st.pk.cpu().numpy(), st.pv.cpu().numpy()]
                       for st in srv._pp_stage_objs if hasattr(st, "pk")]
        out["pp_dispatches"] = list(srv.pp_stage_dispatch_n)
    if dev.type == "cuda":
        out["card_runs"] = {"paged_flash_decode": pfd.card_runs(),
                            "paged_flash_prefill": pfp.card_runs()}
    return out


def _seam_windows(srv):
    """Send each decode window through the seam as ONE program
    (`_window_run`, the path an all-NCCL mesh takes on cards) while
    running its body eagerly: gloo ranks on the CPU cannot capture, so
    this exercises what the captured path adds, the controller's window
    inputs copied into every rank's buffers before each rank runs its
    own window."""
    srv._captures = True
    srv._window_captured = lambda kind: False
    torch.cuda.is_current_stream_capturing = lambda: False


def _control(case, srv, dec, params, mesh, knobs, out):
    """The controller's side of a "paged" case, into `out`; returns the
    last server it served on."""
    from defer_tpu_torch.runtime.paged import PagedDecodeServer, server_stats

    out["tokens"] = []
    # The registry is the process's: count this server's rows only.
    kv_rows0 = srv.obs.kv_rows_read.value
    from defer_tpu_torch.models.gpt import SamplingParams

    samps = [SamplingParams(**kw) if kw else None
             for kw in case.get("sampling") or []]
    for phase, delivered in zip(case["phases"],
                                case.get("delivered", [[]] * 9)):
        rids = [srv.submit(torch.from_numpy(np.asarray(p)).long(), n,
                           sampling=samps[i] if i < len(samps) else None)
                for i, (p, n) in enumerate(phase)]
        for prompt, steps, k, v, lg in delivered:
            rid = srv.submit_prefilled(prompt, steps)
            srv.deliver_kv(rid, k, v, lg)
            rids.append(rid)
        done = srv.run()
        srv.flush_spill()
        out["tokens"] += [done[r].cpu().numpy() for r in rids]
    stats = server_stats(srv)
    out.update(
        mesh_shape=stats["mesh_shape"], tp_psums=stats["tp_psums"],
        dispatches=srv.dispatches, graph_replays=srv.graph_replays,
        kv_rows=srv.obs.kv_rows_read.value - kv_rows0,
        spill_hits=srv.spill_hits_n,
        saved=srv.prefill_tokens_saved, pool_bytes=srv.pool_bytes,
        ticks=srv.ticks, chunks=srv.prefill_chunks,
        pp_stages=stats["pp_stages"], bubble=stats["pp_bubble_fraction"],
        pp_stage_pool_bytes=stats["pp_stage_pool_bytes"],
    )
    mig = case.get("migrate")
    if mig:
        keys = _chain_keys(mig["prompt"], mig["blocks"], knobs["block_size"])
        toks, k, v = srv.export_prefix_blocks(keys)
        out["export"] = (toks, k.cpu().numpy(), v.cpu().numpy())
        srv.close()
        srv2 = PagedDecodeServer(dec, params, mesh=mesh, **knobs)
        out["imported"] = srv2.import_prefix_blocks(toks, k, v)
        rid = srv2.submit(torch.from_numpy(mig["request"][0]).long(),
                          mig["request"][1])
        out["migrated"] = srv2.run()[rid].cpu().numpy()
        out["migrated_saved"] = srv2.prefill_tokens_saved
        srv = srv2
    srv.close()
    return srv


def _t5(case, mesh):
    from defer_tpu_torch.models.t5 import T5Config, spmd_t5

    m = spmd_t5(mesh, T5Config(**case["cfg"]), compute_dtype=torch.float32)
    params = m.shard_params(params_from_jax(case["params"], device=CPU))
    enc, dec = (torch.from_numpy(case[k]).long() for k in ("enc", "dec"))
    mask = torch.from_numpy(case["mask"])
    ones = torch.ones(enc.shape, dtype=torch.int32)
    with torch.no_grad():
        _, cache = m.make_encode()(params, enc, ones)
        step, _ = m.make_step(donate=False)(params, cache, dec)
        out = {
            "generate": m.generate(params, enc, case["steps"]).cpu().numpy(),
            "step": step.cpu().numpy(),
            "forward": m.make_forward()(params, enc, dec, mask).cpu().numpy(),
            "direct": m.forward(params, enc, dec).cpu().numpy(),
            "embedding": params["token_embedding"].cpu().numpy(),
            "cache": {k: tuple(cache[k].shape)
                      for k in ("k", "cross_k", "cross_bias")},
        }
    return out


def _local(x, spec, mesh):
    """This rank's shard of a whole numpy leaf under `spec` (bf16 through
    its bit view)."""
    x = np.array(x, order="C")  # ascontiguousarray would make 0-d 1-d
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    for i, entry in enumerate(spec or ()):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        index, n = 0, 1
        for ax in axes:
            index = index * mesh.shape[ax] + mesh.coords[ax]
            n *= mesh.shape[ax]
        c = t.shape[i] // n
        t = t.narrow(i, index * c, c)
    return t.contiguous()


def _restore(case, mesh):
    from defer_tpu_torch.runtime import checkpoint

    like = {k: torch.zeros_like(_local(v, case["specs"].get(k), mesh))
            for k, v in case["tree"].items()}
    got = checkpoint.restore_sharded(case["dir"], like, specs=case["specs"],
                                     mesh=mesh)
    return {k: (v.view(torch.int16).numpy().view(np.uint16)
                if v.dtype == torch.bfloat16 else v.numpy())
            for k, v in got.items()}


def _save(case, mesh):
    from defer_tpu_torch.runtime import checkpoint

    tree = {k: _local(v, case["specs"].get(k), mesh)
            for k, v in case["tree"].items()}
    checkpoint.save_sharded(case["dir"], tree, specs=case["specs"],
                            mesh=mesh, save_id=case["save_id"])
    return {}


def _resume(case, mesh):
    from defer_tpu_torch.runtime import checkpoint

    sb = SpmdBert(mesh, ts.TransformerConfig(**case["cfg"]),
                  compute_dtype=torch.float32)
    ids = torch.from_numpy(case["ids"]).long()
    labels = torch.from_numpy(case["labels"]).long()
    init, step = train.make_train_step(
        sb, functools.partial(torch.optim.AdamW, lr=1e-3), num_classes=2,
        zero1=True)
    dev = mesh.local_device
    ids, labels = ids.to(dev), labels.to(dev)
    state = init(torch.Generator(device=dev).manual_seed(0))
    out = {}
    for i in range(case["steps"]):
        if i == case["at"]:
            checkpoint.save_sharded_train_state(case["dir"], state, sb,
                                                save_id=i)
        step(state, ids, labels)
    out["straight"] = params_to_numpy(sb.gather_params(state.params))
    state = init(torch.Generator(device=dev).manual_seed(1))
    step(state, ids, labels)  # its moments exist, and are wrong
    checkpoint.restore_sharded_train_state(case["dir"], state, sb)
    out["restored_step"] = int(state.step)
    for _ in range(case["steps"] - case["at"]):
        step(state, ids, labels)
    out["resumed"] = params_to_numpy(sb.gather_params(state.params))
    out["sliced"] = len(state.opt_state.slices)
    return out


def _infer(case, mesh):
    from defer_tpu_torch import DeferConfig
    from defer_tpu_torch.graph.ir import GraphBuilder
    from defer_tpu_torch.parallel.data_parallel import ShardedInference

    b = GraphBuilder("chain")
    h = b.add("dense", b.input(), name="stem", features=8)
    for i in (1, 2):
        br = b.add("dense", h, name=f"blk{i}_dense", features=8)
        br = b.add("relu", br, name=f"blk{i}_relu")
        h = b.add("add", h, br, name=f"add_{i}")
    graph = b.build(b.add("dense", h, name="head", features=4))
    dp = ShardedInference(graph, params_from_jax(case["params"], device=CPU),
                          mesh, DeferConfig(compute_dtype=torch.float32))
    xs = [torch.from_numpy(x) for x in case["xs"]]
    out = {"outs": [y.cpu().numpy() for y in dp.stream(iter(xs))],
           "shards": dp.num_shards}
    try:
        dp(xs[0][:3])
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _fleet(case, mesh):
    from defer_tpu_torch.fleet.api import serve_fleet
    from defer_tpu_torch.models.gpt import GptDecoder

    from defer_tpu_torch.ops import paged_flash_decode as pfd
    from defer_tpu_torch.ops import paged_flash_prefill as pfp

    dev = mesh.local_device
    dec = GptDecoder(_config(case), compute_dtype=torch.float32, device=dev)
    params = params_from_jax(case["params"], device=dev)
    reqs = [(torch.from_numpy(p).long(), n) for p, n in case["requests"]]
    if dev.type == "cuda":
        pfd.reset_card_runs()
        pfp.reset_card_runs()
    outs, stats = serve_fleet(dec, params, reqs, devices=[dev],
                              **case["knobs"])
    runs = ({"paged_flash_decode": pfd.card_runs(),
             "paged_flash_prefill": pfp.card_runs()}
            if dev.type == "cuda" else None)
    return {"tokens": [o.cpu().numpy() for o in outs], "card_runs": runs,
            "mesh_shapes": [r["mesh_shape"] for r in stats["replicas"]],
            "dead": [r["dead"] for r in stats["replicas"]],
            "tp_psums": [r["tp_psums"] for r in stats["replicas"]],
            "shards": sum(1 for k in dec._steps
                          if isinstance(k, tuple) and k[0] == "paged_shard")}


RUNS = {"train": _train, "vit": _vit, "moe": _moe, "attention": _attention,
        "ops": _ops, "card": _card, "decode": _decode, "paged": _paged,
        "t5": _t5, "fleet": _fleet, "restore": _restore, "save": _save,
        "resume": _resume, "infer": _infer}


def main(rank: int, world: int, port: int, job: str, out: str) -> None:
    with open(job, "rb") as f:
        job = pickle.load(f)
    backend = job.get("backend", "gloo")
    device = torch.device(job.get("device", "cpu"))
    multihost.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                         backend=backend)
    torch.manual_seed(0)
    results = {}
    for case in job["cases"]:
        mesh = make_mesh(case["axes"], [device] * world)
        results[case["name"]] = RUNS[case["run"]](case, mesh)
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
