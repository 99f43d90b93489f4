#!/usr/bin/env python3
"""Which torch.distributed collectives a backend takes on CUDA tensors.

    python3 scripts/probe_collectives.py

Runs each op in a fresh set of processes (an op that aborts its process,
as gloo's send/recv of a device tensor does, cannot take the next one
down with it): gloo at two ranks sharing cuda:0, then NCCL at world size
1 on cuda:0. Prints one line per (backend, op): each rank's result or
its error, and the processes' exit codes. parallel/collectives.py uses
only ops this lists as working for both: all_reduce, all_to_all_single
(its ppermute is one with empty splits) and all_gather_into_tensor /
reduce_scatter_tensor. Needs one card; imports neither jax nor
defer_tpu.
"""

from __future__ import annotations

import queue
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ["all_reduce", "all_to_all_single_even", "all_to_all_single_uneven",
       "all_to_all_list", "all_gather_into_tensor", "all_gather_list",
       "reduce_scatter_tensor", "reduce_scatter_list", "batch_isend_irecv",
       "broadcast", "new_group_all_reduce"]
# Seconds each op's processes may take.
TIMEOUT = 30


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _op(name: str, rank: int, world: int, dev: torch.device):
    x = torch.full((4, 3), float(rank + 1), device=dev)
    dst, src = (rank + 1) % world, (rank - 1) % world
    if name == "all_reduce":
        dist.all_reduce(x)
        return float(x[0, 0])
    if name == "all_to_all_single_even":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out[:, 0].tolist()
    if name == "all_to_all_single_uneven":
        sends, recvs = [0] * world, [0] * world
        sends[dst], recvs[src] = 4, 4
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, recvs, sends)
        return out[:, 0].tolist()
    if name == "all_to_all_list":
        outs = [torch.empty(4 // world, 3, device=dev) for _ in range(world)]
        dist.all_to_all(outs, [c.contiguous() for c in x.chunk(world)])
        return [float(o[0, 0]) for o in outs]
    if name == "all_gather_into_tensor":
        out = torch.empty(4 * world, 3, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out[:, 0].tolist()
    if name == "all_gather_list":
        outs = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(outs, x)
        return [float(o[0, 0]) for o in outs]
    if name == "reduce_scatter_tensor":
        out = torch.empty(4 // world, 3, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return out[:, 0].tolist()
    if name == "reduce_scatter_list":
        out = torch.empty(4 // world, 3, device=dev)
        dist.reduce_scatter(out, list(x.chunk(world)))
        return out[:, 0].tolist()
    if name == "batch_isend_irecv":
        out = torch.empty_like(x)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst),
                                           dist.P2POp(dist.irecv, out, src)]):
            req.wait()
        return float(out[0, 0])
    if name == "broadcast":
        dist.broadcast(x, 0)
        return float(x[0, 0])
    if name == "new_group_all_reduce":
        dist.all_reduce(x, group=dist.new_group(list(range(world))))
        return float(x[0, 0])
    raise KeyError(name)


def _worker(rank, world, port, backend, name, results):
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    torch.cuda.set_device(0)
    try:
        out = _op(name, rank, world, torch.device("cuda", 0))
        torch.cuda.synchronize()
        results.put((rank, f"ok {out}"))
    except RuntimeError as e:
        results.put((rank, f"FAIL {str(e)[:300]}"))
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    ctx = mp.get_context("spawn")
    for backend, world in (("gloo", 2), ("nccl", 1)):
        for name in OPS:
            if world == 1 and name == "batch_isend_irecv":
                continue  # no peer at one rank
            results = ctx.Queue()
            port = _free_port()
            procs = [ctx.Process(target=_worker,
                                 args=(r, world, port, backend, name, results))
                     for r in range(world)]
            for p in procs:
                p.start()
            got = []
            try:
                for _ in procs:
                    got.append(results.get(timeout=TIMEOUT))
            except queue.Empty:  # a rank died or hung: report, go on
                got.append((-1, "no result (the process aborted or hung)"))
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
            print(f"{backend} world {world} {name}: {sorted(got)} exit codes "
                  f"{[p.exitcode for p in procs]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
