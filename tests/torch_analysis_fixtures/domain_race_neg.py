"""NEGATIVE fixture: cross-domain-write.

The port's shapes: an annotated drain that copies on a side stream
(`torch.cuda.stream(side)` is a library call: it must not link the
drain to the radix cache's `stream` method, the edge that once showed
a race on PrefixBlockCache.ref), writes its store under the lock, and
a serving-side cache whose refcounts only the tick writes. Expected: 0
findings.
"""

import threading

import torch


class Spill:
    def __init__(self, q):
        self.q = q
        self.store = {}
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._drain_loop, name="kv-spill-drain", daemon=True
        )

    # analysis: domain(drain) owns every copy and all store mutation
    def _drain_loop(self):
        side = torch.cuda.Stream()
        while True:
            key, val = self.q.get()
            with torch.cuda.stream(side):
                host = val.cpu()
            with self._lock:
                self.store[key] = host


class Cache:
    def __init__(self):
        self.ref = {}

    def stream(self, blk):
        self.ref[blk] = self.ref.get(blk, 0) + 1

    def _tick(self, blk):
        self.stream(blk)
        self.ref[blk] -= 1
