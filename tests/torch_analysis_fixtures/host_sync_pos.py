"""POSITIVE fixture: host-sync-in-hot-loop, torch forms.

A paged-server-like `_tick` and a helper it calls read the card back
in every way the torch rule knows. Expected: 10 findings, one a sync
(`t.cpu().numpy()` is one: the inner call).
"""

import numpy as np
import torch


class Server:
    def __init__(self, b):
        self.pos_dev = torch.zeros((b,), dtype=torch.int32)
        self.pos = np.zeros((b,), np.int32)

    def _tick(self, logits, done, ev):
        nxt = torch.argmax(logits, dim=-1)
        first = nxt.item()  # 1
        toks = nxt.tolist()  # 2
        rows = logits.cpu().numpy()  # 3 (one sync, the .cpu())
        back = logits.to("cpu")  # 4
        torch.cuda.synchronize()  # 5
        ev.synchronize()  # 6
        d = int(self.pos_dev[0])  # 7: a tensor attribute of self
        stop = bool(done.any())  # 8
        total = float(logits.sum())  # 9
        self._drain(nxt)
        return first, toks, rows, back, d, stop, total

    def _drain(self, nxt):
        return np.asarray(nxt)  # 10: reachable from _tick
