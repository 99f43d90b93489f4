"""NEGATIVE fixture: host-sync-in-hot-loop, torch forms.

The tick keeps its tokens on the card, reads host mirrors (numpy, a
list built from the one batched transfer) freely, and carries its one
batched transfer behind a justified ignore; a cold admission path may
sync as it likes. Expected: 0 findings (1 suppressed).
"""

import numpy as np
import torch


class Server:
    def __init__(self, b):
        self.pos = np.zeros((b,), np.int32)
        self.feed = torch.zeros((b, 1), dtype=torch.int32)

    def _tick(self, logits, need_host):
        nxt = torch.argmax(logits, dim=-1)
        self.feed.copy_(nxt[:, None])
        depth = int(self.pos.max())  # a host mirror
        budget = [4, 4]
        left = int(budget[0])  # a host list
        posm = np.where(self.pos > 0, self.pos, 0).astype(np.int32)
        deepest = int(posm.max())
        if need_host:
            # analysis: ignore[host-sync-in-hot-loop] the tick's one
            # batched transfer, only for a consumer of host tokens
            host = nxt.tolist()
            return [int(t) for t in host], int(host[0]), depth, left, deepest
        return None

    def admit(self, prompt):
        # Cold: admission, not reached from a serving root.
        return prompt.cpu().numpy(), int(prompt[0, 0]), prompt.item()
