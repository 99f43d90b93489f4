"""POSITIVE fixture: cross-domain-write.

A spill drain thread and the serving tick both write the store with no
lock. Expected: 2 findings.
"""

import threading


class Spill:
    def __init__(self, q):
        self.q = q
        self.store = {}
        self._thread = threading.Thread(
            target=self._drain_loop, name="kv-spill-drain", daemon=True
        )

    def _drain_loop(self):
        while True:
            key, val = self.q.get()
            self.store[key] = val

    def _tick(self):
        self.store["hot"] = 1
        return len(self.store)
