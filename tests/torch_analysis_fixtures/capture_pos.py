"""POSITIVE fixture: capture-in-hot-path.

A tick that captures its window on every call (no memo), one that
compiles a fresh function each call, and a compile whose callable is
dropped at once. Expected: 3 findings.
"""

import torch


class Server:
    def _tick(self):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):  # 1: captured again every tick
            self.body()
        g.replay()
        step = torch.compile(self.step)  # 2: compiled again every tick
        return step(self.x)

    def body(self):
        return self.x + 1


def warm(f, x):
    return torch.compile(f)(x)  # 3: the compiled callable dies here
