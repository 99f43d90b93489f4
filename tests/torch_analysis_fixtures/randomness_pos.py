"""POSITIVE fixture: implicit-randomness.

A tick that samples from the process's global generator three ways,
and a loop that reseeds with the same value each pass. Expected: 4
findings.
"""

import torch


class Sampler:
    def _tick(self, probs, u):
        nxt = torch.multinomial(probs, 1)  # 1
        noise = torch.rand(probs.shape)  # 2
        u.uniform_()  # 3
        return nxt, noise


def replay_draws(gen, n):
    out = []
    for _ in range(n):
        gen.manual_seed(1234)  # 4: every pass draws the same values
        out.append(torch.rand(2, generator=gen))
    return out
