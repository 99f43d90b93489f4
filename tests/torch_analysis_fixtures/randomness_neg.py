"""NEGATIVE fixture: implicit-randomness.

Every hot draw names its slot's generator, a loop reseeds with what
the pass changes, and a cold init may use the global generator.
Expected: 0 findings.
"""

import torch


class Sampler:
    def _tick(self, probs, u, gen):
        nxt = torch.multinomial(probs, 1, generator=gen)
        noise = torch.rand(probs.shape, generator=gen)
        u.uniform_(generator=gen)
        return nxt, noise


def per_request(gens, seeds):
    for i, gen in enumerate(gens):
        gen.manual_seed(seeds[i])
    return gens


def init_weights(shape):
    return torch.randn(shape)
