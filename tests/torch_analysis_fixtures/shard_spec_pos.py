"""POSITIVE fixture: shard-spec, axes and arity.

A collective and a spec builder name axes the literal mesh beside them
lacks, and a spec's tuple names fewer dims than the leaf the init
draws. Expected: 3 findings.
"""

from defer_tpu_torch.parallel.collectives import psum
from defer_tpu_torch.parallel.mesh import make_mesh


def init_stack(gen, L, D, F):
    def draw(shape, scale):
        return gen.normal(shape, scale)

    return {"wq": draw((L, D, D), 0.02), "w1": draw((L, D, F), 0.02)}


def stack_specs(st="stage", tp=None):
    return {"wq": (st, tp), "w1": (st, None, tp)}  # 1: wq is rank 3


def run(x):
    mesh = make_mesh({"model": 2})
    y = psum(x, "data")  # 2
    specs = stack_specs("stage", "model")  # 3: no stage axis here
    return mesh, y, specs
