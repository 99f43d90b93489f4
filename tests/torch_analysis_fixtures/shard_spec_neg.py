"""NEGATIVE fixture: shard-spec, axes and arity.

Axes on the literal mesh, axes passed as variables (not checkable),
and specs whose tuples match the init's ranks, a dense and an MoE `w1`
(exclusive arms) both. Expected: 0 findings.
"""

from defer_tpu_torch.parallel.collectives import all_gather, psum
from defer_tpu_torch.parallel.mesh import make_mesh


def init_stack(gen, L, D, F, E, moe=False):
    def draw(shape, scale):
        return gen.normal(shape, scale)

    p = {"wq": draw((L, D, D), 0.02)}
    if moe:
        p["w1"] = draw((L, E, D, F), 0.02)
    else:
        p["w1"] = draw((L, D, F), 0.02)
    return p


def stack_specs(st="stage", tp=None, ep=None, moe=False):
    p = {"wq": (st, None, tp)}
    if moe:
        p.update(w1=(st, ep, None, tp))
    else:
        p.update(w1=(st, None, tp))
    return p


def run(x, axis):
    mesh = make_mesh({"stage": 2, "model": 2})
    y = psum(x, "model")
    z = all_gather(y, axis, dim=0)
    specs = stack_specs("stage", "model")
    return mesh, z, specs
