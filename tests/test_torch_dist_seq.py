"""Sequence parallelism on the port's collectives (parallel/sequence.py
over a gloo process group of 2 CPU ranks) against the JAX package's,
after each collective alone (its output and the gradient its backward
gives, against numpy: the transposes of parallel/collectives.py): ring
and Ulysses attention alone (make_sharded_attention, causal and
not: outputs and the gradients of q, k and v), SpmdBert over
{"stage": 1, "seq": 2} with each strategy, and the llama knobs (GQA,
RoPE at the shard's offset, swiglu, rms norms) under sp and under tp.

One spawn runs every case of this file (tests/test_torch_dist_worker.py);
tolerances as tests/test_torch_dist.py states them, and 1e-5 for the
attention's outputs and gradients (test_sequence.py's own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from defer_tpu.parallel.sequence import (
    make_sharded_attention as jax_sharded_attention,
)
from test_torch_dist import BERT, LLAMA, check_train, train_case
from test_torch_dist_worker import spawn

ATTN = dict(rtol=1e-5, atol=1e-5)
ATTN_CASES = [(s, c) for s in ("ring", "ulysses") for c in (False, True)]
LAYOUTS = {
    "seq2_ring": ({"stage": 1, "seq": 2}, BERT, {}),
    "seq2_ulysses_causal": ({"stage": 1, "seq": 2},
                            dict(BERT, norm_style="pre", causal=True),
                            {"sp_strategy": "ulysses"}),
    "llama_seq2": ({"stage": 1, "seq": 2}, LLAMA, {"llama": True}),
    "llama_tp2": ({"stage": 1, "model": 2}, LLAMA, {"llama": True}),
}


def _attention_case(strategy, causal):
    rng = np.random.default_rng(7)
    b, h, s, d = 2, 4, 16, 8
    q, k, v, proj = (rng.standard_normal((b, h, s, d)).astype(np.float32)
                     for _ in range(4))
    return dict(name=f"attn_{strategy}_{causal}", run="attention",
                axes={"seq": 2}, strategy=strategy, causal=causal, q=q, k=k,
                v=v, proj=proj)


OPS_X = np.arange(24, dtype=np.float32).reshape(4, 6)
OPS_COT = np.random.default_rng(3).standard_normal((4, 12)).astype(
    np.float32)


@pytest.fixture(scope="module")
def world2(devices, tmp_path_factory):
    cases = [_attention_case(s, c) for s, c in ATTN_CASES]
    cases.append(dict(name="ops", run="ops", axes={"seq": 2}, x=OPS_X,
                      cot=OPS_COT))
    jax_sides = {}
    for name, (axes, cfg, kw) in LAYOUTS.items():
        case, jax_side = train_case(devices, name, axes, cfg, **kw)
        cases.append(case)
        jax_sides[name] = (case, jax_side)
    ranks = spawn({"cases": cases}, 2, str(tmp_path_factory.mktemp("seq")))
    return ranks, {c["name"]: c for c in cases}, jax_sides


def _want_ops(n=2):
    """Each op's output and gradient on every rank, from numpy: x_r =
    (r + 1) X, cotangent c_r = (r + 1) COT cut to the output's shape."""
    x = [(r + 1) * OPS_X for r in range(n)]

    def c(r, shape):
        return (r + 1) * OPS_COT[:shape[0], :shape[1]]

    tot = sum(range(1, n + 1))
    w = OPS_X.shape[1]
    rows = OPS_X.shape[0] // n
    want = {}
    for r in range(n):
        gathered = np.concatenate(x, axis=1)
        a2a = np.concatenate([xi[r * rows:(r + 1) * rows] for xi in x], 1)
        want.setdefault("psum", []).append((sum(x), c(r, OPS_X.shape)))
        want.setdefault("pvary", []).append(
            (x[r], tot * OPS_COT[:, :w]))
        want.setdefault("all_gather", []).append(
            (gathered, tot * OPS_COT[:, r * w:(r + 1) * w]))
        want.setdefault("all_to_all", []).append((a2a, np.concatenate(
            [c(j, a2a.shape)[:, r * w:(r + 1) * w] for j in range(n)])))
        want.setdefault("ppermute", []).append(
            (x[(r - 1) % n], c((r + 1) % n, OPS_X.shape)))
        want.setdefault("shard", []).append((x[r][r * rows:(r + 1) * rows],
                                             np.concatenate([c(j, (rows, w))
                                                             for j in range(n)])))
        want.setdefault("unshard", []).append(
            (gathered, c(r, gathered.shape)[:, r * w:(r + 1) * w]))
    return want


@pytest.mark.parametrize("op", ["psum", "pvary", "all_gather", "all_to_all",
                                "ppermute", "shard", "unshard"])
def test_each_collective_and_its_transpose(world2, op):
    """Forward and backward of each op on both ranks, exactly: psum's
    backward the identity, pvary's the sum, all_gather's the
    reduce-scatter, all_to_all's the inverse route, ppermute's the
    inverse hop, shard's the gather and unshard's this rank's slice."""
    ranks, _, _ = world2
    for r, (y, g) in enumerate(_want_ops()[op]):
        got_y, got_g = ranks[r]["ops"][op]
        np.testing.assert_array_equal(got_y, y, err_msg=f"{op} rank {r}")
        np.testing.assert_allclose(got_g, g, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{op} grad rank {r}")


@pytest.mark.parametrize("strategy,causal", ATTN_CASES)
def test_sharded_attention_and_its_gradients_match_jax(world2, devices,
                                                       strategy, causal):
    ranks, cases, _ = world2
    case = cases[f"attn_{strategy}_{causal}"]
    got = ranks[0][case["name"]]
    attn = jax_sharded_attention(Mesh(np.array(devices[:2]), ("seq",)),
                                 strategy=strategy, causal=causal)
    q, k, v, proj = (jnp.asarray(case[n]) for n in ("q", "k", "v", "proj"))
    np.testing.assert_allclose(got["forward"], np.asarray(attn(q, k, v)),
                               **ATTN)
    grads = jax.grad(lambda *t: (attn(*t) * proj).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    for g, want in zip(got["grads"], grads):
        np.testing.assert_allclose(g, np.asarray(want), **ATTN)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sequence_and_llama_layouts_train_as_jax(world2, name):
    ranks, _, jax_sides = world2
    case, jax_side = jax_sides[name]
    check_train(ranks[0][name], jax_side, case)


def test_a_split_the_axis_cannot_divide_is_refused_before_any_collective(
        world2):
    """The ranks raised the same ValueError on S = 7 over seq 2 and went
    on to the next case: no rank entered a collective alone."""
    ranks, _, _ = world2
    for results in ranks:
        assert "does not divide over mesh axis 'seq'" in results[
            "seq2_ring"]["indivisible"]
