"""The paged server on two-axis meshes in the port, on four gloo CPU
ranks (tests/test_torch_dist_worker.py "paged" cases, which never import
jax), held to the JAX package's mesh=None server (its own meshed tests,
tests/test_paged_tp.py and test_paged_pp.py::test_pp_tp_joint_mesh,
need a shard_map that this jax refuses):

  * {"data": 2, "model": 2}: the data axis replicated, as the JAX
    package's shard_map replicates an axis its specs do not name. Greedy
    tokens identical to JAX serve_paged and to its decoder's generate;
    every rank ran every sharded forward; the ranks at (d, m) hold the
    m-th head slice of the port's mesh=None pool (rtol / atol 1e-4, f32:
    the K/V projections are column slices and the psums add in another
    order), the two data replicas bit-equal;
  * the window capture rule (`window_captures`): a one-process mesh and
    NCCL groups capture, gloo does not; the gloo ranks' K = 4 windows
    stay eager and still give the JAX package's tokens; and the one
    window program an all-NCCL mesh sends through the seam
    (`_window_run`, its body run eagerly here) gives the JAX package's
    tokens greedy (eos_id set) and the port's mesh=None tokens sampled;
  * pp 2 x tp 2, {"stage": 2, "model": 2} through `stage_submeshes`:
    tokens identical to JAX's mesh=None server over the JAX pp test's
    S = 2 points and a pallas point with 2 microbatch groups at K = 4;
    pp_stages 2, tp_psums > 0, and the stage dispatches, bubble fraction
    and per-stage pool bytes equal the port's one-process pp server's;
    the ranks of a stage ran only their stage's forwards, and each holds
    the model-axis head slice of that server's stage pool.

One spawn of 4 ranks serves every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.models.gpt import tiny_gpt as jtiny_gpt
from defer_tpu.runtime.paged import serve_paged as jserve_paged
from defer_tpu_torch.parallel.mesh import Mesh, make_mesh
from defer_tpu_torch.runtime import paged as port_paged
from test_torch_dist_worker import _paged, spawn

CPU = torch.device("cpu")
GPT = dict(num_layers=4, dim=64, num_heads=4, ffn_dim=128, vocab_size=128,
           max_len=64, norm_style="pre")
BASE = dict(num_blocks=16, block_size=4, max_batch=2)
TOL = dict(rtol=1e-4, atol=1e-4)
PSUMS = 2 * GPT["num_layers"] + 2

# (attention, prefix_cache, window, chunk): both attention bodies, the
# radix path, a window and chunked prefill.
DP = [
    ("gathered", False, 1, None),
    ("blockwise", True, 8, None),
    ("pallas", False, 4, 8),
]
# The JAX pp test's S = 2 points, and the prefill kernel's plain version
# at K = 4 over two microbatch groups.
PP = [
    ("gathered", False, 1, None, 1),
    ("blockwise", True, 8, None, 1),
    ("gathered", False, 1, 8, 1),
    ("pallas", False, 4, None, 2),
]


def _mid(kind, point):
    return kind + "-" + "-".join(str(v) for v in point)


def _requests():
    rng = np.random.default_rng(3)
    base = rng.integers(1, 128, size=(1, 6)).astype(np.int32)
    ext = rng.integers(1, 128, size=(1, 4)).astype(np.int32)
    return [(base, 7), (np.concatenate([base, ext], axis=1), 5),
            (rng.integers(1, 128, size=(1, 11)).astype(np.int32), 6)]


def _knobs(point):
    attention, prefix_cache, window, chunk = point[:4]
    return dict(BASE, attention=attention, prefix_cache=prefix_cache,
                decode_window=window, prefill_chunk=chunk)


# Seam windows: sampled rows exercise the policy and uniforms the
# controller hands every rank.
SEAM_SAMPLED = [dict(temperature=0.8, top_k=20, seed=7), None,
                dict(temperature=1.1, min_p=0.05, seed=3)]
SEAM_POINT, SEAM_EOS = ("pallas", False, 4, None), 5


def _cases(params):
    out = {}
    for label, sampling in (("greedy", None), ("sampled", SEAM_SAMPLED)):
        out[f"seam-{label}"] = dict(
            name=f"seam-{label}", run="paged", axes={"data": 2, "model": 2},
            cfg=GPT, params=params, seam_window=True,
            knobs=dict(_knobs(SEAM_POINT), eos_id=SEAM_EOS),
            phases=[_requests()], sampling=sampling)
    for point in DP:
        out[_mid("dp", point)] = dict(
            name=_mid("dp", point), run="paged",
            axes={"data": 2, "model": 2}, cfg=GPT, params=params,
            knobs=_knobs(point), phases=[_requests()])
    for point in PP:
        out[_mid("pp", point)] = dict(
            name=_mid("pp", point), run="paged",
            axes={"stage": 2, "model": 2}, cfg=GPT, params=params,
            knobs=dict(_knobs(point), pp_stages=2, pp_inflight=point[4]),
            phases=[_requests()])
    return out


@pytest.fixture(scope="module")
def model():
    dec = jtiny_gpt(64)
    params = dec.init(jax.random.key(0))
    return dec, params, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def served(model, tmp_path_factory):
    """Every case's per-rank results, and the port's one-process run of
    the same case without the mesh (pp: on pp_devices=[cpu])."""
    cases = _cases(model[2])
    got = spawn({"cases": list(cases.values())}, 4,
                str(tmp_path_factory.mktemp("paged_mesh")))
    ranks = {name: [r[name] for r in got] for name in cases}
    ref = {}
    for name, case in cases.items():
        case = dict(case)
        if "pp_stages" in case["knobs"]:
            case["knobs"] = dict(case["knobs"], pp_devices=[CPU])
        case.pop("seam_window", None)
        ref[name] = _paged(case, None)
    return ranks, ref


@pytest.fixture(scope="module")
def solo(model):
    dec, params, _ = model
    return [np.asarray(dec.generate(params, jnp.asarray(p), s))
            for p, s in _requests()]


def _jax_tokens(model, point, **extra):
    dec, params, _ = model
    outs, _ = jserve_paged(dec, params, [(jnp.asarray(p), s)
                                         for p, s in _requests()],
                           **_knobs(point), **extra)
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("point", DP, ids=lambda p: _mid("dp", p))
def test_data_axis_beside_model_axis_token_identical(model, solo, served,
                                                     point):
    ranks, _ = served
    ctl = ranks[_mid("dp", point)][0]
    for i, (got, want, ref) in enumerate(zip(ctl["tokens"],
                                             _jax_tokens(model, point), solo)):
        np.testing.assert_array_equal(got, want, err_msg=f"request {i}")
        np.testing.assert_array_equal(got, ref, err_msg=f"request {i}")
    assert ctl["mesh_shape"] == "model=2"
    assert ctl["tp_psums"] == PSUMS * ctl["forwards"] > 0
    assert all(r["forwards"] == ctl["forwards"]
               for r in ranks[_mid("dp", point)])


@pytest.mark.parametrize("point", DP, ids=lambda p: _mid("dp", p))
def test_data_replicas_hold_the_model_axis_head_slices(served, point):
    ranks, ref = served
    name = _mid("dp", point)
    for rank, res in enumerate(ranks[name]):
        m = rank % 2  # rank r sits at (r // 2, r % 2)
        for j, (got, whole) in enumerate(zip(res["pool"],
                                             ref[name]["pool"])):
            h = whole.shape[2] // 2
            np.testing.assert_allclose(
                got[:, 1:], whole[:, 1:, m * h:(m + 1) * h], **TOL,
                err_msg=f"rank {rank} leaf {j}")
            twin = ranks[name][rank ^ 2]["pool"][j]  # the other data index
            np.testing.assert_array_equal(got, twin)


@pytest.mark.parametrize("point", PP, ids=lambda p: _mid("pp", p))
def test_pp_x_tp_token_identical(model, solo, served, point):
    ranks, ref = served
    name = _mid("pp", point)
    ctl = ranks[name][0]
    for i, (got, want, sol) in enumerate(zip(ctl["tokens"],
                                             _jax_tokens(model, point), solo)):
        np.testing.assert_array_equal(got, want, err_msg=f"request {i}")
        np.testing.assert_array_equal(got, sol, err_msg=f"request {i}")
    base = ref[name]
    assert ctl["pp_stages"] == 2 and ctl["tp_psums"] > 0
    assert ctl["bubble"] == base["bubble"]
    assert ctl["pp_stage_pool_bytes"] == base["pp_stage_pool_bytes"]
    for res in ranks[name]:
        assert res["pp_dispatches"] == base["pp_dispatches"]


@pytest.mark.parametrize("point", PP, ids=lambda p: _mid("pp", p))
def test_pp_x_tp_stages_hold_their_shards(served, point):
    """Rank r = (stage r // 2, model r % 2) holds one stage: the model
    index's head slice of that stage's pool in the one-process pp
    server; only the last stage's ranks ran the sharded head."""
    ranks, ref = served
    name = _mid("pp", point)
    for rank, res in enumerate(ranks[name]):
        stage, m = divmod(rank, 2)
        assert len(res["pool"]) == 1
        for got, whole in zip(res["pool"][0], ref[name]["pool"][stage]):
            h = whole.shape[2] // 2
            np.testing.assert_allclose(
                got[:, 1:], whole[:, 1:, m * h:(m + 1) * h], **TOL,
                err_msg=f"rank {rank}")
        chains = res["pp_dispatches"][0]
        assert res["forwards"] == (chains if stage == 1 else 0)



def _fake_mesh(backends):
    """A two-axis mesh over a process group whose groups report the
    given backends (group objects are opaque; the rule reads each one's
    backend)."""
    groups = {"data": "g0", "model": "g1"}
    return Mesh(np.empty((2, 2), dtype=object), ("data", "model"),
                np.arange(4).reshape(2, 2), 0, groups, "g2"), dict(
                    zip(["g0", "g1", "g2"], backends))


@pytest.mark.parametrize("backends,want", [
    (("nccl", "nccl", "nccl"), True),
    (("gloo", "gloo", "gloo"), False),
    (("nccl", "nccl", "gloo"), False),
    (("nccl", "gloo", "nccl"), False),
])
def test_window_captures_nccl_groups_only(monkeypatch, backends, want):
    mesh, by_group = _fake_mesh(backends)
    monkeypatch.setattr(port_paged.dist, "get_backend", by_group.__getitem__)
    card = torch.device("cuda", 0)  # a device name: no card is touched
    assert port_paged.window_captures(card, mesh) is want
    assert port_paged.window_captures(CPU, mesh) is False


def test_window_captures_one_process_mesh():
    card = torch.device("cuda", 0)
    one = make_mesh({"model": 1}, [card])
    assert not one.distributed
    assert port_paged.window_captures(card, one) is True
    assert port_paged.window_captures(card, None) is True
    assert port_paged.window_captures(CPU, make_mesh({"model": 1}, [CPU])) \
        is False


def test_gloo_mesh_windows_stay_eager(model, served):
    """The gloo ranks' K = 4 window point: every rank decided not to
    capture, no replay was counted, and the tokens are the JAX
    package's."""
    ranks, _ = served
    point = DP[2]
    assert point[2] == 4
    name = _mid("dp", point)
    assert [r["captures"] for r in ranks[name]] == [False] * 4
    ctl = ranks[name][0]
    assert ctl["graph_replays"] == 0
    for i, (got, want) in enumerate(zip(ctl["tokens"],
                                        _jax_tokens(model, point))):
        np.testing.assert_array_equal(got, want, err_msg=f"request {i}")


@pytest.mark.parametrize("label", ["greedy", "sampled"])
def test_one_window_program_through_the_seam(model, served, label):
    """The controller sends one `_window_run` a window and every rank
    runs it on the controller's inputs (a replay on cards). Greedy, the
    tokens are the JAX package's at the same knobs, eos_id included;
    sampled, whose draws come from the port's own generators, they are
    the port's mesh=None server's."""
    ranks, ref = served
    name = f"seam-{label}"
    ctl = ranks[name][0]
    if label == "greedy":
        want = _jax_tokens(model, SEAM_POINT, eos_id=SEAM_EOS)
    else:
        want = ref[name]["tokens"]
    assert len(ctl["tokens"]) == len(want)
    for i, (got, w) in enumerate(zip(ctl["tokens"], want)):
        np.testing.assert_array_equal(got, w, err_msg=f"request {i}")
    assert ctl["graph_replays"] == ctl["dispatches"] > 0
    assert all(r["forwards"] == ctl["forwards"] > 0 for r in ranks[name])
