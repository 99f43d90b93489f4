"""Sharded checkpoints and ShardedInference over a mesh in the port,
against the JAX package (tests/test_checkpoint.py's sharded tests,
tests/test_data_parallel.py::test_sharded_inference_existing_mesh_axis),
on two gloo CPU ranks (tests/test_torch_dist_worker.py "restore",
"save", "resume" and "infer" cases, which never import jax) and in this
process:

  * a JAX save_sharded directory written from a {"model": 2} mesh of its
    virtual devices restores on two port ranks to the JAX shards, bit
    for bit (a bf16 leaf among them); a port save from two ranks
    restores in JAX to the whole tree, and every stored frame is
    byte-equal to the JAX save's frame for the same (key, span);
  * a one-process save is the JAX package's file, byte for byte;
  * spans and the stored copy of replicated data (the JAX package's
    replica_id == 0) equal JAX's for every rank of a {"data": 2,
    "model": 2} layout, a dim split over both axes included;
  * the JAX refusals, word for word: no shard files, a mixed set, mixed
    save ids, a missing leaf, a span no stored shard covers;
  * a ZeRO-1 SpmdBert state on {"data": 2} saved after 2 of 4 AdamW
    steps and restored into a state from another seed ends bit for bit
    where the uninterrupted run ends;
  * save_dcp / load_dcp round trip, the template's placement winning;
  * ShardedInference over an in-process {"data": 4} mesh and over a
    {"data": 2} mesh of two ranks gives the JAX package's outputs on a
    {"data": 4} mesh within 1e-5 (f32), the whole batch on every rank,
    and keeps the divisibility refusal.

One spawn of 2 ranks serves every rank case.
"""

import json
import os
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from defer_tpu.graph.ir import GraphBuilder as JGraphBuilder
from defer_tpu.parallel.data_parallel import ShardedInference as JSharded
from defer_tpu.parallel.mesh import make_mesh as jmake_mesh
from defer_tpu.runtime import checkpoint as jckpt
from defer_tpu_torch import DeferConfig, params_from_jax
from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.parallel import mesh as pmesh
from defer_tpu_torch.parallel.data_parallel import ShardedInference
from defer_tpu_torch.runtime import checkpoint
from test_torch_dist_worker import spawn

CPU = torch.device("cpu")
F32 = DeferConfig(compute_dtype=torch.float32)
BERT = dict(num_layers=2, dim=32, num_heads=4, ffn_dim=64, vocab_size=64,
            max_len=16)
# The tree both packages save over {"model": 2}: a column split, a row
# split in bf16, a replicated vector and a replicated scalar.
SPECS = {"w": (None, "model"), "e": ("model", None)}


def _tree():
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((4, 6)).astype(np.float32),
        "e": rng.standard_normal((8, 3)).astype(ml_dtypes.bfloat16),
        "b": rng.standard_normal((6,)).astype(np.float32),
        "s": np.asarray(7, np.int32),
    }


def _jax_tree(devices):
    mesh = jmake_mesh({"model": 2}, devices[:2])
    return {k: jax.device_put(jnp.asarray(v), NamedSharding(
        mesh, P(*SPECS.get(k, ())))) for k, v in _tree().items()}


def _chain(builder):
    b = builder("chain")
    h = b.add("dense", b.input(), name="stem", features=8)
    for i in (1, 2):
        br = b.add("dense", h, name=f"blk{i}_dense", features=8)
        br = b.add("relu", br, name=f"blk{i}_relu")
        h = b.add("add", h, br, name=f"add_{i}")
    return b.build(b.add("dense", h, name="head", features=4))


@pytest.fixture(scope="module")
def chain():
    g = _chain(JGraphBuilder)
    params = g.init(jax.random.key(0), (4, 8))
    xs = [np.asarray(jax.random.normal(jax.random.key(i), (4, 8)))
          for i in (1, 2)]
    return g, params, xs


def _frames(dirpath):
    """{(key, spans): frame bytes} of every file of a sharded save."""
    out = {}
    for name in sorted(os.listdir(dirpath)):
        with open(os.path.join(dirpath, name), "rb") as f:
            f.read(len(checkpoint._MAGIC))
            (mlen,) = struct.unpack("<q", f.read(8))
            for e in json.loads(f.read(mlen))["entries"]:
                spans = tuple(tuple(s) for s in e["spans"])
                out[(e["key"], spans)] = f.read(e["frame_len"])
    return out


@pytest.fixture(scope="module")
def ranks(devices, chain, tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_ckpt")
    jdir, pdir, rdir = (str(root / n) for n in ("jax", "port", "resume"))
    jckpt.save_sharded(jdir, _jax_tree(devices))
    g, params, xs = chain
    rng = np.random.default_rng(4)
    cases = [
        dict(name="restore", run="restore", axes={"model": 2}, dir=jdir,
             tree=_tree(), specs=SPECS),
        dict(name="save", run="save", axes={"model": 2}, dir=pdir,
             tree=_tree(), specs=SPECS, save_id=3),
        dict(name="resume", run="resume", axes={"stage": 1, "data": 2},
             dir=rdir,
             cfg=BERT, steps=4, at=2,
             ids=rng.integers(0, 64, (2, 4, 8)).astype(np.int32),
             labels=rng.integers(0, 2, (2, 4)).astype(np.int32)),
        dict(name="infer", run="infer", axes={"data": 2},
             params=jax.tree_util.tree_map(np.asarray, params), xs=xs),
    ]
    (root / "ranks").mkdir()
    got = spawn({"cases": cases}, 2, str(root / "ranks"))
    return {c["name"]: [r[c["name"]] for r in got] for c in cases}, jdir, pdir


def _slice(x, spec, rank):
    for i, ax in enumerate(spec or ()):
        if ax is not None:
            c = x.shape[i] // 2
            x = np.take(x, range(rank * c, (rank + 1) * c), axis=i)
    return x


def test_jax_directory_restores_on_port_ranks(ranks):
    got, _, _ = ranks
    for rank, res in enumerate(got["restore"]):
        for k, whole in _tree().items():
            want = _slice(whole, SPECS.get(k), rank)
            assert res[k].shape == want.shape, k
            if k == "e":
                np.testing.assert_array_equal(
                    res[k].view(np.uint16), want.view(np.uint16))
            else:
                np.testing.assert_array_equal(res[k], want)


def test_port_directory_restores_in_jax(devices, ranks):
    _, jdir, pdir = ranks
    assert sorted(os.listdir(pdir)) == [
        "shards-00000-of-00002.defer", "shards-00001-of-00002.defer"]
    like = _jax_tree(devices)
    got = jckpt.restore_sharded(pdir, like)
    for k, whole in _tree().items():
        assert got[k].sharding == like[k].sharding, k
        np.testing.assert_array_equal(
            np.asarray(got[k]).astype(np.float32),
            whole.astype(np.float32))
    # Each shard stored once, as the JAX save stores it, the same bytes.
    assert _frames(pdir) == _frames(jdir)


def test_one_process_save_is_the_jax_file(tmp_path, devices):
    tree = _tree()
    port = {k: (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v))
            for k, v in tree.items()}
    checkpoint.save_sharded(str(tmp_path / "p"), port, save_id={"step": 2})
    whole = {k: jax.device_put(jnp.asarray(v), devices[0])
             for k, v in tree.items()}
    jckpt.save_sharded(str(tmp_path / "j"), whole, save_id={"step": 2})
    name = "shards-00000-of-00001.defer"
    assert (tmp_path / "p" / name).read_bytes() == (
        tmp_path / "j" / name).read_bytes()
    back = checkpoint.restore_sharded(str(tmp_path / "j"), port)
    for k in tree:
        assert back[k].dtype == port[k].dtype
        assert torch.equal(back[k].view(torch.int16)
                           if k == "e" else back[k],
                           port[k].view(torch.int16) if k == "e" else port[k])


@pytest.mark.parametrize("spec", [
    (("data", "model"), None), ("model", "data"), (None, "model"), ()])
def test_spans_and_stored_copy_match_jax(devices, spec):
    """Every rank of a {"data": 2, "model": 2} layout: the span it holds
    and whether it stores the leaf, against the JAX package's index map
    and replica ids for the same PartitionSpec."""
    jmesh = jmake_mesh({"data": 2, "model": 2}, devices[:4])
    arr = jax.device_put(jnp.zeros((8, 4)), NamedSharding(jmesh, P(*spec)))
    shard_of = {s.device: s for s in arr.addressable_shards}
    grid = np.empty(4, object)
    grid[:] = [CPU] * 4
    ranks = np.arange(4).reshape(2, 2)
    for r, dev in enumerate(jmesh.devices.flat):
        mesh = pmesh.Mesh(grid.reshape(2, 2), ("data", "model"), ranks, r)
        want = shard_of[dev]
        local = want.data.shape
        gshape, spans, owner = checkpoint._layout(spec, local, mesh)
        assert gshape == (8, 4)
        assert spans == jckpt._shard_index_spans(want.index, (8, 4))
        assert owner == (want.replica_id == 0)


def _refusal_dirs(root, devices):
    jmesh = jmake_mesh({"data": 2}, devices[:2])
    tree = {"w": jax.device_put(jnp.ones(4), NamedSharding(jmesh, P("data")))}
    ok = str(root / "ok")
    jckpt.save_sharded(ok, tree, save_id=1)
    mixed = str(root / "mixed")
    jckpt.save_sharded(mixed, tree)
    with open(os.path.join(mixed, "shards-00003-of-00004.defer"), "wb") as f:
        f.write(b"junk")
    ids = str(root / "ids")
    for sid in (1, 2):
        jckpt.save_sharded(ids, tree, save_id=sid)
        os.rename(os.path.join(ids, "shards-00000-of-00001.defer"),
                  os.path.join(ids, f"tmp{sid}"))
    os.rename(os.path.join(ids, "tmp1"),
              os.path.join(ids, "shards-00000-of-00002.defer"))
    os.rename(os.path.join(ids, "tmp2"),
              os.path.join(ids, "shards-00001-of-00002.defer"))
    rep = str(root / "rep")
    jckpt.save_sharded(rep, {"w": jax.device_put(
        jnp.ones(4), NamedSharding(jmesh, P()))})
    empty = root / "empty"
    empty.mkdir()
    return tree, ok, mixed, ids, rep, str(empty)


def test_refusals_match_jax(tmp_path, devices):
    tree, ok, mixed, ids, rep, empty = _refusal_dirs(tmp_path, devices)
    whole = {"w": torch.ones(4)}
    half = pmesh.Mesh(np.array([CPU, CPU], object), ("data",),
                      np.arange(2), 0)
    split = dict(specs={"w": ("data",)}, mesh=half)
    cases = [
        (empty, whole, {}, tree),
        (mixed, whole, {}, tree),
        (ids, whole, {}, tree),
        (ok, {**whole, "extra": torch.ones(2)}, {},
         {**tree, "extra": jnp.ones(2)}),
        # Data shards asked of a leaf stored whole: no stored span.
        (rep, {"w": torch.ones(2)}, split, tree),
    ]
    for d, like, kw, jlike in cases:
        with pytest.raises((FileNotFoundError, ValueError, KeyError)) as err:
            checkpoint.restore_sharded(d, like, **kw)
        with pytest.raises((FileNotFoundError, ValueError, KeyError)) as jerr:
            jckpt.restore_sharded(d, jlike)
        assert type(err.value) is type(jerr.value)
        assert str(err.value) == str(jerr.value)
    # A restore at the saved layout works (the refusals are not spurious).
    got = checkpoint.restore_sharded(ok, {"w": torch.zeros(2)}, **split)
    assert torch.equal(got["w"], torch.ones(2))


def test_zero1_state_resumes_bit_for_bit(ranks):
    got, _, _ = ranks
    for res in got["resume"]:
        assert res["sliced"] > 0 and res["restored_step"] == 2
        for k, want in res["straight"].items():
            if isinstance(want, dict):
                for kk, w in want.items():
                    np.testing.assert_array_equal(res["resumed"][k][kk], w)
            else:
                np.testing.assert_array_equal(res["resumed"][k], want)


def test_dcp_round_trip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2], dtype=torch.int64),
                  "d": torch.randn(3, generator=torch.Generator()
                                   .manual_seed(0)).bfloat16()}}
    checkpoint.save_dcp(str(tmp_path / "dcp"), tree)
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(2, dtype=torch.int64),
                                          "d": torch.zeros(3).bfloat16()}}
    got = checkpoint.load_dcp(str(tmp_path / "dcp"), like)
    assert torch.equal(got["a"], tree["a"])
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    assert torch.equal(got["b"]["d"], tree["b"]["d"])
    assert got["a"].device == like["a"].device
    assert not like["a"].any()  # the template itself is left as it was


def _jax_outputs(chain, devices):
    g, params, xs = chain
    jmesh = jmake_mesh({"data": 4}, devices[:4])
    from defer_tpu.config import DeferConfig as JConfig

    dp = JSharded(g, params, jmesh, config=JConfig(compute_dtype=jnp.float32))
    return [np.asarray(dp(jnp.asarray(x))) for x in xs]


def test_sharded_inference_over_an_in_process_mesh(chain, devices):
    _, params, xs = chain
    dp = ShardedInference(_chain(GraphBuilder), params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device=CPU),
        pmesh.make_mesh({"data": 4}, [CPU] * 4), F32)
    assert dp.num_shards == 4
    for got, want in zip(dp.stream(iter(torch.tensor(x) for x in xs)),
                         _jax_outputs(chain, devices)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        dp(torch.tensor(xs[0][:3]))


def test_sharded_inference_over_ranks(chain, devices, ranks):
    got, _, _ = ranks
    want = _jax_outputs(chain, devices)
    for res in got["infer"]:
        assert res["shards"] == 2
        for a, b in zip(res["outs"], want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        assert res["indivisible"] == (
            "batch 3 not divisible by 2 data shards — pad the batch or "
            "resize the mesh")


def test_default_devices_need_a_card(chain):
    """devices=None is every CUDA device: without a card it raises
    instead of picking the CPU."""
    _, params, _ = chain
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedInference(_chain(GraphBuilder), params_from_jax(
                jax.tree_util.tree_map(np.asarray, params), device=CPU))
