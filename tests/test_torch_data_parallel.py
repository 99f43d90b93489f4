"""parallel/data_parallel.py on CPU device lists: replicas and batch
shards give one pipeline's outputs, in stream order, and the one
pipeline gives the JAX package's.

Weights are the JAX package's bert_tiny init carried over with
`params_from_jax`; token ids are numpy draws from a fixed seed.
Everything computes in float32 on the CPU: replicas and shards run the
same ops on the same rows as one pipeline, so they must agree exactly
(a batch shard within atol 1e-6: the matrix products see other row
counts); one pipeline within atol 1e-4 of the JAX package (four encoder
blocks summed in different orders).
"""

import queue
import threading

import jax
import numpy as np
import pytest
import torch

from defer_tpu.models import get_model as jax_get_model
from defer_tpu_torch import DEFER, DeferConfig, Pipeline, params_from_jax
from defer_tpu_torch.graph.partition import partition
from defer_tpu_torch.models import get_model
from defer_tpu_torch.parallel.data_parallel import (
    ReplicaRetirer,
    ReplicatedPipeline,
    ShardedInference,
)
from defer_tpu_torch.utils.sync import Pending

CPU = torch.device("cpu")
F32 = DeferConfig(compute_dtype=torch.float32)
CUTS = ["encoder_1_out"]


@pytest.fixture(scope="module")
def bert():
    jmodel = jax_get_model("bert_tiny", seq_len=16)
    jparams = jmodel.init(jax.random.key(0), batch_size=4)
    rng = np.random.default_rng(0)
    ids = [rng.integers(0, 128, (4, 16)).astype(np.int32) for _ in range(6)]
    want = [np.asarray(jmodel.graph.apply(jparams, x)) for x in ids]
    model = get_model("bert_tiny", seq_len=16)
    return (model, params_from_jax(jparams, CPU),
            [torch.from_numpy(x) for x in ids], want)


def test_replicated_pipeline_matches_one_pipeline_in_order(bert):
    model, params, ids, want = bert
    stages = partition(model.graph, CUTS)
    one = Pipeline(stages, params, [CPU] * 2, F32)
    rep = ReplicatedPipeline(stages, params, [CPU] * 4, F32)
    assert (rep.num_replicas, rep.num_stages) == (2, 2)
    single = list(one.stream(ids))
    outs = list(rep.stream(ids, max_inflight=2))
    assert len(outs) == len(single) == len(ids)
    for i, (a, b) in enumerate(zip(outs, single)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_allclose(a.numpy(), want[i], atol=1e-4)


def test_run_defer_with_replicas_keeps_stream_order(bert):
    model, params, ids, want = bert
    defer = DEFER(devices=[CPU] * 4, config=F32)
    in_q, out_q = queue.Queue(), queue.Queue()
    for x in ids:
        in_q.put(x)
    in_q.put(None)
    t = threading.Thread(
        target=defer.run_defer, args=(model, CUTS, in_q, out_q),
        kwargs={"params": params, "replicas": 2}, daemon=True,
    )
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert isinstance(defer.last_pipeline, ReplicatedPipeline)
    assert defer.last_pipeline.num_replicas == 2
    pipe, _ = DEFER(devices=[CPU], config=F32).build_pipeline(
        model, CUTS, params=params
    )
    for x, w in zip(ids, want):
        got = out_q.get_nowait()
        torch.testing.assert_close(got, pipe(x), rtol=0, atol=0)
        np.testing.assert_allclose(got.numpy(), w, atol=1e-4)
    assert out_q.empty()


def test_auto_cuts_leave_slots_for_each_replica(bert):
    model, params, _, _ = bert
    pipe, _ = DEFER(devices=[CPU] * 4, config=F32).build_pipeline(
        model, "auto", params=params, replicas=2
    )
    assert (pipe.num_replicas, pipe.num_stages) == (2, 2)


def test_sharded_inference_matches_one_device(bert):
    model, params, ids, want = bert
    sharded = ShardedInference(model.graph, params, [CPU] * 2, F32)
    assert sharded.num_shards == 2 and len(sharded._stages) == 1
    outs = list(sharded.stream(ids))
    assert len(outs) == len(ids)
    for x, got, w in zip(ids, outs, want):
        assert got.shape == (4, w.shape[-1])
        np.testing.assert_allclose(got.numpy(), w, atol=1e-4)
    whole = Pipeline([model.graph], params, [CPU], F32)
    torch.testing.assert_close(outs[0], whole(ids[0]), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        sharded(ids[0][:3])


def test_replica_retirer_orders_across_replicas():
    bank = ReplicaRetirer(2, depth=4)
    out = []
    for i in range(7):
        out += [p.value for p in bank.add(Pending(i))]
    out += [p.value for p in bank.flush()]
    assert out == list(range(7))
    assert len(bank) == 0 and bank.ready_count() == 0


def test_replica_retirer_discard_realigns():
    bank = ReplicaRetirer(2, depth=64)
    assert [p.value for p in bank.add(Pending("a"))] == ["a"]
    # Replica 1 wedges: replica 0's next result waits behind the gap.
    assert bank.add(_NotReady()) == []
    assert bank.add(Pending("c")) == []
    assert bank.ready_count() == 1
    assert bank.discard() == 2
    assert (bank._add_at, bank._emit_at) == (0, 0)
    assert [p.value for p in bank.add(Pending("d"))] == ["d"]


class _NotReady:
    value = None

    def is_ready(self):
        return False


def test_device_budget_checked(bert):
    model, params, _, _ = bert
    stages = partition(model.graph, CUTS)
    with pytest.raises(ValueError, match="needs 6 devices"):
        ReplicatedPipeline(stages, params, [CPU] * 4, F32, num_replicas=3)
