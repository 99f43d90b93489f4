"""runtime/checkpoint.py through both packages: the same params give the
same file bytes, and each package loads what the other saved, bit for
bit (bfloat16 as its uint16 bit view, as the JAX package writes it).

Params are numpy draws from a fixed seed (and a JAX model's random
init); loads must be exactly equal.
"""

import collections

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from defer_tpu.models import get_model as jax_get_model
from defer_tpu.runtime import checkpoint as jckpt
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.runtime.checkpoint import (
    load_checkpoint,
    load_pytree,
    save_checkpoint,
    save_pytree,
)

CPU = torch.device("cpu")


def _params():
    rng = np.random.default_rng(0)
    return {
        "conv": {"kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
                 "bias": rng.standard_normal((4,)).astype(np.float16)},
        "emb": {"table": rng.standard_normal((8, 4)).astype(ml_dtypes.bfloat16),
                "ids": rng.integers(0, 9, (5,)).astype(np.int32)},
        "flag": {"on": np.array([True, False])},
    }


def _as_torch(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _as_torch(v)
        elif v.dtype == np.dtype(ml_dtypes.bfloat16):
            out[k] = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(v)
    return out


def _bits(t):
    t = torch.as_tensor(np.asarray(t)) if not isinstance(t, torch.Tensor) else t
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_same_params_same_file_bytes(tmp_path):
    jnp_params = jax.tree_util.tree_map(jnp.asarray, _params())
    save_checkpoint(tmp_path / "port.ckpt", _as_torch(_params()))
    jckpt.save_checkpoint(str(tmp_path / "jax.ckpt"), jnp_params)
    assert (tmp_path / "port.ckpt").read_bytes() == (
        tmp_path / "jax.ckpt").read_bytes()


def test_reference_file_loads_in_the_port(tmp_path):
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, jax.tree_util.tree_map(jnp.asarray, _params()))
    got = load_checkpoint(path, device=CPU)
    want = _as_torch(_params())
    for node in want:
        for k, v in want[node].items():
            assert got[node][k].dtype == v.dtype
            assert torch.equal(_bits(got[node][k]), _bits(v))


def test_port_file_loads_in_the_reference(tmp_path):
    path = str(tmp_path / "port.ckpt")
    save_checkpoint(path, _as_torch(_params()))
    got = jckpt.load_checkpoint(path)
    for node, p in _params().items():
        for k, v in p.items():
            assert got[node][k].dtype == v.dtype
            np.testing.assert_array_equal(
                np.asarray(got[node][k]).view(np.uint8), v.view(np.uint8)
            )


def test_model_params_round_trip_bit_equal(tmp_path):
    jparams = jax_get_model("bert_tiny", seq_len=16).init(jax.random.key(0))
    params = params_from_jax(jparams, CPU, torch.bfloat16)
    path = str(tmp_path / "bert.ckpt")
    save_checkpoint(path, params)
    back = load_checkpoint(path, device="cpu")
    # Parameterless nodes leave no entry, as in the JAX package.
    assert back.keys() == {k for k, v in params.items() if v}
    for node, p in params.items():
        for k, v in p.items():
            assert back[node][k].dtype == v.dtype
            assert torch.equal(_bits(back[node][k]), _bits(v))


Opt = collections.namedtuple("Opt", ["mu", "count"])


def _tree():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 2)).astype(np.float32)
    return {"params": {"w": w, "b": np.zeros(2, np.float32)},
            "opt": [Opt(mu=w * 0.5, count=np.int32(3)), None],
            "step": np.int32(7)}


def test_pytree_files_cross_the_packages(tmp_path):
    tree = _tree()
    ptree = jax.tree_util.tree_map(torch.as_tensor, tree)
    save_pytree(str(tmp_path / "port.ckpt"), ptree)
    got = jckpt.load_pytree(str(tmp_path / "port.ckpt"), tree)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
        tree)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    jckpt.save_pytree(str(tmp_path / "jax.ckpt"), tree)
    back = load_pytree(str(tmp_path / "jax.ckpt"), ptree, device=CPU)
    assert isinstance(back["opt"][0], Opt) and back["opt"][1] is None
    np.testing.assert_array_equal(back["opt"][0].mu.numpy(), tree["opt"][0].mu)
    assert int(back["step"]) == 7 and int(back["opt"][0].count) == 3


def test_bad_files_and_keys_raise(tmp_path):
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="not a defer_tpu checkpoint"):
        load_checkpoint(str(bad), device=CPU)
    with pytest.raises(ValueError, match="may not contain"):
        save_checkpoint(str(tmp_path / "x"), {"a/b": torch.zeros(1)})
    save_pytree(str(tmp_path / "t.ckpt"), {"a": torch.zeros(1)})
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(str(tmp_path / "t.ckpt"), {"a": 0, "b": 0}, device=CPU)


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: loads land on it")
    save_checkpoint(str(tmp_path / "c.ckpt"), {"a": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint(str(tmp_path / "c.ckpt"))
