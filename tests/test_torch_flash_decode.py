"""flash_decode's plain version against the JAX package's kernel.

The same numpy-seeded q/k/v go to `defer_tpu`'s Pallas `flash_decode`
(interpret mode, as tests/test_pallas_attention.py runs it on the CPU)
and to the port's `flash_decode_plain`, on the cases of
test_pallas_attention.py (MHA, GQA G=4 and G=8, block-boundary
positions, a sliding window) and a scalar position. Both compute f32
scores and probabilities; tolerance rtol = atol = 2e-5, the JAX file's.
On CPU tensors `flash_decode` takes the plain version and launches
nothing; the kernel itself is held against the plain version on the
card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.ops import pallas_attention as jax_pa
from defer_tpu_torch.ops.flash_decode import (
    _decode_lo_hi,
    flash_decode,
    flash_decode_plain,
    live_rows,
)

TOL = 2e-5


def _inputs(b, hq, hkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, hq, d), np.float32),
        rng.standard_normal((b, hkv, s, d), np.float32),
        rng.standard_normal((b, hkv, s, d), np.float32),
    )


@pytest.mark.parametrize(
    "hq,hkv,s,pos,window",
    [
        (8, 8, 64, [63, 10], None),  # MHA, full + short slots
        (8, 2, 64, [31, 32], None),  # GQA g=4
        (16, 2, 128, [5, 100], None),  # block-boundary positions
        (8, 2, 64, [40, 63], 16),  # sliding window
        (32, 4, 64, [0, 63], None),  # g=8, pos extremes
        (8, 2, 32, 7, None),  # a scalar pos, broadcast
    ],
)
def test_plain_matches_the_jax_kernel(hq, hkv, s, pos, window):
    b = 2
    q, k, v = _inputs(b, hq, hkv, s, 16)
    want = jax_pa.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pos, jnp.int32), window=window, interpret=True,
        block_k=32 if s % 32 == 0 else 8,
    )
    posv = torch.tensor(pos, dtype=torch.int32)
    got = flash_decode_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        posv, window=window,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("window", [None, 1, 16, 300])
@pytest.mark.parametrize("block_k", [1, 8, 32])
def test_live_range_matches_jax(window, block_k):
    for p in (0, 1, 7, 8, 31, 32, 33, 100, 255):
        lo, hi = jax_pa._decode_lo_hi(jnp.int32(p), block_k, window)
        assert _decode_lo_hi(p, block_k, window) == (int(lo), int(hi))


def test_live_rows():
    assert live_rows(0, 64, None) == 1
    assert live_rows(63, 64, None) == 64
    assert live_rows(100, 64, None) == 64  # pos past S: the whole cache
    assert live_rows(40, 64, 16) == 16
    assert live_rows(5, 64, 16) == 6


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 8, 2, 32, 16))
    pos = torch.tensor([31, 4], dtype=torch.int32)
    before = flash_decode.launches
    got = flash_decode(q, k, v, pos, window=8)
    assert flash_decode.launches == before
    torch.testing.assert_close(
        got, flash_decode_plain(q, k, v, pos, window=8), rtol=0, atol=0
    )
    # bf16 in, bf16 out: one cast at the end of f32 math.
    got16 = flash_decode(q.bfloat16(), k.bfloat16(), v.bfloat16(), pos)
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize(
    "q_shape,k_shape,window,match",
    [
        ((2, 8, 16), (2, 3, 32, 16), None, "multiple"),
        ((2, 8, 16), (2, 2, 32, 8), None, "head dim"),
        ((2, 8, 16), (2, 2, 32, 16), 0, "window"),
        ((2, 8), (2, 2, 32, 16), None, "expected"),
    ],
)
def test_validation(q_shape, k_shape, window, match):
    q = torch.zeros(q_shape)
    k = torch.zeros(k_shape)
    with pytest.raises(ValueError, match=match):
        flash_decode(q, k, k, 3, window=window)
