"""The paged kernels' plain versions against the JAX package.

The same numpy-seeded q and pool go to `defer_tpu`'s Pallas
`paged_flash_decode` / `paged_flash_prefill` (interpret mode, as
tests/test_paged_attention.py and tests/test_spec_paged.py run them on
the CPU), to the JAX package's plain folds `_blockwise_attend(_mt)`,
and to the port's `paged_flash_decode_plain` /
`paged_flash_prefill_plain`: small shapes (B=3, Hq=4, Hkv=2, bs=4, MB=4,
Dh=16, T=3), tables whose unallocated entries point at trash block 0,
with and without a window that crosses a block edge, on a float pool
and on an int8 pool with per-(block, head) scales. Everything is f32
and every side computes f32 scores and probabilities: atol = rtol =
1e-5. The live-range helpers must equal the JAX ones. On CPU tensors the
wrappers take the plain version and launch nothing; the kernels
themselves are held against the plain versions on the card
(tests/test_torch_cuda.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.ops import pallas_attention as jax_pa
from defer_tpu.runtime.paged import _blockwise_attend as jax_blockwise
from defer_tpu.runtime.paged import _blockwise_attend_mt as jax_blockwise_mt
from defer_tpu_torch.models.quant import quantize_symmetric
from defer_tpu_torch.ops.flash_decode import (
    _cluster_size,
    _f32_chunks,
    _live_bounds,
    _warp_slices,
)
from defer_tpu_torch.ops.paged_flash_decode import (
    _decode_lo_hi,
    _table_reads,
    folded_blocks,
    paged_flash_decode,
    paged_flash_decode_plain,
)
from defer_tpu_torch.ops.paged_flash_prefill import (
    _prefill_lo_hi,
    _prefill_plan,
    _split_columns,
    paged_flash_prefill,
    paged_flash_prefill_plain,
)

TOL = 1e-5
B, HQ, HKV, BS, MB, DH, T, NB = 3, 4, 2, 4, 4, 16, 3, 10
# Slot 0 owns four blocks, slot 1 one (the rest trash), slot 2 three.
TABLES = np.array([[1, 2, 3, 4], [5, 0, 0, 0], [6, 7, 8, 0]], np.int32)


def _pool(seed=0):
    rng = np.random.default_rng(seed)
    pk = rng.standard_normal((NB, HKV, BS, DH), np.float32)
    pv = rng.standard_normal((NB, HKV, BS, DH), np.float32)
    return rng, pk, pv


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("pos", [[15, 2, 9], [0, 3, 11]])
def test_decode_plain_matches_the_jax_kernel_and_fold(pos, window):
    rng, pk, pv = _pool()
    q = rng.standard_normal((B, HQ, DH), np.float32)
    posa = np.asarray(pos, np.int32)
    want = jax_pa.paged_flash_decode(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(TABLES), jnp.asarray(posa), window=window,
        interpret=True,
    )
    fold = jax_blockwise(
        jnp.asarray(q)[:, :, None, :], jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(TABLES), jnp.asarray(posa), BS, MB, window,
    )
    tq, tk, tv, tt, tp = _t(q, pk, pv, TABLES, posa)
    got = paged_flash_decode_plain(tq, tk, tv, tt, tp, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.reshape(B, 1, HQ * DH).numpy(),
                               np.asarray(fold), rtol=TOL, atol=TOL)
    # Folding the whole table adds exactly nothing past the live range.
    whole = paged_flash_decode_plain(tq, tk, tv, tt, tp, window=window,
                                     num_blocks=MB)
    torch.testing.assert_close(whole, got, rtol=0, atol=0)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("start", [[0, 1, 9], [13, 0, 6]])
def test_prefill_plain_matches_the_jax_kernel_and_fold(start, window):
    rng, pk, pv = _pool(1)
    q = rng.standard_normal((B, HQ, T, DH), np.float32)
    sa = np.asarray(start, np.int32)
    want = jax_pa.paged_flash_prefill(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(TABLES), jnp.asarray(sa), window=window,
        interpret=True,
    )
    fold = jax_blockwise_mt(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(TABLES), jnp.asarray(sa), BS, MB, window,
    )
    tq, tk, tv, tt, ts = _t(q, pk, pv, TABLES, sa)
    got = paged_flash_prefill_plain(tq, tk, tv, tt, ts, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(
        got.transpose(1, 2).reshape(B, T, HQ * DH).numpy(),
        np.asarray(fold), rtol=TOL, atol=TOL,
    )


def _int8_pool(seed):
    """The seeded pool as the int8 pool stores it: int8 payload and one
    f32 scale per (block, head), numpy arrays."""
    out = []
    for pool in _pool(seed)[1:]:
        q, s = quantize_symmetric(torch.from_numpy(pool), axis=(-2, -1))
        out += [q.numpy(), s.numpy()]
    return out


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("pos", [[15, 2, 9], [0, 3, 11]])
def test_decode_plain_int8_matches_the_jax_kernel_and_fold(pos, window):
    """The quantized case: an int8 pool with per-(block, head) scales,
    through the Pallas kernel's scale path (interpret mode), the JAX
    fold over the {"q", "s"} pool and the port's plain version."""
    kq, ks, vq, vs = _int8_pool(3)
    q = np.random.default_rng(4).standard_normal((B, HQ, DH), np.float32)
    posa = np.asarray(pos, np.int32)
    want = jax_pa.paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(TABLES), jnp.asarray(posa), window=window,
        interpret=True, scale_k=jnp.asarray(ks), scale_v=jnp.asarray(vs),
    )
    fold = jax_blockwise(
        jnp.asarray(q)[:, :, None, :],
        {"q": jnp.asarray(kq), "s": jnp.asarray(ks)},
        {"q": jnp.asarray(vq), "s": jnp.asarray(vs)},
        jnp.asarray(TABLES), jnp.asarray(posa), BS, MB, window,
    )
    tq, tkq, tks, tvq, tvs, tt, tp = _t(q, kq, ks, vq, vs, TABLES, posa)
    got = paged_flash_decode_plain(tq, tkq, tvq, tt, tp, window=window,
                                   scale_k=tks, scale_v=tvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.reshape(B, 1, HQ * DH).numpy(),
                               np.asarray(fold), rtol=TOL, atol=TOL)
    torch.testing.assert_close(
        paged_flash_decode(tq, tkq, tvq, tt, tp, window=window,
                           scale_k=tks, scale_v=tvs), got, rtol=0, atol=0,
    )


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("start", [[0, 1, 9], [13, 0, 6]])
def test_prefill_plain_int8_matches_the_jax_kernel_and_fold(start, window):
    kq, ks, vq, vs = _int8_pool(5)
    q = np.random.default_rng(6).standard_normal((B, HQ, T, DH), np.float32)
    sa = np.asarray(start, np.int32)
    want = jax_pa.paged_flash_prefill(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(TABLES), jnp.asarray(sa), window=window,
        interpret=True, scale_k=jnp.asarray(ks), scale_v=jnp.asarray(vs),
    )
    fold = jax_blockwise_mt(
        jnp.asarray(q),
        {"q": jnp.asarray(kq), "s": jnp.asarray(ks)},
        {"q": jnp.asarray(vq), "s": jnp.asarray(vs)},
        jnp.asarray(TABLES), jnp.asarray(sa), BS, MB, window,
    )
    tq, tkq, tks, tvq, tvs, tt, ts = _t(q, kq, ks, vq, vs, TABLES, sa)
    got = paged_flash_prefill_plain(tq, tkq, tvq, tt, ts, window=window,
                                    scale_k=tks, scale_v=tvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(
        got.transpose(1, 2).reshape(B, T, HQ * DH).numpy(),
        np.asarray(fold), rtol=TOL, atol=TOL,
    )


@pytest.mark.parametrize("window", [None, 1, 5, 16])
@pytest.mark.parametrize("bs", [1, 4, 8])
def test_live_ranges_match_jax(window, bs):
    for p in (0, 1, 3, 4, 5, 15, 16, 31):
        lo, hi = jax_pa._decode_lo_hi(jnp.int32(p), bs, window)
        assert _decode_lo_hi(p, bs, window) == (int(lo), int(hi))
        for t in (1, 3, 8):
            lo, hi = jax_pa._prefill_lo_hi(jnp.int32(p), t, bs, window)
            assert _prefill_lo_hi(p, t, bs, window) == (int(lo), int(hi))


def test_folded_blocks_is_the_jax_bound():
    pos = torch.tensor([3, 9, 0])
    assert folded_blocks(pos, 1, 4, 4) == 9 // 4 + 1
    assert folded_blocks(pos, 3, 4, 4) == min((9 + 2) // 4 + 1, 4)
    assert folded_blocks(torch.tensor([15]), 3, 4, 4) == 4  # capped at MB


def test_cpu_tensors_take_the_plain_version():
    rng, pk, pv = _pool(2)
    q = rng.standard_normal((B, HQ, T, DH), np.float32)
    tq, tk, tv, tt = _t(q, pk, pv, TABLES)
    pos = torch.tensor([7, 2, 10], dtype=torch.int32)
    dec_before = paged_flash_decode.launches
    pre_before = paged_flash_prefill.launches
    got = paged_flash_decode(tq[:, :, 0], tk, tv, tt, pos, window=3)
    torch.testing.assert_close(
        got, paged_flash_decode_plain(tq[:, :, 0], tk, tv, tt, pos,
                                      window=3), rtol=0, atol=0,
    )
    got = paged_flash_prefill(tq, tk, tv, tt, pos)
    torch.testing.assert_close(
        got, paged_flash_prefill_plain(tq, tk, tv, tt, pos), rtol=0, atol=0
    )
    assert paged_flash_decode.launches == dec_before
    assert paged_flash_prefill.launches == pre_before
    # bf16 in, bf16 out: one cast at the end of f32 math.
    got16 = paged_flash_decode(tq[:, :, 0].bfloat16(), tk.bfloat16(),
                               tv.bfloat16(), tt, 3)
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("fn,q_shape", [
    (paged_flash_decode, (B, HQ, DH)),
    (paged_flash_prefill, (B, HQ, T, DH)),
])
def test_validation_and_int8_scales(fn, q_shape):
    _, pk, pv = _pool()
    tk, tv, tt = _t(pk, pv, TABLES)
    q = torch.zeros(q_shape)
    kq, vq = tk.to(torch.int8), tv.to(torch.int8)
    ones = torch.ones(NB, HKV)
    with pytest.raises(ValueError, match="both scale_k and scale_v"):
        fn(q, kq, vq, tt, 3, scale_k=ones)
    with pytest.raises(ValueError, match="both scale_k and scale_v"):
        fn(q, kq, vq, tt, 3, scale_v=ones)
    with pytest.raises(ValueError, match="needs its per-"):
        fn(q, kq, vq, tt, 3)
    with pytest.raises(ValueError, match="int8 pool"):
        fn(q, tk, tv, tt, 3, scale_k=ones, scale_v=ones)
    with pytest.raises(ValueError, match=r"float32 \[NB, Hkv\]"):
        fn(q, kq, vq, tt, 3, scale_k=ones[:, :1], scale_v=ones)
    with pytest.raises(ValueError, match=r"float32 \[NB, Hkv\]"):
        fn(q, kq, vq, tt, 3, scale_k=ones, scale_v=ones.double())
    got = fn(q, kq, vq, tt, 3, scale_k=ones, scale_v=ones)
    assert got.shape == q.shape and torch.isfinite(got).all()
    with pytest.raises(ValueError, match="multiple"):
        fn(torch.zeros(q_shape[:1] + (3,) + q_shape[2:]), tk, tv, tt, 3)
    with pytest.raises(ValueError, match="head dim"):
        fn(q, tk[..., :8], tv[..., :8], tt, 3)
    with pytest.raises(ValueError, match="tables"):
        fn(q, tk, tv, tt[:2], 3)
    with pytest.raises(ValueError, match="window"):
        fn(q, tk, tv, tt, 3, window=0)


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("start,t,g,bs,window,mb", [
    (0, 64, 4, 16, 4096, 256),     # a first chunk
    (64, 64, 4, 16, 4096, 256),    # the chunk after a 4-block radix hit
    (1984, 64, 4, 16, 4096, 256),  # a 2k-deep chunk
    (4032, 64, 4, 16, 4096, 256),  # the last chunk of max_len 4096
    (500, 64, 4, 16, 100, 64),     # a window crossing block edges
    (1000, 5, 4, 16, None, 64),
    (100, 16, 1, 16, None, 32),
    (300, 32, 8, 16, None, 64),
    (7, 24, 4, 8, None, 64),
    (600, 40, 4, 32, 200, 32),
    (9, 5, 2, 1, None, 16),
    (13, 3, 2, 4, 5, 4),
])
def test_split_plan_covers_the_live_range_once(start, t, g, bs, window, mb,
                                               sms):
    """The tensor-core prefill kernel's plan: for every CTA's 64
    token-major rows, the cluster's ranks that have tiles cover the
    rows' live columns exactly once, in whole 64-column tiles from the
    edge of the first live block, never past the deepest row's position,
    and every column a row attends lies in them; the cluster is at most
    8 CTAs and holds every rank that has tiles; over the chunk the live
    columns are `_prefill_lo_hi`'s blocks."""
    splits = _prefill_plan(sms, 1, 8 * g, 8, t, bs, mb)
    assert 1 <= splits <= min(8, math.ceil(mb * bs / 64))
    lo, hi = _prefill_lo_hi(start, t, bs, window)
    rows, cta_rows = t * g, 64
    spans = []
    for r0 in range(0, rows, cta_rows):
        ranges = _split_columns(start, r0, g, t, bs, mb, window, splits)
        assert 1 <= len(ranges) <= splits
        t_first, t_last = r0 // g, min((r0 + cta_rows - 1) // g, t - 1)
        first = (max(start + t_first - window + 1, 0) // bs * bs
                 if window is not None else 0)
        last = min(start + t_last, mb * bs - 1)
        assert ranges[0][0] == first and ranges[-1][1] == last
        for (a, b), (c, _) in zip(ranges, ranges[1:]):
            assert c == b + 1  # contiguous: no column twice, none skipped
        for a, b in ranges:
            assert (a - first) % 64 == 0 and a <= b <= last
        for r in range(r0, min(r0 + cta_rows, rows)):
            pos = start + r // g
            low = max(pos - window + 1, 0) if window is not None else 0
            assert first <= low and pos <= last
        spans.append((first, last))
    assert spans[0][0] == lo * bs
    assert spans[-1][1] // bs == hi


@pytest.mark.parametrize("bs", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("pos,mb_rows,window", [
    ([0, 0], 4096, 4096),                # inactive slots sit at pos 0
    ([4095, 100], 4096, 4096),           # pos at the table's last row
    ([700, 40], 1024, 100),              # window low edge mid-block
    ([170, 176, 182, 188], 4096, 4096),  # the tick's depths
    ([4095, 2047, 130, 0], 4096, 4096),  # ragged, the deep phase-2 mix
    ([511, 0, 100], 512, None),
    ([299, 100], 320, 37),
])
def test_decode_split_reads_each_live_row_once(pos, mb_rows, window, bs):
    """The tensor-core paged decode kernel's work split over the table
    (cluster size from the table span, as the wrapper passes it, and
    every smaller one the launch may fall back to): the warps' slices
    cover each live row exactly once; the table entries it loads are
    those of live columns only, [lo // bs, hi // bs], each live column's
    at least once; an int8 pool's scales are loaded once a block in each
    slice that touches the block, never for a dead column; the f32
    kernel's whole-block chunks cover the live rows once."""
    mb = mb_rows // bs
    for p in pos:
        lo, hi = _live_bounds(p, mb * bs, window)
        assert (lo // bs, hi // bs) == _decode_lo_hi(min(p, mb * bs - 1), bs,
                                                     window)
        for cluster in range(1, _cluster_size(mb * bs) + 1):
            plan = _warp_slices(lo, hi, cluster)
            rows = sorted(r for spans in plan.values() for a, b in spans
                          for r in range(a, b + 1))
            assert rows == list(range(lo, hi + 1))
            reads = _table_reads(lo, hi, bs, cluster)
            entries = set()
            for key, per_slice in reads.items():
                for (a, b), (cols, scale_cols) in zip(plan[key], per_slice):
                    assert cols == sorted({r // bs for r in range(a, b + 1)})
                    assert all(lo // bs <= c <= hi // bs for c in cols)
                    assert sorted(scale_cols) == cols  # once a block
                    entries |= set(cols)
            assert entries == set(range(lo // bs, hi // bs + 1))
            chunks = _f32_chunks(lo, hi, cluster, bs)
            covered = [r for c in chunks if c is not None
                       for r in range(c[0], c[1] + 1)]
            assert covered == list(range(lo, hi + 1))
            for c in chunks:
                if c is not None and c[0] > lo:
                    assert c[0] % bs == 0  # a rank starts on a block edge


def test_split_count_results_are_pinned_for_the_prefill():
    """The prefill's launch plan on a card of 132 SMs and beside it:
    clusters of up to 8 CTAs of 64 rows, enough for two CTAs an SM,
    fewer where the table span holds fewer 64-column tiles or the grid
    alone fills the card."""
    # The phase-5 chunk of Mistral-7B: 32 CTAs of 64 rows, 8 ranks each.
    assert _prefill_plan(132, 1, 32, 8, 64, 16, 256) == 8
    # A decode round at T=1 (pp's stages): 8 CTAs.
    assert _prefill_plan(132, 1, 32, 8, 1, 16, 256) == 8
    assert _prefill_plan(132, 4, 32, 8, 5, 16, 64) == 8
    assert _prefill_plan(132, 1, 32, 8, 64, 16, 4) == 1
    # A 512-token chunk: 256 CTAs, so 2 ranks fill two an SM.
    assert _prefill_plan(132, 1, 32, 8, 512, 16, 256) == 2
    assert _prefill_plan(132, 64, 32, 8, 512, 16, 256) == 1
    assert _prefill_plan(16, 1, 8, 8, 16, 16, 32) == 4
    assert _prefill_plan(1, 1, 4, 2, 3, 4, 4) == 1
