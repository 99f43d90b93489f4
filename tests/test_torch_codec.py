"""runtime/codec.py through both packages: the frames are the same
bytes, so each package decodes what the other encoded.

Arrays are numpy draws from a fixed seed. Lossless schemes (0 raw, 1
native zstd, 2 zlib fallback) must round-trip exactly; the int8 scheme
(3) within its bound, amax/127 per tensor (half a step of rounding, plus
the rounding of the target dtype: for bfloat16 that is 2^-8 of the
value).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from defer_tpu.runtime import codec as jcodec
from defer_tpu_torch.obs.metrics import get_registry
from defer_tpu_torch.runtime import codec
from defer_tpu_torch.utils import native

DTYPES = [np.float32, np.float16, np.int8, np.int32, np.uint8, np.bool_]
SCHEMES = [0, 1, 2, 3]


def _array(dtype, shape=(3, 5, 7), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(shape) > 0.5
    return (rng.standard_normal(shape) * 20).astype(dtype)


@pytest.fixture
def scheme_of(monkeypatch):
    """Set both packages' encoders up for one scheme; returns the
    encode keyword arguments."""

    def setup(scheme):
        if scheme == 2:
            # Both packages without their native library: the zlib path.
            monkeypatch.setattr(codec, "load_native", lambda: None)
            monkeypatch.setattr(jcodec, "load_native", lambda: None)
        return {"level": 0} if scheme == 0 else (
            {"quantize": "int8"} if scheme == 3 else {}
        )

    return setup


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_frames_cross_the_packages(scheme_of, dtype, scheme):
    a = _array(dtype)
    kw = scheme_of(scheme)
    if scheme == 3 and not np.issubdtype(a.dtype, np.floating):
        for enc in (codec.encode, jcodec.encode):
            with pytest.raises(ValueError, match="floating"):
                enc(a, **kw)
        return
    frame, jframe = codec.encode(a, **kw), jcodec.encode(a, **kw)
    # One wire: the port writes the reference's bytes.
    assert frame == jframe
    assert codec.frame_schemes(frame)[0] == scheme
    if scheme == 3:
        assert codec.frame_schemes(frame) == (3, 1)
        want = jcodec.decode(jframe)
        np.testing.assert_array_equal(codec.decode(jframe).numpy(), want)
        bound = np.abs(a).max() / 127 * 0.5 + np.abs(a).max() * 2**-10
        assert np.abs(want.astype(np.float64) - a).max() <= bound
    else:
        np.testing.assert_array_equal(jcodec.decode(frame), a)
        got = codec.decode(jframe)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), a)
    # A torch tensor encodes to the same frame as its numpy array.
    assert codec.encode(torch.from_numpy(a), **kw) == frame


@pytest.mark.parametrize("scheme", SCHEMES)
def test_bfloat16_round_trip_and_the_reference_reads_it(scheme_of, scheme):
    x = torch.from_numpy(_array(np.float32, (4, 33))).to(torch.bfloat16)
    frame = codec.encode(x, **scheme_of(scheme))
    back = codec.decode(frame)
    assert back.dtype == torch.bfloat16 and back.shape == x.shape
    # The reference decodes the 'bfloat16' field through ml_dtypes.
    ref = jcodec.decode(frame)
    assert ref.dtype == np.dtype(ml_dtypes.bfloat16)
    if scheme == 3:
        amax = x.float().abs().max().item()
        err = (back.float() - x.float()).abs().max().item()
        assert err <= amax / 127 * 0.5 + amax * 2**-8
    else:
        assert torch.equal(back.view(torch.int16), x.view(torch.int16))
        # 2 bytes an element, never widened to f32 on the wire.
        assert frame[5:5 + len(codec.BF16)] == b"bfloat16"
    np.testing.assert_array_equal(
        ref.astype(np.float32), back.float().numpy()
    )


def test_bfloat16_from_an_ml_dtypes_array():
    a = _array(np.float32, (6,)).astype(ml_dtypes.bfloat16)
    back = codec.decode(codec.encode(a))
    np.testing.assert_array_equal(back.float().numpy(), a.astype(np.float32))


def test_the_references_bfloat16_frame_is_refused_by_name():
    a = _array(np.float32, (6,)).astype(ml_dtypes.bfloat16)
    jframe = jcodec.encode(a)
    assert b"<V2" in jframe[:10]
    with pytest.raises(ValueError, match="JAX package's codec.*bfloat16"):
        codec.decode(jframe)


def test_native_library_builds_into_the_package_build_dir():
    lib = codec.load_native()
    assert lib is not None
    path = native.library_path("codec.cpp", codec._LIBS)
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "defer_tpu_torch"


def test_counters_book_raw_and_encoded_bytes():
    reg = get_registry()
    raw0 = reg.value("defer_codec_raw_bytes_total")
    enc0 = reg.value("defer_codec_encoded_bytes_total")
    a = np.zeros((256, 256), np.float32)
    frame = codec.encode(a)
    q = codec.encode(a, quantize="int8")
    assert reg.value("defer_codec_raw_bytes_total") - raw0 == 2 * a.nbytes
    assert (reg.value("defer_codec_encoded_bytes_total") - enc0
            == len(frame) + len(q))
    assert len(frame) < a.nbytes // 50


@pytest.mark.parametrize("shape", [(), (0,), (0, 3), (1,), (2, 1, 3)])
def test_edge_shapes(shape):
    a = _array(np.float32, shape) if 0 not in shape else np.zeros(
        shape, np.float32
    )
    for kw in ({}, {"level": 0}, {"quantize": "int8"}):
        frame = codec.encode(a, **kw)
        assert frame == jcodec.encode(a, **kw)
        back = codec.decode(frame)
        # A 0-d numpy array rides as shape (1,) in both packages (numpy's
        # ascontiguousarray); a 0-d tensor keeps its shape.
        assert back.shape == jcodec.decode(frame).shape
        assert back.dtype == torch.float32
        t = torch.from_numpy(np.array(a))
        assert codec.decode(codec.encode(t, **kw)).shape == t.shape


def test_q8_refuses_non_finite_and_unknown_modes():
    a = np.array([1.0, np.nan], np.float32)
    with pytest.raises(ValueError, match="finite"):
        codec.encode(a, quantize="int8")
    with pytest.raises(ValueError, match="unknown quantize"):
        codec.encode(a, quantize="int4")
    # The lossless path keeps them.
    back = codec.decode(codec.encode(a)).numpy()
    assert back[0] == 1.0 and np.isnan(back[1])


def test_bad_frames_raise():
    with pytest.raises(ValueError, match="not a defer_tpu codec frame"):
        codec.decode(b"XX\x01")
    frame = bytearray(codec.encode(np.arange(10, dtype=np.int32)))
    frame[2] = 9
    with pytest.raises(ValueError, match="version"):
        codec.decode(bytes(frame))
    good = codec.encode(np.arange(100, dtype=np.int32))
    with pytest.raises(ValueError, match="corrupt"):
        codec.decode(good[:-5])
    with pytest.raises(ValueError, match="CPU tensor"):
        codec.encode(torch.zeros(3, device="meta"))
