"""runtime/data.py and runtime/native_image.py against the JAX package's:
the numpy preprocessing path gives the reference's values, the native
C++ pass (the port's own copy of imageproc.cpp, built into
defer_tpu_torch/_build/) stays within 1e-3 of it, and the feed helpers
keep order and terminate.

Images are numpy draws from a fixed seed. The numpy paths must agree
exactly (the same float32 ops in the same order); the native pass within
atol 1e-3 (its bilinear blend is summed in another order); bfloat16
outputs within one bf16 step of the float32 value.
"""

import numpy as np
import pytest
import torch

from defer_tpu.runtime import data as jdata
from defer_tpu_torch.runtime.data import (
    batched,
    imagenet_preprocess,
    load_image_dir,
    prefetch_to_device,
    preprocess_mode,
)
from defer_tpu_torch.runtime.native_image import (
    native_available,
    native_preprocess,
)
from defer_tpu_torch.utils import native

CPU = torch.device("cpu")
MODES = ["scale", "unit", "caffe"]
# (1, 89, 64, 3) pins half-to-even rounding of the resize (89 * 0.5).
SHAPES = [(2, 50, 70, 3), (1, 96, 40, 3), (1, 32, 32, 3), (1, 89, 64, 3)]


def _images(shape, seed=3):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_numpy_path_equals_the_reference(shape, mode):
    x = _images(shape).astype(np.float32)
    got = imagenet_preprocess(x, size=32, mode=mode)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), jdata.imagenet_preprocess(x, size=32, mode=mode)
    )


@pytest.mark.parametrize("mode", MODES)
def test_native_pass_within_1e3_of_numpy_and_the_reference(mode):
    assert native_available()
    lib = native.library_path("imageproc.cpp", ("-pthread",))
    assert lib.exists() and lib.parent.name == "_build"
    for shape in SHAPES:
        imgs = _images(shape)
        got = native_preprocess(imgs, size=32, mode=mode)
        want = imagenet_preprocess(imgs.astype(np.float32), size=32, mode=mode)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)
        np.testing.assert_allclose(
            imagenet_preprocess(imgs, size=32, mode=mode).numpy(),
            jdata.imagenet_preprocess(imgs, size=32, mode=mode), atol=1e-3,
        )
        got16 = native_preprocess(imgs, size=32, mode=mode,
                                  out_dtype=torch.bfloat16)
        assert got16.dtype == torch.bfloat16
        # One bf16 step (2^-8 relative) of the float32 value.
        step = want.abs() * 2**-8 + 1e-3
        assert bool(((got16.float() - want).abs() <= step).all())


def test_bfloat16_output_on_the_numpy_path():
    x = _images((1, 40, 40, 3)).astype(np.float32)
    got = imagenet_preprocess(x, size=32, out_dtype=torch.bfloat16)
    want = imagenet_preprocess(x, size=32)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


def test_preprocess_modes_and_errors_match_the_reference():
    for name in ("resnet50", "vgg19", "efficientnet_b0", "mobilenetv2"):
        assert preprocess_mode(name) == jdata.preprocess_mode(name)
    with pytest.raises(ValueError, match="unknown preprocess mode"):
        imagenet_preprocess(np.zeros((1, 8, 8, 3), np.float32), size=8,
                            mode="nope")
    with pytest.raises(ValueError, match="HWC"):
        imagenet_preprocess(np.zeros((8, 8), np.float32))


def test_load_image_dir_decodes_sorted(tmp_path):
    from PIL import Image

    for i, name in enumerate(["b.png", "a.png", "c.txt"]):
        if name.endswith(".png"):
            Image.fromarray(np.full((6, 5, 3), i * 40, np.uint8)).save(
                tmp_path / name)
        else:
            (tmp_path / name).write_text("x")
    got = list(load_image_dir(str(tmp_path), with_names=True))
    assert [n for n, _ in got] == ["a.png", "b.png"]
    assert got[0][1].shape == (6, 5, 3) and int(got[0][1][0, 0, 0]) == 40
    with pytest.raises(FileNotFoundError):
        list(load_image_dir(str(tmp_path / "..")))


def test_batched_drops_or_keeps_the_tail():
    ex = [np.full((2,), i, np.float32) for i in range(5)]
    out = list(batched(ex, 2))
    assert [b.shape for b in out] == [(2, 2), (2, 2)]
    assert isinstance(out[0], torch.Tensor)
    assert len(list(batched(ex, 2, drop_remainder=False))) == 3


def test_prefetch_keeps_order_and_relays_errors():
    items = [np.full((3,), i, np.int32) for i in range(6)]
    out = list(prefetch_to_device(iter(items), CPU, depth=2))
    assert [int(t[0]) for t in out] == list(range(6))
    assert all(isinstance(t, torch.Tensor) for t in out)

    def broken():
        yield np.zeros(1)
        raise RuntimeError("source died")

    with pytest.raises(RuntimeError, match="source died"):
        list(prefetch_to_device(broken(), CPU))


def test_prefetch_feeder_ends_when_the_consumer_leaves():
    import threading

    before = threading.active_count()
    gen = prefetch_to_device((np.zeros(2) for _ in range(1000)), CPU, depth=1)
    next(gen)
    gen.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


def test_prefetch_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: prefetch targets it")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch_to_device(iter([])))
