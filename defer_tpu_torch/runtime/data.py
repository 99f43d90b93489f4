"""Host input pipeline: preprocessing + device prefetch (counterpart of
`defer_tpu/runtime/data.py`).

The reference's drivers load and preprocess one image with PIL on the
host and re-feed the same tensor forever (reference src/test.py:13-16,
src/local_infer.py:10-14). Here the host side of the feed is a real
component:

  * `imagenet_preprocess` — the zoo models' input transform (resize,
    center-crop, scale) on host arrays, batched, into a CPU tensor;
  * `batched` — group an example stream into fixed-size batches;
  * `prefetch_to_device` — a bounded background thread that copies each
    batch into pinned host memory and issues its host-to-device copy on
    a side stream, `depth` items ahead, overlapping the transfer with
    the card's compute (the reference's decoupled feed thread,
    reference src/dispatcher.py:99-103, minus the socket).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Iterable, Iterator, Sequence

import numpy as np
import torch

from defer_tpu_torch.parallel.mesh import cuda_devices
from defer_tpu_torch.parallel.pipeline import resolve_device
from defer_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def imagenet_preprocess(
    images: Any,
    *,
    size: int = 224,
    mode: str = "scale",
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """uint8/float HWC (or NHWC) images -> float32 NHWC model input on
    the host (or `out_dtype`, e.g. torch.bfloat16 — casting on the host
    halves the host-to-device transfer).

    mode="scale": x/127.5 - 1 (the MobileNet/Inception family
    convention). mode="caffe": BGR mean subtraction (ResNet50/VGG
    Keras weights convention). mode="unit": x/255 (EfficientNet).
    """
    x = images.numpy() if isinstance(images, torch.Tensor) else np.asarray(
        images
    )
    if x.ndim == 3:
        x = x[None]
    if x.ndim != 4:
        raise ValueError(f"expected HWC or NHWC images, got shape {x.shape}")
    if x.dtype == np.uint8:
        # Fast path: the fused native C++ pass (resize+crop+affine in
        # one multithreaded sweep, native/imageproc.cpp).
        from defer_tpu_torch.runtime.native_image import native_preprocess

        out = native_preprocess(x, size=size, mode=mode, out_dtype=out_dtype)
        if out is not None:
            return out
    x = x.astype(np.float32)
    if x.shape[1] != size or x.shape[2] != size:
        x = _resize_center_crop(x, size)
    if mode == "scale":
        x = x / 127.5 - 1.0
    elif mode == "unit":
        x = x / 255.0
    elif mode == "caffe":
        # RGB -> BGR, subtract ImageNet channel means.
        x = x[..., ::-1] - np.array([103.939, 116.779, 123.68], np.float32)
    else:
        raise ValueError(f"unknown preprocess mode {mode!r}")
    out = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return out.to(out_dtype) if out_dtype is not None else out


def _resize_center_crop(x: np.ndarray, size: int) -> np.ndarray:
    """Resize the short side to `size`, then center-crop to size x size
    (pure numpy: host preprocessing must not touch the card the pipeline
    runs on)."""
    n, h, w, c = x.shape
    scale = size / min(h, w)
    nh, nw = max(size, round(h * scale)), max(size, round(w * scale))
    resized = _bilinear_resize_np(x, nh, nw)
    top, left = (nh - size) // 2, (nw - size) // 2
    return resized[:, top : top + size, left : left + size, :]


def _bilinear_resize_np(x: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Vectorized half-pixel-centered bilinear resize, NHWC (TF2
    'bilinear' semantics)."""
    n, h, w, c = x.shape
    ys = np.clip((np.arange(nh) + 0.5) * h / nh - 0.5, 0, h - 1)
    xs = np.clip((np.arange(nw) + 0.5) * w / nw - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0).astype(x.dtype)[None, :, None, None]
    wx = (xs - x0).astype(x.dtype)[None, None, :, None]
    top = x[:, y0][:, :, x0] * (1 - wx) + x[:, y0][:, :, x1] * wx
    bot = x[:, y1][:, :, x0] * (1 - wx) + x[:, y1][:, :, x1] * wx
    return top * (1 - wy) + bot * wy


# Keras-weights input conventions per zoo family (reference models use
# the preprocessing their checkpoints were trained with).
_CAFFE_MODELS = ("resnet50", "resnet101", "resnet152", "vgg16", "vgg19")


def preprocess_mode(model_name: str) -> str:
    """Which imagenet_preprocess mode a zoo model's weights expect."""
    if model_name in _CAFFE_MODELS:
        return "caffe"
    if model_name.startswith("efficientnet"):
        return "unit"  # Rescaling(1/255) lives in the real Keras model
    return "scale"


def load_image_dir(
    path: str,
    *,
    extensions: Sequence[str] = (".png", ".jpg", ".jpeg", ".bmp"),
    with_names: bool = False,
) -> Iterator[Any]:
    """Decode every image in a directory (sorted order) to uint8 HWC
    RGB numpy arrays — the reference's PIL input path (reference
    src/test.py:13-16) as a stream instead of one hard-coded file.
    with_names=True yields (filename, array) pairs instead. Needs PIL
    (imported here, not at module import)."""
    from PIL import Image

    names = sorted(
        f for f in os.listdir(path)
        if os.path.splitext(f)[1].lower() in extensions
    )
    if not names:
        raise FileNotFoundError(f"no images with {extensions} under {path!r}")
    for name in names:
        with Image.open(os.path.join(path, name)) as im:
            arr = np.asarray(im.convert("RGB"))
        yield (name, arr) if with_names else arr


def batched(
    examples: Iterable[Any],
    batch_size: int,
    *,
    drop_remainder: bool = True,
) -> Iterator[torch.Tensor]:
    """Stack an example stream (arrays or tensors) into fixed-size CPU
    tensor batches (static shapes; a short tail is dropped by default)."""
    buf: list[torch.Tensor] = []
    for ex in examples:
        buf.append(torch.as_tensor(ex))
        if len(buf) == batch_size:
            yield torch.stack(buf)
            buf = []
    if buf and not drop_remainder:
        yield torch.stack(buf)
    elif buf:
        log.info("batched: dropped %d-example tail batch", len(buf))


_STOP = object()


class _Error:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_to_device(
    it: Iterable[Any],
    device: Any = None,
    *,
    depth: int = 2,
) -> Iterator[torch.Tensor]:
    """Iterate `it`, staging each item on `device` (default: the first
    CUDA device) `depth` items ahead in a background thread.

    On a card each item is copied into pinned host memory, and its copy
    to the device is issued `non_blocking` on a side stream with an
    event recorded after it; the consumer's stream waits on that event
    (no host wait) before the item is yielded. On the CPU items pass
    through as tensors. Exceptions from the source iterator re-raise at
    the consumption point; the thread always terminates."""
    dev = resolve_device(device) if device is not None else cuda_devices()[0]
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
    abandoned = threading.Event()

    def _put(item: Any) -> bool:
        """put that gives up when the consumer is gone, so the feeder
        thread (and the source iterator + staged buffers it holds)
        always terminates."""
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def stage(item: Any) -> tuple[torch.Tensor, Any]:
        t = torch.as_tensor(item)
        if side is None:
            return t.to(dev), None
        pinned = t.pin_memory()
        with torch.cuda.stream(side):
            out = pinned.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    # analysis: domain(prefetch) stages host batches onto the card; results
    # cross to the consumer only through the queue
    def feed() -> None:
        try:
            for item in it:
                if not _put(stage(item)):
                    return
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            _put(_Error(e))
            return
        _put(_STOP)

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _STOP:
                return
            if isinstance(item, _Error):
                raise item.exc
            out, done = item
            if done is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(done)
                # The tensor was allocated on the side stream; tell the
                # allocator the consumer's stream uses it too.
                out.record_stream(stream)
            yield out
    finally:
        # Runs on normal exhaustion, consumer error, or GeneratorExit
        # (abandoned partial read) — unblocks the feeder either way.
        abandoned.set()
