"""Pretrained-checkpoint loading for the model zoo (counterpart of
`defer_tpu/models/pretrained.py`).

Resolve a real Keras checkpoint (a `save_weights` HDF5 file, either
on-disk dialect, or tf.keras.applications' own pretrained cache), then
transplant it into the zoo graph through `keras_name_map` +
`load_keras_h5`.

Offline honesty: "imagenet" needs a populated ~/.keras cache or the
network; where neither exists `PretrainedUnavailable` is raised so that
callers can skip cleanly instead of half-running. "random" builds a REAL
tf.keras model with fresh weights, no network, which still proves the
whole checkpoint -> transplant -> inference path numerically (the TF
model is returned for comparison). tensorflow and h5py are imported only
inside the calls that need them: the port depends on neither.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any

import torch

from defer_tpu_torch.models import Model, get_model
from defer_tpu_torch.models.transplant import (
    KerasWeights,
    load_keras_h5,
    transplant,
)
from defer_tpu_torch.parallel.mesh import cuda_devices
from defer_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class PretrainedUnavailable(RuntimeError):
    """The requested checkpoint source cannot be produced here (no
    tensorflow, no network and no ~/.keras cache, ...)."""


def _tf_application(name: str):
    import tensorflow as tf

    apps = {
        "resnet50": tf.keras.applications.ResNet50,
        "vgg16": tf.keras.applications.VGG16,
        "mobilenetv2": tf.keras.applications.MobileNetV2,
        "efficientnet_b0": tf.keras.applications.EfficientNetB0,
    }
    if name not in apps:
        raise PretrainedUnavailable(
            f"no tf.keras.applications model wired for {name!r} "
            f"(have: {sorted(apps)})"
        )
    return apps[name]


def load_pretrained(
    name: str = "resnet50",
    weights: str = "imagenet",
    *,
    model_json: str | None = None,
    generator: torch.Generator | None = None,
    device: Any = None,
) -> tuple[Model, dict, Any]:
    """Zoo model `name` + params transplanted from a real checkpoint.

    weights: an .h5/.weights.h5 path (Keras `save_weights`, either
    dialect), "imagenet" (tf.keras.applications pretrained: cache or
    download), or "random" (a real tf.keras model with fresh weights, no
    network needed). The params land on `generator`'s device (one
    seeded 0 on `device` when None; `device` defaults to the first CUDA
    device and raises without one).

    Returns (model, params, tf_model); tf_model is the live Keras model
    when one was built (for output cross-checks), else None. Raises
    PretrainedUnavailable when the source cannot be produced; callers
    are expected to catch it and skip."""
    model = get_model(name)
    if model.keras_name_map is None:
        raise PretrainedUnavailable(
            f"zoo model {name!r} has no keras_name_map"
        )

    tf_model = None
    if weights in ("imagenet", "random"):
        try:
            app = _tf_application(name)
        except ImportError as e:
            raise PretrainedUnavailable(
                f"tensorflow is not importable ({e})"
            ) from e
        try:
            tf_model = app(
                weights="imagenet" if weights == "imagenet" else None
            )
        except Exception as e:  # noqa: BLE001 — download/cache failure
            raise PretrainedUnavailable(
                f"could not build {name}(weights={weights!r}): {e} — "
                "no network and no ~/.keras cache? Pass a local .h5 "
                "checkpoint path instead"
            ) from e
        fd, tmp = tempfile.mkstemp(suffix=".weights.h5")
        os.close(fd)
        try:
            tf_model.save_weights(tmp)
            layer_weights = load_keras_h5(tmp, tf_model.to_json())
        finally:
            os.unlink(tmp)
        src = f"tf.keras {name}({weights})"
    else:
        if not os.path.exists(weights):
            raise PretrainedUnavailable(
                f"checkpoint path {weights!r} does not exist"
            )
        # model_json may be the to_json() text or a path to it: the Keras
        # 3 .weights.h5 layout needs it to resolve per-class counter group
        # names to real layer names (load_keras_h5).
        if model_json is not None and os.path.exists(model_json):
            with open(model_json) as f:
                model_json = f.read()
        layer_weights = load_keras_h5(weights, model_json)
        src = weights

    # Init AFTER the cheap availability checks: every skip path above
    # must be near-free, not pay a full zoo-model init.
    if generator is None:
        dev = device if device is not None else cuda_devices()[0]
        generator = torch.Generator(device=dev).manual_seed(0)
    params = transplant(
        model.graph,
        model.init(generator),
        KerasWeights(layer_weights, name_map=model.keras_name_map),
        strict=True,
    )
    log.info("transplanted %s from %s", name, src)
    return model, params, tf_model
