"""Pretrained-weights end-to-end demo: real Keras ResNet50 checkpoint
-> transplant -> classify real images -> single-device and pipelined
runs must agree on top-1 (reference src/local_infer.py:8-23;
counterpart of examples/pretrained_infer.py).

    python -m defer_tpu_torch.examples.pretrained_infer                    # imagenet (cache/net)
    python -m defer_tpu_torch.examples.pretrained_infer --weights PATH.h5  # local checkpoint
    python -m defer_tpu_torch.examples.pretrained_infer --weights random   # offline: real
        tf.keras model with fresh weights; still proves the transplant
        numerically by cross-checking against TF's own forward.

With no network, no ~/.keras cache and no --weights, the demo SKIPS
cleanly (exit 0, "SKIP" line) instead of half-running.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading

import numpy as np
import torch

from defer_tpu_torch.examples import _launch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="resnet50")
    ap.add_argument(
        "--weights",
        default="imagenet",
        help='"imagenet", "random", or a Keras save_weights .h5 path',
    )
    ap.add_argument("--images", default=_launch.IMAGES)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument(
        "--model-json",
        default=None,
        help="model.to_json() text file: required to resolve layer "
        "names in Keras 3 .weights.h5 checkpoints",
    )
    _launch.add_device_flag(ap)
    return ap


def run(args: argparse.Namespace, *, params=None,
        compute_dtype=None) -> dict:
    """Returns {"code": the exit code, "skipped": bool, and on success
    the top-1 indices of the single-device and pipelined runs}."""
    devs = _launch.devices(args)
    from defer_tpu_torch.models.pretrained import (
        PretrainedUnavailable,
        load_pretrained,
    )
    from defer_tpu_torch.models.transplant import TransplantError

    try:
        model, loaded, tf_model = load_pretrained(
            args.model, args.weights, model_json=args.model_json,
            device=devs[0],
        )
    except PretrainedUnavailable as e:
        print(f"SKIP: pretrained weights unavailable ({e})")
        return {"code": 0, "skipped": True}
    except TransplantError as e:
        print(
            f"ERROR: checkpoint did not match the {args.model} graph "
            f"({e}). Keras 3 .weights.h5 files need --model-json "
            "<file containing model.to_json()>."
        )
        return {"code": 2, "skipped": False}
    params = loaded if params is None else params

    from defer_tpu_torch.runtime.data import (
        imagenet_preprocess,
        load_image_dir,
        preprocess_mode,
    )

    _launch.require_pil("pretrained_infer")
    names, imgs = [], []
    for fname, arr in load_image_dir(args.images, with_names=True):
        names.append(fname)
        imgs.append(arr)
    if not imgs:
        print(f"SKIP: no images in {args.images}")
        return {"code": 0, "skipped": True}
    # imagenet_preprocess returns NHWC; one image in -> (1,H,W,C) out.
    batch = torch.cat(
        [
            imagenet_preprocess(
                a,
                size=model.input_shape[0],
                mode=preprocess_mode(model.name),
                out_dtype=torch.float32,
            )
            for a in imgs
        ]
    )

    # 1. Single-device forward.
    with torch.no_grad():
        y_single = model.graph.apply(params, batch.to(devs[0])).float().cpu()
    top1_single = y_single.argmax(-1).numpy()

    # 2. The same params streamed through the pipeline (queue-in /
    #    queue-out contract, reference src/test.py:30-41).
    from defer_tpu_torch.api import DEFER
    from defer_tpu_torch.config import DeferConfig

    config = DeferConfig()
    if compute_dtype is not None:
        config = config.replace(compute_dtype=compute_dtype)
    defer = DEFER(devices=devs, config=config)
    cuts = model.default_cuts(args.stages)
    inq: queue.Queue = queue.Queue()
    outq: queue.Queue = queue.Queue()

    # analysis: domain(serving) the pipeline's stream loop; this thread
    # shares only the queues with it
    def pipeline() -> None:
        defer.run_defer(model, cuts, inq, outq, params=params)

    t = threading.Thread(target=pipeline, daemon=True)
    t.start()
    inq.put(batch)
    inq.put(None)
    y_pipe = outq.get(timeout=600).float().cpu()
    t.join(timeout=120)
    top1_pipe = y_pipe.argmax(-1).numpy()

    assert (top1_single == top1_pipe).all(), (
        f"top-1 disagreement: single {top1_single} vs pipeline {top1_pipe}"
    )

    # 3. Cross-check against tf.keras' own forward when it is live.
    if tf_model is not None:
        y_tf = np.asarray(tf_model(batch.numpy(), training=False))
        top1_tf = y_tf.argmax(-1)
        assert (top1_single == top1_tf).all(), (
            f"top-1 disagreement vs tf.keras: {top1_single} vs {top1_tf}"
        )

    labels = _imagenet_labels()
    for n, idx, p in zip(names, top1_single, y_single.max(-1).values):
        label = labels[idx] if labels else f"class {idx}"
        print(f"{n}: top-1 {label} (index {idx}, p={float(p):.3f})")
    agree = "single==pipeline" + ("==tf.keras" if tf_model is not None else "")
    print(
        f"OK: {len(names)} images, {len(cuts) + 1}-stage pipeline, "
        f"top-1 agreement {agree}"
    )
    return {"code": 0, "skipped": False, "top1_single": top1_single,
            "top1_pipeline": top1_pipe, "tf_checked": tf_model is not None}


def _imagenet_labels() -> list[str] | None:
    """Class names from keras' imagenet_class_index.json when a keras
    cache holds it; None otherwise (indices are printed instead). Only
    the cached file is read: nothing is fetched."""
    home = os.environ.get("KERAS_HOME",
                          os.path.join(os.path.expanduser("~"), ".keras"))
    path = os.path.join(home, "models", "imagenet_class_index.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        index = json.load(f)
    return [index[str(i)][1] for i in range(1000)]


def main(argv=None) -> int:
    return run(parser().parse_args(argv))["code"]


if __name__ == "__main__":
    raise SystemExit(main())
