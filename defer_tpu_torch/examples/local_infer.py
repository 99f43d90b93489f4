"""Single-device baseline: the reference's `local_infer.py` on the port
(reference src/local_infer.py:16-23: loop model.predict, count results;
counterpart of examples/local_infer.py).

This defines the denominator of every pipeline speedup claim.

    python -m defer_tpu_torch.examples.local_infer --model resnet50 --minutes 1
    python -m defer_tpu_torch.examples.local_infer --synthetic --batch 32
"""

from __future__ import annotations

import argparse
import itertools

import torch

from defer_tpu_torch.api import run_local_inference
from defer_tpu_torch.examples import _launch
from defer_tpu_torch.models import get_model


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument(
        "--images",
        default=_launch.IMAGES,
        help="directory of real images for the looped batch; "
        "--synthetic feeds ones instead",
    )
    ap.add_argument("--synthetic", action="store_true")
    _launch.add_device_flag(ap)
    return ap


def run(args: argparse.Namespace, *, params=None,
        compute_dtype=None) -> dict:
    """Loop the whole model on one device for --minutes; returns
    run_local_inference's numbers (its "output": the looped batch's
    result)."""
    dev = _launch.device(args)
    model = get_model(args.model)
    example = None
    is_image_model = (
        len(model.input_shape) == 3 and model.input_shape[-1] == 3
    )
    if not args.synthetic and is_image_model:
        # The reference preprocesses one real image and loops on it
        # (reference src/local_infer.py:10-14); same here, batched,
        # with the preprocessing the model's weights expect.
        from defer_tpu_torch.runtime.data import (
            imagenet_preprocess,
            load_image_dir,
            preprocess_mode,
        )

        _launch.require_pil("local_infer")
        imgs = itertools.cycle(load_image_dir(args.images))
        example = torch.cat(
            [
                imagenet_preprocess(
                    next(imgs),
                    size=model.input_shape[0],
                    mode=preprocess_mode(model.name),
                )
                for _ in range(args.batch)
            ]
        )

    stats = run_local_inference(
        model,
        batch_size=args.batch,
        duration_s=args.minutes * 60,
        params=params,
        compute_dtype=compute_dtype,
        example=example,
        device=dev,
    )
    print(f"{stats['count']:.0f} results in {args.minutes} min")
    print(f"Throughput: {stats['items_per_sec']:.2f} images/sec")
    return stats


def main(argv=None) -> None:
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
