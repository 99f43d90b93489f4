"""Distributed pipeline-inference driver: the reference's `test.py` user
model on the port (reference src/test.py:20-58; counterpart of
examples/distributed_infer.py).

Where the reference hard-codes two compute-node IPs and ships sub-models
over sockets, this places the stages on the cards of this process (round
robin: with one card every stage sits on cuda:0); the queue-in/queue-out
contract and the cut-list knob are unchanged, so a reference user's
driver ports line for line.

    python -m defer_tpu_torch.examples.distributed_infer --model resnet50 --minutes 1
    python -m defer_tpu_torch.examples.distributed_infer --cuts add_2,add_4,add_6,add_8
    python -m defer_tpu_torch.examples.distributed_infer --images examples/images

Inputs are real decoded images (PIL -> preprocess -> batch -> device
prefetch), cycled for the duration of the run: the reference's
image-feed loop (reference src/test.py:13-16,52-54) with a directory
instead of one hard-coded JPEG. --synthetic feeds ones instead.
"""

from __future__ import annotations

import argparse
import itertools
import queue
import threading
import time

import torch

from defer_tpu_torch.api import DEFER
from defer_tpu_torch.config import DeferConfig
from defer_tpu_torch.examples import _launch
from defer_tpu_torch.models import get_model
from defer_tpu_torch.runtime.data import (
    batched,
    imagenet_preprocess,
    load_image_dir,
    prefetch_to_device,
    preprocess_mode,
)


def image_stream(images_dir: str, model, batch: int, device):
    """Decode -> preprocess -> batch -> device-prefetch, cycling the
    directory forever (static shapes; prefetch overlaps host decode +
    transfer with the card's compute)."""
    mode = preprocess_mode(model.name)
    size = model.input_shape[0]

    def examples():
        for im in itertools.cycle(load_image_dir(images_dir)):
            # bf16 on the host: halves the host-to-device transfer and
            # matches the pipeline compute dtype (no device cast pass).
            yield imagenet_preprocess(
                im, size=size, mode=mode, out_dtype=torch.bfloat16
            )[0]

    return prefetch_to_device(batched(examples(), batch), device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="resnet50")
    ap.add_argument(
        "--cuts",
        default=None,
        help="comma-separated cut layers (reference test.py's part_at), "
        "or 'auto' for FLOPs-balanced boundaries; default: one stage "
        "per device from the model's candidate list",
    )
    ap.add_argument("--minutes", type=float, default=5.0)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument(
        "--images",
        default=_launch.IMAGES,
        help="directory of images to cycle through the pipeline",
    )
    ap.add_argument(
        "--synthetic",
        action="store_true",
        help="feed ones instead of decoding real images",
    )
    ap.add_argument(
        "--weights",
        default=None,
        help='real checkpoint for the pipeline: "imagenet", "random", '
        "or a Keras save_weights .h5 path (default: fresh init, as the "
        "throughput numbers don't depend on the values)",
    )
    _launch.add_device_flag(ap)
    return ap


def run(args: argparse.Namespace, *, params=None,
        compute_dtype=None) -> dict:
    """Stream the feed through the pipeline for --minutes; returns the
    result count, images/s over the whole window (set-up included, as the
    JAX example prints), images/s from the first result on (with two
    results or more), the stage count and the first result."""
    devs = _launch.devices(args)
    model = get_model(args.model)
    if args.weights:
        from defer_tpu_torch.models.pretrained import (
            PretrainedUnavailable,
            load_pretrained,
        )
        from defer_tpu_torch.models.transplant import TransplantError

        try:
            model, params, _ = load_pretrained(
                args.model, args.weights, device=devs[0]
            )
            print(f"{args.model}: weights from {args.weights}")
        except PretrainedUnavailable as e:
            print(f"pretrained weights unavailable ({e}); using fresh init")
        except TransplantError as e:
            raise SystemExit(
                f"checkpoint did not match the {args.model} graph: {e}"
            ) from e
    n_dev = len(devs)
    if args.cuts == "auto":
        cuts = "auto"
        n_stages = n_dev
        print(f"{args.model}: auto (FLOPs-balanced) stages over "
              f"{n_dev} device(s)")
    else:
        cuts = (
            args.cuts.split(",")
            if args.cuts
            else model.default_cuts(min(n_dev, len(model.cut_candidates) + 1))
        )
        n_stages = len(cuts) + 1
        print(f"{args.model}: {n_stages} stages over {n_dev} device(s)")
    if not args.synthetic:
        _launch.require_pil("distributed_infer")

    config = DeferConfig()
    if compute_dtype is not None:
        config = config.replace(compute_dtype=compute_dtype)
    defer = DEFER(devices=devs, config=config)
    # The reference sizes these 10 deep for backpressure (test.py:44-45).
    input_q: queue.Queue = queue.Queue(10)
    output_q: queue.Queue = queue.Queue()
    if args.synthetic:
        # Placed once, as the JAX example's device-resident ones.
        feed = itertools.repeat(model.example_input(args.batch).to(devs[0]))
    else:
        feed = image_stream(args.images, model, args.batch, devs[0])

    run_s = args.minutes * 60
    res: dict = {"stages": n_stages}
    failed: list = []

    # analysis: domain(serving) the pipeline's stream loop; this thread and
    # the driver's share only the queues
    def pipeline() -> None:
        try:
            defer.run_defer(model, cuts, input_q, output_q, params=params)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failed.append(e)

    def print_result(q: queue.Queue) -> None:
        res_count = 0
        while (out := q.get()) is not None:
            if res_count == 0:
                res["first_output"] = out
                first_at = time.time()
            res_count += 1
        end = time.time()
        images = res_count * args.batch
        res["count"] = res_count
        res["images_per_sec"] = images / (end - start)
        print(f"{res_count} results in {args.minutes} min")
        print(f"Throughput: {res['images_per_sec']:.2f} images/sec")
        if res_count > 1:
            # The results after the first over the time after it: the
            # rate without the pipeline's build and first calls, as
            # local_infer's baseline times its loop after a warm-up.
            res["steady_images_per_sec"] = (
                (res_count - 1) * args.batch / (end - first_at))
            print(f"Steady throughput from the first result: "
                  f"{res['steady_images_per_sec']:.2f} images/sec")
        if defer.last_stage_latencies:
            for r in defer.last_stage_latencies:
                print(
                    f"  stage {r['stage']}: p50 {r['p50_s'] * 1e3:.2f} ms "
                    f"max {r['max_s'] * 1e3:.2f} ms"
                )

    a = threading.Thread(target=pipeline, daemon=True)
    b = threading.Thread(target=print_result, args=(output_q,))
    start = time.time()
    a.start()
    b.start()

    try:
        while (time.time() - start) < run_s and a.is_alive():
            try:
                # blocks at depth 10: backpressure, as in test.py:52
                input_q.put(next(feed), timeout=1.0)
            except queue.Full:
                continue
    finally:
        # Always flow the sentinels, even when the image feed raises:
        # otherwise the result thread blocks on output_q forever and the
        # process never exits. The pipeline drains in-flight results on
        # the way out.
        while a.is_alive():
            try:
                input_q.put(None, timeout=1.0)
                break
            except queue.Full:
                continue
        a.join()
        output_q.put(None)
        b.join()
    if failed:
        raise RuntimeError("the pipeline failed") from failed[0]
    return res


def main(argv=None) -> None:
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
