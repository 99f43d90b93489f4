"""Package CLI: `python -m defer_tpu_torch <command>` (counterpart of
`defer_tpu/__main__.py`).

The reference has no tooling surface at all (drivers are edited by
hand, reference src/test.py:13-28); these subcommands cover the
workflows its users actually performed manually:

    info         the CUDA devices (name, memory, power limit) and the
                 registered models/ops
    partition    compute a cut list (the reference documents its own
                 in a comment, src/test.py:24-28)
    roofline     analytic perf triage for a zoo model on a card
    serve-stage  run a remote stage worker (the `node.py` analogue)
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess


def _power_limits() -> list[str]:
    """Each card's power limit as nvidia-smi reports it (empty when
    nvidia-smi is absent)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return []
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def cmd_info(args: argparse.Namespace) -> None:
    import torch

    from defer_tpu_torch.models import model_names
    from defer_tpu_torch.ops import op_names

    devices = []
    if torch.cuda.is_available():
        limits = _power_limits()
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            devices.append({
                "index": i,
                "name": props.name,
                "memory_bytes": props.total_memory,
                "power_limit": limits[i] if i < len(limits) else None,
            })
    print(json.dumps(
        {
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "devices": devices,
            "models": model_names(),
            "num_ops": len(op_names()),
        },
        indent=2,
    ))


def _init_params(model):
    import torch

    return model.init(torch.Generator().manual_seed(0))


def cmd_partition(args: argparse.Namespace) -> None:
    from defer_tpu_torch.graph.partition import partition
    from defer_tpu_torch.models import get_model
    from defer_tpu_torch.utils.flops import balanced_cuts, flops_by_node

    model = get_model(args.model)
    params = _init_params(model)
    shape = (1, *model.input_shape)
    if args.auto:
        cuts = balanced_cuts(
            model.graph,
            params,
            shape,
            args.stages,
            model.cut_candidates or None,
            input_dtype=model.input_dtype,
        )
    else:
        cuts = model.default_cuts(args.stages)
    stages = partition(model.graph, cuts) if cuts else [model.graph]
    per = flops_by_node(
        model.graph, params, shape, input_dtype=model.input_dtype
    )
    total = sum(per.values())
    print(f"{args.model}: {args.stages} stages, cuts = {list(cuts)}")
    for i, s in enumerate(stages):
        fl = sum(per[n.name] for n in s.nodes if n.op != "input")
        print(
            f"  stage {i}: {len(s.nodes):4d} nodes, "
            f"{fl / 1e9:8.2f} GFLOP ({fl / total:5.1%})"
        )


def cmd_roofline(args: argparse.Namespace) -> None:
    import torch

    from defer_tpu_torch.config import DeferConfig
    from defer_tpu_torch.models import get_model
    from defer_tpu_torch.parallel.pipeline import cast_params_to_storage
    from defer_tpu_torch.utils.roofline import format_report, roofline_report

    kind = args.device_kind
    if kind is None:
        if not torch.cuda.is_available():
            raise SystemExit(
                "roofline: no CUDA device to take the peak rates from; "
                "name the card with --device-kind"
            )
        kind = torch.cuda.get_device_name(0)
    model = get_model(args.model)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    params = cast_params_to_storage(
        _init_params(model), DeferConfig(compute_dtype=dtype)
    )
    # Token ids stay integral.
    in_dtype = dtype if model.input_dtype.is_floating_point else (
        model.input_dtype
    )
    print(
        format_report(
            roofline_report(
                model.graph,
                params,
                (args.batch, *model.input_shape),
                kind,
                input_dtype=in_dtype,
                top=args.top,
            )
        )
    )


def cmd_serve_stage(args: argparse.Namespace) -> None:
    from defer_tpu_torch.runtime.remote_stage import main as serve_main

    argv = ["--listen", str(args.listen), "--next", args.next]
    if args.accept_timeout is not None:
        argv += ["--accept-timeout", str(args.accept_timeout)]
    if args.handoff_timeout is not None:
        argv += ["--handoff-timeout", str(args.handoff_timeout)]
    if args.expect_peer:
        argv += ["--expect-peer"]
    if args.device is not None:
        argv += ["--device", args.device]
    serve_main(argv)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="defer_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("info", help="CUDA devices + registered models/ops")

    p = sub.add_parser("partition", help="compute and describe a cut list")
    p.add_argument("model")
    p.add_argument("--stages", type=int, default=2)
    p.add_argument(
        "--auto",
        action="store_true",
        help="FLOPs-balanced cuts instead of the model's defaults",
    )

    p = sub.add_parser("roofline", help="analytic perf triage")
    p.add_argument("model")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument(
        "--device-kind",
        default=None,
        help="e.g. 'NVIDIA H100 80GB HBM3'; default: the first CUDA device",
    )
    p.add_argument("--top", type=int, default=8)

    p = sub.add_parser(
        "serve-stage", help="run a remote stage worker (node.py analogue)"
    )
    p.add_argument("--listen", type=int, default=5000)
    p.add_argument("--next", required=True)
    p.add_argument("--accept-timeout", type=float, default=None)
    p.add_argument("--handoff-timeout", type=float, default=None)
    p.add_argument(
        "--expect-peer",
        action="store_true",
        help="mid-chain worker: a missing upstream activation peer is "
        "a hard error, not a clean zero-work exit",
    )
    p.add_argument(
        "--device",
        default=None,
        help="e.g. cuda:0 or cpu (default: the first CUDA device)",
    )

    args = ap.parse_args(argv)
    {
        "info": cmd_info,
        "partition": cmd_partition,
        "roofline": cmd_roofline,
        "serve-stage": cmd_serve_stage,
    }[args.cmd](args)


if __name__ == "__main__":
    main()
