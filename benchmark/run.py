"""The benchmark of `defer_tpu_torch`: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout on a machine with the cards the cell
asks for (`BENCHMARK.json`), and prints one JSON object as the last line
of its standard output: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, with `--trace 1` a `breakdown`, and last `check`, each number
compared beside its limit (also the last lines of standard error).

Exits non-zero with no result line where there is no CUDA card, fewer
cards than the cell needs, the package under test is missing, or JAX or
the JAX package was loaded. The cell, its configuration, traffic,
metric readers and reference are found by name under `benchmark/`
(`harness.py`).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """Build caches inside the checkout at fixed paths; nothing that
    could load JAX; the program's own trace switch off."""
    cache = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("DEFER_TPU_TRACE", None)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    # The script's own directory first on the path would let a file here
    # shadow a module of the same name; the checkout's root goes there.
    sys.path[0] = ROOT
    from benchmark import harness

    return harness.main(args.workload, args.seed, args.seconds,
                        bool(args.trace), t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
