"""The control of `correct`: the reference in fp8 put in the program's
place, read on the chip at a cell's own sizes.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

For each seed it draws the cell's weights and every input entry of its
mix as a run does, and prints the largest row error of the fp8
reference (`lowprec.py`) against the float32 one over all the entries,
beside the cell's limit: the control must read above it. The program's
own readings are the `row_rel_err_max` that every benchmark run prints.
The control does not depend on the stages, so a chain's control is read
on one card. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    import torch

    from benchmark import compare, harness, lowprec, weights

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    cfg, ref, dev = cell.config, cell.reference, torch.device("cuda", 0)
    block = int(cell.spec["check"].get("block", 32))
    for seed in (int(s) for s in args.seeds.split(",")):
        w = weights.draw(ref.param_specs(cfg), cfg["init"], seed, dev,
                         getattr(torch, cfg["compute_dtype"]))
        worst, rows = 0.0, 0
        for x in weights.input_entries(seed, cell.kind.entries(cell.mix),
                                       cell.kind.entry_shape(cell.mix), dev):
            with torch.no_grad():
                for a in range(0, x.shape[0], block):
                    xb = x[a:a + block]
                    e = compare.row_errors(ref.forward(cfg, w, xb, lowprec.fp8),
                                           ref.forward(cfg, w, xb),
                                           cfg["output"])
                    worst, rows = max(worst, float(e.max())), rows + xb.shape[0]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "rows": rows, "control_row_rel_err_max": worst,
                          "limit": cell.spec["check"]["limit"],
                          "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
