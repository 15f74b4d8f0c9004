#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from, on the card:

    python3 iubench/control.py --workload tet998k_f32.cold \\
        --seeds 11 12 13 --control-seeds 11 12 13 --seconds 1

For each seed one whole run of the cell (set-up, a short window, the
check) in this process, printing the numbers the program's answers
read; for each control seed also those of the control, the reference
computed in the precision below the configuration's and put in the
program's place.  Ends with the largest reading of the program and the
smallest of the control for each number, one JSON object a line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch

    import interpolate_unstructured_tpu_torch as tiu
    from interpolate_unstructured_tpu_torch.utils import cache

    from iubench import harness

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    cache.enable_compile_cache(ROOT / "build")
    spec = harness.find_spec(args.workload)
    prog, ctrl = {}, {}
    for seed in args.seeds:
        out = harness.run_cell(spec, seed, args.seconds, False, "cuda",
                               time.perf_counter(), tiu,
                               control=seed in args.control_seeds or None)
        line = {"workload": args.workload, "seed": seed,
                "calls": out["attempted"], "program": out["checks"],
                "control": out["control_checks"]}
        print(json.dumps(line), flush=True)
        for name, c in out["checks"].items():
            v = c["value"]
            prog[name] = max(prog.get(name, 0.0), float("inf") if v is None
                             else v)
        for name, c in (out["control_checks"] or {}).items():
            v = c["value"]
            ctrl[name] = min(ctrl.get(name, float("inf")),
                             float("inf") if v is None else v)
        del out
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "program_max": prog,
                      "control_min": ctrl}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
