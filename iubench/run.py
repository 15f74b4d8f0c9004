#!/usr/bin/env python3
"""Run one cell of the benchmark of ``interpolate_unstructured_tpu_torch``
once, on the CUDA card it is started on:

    python3 iubench/run.py --workload tet998k_f32.cold --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with the reference beside its limit,
which also end standard error.  Exits non-zero, printing no result,
without enough CUDA devices or when the JAX package or jax was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")
# one process drives the card; its host side runs on one thread, so that
# no thread pool of its own competes with the thread that launches
os.environ["OMP_NUM_THREADS"] = "1"


def call_stats(ms):
    """min/median/max of the window's call times (ms), for standard error."""
    if not ms:
        return "-"
    s = sorted(ms)
    return f"{s[0]:.4f}/{s[len(s) // 2]:.4f}/{s[-1]:.4f}"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    torch.set_num_threads(1)
    marks = {"torch_s": time.perf_counter() - T_START}
    from iubench import harness

    spec = harness.find_spec(args.workload)
    chips = int(spec.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    marks["cuda_s"] = time.perf_counter() - T_START
    import interpolate_unstructured_tpu_torch as tiu
    from interpolate_unstructured_tpu_torch.ops import _kernels
    from interpolate_unstructured_tpu_torch.utils import cache

    marks["port_s"] = time.perf_counter() - T_START
    # the kernel library builds (first run) or loads here, inside the
    # checkout, before the grid build is timed
    cache.enable_compile_cache(ROOT / "build")
    _kernels.lib()
    marks["kernels_s"] = time.perf_counter() - T_START
    out = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START, tiu, marks=marks)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    rec = out["record"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if args.trace:
        prof = rec.profile or {}
        device["busy_s"] = prof.get("busy_s", 0.0)
        device["window_s"] = prof.get("window_s", 0.0)
        result["breakdown"] = {"device_ops": prof.get("device_ops", []),
                               "idle_gaps": prof.get("idle_gaps", [])}
    result["checks"] = out["checks"]
    from iubench import work

    print(f"card: {work.power_limit()}; setup_s {rec.setup_s:.4f}; "
          f"set-up marks {json.dumps(rec.phases)}; "
          f"build {json.dumps(rec.build)}; calls {rec.calls}; "
          f"window_s {rec.window_s:.4f}; check_s {rec.judge_s:.4f}; "
          f"call ms min/median/max {call_stats(rec.call_ms)}; "
          f"work {json.dumps(rec.work)}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
