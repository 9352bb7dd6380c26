#!/usr/bin/env python3
"""Readings for the limits of a cell's check: for each seed, one short run
of the cell (its own sizes and load) whose check also puts each control in
the program's place and judges it as the program is judged.  The controls
are the reference one precision step lower: `control.fp8` (fp8 products
where the configuration states bf16, TF32 where it states fp32) and
`control.tf32` (the encoder's TF32 step alone).  One JSON line a seed, with
the program's numbers and each control's, each with its `correct`.

    python3 benchmark/calibrate.py --workload <name> --seconds 4 --seeds 11 12 13
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402
from benchmark.drivers.cache_common import CONTROLS  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    harness.fixed_environment()
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False, faults=tuple(CONTROLS), t_start=t0)
        line = {"seed": seed, "correct": r["correct"], "metrics": r["metrics"],
                "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                "checks": r["checks"], "controls": r.get("controls"), "s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
