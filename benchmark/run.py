#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is `benchmark/workloads/<name>.json` (BENCHMARK.json lists them).
The run builds its weights and inputs from --seed on the card, warms up,
drives the port (`multimodal_sae_tpu_torch`) for --seconds, compares what
the window produced with the plain reference under `benchmark/reference/`,
and prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics; with --trace 1
its per-layer ones, from torch.profiler), device, breakdown (--trace 1),
and the numbers compared beside their limits (checks), which also end
standard error.  It exits non-zero and prints no result without enough
CUDA devices, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.fixed_environment()
    since_start = harness.process_seconds()
    t_start = None if since_start is not None else T_START
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules that the run may not load were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    card = harness.power_limit()
    if card:
        print(f"card: {card}", file=sys.stderr)
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
