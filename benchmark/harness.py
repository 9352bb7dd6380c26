"""The benchmark's frame around one run of one cell: the cell's files, the
card check, the measured window, the profiler, the check for JAX, and the
result line.

A cell is `workloads/<name>.json`; it names its configuration
(`configs/<config>.json`) and its entry kind, whose driver is
`drivers/<entry>.py`.  A driver has three functions:

    setup(ctx) -> state          build weights and the program, warm up
    window(ctx, state) -> dict   drive the program until `ctx.window` closes:
                                 {"attempted": n, "units": {name: count}}; the
                                 cell's `rates` name the count of each of its
                                 end-to-end rates (count / window seconds)
    check(ctx, state, out) -> {side: {name: value}}
                                 free the program, compare with the reference:
                                 the numbers of "program", and of each control
                                 the run asked for, put in the program's place

Per-layer metrics are `layer_metrics/<metric>.py`, each with
`read(trace) -> float or None`.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_sae_tpu")
CACHE_DIR = ROOT / ".bench_cache"


def fixed_environment() -> None:
    """Caches at fixed paths inside the checkout; no library loads JAX."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark by file path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell `name` with the metrics `BENCHMARK.json` gives it."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    if name not in {w["name"] for w in bench["workloads"]}:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    config = load_json(BENCH_DIR / "configs" / f"{workload['config']}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if ((name in m["workloads"]) if "workloads" in m else (m["moves"] in reported))]
    return Cell(name, workload, config, e2e, per_layer)


def process_seconds() -> Optional[float]:
    """Seconds since this process started, from /proc (None elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


class Window:
    """The measured window: open for `seconds` from `start()`."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.t0 = self.deadline = None

    def start(self) -> None:
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.seconds

    def open(self) -> bool:
        return time.perf_counter() < self.deadline


class Spans:
    """Named device spans: CUDA events around a call, read after the
    window (milliseconds); nothing is recorded when off."""

    def __init__(self, on: bool):
        self.on = on
        self.pending: Dict[str, list] = {}

    def around(self, name: str, fn: Callable, *args, **kw):
        if not self.on:
            return fn(*args, **kw)
        import torch

        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(f"bench.{name}"):
            a.record()
            out = fn(*args, **kw)
            b.record()
        self.pending.setdefault(name, []).append((a, b))
        return out

    def ms(self) -> Dict[str, List[float]]:
        return {name: [a.elapsed_time(b) for a, b in pairs] for name, pairs in self.pending.items()}


@dataclass
class Ctx:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    window: Window
    spans: Spans
    work: List[dict] = field(default_factory=list)
    faults: tuple = ()
    """Test hooks: names of faults a driver plants in the timed path."""
    setup_phases: Dict[str, float] = field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.workload["traffic"]

    def phase(self, name: str):
        """Times a step of set-up (host clock, after a synchronise), for the
        lines on standard error."""
        import contextlib

        @contextlib.contextmanager
        def timed():
            t0 = time.perf_counter()
            yield
            _sync(self.device)
            self.setup_phases[name] = time.perf_counter() - t0

        return timed()

    def span(self, name: str):
        """A host annotation in the profile (a no-op context when off)."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(f"bench.{name}")


@dataclass
class Trace:
    """What a per-layer reader reads."""

    cell: Cell
    window_s: float
    busy_s: Optional[float]
    kernels: Dict[str, dict]
    spans: Dict[str, List[float]]
    work: List[dict]

    def kernel(self, *parts: str) -> dict:
        """Launches and device seconds of the kernels whose names hold any of
        `parts`."""
        count, seconds = 0, 0.0
        for name, k in self.kernels.items():
            if any(p in name for p in parts):
                count += k["count"]
                seconds += k["s"]
        return {"count": count, "s": seconds}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def forbidden_modules(names=None) -> List[str]:
    """Top-level names of loaded modules (or of `names`) that the run may
    not hold, compared whole: `multimodal_sae_tpu_torch` is not
    `multimodal_sae_tpu`."""
    tops = {name.split(".", 1)[0] for name in (list(sys.modules) if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


def require_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} present")


def summarize_profile(prof, window_name: str = "bench.window"):
    """(kernels {name: {count, s}}, busy_s, window_s, breakdown) of a
    finished torch.profiler run.  Busy time is the union of the device's
    operation intervals inside the annotated window; idle gaps are labelled
    by the innermost host operation under way at their middle, inside the
    benchmark's outermost span there."""
    import numpy as np

    events = prof.events()
    window = [e for e in events if e.name == window_name]
    if not window:
        return {}, None, None, None
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    kernels: Dict[str, dict] = {}
    intervals = []
    cpu = []
    host_names = {e.name for e in events if not str(getattr(e, "device_type", "")).endswith("CUDA")}
    for e in events:
        dev = str(getattr(e, "device_type", "")).endswith("CUDA")
        start, end = e.time_range.start, e.time_range.end
        if dev and e.name in host_names:
            continue  # a host annotation's mirror on the device's timeline
        if dev:
            k = kernels.setdefault(e.name, {"count": 0, "s": 0.0})
            k["count"] += 1
            k["s"] += (end - start) / 1e6
            lo, hi = max(start, w0), min(end, w1)
            if hi > lo:
                intervals.append((lo, hi))
        elif w0 <= end and start <= w1:
            cpu.append((start, end, e.name))
    if not intervals:
        return kernels, None, (w1 - w0) / 1e6, None
    intervals.sort()
    merged = [list(intervals[0])]
    for lo, hi in intervals[1:]:
        if lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    busy_us = sum(hi - lo for lo, hi in merged)
    gaps = [(merged[0][0] - w0, w0, merged[0][0])] if merged[0][0] > w0 else []
    gaps += [(b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])]
    if w1 > merged[-1][1]:
        gaps.append((w1 - merged[-1][1], merged[-1][1], w1))
    gaps.sort(reverse=True)
    starts = np.array([c[0] for c in cpu], dtype=np.float64)
    ends = np.array([c[1] for c in cpu], dtype=np.float64)
    names = [c[2] for c in cpu]
    by_label: Dict[str, float] = {}
    for length, lo, hi in gaps[:2000]:
        mid = (lo + hi) / 2
        over = np.nonzero((starts <= mid) & (ends >= mid))[0]
        inner = "idle host" if len(over) == 0 else names[over[np.argmin(ends[over] - starts[over])]]
        outer = [i for i in over if names[i].startswith("bench.") and names[i] != window_name]
        label = inner
        if outer:
            top = outer[int(np.argmax(ends[outer] - starts[outer]))]
            if names[top] != inner:
                label = f"{names[top]} / {inner}"
        by_label[label] = by_label.get(label, 0.0) + length / 1e6
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1]["s"])[:10]
    breakdown = {
        "device_ops": [[name[:160], k["s"]] for name, k in top_ops],
        "idle_gaps": [[label[:160], s] for label, s in sorted(by_label.items(), key=lambda kv: -kv[1])[:10]],
    }
    return kernels, busy_us / 1e6, (w1 - w0) / 1e6, breakdown


def device_info(chips: int, trace: dict = None) -> dict:
    import torch

    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0)
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
        platform = "gpu"
    else:
        kind, peak, platform = "cpu", 0, "cpu"
    out = {"platform": platform, "kind": kind, "count": chips, "memory_peak_bytes": int(peak)}
    if trace:
        out.update(trace)
    return out


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device=None, bench: Optional[dict] = None,
             cell: Optional[Cell] = None, faults: tuple = (), t_start: Optional[float] = None) -> dict:
    """One run of one cell: set-up, window, per-layer readings, check.
    Returns the result object (the last line's), without printing it.  The
    command line passes no `device` and needs the card; tests pass a CPU
    device and a cell of their own."""
    import torch

    cell = cell or load_cell(name, bench)
    if device is None:
        require_card(cell.chips)
        device = torch.device("cuda", 0)
    on_card = torch.device(device).type == "cuda"
    driver = importlib.import_module(f"benchmark.drivers.{cell.workload['entry']}")
    ctx = Ctx(cell, int(seed), float(seconds), bool(trace), torch.device(device), Window(seconds),
              Spans(bool(trace) and on_card), faults=tuple(faults))
    ctx.setup_phases["before_setup"] = process_seconds() if t_start is None else time.perf_counter() - t_start
    state = driver.setup(ctx)
    if on_card:
        torch.cuda.synchronize()
    setup_s = process_seconds() if t_start is None else time.perf_counter() - t_start
    print("setup phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in ctx.setup_phases.items()), file=sys.stderr)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    ctx.spans.pending.clear()
    with torch.profiler.record_function("bench.window") if trace else contextlib.nullcontext():
        ctx.window.start()
        out = driver.window(ctx, state)
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - ctx.window.t0
    trace_dev = None
    metrics = {}
    breakdown = None
    if prof is not None:
        prof.__exit__(None, None, None)
        kernels, busy_s, traced_s, breakdown = summarize_profile(prof)
        del prof
        t = Trace(cell, traced_s or window_s, busy_s, kernels, ctx.spans.ms(), list(ctx.work))
        for m in cell.per_layer:
            reader = load_module(BENCH_DIR / "layer_metrics" / f"{m['name']}.py", f"bench_metric_{m['name']}")
            value = reader.read(t)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        trace_dev = {"busy_s": busy_s if busy_s is not None else 0.0, "window_s": traced_s or window_s}
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": float(setup_s), "unit": "s"}
            else:
                count = out["units"][cell.workload["rates"][m["name"]]]
                metrics[m["name"]] = {"value": count / window_s, "unit": m["unit"]}
    device_line = device_info(cell.chips, trace_dev) if on_card else {
        "platform": "cpu", "kind": "cpu", "count": cell.chips, "memory_peak_bytes": 0,
        **(trace_dev or {})}
    readings = driver.check(ctx, state, out)
    del state
    limits = cell.workload["check"]["limits"]
    checks = {side: {k: {"value": float(v[k]), "limit": float(limits[k])} for k in limits}
              for side, v in readings.items()}
    result = {"correct": judge(checks["program"]), "attempted": int(out["attempted"]),
              "failed": int(out.get("failed", 0)), "metrics": metrics, "device": device_line}
    if breakdown is not None:
        result["breakdown"] = breakdown
    controls = {side: {"correct": judge(c), "checks": c} for side, c in checks.items() if side != "program"}
    if controls:
        result["controls"] = controls
    result["checks"] = checks["program"]
    return result


def judge(checks: Dict[str, dict]) -> bool:
    """`correct`: every number compared at or under its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def emit(result: dict, out=None, err=None) -> None:
    """The result's compared numbers as the last lines of standard error,
    then the result as the last line of standard output."""
    out = out or sys.stdout
    err = err or sys.stderr
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
