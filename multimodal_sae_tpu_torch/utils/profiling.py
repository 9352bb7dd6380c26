"""Profiling hooks (multimodal_sae_tpu/utils/profiling.py): a trace of a
long-running entry point when `MMSAE_PROFILE_DIR` is set, wall-clock
spans, and the program's own spans and counters.  The JAX package traces
with `jax.profiler`; here `torch.profiler` records the host's operators
and, on a card, its kernels (CUPTI), and writes a Chrome trace per
process.

Spans and counters.  `span(name, device=False, batch=None)` and
`count(name, n)` record only while a `torch.profiler` is recording
(`torch.autograd._profiler_enabled()`), whoever started it:
`maybe_trace`, a user, a benchmark.  Otherwise a span costs that one
check and returns a shared no-op context: it allocates nothing, records
no event and calls nothing of CUDA.  While recording, a span is a
`torch.profiler.record_function("mmsae.<name>")`, with `batch` (the
cache's batch number) as its argument, on the profiler's clock beside the
card's activity and nested under the spans open around it; it adds its
host seconds to in-memory totals, and with `device=True`, once CUDA is in
use, its device seconds: a pair of timing CUDA events on the current
stream (under `--dp`, the first card's), folded in once `query()` says the
end event has completed, never by a device-wide synchronise, so a long
traced job keeps only the pairs still in flight.  `totals()` reads the
totals, `reset()` clears them; `maybe_trace` resets them on entry and
writes them beside its trace.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import torch

from .misc import process_index, rank0_print

PREFIX = "mmsae."
_OFF = nullcontext()
_spans: Dict[str, list] = {}
"""name -> [n, host seconds, device seconds, device pairs folded]."""
_counters: Dict[str, int] = {}
_pending: List[tuple] = []
"""(name, start event, end event) of device spans not yet folded in."""


def span(name: str, *, device: bool = False, batch: Optional[int] = None):
    """A context that records `mmsae.<name>` while a profiler records (see
    the module's docstring); a shared no-op context otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, device, batch)


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name` while a profiler records."""
    if torch.autograd._profiler_enabled():
        _counters[name] = _counters.get(name, 0) + int(n)


def recording() -> bool:
    """Whether spans and counters record now (a profiler is recording)."""
    return torch.autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "record", "events", "t0")

    def __init__(self, name: str, device: bool, batch: Optional[int]):
        self.name = name
        self.record = torch.profiler.record_function(PREFIX + name, None if batch is None else str(batch))
        self.events = None
        if device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        self.record.__enter__()
        if self.events:
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        if self.events:
            self.events[1].record()
        self.record.__exit__(*exc)
        total = _spans.setdefault(self.name, [0, 0.0, 0.0, 0])
        total[0] += 1
        total[1] += host_s
        if self.events:
            _pending.append((self.name, *self.events))
        _fold(wait=False)
        return False


def _fold(wait: bool) -> None:
    """Fold the device spans whose end event has completed into the totals
    (with `wait`, each pending end event is waited for, that event alone)."""
    if not _pending:
        return
    keep = []
    for name, start, end in _pending:
        if wait:
            end.synchronize()
        elif not end.query():
            keep.append((name, start, end))
            continue
        total = _spans[name]
        total[2] += start.elapsed_time(end) / 1e3
        total[3] += 1
    _pending[:] = keep


def totals() -> dict:
    """{"spans": {name: {"n", "host_s", "device_s"}}, "counters": {name:
    int}} since the last `reset()`; `device_s` is None for a span that
    timed no device work (a host span, or no CUDA)."""
    _fold(wait=True)
    return {
        "spans": {name: {"n": n, "host_s": host_s, "device_s": device_s if pairs else None}
                  for name, (n, host_s, device_s, pairs) in _spans.items()},
        "counters": dict(_counters),
    }


def reset() -> None:
    """Clear the totals and the device spans still pending."""
    _spans.clear()
    _counters.clear()
    _pending.clear()


@contextmanager
def maybe_trace(name: str, log_dir: Optional[str] = None):
    """Trace the block with `torch.profiler` (CPU and, where there is one,
    CUDA activity) into `{log_dir}/{name}/rank{r}.trace.json` when `log_dir`
    or `$MMSAE_PROFILE_DIR` is set; otherwise a no-op.  The program's span
    and counter totals are reset on entry and written to
    `rank{r}.spans.json` beside the trace."""
    log_dir = log_dir or os.environ.get("MMSAE_PROFILE_DIR")
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(log_dir, name)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    rank0_print(f"[profile] tracing to {path}")
    reset()
    with profile(activities=activities) as prof:
        yield
    trace = os.path.join(path, f"rank{process_index()}.trace.json")
    prof.export_chrome_trace(trace)
    with open(os.path.join(path, f"rank{process_index()}.spans.json"), "w") as f:
        json.dump(totals(), f, indent=1, sort_keys=True)
    rank0_print(f"[profile] trace written to {trace}")


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def timed(label: str, sink=None):
    """Wall-clock span logging; `sink(label, seconds)` if given, else rank0
    stdout.  Once CUDA is in use the current card is synchronised before
    each clock read, so the span times the work and not its enqueue; while
    a profiler records it is also the host span `mmsae.<label>`."""
    with span(label):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            dt = time.perf_counter() - t0
            if sink is not None:
                sink(label, dt)
            else:
                rank0_print(f"[timing] {label}: {dt:.3f}s")
