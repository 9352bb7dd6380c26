"""Profiling hooks (multimodal_sae_tpu/utils/profiling.py): a trace of a
long-running entry point when `MMSAE_PROFILE_DIR` is set, and wall-clock
spans.  The JAX package traces with `jax.profiler`; here `torch.profiler`
records the host's operators and, on a card, its kernels (CUPTI), and
writes a Chrome trace per process."""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Optional

from .misc import process_index, rank0_print


@contextmanager
def maybe_trace(name: str, log_dir: Optional[str] = None):
    """Trace the block with `torch.profiler` (CPU and, where there is one,
    CUDA activity) into `{log_dir}/{name}/rank{r}.trace.json` when `log_dir`
    or `$MMSAE_PROFILE_DIR` is set; otherwise a no-op."""
    log_dir = log_dir or os.environ.get("MMSAE_PROFILE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(log_dir, name)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    rank0_print(f"[profile] tracing to {path}")
    with profile(activities=activities) as prof:
        yield
    trace = os.path.join(path, f"rank{process_index()}.trace.json")
    prof.export_chrome_trace(trace)
    rank0_print(f"[profile] trace written to {trace}")


@contextmanager
def timed(label: str, sink=None):
    """Wall-clock span logging; `sink(label, seconds)` if given, else rank0
    stdout."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink(label, dt)
        else:
            rank0_print(f"[timing] {label}: {dt:.3f}s")
