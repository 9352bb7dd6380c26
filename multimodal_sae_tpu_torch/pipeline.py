"""Async interpretation pipeline (behavior of reference
sae_auto_interp/pipeline.py:8-62).

Hardware-agnostic orchestration: a generator of FeatureRecords fans out
through a sequence of pipes (explainers, scorers, postprocessors) under a
concurrency semaphore.  `process_wrapper` adds sync pre/post hooks around an
async pipe function; `Pipe` runs several functions on the same input and
gathers their results; `Pipeline.run` walks the generator one buffer at a
time, scheduling every record as its own task.

Copied from multimodal_sae_tpu/pipeline.py; it uses no jax.
"""

from __future__ import annotations

import asyncio
from functools import wraps
from typing import Callable


def process_wrapper(
    function: Callable, preprocess: Callable = None, postprocess: Callable = None
):
    """Wrap an async pipe function with synchronous pre/post hooks."""

    @wraps(function)
    async def wrapped(record):
        value = record if preprocess is None else preprocess(record)
        result = await function(value)
        return result if postprocess is None else postprocess(result)

    return wrapped


class Pipe:
    """Fan one input out to several async functions and gather the results."""

    def __init__(self, *functions: Callable):
        self.functions = functions

    async def __call__(self, record):
        return await asyncio.gather(*(fn(record) for fn in self.functions))


class Pipeline:
    """Chain pipes over a record generator with bounded concurrency."""

    def __init__(self, generator, *pipes):
        self.generator = generator
        self.pipes = pipes

    async def _chain(self, record):
        value = record
        for pipe in self.pipes:
            value = await pipe(value)
        return value

    async def run(self, max_processes: int = 100, collate: bool = False):
        """Run every record through the pipes with bounded concurrency.

        One record's failure must not abort the run (a single explainer
        error past the client's retries re-raised out of as_completed would
        orphan every in-flight task and lose the whole buffer): failed records are logged and skipped, and the first
        failure is re-raised at the END only if NOTHING succeeded — a
        systematically broken endpoint still fails loudly instead of
        burning through the whole dataset."""
        semaphore = asyncio.Semaphore(max_processes)

        async def bounded(record):
            async with semaphore:
                return await self._chain(record)

        failures = 0
        successes = 0
        first_error: Exception | None = None
        source = self.generator(collate)
        # collate=True yields one flat list of records rather than a
        # per-buffer generator of lists; treat it as a single batch.
        buffers = [source] if collate else source
        for records in buffers:
            tasks = [asyncio.create_task(bounded(r)) for r in records]
            progress = _progress_bar(len(tasks))
            for finished in asyncio.as_completed(tasks):
                try:
                    await finished
                    successes += 1
                except Exception as e:  # noqa: BLE001 — isolate per record
                    failures += 1
                    if first_error is None:
                        first_error = e
                    from .logger import logger

                    logger.error(f"pipeline record failed (skipping): {e!r}")
                if progress is not None:
                    progress.update(1)
        if failures:
            from .logger import logger

            logger.warning(
                f"pipeline finished with {failures} failed / "
                f"{successes} succeeded records"
            )
            if successes == 0 and first_error is not None:
                raise first_error


def _progress_bar(total: int):
    try:
        from tqdm import tqdm

        return tqdm(total=total, desc="Collected")
    except ImportError:
        return None
