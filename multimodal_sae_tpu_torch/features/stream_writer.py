"""Streaming per-split shard persistence for the activation cache (a copy of
multimodal_sae_tpu/features/stream_writer.py on the port's COO kernels).

As the cache's arenas fill, chunks are partitioned by feature range
(`coo_partition_splits`) and appended to the final
`Rank{r}_{start}_{end}.safetensors` shard files by a background thread,
overlapped with the device step, instead of partitioning and writing every
shard after the run.

Shard layout trick: a safetensors file is `u64 header_len | JSON | data`, and
the JSON spec allows trailing-whitespace padding.  A fixed-size header region
is reserved up front, the `locations` bytes stream directly into the final
file as they arrive, `activations` stream into a sidecar (its byte offset
inside the file depends on the final count), and `finalize()` writes the real
header into the reserved region and appends the sidecar.

The streamed shards parse with any safetensors reader and hold arrays
byte-identical to the buffered `save_splits` path; `concate_safetensors`
re-serializes them into the merged `{start}_{end}.safetensors` either way.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.profiling import span

_HDR = 256  # reserved bytes for `u64 len | JSON + space padding`
_DTYPE_TAGS = {
    "float32": "F32",
    "float16": "F16",
    "float64": "F64",
    "bfloat16": "BF16",
    "int64": "I64",
}


class _SplitAppender:
    """One open shard: locations stream straight into the final file after
    the reserved header; activations stream into a sidecar."""

    __slots__ = ("path", "f", "f_act", "n", "act_dtype")

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "wb", buffering=1 << 20)
        self.f.write(b"\0" * _HDR)
        self.f_act = open(path + ".acts", "wb", buffering=1 << 20)
        self.n = 0
        self.act_dtype: Optional[np.dtype] = None

    def append(self, locs: np.ndarray, acts: np.ndarray):
        if self.act_dtype is None:
            self.act_dtype = acts.dtype
        # Raw-byte streaming: the finalize header derives byte offsets from
        # these dtypes, so a silent mismatch would desynchronize the file.
        if locs.dtype != np.int64:
            raise TypeError(f"locations must be int64, got {locs.dtype}")
        if acts.dtype != self.act_dtype:
            raise TypeError(
                f"activation dtype changed mid-stream: "
                f"{self.act_dtype} -> {acts.dtype}"
            )
        self.f.write(memoryview(np.ascontiguousarray(locs)))
        self.f_act.write(memoryview(np.ascontiguousarray(acts)))
        self.n += len(acts)

    def finalize(self):
        self.f_act.close()
        act_dtype = np.dtype(self.act_dtype or np.float32)
        tag = _DTYPE_TAGS[act_dtype.name]
        n = self.n
        loc_bytes = n * 3 * 8
        act_bytes = n * act_dtype.itemsize
        header = {
            "locations": {
                "dtype": "I64",
                "shape": [n, 3],
                "data_offsets": [0, loc_bytes],
            },
            "activations": {
                "dtype": tag,
                "shape": [n],
                "data_offsets": [loc_bytes, loc_bytes + act_bytes],
            },
        }
        blob = json.dumps(header, separators=(",", ":")).encode()
        if len(blob) > _HDR - 8:
            raise ValueError(f"header too large ({len(blob)} bytes)")
        blob = blob + b" " * (_HDR - 8 - len(blob))  # spec-sanctioned padding
        # Append the activations sidecar, then patch the reserved header.
        with open(self.path + ".acts", "rb") as src:
            while True:
                chunk = src.read(1 << 24)
                if not chunk:
                    break
                self.f.write(chunk)
        self.f.seek(0)
        self.f.write(int(_HDR - 8).to_bytes(8, "little"))
        self.f.write(blob)
        self.f.close()
        os.remove(self.path + ".acts")


class StreamingSplitWriter:
    """Background-threaded per-split appenders for one cache run.

    Args:
        save_dir: cache root (shards land in `{save_dir}/{module}/`).
        split_indices: [(start, inclusive_end), ...] feature ranges — the
            same `linspace` partition `save_splits` uses.
        rank: this host's rank (shard filename component).
    """

    def __init__(
        self,
        save_dir: str,
        split_indices: Sequence[Tuple[int, int]],
        rank: int = 0,
        act_dtype=np.float32,
    ):
        self.save_dir = save_dir
        self.split_indices = list(split_indices)
        self.rank = rank
        self.act_dtype = np.dtype(act_dtype)
        if self.act_dtype.name not in _DTYPE_TAGS:
            # Validate up front: a KeyError at finalize() would discard the
            # whole run's cache compute.
            raise TypeError(
                f"streaming writer cannot serialize activation dtype "
                f"{self.act_dtype} (supported: {sorted(_DTYPE_TAGS)}); "
                "use the buffered save_splits path"
            )
        self.boundaries = np.array(
            [s for s, _ in self.split_indices] + [self.split_indices[-1][1] + 1],
            dtype=np.int64,
        )
        self._appenders: Dict[Tuple[str, int], _SplitAppender] = {}
        self._part_scratch: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=4)
        self._error: List[BaseException] = []
        self._aborted = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ---- producer side -----------------------------------------------------
    def _put(self, item):
        """Bounded put that keeps watching for a dead worker: if the writer
        thread errored (disk full, ...) the queue stops draining and a plain
        blocking put would hang the whole caching run forever instead of
        surfacing the exception."""
        while True:
            if self._error:
                raise self._error[0]
            if self._aborted:
                # After abort() the worker is gone and the queue never drains;
                # without this check a later submit() would spin here forever.
                raise RuntimeError("streaming writer was aborted")
            try:
                self._queue.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def submit(self, module_path: str, locs: np.ndarray, acts: np.ndarray):
        """Enqueue a COO chunk (row-major within the chunk) for partitioning
        and appending.  Chunks must arrive in stream order per module.  The
        span `cache.stream_submit` is the time blocked on the full queue
        (the disk slower than caching)."""
        if len(acts):
            with span("cache.stream_submit"):
                self._put((module_path, locs, acts))

    def abort(self):
        """Close every open shard and remove the partial files (zeroed
        headers + .acts sidecars) so a failed run leaves no unparseable
        shards for a retry or rank-0 merge to trip over.

        The worker is stopped and joined BEFORE any file is removed: it may
        be mid-chunk (or have chunks still queued) when the producer aborts,
        and an append after removal would silently recreate partial shards
        that then escape cleanup."""
        self._aborted = True
        try:  # drop queued chunks so the worker stops after its current one
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        try:
            self._queue.put_nowait(None)  # wake a get()-blocked worker
        except queue.Full:
            pass
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            # A wedged filesystem write can outlive the join timeout; deleting
            # files under a live worker would recreate partial shards (and race
            # the _appenders dict). Leave the partials in place — the caller's
            # retry/merge will see the zeroed headers fail to parse loudly.
            import logging

            logging.getLogger(__name__).warning(
                "streaming writer worker still alive after 30s join; "
                "skipping partial-shard removal to avoid racing a live append"
            )
            return
        for app in self._appenders.values():
            for fh in (app.f, app.f_act):
                try:
                    fh.close()
                except Exception:
                    pass
            for path in (app.path, app.path + ".acts"):
                try:
                    os.remove(path)
                except OSError:
                    pass
        self._appenders.clear()

    def close(self, extra_modules: Sequence[str] = ()) -> Dict[str, int]:
        """Drain the queue, finalize every shard header (creating empty
        shards for splits a module never touched, like the buffered path),
        and return per-module entry counts.

        `extra_modules`: modules that must get (empty) shard files even if
        they produced zero COO entries — `modules()` only reflects appenders
        created by actual data, and a hookpoint whose filtered features never
        fired would otherwise have no Rank files at all, breaking the rank-0
        merge (which iterates every cached module)."""
        try:
            self._put(None)
        except BaseException:
            self.abort()
            raise
        self._thread.join()
        if self._error:
            self.abort()
            raise self._error[0]
        for module in set(self.modules()) | set(extra_modules):
            for split_i in range(len(self.split_indices)):
                self._get_appender(module, split_i)
        counts: Dict[str, int] = {}
        for (module, _split), app in sorted(self._appenders.items()):
            counts[module] = counts.get(module, 0) + app.n
            if app.act_dtype is None:
                app.act_dtype = self.act_dtype
            app.finalize()
        return counts

    # ---- worker side ---------------------------------------------------------
    def _worker(self):
        try:
            while True:
                item = self._queue.get()
                if item is None or self._aborted:
                    return
                module, locs, acts = item
                self._append_chunk(module, locs, acts)
        except BaseException as e:  # surfaced on the producer thread
            self._error.append(e)

    def _append_chunk(self, module: str, locs: np.ndarray, acts: np.ndarray):
        from ..native import coo_partition_splits, populated_empty

        if acts.dtype == np.float32:
            # Persistent partition scratch: chunks arrive every batch at a
            # steady size, so one reused pair (grown monotonically) replaces
            # a per-batch 28 B/entry fresh-page allocation.  Safe because the
            # per-split views are serialized to the appenders synchronously
            # below, before the next chunk is partitioned.
            if self._part_scratch is None or self._part_scratch[0].shape[0] < len(acts):
                self._part_scratch = (
                    populated_empty((len(acts), 3), np.int64),
                    populated_empty((len(acts),), np.float32),
                )
            parts = coo_partition_splits(
                locs, acts, self.boundaries, scratch=self._part_scratch
            )
        else:  # the native partition is f32-only; never silently upcast
            feats = locs[:, 2]
            parts = [
                (locs[m], acts[m])
                for m in (
                    (feats >= s) & (feats < e)
                    for s, e in zip(self.boundaries[:-1], self.boundaries[1:])
                )
            ]
        for split_i, (p_locs, p_acts) in enumerate(parts):
            if not len(p_acts):
                continue
            self._get_appender(module, split_i).append(p_locs, p_acts)

    def _get_appender(self, module: str, split_i: int) -> _SplitAppender:
        key = (module, split_i)
        app = self._appenders.get(key)
        if app is None:
            start, end = self.split_indices[split_i]
            module_dir = os.path.join(self.save_dir, module)
            os.makedirs(module_dir, exist_ok=True)
            path = os.path.join(
                module_dir, f"Rank{self.rank}_{start}_{end}.safetensors"
            )
            app = self._appenders[key] = _SplitAppender(path)
        return app

    def modules(self) -> List[str]:
        return sorted({m for m, _ in self._appenders})
