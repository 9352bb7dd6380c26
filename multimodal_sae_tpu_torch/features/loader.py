"""Lazy readers over the cached COO safetensors splits
(multimodal_sae_tpu/features/loader.py).

`TensorBuffer` loads one `{start}_{end}.safetensors` split and yields a
`BufferOutput` per feature, skipping features with fewer than
`min_examples` entries; `FeatureDataset` builds buffers for every split, or
only for the splits that hold the requested features.  Host numpy
throughout: this layer puts nothing on the card.

Reads: zero-copy mmap views by default (`MMSAE_NO_MMAP=1` reads the whole
file), through the split's `.featidx` sidecar where a valid one exists
(`MMSAE_NO_FEATIDX=1` turns sidecars off), else through one sort of the
feature column.  Each feature's entries come in row-major file order on
every path.

Two faults of the JAX package are fixed here: an `OSError` or `ValueError`
from the mmap falls back to the full read, and the self-heal write of a
sidecar is tried once per directory (a read-only cache warns once, not on
every load).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np

from ..config import FeatureConfig
from ..utils.safetensors_io import load_file
from .features import Feature, FeatureRecord
from .split_index import UnsupportedSplitFormat, index_path, mmap_safetensors, read_index, write_index

logger = logging.getLogger(__name__)

_HEAL_FAILED: set = set()
"""Directories in which a self-heal write of a sidecar failed; no later load
tries again."""


class BufferOutput(NamedTuple):
    feature: Feature

    locations: np.ndarray
    """(n, 2) int64: (dataset row, sequence position)."""

    activations: np.ndarray
    """(n,) activations."""


def _unique_nonneg(values: np.ndarray) -> np.ndarray:
    """Ascending unique of a non-negative int column by counting (bincount),
    with a sort for negative ids or ranges past 2M ids."""
    if values.size == 0:
        return np.unique(values)
    vmax = int(values.max())
    if int(values.min()) >= 0 and vmax < 1 << 21:
        return np.nonzero(np.bincount(values, minlength=vmax + 1))[0]
    return np.unique(values)


def _unique_sorted(sorted_vals: np.ndarray) -> np.ndarray:
    """Ascending unique of an already sorted column, in one compare pass."""
    if sorted_vals.size == 0:
        return np.asarray(sorted_vals[:0], dtype=np.int64)
    keep = np.empty(sorted_vals.shape[0], dtype=bool)
    keep[0] = True
    np.not_equal(sorted_vals[1:], sorted_vals[:-1], out=keep[1:])
    return sorted_vals[keep].astype(np.int64, copy=False)


def _read_split(path: str) -> Dict[str, np.ndarray]:
    """The split's arrays: mmap views unless `MMSAE_NO_MMAP` is set, else (or
    when the mmap fails, or for a dtype numpy cannot view) a full read."""
    if os.environ.get("MMSAE_NO_MMAP", "") in ("", "0"):
        try:
            return mmap_safetensors(path)
        except UnsupportedSplitFormat:
            pass
        except (OSError, ValueError) as e:
            logger.warning(f"mmap of {path} failed ({e}); reading the whole file")
    return {name: t.numpy() for name, t in load_file(path).items()}


def _self_heal(path: str, feats: np.ndarray, order: np.ndarray) -> None:
    """Persist the sort a full-split load just paid as the split's sidecar;
    a directory where that failed once is not tried again."""
    directory = os.path.dirname(os.path.abspath(path))
    if directory in _HEAL_FAILED:
        return
    try:
        write_index(path, feats, order=order, strict=True)
    except OSError as e:
        _HEAL_FAILED.add(directory)
        logger.warning(
            f"could not write feature index {index_path(path)}: {e}; "
            f"not trying again in {directory}"
        )


class TensorBuffer:
    """Lazy per-split reader (reference loader.py:28-118)."""

    def __init__(
        self,
        path: str,
        module_path: str,
        features: Optional[np.ndarray] = None,
        min_examples: int = 120,
    ):
        self.tensor_path = path
        self.module_path = module_path
        self.features = None if features is None else np.asarray(features)
        self.min_examples = min_examples

        self.activations: Optional[np.ndarray] = None
        self.locations: Optional[np.ndarray] = None
        self._order: Optional[np.ndarray] = None
        self._sorted_feats: Optional[np.ndarray] = None

    def _load(self):
        split_data = _read_split(self.tensor_path)
        self.activations = split_data["activations"]
        self.locations = split_data["locations"]
        feats = self.locations[:, 2]
        index = read_index(self.tensor_path, feats.shape[0], feats)
        if index is not None:
            # Sidecar path: no O(N) work; `_feature_slice` searchsorts the
            # persisted index and gathers only member rows.
            self._order, self._sorted_feats = index
            if self.features is None:
                self.features = _unique_sorted(self._sorted_feats)
            return
        if self.features is not None and feats.size:
            # Filtered scan: drop non-member entries through a boolean LUT
            # over the split's id range before the sort.  Entries keep their
            # row-major order.  Ids parsed from JSON may arrive as floats;
            # ids outside [0, max] match nothing and must not size the LUT.
            requested = self.features.astype(np.int64, copy=False)
            requested = requested[(requested >= 0) & (requested <= int(feats.max()))]
            if requested.size:
                lut = np.zeros(int(feats.max()) + 1, dtype=bool)
                lut[requested] = True
                member = lut[feats]
                self.locations = self.locations[member]
                self.activations = self.activations[member]
            else:
                self.locations = self.locations[:0]
                self.activations = self.activations[:0]
            feats = self.locations[:, 2]
        # Unstable sort: `_feature_slice` re-sorts each feature's slice, so
        # the order of equal keys is unobservable.
        self._order = np.argsort(feats, kind=None)
        self._sorted_feats = feats[self._order]
        if self.features is None:
            self.features = _unique_nonneg(feats)
            # Only from a full-split load: a filtered `_order` permutes the
            # member-compacted arrays, not the file.
            _self_heal(self.tensor_path, feats, self._order)

    def _feature_slice(self, feature: int):
        # The needle in the index's dtype: a Python int against the
        # sidecar's int32 would promote the whole array on every call.
        needle = self._sorted_feats.dtype.type(feature)
        lo = np.searchsorted(self._sorted_feats, needle, side="left")
        hi = np.searchsorted(self._sorted_feats, needle, side="right")
        # Row-major file order; np.sort copies, leaving the index untouched.
        return np.sort(self._order[lo:hi])

    def __len__(self):
        if self.features is not None:
            return len(self.features)
        if self.locations is None:
            self._load()
        if self.features is None:
            self.features = _unique_nonneg(self.locations[:, 2])
        return len(self.features)

    def __iter__(self):
        if self.locations is None:
            self._load()
        for feature in self.features:
            sel = self._feature_slice(int(feature))
            if sel.shape[0] < self.min_examples:
                continue
            yield BufferOutput(
                Feature(self.module_path, int(feature)),
                self.locations[sel, :2],
                self.activations[sel],
            )
        # Free the split once drained.
        self.activations = None
        self.locations = None
        self._order = None
        self._sorted_feats = None


class FeatureDataset:
    """TensorBuffers for each module and split (reference loader.py:121-259)."""

    def __init__(
        self,
        raw_dir: str,
        cfg: FeatureConfig,
        modules: Optional[List[str]] = None,
        features: Optional[Dict[str, np.ndarray]] = None,
    ):
        self.cfg = cfg
        self.buffers: List[TensorBuffer] = []
        if features is None:
            self._build(raw_dir, modules)
        else:
            self._build_selected(raw_dir, modules, features)

    def _edges(self) -> np.ndarray:
        return np.linspace(0, self.cfg.width, self.cfg.n_splits + 1).astype(np.int64)

    def _build(self, raw_dir: str, modules: Optional[List[str]] = None):
        edges = self._edges()
        modules = os.listdir(raw_dir) if modules is None else modules
        for module in modules:
            for start, end in zip(edges[:-1], edges[1:]):
                # The file name's end is inclusive.
                path = f"{raw_dir}/{module}/{start}_{end - 1}.safetensors"
                self.buffers.append(TensorBuffer(path, module, min_examples=self.cfg.min_examples))

    def _build_selected(self, raw_dir: str, modules: Optional[List[str]], features: Dict[str, np.ndarray]):
        """Buffers only for the splits that hold requested features,
        bucketized over the split edges; ids outside [0, width) raise."""
        edges = self._edges()
        if modules is None:
            modules = list(features)
        for module in modules:
            selected = np.asarray(features[module])
            bad = selected[(selected < 0) | (selected >= self.cfg.width)]
            if bad.size:
                raise ValueError(
                    f"feature filter for '{module}' contains id(s) outside "
                    f"[0, {self.cfg.width}): {bad[:5].tolist()}"
                    f"{'...' if bad.size > 5 else ''} — check the filter "
                    "against the SAE width"
                )
            bucketized = np.searchsorted(edges, selected, side="right")
            for bucket in np.unique(bucketized):
                mask = bucketized == bucket
                start, end = edges[bucket - 1], edges[bucket]
                path = f"{raw_dir}/{module}/{start}_{end - 1}.safetensors"
                self.buffers.append(
                    TensorBuffer(path, module, selected[mask], min_examples=self.cfg.min_examples)
                )

    def __len__(self):
        return len(self.buffers)

    def load(
        self,
        collate: bool = False,
        constructor: Optional[Callable] = None,
        sampler: Optional[Callable] = None,
        transform: Optional[Callable] = None,
        num_workers: Optional[int] = None,
    ):
        """Per buffer, per feature: construct, sample, transform.  Returns a
        generator of per-buffer record lists, or one flat list when
        `collate`.  A `SkipRecord` from any of the three drops the record.

        `num_workers` (default `MMSAE_LOADER_WORKERS`, else 1) loads and
        constructs up to that many buffers at once on a thread pool.  The
        sampler and transform always run on the consuming thread in
        buffer-then-record order (samplers draw from a shared RNG), so a
        threaded load equals a sequential one."""
        from .samplers import SkipRecord

        if num_workers is None:
            env = os.environ.get("MMSAE_LOADER_WORKERS")
            num_workers = int(env) if env else 1

        def _construct(buffer_output: BufferOutput) -> Optional[FeatureRecord]:
            record = FeatureRecord(buffer_output.feature)
            try:
                if constructor is not None:
                    constructor(record=record, buffer_output=buffer_output)
            except SkipRecord:
                return None
            return record

        def _finish(record: Optional[FeatureRecord]) -> Optional[FeatureRecord]:
            if record is None:
                return None
            try:
                if sampler is not None:
                    sampler(record)
                if transform is not None:
                    transform(record)
            except SkipRecord:
                return None
            return record

        def _construct_buffer(buffer: TensorBuffer):
            return [_construct(out) for out in buffer]

        if num_workers <= 1 or len(self.buffers) <= 1:

            def _seq_gen():
                for buffer in self.buffers:
                    yield [r for c in _construct_buffer(buffer) if (r := _finish(c)) is not None]

            gen = _seq_gen()
        else:

            def _par_gen():
                from collections import deque
                from concurrent.futures import ThreadPoolExecutor

                def _drain(future):
                    return [r for c in future.result() if (r := _finish(c)) is not None]

                with ThreadPoolExecutor(num_workers) as pool:
                    pending = deque()
                    for buffer in self.buffers:
                        pending.append(pool.submit(_construct_buffer, buffer))
                        if len(pending) >= num_workers:
                            yield _drain(pending.popleft())
                    while pending:
                        yield _drain(pending.popleft())

            gen = _par_gen()

        if collate:
            return [r for records in gen for r in records]
        return gen
