"""Activation caching: frozen subject forward -> TopK SAE latents -> sparse
COO safetensors splits (multimodal_sae_tpu/features/cache.py).

The device step returns each position's top-k (values, indices) sorted by
feature index, so the host-side COO stream comes out in row-major (batch,
seq, feature) order, and only (B, S, k) elements cross to the host.  The
run loop overlaps the two: it dispatches batch N on the current stream
(its results copied into pinned host memory behind a CUDA event), then
extracts batch N-1 on the host while N runs.  `FeatureImageCache` runs the
same loop on LLaVA-NeXT captures with each row's BOS position dropped.

While a profiler records (utils/profiling.py), the loop's spans are
`cache.encode` (device: each hookpoint's encode, top-k and sort),
`cache.wait` (the host waiting for a batch's results: near 0 when the host
paces the job), `cache.extract` (the host COO), `cache.arena_grow` with the
counter `cache.arena_grow_bytes` (an arena's reallocation) and
`cache.stream_submit` (stream_writer.py: blocked on the writer's queue).

On-disk format, byte-equal to the JAX package's:
`{save_dir}/{module}/Rank{r}_{start}_{end}.safetensors` shards merged into
`{start}_{end}.safetensors` (tensors `locations (N, 3) int64`,
`activations (N,)`) plus `.featidx` sidecars.
"""

from __future__ import annotations

import logging
import os
import re
from collections import defaultdict
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ..config import SaeConfig
from ..device import set_precision
from ..utils.profiling import count, span
from ..utils.safetensors_io import load_file, save_file
from ..native import coo_extract_topk, coo_partition_splits, populated_empty
from ..ops import sort_pairs_by_index, top_k
from ..parallel.data_parallel import map_rows
from ..sae import Sae
from ..sae.model import pre_acts as sae_pre_acts

logger = logging.getLogger(__name__)

PREALLOC_MAX_ENTRIES = 128 * 1024 * 1024
"""Default cap on the entries `run` pre-faults per hookpoint (~3.6 GB);
`MMSAE_PREALLOC_MAX_ENTRIES` overrides it, 0 turning pre-faulting off."""

_TORCH_DTYPE = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float64): torch.float64,
}


@torch.no_grad()
def topk_latents_step(params, x: torch.Tensor, cfg: SaeConfig):
    """pre_acts -> exact top-k -> sort by feature index.

    Returns (vals, idx int32) of shape (..., k), index-ascending within each
    position, so masking on the host in row-major order reproduces the
    reference's `torch.nonzero` order."""
    lead = x.shape[:-1]
    latents = sae_pre_acts(params, x.reshape(-1, x.shape[-1]))
    # Post-ReLU latents are finite: the filter may skip its -inf clamp.
    vals, idx = top_k(latents, cfg.k, assume_finite=True)
    idx, vals = sort_pairs_by_index(idx, vals)
    return vals.reshape(*lead, cfg.k), idx.reshape(*lead, cfg.k)


class _Arena:
    """Pre-touched, grow-by-doubling COO buffers: first-touch page faults on
    fresh GB-scale allocations cost far more than streaming into touched
    pages, so each module pays them once per capacity doubling."""

    __slots__ = ("loc", "act", "n")

    def __init__(self):
        self.loc: Optional[np.ndarray] = None
        self.act: Optional[np.ndarray] = None
        self.n = 0

    def reserve(self, extra: int, act_dtype=np.float32):
        need = self.n + extra
        cap = 0 if self.loc is None else self.loc.shape[0]
        if need <= cap:
            return
        new_cap = max(need, cap * 2, 1 << 20)
        with span("cache.arena_grow"):
            loc = populated_empty((new_cap, 3), np.int64)
            act = populated_empty((new_cap,), act_dtype if self.act is None else self.act.dtype)
            if self.n:
                np.copyto(loc[: self.n], self.loc[: self.n])
                np.copyto(act[: self.n], self.act[: self.n])
        count("cache.arena_grow_bytes", loc.nbytes + act.nbytes)
        self.loc, self.act = loc, act

    def append(self, locations: np.ndarray, activations: np.ndarray):
        k = len(activations)
        if k == 0:
            return
        self.reserve(k, act_dtype=activations.dtype)
        np.copyto(self.loc[self.n : self.n + k], locations)
        np.copyto(self.act[self.n : self.n + k], activations)
        self.n += k

    def views(self):
        if self.loc is None:
            return np.empty((0, 3), np.int64), np.empty((0,), np.float32)
        return self.loc[: self.n], self.act[: self.n]


class Cache:
    """Host-side COO accumulator: per-module `locations (N, 3) int64` /
    `activations (N,)` arenas, rows offset by `shard_size` so they index the
    whole dataset."""

    def __init__(
        self,
        shard_size: int,
        filters: Optional[Dict[str, np.ndarray]] = None,
        batch_size: int = 64,
    ):
        self.feature_locations = defaultdict(list)
        self.feature_activations = defaultdict(list)
        self._arenas: Dict[str, _Arena] = defaultdict(_Arena)
        self.filters = {k: np.asarray(v) for k, v in filters.items()} if filters else None
        self.batch_size = batch_size
        self.shard_size = shard_size

    def preallocate(self, module_path: str, n_entries: int, act_dtype=np.float32):
        """Pre-fault arena capacity for `n_entries` triples before the loop
        starts (an under-estimate is safe: growth resumes doubling)."""
        if n_entries > 0:
            self._arenas[module_path].reserve(int(n_entries), act_dtype=act_dtype)

    def add_topk(
        self,
        vals: np.ndarray,
        idx: np.ndarray,
        batch_number: int,
        module_path: str,
        threshold: float = 1e-5,
        row_offset: Optional[int] = None,
    ):
        """Add a (B, S, k) top-k batch: the entries with |value| > threshold
        (and in the module's filter), as the reference's dense scatter +
        nonzero would find them.  `row_offset` (default
        `batch_number * batch_size`) is the batch's first dataset row."""
        with span("cache.extract", batch=batch_number):
            vals = np.asarray(vals)
            idx = np.asarray(idx)
            if row_offset is None:
                row_offset = batch_number * self.batch_size
            row_offset += self.shard_size
            selected = self.filters[module_path] if self.filters is not None else None
            arena = self._arenas[module_path]
            if vals.dtype == np.float32:
                arena.reserve(vals.size)
                arena.n += coo_extract_topk(
                    vals, idx, threshold=threshold, filter_ids=selected,
                    row_offset=row_offset, out=(arena.loc[arena.n :], arena.act[arena.n :]),
                )
            else:
                mask = np.abs(vals) > threshold
                if selected is not None:
                    mask &= np.isin(idx, selected)
                b, s, j = np.nonzero(mask)
                locations = np.empty((b.shape[0], 3), dtype=np.int64)
                locations[:, 0] = b + row_offset
                locations[:, 1] = s
                locations[:, 2] = idx[b, s, j]
                arena.append(locations, vals[mask])

    def add(self, latents, batch_number: int, module_path: str):
        """Add a dense (B, S, F) batch of masked latents, the reference's
        path (cache.py:42-57): its entries with |value| > 1e-5 (and in the
        module's filter), rows offset by `batch_number * batch_size`.  A
        torch tensor, on the card or not, moves to the host once."""
        locations, activations = self.get_nonzeros(latents, module_path)
        locations = locations.copy()
        locations[:, 0] += batch_number * self.batch_size + self.shard_size
        self._arenas[module_path].append(locations, activations)

    def get_nonzeros(self, latents, module_path: str):
        """(locations (N, 3) int64, activations (N,)) of the entries of a
        dense (B, S, F) batch with |value| > 1e-5, in row-major order, kept
        to the module's filter."""
        latents = _host_array(latents)
        mask = np.abs(latents) > 1e-5
        locations = np.argwhere(mask).astype(np.int64)
        activations = latents[mask]
        if self.filters is None:
            return locations, activations
        keep = np.isin(locations[:, 2], self.filters[module_path])
        return locations[keep], activations[keep]

    def save(self):
        """Publish the arenas as single per-module arrays (views)."""
        for module_path, arena in self._arenas.items():
            locations, activations = arena.views()
            self.feature_locations[module_path] = locations
            self.feature_activations[module_path] = activations

    def nonempty_modules(self) -> Iterable[str]:
        return set(self.feature_locations) | set(self._arenas)


class FeatureCache:
    """Drives caching over a token dataset (reference cache.py:95-310).

    Args:
        capture_fn: (batch) -> {module_path: hiddens (B, S, d) tensor}.
        submodule_dict: {module_path: Sae}, on the subject's device.
        batch_size: rows per step.
        shard_size: global row offset of this process's dataset shard.
        activation_dtype: numpy dtype written to disk (fp32 gives the
            bit-stable cache).

    Under `--dp` the captured rows go back to their replica's device, where
    its copy of the SAE encodes them (`replicate_saes`,
    `data_parallel.map_rows`), and the top-k pairs are gathered on the
    first device in row order.
    """

    def __init__(
        self,
        capture_fn: Callable[[dict], Dict[str, torch.Tensor]],
        submodule_dict: Dict[str, Sae],
        batch_size: int,
        shard_size: int = 0,
        filters: Optional[Dict[str, np.ndarray]] = None,
        activation_dtype=np.float32,
    ):
        self.capture_fn = capture_fn
        self.submodule_dict = dict(submodule_dict)
        self.batch_size = batch_size
        self.activation_dtype = np.dtype(activation_dtype)
        first_sae = next(iter(submodule_dict.values()))
        self.width = first_sae.cfg.num_latents_for(first_sae.d_in)
        self.cache = Cache(shard_size, filters, batch_size=batch_size)
        if filters is not None:
            self.filter_submodules(filters)
        self._stream = None
        self._stream_n_splits = 0
        self._stream_marks: Dict[str, int] = {}
        self._row_cursor = 0  # dataset rows consumed

    def enable_streaming(self, save_dir: str, n_splits: int, rank: int = 0):
        """Write `Rank{r}_{start}_{end}.safetensors` shards during the run
        (background thread); `save_splits` then only finalizes their
        headers.  Call before `run()`."""
        from .stream_writer import StreamingSplitWriter

        os.makedirs(save_dir, exist_ok=True)
        self._stream = StreamingSplitWriter(
            save_dir,
            self._generate_split_indices(n_splits),
            rank=rank,
            act_dtype=self.activation_dtype,
        )
        self._stream_n_splits = n_splits
        self._stream_save_dir = save_dir
        self._stream_rank = rank
        self._stream_marks = {}

    def filter_submodules(self, filters: Dict[str, np.ndarray]):
        """Keep only the hookpoints the filter names (reference cache.py:151-156)."""
        self.submodule_dict = {k: v for k, v in self.submodule_dict.items() if k in filters}

    def _device_step(self, batch: dict, skip_bos: bool = False, batch_number: Optional[int] = None) -> dict:
        """Dispatch one batch's device work (capture + per-hookpoint top-k)
        and the copies of its results to pinned host memory, without waiting
        for them: {module: (vals, idx, event or None)}.  `skip_bos` drops
        each row's first position before the encoder (the image cache);
        `batch_number` is the spans' argument."""
        hiddens = self.capture_fn(batch)
        out = {}
        for module_path, h in hiddens.items():
            if module_path not in self.submodule_dict:
                continue
            if skip_bos:
                # One explicit copy of the strided view; the encoder's
                # reshape then takes it as it is.
                h = h[:, 1:, :].contiguous()
            sae = self.submodule_dict[module_path]
            with span("cache.encode", device=True, batch=batch_number):
                vals, idx = map_rows(sae, lambda s, rows: topk_latents_step(s.params, rows, s.cfg), h)
            vals = vals.to(_TORCH_DTYPE[self.activation_dtype])
            if vals.is_cuda:
                vals_h = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
                idx_h = torch.empty(idx.shape, dtype=idx.dtype, pin_memory=True)
                vals_h.copy_(vals, non_blocking=True)
                idx_h.copy_(idx, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                out[module_path] = (vals_h, idx_h, event)
            else:
                out[module_path] = (vals, idx, None)
        return out

    def _host_step(self, dev_out: dict, batch_number: int, n_rows: int):
        """Wait for one batch's results and extract its COO triples; the row
        cursor sets each row's global dataset index."""
        for module_path, (vals, idx, event) in dev_out.items():
            with span("cache.wait", batch=batch_number):
                if event is not None:
                    event.synchronize()
            self.cache.add_topk(
                vals.numpy(), idx.numpy(), batch_number, module_path,
                row_offset=self._row_cursor,
            )
            if self._stream is not None:
                arena = self.cache._arenas[module_path]
                mark = self._stream_marks.get(module_path, 0)
                if arena.n > mark:
                    # Views into the arena are safe to hand off: it only
                    # appends past `n`, and growth reallocates.
                    self._stream.submit(
                        module_path, arena.loc[mark : arena.n], arena.act[mark : arena.n]
                    )
                    self._stream_marks[module_path] = arena.n
        self._row_cursor += n_rows

    def process_batch(self, batch: dict, batch_number: int, skip_bos: bool = False):
        """One cache step without the run loop's overlap: capture, encode
        each hookpoint, accumulate its entries."""
        set_precision()
        self._host_step(self._device_step(batch, skip_bos, batch_number), batch_number, _batch_rows(batch))

    def _preallocate_arenas(self, n_tokens: int, tokens=None):
        """Size each arena from the run-wide estimate: `n_tokens` per row
        times the dataset length where it has one, k entries per token,
        scaled by the filter's coverage, capped by `MMSAE_PREALLOC_MAX_ENTRIES`
        (default `PREALLOC_MAX_ENTRIES`; 0 disables)."""
        cap = int(os.environ.get("MMSAE_PREALLOC_MAX_ENTRIES", PREALLOC_MAX_ENTRIES))
        if cap <= 0 or n_tokens <= 0:
            return
        try:
            n_rows = len(tokens) if tokens is not None else 0
        except TypeError:
            n_rows = 0
        total_tokens = n_tokens * n_rows if n_rows else n_tokens
        for module_path, sae in self.submodule_dict.items():
            expected = total_tokens * sae.cfg.k
            if self.cache.filters is not None:
                sel = self.cache.filters.get(module_path)
                if sel is not None and self.width:
                    expected = int(expected * (len(sel) / self.width)) + 1
            self.cache.preallocate(
                module_path, min(expected, cap), act_dtype=self.activation_dtype
            )

    def run(self, n_tokens: int, tokens, progress: bool = True, skip_bos: bool = False):
        """Cache every full batch of `tokens` (a sequence of {"input_ids": ...}
        rows or an iterator of prepared batches).  `n_tokens` is not a
        budget: like the reference, the whole dataset is cached; it sizes
        the arenas.  `progress` shows a tqdm bar where tqdm is installed.
        `skip_bos` drops each row's first position before encoding."""
        # The fp32 encoder runs with TF32 off, as the JAX side runs it at
        # HIGHEST: TF32 keeps ~3 digits and would move top-k boundaries.
        set_precision()
        self._preallocate_arenas(n_tokens, tokens)
        iterator = _batched(tokens, self.batch_size)
        try:
            from tqdm import tqdm

            iterator = tqdm(iterator, desc="Caching features", disable=not progress)
        except ImportError:
            pass
        pending = None
        try:
            for batch_number, batch in enumerate(iterator):
                dev = self._device_step(batch, skip_bos, batch_number)
                if pending is not None:
                    self._host_step(*pending)
                pending = (dev, batch_number, _batch_rows(batch))
            if pending is not None:
                self._host_step(*pending)
        except BaseException:
            if self._stream is not None:
                # Drop partial shards (zeroed headers) and stop the writer.
                self._stream.abort()
                self._stream = None
            raise
        if pending is not None:
            for module_path in self.submodule_dict:
                if self.cache._arenas[module_path].n == 0:
                    logger.warning(
                        f"hookpoint '{module_path}' produced 0 cache entries over "
                        "the entire run — check it matches the subject's hookpoint "
                        "names (prefix, layer index, --truncate_layers)"
                    )
        self.cache.save()

    # ---- persistence (format identical to the reference) -------------------
    def _generate_split_indices(self, n_splits: int):
        boundaries = np.linspace(0, self.width, n_splits + 1).astype(np.int64)
        # The end is inclusive in the file name (reference cache.py:243-247).
        return list(zip(boundaries[:-1], boundaries[1:] - 1))

    def save(self, save_dir: str):
        """Write one `{save_dir}/{module}.safetensors` per module, the
        unsplit layout (reference cache.py:232-241)."""
        for module_path in self.cache.nonempty_modules():
            save_file(
                {
                    "locations": self.cache.feature_locations[module_path],
                    "activations": self.cache.feature_activations[module_path],
                },
                f"{save_dir}/{module_path}.safetensors",
            )

    def save_splits(self, n_splits: int, save_dir: str, rank: int = 0, *, replicate_boundary_drop: bool = False):
        """Write this rank's feature-range shards
        `Rank{r}_{start}_{end}.safetensors`.  Features on a split boundary
        are kept; the reference's `features < end` against the inclusive
        end dropped them, which `replicate_boundary_drop=True` reproduces to
        bit-match caches the reference wrote (not with streaming)."""
        if self._stream is not None:
            if replicate_boundary_drop:
                raise ValueError(
                    "streaming shard writes keep boundary features; disable "
                    "enable_streaming() to replicate the reference's boundary drop"
                )
            if n_splits != self._stream_n_splits:
                raise ValueError(
                    f"streaming was enabled with n_splits={self._stream_n_splits}, got {n_splits}"
                )
            if os.path.abspath(save_dir) != os.path.abspath(self._stream_save_dir):
                raise ValueError(
                    f"streaming writes to {self._stream_save_dir!r}, but "
                    f"save_splits was called with save_dir={save_dir!r}"
                )
            if rank != self._stream_rank:
                raise ValueError(f"streaming was enabled with rank={self._stream_rank}, got {rank}")
            counts = self._stream.close(extra_modules=list(self.cache._arenas))
            self._stream = None
            for module_path, n in counts.items():
                have = self.cache._arenas[module_path].n
                if n != have:
                    raise RuntimeError(
                        f"streaming writer persisted {n} entries for '{module_path}' "
                        f"but the arena holds {have}; the shards on disk are incomplete"
                    )
            return
        split_indices = self._generate_split_indices(n_splits)
        boundaries = np.array(
            [s for s, _ in split_indices] + [split_indices[-1][1] + 1], dtype=np.int64
        )
        for module_path in self.cache.nonempty_modules():
            locations = self.cache.feature_locations[module_path]
            activations = self.cache.feature_activations[module_path]
            module_dir = f"{save_dir}/{module_path}"
            os.makedirs(module_dir, exist_ok=True)
            if not replicate_boundary_drop and activations.dtype == np.float32:
                parts = coo_partition_splits(locations, activations, boundaries)
            else:
                feats = locations[:, 2]
                drop = 0 if replicate_boundary_drop else 1
                parts = [
                    (locations[m], activations[m])
                    for m in ((feats >= s) & (feats < e + drop) for s, e in split_indices)
                ]
            for (start, end), (locs, acts) in zip(split_indices, parts):
                save_file(
                    {"locations": locs, "activations": acts},
                    f"{module_dir}/Rank{rank}_{start}_{end}.safetensors",
                )

    def concate_safetensors(self, n_splits: int, save_dir: str):
        """Merge the per-rank shards into `{start}_{end}.safetensors` in
        numeric rank order, delete the shards, and write each merged split's
        `.featidx` sidecar."""
        from .split_index import write_index

        split_indices = self._generate_split_indices(n_splits)
        for module_path in self.cache.nonempty_modules():
            module_dir = f"{save_dir}/{module_path}"
            for start, end in split_indices:
                shard_files = [
                    f for f in os.listdir(module_dir)
                    if re.search(rf"Rank[0-9]+_{start}_{end}\.safetensors", f)
                ]
                if not shard_files:
                    raise FileNotFoundError(
                        f"no Rank*_{start}_{end}.safetensors shards in {module_dir}; "
                        "a rank's save_splits output is missing"
                    )
                locations, activations = [], []
                for fname in sorted(
                    shard_files, key=lambda f: int(re.match(r"Rank([0-9]+)_", f).group(1))
                ):
                    data = load_file(os.path.join(module_dir, fname))
                    locations.append(data["locations"].numpy())
                    activations.append(data["activations"].numpy())
                    os.remove(os.path.join(module_dir, fname))
                merged_locations = np.concatenate(locations, axis=0)
                split_path = f"{module_dir}/{start}_{end}.safetensors"
                save_file(
                    {"locations": merged_locations, "activations": np.concatenate(activations, axis=0)},
                    split_path,
                )
                write_index(split_path, merged_locations[:, 2])


class FeatureImageCache(FeatureCache):
    """Image-input caching (reference cache.py:312-429): the capture_fn runs
    the multimodal forward on `<image>`-prompted inputs, and each row's
    leading BOS position is dropped before encoding (reference
    cache.py:402-409)."""

    def run(self, n_tokens: int, tokens, progress: bool = True, **kw):
        if kw:
            raise TypeError(
                f"FeatureImageCache.run got unexpected kwargs {sorted(kw)}; the image "
                "cache always drops the BOS position (reference cache.py:402-409)"
            )
        super().run(n_tokens, tokens, progress=progress, skip_bos=True)


def _host_array(x) -> np.ndarray:
    """A numpy view of `x`; a torch tensor is copied to the host once (bf16,
    which numpy lacks, widened to fp32, exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _batch_rows(batch: dict) -> int:
    """Row count of a prepared batch (every collated key shares the batch axis)."""
    for key in ("input_ids", "image", "images", "pixel_values"):
        if key in batch:
            return len(batch[key])
    return len(next(iter(batch.values())))


def _batched(items, batch_size: int):
    """Fixed-size batches, dropping the final ragged one (the reference's
    DataLoader(drop_last=True)).  Iterators of prepared batches pass
    through; a bare dict is refused."""
    if isinstance(items, dict):
        raise TypeError(
            "_batched got a plain dict; pass a row dataset (supports "
            "__getitem__) or an iterator of prepared batch dicts"
        )
    if hasattr(items, "__getitem__"):
        for i in range(len(items) // batch_size):
            yield _collate([items[j] for j in range(i * batch_size, (i + 1) * batch_size)])
    else:
        yield from items


def _collate(chunk: Sequence):
    if isinstance(chunk[0], dict):
        out = {}
        for key in chunk[0]:
            vals = [c[key] for c in chunk]
            if isinstance(vals[0], (np.ndarray, list)) or np.isscalar(vals[0]):
                try:
                    out[key] = np.stack([np.asarray(v) for v in vals])
                    continue
                except ValueError:
                    pass
            out[key] = vals
        return out
    return {"input_ids": np.stack([np.asarray(c) for c in chunk])}
