"""Zero-copy split reads and the per-split feature-index sidecars
(multimodal_sae_tpu/features/split_index.py).

A sidecar `{start}_{end}.featidx` beside each merged split holds the split's
feature-sorted permutation (`order`), the permuted feature column (`feats`,
ascending) and `meta = [n_entries, split_bytes]`, so a filtered load is
O(selected entries).  The bytes equal the JAX package's, and either package
reads the other's.  Sidecars are written by the cache merger, self-healed
by unfiltered loads, and retrofitted onto an existing cache (the JAX
package's or the reference's) with

    python -m multimodal_sae_tpu_torch.features.split_index <cache_dir> [--rebuild]

`MMSAE_NO_FEATIDX=1` turns the sidecars off.

Staleness.  The JAX package judges a sidecar by the split's entry count and
byte size, and the size follows from the count, so a split regenerated with
the same count was read through the old permutation.  Here a sidecar is
stale as well when its mtime is older than its split's, or when any of up
to `SPOT_CHECKS` evenly spaced entries of its `feats` differs from the
split's feature column at its `order` (a few reads from the mapped split).
Neither check adds a byte to the file.  A copy that reorders mtimes costs
one scan and a self-heal rewrite; it never gives a wrong read.
"""

from __future__ import annotations

import json
import logging
import mmap
import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.safetensors_io import save_file

INDEX_SUFFIX = ".featidx"
SPOT_CHECKS = 64

logger = logging.getLogger(__name__)

# safetensors dtype tags numpy can view zero-copy (BF16 has no numpy dtype).
_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


class UnsupportedSplitFormat(Exception):
    """The file holds a dtype numpy cannot view zero-copy (e.g. BF16)."""


def mmap_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read-only zero-copy numpy views over a safetensors file.  The views
    hold the mapping alive.  Raises `UnsupportedSplitFormat` for dtypes
    numpy cannot represent."""
    with open(path, "rb") as f:
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    header_len = int.from_bytes(mapped[:8], "little")
    header = json.loads(mapped[8 : 8 + header_len].decode("utf-8"))
    base = 8 + header_len
    out: Dict[str, np.ndarray] = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        np_dtype = _DTYPES.get(spec["dtype"])
        if np_dtype is None:
            raise UnsupportedSplitFormat(f"{path}: dtype {spec['dtype']}")
        start, end = spec["data_offsets"]
        count = (end - start) // np.dtype(np_dtype).itemsize
        out[name] = np.frombuffer(
            mapped, dtype=np_dtype, count=count, offset=base + start
        ).reshape(spec["shape"])
    return out


def index_path(split_path: str) -> str:
    root, _ext = os.path.splitext(split_path)
    return root + INDEX_SUFFIX


def _disabled() -> bool:
    """`MMSAE_NO_FEATIDX` set (and not "0") turns the sidecars off."""
    return os.environ.get("MMSAE_NO_FEATIDX", "") not in ("", "0")


def write_index(
    split_path: str,
    feats: np.ndarray,
    order: Optional[np.ndarray] = None,
    strict: bool = False,
) -> bool:
    """Persist the sidecar for one split; `feats` is its feature column in
    file order, `order` an optional precomputed argsort of it (unstable is
    fine: readers re-sort each feature's slice).  Best-effort: a missing
    sidecar costs speed, never correctness, so an unwritable directory
    returns False with a warning (`strict=True` raises the `OSError`
    instead).  Written to a temp file and renamed, so no reader sees a torn
    index.  Returns False without writing under `MMSAE_NO_FEATIDX` or for
    feature ids or counts outside int32."""
    if _disabled():
        return False
    feats = np.asarray(feats)
    if feats.size and (int(feats.min()) < 0 or int(feats.max()) >= np.iinfo(np.int32).max):
        logger.warning(f"not indexing {split_path}: feature ids outside int32 range")
        return False
    if feats.shape[0] >= np.iinfo(np.int32).max:
        logger.warning(f"not indexing {split_path}: too many entries for int32")
        return False
    if order is None:
        order = np.argsort(feats, kind=None)
    target = index_path(split_path)
    try:
        split_bytes = os.path.getsize(split_path)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(target) or ".", suffix=".featidx.tmp")
        os.close(fd)
        try:
            save_file(
                {
                    # The check rides as a tensor, not header metadata, so
                    # the bytes stay deterministic.
                    "meta": np.array([feats.shape[0], split_bytes], dtype=np.int64),
                    "order": np.ascontiguousarray(order, dtype=np.int32),
                    "feats": np.ascontiguousarray(feats[order], dtype=np.int32),
                },
                tmp,
            )
            os.replace(tmp, target)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
    except OSError as e:
        if strict:
            raise
        logger.warning(f"could not write feature index {target}: {e}")
        return False
    return True


def read_index(
    split_path: str, n_entries: int, feats: Optional[np.ndarray] = None
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """`(order, feats_sorted)` for a split, or None when the sidecars are
    disabled (`MMSAE_NO_FEATIDX`) or this one is absent, unreadable, or
    stale: by the split's entry count and byte size, by an mtime older than
    the split's, and, when the split's feature column `feats` is given, by
    a spot check of up to `SPOT_CHECKS` entries."""
    if _disabled():
        return None
    target = index_path(split_path)
    try:
        if not os.path.exists(target):
            return None
        if os.stat(target).st_mtime_ns < os.stat(split_path).st_mtime_ns:
            logger.warning(f"stale feature index ignored (older than its split): {target}")
            return None
        data = mmap_safetensors(target)
        meta = data["meta"]
        if meta.shape != (2,) or int(meta[0]) != n_entries or int(meta[1]) != os.path.getsize(split_path):
            logger.warning(f"stale feature index ignored: {target}")
            return None
        order, sorted_feats = data["order"], data["feats"]
        if order.shape[0] != n_entries or sorted_feats.shape[0] != n_entries:
            logger.warning(f"malformed feature index ignored: {target}")
            return None
        if feats is not None and n_entries:
            at = np.unique(np.linspace(0, n_entries - 1, SPOT_CHECKS).astype(np.int64))
            if not np.array_equal(np.asarray(feats)[order[at]], sorted_feats[at]):
                logger.warning(f"stale feature index ignored (its features differ from the split's): {target}")
                return None
        return order, sorted_feats
    except (OSError, KeyError, IndexError, ValueError, UnsupportedSplitFormat) as e:
        logger.warning(f"unreadable feature index ignored ({target}): {e}")
        return None


def ensure_index(cache_dir: str, rebuild: bool = False) -> int:
    """Retrofit sidecars onto every `{start}_{end}.safetensors` split under
    `cache_dir/<module>/`; returns the number written.  Valid sidecars are
    kept unless `rebuild`.  Works on the JAX package's and the reference's
    caches (the split format is shared)."""
    written = 0
    for module in sorted(os.listdir(cache_dir)):
        module_dir = os.path.join(cache_dir, module)
        if not os.path.isdir(module_dir):
            continue
        for fname in sorted(os.listdir(module_dir)):
            if not fname.endswith(".safetensors"):
                continue
            split_path = os.path.join(module_dir, fname)
            try:
                data = mmap_safetensors(split_path)
            except UnsupportedSplitFormat:
                continue
            locations = data.get("locations")
            if locations is None or locations.ndim != 2 or locations.shape[1] < 3:
                continue
            n = locations.shape[0]
            if not rebuild and read_index(split_path, n, locations[:, 2]) is not None:
                continue
            if write_index(split_path, locations[:, 2]):
                written += 1
    return written


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Build .featidx feature-index sidecars for a COO cache directory "
        "(this package's, the JAX package's or the reference's)."
    )
    p.add_argument("cache_dir")
    p.add_argument("--rebuild", action="store_true", help="rewrite even valid indexes")
    a = p.parse_args(argv)
    n = ensure_index(a.cache_dir, rebuild=a.rebuild)
    print(f"wrote {n} feature index sidecar(s) under {a.cache_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
