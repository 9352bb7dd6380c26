"""Zero-copy split reads and the per-split feature-index sidecars
(multimodal_sae_tpu/features/split_index.py).

A sidecar `{start}_{end}.featidx` beside each merged split holds the split's
feature-sorted permutation (`order`), the permuted feature column (`feats`,
ascending) and `meta = [n_entries, split_bytes]`, so a filtered load is
O(selected entries).  The bytes equal the JAX package's.  The loader that
reads through the sidecars, and the fix of their staleness check (count and
size only), come with the loader slice.
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


def write_index(split_path: str, feats: np.ndarray) -> bool:
    """Persist the sidecar for one split; `feats` is its feature column in
    file order.  Best-effort: a missing sidecar costs speed, never
    correctness, so an unwritable directory returns False with a warning.
    Written to a temp file and renamed, so no reader sees a torn index.
    Returns False without writing under `MMSAE_NO_FEATIDX`."""
    if _disabled():
        return False
    feats = np.asarray(feats)
    if feats.size and (int(feats.min()) < 0 or int(feats.max()) >= np.iinfo(np.int32).max):
        logger.warning(f"not indexing {split_path}: feature ids outside int32 range")
        return False
    if feats.shape[0] >= np.iinfo(np.int32).max:
        logger.warning(f"not indexing {split_path}: too many entries for int32")
        return False
    order = np.argsort(feats, kind=None)
    target = index_path(split_path)
    try:
        split_bytes = os.path.getsize(split_path)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(target) or ".", suffix=".featidx.tmp")
        os.close(fd)
        try:
            save_file(
                {
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
        logger.warning(f"could not write feature index {target}: {e}")
        return False
    return True


def read_index(split_path: str, n_entries: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """`(order, feats_sorted)` for a split, or None when the sidecars are
    disabled (`MMSAE_NO_FEATIDX`) or this one is absent, unreadable, or stale
    by the split's entry count and byte size."""
    if _disabled():
        return None
    target = index_path(split_path)
    try:
        if not os.path.exists(target):
            return None
        data = mmap_safetensors(target)
        meta = data["meta"]
        if meta.shape != (2,) or int(meta[0]) != n_entries or int(meta[1]) != os.path.getsize(split_path):
            logger.warning(f"stale feature index ignored: {target}")
            return None
        order, feats = data["order"], data["feats"]
        if order.shape[0] != n_entries or feats.shape[0] != n_entries:
            logger.warning(f"malformed feature index ignored: {target}")
            return None
        return order, feats
    except (OSError, KeyError, ValueError, UnsupportedSplitFormat) as e:
        logger.warning(f"unreadable feature index ignored ({target}): {e}")
        return None
