"""Natural sort (a copy of multimodal_sae_tpu/utils/misc.py's)."""

from __future__ import annotations

import re
from typing import Iterable, List, TypeVar

T = TypeVar("T")

_NUM_RE = re.compile(r"(\d+)")


def natsort_key(s: str):
    """Natural-sort key: "layers.2" < "layers.10"."""
    return tuple(int(p) if p.isdigit() else p for p in _NUM_RE.split(str(s)))


def natsorted(items: Iterable[T], key=None) -> List[T]:
    """Natural sort (equivalent to `natsort.natsorted` for our usage)."""
    if key is None:
        return sorted(items, key=natsort_key)
    return sorted(items, key=lambda x: natsort_key(key(x)))
