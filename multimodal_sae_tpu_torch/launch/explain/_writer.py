"""Buffered per-module JSON row writer for the explain CLIs.

The reference re-read, re-parsed, and rewrote the whole `{module}.json`
after EVERY explanation — O(n²) JSON I/O that dominates wall-clock at
131k-feature scale (~16k parses+rewrites per module for one full module).  This writer keeps the artifact format
byte-identical (one pretty-printed JSON array per module) but batches the
rewrites: rows buffer in memory and flush every `flush_every` results and on
close(), so a crash loses at most `flush_every - 1` rows instead of the
crash-resilience the per-row rewrite bought.

Copied from multimodal_sae_tpu/launch/explain/_writer.py; it uses no jax.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List


class ModuleRowWriter:
    def __init__(self, out_dir: str, flush_every: int = 64):
        self.out_dir = out_dir
        self.flush_every = flush_every
        self._pending: Dict[str, List[dict]] = defaultdict(list)
        self._since_flush = 0

    def _path(self, module_file: str) -> str:
        return os.path.join(self.out_dir, module_file)

    def append(self, module_file: str, row: dict) -> None:
        self._pending[module_file].append(row)
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        for module_file, rows in self._pending.items():
            if not rows:
                continue
            path = self._path(module_file)
            existing = json.load(open(path, "r")) if os.path.exists(path) else []
            existing.extend(rows)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(existing, f, indent=4, ensure_ascii=False)
            os.replace(tmp, path)  # atomic: a crash never leaves a torn file
            rows.clear()
        self._since_flush = 0

    def close(self) -> None:
        self.flush()
