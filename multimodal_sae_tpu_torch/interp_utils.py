"""Filter and SAE loaders of the cache path (multimodal_sae_tpu/interp_utils.py
`load_filter`, `load_saes`)."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from .device import DeviceLike
from .sae import Sae


def load_filter(path: str) -> Dict[str, np.ndarray]:
    """Json {hookpoint: [feature ids]} -> arrays (reference utils.py:44-48)."""
    with open(path) as f:
        filt = json.load(f)
    return {key: np.asarray(value, dtype=np.int64) for key, value in filt.items()}


def load_saes(
    sae_path: str,
    filters: Optional[Dict[str, np.ndarray]] = None,
    dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
) -> Dict[str, Sae]:
    """One SAE per hookpoint from the local directory `sae_path`: the
    filter's hookpoints when a filter is given, else every subdirectory.
    The cache path never decodes, so decoders stay on disk."""
    if not os.path.isdir(sae_path):
        raise FileNotFoundError(f"{sae_path} is not a local SAE directory")
    if filters is not None:
        return {
            name: Sae.load_from_disk(os.path.join(sae_path, name), dtype, decoder=False, device=device)
            for name in filters
        }
    return Sae.load_many(sae_path, dtype=dtype, decoder=False, device=device)
