"""UMAP over decoder directions (multimodal_sae_tpu/features/dim_reduce/umap.py).
Needs `umap-learn`, imported when a reducer is made; it runs on the host on
numpy arrays.  `PcaReducer` needs nothing beyond torch."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .dim_reducer import DimReducer


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class UmapReducer(DimReducer):
    def __init__(self, name: str, n_components: int, **kwargs) -> None:
        super().__init__(name, n_components, **kwargs)
        from umap import UMAP  # optional dependency

        self.umap = UMAP(n_components=n_components, **kwargs)

    def fit(self, X, **kwargs):
        return self.umap.fit(_host(X), **kwargs)

    def transform(self, X, **kwargs):
        return self.umap.transform(_host(X), **kwargs)

    def fit_sae_list(self, sae_list: List):
        """Concatenate the SAEs' decoder rows (each `W_dec` (L, d)) and fit."""
        return self.fit(np.concatenate([_host(sae.params["W_dec"]) for sae in sae_list], axis=0))
