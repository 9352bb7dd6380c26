"""Dimensionality reduction over SAE decoder directions
(multimodal_sae_tpu/features/dim_reduce/): PCA on the card, and UMAP when
`umap-learn` is installed."""

from .dim_reducer import DimReducer
from .pca import PcaReducer
from .umap import UmapReducer

__all__ = ["DimReducer", "UmapReducer", "PcaReducer"]
