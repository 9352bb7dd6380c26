"""Dimensionality-reduction interface for decoder-direction maps
(multimodal_sae_tpu/features/dim_reduce/dim_reducer.py): reducers expose
fit/transform/fit_transform over (n_samples, n_features) arrays."""

from __future__ import annotations

from abc import ABC, abstractmethod


class DimReducer(ABC):
    """Base reducer: `name` labels the method, `n_components` the target dim."""

    def __init__(self, name: str, n_components: int, **kwargs) -> None:
        super().__init__()
        self.name = name
        self.n_components = n_components

    @abstractmethod
    def fit(self, X, **kwargs):
        """Learn the projection from (n_samples, n_features) data."""
        raise NotImplementedError

    @abstractmethod
    def transform(self, X, **kwargs):
        """Project data to (n_samples, n_components)."""
        raise NotImplementedError

    def fit_transform(self, X, **kwargs):
        self.fit(X, **kwargs)
        return self.transform(X, **kwargs)
