"""Subject-model protocol and a synthetic subject
(multimodal_sae_tpu/models/api.py)."""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@runtime_checkable
class ActivationSource(Protocol):
    """What FeatureCache requires of a subject model."""

    def hookpoint_names(self) -> List[str]:
        """All hookable module names, e.g. ["layers.0", ..., "layers.31"]."""
        ...

    def layers_name(self) -> str:
        """Prefix for layer-index hookpoints, e.g. "layers"."""
        ...

    def resolve_widths(self, hookpoints: List[str]) -> Dict[str, int]:
        """Output dim per hookpoint."""
        ...

    def capture(self, batch: dict, hookpoints: List[str]) -> Dict[str, torch.Tensor]:
        """Run the frozen forward, returning {hookpoint: (B, S, d)}."""
        ...


class SyntheticActivationSource:
    """Deterministic fake subject: hidden states are a fixed random
    projection of one-hot token ids.

    `jax.random` bits cannot be reproduced in torch, so the projection is
    drawn with numpy from `seed`, or passed in as `embed` (e.g. the JAX
    source's `np.asarray(src.embed)`, for parity)."""

    def __init__(
        self,
        d_model: int = 64,
        n_layers: int = 4,
        vocab: int = 128,
        seed: int = 0,
        embed: Optional[np.ndarray] = None,
        device: DeviceLike = None,
    ):
        self.d_model = d_model
        self.n_layers = n_layers
        if embed is None:
            rng = np.random.default_rng(seed)
            embed = rng.standard_normal((vocab, d_model), dtype=np.float32) / d_model**0.5
        if embed.shape != (vocab, d_model):
            raise ValueError(f"embed must be {(vocab, d_model)}, got {embed.shape}")
        self.embed = torch.from_numpy(np.array(embed, np.float32)).to(resolve_device(device))
        self._names = [f"layers.{i}" for i in range(n_layers)]

    @classmethod
    def from_spec(cls, uri: str, device: DeviceLike = None) -> "SyntheticActivationSource":
        """Parse a `synthetic://dM,L,V` model spec (empty spec -> defaults)."""
        spec = uri[len("synthetic://"):] if uri.startswith("synthetic://") else uri
        if spec:
            d_model, n_layers, vocab = (int(x) for x in spec.split(","))
            return cls(d_model=d_model, n_layers=n_layers, vocab=vocab, device=device)
        return cls(device=device)

    def hookpoint_names(self) -> List[str]:
        return list(self._names)

    def layers_name(self) -> str:
        return "layers"

    def resolve_widths(self, hookpoints: List[str]) -> Dict[str, int]:
        return {h: self.d_model for h in hookpoints}

    def capture(self, batch: dict, hookpoints: List[str]) -> Dict[str, torch.Tensor]:
        ids = torch.as_tensor(np.asarray(batch["input_ids"]), dtype=torch.long)
        h = self.embed[ids.to(self.embed.device)]
        return {
            name: h * (1.0 + 0.1 * i) + 0.01 * i
            for name in hookpoints
            for i in [int(name.split(".")[-1])]
        }
