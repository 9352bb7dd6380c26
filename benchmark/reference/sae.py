"""The TopK SAE's encoder in plain PyTorch: relu((x - b_dec) @ W_enc + b_enc),
with the weights drawn again from the seed."""

from __future__ import annotations

import torch

from .. import weights
from .lowp import Precision


class Encoder:
    def __init__(self, sae: dict, seed: int, device):
        self.p = weights.sae_params(sae, seed, device)
        self.k = sae["k"]

    def latents(self, x: torch.Tensor, prec: Precision) -> torch.Tensor:
        """(N, d) hidden states -> (N, L) post-ReLU latents."""
        z = prec.encode_mm(x.float() - self.p["b_dec"], self.p["W_enc"])
        return (z + self.p["b_enc"]).relu_()
