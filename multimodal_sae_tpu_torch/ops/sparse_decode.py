"""Sparse TopK-SAE decode (multimodal_sae_tpu/ops/sparse_decode.py), forward
only.

* `eager_decode`  — scatter (vals, idx) into a dense (N, L) buffer, then one
                    matmul: the semantic reference.
* `gather_decode` — the weighted row gather `sum_j vals[n, j] * W[idx[n, j]]`:
                    kernel K2's decode mode on CUDA (ops/gather_rows.py), its
                    plain version on the CPU.
* `sparse_decode` — the public entry, `gather_decode` as the forward.

The JAX package gives `sparse_decode` a custom VJP (dvals by the same
gather, dW chunk by chunk); it comes with the training slice (ROADMAP.md
§1).  Until then `sparse_decode` raises on inputs that require grad rather
than return a result whose gradient would be wrong.  The attribution path
needs none: it differentiates only above the splice.  `topk_mask_decode`
also waits for training.
"""

from __future__ import annotations

import torch

from .gather_rows import gather_decode


def scatter_dense(idx: torch.Tensor, vals: torch.Tensor, width: int) -> torch.Tensor:
    """Scatter per-row (vals, idx) (N, k) into a dense (N, width) matrix.
    Indices within a row come from top-k and are unique."""
    dense = torch.zeros(idx.shape[0], width, dtype=vals.dtype, device=vals.device)
    return dense.scatter_add_(1, idx.long(), vals)


def eager_decode(top_indices: torch.Tensor, top_acts: torch.Tensor, W_dec: torch.Tensor) -> torch.Tensor:
    """(..., k) indices and activations, (L, d) W_dec -> (..., d): the dense
    scatter times W_dec (no decoder bias)."""
    lead, k = top_acts.shape[:-1], top_acts.shape[-1]
    dense = scatter_dense(top_indices.reshape(-1, k), top_acts.reshape(-1, k), W_dec.shape[0])
    return (dense @ W_dec.to(dense.dtype)).reshape(*lead, W_dec.shape[1])


def sparse_decode(top_indices: torch.Tensor, top_acts: torch.Tensor, W_dec: torch.Tensor) -> torch.Tensor:
    """y = Σ_j top_acts[..., j] · W_dec[top_indices[..., j]], forward only.

    Raises when autograd would track the result: the backward (dvals and
    the chunked dW) comes with the training slice."""
    if torch.is_grad_enabled() and (top_acts.requires_grad or W_dec.requires_grad):
        raise NotImplementedError(
            "sparse_decode has no backward yet: its dvals/dW VJP comes with the "
            "training slice (ROADMAP.md §1, sparse_decode's backward and training)"
        )
    return gather_decode(top_indices, top_acts, W_dec)
