"""Sparse TopK-SAE decode (multimodal_sae_tpu/ops/sparse_decode.py).

* `eager_decode`     — scatter (vals, idx) into a dense (N, L) buffer, then
                       one matmul: the semantic reference.
* `gather_decode`    — the weighted row gather `sum_j vals[n, j] * W[idx[n, j]]`:
                       kernel K2's decode mode on CUDA (ops/gather_rows.py),
                       its plain version on the CPU.
* `sparse_decode`    — the public entry, differentiable in (vals, W): the
                       forward is `gather_decode`; the backward (`SparseDecode`,
                       the JAX package's custom VJP) takes dvals = g · W[idx]
                       from K2's dvals mode and dW = Sᵀg from `dW_chunked`.
* `topk_mask_decode` — the training fast path: threshold the dense
                       pre-activations at their k-th value and decode with one
                       dense matmul, never forming (vals, idx).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .gather_rows import decode_dvals, gather_decode
from .topk import kth_value, top_k

DW_CHUNK = 1024
"""Rows of the dense scatter formed at a time by `dW_chunked` (the JAX
package's `_dW_chunked` chunk): 512 MiB at 131,072 fp32 latents."""


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


def dW_chunked(idx: torch.Tensor, vals: torch.Tensor, g: torch.Tensor, L: int, chunk: int = DW_CHUNK) -> torch.Tensor:
    """dW_dec = Sᵀ g for the dense scatter S of (vals, idx) (N, k) and g
    (N, d), as the JAX package's `_dW_chunked` builds it: `chunk`-row slabs
    of S, each contracted with its g rows by `torch.matmul` in fp32 and
    summed into an fp32 (L, d) accumulator.  One slab's product comes back
    in g's dtype, several slabs' sum in vals' dtype, as there."""
    if idx.shape[0] <= chunk:
        dense = scatter_dense(idx, vals, L)
        return (dense.float().T @ g.float()).to(g.dtype)
    acc = torch.zeros(L, g.shape[1], dtype=torch.float32, device=g.device)
    for r0 in range(0, idx.shape[0], chunk):
        dense = scatter_dense(idx[r0:r0 + chunk], vals[r0:r0 + chunk], L)
        acc += dense.float().T @ g[r0:r0 + chunk].float()
    return acc.to(vals.dtype)


class SparseDecode(torch.autograd.Function):
    """`gather_decode` with the JAX package's custom VJP
    (multimodal_sae_tpu/ops/sparse_decode.py::_sparse_decode_bwd): no
    gradient for the indices, dvals[n, j] = g[n] · W[idx[n, j]] in the
    values' dtype (K2's dvals mode on CUDA), dW = `dW_chunked` in W's."""

    @staticmethod
    def forward(ctx, top_indices, top_acts, W_dec):
        ctx.save_for_backward(top_indices, top_acts, W_dec)
        return gather_decode(top_indices, top_acts, W_dec)

    @staticmethod
    def backward(ctx, g):
        top_indices, top_acts, W_dec = ctx.saved_tensors
        k, d = top_acts.shape[-1], W_dec.shape[1]
        idx2, g2 = top_indices.reshape(-1, k), g.reshape(-1, d)
        d_acts = d_W = None
        if ctx.needs_input_grad[1]:
            d_acts = decode_dvals(g2, idx2, W_dec, top_acts.dtype).reshape(top_acts.shape)
        if ctx.needs_input_grad[2]:
            d_W = dW_chunked(idx2, top_acts.reshape(-1, k), g2, W_dec.shape[0]).to(W_dec.dtype)
        return None, d_acts, d_W


def sparse_decode(top_indices: torch.Tensor, top_acts: torch.Tensor, W_dec: torch.Tensor) -> torch.Tensor:
    """y = Σ_j top_acts[..., j] · W_dec[top_indices[..., j]], differentiable
    in (top_acts, W_dec)."""
    return SparseDecode.apply(top_indices, top_acts, W_dec)


def topk_mask_decode(
    pre_acts: torch.Tensor, W_dec: torch.Tensor, k: int, mark: Optional[Callable[[str], None]] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training fast path (multimodal_sae_tpu/ops/sparse_decode.py
    `topk_mask_decode`): (y, dense, mask) with mask = pre >= kth, the row's
    exact k-th largest pre-activation (detached, as torch.topk's backward
    flows only into the selected values), dense = where(mask, pre, 0) and
    y = dense @ W_dec (no bias).

    The threshold comes from the wide top-k (`top_k`, kernel K1 on CUDA)
    when k·256 <= width, else from `kth_value`, as the JAX code dispatches.
    Every latent tied at the threshold is kept, so more than k can
    contribute: the JAX package's documented deviation from torch.topk,
    kept for parity.  The JAX package's approximate threshold (the TPU's
    PartialReduce unit) has no counterpart: the threshold here is exact.
    `mark(stage)`, when given, is called after the "top_k" and
    "masked_decode" stages (chip_smoke.py times them)."""
    if k * 256 <= pre_acts.shape[-1]:
        kth = top_k(pre_acts.detach(), k, assume_finite=True)[0][..., -1:]
    else:
        kth = kth_value(pre_acts, k)
    if mark is not None:
        mark("top_k")
    mask = pre_acts >= kth
    dense = torch.where(mask, pre_acts, 0.0)
    y = dense @ W_dec.to(dense.dtype)
    if mark is not None:
        mark("masked_decode")
    return y, dense, mask
