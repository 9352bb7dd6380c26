"""Exact wide top-k over the last axis, and the sort by index that orders the
cache's COO stream.

Ports what multimodal_sae_tpu/ops/topk.py computes, not its TPU mechanisms:
the one-hot MXU gathers become `torch.gather`, and the rank-permutation sort
becomes a sort of the (unique) indices with the values gathered after it, so
payload bits survive by construction.  The block-max filter keeps the JAX
package's block choice and runs its reduce through kernel K1
(ops/block_max.py) at both levels.  Indices come back as int32, as in JAX.
Like `torch.topk(sorted=False)`, ties at the k-th value may pick either
element: results are exact as sets.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .block_max import block_max

Pair = Tuple[torch.Tensor, torch.Tensor]


def blockwise_top_k(x: torch.Tensor, k: int) -> Pair:
    """Exact top-k over the last axis: (values descending, int32 indices).

    The JAX version splits the axis into blocks so XLA tiles two narrow
    sorts; `torch.topk` selects exactly on its own."""
    if k > x.shape[-1]:
        raise ValueError(f"k={k} must be <= width={x.shape[-1]}")
    vals, idx = torch.topk(x, k, dim=-1)
    return vals, idx.to(torch.int32)


def _block_filter(x2: torch.Tensor, k: int, block: int, assume_finite: bool) -> Pair:
    """One level of block-max filtering: the k blocks of width `block` with
    the largest maxima, as (candidates (n, k*block), block ids (n, k)).

    Without `assume_finite` the candidates read -inf as the dtype's finite
    minimum, as the JAX package's clamped one-hot gather returns them."""
    n, width = x2.shape
    bidx = torch.topk(block_max(x2, block), k, dim=-1, sorted=False).indices
    blocks = x2.view(n, width // block, block)
    cand = blocks.gather(1, bidx[:, :, None].expand(n, k, block)).reshape(n, k * block)
    if not assume_finite:
        cand = cand.clamp_min(torch.finfo(cand.dtype).min)
    return cand, bidx


def blockmax_top_k(
    x: torch.Tensor, k: int, block: int = 64, block2: int = 8, assume_finite: bool = False
) -> Pair:
    """Exact top-k via block-max filtering (multimodal_sae_tpu/ops/topk.py
    `blockmax_top_k`).

    Level 1 keeps the k blocks with the largest maxima, a superset of the
    top-k: with v_k the k-th largest value, fewer than k blocks hold a value
    above v_k and they all rank ahead of blocks whose max is <= v_k.  Level 2
    applies the same filter at width `block2` to the k*block candidates, so
    the final exact top-k runs over k*block2 values.  `assume_finite`
    promises no -inf input (post-ReLU latents)."""
    width = x.shape[-1]
    lead = x.shape[:-1]
    if (
        k * block > width + (-width) % block
        or not torch.is_floating_point(x)
        or width % block
    ):
        return blockwise_top_k(x, k)
    x2 = x.reshape(-1, width)
    cand1, bidx1 = _block_filter(x2, k, block, assume_finite)
    if k * block > 4096 and block % block2 == 0 and block2 > 1:
        # Level-1 candidates are finite (clamped unless promised finite).
        cand2, bidx2 = _block_filter(cand1, k, block2, True)
        vals, pos2 = torch.topk(cand2, k, dim=-1)
        pos1 = bidx2.gather(1, pos2 // block2) * block2 + pos2 % block2
    else:
        vals, pos1 = torch.topk(cand1, k, dim=-1)
    idx = bidx1.gather(1, pos1 // block) * block + pos1 % block
    return vals.reshape(*lead, k), idx.to(torch.int32).reshape(*lead, k)


def top_k(x: torch.Tensor, k: int, *, assume_finite: bool = False) -> Pair:
    """Exact top-k over the last axis, with the JAX package's dispatch
    (multimodal_sae_tpu/ops/topk.py `top_k`): widths of 32,768 and up take
    the block-max filter with the largest block <= 64 whose k winning blocks
    cover at most a quarter of the row (k=256 at 131,072 -> block 64, then
    block 8 at level 2)."""
    width = x.shape[-1]
    if width >= 32768:
        block = 64
        while block > 8 and k * block * 4 > width:
            block //= 2
        if k * block * 4 <= width and width % block == 0:
            return blockmax_top_k(x, k, block=block, assume_finite=assume_finite)
    return blockwise_top_k(x, k)


def sort_pairs_by_index(idx: torch.Tensor, vals: torch.Tensor) -> Pair:
    """Sort (idx, vals) ascending by idx along the last axis (stable).
    Values move by gather, so every payload bit, ±inf and NaN included,
    survives."""
    idx_s, order = torch.sort(idx, dim=-1, stable=True)
    return idx_s, vals.gather(-1, order)
