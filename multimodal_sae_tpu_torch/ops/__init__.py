"""Ops of the port: the exact wide top-k and k-th value, the sparse decode
and its backward, the geometric median, Adam (fp32 and 8-bit), and the CUDA
kernels in their own modules, `ops.block_max` (K1), `ops.gather_rows` (K2),
`ops.flash_attention` (K3, forward and backward) and `ops.sae_encode` (the
SAE encoder's split fp32 product), each beside its plain version and its
launch count."""

from .geometric_median import geometric_median
from .sparse_decode import eager_decode, gather_decode, sparse_decode, topk_mask_decode
from .topk import (
    blockmax_top_k,
    blockwise_top_k,
    kth_value,
    kth_value_bitwise,
    kth_value_histogram,
    sort_pairs_by_index,
    top_k,
)

__all__ = [
    "blockmax_top_k",
    "blockwise_top_k",
    "eager_decode",
    "gather_decode",
    "geometric_median",
    "kth_value",
    "kth_value_bitwise",
    "kth_value_histogram",
    "sort_pairs_by_index",
    "sparse_decode",
    "top_k",
    "topk_mask_decode",
]
