"""Ops of the port: the exact wide top-k and k-th value, the sparse decode
and its backward, the geometric median, Adam (fp32 and 8-bit), and the CUDA
kernels in their own modules, `ops.block_max` (K1), `ops.gather_rows` (K2)
and `ops.flash_attention` (K3, forward and backward), each beside its plain
version and its launch count."""

from .geometric_median import geometric_median
from .topk import blockmax_top_k, blockwise_top_k, kth_value, sort_pairs_by_index, top_k

__all__ = ["blockmax_top_k", "blockwise_top_k", "geometric_median", "kth_value", "sort_pairs_by_index", "top_k"]
