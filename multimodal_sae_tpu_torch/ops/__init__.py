"""Ops of the port: the exact wide top-k, the sparse decode, and the CUDA
kernels in their own modules, `ops.block_max` (K1), `ops.gather_rows` (K2)
and `ops.flash_attention` (K3, forward and backward), each beside its plain
version and its launch count."""

from .topk import blockmax_top_k, blockwise_top_k, sort_pairs_by_index, top_k

__all__ = ["blockmax_top_k", "blockwise_top_k", "sort_pairs_by_index", "top_k"]
