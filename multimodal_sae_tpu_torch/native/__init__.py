from .coo import coo_extract_topk, coo_partition_splits, native_available, populated_empty

__all__ = ["coo_extract_topk", "coo_partition_splits", "native_available", "populated_empty"]
