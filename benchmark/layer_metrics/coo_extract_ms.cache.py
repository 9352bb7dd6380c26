"""coo_extract_ms.cache:
the host COO extraction's host time a batch,
in the text feature cache (FeatureCache.run);
see benchmark/program_readers.py."""

from benchmark.program_readers import coo_extract_ms as read  # noqa: F401
