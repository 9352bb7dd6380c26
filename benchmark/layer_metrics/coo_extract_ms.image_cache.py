"""coo_extract_ms.image_cache:
the host COO extraction's host time a batch,
in the image feature cache (FeatureImageCache.run);
see benchmark/program_readers.py."""

from benchmark.program_readers import coo_extract_ms as read  # noqa: F401
