"""subject_forward_ms.image_cache:
the subject forward's device time a batch,
in the image feature cache (FeatureImageCache.run);
see benchmark/readers.py."""

from benchmark.readers import subject_forward_ms as read  # noqa: F401
