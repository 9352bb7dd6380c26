"""subject_forward_ms.cache:
the subject forward's device time a batch,
in the text feature cache (FeatureCache.run);
see benchmark/readers.py."""

from benchmark.readers import subject_forward_ms as read  # noqa: F401
