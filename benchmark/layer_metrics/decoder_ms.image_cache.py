"""decoder_ms.image_cache:
the subject decoder's device time a batch,
in the image feature cache (FeatureImageCache.run);
see benchmark/program_readers.py."""

from benchmark.program_readers import decoder_ms as read  # noqa: F401
