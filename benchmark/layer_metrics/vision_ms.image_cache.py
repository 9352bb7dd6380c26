"""vision_ms.image_cache:
the vision tower, projector and anyres pack's device time a batch,
in the image feature cache (FeatureImageCache.run);
see benchmark/program_readers.py."""

from benchmark.program_readers import vision_ms as read  # noqa: F401
