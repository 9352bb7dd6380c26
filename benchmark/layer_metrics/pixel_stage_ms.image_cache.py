"""pixel_stage_ms.image_cache:
the pixel staging's host time a batch,
in the image feature cache (FeatureImageCache.run);
see benchmark/program_readers.py."""

from benchmark.program_readers import pixel_stage_ms as read  # noqa: F401
