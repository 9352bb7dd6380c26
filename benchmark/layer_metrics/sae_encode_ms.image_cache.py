"""sae_encode_ms.image_cache:
the SAE encode and top-k's device time a batch,
in the image feature cache (FeatureImageCache.run);
see benchmark/program_readers.py."""

from benchmark.program_readers import sae_encode_ms as read  # noqa: F401
