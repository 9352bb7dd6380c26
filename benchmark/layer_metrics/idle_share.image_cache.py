"""idle_share.image_cache:
idle share of the device,
in the image feature cache (FeatureImageCache.run);
see benchmark/readers.py."""

from benchmark.readers import idle_share as read  # noqa: F401
