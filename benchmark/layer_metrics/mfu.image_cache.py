"""mfu.image_cache:
the whole step's share of the card's peaks,
in the image feature cache (FeatureImageCache.run);
see benchmark/readers.py."""

from benchmark.readers import mfu as read  # noqa: F401
