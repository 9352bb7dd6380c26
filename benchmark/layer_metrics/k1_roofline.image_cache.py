"""k1_roofline.image_cache:
K1's share of its bytes bound,
in the image feature cache (FeatureImageCache.run);
see benchmark/readers.py."""

from benchmark.readers import k1_roofline as read  # noqa: F401
