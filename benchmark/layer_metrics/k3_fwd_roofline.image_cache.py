"""k3_fwd_roofline.image_cache:
K3 forward's share of its bound,
in the image feature cache (FeatureImageCache.run);
see benchmark/readers.py."""

from benchmark.readers import k3_fwd_roofline as read  # noqa: F401
