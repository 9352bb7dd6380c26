"""k1_roofline.cache:
K1's share of its bytes bound,
in the text feature cache (FeatureCache.run);
see benchmark/readers.py."""

from benchmark.readers import k1_roofline as read  # noqa: F401
