"""k3_fwd_roofline.cache:
K3 forward's share of its bound,
in the text feature cache (FeatureCache.run);
see benchmark/readers.py."""

from benchmark.readers import k3_fwd_roofline as read  # noqa: F401
