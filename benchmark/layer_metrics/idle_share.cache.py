"""idle_share.cache:
idle share of the device,
in the text feature cache (FeatureCache.run);
see benchmark/readers.py."""

from benchmark.readers import idle_share as read  # noqa: F401
