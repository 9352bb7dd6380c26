"""mfu.cache:
the whole step's share of the card's peaks,
in the text feature cache (FeatureCache.run);
see benchmark/readers.py."""

from benchmark.readers import mfu as read  # noqa: F401
