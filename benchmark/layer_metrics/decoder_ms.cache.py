"""decoder_ms.cache:
the subject decoder's device time a batch,
in the text feature cache (FeatureCache.run);
see benchmark/program_readers.py."""

from benchmark.program_readers import decoder_ms as read  # noqa: F401
