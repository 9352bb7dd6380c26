"""valid_share.image_cache:
the share of the decoder's positions that the attention mask attends,
in the image feature cache (FeatureImageCache.run);
see benchmark/program_readers.py."""

from benchmark.program_readers import valid_share as read  # noqa: F401
