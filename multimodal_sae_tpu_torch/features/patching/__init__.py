from .attribution import Attribution, build_fast_attribution, fast_attribution_maps, general_attribution_maps
from .utils import get_logit_diff, sae_splice_intervention, spliced_forward_with_delta

__all__ = [
    "Attribution",
    "build_fast_attribution",
    "fast_attribution_maps",
    "general_attribution_maps",
    "get_logit_diff",
    "sae_splice_intervention",
    "spliced_forward_with_delta",
]
