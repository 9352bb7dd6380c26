from .cache import Cache, FeatureCache, topk_latents_step

__all__ = ["Cache", "FeatureCache", "topk_latents_step"]
