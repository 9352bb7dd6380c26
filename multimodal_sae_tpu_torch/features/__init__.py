from .cache import Cache, FeatureCache, FeatureImageCache, topk_latents_step

__all__ = ["Cache", "FeatureCache", "FeatureImageCache", "topk_latents_step"]
