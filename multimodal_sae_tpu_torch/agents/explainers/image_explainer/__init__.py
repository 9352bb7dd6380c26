from .image_explainer import ImageExplainer

__all__ = ["ImageExplainer"]
