from .explainer import (
    Explainer,
    ExplainerResult,
    explanation_loader,
    random_explanation_loader,
)
from .image_explainer import ImageExplainer
from .simple import SimpleExplainer

__all__ = [
    "Explainer",
    "ExplainerResult",
    "explanation_loader",
    "random_explanation_loader",
    "ImageExplainer",
    "SimpleExplainer",
]
