"""Explainers and scorers of the interpretation layer (multimodal_sae_tpu/agents).
The segment scorer is not ported yet (ROADMAP.md §1, item 5).
"""

from .explainers import (
    Explainer,
    ExplainerResult,
    ImageExplainer,
    SimpleExplainer,
    explanation_loader,
    random_explanation_loader,
)
from .scorers import (
    ClipScorer,
    GeneratedClipScorer,
    LabelRefiner,
    SimpleScorer,
    SimpleScorerResult,
)

__all__ = [
    "Explainer",
    "ExplainerResult",
    "SimpleExplainer",
    "ImageExplainer",
    "explanation_loader",
    "random_explanation_loader",
    "SimpleScorer",
    "SimpleScorerResult",
    "LabelRefiner",
    "ClipScorer",
    "GeneratedClipScorer",
]
