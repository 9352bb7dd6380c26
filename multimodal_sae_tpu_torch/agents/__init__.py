"""Explainers and scorers of the interpretation layer (multimodal_sae_tpu/agents),
the segment scorer among them."""

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
    RandomSegmentScorer,
    SegmentScorer,
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
    "SegmentScorer",
    "RandomSegmentScorer",
    "LabelRefiner",
    "ClipScorer",
    "GeneratedClipScorer",
]
