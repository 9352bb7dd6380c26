from .simple.simple_scorer import SimpleScorer, SimpleScorerResult
from .segment.label_refiner import LabelRefiner
from .clip.clip_scorer import ClipScorer, GeneratedClipScorer

__all__ = [
    "SimpleScorer",
    "SimpleScorerResult",
    "LabelRefiner",
    "ClipScorer",
    "GeneratedClipScorer",
]
