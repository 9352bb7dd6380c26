from .clip_scorer import ClipScorer, GeneratedClipScorer

__all__ = ["ClipScorer", "GeneratedClipScorer"]
