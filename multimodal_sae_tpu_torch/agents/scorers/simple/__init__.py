from .simple_scorer import SimpleScorer, SimpleScorerResult

__all__ = ["SimpleScorer", "SimpleScorerResult"]
