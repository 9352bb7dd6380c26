from .simple import SimpleExplainer

__all__ = ["SimpleExplainer"]
