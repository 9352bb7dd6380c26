from .label_refiner import LabelRefiner

__all__ = ["LabelRefiner"]
