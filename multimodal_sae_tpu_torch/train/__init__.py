from .data import MemmapDataset, chunk_and_tokenize
from .trainer import SaeTrainer

__all__ = ["MemmapDataset", "SaeTrainer", "chunk_and_tokenize"]
