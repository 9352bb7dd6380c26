from .collator import DataCollatorForImage
from .data import MemmapDataset, chunk_and_tokenize, process_mm_data
from .trainer import SaeTrainer

__all__ = ["DataCollatorForImage", "MemmapDataset", "SaeTrainer", "chunk_and_tokenize", "process_mm_data"]
