from .api import ActivationSource, SyntheticActivationSource
from .llama import LlamaConfig, LlamaModel, llama_forward, pad_text_rows

__all__ = [
    "ActivationSource",
    "SyntheticActivationSource",
    "LlamaConfig",
    "LlamaModel",
    "llama_forward",
    "pad_text_rows",
]
